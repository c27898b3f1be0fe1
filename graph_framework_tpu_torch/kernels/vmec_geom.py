"""The fused VMEC geometry jet (K4): CUDA kernel wrapper and plain version.

Counterpart of ``graph_framework_tpu.pallas.vmec_geom`` (the TPU kernel
``_jet_kernel`` over ``_jet_sums``, built by ``make_fused_geometry``).  Per
ray (s, u, v) it computes, over the per-mode tables of a VMEC
equilibrium, the clamped radial cell on the full and on the half grid, the
cell-local Horner value, d/ds and d2/ds2 of every mode's spline, per-mode
cos/sin of (xm u - xn v) (the kernel reaches them by rotations from the
sincos of u and nfp v, over the modes as runs of one m: ``mode_runs``),
and the 27 sums of the geometry's second-order
jet: the 10 sums the geometry consumes (R, Z, their (s, u, v) derivatives,
dl/du, dl/dv) and the 17 unique second partials (``JET_NAMES``).

* :func:`reference_jet` is the plain PyTorch version over the whole table
  (the JAX package's ``_reference_jet``, without its radial cut).
* :func:`geometry_jet` is the wrapper: for CPU tensors, and only then, it
  runs the plain version; for CUDA tensors it launches the hand-written
  kernel of ``csrc/vmec_geom.cu`` (built by ``nvcc`` on first use,
  kernels/build.py) on the current stream, or raises: there is no
  fallback.  ``vmec_geom_launches`` counts its launches.
* :class:`FusedGeometry` is the first-order differentiable form: forward
  returns the 10 sums and saves the jet; backward contracts the output
  cotangents with the Jacobian read from the jet (``JVP_IDX``), in plain
  torch, as the JAX package's linear tangent map transposes.  It is
  differentiable once: a backward with ``create_graph=True`` raises.
* :func:`fused_geometry` is what ``models.vmec`` calls under
  ``fused_mode_sums``.  The spline tables are constants there: a table
  that requires grad is refused.

Not carried over (TPU artifacts): the one-hot MXU fetch and the bf16
word split of the tables, the 128-cell radial cut, the dense mode grid
(90 slots for 86 modes) and its 128-slot padding, the (n, 48) duplicated
output, and the Cody-Waite reduction before the trig (CUDA's sincos
reduces the range itself); and the JAX kernel's debug guard
(``pallas/vmec_geom.py:344-356``), which checks that the rays stay inside
the 128-cell cut: with no cut there is nothing to guard.  Under debug mode
(``utils.set_debug``) the kernel's outputs get the finiteness check that
every kernel wrapper makes (``utils.check_kernel_outputs``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from graph_framework_tpu_torch.kernels import build
from graph_framework_tpu_torch.ops.tables import table_index_1d
from graph_framework_tpu_torch.utils import check_kernel_outputs

#: Kernel launches of K4; plain-version calls do not count.
vmec_geom_launches = 0

#: The 27 jet sums, in the kernel's output order.
JET_NAMES = (
    "r", "z", "drs", "dru", "drv", "dzs", "dzu", "dzv", "dlu", "dlv",
    "drss", "drsu", "drsv", "druu", "druv", "drvv",
    "dzss", "dzsu", "dzsv", "dzuu", "dzuv", "dzvv",
    "dlus", "dlvs", "dluu", "dluv", "dlvv")

#: d(output o)/d(s, u, v) = jet[JVP_IDX[o]] for the first 10 sums (Hessian
#: symmetry reuses the off-diagonal partials; the JAX package's _JVP_IDX).
#: FusedGeometry's backward reads it at each call.
JVP_IDX = (
    (2, 3, 4),      # r
    (5, 6, 7),      # z
    (10, 11, 12),   # drs
    (11, 13, 14),   # dru
    (12, 14, 15),   # drv
    (16, 17, 18),   # dzs
    (17, 19, 20),   # dzu
    (18, 20, 21),   # dzv
    (22, 24, 25),   # dlu
    (23, 25, 26),   # dlv
)

#: Floating point operations, counted over csrc/vmec_geom.cu by
#: tools/count_ops.py (a CPU test holds them to it) for the reference's 86
#: modes in 10 runs: per ray a fixed part (the two radial cells, two
#: sincos counted two each, the rotations to each run's first mode, the
#: factors m applied once a run, the final 1/ds factors) and a part per
#: mode (the Horner jets, one rotation, the sums); and the operations on
#: the mode numbers and tables alone (xn, xn^2, m^2, doubled coefficients,
#: ds^2), which the function needs once, not once a ray.
JET_OPS = {"per_ray_fixed": 420, "per_mode": 90, "table_fixed": 27,
           "table_per_mode": 7}


class ModeRuns(NamedTuple):
    """The modes as the kernel walks them: ``layout`` the runs (m, n0,
    len), each len consecutive modes of one m with n = n0, n0 + 1, ..., in
    the tables' order; ``runs`` the same as an (R, 3) int32 tensor on the
    tables' device; ``nfp`` the period count, xn = n nfp."""
    runs: torch.Tensor
    layout: tuple
    nfp: int


def mode_runs(xm, xn) -> ModeRuns:
    """The :class:`ModeRuns` of the mode numbers ``xm``, ``xn`` (G,).

    m = xm and n = xn / nfp must be integers, m >= 0, with nfp the
    greatest common divisor of the nonzero |xn| (1 if there is none): every
    VMEC file's modes are.  Any other mode set raises.  VMEC's order is
    m-major with n ascending, one run for each m; any order works, with
    shorter runs.  One copy of the mode numbers to the host."""
    m = xm.detach().double().cpu().numpy()
    xn_ = xn.detach().double().cpu().numpy()
    if not (np.array_equal(m, np.round(m)) and np.array_equal(
            xn_, np.round(xn_)) and (m >= 0).all()):
        raise ValueError("the VMEC geometry kernel takes integer mode "
                         "numbers xm >= 0 and xn")
    m, xn_ = m.astype(np.int64), xn_.astype(np.int64)
    nfp = int(np.gcd.reduce(np.abs(xn_))) or 1
    n = xn_ // nfp
    layout = []
    for mj, nj in zip(m.tolist(), n.tolist()):
        last = layout[-1] if layout else None
        if last and last[0] == mj and last[1] + last[2] == nj:
            layout[-1] = (mj, last[1], last[2] + 1)
        else:
            layout.append((mj, nj, 1))
    runs = torch.tensor(layout, dtype=torch.int32).to(xm.device)
    return ModeRuns(runs, tuple(layout), nfp)


class JetTables(NamedTuple):
    """K4's inputs besides (s, u, v): the per-mode tables, cell-major.

    ``rz`` (ns_f, 4, 2 G): per cell and Horner coefficient, the G rmnc
    then the G zmns modes; ``lm`` (ns_h, 4, G) the lmns modes on the half
    grid; ``xm``/``xn`` (G,) each mode's numbers (the plain version's); the
    grid scalars.  The kernel's: ``modes`` the mode numbers as runs
    (:func:`mode_runs`); ``rz_by_mode`` (ns_f, G, 8) and ``lm_by_mode``
    (ns_h, G, 4) the same coefficients with a mode's Horner coefficients
    together (rmnc then zmns).  :func:`make_jet_tables` builds them."""
    rz: torch.Tensor
    lm: torch.Tensor
    xm: torch.Tensor
    xn: torch.Tensor
    sminf: float
    sminh: float
    ds: float
    modes: ModeRuns
    rz_by_mode: torch.Tensor
    lm_by_mode: torch.Tensor


def make_jet_tables(rz, lm, xm, xn, sminf, sminh, ds) -> JetTables:
    """:class:`JetTables` from its tensors and grid scalars, with the
    kernel's mode runs derived from ``xm``, ``xn`` (a mode set that is not
    integer raises) and its mode-major copies of the tables."""
    g = lm.shape[-1]
    rz_by_mode = torch.cat([rz[..., :g], rz[..., g:]], dim=1)
    return JetTables(rz, lm, xm, xn, float(sminf), float(sminh), float(ds),
                     mode_runs(xm, xn),
                     rz_by_mode.transpose(1, 2).contiguous(),
                     lm.transpose(1, 2).contiguous())


def jet_tables(eq) -> JetTables:
    """The :class:`JetTables` of a VMEC equilibrium: its own per-mode
    tables (not the dense mode grid, whose empty slots hold zeros), built
    once per equilibrium object (a replaced table makes a new object, and
    with it new tables)."""
    tables = eq._cache.get("jet")
    if tables is None:
        with torch.no_grad():
            rz = torch.cat([eq.rmnc_coeffs, eq.zmns_coeffs], dim=-1)
            tables = make_jet_tables(
                rz.contiguous(), eq.lmns_coeffs.detach().contiguous(),
                eq.xm.contiguous(), eq.xn.contiguous(), eq.sminf, eq.sminh,
                eq.ds)
        eq._cache["jet"] = tables
    return tables


def reference_jet(s, u, v, tables: JetTables):
    """Plain version: the (27, n) jet sums (``JET_NAMES``) of the rays
    (s, u, v), each (n,), over the whole tables."""
    rz, lm = tables.rz, tables.lm
    g = lm.shape[-1]
    ds = tables.ds

    def radial(table, smin):
        idx = table_index_1d(s, ds, smin, table.shape[0])
        ul = ((s - smin) / ds - idx.to(s.dtype)).unsqueeze(-1)
        blk = table[idx]
        return blk[:, 0], blk[:, 1], blk[:, 2], blk[:, 3], ul

    c0, c1, c2, c3, ul = radial(rz, tables.sminf)
    val = c0 + ul * (c1 + ul * (c2 + ul * c3))
    dval = (c1 + ul * (2.0 * c2 + 3.0 * ul * c3)) / ds
    d2val = (2.0 * c2 + 6.0 * ul * c3) / (ds * ds)
    rm, zm = val[:, :g], val[:, g:]
    rms, zms = dval[:, :g], dval[:, g:]
    rmss, zmss = d2val[:, :g], d2val[:, g:]
    l0, l1, l2, l3, uh = radial(lm, tables.sminh)
    lmv = l0 + uh * (l1 + uh * (l2 + uh * l3))
    lms = (l1 + uh * (2.0 * l2 + 3.0 * uh * l3)) / ds

    xm, xn = tables.xm, tables.xn
    ang = u.unsqueeze(-1) * xm - v.unsqueeze(-1) * xn
    ca, sa = torch.cos(ang), torch.sin(ang)

    def sm(t):
        return t.sum(-1)

    rm_sa, rm_ca = rm * sa, rm * ca
    zm_sa, zm_ca = zm * sa, zm * ca
    lm_sa, lm_ca = lmv * sa, lmv * ca
    rms_sa, zms_ca = rms * sa, zms * ca
    return torch.stack([
        sm(rm_ca), sm(zm_sa), sm(rms * ca), -sm(xm * rm_sa),
        sm(xn * rm_sa), sm(zms * sa), sm(xm * zm_ca), -sm(xn * zm_ca),
        sm(xm * lm_ca), -sm(xn * lm_ca),
        sm(rmss * ca), -sm(xm * rms_sa), sm(xn * rms_sa),
        -sm(xm * xm * rm_ca), sm(xm * xn * rm_ca), -sm(xn * xn * rm_ca),
        sm(zmss * sa), sm(xm * zms_ca), -sm(xn * zms_ca),
        -sm(xm * xm * zm_sa), sm(xm * xn * zm_sa), -sm(xn * xn * zm_sa),
        sm(xm * lms * ca), -sm(xn * lms * ca),
        -sm(xm * xm * lm_sa), sm(xm * xn * lm_sa), -sm(xn * xn * lm_sa)])


def _check(s, u, v, tables):
    build.check("the VMEC geometry kernel", (s, u, v) + tuple(tables[:4]),
                "coordinates and tables")
    if s.ndim != 1 or u.shape != s.shape or v.shape != s.shape:
        raise ValueError("s, u and v must be 1-D of one length")
    rz, lm, xm, xn = tables[:4]
    g = lm.shape[-1] if lm.ndim == 3 else -1
    if (rz.ndim != 3 or lm.ndim != 3 or rz.shape[1:] != (4, 2 * g)
            or lm.shape[1] != 4 or xm.shape != (g,) or xn.shape != (g,)):
        raise ValueError(
            f"tables must be rz (ns_f, 4, 2G), lm (ns_h, 4, G), xm and xn "
            f"(G,); got {tuple(rz.shape)}, {tuple(lm.shape)}, "
            f"{tuple(xm.shape)}, {tuple(xn.shape)}")
    for a, shape in ((tables.rz_by_mode, (rz.shape[0], g, 8)),
                     (tables.lm_by_mode, (lm.shape[0], g, 4))):
        if (a.shape != shape or a.device != s.device or a.dtype != s.dtype
                or not a.is_contiguous() or a.data_ptr() % 16):
            raise ValueError("the kernel's mode-major tables do not match "
                             "rz and lm: build the tables with "
                             "make_jet_tables")
    runs = tables.modes.runs
    if (sum(r[2] for r in tables.modes.layout) != g
            or runs.device != s.device or runs.dtype != torch.int32
            or runs.shape != (len(tables.modes.layout), 3)
            or not runs.is_contiguous()):
        raise ValueError("the tables' mode runs do not describe their G "
                         "modes on their device: build the tables with "
                         "make_jet_tables")


def launch(s, u, v, tables):
    """K4 on the current stream, without :func:`geometry_jet`'s checks: a
    new (27, n) tensor."""
    global vmec_geom_launches
    n = s.shape[0]
    out = torch.empty((len(JET_NAMES), n), dtype=s.dtype, device=s.device)
    if n == 0:
        return out
    rz, lm = tables.rz_by_mode, tables.lm_by_mode
    runs = tables.modes.runs
    params = (ctypes.c_double * 4)(tables.sminf, tables.sminh, tables.ds,
                                   tables.modes.nfp)
    build.call(build.load().gft_vmec_geom, "vmec_geom", s,
               build.DTYPE_CODES[s.dtype], n, s.data_ptr(), u.data_ptr(),
               v.data_ptr(), rz.data_ptr(), lm.data_ptr(), runs.data_ptr(),
               runs.shape[0], rz.shape[0], lm.shape[0], lm.shape[1], params,
               out.data_ptr())
    vmec_geom_launches += 1
    check_kernel_outputs("vmec_geom (K4)", ("the jet sums",), (out,),
                         (s, u, v))
    return out


def geometry_jet(s, u, v, tables: JetTables):
    """The (27, n) jet sums of the rays (s, u, v) over ``tables``.

    CPU tensors run :func:`reference_jet`; CUDA tensors launch K4 on the
    current stream and return a new tensor.  Anything the kernel does not
    take raises.  No gradient: see :class:`FusedGeometry`."""
    _check(s, u, v, tables)
    if s.device.type == "cpu":
        return reference_jet(s, u, v, tables)
    return launch(s, u, v, tables)


class FusedGeometry(torch.autograd.Function):
    """``apply(s, u, v, tables)`` -> the 10 geometry sums (r, z, drs, dru,
    drv, dzs, dzu, dzv, dlu, dlv), differentiable once in (s, u, v).

    Forward runs :func:`geometry_jet` once and saves jet sums 2..26 (the
    first-order sums 2..9 and the 17 second partials); backward gives
    ct_d = sum_o J[o, d] ct_o with J[o] = jet[JVP_IDX[o]] - no second
    launch.  The tables get no gradient; a backward that would itself be
    differentiated (``create_graph=True``) raises."""

    @staticmethod
    def forward(ctx, s, u, v, tables):
        jet = geometry_jet(s.detach(), u.detach(), v.detach(), tables)
        ctx.save_for_backward(jet[2:])
        return tuple(jet[:10].unbind(0))

    @staticmethod
    def backward(ctx, *cts):
        # create_graph=True asks for a differentiable backward, whose
        # derivative in (s, u, v) would need the jet's third order: refuse
        # it here (torch's once_differentiable raises only when the second
        # pass happens to reach its error node, and can miss it)
        if torch.is_grad_enabled():
            raise RuntimeError(
                "the fused VMEC geometry (K4) is differentiable once: a "
                "second derivative (create_graph=True) needs "
                "fused_mode_sums=False")
        # (autograd hands zeros, not None, for outputs that got no gradient)
        (partials,) = ctx.saved_tensors
        d = (partials[_jvp_rows(partials.device)]
             * torch.stack(cts)[:, None]).sum(0)
        return d[0], d[1], d[2], None


_JVP_ROWS: dict = {}


def _jvp_rows(device):
    """JVP_IDX as a (10, 3) index into the saved partials (jet rows 2..26),
    made once per device and index table: a copy to the card at every
    backward would wait for the stream."""
    key = (str(device), tuple(map(tuple, JVP_IDX)))
    if key not in _JVP_ROWS:
        _JVP_ROWS[key] = torch.tensor(key[1], device=device) - 2
    return _JVP_ROWS[key]


def fused_geometry(eq, s, u, v):
    """The 10 geometry sums of ``eq`` at the rays (s, u, v) through
    :class:`FusedGeometry` (``models.vmec._rzl_and_jac`` under
    ``fused_mode_sums``).  The tables are constants of the kernel: one
    that requires grad is refused rather than cut silently."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (eq.rmnc_coeffs, eq.zmns_coeffs,
                                      eq.lmns_coeffs)):
        raise ValueError("the fused VMEC geometry (K4) takes the tables as "
                         "constants: build the equilibrium with "
                         "fused_mode_sums=False for table gradients")
    return FusedGeometry.apply(s, u, v, jet_tables(eq))
