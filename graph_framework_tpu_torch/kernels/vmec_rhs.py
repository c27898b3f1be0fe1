"""The VMEC ray right-hand side (K8): CUDA kernel wrapper and plain version.

It replaces no TPU kernel: the JAX package takes the ray equations in flux
coordinates from one ``jax.grad`` of D, which XLA fuses, where the port's
eager path (``models.rays.make_ray_rhs``) dispatches the geometry's
assembly, D and an ``autograd.grad`` pass operation by operation.  Per ray
it maps the state (w, s, u, v, k_s, k_u, k_v) and K4's (27, n) geometry jet
at (s, u, v) (``kernels.vmec_geom``) to the six ray derivatives, the chain
rule taken by hand:

* the 10 geometry sums as values with their (s, u, v) partials, read from
  the jet (``vmec_geom.JVP_IDX``);
* ``models.vmec._assemble_geometry`` carried on those: rot(v), the bases,
  the Jacobian, jbsupu and jbsupv with dchi/ds and d2chi/ds2 from the
  ray's cell of the chi table, B and kvec = k_i e^i;
* the profiles ne = 1e19 p(s), p = (1 - |s|^1.5)^2, and dp/ds; VMEC's ion
  density is ne;
* D's partials over w and kvec and the adjoints of ne, the ion density and
  B by the hand-written cold-plasma sweep (``csrc/efit_adjoint.cuh``
  ``ColdPlasma::adjoint``), contracted with the tangents into the total
  dD/d(s, u, v), through the basis too (the canonical form), and dD/dk_i =
  dD/dkvec . e^i;
* (-D_k / D_w, D_x / D_w), the six leaves of ``RayDerivatives``.

* :func:`ray_rhs_plain` is the plain PyTorch version: the same hand chain
  over the jet's rows, no autograd (:class:`_Dual` carries the partials).
* :func:`ray_rhs` is the wrapper: for CPU tensors, and only then, it runs
  the plain version; for float32 and float64 CUDA tensors it launches the
  hand-written kernel of ``csrc/vmec_rhs.cu`` (built by ``nvcc`` on first
  use, kernels/build.py) on the current stream, reading the leaves'
  pointers as they are, or raises: there is no fallback.
  ``vmec_rhs_launches`` counts its launches; each is the span
  ``gft.vmec_rhs`` (``telemetry``).
* :func:`launch` is the launch without the wrapper's checks, for a caller
  whose first call went through :func:`ray_rhs`
  (``models.vmec.VmecEquilibrium.value_rhs``, which routes the ray RHS's
  value path through K4 and K8).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from graph_framework_tpu_torch import telemetry
from graph_framework_tpu_torch.constants import C, EPSILON0, ME, Q
from graph_framework_tpu_torch.kernels import build, vmec_geom
from graph_framework_tpu_torch.ops.tables import table_index_1d
from graph_framework_tpu_torch.utils import check_kernel_outputs

#: Kernel launches of K8; plain-version calls do not count.
vmec_rhs_launches = 0

#: Floating point operations a ray, counted over csrc/vmec_rhs.cu by
#: tools/count_ops.py (a CPU test holds them to it).
RHS_OPS = {"per_ray": 865}

#: The jet rows of the sums the geometry takes, each with the rows of its
#: (s, u, v) partials (vmec_geom.JVP_IDX): r, drs, dru, drv, dzs, dzu, dzv,
#: dlu, dlv.
_SUMS = tuple((o, vmec_geom.JVP_IDX[o]) for o in (0, 2, 3, 4, 5, 6, 7, 8, 9))


class RhsParams(NamedTuple):
    """K8's inputs besides the state and the jet: the (nchi, 4) cell-local
    chi table and its grid, signj dphi, and ``ColdPlasma::adjoint``'s
    factors q^2/(eps0 me c^2), -q/(me c), qi^2/(eps0 mi c^2), qi/(mi c),
    folded in double; ``array``, the seven floats as the C interface takes
    them."""
    chi: torch.Tensor
    sminf: float
    ds: float
    phip: float
    kpe: float
    kce: float
    kpi: float
    kci: float
    array: ctypes.Array


def rhs_params(eq) -> RhsParams:
    """The :class:`RhsParams` of a VMEC equilibrium, built once per
    equilibrium object."""
    params = eq._cache.get("rhs")
    if params is None:
        mi = eq.ion_masses[0]
        qi = float(eq.ion_charges[0]) * Q
        values = (float(eq.sminf), float(eq.ds), eq.signj * eq.dphi,
                  Q * Q / (EPSILON0 * ME * C * C), -Q / (ME * C),
                  qi * qi / (EPSILON0 * mi * C * C), qi / (mi * C))
        params = RhsParams(eq.chi_coeffs.detach().contiguous(), *values,
                           (ctypes.c_double * len(values))(*values))
        eq._cache["rhs"] = params
    return params


class _Dual:
    """A value and its partials over (s, u, v): the plain version's
    ``Dual<T, 3>`` (csrc/efit_common.cuh), with its operation order."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v, self.d = v, tuple(d)

    def __add__(self, o):
        if isinstance(o, _Dual):
            return _Dual(self.v + o.v, (a + b for a, b in zip(self.d, o.d)))
        return _Dual(self.v + o, self.d)

    __radd__ = __add__

    def __sub__(self, o):
        return _Dual(self.v - o.v, (a - b for a, b in zip(self.d, o.d)))

    def __mul__(self, o):
        if isinstance(o, _Dual):
            return _Dual(self.v * o.v,
                         (a * o.v + self.v * b for a, b in zip(self.d, o.d)))
        return _Dual(self.v * o, (a * o for a in self.d))

    __rmul__ = __mul__

    def recip(self):
        r = 1.0 / self.v
        return _Dual(r, (-(a * r) * r for a in self.d))


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _chi_jet(s, p: RhsParams):
    """dchi/ds at the ray's cell of the cell-local chi table, as a dual
    whose s-partial is d2chi/ds2 (models/vmec.py ``_chi_jet``)."""
    idx = table_index_1d(s, p.ds, p.sminf, p.chi.shape[0])
    tc = (s - p.sminf) / p.ds - idx.to(s.dtype)
    c = p.chi[idx]
    c1, c2, c3 = c[:, 1], c[:, 2], c[:, 3]
    zero = torch.zeros_like(s)
    return _Dual((c1 + tc * (2.0 * c2 + 3.0 * tc * c3)) / p.ds,
                 ((2.0 * c2 + 6.0 * tc * c3) / p.ds / p.ds, zero, zero))


def _profile(s):
    """p(s) = (1 - |s|^1.5)^2 and dp/ds."""
    a = torch.sqrt(s * s)
    ra = torch.sqrt(a)
    pq = 1.0 - a * ra
    return pq * pq, -3.0 * pq * (s / ra)


def _densities(s):
    """(value, d/ds) of the electron and of the ion density: ne = 1e19
    p(s), and the ion density is ne (models/vmec.py ``_VmecView``)."""
    p, dp = _profile(s)
    ne = (1.0e19 * p, 1.0e19 * dp)
    return ne, ne


def _wave_vector(kcov, esup):
    """kvec = k_s e^s + k_u e^u + k_v e^v, each component a dual: its
    partials carry the flow through the basis."""
    return tuple(kcov[0] * esup[0][c] + kcov[1] * esup[1][c]
                 + kcov[2] * esup[2][c] for c in range(3))


class _Species:
    """``Species`` of csrc/efit_adjoint.cuh: one species' terms of e11 and
    e12 and their sweep back."""

    def __init__(self, wp2, c, iw, iw2):
        self.a = wp2 * iw2
        self.q = c * iw
        self.cc_w2 = c * c * iw2
        self.iden = 1.0 / (1.0 - self.cc_w2)
        self.t11 = self.a * self.iden
        self.t12 = (self.q * self.a) * self.iden

    def back(self, c11, c12, c, iw, iw2, w_b, w2_b):
        """(adjoint of c, of w, of w2, of wp2 without its e33 part)."""
        den_b = -(c11 * self.t11 + c12 * self.t12) * self.iden
        a_b = (c11 + c12 * self.q) * self.iden
        q_b = c12 * self.a * self.iden
        w_b = w_b - q_b * self.q * iw
        w2_b = w2_b + (den_b * self.cc_w2 - a_b * self.a) * iw2
        return (q_b * iw - 2.0 * c * den_b * iw2, w_b, w2_b, a_b * iw2)


def _cold_plasma_adjoint(w, k, ne, ni, bv, p: RhsParams):
    """``ColdPlasma::adjoint`` (csrc/efit_adjoint.cuh) with the ion density
    ``ni`` in its te slot: dD/dw, dD/dkvec (3), the adjoints of ne and ni,
    dD/dB (3)."""
    wpe2 = ne * p.kpe
    b_len = torch.sqrt(bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2])
    ib = 1.0 / b_len
    ec = b_len * p.kce
    iw = 1.0 / w
    iw2 = iw * iw
    el = _Species(wpe2, ec, iw, iw2)
    wpi2 = ni * p.kpi
    ic = b_len * p.kci
    io = _Species(wpi2, ic, iw, iw2)
    e11 = (1.0 - el.t11) - io.t11
    m12 = -(el.t12 + io.t12)
    e33w = (wpe2 + wpi2) * iw2

    n = [ki * iw for ki in k]
    bh = [bi * ib for bi in bv]
    n2 = n[0] * n[0] + n[1] * n[1] + n[2] * n[2]
    npara = bh[0] * n[0] + bh[1] * n[1] + bh[2] * n[2]
    npara2 = npara * npara
    nperp2 = n2 - npara2
    m11 = e11 - npara2
    m13_sq = npara2 * nperp2
    m22 = e11 - n2
    m33 = (1.0 - e33w) - nperp2

    m33_b = m11 * m22 - m12 * m12
    m11_b = m22 * m33
    m22_b = m11 * m33 - m13_sq
    c12 = 2.0 * m12 * m33
    m13_b = -m22
    nperp2_b = m13_b * npara2 - m33_b
    n2_b = nperp2_b - m22_b
    npara_b = 2.0 * npara * ((m13_b * nperp2 - m11_b) - nperp2_b)
    n_b = [npara_b * bh[i] + 2.0 * n2_b * n[i] for i in range(3)]
    g_k = [nb * iw for nb in n_b]
    w_b = -((n_b[0] * n[0] + n_b[1] * n[1] + n_b[2] * n[2]) * iw)
    c11 = -(m11_b + m22_b)
    w2_b = m33_b * e33w * iw2
    e33_b = -m33_b * iw2
    ec_b, w_b, w2_b, wpe2_b = el.back(c11, c12, ec, iw, iw2, w_b, w2_b)
    ic_b, w_b, w2_b, wpi2_b = io.back(c11, c12, ic, iw, iw2, w_b, w2_b)
    ne_b = (wpe2_b + e33_b) * p.kpe
    ni_b = (wpi2_b + e33_b) * p.kpi
    g_w = w_b + 2.0 * w * w2_b
    blen_b = ec_b * p.kce + ic_b * p.kci - npara_b * npara * ib
    bb = [npara_b * n[i] * ib + blen_b * bh[i] for i in range(3)]
    return g_w, g_k, ne_b, ni_b, bb


def ray_rhs_plain(leaves, jet, p: RhsParams):
    """Plain version: the six ray derivatives (ds/dt, du/dt, dv/dt, dk_s/dt,
    dk_u/dt, dk_v/dt) of the rays ``leaves`` (w, s, u, v, k_s, k_u, k_v),
    each (n,), from K4's (27, n) ``jet`` at (s, u, v)."""
    w, s, _, v, *kcov = leaves
    r, drs, dru, drv, dzs, dzu, dzv, dlu, dlv = (
        _Dual(jet[o], (jet[i] for i in rows)) for o, rows in _SUMS)
    sv, cv = torch.sin(v), torch.cos(v)
    zero = torch.zeros_like(v)
    c, sn = _Dual(cv, (zero, zero, -sv)), _Dual(sv, (zero, zero, cv))

    esub_s = (drs * c, drs * sn, dzs)
    esub_u = (dru * c, dru * sn, dzu)
    esub_v = (drv * c - r * sn, drv * sn + r * c, dzv)
    cuv = _cross(esub_u, esub_v)
    inv_jac = _dot(esub_s, cuv).recip()
    esup = [[a * inv_jac for a in vec] for vec in (
        cuv, _cross(esub_v, esub_s), _cross(esub_s, esub_u))]

    jbsupu = (_chi_jet(s, p) - p.phip * dlv) * inv_jac
    jbsupv = p.phip * (1.0 + dlu) * inv_jac
    b = [jbsupu * esub_u[k] + jbsupv * esub_v[k] for k in range(3)]
    kvec = _wave_vector(kcov, esup)
    (ne, ne_s), (ni, ni_s) = _densities(s)

    g_w, g_k, ne_b, ni_b, bb = _cold_plasma_adjoint(
        w, [a.v for a in kvec], ne, ni, [a.v for a in b], p)
    dx = [g_k[0] * kvec[0].d[j] + g_k[1] * kvec[1].d[j]
          + g_k[2] * kvec[2].d[j] + bb[0] * b[0].d[j] + bb[1] * b[1].d[j]
          + bb[2] * b[2].d[j] for j in range(3)]
    dx[0] = dx[0] + (ne_b * ne_s + ni_b * ni_s)
    dk = [g_k[0] * esup[j][0].v + g_k[1] * esup[j][1].v
          + g_k[2] * esup[j][2].v for j in range(3)]
    return tuple([-a / g_w for a in dk] + [a / g_w for a in dx])


def _check(leaves, jet, p):
    s = leaves[0]
    build.check("the VMEC ray RHS kernel", (*leaves, jet, p.chi),
                "leaves, jet and chi table")
    if len(leaves) != 7 or s.ndim != 1:
        raise ValueError("the VMEC ray RHS kernel takes seven 1-D leaves "
                         "(w, s, u, v, k_s, k_u, k_v)")
    n = s.shape[0]
    if (any(a.shape != s.shape for a in leaves)
            or jet.shape != (len(vmec_geom.JET_NAMES), n)
            or p.chi.ndim != 2 or p.chi.shape[1] != 4):
        raise ValueError(f"the VMEC ray RHS kernel takes (n,) leaves, a "
                         f"(27, n) jet and a (nchi, 4) chi table; got "
                         f"{[tuple(a.shape) for a in leaves]}, "
                         f"{tuple(jet.shape)}, {tuple(p.chi.shape)}")


def launch(leaves, jet, p):
    """K8 on the current stream, without :func:`ray_rhs`'s checks: the six
    derivatives, rows of a new (6, n) tensor."""
    global vmec_rhs_launches
    s = leaves[0]
    n = s.shape[0]
    out = torch.empty((6, n), dtype=s.dtype, device=s.device)
    if n == 0:
        return tuple(out.unbind(0))
    with telemetry.span("gft.vmec_rhs"):
        build.call(build.load().gft_vmec_rhs, "vmec_rhs", s,
                   build.DTYPE_CODES[s.dtype], n, build.pointers(leaves),
                   jet.data_ptr(), p.chi.data_ptr(), p.chi.shape[0], p.array,
                   out.data_ptr())
    vmec_rhs_launches += 1
    check_kernel_outputs("vmec_rhs (K8)", ("the ray derivatives",), (out,),
                         (*leaves, jet))
    return tuple(out.unbind(0))


def ray_rhs(leaves, jet, params: RhsParams):
    """The six ray derivatives of the rays ``leaves`` (w, s, u, v, k_s, k_u,
    k_v), each (n,), from K4's jet ``jet`` (27, n) at (s, u, v).

    CPU tensors run :func:`ray_rhs_plain`; float32 and float64 CUDA tensors
    launch K8 on the current stream.  Anything the kernel does not take
    raises."""
    _check(leaves, jet, params)
    if leaves[0].device.type == "cpu":
        return ray_rhs_plain(leaves, jet, params)
    return launch(leaves, jet, params)

