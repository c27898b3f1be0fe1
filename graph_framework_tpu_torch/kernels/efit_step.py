"""The freeze-window step: CUDA kernel wrappers and their plain versions.

Counterpart of ``graph_framework_tpu.pallas.efit_step`` (the TPU kernels
``_window_kernel``, ``_window_bwd_kernel`` and ``_window_bwd_tab_kernel``
and their launcher ``make_frozen_window_step``).  One call advances every
ray through one freeze window: the window-base freeze gather
(``EfitEquilibrium.freeze_cells``), then ``steps`` rk2/rk4 substeps of the
cold-plasma ray equations against the frozen blocks, plain or with
compensated TwoSum accumulation.

* :func:`frozen_window` is the plain PyTorch version - freeze_cells, then
  K x stepper with the autograd right-hand side, the algebra of the JAX
  package's XLA frozen path (solver.py:285-345).  It takes any dispersion.
* :func:`frozen_window_vjp` and :func:`frozen_window_vjp_blocks` are the
  plain versions of the backward kernels: autograd of
  :func:`frozen_window`, the second also with the gathered coefficient
  blocks as autograd leaves (their per-ray cotangents).
* :func:`efit_window` is the wrapper.  For CPU tensors, and only then, it
  runs the plain versions with ``cold_plasma``.  For CUDA tensors it
  launches the hand-written kernels (``csrc/efit_window.cu`` forward,
  ``csrc/efit_window_bwd.cu`` backward; built by ``nvcc`` on first use,
  kernels/build.py) or raises: there is no fallback.  When the state or
  the spline tables require grad, the plain window goes through
  :class:`EfitWindow`, whose backward launches K2 or, when a table needs a
  gradient, K3 and scatters its block cotangents into the tables.  The
  compensated window is forward-only, as in the JAX package.
  ``efit_window_launches``, ``efit_window_bwd_launches`` and
  ``efit_window_bwd_tab_launches`` count the kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from graph_framework_tpu_torch.constants import (
    C, EPSILON0, ME, Q)
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.models.rays import RayState, make_ray_rhs
from graph_framework_tpu_torch.ops.compensated import (
    CompCarry, compensated_stepper)
from graph_framework_tpu_torch.ops.integrators import INCREMENTS, STEPPERS

#: Kernel launches of the forward window (K1), the window VJP (K2) and the
#: window VJP with block cotangents (K3); plain-version calls on CPU
#: tensors do not count.
efit_window_launches = 0
efit_window_bwd_launches = 0
efit_window_bwd_tab_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
_METHOD_CODES = {"rk2": 2, "rk4": 4}


def frozen_window(eq, dispersion, carry, *, method, dt, steps,
                  compensated):
    """Plain version: one freeze window of ``steps`` substeps.

    ``carry`` is a RayState, or a CompCarry when ``compensated`` (frozen
    at its hi words).  Returns the advanced carry."""
    hi = carry.hi if compensated else carry
    feq = eq.freeze_cells(torch.stack([hi.x, hi.y, hi.z]))
    return _frozen_steps(feq, dispersion, carry, method, dt, steps,
                         compensated)


def _frozen_steps(feq, dispersion, carry, method, dt, steps, compensated):
    """``steps`` substeps against the frozen view ``feq``."""
    rhs = make_ray_rhs(dispersion, feq)
    if compensated:
        step = compensated_stepper(lambda s: INCREMENTS[method](rhs, s, dt))
    else:
        def step(s):
            return STEPPERS[method](rhs, s, dt)
    for _ in range(steps):
        carry = step(carry)
    return carry


class WindowVjp(NamedTuple):
    """The cotangents one window's backward gives: of the window-input
    state and, when asked for, each ray's psi and profile coefficient
    blocks (n, 16) with the rows of the tables they were gathered from
    (``psi_coeffs.reshape(nr * nz, 16)`` and
    ``profile_coeffs.reshape(npsi, 16)``)."""
    state: RayState
    psi_block: Optional[torch.Tensor] = None
    prof_block: Optional[torch.Tensor] = None
    psi_cell: Optional[torch.Tensor] = None
    prof_cell: Optional[torch.Tensor] = None


def _window_vjp(eq, state, ct, method, dt, steps, blocks):
    """Autograd of :func:`frozen_window` (plain, cold_plasma): pull the
    window-output cotangent ``ct`` back to the window input and, with
    ``blocks``, to the gathered coefficient blocks.  The freeze indices
    carry no gradient, as in the JAX package's transpose."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(True) for a in state]
        feq = eq.freeze_cells(torch.stack(leaves[2:5]).detach())
        psi_blk = feq.psi_block.detach().requires_grad_(blocks)
        prof_blk = feq.prof_block.detach().requires_grad_(blocks)
        feq = dataclasses.replace(feq, psi_block=psi_blk,
                                  prof_block=prof_blk)
        s = _frozen_steps(feq, cold_plasma, RayState(*leaves), method, dt,
                          steps, False)
        inputs = leaves + ([psi_blk, prof_blk] if blocks else [])
        grads = torch.autograd.grad(list(s), inputs, grad_outputs=list(ct),
                                    allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(inputs, grads)]
    d_state = RayState(*grads[:8])
    if not blocks:
        return WindowVjp(d_state)
    nz = eq.psi_coeffs.shape[1]
    n = leaves[0].shape[0]
    return WindowVjp(d_state, grads[8], grads[9].reshape(n, 16),
                     feq.iu.long() * nz + feq.jv.long(), feq.pidx.long())


def frozen_window_vjp(eq, state, ct, *, method, dt, steps):
    """Plain version of K2: the window-input cotangent (a RayState) of one
    plain cold-plasma window from ``state``, for the output cotangent
    ``ct`` (a RayState).  The frozen blocks get none."""
    return _window_vjp(eq, state, ct, method, dt, steps, False).state


def frozen_window_vjp_blocks(eq, state, ct, *, method, dt, steps):
    """Plain version of K3: :func:`frozen_window_vjp` plus each ray's
    psi- and profile-block cotangents, summed over the window's substeps
    and stages, and the table rows they belong to (a :class:`WindowVjp`)."""
    return _window_vjp(eq, state, ct, method, dt, steps, True)


def kernel_params(eq, dt):
    """The kernel's 13 float parameters (csrc/efit_window.cu
    gft_efit_window): the grid and profile normalization, the plasma and
    cyclotron frequency factors folded in double exactly as
    constants.plasma_frequency_squared / cyclotron_frequency fold them,
    and dt."""
    mi = eq.ion_masses[0]
    qi = float(eq.ion_charges[0]) * Q
    return [eq.rmin, eq.dr, eq.zmin, eq.dz, eq.psimin, eq.dpsi,
            eq.ne_scale, eq.te_scale,
            Q * Q / (EPSILON0 * ME * C * C), -Q / (ME * C),
            qi * qi / (EPSILON0 * mi * C * C), qi / (mi * C),
            float(dt)]


def _leaves(carry, compensated):
    if compensated:
        if not isinstance(carry, CompCarry):
            raise TypeError("compensated=True needs a CompCarry")
        return list(carry.hi) + list(carry.lo)
    if not isinstance(carry, RayState):
        raise TypeError("compensated=False needs a RayState")
    return list(carry)


def _check_launch(eq, leaves, method, steps):
    if method not in _METHOD_CODES:
        raise ValueError(f"window kernel supports rk2/rk4, not {method!r}")
    if not isinstance(steps, int) or steps < 1:
        raise ValueError(f"steps={steps!r} must be a positive int")
    x = leaves[0]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"window kernel takes float32/float64, not "
                        f"{x.dtype}")
    for a in leaves:
        if (a.device != x.device or a.dtype != x.dtype or a.ndim != 1
                or a.shape != x.shape or not a.is_contiguous()):
            raise ValueError(
                "window kernel needs contiguous 1-D state leaves of one "
                "shape, dtype and device")
    if not eq.cell_local:
        raise ValueError("window kernel needs cell_local tables")
    if eq.num_ion_species != 1:
        raise ValueError("window kernel takes exactly one ion species")
    psi, prof = eq.psi_coeffs, eq.profile_coeffs
    for name, t, tail in (("psi_coeffs", psi, (4, 4)),
                          ("profile_coeffs", prof, (4, 4))):
        if (t.device != x.device or t.dtype != x.dtype
                or not t.is_contiguous() or tuple(t.shape[-2:]) != tail):
            raise ValueError(
                f"{name} must be contiguous, on {x.device}, {x.dtype}, "
                f"with trailing shape {tail}; got {t.device} {t.dtype} "
                f"{tuple(t.shape)}")
    if psi.ndim != 4 or prof.ndim != 3 or prof.shape[1] != 4:
        raise ValueError("psi_coeffs must be (nr, nz, 4, 4) and "
                         "profile_coeffs (npsi, 4, 4)")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[a.data_ptr() for a in tensors])


def _launch(eq, leaves, method, dt, steps, compensated):
    """K1 on the current stream: the advanced leaves, in new tensors."""
    from graph_framework_tpu_torch.kernels import build

    global efit_window_launches
    _check_launch(eq, leaves, method, steps)
    x = leaves[0]
    n = x.shape[0]
    outs = [torch.empty_like(a) for a in leaves]
    if n == 0:
        return outs
    lib = build.load()
    params = (ctypes.c_double * 13)(*kernel_params(eq, dt))
    psi, prof = eq.psi_coeffs, eq.profile_coeffs
    with torch.cuda.device(x.device):
        rc = lib.gft_efit_window(
            _DTYPE_CODES[x.dtype], _METHOD_CODES[method], int(compensated),
            steps, n, _pointers(leaves), _pointers(outs), psi.data_ptr(),
            psi.shape[0], psi.shape[1], prof.data_ptr(), prof.shape[0],
            params, _stream(x))
    if rc != 0:
        raise RuntimeError(f"efit_window kernel launch failed ({rc}): "
                           f"{build.error_string(rc)}")
    efit_window_launches += 1
    return outs


def _launch_bwd(eq, leaves, cts, method, dt, steps, tables):
    """K2 (or K3 with ``tables``) on the current stream: a WindowVjp."""
    from graph_framework_tpu_torch.kernels import build

    global efit_window_bwd_launches, efit_window_bwd_tab_launches
    _check_launch(eq, leaves + cts, method, steps)
    x = leaves[0]
    n = x.shape[0]
    outs = [torch.empty_like(a) for a in leaves]
    blocks = cells = None
    if tables:
        blocks = torch.empty((2, 16, n), dtype=x.dtype, device=x.device)
        cells = torch.empty((2, n), dtype=torch.int64, device=x.device)
    if n:
        lib = build.load()
        params = (ctypes.c_double * 13)(*kernel_params(eq, dt))
        psi, prof = eq.psi_coeffs, eq.profile_coeffs
        with torch.cuda.device(x.device):
            rc = lib.gft_efit_window_bwd(
                _DTYPE_CODES[x.dtype], _METHOD_CODES[method], steps, n,
                _pointers(leaves), _pointers(cts), _pointers(outs),
                psi.data_ptr(), psi.shape[0], psi.shape[1], prof.data_ptr(),
                prof.shape[0], params,
                blocks[0].data_ptr() if tables else None,
                blocks[1].data_ptr() if tables else None,
                cells[0].data_ptr() if tables else None,
                cells[1].data_ptr() if tables else None,
                _stream(x))
        if rc != 0:
            raise RuntimeError(f"efit_window_bwd kernel launch failed "
                               f"({rc}): {build.error_string(rc)}")
        if tables:
            efit_window_bwd_tab_launches += 1
        else:
            efit_window_bwd_launches += 1
    if not tables:
        return WindowVjp(RayState(*outs))
    return WindowVjp(RayState(*outs), blocks[0].t(), blocks[1].t(),
                     cells[0], cells[1])


def _device_of(leaves):
    device = leaves[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"window kernel runs on cuda (or cpu via the "
                         f"plain version), not {device}")
    return device


def efit_window_vjp(eq, state, ct, *, method, dt, steps, tables=False):
    """The backward of one plain window: a :class:`WindowVjp` for the
    window-input ``state`` and the output cotangent ``ct`` (RayStates).

    CPU tensors run :func:`frozen_window_vjp` (``tables=False``) or
    :func:`frozen_window_vjp_blocks`; CUDA tensors launch K2 or K3 on the
    current stream.  Anything the kernels do not take raises."""
    leaves, cts = list(state), [c.contiguous() for c in ct]
    if _device_of(leaves).type == "cpu":
        return _window_vjp(eq, RayState(*leaves), RayState(*cts), method,
                           dt, steps, tables)
    return _launch_bwd(eq, leaves, cts, method, dt, steps, tables)


def scatter_block_cotangents(eq, vjp):
    """The table gradients of a :class:`WindowVjp` with block cotangents:
    each ray's blocks added into the table rows it was gathered from (the
    transpose of the freeze gather).  On CUDA ``index_add_`` adds with
    atomics, so the order of the sums - and the last bits of a row that
    several rays share - varies from run to run."""
    psi, prof = eq.psi_coeffs, eq.profile_coeffs
    rows = psi.shape[0] * psi.shape[1]
    d_psi = torch.zeros((rows, 16), dtype=psi.dtype, device=psi.device)
    d_psi.index_add_(0, vjp.psi_cell, vjp.psi_block)
    d_prof = torch.zeros((prof.shape[0], 16), dtype=prof.dtype,
                         device=prof.device)
    d_prof.index_add_(0, vjp.prof_cell, vjp.prof_block)
    return d_psi.reshape(psi.shape), d_prof.reshape(prof.shape)


def _with_tables(eq, psi_table, prof_table):
    """``eq`` with these spline tables (``eq`` itself when it holds them:
    ``dataclasses.replace`` costs host time on every window)."""
    if psi_table is eq.psi_coeffs and prof_table is eq.profile_coeffs:
        return eq
    return dataclasses.replace(eq, psi_coeffs=psi_table,
                               profile_coeffs=prof_table)


class EfitWindow(torch.autograd.Function):
    """One plain window with reverse mode (the JAX package's ``window8``
    and ``windowt`` custom_vjps in one Function).

    ``apply(eq, method, dt, steps, psi_table, prof_table, *leaves)``
    returns the 8 advanced leaves.  Forward runs K1 (the plain version on
    CPU tensors) and saves only the window inputs and the tables; backward
    recomputes inside K2 - or K3 when ``psi_table`` or ``prof_table``
    needs a gradient, whose block cotangents are then scattered into the
    tables.  ``eq`` supplies the grid scalars; its tables are replaced by
    the two passed in.
    """

    @staticmethod
    def forward(ctx, eq, method, dt, steps, psi_table, prof_table, *leaves):
        eq = _with_tables(eq, psi_table, prof_table)
        ctx.eq, ctx.method, ctx.dt, ctx.steps = eq, method, dt, steps
        ctx.save_for_backward(psi_table, prof_table, *leaves)
        if _device_of(leaves).type == "cpu":
            out = frozen_window(eq, cold_plasma, RayState(*leaves),
                                method=method, dt=dt, steps=steps,
                                compensated=False)
        else:
            out = _launch(eq, list(leaves), method, dt, steps, False)
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, *cts):
        psi_table, prof_table, *leaves = ctx.saved_tensors
        eq = _with_tables(ctx.eq, psi_table, prof_table)
        cts = RayState(*[torch.zeros_like(a) if c is None else c
                         for a, c in zip(leaves, cts)])
        want_psi, want_prof = ctx.needs_input_grad[4:6]
        vjp = efit_window_vjp(eq, RayState(*leaves), cts,
                              method=ctx.method, dt=ctx.dt, steps=ctx.steps,
                              tables=want_psi or want_prof)
        d_psi = d_prof = None
        if want_psi or want_prof:
            d_psi, d_prof = scatter_block_cotangents(eq, vjp)
        return (None, None, None, None, d_psi if want_psi else None,
                d_prof if want_prof else None, *vjp.state)


def efit_window(eq, carry, *, method, dt, steps, compensated):
    """Advance ``carry`` (RayState, or CompCarry when ``compensated``)
    through one freeze window of ``steps`` substeps of cold-plasma rays
    over the EFIT equilibrium ``eq``.

    CPU tensors run :func:`frozen_window`; CUDA tensors launch the kernel
    on the current stream and return new tensors (the kernel allocates
    nothing; this wrapper allocates the outputs).  When grad mode is on
    and a state leaf or ``eq``'s ``psi_coeffs`` / ``profile_coeffs``
    requires grad, the plain window runs through :class:`EfitWindow` (K1
    forward, K2/K3 backward on CUDA); the compensated window then raises,
    since it is forward-only.  Anything the kernels do not take raises.
    """
    leaves = _leaves(carry, compensated)
    device = _device_of(leaves)
    wants_grad = torch.is_grad_enabled() and any(
        a.requires_grad for a in leaves + [eq.psi_coeffs, eq.profile_coeffs])
    if wants_grad:
        if compensated:
            raise ValueError(
                "the compensated window is forward-only (as in the JAX "
                "package): take gradients through compensated=False")
        return RayState(*EfitWindow.apply(eq, method, dt, steps,
                                          eq.psi_coeffs, eq.profile_coeffs,
                                          *leaves))
    if device.type == "cpu":
        return frozen_window(eq, cold_plasma, carry, method=method, dt=dt,
                             steps=steps, compensated=compensated)
    outs = _launch(eq, leaves, method, dt, steps, compensated)
    if compensated:
        return CompCarry(RayState(*outs[:8]), RayState(*outs[8:]))
    return RayState(*outs)
