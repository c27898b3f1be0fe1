"""The freeze-window step: CUDA kernel wrapper and its plain version.

Counterpart of ``graph_framework_tpu.pallas.efit_step`` (the TPU kernel
``_window_kernel`` and its launcher ``make_frozen_window_step``).  One
call advances every ray through one freeze window: the window-base freeze
gather (``EfitEquilibrium.freeze_cells``), then ``steps`` rk2/rk4 substeps
of the cold-plasma ray equations against the frozen blocks, plain or with
compensated TwoSum accumulation.

* :func:`frozen_window` is the plain PyTorch version - freeze_cells, then
  K x stepper with the autograd right-hand side, the algebra of the JAX
  package's XLA frozen path (solver.py:285-345).  It takes any dispersion.
* :func:`efit_window` is the wrapper.  For CPU tensors, and only then, it
  runs the plain version with ``cold_plasma``.  For CUDA tensors it
  launches the hand-written kernel ``csrc/efit_window.cu`` (built by
  ``nvcc`` on first use, kernels/build.py) or raises: there is no
  fallback.  ``efit_window_launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from graph_framework_tpu_torch.constants import (
    C, EPSILON0, ME, Q)
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.models.rays import RayState, make_ray_rhs
from graph_framework_tpu_torch.ops.compensated import (
    CompCarry, compensated_stepper)
from graph_framework_tpu_torch.ops.integrators import INCREMENTS, STEPPERS

#: Kernel launches made by :func:`efit_window` (plain-version calls on CPU
#: tensors do not count).
efit_window_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
_METHOD_CODES = {"rk2": 2, "rk4": 4}


def frozen_window(eq, dispersion, carry, *, method, dt, steps,
                  compensated):
    """Plain version: one freeze window of ``steps`` substeps.

    ``carry`` is a RayState, or a CompCarry when ``compensated`` (frozen
    at its hi words).  Returns the advanced carry."""
    hi = carry.hi if compensated else carry
    feq = eq.freeze_cells(torch.stack([hi.x, hi.y, hi.z]))
    rhs = make_ray_rhs(dispersion, feq)
    if compensated:
        step = compensated_stepper(lambda s: INCREMENTS[method](rhs, s, dt))
    else:
        def step(s):
            return STEPPERS[method](rhs, s, dt)
    for _ in range(steps):
        carry = step(carry)
    return carry


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


def _launch(eq, leaves, method, dt, steps, compensated):
    from graph_framework_tpu_torch.kernels import build

    global efit_window_launches
    _check_launch(eq, leaves, method, steps)
    x = leaves[0]
    n = x.shape[0]
    outs = [torch.empty_like(a) for a in leaves]
    if n == 0:
        return outs
    lib = build.load()
    ns = len(leaves)
    ptr_in = (ctypes.c_void_p * ns)(*[a.data_ptr() for a in leaves])
    ptr_out = (ctypes.c_void_p * ns)(*[a.data_ptr() for a in outs])
    params = (ctypes.c_double * 13)(*kernel_params(eq, dt))
    psi, prof = eq.psi_coeffs, eq.profile_coeffs
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gft_efit_window(
            _DTYPE_CODES[x.dtype], _METHOD_CODES[method], int(compensated),
            steps, n, ptr_in, ptr_out, psi.data_ptr(),
            psi.shape[0], psi.shape[1], prof.data_ptr(), prof.shape[0],
            params, stream)
    if rc != 0:
        raise RuntimeError(f"efit_window kernel launch failed ({rc}): "
                           f"{build.error_string(rc)}")
    efit_window_launches += 1
    return outs


def efit_window(eq, carry, *, method, dt, steps, compensated):
    """Advance ``carry`` (RayState, or CompCarry when ``compensated``)
    through one freeze window of ``steps`` substeps of cold-plasma rays
    over the EFIT equilibrium ``eq``.

    CPU tensors run :func:`frozen_window`; CUDA tensors launch the kernel
    on the current stream and return new tensors (the kernel allocates
    nothing; this wrapper allocates the outputs).  Anything the kernel
    does not take raises.
    """
    leaves = _leaves(carry, compensated)
    device = leaves[0].device
    if device.type == "cpu":
        return frozen_window(eq, cold_plasma, carry, method=method, dt=dt,
                             steps=steps, compensated=compensated)
    if device.type != "cuda":
        raise ValueError(f"window kernel runs on cuda (or cpu via the "
                         f"plain version), not {device}")
    outs = _launch(eq, leaves, method, dt, steps, compensated)
    if compensated:
        return CompCarry(RayState(*outs[:8]), RayState(*outs[8:]))
    return RayState(*outs)

