"""The slab-field Boris push: CUDA kernel wrapper and its plain version.

Counterpart of ``graph_framework_tpu.pallas.boris`` (the TPU kernel
``_kernel`` and its launcher ``make_slab_push``): ``steps`` relativistic
Boris u'/tau/sigma pushes (xkorc.cpp:87-103) in the analytic slab field
B = z_hat (b1 + b_shear x) / b0 (equilibrium.hpp:611-719), with gamma
recovered each step from the Boris invariant gamma = sqrt(1 + u.u)
(``models.korc.initialize_gamma`` establishes it).  This is the
reference's framework-comparison push (code_performance.dox:42-60).

* :func:`slab_push_plain` is the plain PyTorch version: the same step loop
  in eager PyTorch, in the kernel's order of operations.
* :func:`make_slab_push` builds the wrapper.  For CPU tensors, and only
  then, it runs the plain version; for CUDA tensors it launches the
  hand-written kernel ``csrc/boris.cu`` (built by ``nvcc`` on first use,
  kernels/build.py) on the current stream, or raises: there is no
  fallback.  ``slab_push_launches`` counts the kernel launches.

The kernel has no backward (nor had the TPU kernel): an input that
requires grad is refused rather than cut silently.
"""

from __future__ import annotations

import ctypes

import torch

from graph_framework_tpu_torch.kernels import build
from graph_framework_tpu_torch.utils import check_kernel_outputs

#: Kernel launches of the slab push; plain-version calls do not count.
slab_push_launches = 0

#: Floating point operations per particle and step the function needs,
#: counted over csrc/boris.cu by tools/count_ops.py (a CPU test holds it
#: to it): bz 2 (the quotients folded), 1/gamma and h 8, u' 6, tz and
#: tau^2 2, |u'|^2 5, sigma 2, u*.t 1, 1/gamma' 9, t/gamma' 1, s 3,
#: u_next 6 (its z part is u'_z), larmor dt / gamma' 1, positions 6.  A
#: square root, rsqrt or reciprocal counts one.  The plain version's
#: algebra below takes 58, with 3 square roots and 5 divisions.
SLAB_PUSH_OPS = 52


def _step(x, y, z, ux, uy, uz, *, dt, b0, b1, b_shear, neg_half_dt,
          larmor_dt):
    bz = (b1 + b_shear * x) / b0
    g = torch.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
    h = dt / (2.0 * g)

    # u' = u - h (u x b), b = (0, 0, bz)
    upx = ux - h * (uy * bz)
    upy = uy + h * (ux * bz)
    upz = uz

    tz = neg_half_dt * bz
    tau_sq = tz * tz
    speed_sq = upx * upx + upy * upy + upz * upz
    sigma = 1.0 + speed_sq - tau_sq
    ustar = upz * tz
    g2 = torch.sqrt(0.5 * (sigma + torch.sqrt(
        sigma * sigma + 4.0 * (tau_sq + ustar * ustar))))
    tz2 = tz / g2
    s = 1.0 / (1.0 + tz2 * tz2)

    # u_next = s (u' + (u'.t) t + u' x t)
    udt = upz * tz2
    unx = s * (upx + upy * tz2)
    uny = s * (upy - upx * tz2)
    unz = s * (upz + udt * tz2)

    inv_g = larmor_dt / g2
    return (x + inv_g * unx, y + inv_g * uny, z + inv_g * unz,
            unx, uny, unz)


def _params(dt, b0, b1, b_shear, larmor):
    """The kernel's scalars, -0.5 dt and larmor dt folded in double as the
    JAX kernel folds them."""
    return dict(dt=float(dt), b0=float(b0), b1=float(b1),
                b_shear=float(b_shear), neg_half_dt=-0.5 * float(dt),
                larmor_dt=float(larmor) * float(dt))


def slab_push_plain(x, y, z, ux, uy, uz, *, dt, b0, b1=1.0, b_shear=0.1,
                    larmor=1.0, steps=100):
    """Plain version: ``steps`` pushes of the six (P,) tensors in eager
    PyTorch; returns the six advanced tensors."""
    state = (x, y, z, ux, uy, uz)
    params = _params(dt, b0, b1, b_shear, larmor)
    for _ in range(steps):
        state = _step(*state, **params)
    return state


def _check(leaves, steps):
    """Refuse what the kernel does not take; the dtype code."""
    if not isinstance(steps, int) or steps < 0:
        raise ValueError(f"steps={steps!r} must be a non-negative int")
    code = build.check("slab push", leaves, "x, y, z, ux, uy, uz",
                       length=True)
    if torch.is_grad_enabled() and any(a.requires_grad for a in leaves):
        raise ValueError("the slab push has no backward (nor has the JAX "
                         "kernel): pass tensors that do not require grad")
    return code


def _launch(leaves, params, steps, dtype):
    """The kernel on the current stream: six new tensors."""
    global slab_push_launches
    x = leaves[0]
    outs = [torch.empty_like(a) for a in leaves]
    if x.shape[0] == 0:
        return tuple(outs)
    values = (ctypes.c_double * 6)(
        params["dt"], params["b0"], params["b1"], params["b_shear"],
        params["neg_half_dt"], params["larmor_dt"])
    build.call(build.load().gft_slab_push, "slab push", x, dtype,
               x.shape[0], steps, build.pointers(leaves),
               build.pointers(outs), values)
    slab_push_launches += 1
    check_kernel_outputs("slab_push (K5)", ("x", "y", "z", "ux", "uy", "uz"),
                         outs, leaves, unit="particle")
    return tuple(outs)


def make_slab_push(*, dt, b0, b1=1.0, b_shear=0.1, larmor=1.0, steps=100):
    """Build ``push(x, y, z, ux, uy, uz) -> 6 tensors`` advancing
    ``steps`` Boris pushes in one kernel launch (the JAX package's
    ``make_slab_push`` without its TPU tiling: any particle count).

    CPU tensors run :func:`slab_push_plain`; CUDA tensors launch the
    kernel and return new tensors.  Anything the kernel does not take
    raises, inputs that require grad included."""
    params = _params(dt, b0, b1, b_shear, larmor)

    def push(x, y, z, ux, uy, uz):
        leaves = [x, y, z, ux, uy, uz]
        dtype = _check(leaves, steps)
        if x.device.type == "cpu":
            return slab_push_plain(*leaves, dt=dt, b0=b0, b1=b1,
                                   b_shear=b_shear, larmor=larmor,
                                   steps=steps)
        return _launch(leaves, params, steps, dtype)

    return push
