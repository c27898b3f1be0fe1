"""The weak-damping kamp of a real ray state over an EFIT equilibrium (K9):
CUDA kernel wrappers.

It replaces no TPU kernel: the JAX package leaves this function to XLA
(``make_weak_damping_split`` under ``jax.grad``).  The port's plain version
is the eager ``models.absorption.make_weak_damping_real_plain``, which
dispatches some 700 device operations a call and, under reverse mode,
evaluates kamp again with ``create_graph=True`` and pulls the cotangent
through that second-order graph (about 2000 more).  Per ray the kernel pair
of ``csrc/weak_damping.cu`` computes the same function at the state's own
precision,

    kamp = |k| - Dw / (khat . dDc/dk),

Dc the cold-plasma expansion, Dw the hot-plasma expansion with Z of the
real zeta as ``ops.special.z_plasma`` evaluates it, B, ne and te from the
ray's own cells of the cell-local tables: a forward kernel, state -> kamp,
and a VJP kernel, kamp's cotangent -> the cotangents of w, x, y, z, kx, ky,
kz and each ray's 16 psi-coefficient cotangents, which the table scatter
(``kernels/table_scatter.py``) adds into ``psi_coeffs``' gradient.

The wrapper knows tables, leaves and the grid's scalars, not the
equilibrium: ``models.absorption.k9_takes`` chooses K9.

* :func:`param_array` is the C interfaces' ``params`` for a set of grid
  scalars (``efit_step.kernel_params``).
* :func:`weak_damping` is the wrapper, for CUDA tensors only (the plain
  version serves the CPU): it launches K9 on the current stream, through
  :class:`WeakDamping` where grad mode is on and a leaf or ``psi``
  requires grad, or raises: there is no fallback.
  ``weak_damping_launches`` counts the forward kernel's launches and
  ``weak_damping_vjp_launches`` the VJP's; each launch is the span
  ``gft.weak_damping.kernel`` (``telemetry``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from graph_framework_tpu_torch import telemetry
from graph_framework_tpu_torch.kernels import build, table_scatter
from graph_framework_tpu_torch.ops import special
from graph_framework_tpu_torch.utils import check_kernel_outputs

#: Kernel launches of K9's forward and of its VJP; plain-version calls do
#: not count.
weak_damping_launches = 0
weak_damping_vjp_launches = 0

#: Floating point operations a ray, counted over csrc/weak_damping.cu by
#: tools/count_ops.py (a CPU test holds them to it), at a ray whose zeta
#: takes Weideman's series: the source's own count, which holds more than
#: the function needs (the forward's dead sweep back through the field
#: front, the VJP's forward mode over six tangents).
WEAK_DAMPING_OPS = {"forward": 1037, "vjp": 3340}

#: The leaves K9 reads, in RayState order (t is not read: EFIT does not
#: depend on time, and t's cotangent is zero).
LEAVES = ("w", "x", "y", "z", "kx", "ky", "kz")


def param_array(grid):
    """The C interfaces' ``params``: the window kernels' 17 grid scalars
    (``efit_step.kernel_params``, dt unused), Weideman's L and his 64
    coefficients in Horner order, in double (the kernel rounds them to the
    state's dtype, as the plain version's table is rounded).  One array for
    each set of grid scalars: building it costs some 30 us of host time,
    twice a recorded step."""
    return _param_array(tuple(grid))


@functools.lru_cache(maxsize=8)
def _param_array(grid):
    ell, coeffs = special._weideman_table(torch.float64)
    values = list(grid) + [ell] + list(coeffs)
    return (ctypes.c_double * len(values))(*values)


def _check(psi, prof, leaves):
    dtype = build.check("the weak damping kernel", (*leaves, psi, prof),
                        "leaves and tables")
    if len(leaves) != len(LEAVES) or any(
            a.ndim != 1 or a.shape != leaves[0].shape for a in leaves):
        raise ValueError("the weak damping kernel takes seven (n,) leaves "
                         "(w, x, y, z, kx, ky, kz)")
    if (psi.ndim != 4 or psi.shape[2:] != (4, 4) or prof.ndim != 3
            or prof.shape[1:] != (4, 4)):
        raise ValueError("the weak damping kernel takes (nr, nz, 4, 4) psi "
                         "and (npsi, 4, 4) profile tables")
    return dtype


def _launch(psi, prof, leaves, params):
    """K9's forward on the current stream: kamp, a new complex tensor."""
    global weak_damping_launches
    x = leaves[0]
    out = torch.empty((x.shape[0], 2), dtype=x.dtype, device=x.device)
    if x.shape[0]:
        with telemetry.span("gft.weak_damping.kernel"):
            build.call(build.load().gft_weak_damping, "weak_damping", x,
                       build.DTYPE_CODES[x.dtype], x.shape[0],
                       build.pointers(leaves), psi.data_ptr(),
                       psi.shape[0], psi.shape[1], prof.data_ptr(),
                       prof.shape[0], params, out.data_ptr())
        weak_damping_launches += 1
    return torch.view_as_complex(out)


def _launch_vjp(psi, prof, leaves, params, ct, rows):
    """K9's VJP on the current stream: the (7, n) leaf cotangents and, with
    ``rows``, the (n, 16) psi-block cotangents and their (n,) cells."""
    global weak_damping_vjp_launches
    x = leaves[0]
    n = x.shape[0]
    ct = torch.view_as_real(ct.resolve_conj().contiguous())
    dleaves = torch.empty((len(LEAVES), n), dtype=x.dtype, device=x.device)
    dpsi = cells = None
    if rows:
        dpsi = torch.empty((n, 16), dtype=x.dtype, device=x.device)
        cells = torch.empty((n,), dtype=torch.int64, device=x.device)
    if n:
        with telemetry.span("gft.weak_damping.kernel"):
            build.call(build.load().gft_weak_damping_vjp, "weak_damping_vjp",
                       x, build.DTYPE_CODES[x.dtype], n,
                       build.pointers(leaves), ct.data_ptr(), psi.data_ptr(),
                       psi.shape[0], psi.shape[1], prof.data_ptr(),
                       prof.shape[0], params, dleaves.data_ptr(),
                       dpsi.data_ptr() if rows else None,
                       cells.data_ptr() if rows else None)
        weak_damping_vjp_launches += 1
        check_kernel_outputs(
            "weak_damping_vjp (K9)",
            [f"cotangent of {f}" for f in LEAVES]
            + (["psi block cotangents"] if rows else []),
            list(dleaves) + ([dpsi.t()] if rows else []), leaves + [ct])
    return dleaves, dpsi, cells


class WeakDamping(torch.autograd.Function):
    """``apply(prof, params, psi, *leaves)``: kamp of the seven leaves (w,
    x, y, z, kx, ky, kz), K9's forward; the backward launches K9's VJP and,
    where ``psi`` needs a gradient, scatters its rows into the table (one
    table scatter).  ``prof`` takes no gradient.  Keeps only the inputs
    between the passes."""

    @staticmethod
    def forward(ctx, prof, params, psi, *leaves):
        ctx.params = params
        ctx.save_for_backward(prof, psi, *leaves)
        return _launch(psi, prof, list(leaves), params)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        prof, psi, *leaves = ctx.saved_tensors
        want_psi = ctx.needs_input_grad[2]
        dleaves, rows, cells = _launch_vjp(psi, prof, leaves, ctx.params, ct,
                                           want_psi)
        d_psi = None
        if want_psi:
            d_psi = table_scatter.table_scatter(
                rows, cells, psi.shape[0] * psi.shape[1]).reshape(psi.shape)
        return (None, None, d_psi, *[d if need else None for d, need in
                                     zip(dleaves.unbind(0),
                                         ctx.needs_input_grad[3:])])


def weak_damping(psi, prof, leaves, params):
    """kamp of the seven leaves (w, x, y, z, kx, ky, kz: CUDA float32 or
    float64, one length) over the psi table ``psi`` (nr, nz, 4, 4) and the
    profile table ``prof`` (npsi, 4, 4) with the grid's ``params``
    (:func:`param_array`), in the complex dtype of the leaves' precision:
    K9 on the current stream, differentiable in the leaves and in ``psi``.
    Anything the kernel does not take raises."""
    leaves = list(leaves)
    _check(psi, prof, leaves)
    if leaves[0].device.type != "cuda":
        raise ValueError("the weak damping kernel runs on CUDA tensors "
                         "(the plain version serves the CPU)")
    if torch.is_grad_enabled() and (
            psi.requires_grad or any(a.requires_grad for a in leaves)):
        return WeakDamping.apply(prof, params, psi, *leaves)
    return _launch(psi, prof, leaves, params)
