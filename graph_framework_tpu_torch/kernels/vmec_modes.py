"""The VMEC Fourier mode sums (K7): CUDA kernel wrapper and plain version.

Counterpart of ``graph_framework_tpu.pallas.vmec_modes`` (the TPU kernel
``_kernel``, launched by ``_pallas_forward`` and wrapped by
``make_mode_sums``).  Per ray, from its angles (u, v) and its already
evaluated per-mode radial coefficients rm, zm, rm' = drm/ds, zm' and lm
(each (B, M)), it computes the ten sums of the VMEC geometry:

    R = sum rm ca            dR/ds = sum rm' ca
    dR/du = -sum xm rm sa    dR/dv = sum xn rm sa
    Z = sum zm sa            dZ/ds = sum zm' sa
    dZ/du = sum xm zm ca     dZ/dv = -sum xn zm ca
    dl/du = sum xm lm ca     dl/dv = -sum xn lm ca

with ca, sa = cos, sin(xm u - xn v).

* :func:`reference_forward` is the plain PyTorch version.
* :func:`mode_sums` is the wrapper: CPU tensors run the plain version,
  and only they; CUDA tensors launch the hand-written kernel of
  ``csrc/vmec_modes.cu`` on the current stream or raise.
  ``vmec_modes_launches`` counts its launches.
* :func:`make_mode_sums` gives the differentiable form: forward is the
  wrapper, backward the plain torch adjoint of the JAX package's custom
  vjp, itself differentiable, so reverse over reverse works.

No path of the port calls it: the JAX package's ``fused_mode_sums`` now
routes to the fused geometry jet (K4, kernels/vmec_geom.py), and so does
the port's.  Not carried over: the (B, 16) padded output and the block
padding (the kernel masks a ragged last block).
"""

from __future__ import annotations

import torch

from graph_framework_tpu_torch.kernels import build
from graph_framework_tpu_torch.utils import check_kernel_outputs

#: Kernel launches of K7; plain-version calls do not count.
vmec_modes_launches = 0

#: Floating point operations a ray: per mode the angle, a sincos counted as
#: two and the ten sums' products and adds; per ray the additions of the
#: warp's shuffle tree whose results reach lane 0 (31 a sum).  Counted over
#: csrc/vmec_modes.cu by tools/count_ops.py (a CPU test holds them to it).
MODE_SUM_OPS = {"per_ray_fixed": 310, "per_mode": 28}

#: The output order.
SUM_NAMES = ("r", "z", "drs", "dru", "drv", "dzs", "dzu", "dzv", "dlu",
             "dlv")


def reference_forward(u, v, rm, zm, rm_s, zm_s, lm, xm, xn):
    """Plain version: the ten sums, a tuple of (B,) tensors."""
    ang = u.unsqueeze(-1) * xm - v.unsqueeze(-1) * xn
    ca, sa = torch.cos(ang), torch.sin(ang)
    rm_sa, zm_ca, lm_ca = rm * sa, zm * ca, lm * ca

    def s(x):
        return x.sum(-1)

    return (s(rm * ca), s(zm * sa), s(rm_s * ca), -s(xm * rm_sa),
            s(xn * rm_sa), s(zm_s * sa), s(xm * zm_ca), -s(xn * zm_ca),
            s(xm * lm_ca), -s(xn * lm_ca))


def reference_backward(u, v, rm, zm, rm_s, zm_s, lm, xm, xn, cts):
    """The adjoint of the ten sums (``make_mode_sums``'s bwd in the JAX
    package): cotangents of (u, v, rm, zm, rm_s, zm_s, lm) for the output
    cotangents ``cts`` (ten (B,) tensors).  Plain torch, differentiable."""
    (ct_r, ct_z, ct_drs, ct_dru, ct_drv, ct_dzs, ct_dzu, ct_dzv,
     ct_dlu, ct_dlv) = [c.unsqueeze(-1) for c in cts]
    ang = u.unsqueeze(-1) * xm - v.unsqueeze(-1) * xn
    ca, sa = torch.cos(ang), torch.sin(ang)
    # cotangents of the trig grids ...
    ct_ca = (rm * ct_r + rm_s * ct_drs + xm * zm * ct_dzu
             - xn * zm * ct_dzv + xm * lm * ct_dlu - xn * lm * ct_dlv)
    ct_sa = (zm * ct_z - xm * rm * ct_dru + xn * rm * ct_drv
             + zm_s * ct_dzs)
    # ... and of the coefficient blocks
    ct_rm = ca * ct_r - xm * sa * ct_dru + xn * sa * ct_drv
    ct_zm = sa * ct_z + xm * ca * ct_dzu - xn * ca * ct_dzv
    ct_rms = ca * ct_drs
    ct_zms = sa * ct_dzs
    ct_lm = xm * ca * ct_dlu - xn * ca * ct_dlv
    # d(ang)/du = xm, d(ang)/dv = -xn; dca = -sa d(ang), dsa = ca d(ang)
    ct_ang = ct_sa * ca - ct_ca * sa
    return ((ct_ang * xm).sum(-1), -(ct_ang * xn).sum(-1), ct_rm, ct_zm,
            ct_rms, ct_zms, ct_lm)


def _check(u, v, blocks, xm, xn):
    """Refuse what the kernel does not take; the dtype code."""
    code = build.check("the mode-sum kernel", (u, v, xm, xn) + tuple(blocks),
                       "tensors")
    n, m = u.shape[0], xm.shape[0]
    if (u.ndim != 1 or v.shape != u.shape or xm.shape != (m,)
            or xn.shape != (m,)
            or any(b.shape != (n, m) for b in blocks)):
        raise ValueError(f"mode sums take u, v (B,), five (B, M) blocks and "
                         f"xm, xn (M,); got u {tuple(u.shape)}, blocks "
                         f"{[tuple(b.shape) for b in blocks]}, xm "
                         f"{tuple(xm.shape)}")
    return code


def _launch(u, v, blocks, xm, xn, dtype):
    """K7 on the current stream: a new (10, B) tensor."""
    global vmec_modes_launches
    n, m = u.shape[0], xm.shape[0]
    out = torch.empty((len(SUM_NAMES), n), dtype=u.dtype, device=u.device)
    if n == 0:
        return out
    build.call(build.load().gft_vmec_modes, "vmec_modes", u, dtype, n, m,
               u.data_ptr(), v.data_ptr(), build.pointers(blocks),
               xm.data_ptr(), xn.data_ptr(), out.data_ptr())
    vmec_modes_launches += 1
    check_kernel_outputs("vmec_modes (K7)", ("the mode sums",), (out,),
                         (u, v))
    return out


def mode_sums(u, v, rm, zm, rm_s, zm_s, lm, xm, xn):
    """The ten sums (``SUM_NAMES``), a tuple of (B,) tensors: CPU tensors
    run :func:`reference_forward`, CUDA tensors launch K7.  No gradient:
    see :func:`make_mode_sums`."""
    blocks = (rm, zm, rm_s, zm_s, lm)
    dtype = _check(u, v, blocks, xm, xn)
    if u.device.type == "cpu":
        return reference_forward(u, v, *blocks, xm, xn)
    return tuple(_launch(u, v, blocks, xm, xn, dtype).unbind(0))


class ModeSums(torch.autograd.Function):
    """``apply(xm, xn, u, v, rm, zm, rm_s, zm_s, lm)``: forward
    :func:`mode_sums`, backward :func:`reference_backward` (recorded by
    autograd when the backward itself is differentiated)."""

    @staticmethod
    def forward(ctx, xm, xn, u, v, rm, zm, rm_s, zm_s, lm):
        ctx.save_for_backward(xm, xn, u, v, rm, zm, rm_s, zm_s, lm)
        return mode_sums(u, v, rm, zm, rm_s, zm_s, lm, xm, xn)

    @staticmethod
    def backward(ctx, *cts):
        xm, xn, *args = ctx.saved_tensors
        cts = [torch.zeros_like(args[0]) if c is None else c for c in cts]
        return (None, None) + reference_backward(*args, xm, xn, cts)


def make_mode_sums(xm, xn):
    """The differentiable mode sums of one mode set (the JAX package's
    ``make_mode_sums`` without its tiling arguments):
    ``f(u, v, rm, zm, rm_s, zm_s, lm)`` -> the ten (B,) sums."""
    def f(u, v, rm, zm, rm_s, zm_s, lm):
        return ModeSums.apply(xm, xn, u, v, rm, zm, rm_s, zm_s, lm)

    return f
