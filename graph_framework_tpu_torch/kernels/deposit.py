"""The PIC grid deposit: CUDA kernel wrapper and its plain version.

Counterpart of ``graph_framework_tpu.pallas.deposit`` (the TPU kernel
``_kernel`` and its launcher ``deposit_pallas``): for every grid point g,
over all particles p with validity mask m_p (xpic.cpp:99-131),

    n[g] = sum_p exp((x_p - g)^2 / -w) m_p
    e[g] = sum_p (2 te / (q w)) (x_p - g) m_p.

* :func:`deposit_plain` is the plain PyTorch version: the blocked per-pair
  sum, in the kernel's per-pair algebra.
* :func:`deposit` is the wrapper.  For CPU tensors, and only then, it runs
  the plain version; for CUDA tensors it launches the hand-written kernels
  of ``csrc/deposit.cu`` (built by ``nvcc`` on first use, kernels/build.py)
  on the current stream, or raises: there is no fallback.  The kernels
  compute e from the two particle sums sum m and sum x m, bin the particles
  by position (a stable counting sort) and sum each grid point's n over
  only the particles within :data:`REACH` of its tile, beyond which every
  term is exactly +0; every sum runs in a fixed order, so the same inputs
  give the same bits.  ``deposit_launches`` counts the wrapper's calls that
  launched them (one per call, however many kernels it launches).

Any particle count and any grid size: the JAX package's padding of the
particles to a block multiple and of the grid to a tile multiple, and its
``(8, TILE)`` output, are TPU tiling and are not carried over.  The
deposit has no backward (nor had the TPU kernel): an input that requires
grad is refused rather than cut silently, and so is, on the card, a width
that is not positive (no reach exists then).
"""

from __future__ import annotations

import ctypes
import math

import torch

from graph_framework_tpu_torch.kernels import build
from graph_framework_tpu_torch.utils import check_kernel_outputs

#: Wrapper calls that launched the kernels; plain-version calls do not count.
deposit_launches = 0

#: Floating point operations of the kernels (tools/count_ops.py counts
#: them over csrc/deposit.cu): a pair within reach (dx 1, dx^2 1, / -w 1,
#: exp 1, * m 1, + n 1), a particle (+ m, x m, + x m for e's two sums;
#: x - lo, * 1/width for its bin), a grid point (e = coef (S1 - g S0)).
DEPOSIT_OPS = {"per_pair": 6, "per_particle": 5, "per_point": 3}

#: Particles a histogram of the kernels' counting sort (csrc/deposit.cu
#: kChunk) up to 4096 histograms (4M particles); more particles take
#: larger chunks.
CHUNK = 1024

#: exp(a) of the working type is exactly +0 for a below minus these: ln of
#: half the smallest subnormal, 2^-150 (f32) and 2^-1075 (f64).
EXP_UNDERFLOW = {torch.float32: 103.98, torch.float64: 745.14}
#: The kernels' reach r = sqrt(REACH w): a pair farther apart adds exactly
#: +0 (dx^2 / w > 112 > 103.98; 760 > 745.14), with a margin of 3.7% (f32)
#: and 1.0% (f64) in distance for the rounding of dx and of the bins.
REACH = {torch.float32: 112.0, torch.float64: 760.0}

#: Particles per block of the plain version (bounds its (G, block) pairs).
_PLAIN_BLOCK = 4096


def _params(width, te, q):
    """-w and 2 te / (q w), folded in double as the JAX kernel folds them."""
    width = float(width)
    return -width, 2.0 * float(te) / (float(q) * width)


def reach(width, dtype):
    """The kernels' reach in the working type ``dtype``: beyond it every
    pair's term exp(dx^2 / -w) m is exactly +0."""
    return math.sqrt(REACH[dtype] * float(width))


def deposit_plain(x, mask, grid, *, width=1.0e-4, te=1.0, q=1.0):
    """Plain version: (n, e), each (G,), summed over blocks of
    ``_PLAIN_BLOCK`` particles, each block's pairs summed per grid point."""
    neg_width, coef = _params(width, te, q)
    n = torch.zeros_like(grid)
    e = torch.zeros_like(grid)
    for start in range(0, x.shape[0], _PLAIN_BLOCK):
        end = start + _PLAIN_BLOCK
        xb, mb = x[start:end], mask[start:end]
        dx = xb[None, :] - grid[:, None]
        n = n + torch.sum(torch.exp(dx * dx / neg_width) * mb, dim=1)
        e = e + torch.sum(coef * dx * mb, dim=1)
    return n, e


def _check(x, mask, grid):
    """Refuse what the kernels do not take; the dtype code."""
    code = build.check("deposit", (x, mask, grid), "x, mask and grid")
    if x.ndim != 1 or grid.ndim != 1:
        raise ValueError(f"deposit takes 1-D x and grid, not "
                         f"{tuple(x.shape)} and {tuple(grid.shape)}")
    if mask.shape != x.shape:
        raise ValueError(f"mask {tuple(mask.shape)} must match x "
                         f"{tuple(x.shape)}")
    if grid.shape[0] < 1:
        raise ValueError("deposit needs at least one grid point")
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x, mask, grid)):
        raise ValueError("the deposit has no backward (nor has the JAX "
                         "kernel): pass tensors that do not require grad")
    return code


def _launch(x, mask, grid, width, te, q, code):
    """The kernels on the current stream: new (n, e) tensors."""
    global deposit_launches
    if not (0.0 < float(width) < math.inf):
        raise ValueError(f"the deposit kernel needs a positive finite width "
                         f"(its reach), not {width}")
    p, g = x.shape[0], grid.shape[0]
    if p == 0:
        return torch.zeros_like(grid), torch.zeros_like(grid)
    lib = build.load()
    nbytes = lib.gft_deposit_scratch_bytes(code, p, g)
    if nbytes < 0:
        raise ValueError(f"the deposit kernel takes 1 to 2^31 - 1 particles "
                         f"and up to 2^29 grid points, not {p} and {g}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    n, e = torch.empty_like(grid), torch.empty_like(grid)
    params = (ctypes.c_double * 3)(*_params(width, te, q),
                                   reach(width, x.dtype))
    build.call(lib.gft_deposit, "deposit", x, code, p, g, x.data_ptr(),
               mask.data_ptr(), grid.data_ptr(), scratch.data_ptr(),
               n.data_ptr(), e.data_ptr(), params)
    deposit_launches += 1
    check_kernel_outputs("deposit (K6)", ("n", "e"), (n, e), (x, grid),
                         unit="grid point")
    return n, e


def deposit(x, mask, grid, *, width=1.0e-4, te=1.0, q=1.0):
    """Deposit particles ``x`` with validity weights ``mask`` onto the
    points ``grid``: (n, e), each of the grid's shape (the JAX package's
    ``deposit_pallas`` without its tiling arguments).

    CPU tensors run :func:`deposit_plain`; CUDA tensors launch the kernels
    and return new tensors.  Anything the kernels do not take raises,
    inputs that require grad included."""
    code = _check(x, mask, grid)
    if x.device.type == "cpu":
        return deposit_plain(x, mask, grid, width=width, te=te, q=q)
    return _launch(x, mask, grid, width, te, q, code)
