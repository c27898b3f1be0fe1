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
  of ``csrc/deposit.cu`` (a deterministic two-pass reduction; built by
  ``nvcc`` on first use, kernels/build.py) on the current stream, or
  raises: there is no fallback.  ``deposit_launches`` counts the wrapper's
  kernel launches (one per call: both passes).

Any particle count and any grid size: the JAX package's padding of the
particles to a block multiple and of the grid to a tile multiple, and its
``(8, TILE)`` output, are TPU tiling and are not carried over.  The
deposit has no backward (nor had the TPU kernel): an input that requires
grad is refused rather than cut silently.
"""

from __future__ import annotations

import ctypes

import torch

#: Wrapper calls that launched the kernels; plain-version calls do not count.
deposit_launches = 0

#: Floating point operations per (particle, grid point) pair, counted from
#: the per-pair algebra below (and csrc/deposit.cu): dx 1, dx^2 1, / -w 1,
#: exp 1, * m 1, + n 1, coef dx 1, * m 1, + e 1.
DEPOSIT_OPS_PER_PAIR = 9

#: Particles per pass-1 block on the card: 1M particles make 245 chunks,
#: which with 8 tiles of 128 grid points fill the 132 SMs several times.
CHUNK = 4096
_MAX_CHUNKS = 65535

#: Particles per block of the plain version (bounds its (G, block) pairs).
_PLAIN_BLOCK = 4096

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def _params(width, te, q):
    """-w and 2 te / (q w), folded in double as the JAX kernel folds them."""
    width = float(width)
    return -width, 2.0 * float(te) / (float(q) * width)


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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"deposit runs on cuda (or cpu via the plain "
                         f"version), not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"deposit takes float32/float64, not {x.dtype}")
    for a in (x, mask, grid):
        if (a.device != x.device or a.dtype != x.dtype or a.ndim != 1
                or not a.is_contiguous()):
            raise ValueError("deposit needs contiguous 1-D x, mask and grid "
                             "of one dtype and device")
    if mask.shape != x.shape:
        raise ValueError(f"mask {tuple(mask.shape)} must match x "
                         f"{tuple(x.shape)}")
    if grid.shape[0] < 1:
        raise ValueError("deposit needs at least one grid point")
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x, mask, grid)):
        raise ValueError("the deposit has no backward (nor has the JAX "
                         "kernel): pass tensors that do not require grad")


def _launch(x, mask, grid, width, te, q):
    """Both passes on the current stream: new (n, e) tensors."""
    from graph_framework_tpu_torch.kernels import build

    global deposit_launches
    p, g = x.shape[0], grid.shape[0]
    if p == 0:
        return torch.zeros_like(grid), torch.zeros_like(grid)
    chunk = max(CHUNK, -(-p // _MAX_CHUNKS))
    partial = torch.empty((-(-p // chunk), 2, g), dtype=x.dtype,
                          device=x.device)
    n, e = torch.empty_like(grid), torch.empty_like(grid)
    lib = build.load()
    params = (ctypes.c_double * 2)(*_params(width, te, q))
    with torch.cuda.device(x.device):
        rc = lib.gft_deposit(
            _DTYPE_CODES[x.dtype], p, g, chunk, x.data_ptr(),
            mask.data_ptr(), grid.data_ptr(), partial.data_ptr(),
            n.data_ptr(), e.data_ptr(), params, build.stream(x))
    if rc != 0:
        raise RuntimeError(f"deposit kernel launch failed ({rc}): "
                           f"{build.error_string(rc)}")
    deposit_launches += 1
    return n, e


def deposit(x, mask, grid, *, width=1.0e-4, te=1.0, q=1.0):
    """Deposit particles ``x`` with validity weights ``mask`` onto the
    points ``grid``: (n, e), each of the grid's shape (the JAX package's
    ``deposit_pallas`` without its tiling arguments).

    CPU tensors run :func:`deposit_plain`; CUDA tensors launch the kernels
    and return new tensors.  Anything the kernels do not take raises,
    inputs that require grad included."""
    _check(x, mask, grid)
    if x.device.type == "cpu":
        return deposit_plain(x, mask, grid, width=width, te=te, q=q)
    return _launch(x, mask, grid, width, te, q)
