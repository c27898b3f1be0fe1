"""Offset-normalized cubic / bicubic spline evaluation (cell-major tables).

Counterpart of ``graph_framework_tpu.ops.spline``.  The reference stores
cubic splines as per-cell coefficient tables c0..c3 and evaluates the
polynomial in the normalized coordinate u = (x - offset)/scale with the
coefficients of the cell containing u (equilibrium.hpp
``build_1D_spline``, :1120-1131); bicubic surfaces evaluate
sum_ab c_ab v^b u^a (``efit::build_psi``, :1278-1313).

Layout: tables are CELL-MAJOR - all coefficients of one cell contiguous:

  * 1D:    (n, 4)         [cell, power]
  * multi: (n, P, 4)      [cell, profile, power]
  * 2D:    (nr, nz, 4, 4) [i, j, u-power, v-power], gathered flat

which is also what the CUDA window kernel reads: one thread fetches its
ray's 16-coefficient block as 16 contiguous values.

The load-time helpers (cell-local rebase, cell-major reshapes) are numpy
in extended precision, verbatim from the JAX package.  The evaluators are
torch: the index carries no gradient (ops.tables), so autograd
differentiates the polynomial only - the reference's symbolic ``df``
through ``piecewise_*`` nodes.
"""

import math

import numpy as np
import torch

from graph_framework_tpu_torch.ops.tables import table_index_1d


def rebase_cells_1d(coeffs):
    """Rebase (4, n) global-coordinate cell tables to cell-local form.

    The file format stores polynomials in the *global* normalized
    coordinate u, which makes f64 evaluation ill-conditioned at large u.
    Rebasing each cell's polynomial to t = u - i (t in [0, 1)) at load time
    - in extended precision, so the rebase itself does not reintroduce the
    cancellation - gives near-machine-accurate evaluation.
    """
    c = np.asarray(coeffs, dtype=np.longdouble)
    n = c.shape[1]
    cells = np.arange(n, dtype=np.longdouble)
    out = np.zeros((4, n), dtype=np.float64)
    for k in range(4):
        acc = np.zeros(n, dtype=np.longdouble)
        for i in range(k, 4):
            acc += math.comb(i, k) * c[i] * cells ** (i - k)
        out[k] = acc.astype(np.float64)
    return out


def rebase_cells_2d(coeffs):
    """Rebase a (4, 4, nr, nc) global-coordinate bicubic stack to
    cell-local coordinates in both directions (see :func:`rebase_cells_1d`).
    """
    c = np.asarray(coeffs, dtype=np.longdouble)
    _, _, nr, nc = c.shape
    iu = np.arange(nr, dtype=np.longdouble)[:, None]
    jv = np.arange(nc, dtype=np.longdouble)[None, :]
    out = np.zeros((4, 4, nr, nc), dtype=np.float64)
    for k in range(4):
        for l in range(4):
            acc = np.zeros((nr, nc), dtype=np.longdouble)
            for a in range(k, 4):
                for b in range(l, 4):
                    acc += (math.comb(a, k) * math.comb(b, l)
                            * c[a, b] * iu ** (a - k) * jv ** (b - l))
            out[k, l] = acc.astype(np.float64)
    return out


def to_cell_major_1d(coeffs):
    """(4, n) file/rebase orientation -> (n, 4) runtime layout."""
    return np.ascontiguousarray(np.asarray(coeffs).T)


def to_cell_major_2d(coeffs):
    """(4, 4, nr, nc) file/rebase orientation -> (nr, nc, 4, 4) runtime
    layout (one contiguous 16-coefficient block per cell)."""
    return np.ascontiguousarray(np.asarray(coeffs).transpose(2, 3, 0, 1))


def spline_1d(c0, c1, c2, c3, x, scale, offset, local=False):
    """Evaluate a 1D cubic spline from four separate coefficient tables:
    ``equilibrium::build_1D_spline`` over four ``piecewise_1D`` gathers
    (equilibrium.hpp:1120-1131), c0[i] + u (c1[i] + u (c2[i] + u c3[i]))
    with u = (x - offset) / scale and i = clamp(trunc(u)).  The literal
    four-gather form of the embedding surface; the hot paths use the
    cell-major :func:`eval_cubic_1d`."""
    u = (x - offset) / scale
    idx = table_index_1d(x, scale, offset, c0.shape[0])
    if local:
        u = u - idx.to(u.dtype)
    return c0[idx] + u * (c1[idx] + u * (c2[idx] + u * c3[idx]))


def eval_cubic_1d(coeffs, x, scale, offset, local=False):
    """Evaluate a 1D cubic spline from a cell-major (n, 4) table: one
    contiguous 4-value block gather per point."""
    u = (x - offset) / scale
    idx = table_index_1d(x, scale, offset, coeffs.shape[0])
    if local:
        u = u - idx.to(u.dtype)
    b = coeffs[idx]                               # (..., 4)
    return b[..., 0] + u * (b[..., 1] + u * (b[..., 2] + u * b[..., 3]))


def eval_cubic_multi(coeffs, x, scale, offset, local=False):
    """Evaluate several cubic splines sharing one argument and index.

    ``coeffs``: (n, P, 4) cell-major; one gather fetches the contiguous
    (P, 4) block per point (the EFIT profiles ne, te, pressure, fpol all
    key on the same psi).  Returns shape (...batch, P).
    """
    u = (x - offset) / scale
    idx = table_index_1d(x, scale, offset, coeffs.shape[0])
    if local:
        u = u - idx.to(u.dtype)
    return eval_cubic_multi_block(coeffs[idx], u)


def _flat_block_2d(coeffs, x, x_scale, x_offset, y, y_scale, y_offset,
                   local):
    """Shared index/gather for the bicubic evaluators: one linearized-index
    gather of the cell's contiguous 16-coefficient block."""
    nr, nc = coeffs.shape[:2]
    u = (x - x_offset) / x_scale
    v = (y - y_offset) / y_scale
    i = table_index_1d(x, x_scale, x_offset, nr)
    j = table_index_1d(y, y_scale, y_offset, nc)
    if local:
        u = u - i.to(u.dtype)
        v = v - j.to(v.dtype)
    block = coeffs.reshape(nr * nc, 16)[i * nc + j]   # (..., 16)
    return block, u, v


def _cubic_rows(block, v):
    """The four cubics in v of a flat (..., 16) block, one per u power:
    ca[a] = b[a,0] + v (b[a,1] + v (b[a,2] + v b[a,3])), and their
    v-derivatives cb[a]."""
    b = block.reshape(block.shape[:-1] + (4, 4))
    v_ = v[..., None]
    ca = b[..., 0] + v_ * (b[..., 1] + v_ * (b[..., 2] + v_ * b[..., 3]))
    cb = b[..., 1] + v_ * (2.0 * b[..., 2] + 3.0 * v_ * b[..., 3])
    return ca, cb


def eval_bicubic_2d(coeffs, x, x_scale, x_offset, y, y_scale, y_offset,
                    local=False):
    """Evaluate a bicubic spline surface from a cell-major (nr, nc, 4, 4)
    table: ``coeffs[i, j, a, b]`` multiplies u^a v^b, u indexing rows and
    v columns (efit::build_psi, equilibrium.hpp:1278-1313)."""
    block, u, v = _flat_block_2d(coeffs, x, x_scale, x_offset,
                                 y, y_scale, y_offset, local)
    ca, _ = _cubic_rows(block, v)
    return (ca[..., 0] + u * (ca[..., 1]
            + u * (ca[..., 2] + u * ca[..., 3])))


def eval_bicubic_jet_block(block, u, v, x_scale, y_scale):
    """Value and first derivatives (value, d/dx, d/dy) of the bicubic over
    an already-gathered (..., 16) block at CELL-LOCAL (u, v).  Frozen-cell
    stepping evaluates every RK stage of a window against one base-state
    gather, so u, v may run slightly outside [0, 1) (the extrapolation
    contract is documented at models.efit.FrozenCellEfit)."""
    ca, cb = _cubic_rows(block, v)
    val = (ca[..., 0] + u * (ca[..., 1]
           + u * (ca[..., 2] + u * ca[..., 3])))
    dval_du = ca[..., 1] + u * (2.0 * ca[..., 2] + 3.0 * u * ca[..., 3])
    dval_dv = (cb[..., 0] + u * (cb[..., 1]
               + u * (cb[..., 2] + u * cb[..., 3])))
    return val, dval_du / x_scale, dval_dv / y_scale


def eval_bicubic_jet(coeffs, x, x_scale, x_offset, y, y_scale, y_offset,
                     local=False):
    """Bicubic value and first derivatives from ONE coefficient gather.

    The derivative polynomials come analytically from the same block, so
    the B field (equilibrium.hpp:1364-1382) needs no nested gradient."""
    block, u, v = _flat_block_2d(coeffs, x, x_scale, x_offset,
                                 y, y_scale, y_offset, local)
    return eval_bicubic_jet_block(block, u, v, x_scale, y_scale)


def eval_cubic_multi_block(block, u):
    """Polynomial part of :func:`eval_cubic_multi` over an
    already-gathered (..., P, 4) block and cell-local coordinate u."""
    u = u[..., None]
    return (block[..., 0] + u * (block[..., 1]
            + u * (block[..., 2] + u * block[..., 3])))
