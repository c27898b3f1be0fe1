"""Piecewise-constant table lookups (the reference's gather primitives).

Counterpart of ``graph_framework_tpu.ops.tables`` (``table_index_1d``,
``piecewise_1d``, ``piecewise_2d``, ``index_1d``; reference:
piecewise.hpp), with the index semantics of the reference's generated-kernel index expression
(piecewise.hpp ``compile_index``, :26-60):

    i = (uint) min(max((x - offset)/scale, 0), len-1)

normalize, clamp to the table range as a float, then truncate.  The index
carries no gradient (piecewise.hpp ``df``, :241-243): the normalized
coordinate is detached before indexing.  A complex coordinate indexes by
its real part (``compile_index`` wraps the normalized coordinate in
``real()`` for complex scalars), so the equilibria evaluate at the complex
positions of the absorption phase.

A NaN coordinate indexes cell 0, as it does in the JAX package (its gather
clamps the out-of-range integer a NaN casts to) and in the CUDA kernel
(``fmax(NaN, 0) = 0``); torch would otherwise raise on the garbage index.

:func:`gather_rows` is the spline tables' row gather (ops/spline.py,
``EfitEquilibrium.freeze_cells``, ``models/vmec.py``).  Where the table
takes a gradient, its transpose is the hand-written scatter of
``kernels/table_scatter.py`` on the card, in place of the library's
``index_put_`` with accumulate; K3's block cotangents go into the EFIT
tables through the same scatter (``kernels.efit_step.
scatter_block_cotangents``).
"""

import math

import torch

from graph_framework_tpu_torch.kernels.table_scatter import table_scatter


def table_index_1d(x, scale, offset, length):
    """Clamped int64 table index of coordinate ``x`` (no gradient)."""
    x = x.detach()
    if x.is_complex():
        x = x.real
    u = (x - offset) / scale
    u = torch.nan_to_num(u, nan=0.0)
    u = torch.clamp(u, 0.0, float(length - 1))
    return u.to(torch.int64)


def piecewise_1d(data, x, scale, offset):
    """``data[(x - offset)/scale]`` with clamped truncation
    (``graph::piecewise_1D``, piecewise.hpp:105-...); ``data`` is (n,)."""
    return data[table_index_1d(x, scale, offset, data.shape[0])]


def piecewise_2d(data, x, x_scale, x_offset, y, y_scale, y_offset):
    """Gather from a (num_rows, num_cols) table, rows indexed by ``x`` and
    columns by ``y`` (``graph::piecewise_2D``, piecewise.hpp:686-...,
    whose kernel reads ``i*num_cols + j``, piecewise.hpp:1078-1125)."""
    num_rows, num_cols = data.shape
    i = table_index_1d(x, x_scale, x_offset, num_rows)
    j = table_index_1d(y, y_scale, y_offset, num_cols)
    return data.reshape(-1)[i * num_cols + j]


def index_1d(values, x, scale, offset):
    """Gather from a per-step array, such as PIC's electric field
    (``graph::index_1D``, piecewise.hpp:1448-1755; xpic.cpp:80-93): the
    index arithmetic of :func:`piecewise_1d` on a runtime variable."""
    return piecewise_1d(values, x, scale, offset)


class TableGather(torch.autograd.Function):
    """``apply(table, idx)``: ``table[idx]`` of a table of ``cells`` rows,
    whose VJP is :class:`TableScatter`, so derivatives of every order
    behave as plain indexing's do."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.cells = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return TableScatter.apply(grad, idx, ctx.cells), None


class TableScatter(torch.autograd.Function):
    """``apply(grad, idx, cells)``: the gradient of a table of ``cells``
    rows from the cotangent ``grad`` (idx.shape + the row's shape) of its
    rows gathered at ``idx`` (``kernels.table_scatter.table_scatter`` over
    the flattened rows); its VJP is :class:`TableGather`."""

    @staticmethod
    def forward(ctx, grad, idx, cells):
        ctx.save_for_backward(idx)
        row = grad.shape[idx.dim():]
        out = table_scatter(grad.reshape(idx.numel(), math.prod(row)),
                            idx.reshape(-1), cells)
        return out.reshape((cells,) + row)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return TableGather.apply(grad, idx), None, None


def gather_rows(table, idx):
    """``table[idx]``: the rows of a table (cells first) at an int64 index
    in [0, cells), of shape idx.shape + the row's shape.

    Plain indexing unless the call needs the table's gradient (grad mode on
    and a real table that requires grad): then :class:`TableGather`, whose
    backward sums the rows of each cell with ``kernels.table_scatter``."""
    if (torch.is_grad_enabled() and table.requires_grad
            and not table.is_complex()):
        return TableGather.apply(table, idx)
    return table[idx]
