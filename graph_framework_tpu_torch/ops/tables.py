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
"""

import torch


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
