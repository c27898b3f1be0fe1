"""Piecewise-constant table index (the reference's gather primitive).

Counterpart of ``graph_framework_tpu.ops.tables.table_index_1d``, with the
index semantics of the reference's generated-kernel index expression
(piecewise.hpp ``compile_index``, :26-60):

    i = (uint) min(max((x - offset)/scale, 0), len-1)

normalize, clamp to the table range as a float, then truncate.  The index
carries no gradient (piecewise.hpp ``df``, :241-243): the normalized
coordinate is detached before indexing.

A NaN coordinate indexes cell 0, as it does in the JAX package (its gather
clamps the out-of-range integer a NaN casts to) and in the CUDA kernel
(``fmax(NaN, 0) = 0``); torch would otherwise raise on the garbage index.
"""

import torch


def table_index_1d(x, scale, offset, length):
    """Clamped int64 table index of coordinate ``x`` (no gradient)."""
    u = ((x.detach() - offset) / scale)
    u = torch.nan_to_num(u, nan=0.0)
    u = torch.clamp(u, 0.0, float(length - 1))
    return u.to(torch.int64)
