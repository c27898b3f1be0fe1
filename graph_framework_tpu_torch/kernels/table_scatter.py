"""The transpose of the spline tables' row gather: CUDA kernel wrapper and
its plain version.

For a (n, width) cotangent ``grad`` of the rows ``table[idx]`` gathered
from a (cells, width) table, the table's gradient is

    out[c] = sum over the rows r with idx[r] == c of grad[r].

The JAX package has no kernel for it (XLA transposes its gathers); the
port's library transpose, ``index_put_`` with accumulate, sums the rows of
one cell serially, which is slow when many rows share a cell (config 5's
beam: 125k rays in a handful of cells).

* :func:`table_scatter_plain` is the plain PyTorch version:
  ``zeros(cells, width).index_add_(0, idx, grad)``, which on the CPU sums
  each cell's rows in row order, as ``index_put_`` with accumulate does.
* :func:`table_scatter` is the wrapper.  For CPU tensors, and only then, it
  runs the plain version; for float32 and float64 CUDA tensors it launches
  the hand-written kernel of ``csrc/table_scatter.cu`` (built by ``nvcc`` on
  first use, kernels/build.py) on the current stream into an output it
  zeroes, or raises: there is no fallback.  ``table_scatter_launches``
  counts its launches; each is the span ``gft.table_scatter``
  (``telemetry``).

The kernel sums a cell's rows in another order than the plain version (a
tree in the warp, then atomics), so a cell's last bits may differ from the
plain version's and from run to run.
"""

from __future__ import annotations

import torch

from graph_framework_tpu_torch import telemetry
from graph_framework_tpu_torch.kernels import build
from graph_framework_tpu_torch.utils import check_kernel_outputs

#: Wrapper calls that launched the kernel; plain-version calls do not count.
table_scatter_launches = 0


def table_scatter_plain(grad, idx, cells):
    """Plain version: the (cells, width) sum of the rows of ``grad`` (n,
    width) by their cells ``idx`` (n,)."""
    out = torch.zeros((cells, grad.shape[1]), dtype=grad.dtype,
                      device=grad.device)
    return out.index_add_(0, idx, grad)


def _check(grad, idx, cells):
    if grad.ndim != 2 or idx.ndim != 1 or idx.shape[0] != grad.shape[0]:
        raise ValueError(f"table_scatter takes (n, width) rows and (n,) "
                         f"cells, not {tuple(grad.shape)} and "
                         f"{tuple(idx.shape)}")
    if idx.dtype != torch.int64 or idx.device != grad.device:
        raise ValueError("table_scatter takes int64 cells on the rows' "
                         "device")
    if cells < 1:
        raise ValueError(f"table_scatter needs at least one cell, not "
                         f"{cells}")


def _launch(grad, idx, cells):
    """The kernel on the current stream: a new (cells, width) tensor."""
    global table_scatter_launches
    grad, idx = grad.contiguous(), idx.contiguous()
    dtype = build.check("the table_scatter kernel", (grad,), "rows")
    n, width = grad.shape
    out = torch.zeros((cells, width), dtype=grad.dtype, device=grad.device)
    if n == 0:
        return out
    vec = int(width * grad.element_size() % 16 == 0
              and grad.data_ptr() % 16 == 0)
    sms = torch.cuda.get_device_properties(grad.device).multi_processor_count
    with telemetry.span("gft.table_scatter"):
        build.call(build.load().gft_table_scatter, "table_scatter", grad,
                   dtype, n, width, cells, grad.data_ptr(), idx.data_ptr(),
                   vec, sms, out.data_ptr())
    table_scatter_launches += 1
    check_kernel_outputs("table_scatter", ("out",), (out,), (grad,),
                         unit="column")
    return out


def table_scatter(grad, idx, cells):
    """The (cells, width) table gradient of the rows ``grad`` (n, width)
    gathered from the cells ``idx`` (n, int64, each in [0, cells)).

    CPU tensors run :func:`table_scatter_plain`; float32 and float64 CUDA
    tensors launch the kernel and return a new tensor.  Anything the kernel
    does not take raises."""
    _check(grad, idx, cells)
    if grad.device.type == "cpu":
        return table_scatter_plain(grad, idx, cells)
    return _launch(grad, idx, cells)
