"""Python side of the C binding (handle management + dtype plumbing).

Counterpart of ``graph_framework_tpu.capi_bridge``.  The native library
(``capi/graph_c_binding.c``, built as ``libgraph_tpu_torch.so`` by
``capi/build.py``) embeds CPython and calls these functions, each with the
JAX bridge's name and arguments; graph nodes cross the boundary as raw
PyObject pointers owned by the C side.  Mirrors the object model of the
reference's C binding (graph_c_binding/graph_c_binding.cpp): a context
owns a workflow manager, a scalar type and a device; nodes are expression
handles.

A context computes in its own scalar type: FLOAT in float32 and
COMPLEX_FLOAT in complex64 (the JAX bridge stores every variable as
float64/complex128, so there FLOAT computes in float64 once x64 is on).
Its device is the card unless ``GRAPH_TORCH_DEVICE`` names another (the
counterpart of the JAX bridge honouring ``JAX_PLATFORMS``): a C caller
chooses the CPU with ``GRAPH_TORCH_DEVICE=cpu``.  Without a card and
without that variable, :func:`make_context` raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from graph_framework_tpu_torch import expr as g

#: C enum graph_type -> (numpy dtype of the C buffers, torch dtype, its
#: real dtype)
_DTYPES = {0: (np.float32, torch.float32, torch.float32),
           1: (np.float64, torch.float64, torch.float64),
           2: (np.complex64, torch.complex64, torch.float32),
           3: (np.complex128, torch.complex128, torch.float64)}

#: The environment variable that names the contexts' device.
DEVICE_VARIABLE = "GRAPH_TORCH_DEVICE"


class Context:
    def __init__(self, type_code: int, safe_math: bool, device):
        self.type_code = type_code
        self.dtype, self.torch_dtype, self.real_dtype = _DTYPES[type_code]
        self.safe_math = bool(safe_math)
        self.device = torch.device(device)
        self.work = g.Workflow(device=self.device)

    @property
    def is_complex(self):
        return self.type_code >= 2


def make_context(type_code, safe_math):
    """A context on the device ``GRAPH_TORCH_DEVICE`` names, the card when
    it is unset; raises where that is the card and torch has none."""
    device = os.environ.get(DEVICE_VARIABLE) or "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"graph context: no CUDA device (torch.cuda.is_available() is "
            f"False); set {DEVICE_VARIABLE}=cpu to run on the CPU")
    return Context(int(type_code), bool(safe_math), device)


def variable(ctx, size, symbol):
    return g.variable(int(size), 0.0, symbol or "v",
                      dtype=ctx.torch_dtype, device=ctx.device)


def constant(ctx, value):
    return g.constant(ctx.dtype(value))


def constant_c(ctx, re, im):
    return g.constant(ctx.dtype(complex(re, im)))


def set_variable(ctx, var, buf):
    arr = np.frombuffer(buf, dtype=ctx.dtype, count=var.size).copy()
    var.set(torch.from_numpy(arr))


def pseudo_variable(ctx, node):
    return g.pseudo_variable(node)


def remove_pseudo(ctx, node):
    return node.remove_pseudo()


def add(ctx, a, b):
    return a + b


def sub(ctx, a, b):
    return a - b


def mul(ctx, a, b):
    return a * b


def div(ctx, a, b):
    return a / b


def sqrt(ctx, a):
    return g.sqrt(a)


def exp(ctx, a):
    return g.exp(a)


def log(ctx, a):
    return g.log(a)


def pow(ctx, a, b):
    return g.pow_(a, b)


def erfi(ctx, a):
    return g.erfi(a)


def sin(ctx, a):
    return g.sin(a)


def cos(ctx, a):
    return g.cos(a)


def atan(ctx, a, b):
    return g.atan(a, b)


def random_state(ctx, seed):
    # the state handle just carries the seed; graph_random builds the node
    return int(seed)


def random(ctx, state_or_seed):
    seed = state_or_seed if isinstance(state_or_seed, int) else 0
    return g.random(1, seed=seed, dtype=ctx.real_dtype)


def _table(ctx, buf, size):
    # a copy: the C caller may free or reuse its buffer after the call
    return np.frombuffer(buf, dtype=ctx.dtype, count=int(size)).copy()


def piecewise_1d(ctx, arg, scale, offset, buf, size):
    data = _table(ctx, buf, size)
    return g.piecewise_1D(data, arg, scale, offset)


def piecewise_2d(ctx, num_cols, x, x_scale, x_offset, y, y_scale,
                 y_offset, buf, size):
    data = _table(ctx, buf, size)
    return g.piecewise_2D(data, int(num_cols), x, x_scale, x_offset,
                          y, y_scale, y_offset)


def index_1d(ctx, var, arg, scale, offset):
    return g.index_1D(var, arg, scale, offset)


def index_2d(ctx, var, num_cols, x, x_scale, x_offset, y, y_scale,
             y_offset):
    return g.index_2D(var, int(num_cols), x, x_scale, x_offset,
                      y, y_scale, y_offset)


def df(ctx, a, b):
    return a.df(b)


def get_max_concurrency(ctx):
    """The CUDA devices a context on the card can use; a CPU context has
    its one device."""
    if ctx.device.type == "cuda":
        return torch.cuda.device_count()
    return 1


def set_device_number(ctx, num):
    pass   # as in the JAX bridge: device selection is not per context


def _items(inputs, outputs, map_in, map_out):
    setters = list(zip(map_in, map_out))
    return list(inputs), list(outputs), setters


def add_pre_item(ctx, inputs, outputs, map_in, map_out, name, size):
    i, o, s = _items(inputs, outputs, map_in, map_out)
    ctx.work.add_preitem(i, o, s, name=name or "pre")


def add_item(ctx, inputs, outputs, map_in, map_out, name, size):
    i, o, s = _items(inputs, outputs, map_in, map_out)
    ctx.work.add_item(i, o, s, name=name or "item")


def add_converge_item(ctx, inputs, outputs, map_in, map_out, name, size,
                      tol, max_iter):
    i, o, s = _items(inputs, outputs, map_in, map_out)
    ctx.work.add_converge_item(i, o, s, name=name or "converge",
                               tol=float(tol), max_iter=int(max_iter))


def compile(ctx):
    ctx.work.compile()


def pre_run(ctx):
    ctx.work.pre_run()


def run(ctx):
    ctx.work.run()


def wait(ctx):
    ctx.work.wait()


def copy_to_device(ctx, node, buf):
    set_variable(ctx, node, buf)


def _host(ctx, node) -> np.ndarray:
    if isinstance(node, g.Variable):
        return node.data.cpu().numpy()
    return node.evaluate(device=ctx.device).cpu().numpy()


def copy_to_host(ctx, node):
    """Return the node's bytes in the context dtype."""
    return np.ascontiguousarray(_host(ctx, node).astype(ctx.dtype)).tobytes()


def print_nodes(ctx, index, nodes):
    values = [_host(ctx, n).ravel() for n in nodes]
    print(" ".join(str(v[min(index, v.size - 1)]) for v in values))
