"""graph_framework_tpu_torch: the PyTorch + CUDA port of graph_framework_tpu.

The JAX package ``graph_framework_tpu`` stays the reference; this package
keeps its module names so each counterpart is easy to find, and is held to
it by ``tests/test_torch_*.py`` (the same inputs through both packages).

It imports ``torch`` and numpy only - never ``jax`` and never
``graph_framework_tpu``.  Plain tensor code is eager PyTorch: functions on
tensors, ``NamedTuple`` states of tensors, an explicit device and dtype.
There is no ``jit``: ``lax.scan`` becomes a Python loop, and the hot loop
is the hand-written CUDA kernel in ``csrc/efit_window.cu`` (wrapper and
plain version in :mod:`graph_framework_tpu_torch.kernels.efit_step`).

Subpackages
-----------
``ops``      table index, spline evaluation, RK integrators, compensated
             accumulation, Newton iteration.
``models``   the equilibrium protocol, EFIT, cold-plasma dispersion, ray
             equations.
``kernels``  CUDA kernel wrappers and their build (``nvcc`` at first use).
``tools``    numpy spline-table builders for EFIT inputs.
"""

__version__ = "0.1.0"

from graph_framework_tpu_torch import constants  # noqa: F401
