"""graph_framework_tpu_torch: the PyTorch + CUDA port of graph_framework_tpu.

The JAX package ``graph_framework_tpu`` stays the reference; this package
keeps its module names so each counterpart is easy to find, and is held to
it by ``tests/test_torch_*.py`` (the same inputs through both packages).

It imports ``torch`` and numpy only - never ``jax`` and never
``graph_framework_tpu``.  Plain tensor code is eager PyTorch: functions on
tensors, ``NamedTuple`` states of tensors, an explicit device and dtype
(the card unless the caller names another).  There is no ``jit``:
``lax.scan`` becomes a Python loop, and the hot loops are hand-written
CUDA kernels in ``csrc/`` - the ray trace's freeze window and its
backward, the slab-field Boris push and the PIC deposit - each with its
wrapper and plain version in :mod:`graph_framework_tpu_torch.kernels`.

Subpackages
-----------
``ops``      table index and gathers, spline evaluation, RK, split-
             symplectic and adaptive integrators, compensated
             accumulation, Newton iteration (real and holomorphic), the
             complex special functions (Faddeeva w, erf, plasma Z).
``models``   the equilibrium protocol, the analytic equilibria, EFIT,
             VMEC, the dispersion zoo with the hot plasmas, ray
             equations, absorption and power binning, the Boris pusher
             (korc) and the PIC demo (pic).
``io``       NetCDF4 result files (h5py, imported when a file opens),
             the asynchronous row writer and ray-state checkpoints (a
             file a rank for an ensemble split across processes).
``parallel`` a ray ensemble split across processes, one a device
             (``torch.distributed``): each rank's slice, the replicated
             tables, Newton's ensemble max and config 5's sums as
             all-reduces, the group's start-up and per-rank rows.
``cli``      the programs ``xrays`` (trace, absorption, power),
             ``xrays_bench``, ``xkorc`` and ``xpic``; the card unless
             ``--device`` names another device.
``kernels``  CUDA kernel wrappers and their build (``nvcc`` at first use).
``tools``    numpy spline-table builders for EFIT inputs; the kernels'
             operation counter.
``capi``     the C API over the port: ``libgraph_tpu_torch.so`` (the JAX
             package's C source and header, importing this package's
             bridge) and its gcc build at first use, with the embedders'
             C and Fortran test programs.

``postprocess`` (NaN scrub, 3D power bins over result files) is a
module of its own, as in the JAX package; so are ``expr`` (expression
graphs, their derivatives and reductions, and the workflow manager that
runs setter items eagerly on the variables' device) and ``capi_bridge``
(the Python side of the C library: contexts of a scalar type and a
device, the card unless ``GRAPH_TORCH_DEVICE`` names another).
"""

__version__ = "0.1.0"

from graph_framework_tpu_torch import constants  # noqa: F401
