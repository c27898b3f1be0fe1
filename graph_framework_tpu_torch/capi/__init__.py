"""The C API over the port: ``libgraph_tpu_torch.so``.

``graph_c_binding.c`` and ``graph_c_binding.h`` are the JAX package's
``capi/`` sources with one change: the library imports
``graph_framework_tpu_torch.capi_bridge``.  It exports the same symbols, so
the embedders' side of the contract - ``capi/c_binding_test.c``,
``capi/graph_fortran_binding.f90`` and ``capi/f_binding_test.f90`` -
compiles unchanged against it.  :mod:`graph_framework_tpu_torch.capi.build`
builds the library and those programs with gcc (gfortran) at first use.
"""
