"""Command-line programs: ``xrays`` (ray tracing, absorption, power
binning), ``xrays_bench``, ``xkorc`` and ``xpic``; each runs as
``python -m graph_framework_tpu_torch.cli.<name>``.

The phase functions of ``xrays``, ``xkorc`` and ``xpic`` take a store
factory ``open_store(path, mode, num_rays=None)``; their ``main`` passes
:func:`open_result_file`."""


def open_result_file(path, mode, num_rays=None):
    """The result file at ``path`` (``io.output.ResultFile``; needs h5py):
    mode "w" creates it for ``num_rays`` rays, "r+" reopens it."""
    from graph_framework_tpu_torch.io.output import ResultFile
    return ResultFile(path, num_rays=num_rays, mode=mode)
