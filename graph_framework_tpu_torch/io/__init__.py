"""Result files (NetCDF4 through h5py) and the asynchronous row writer."""

from graph_framework_tpu_torch.io.output import (  # noqa: F401
    AsyncWriter, ResultFile, state_row)
