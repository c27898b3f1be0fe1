"""Result files (NetCDF4 through h5py), the asynchronous row writer, and
ray-state checkpoints (``torch.save``)."""

from graph_framework_tpu_torch.io.checkpoint import (  # noqa: F401
    latest_step, restore_ray_state, save_ray_state)
from graph_framework_tpu_torch.io.output import (  # noqa: F401
    AsyncWriter, ResultFile, state_row)
