"""Ray ensembles split across processes, one a device
(``torch.distributed``); the group's start-up in :mod:`.distributed`."""

from graph_framework_tpu_torch.parallel.mesh import (  # noqa: F401
    ray_mesh,
    shard_rays,
    replicate,
    sharded_trace_fn,
    run_blocked_sharded,
)
