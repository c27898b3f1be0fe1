"""Process-group start-up and per-rank output.

Counterpart of ``graph_framework_tpu.parallel.distributed``.  The
reference is one node with one thread per device (xrays.cpp:419-527);
the JAX package starts ``jax.distributed`` and runs one program over every
host's chips.  Here one process drives one device: every process calls
:func:`initialize` with the same address and world size and its own rank,
and :func:`.mesh.ray_mesh` then gives its slice of the rays.  Nothing is
auto-detected: nothing on a machine announces a cluster, so the caller
names the coordinator, the world size and the rank.

Output follows the reference's file-per-worker scheme (``result<n>.nc``,
xrays.cpp:461): each rank writes its own rows (:func:`host_local_rows`)
to :func:`host_output_filename`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from graph_framework_tpu_torch.parallel.mesh import RayMesh, local_rows


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, backend: Optional[str] = None) -> None:
    """Join the process group at ``coordinator_address`` ("host:port", the
    rank-0 process listens there) as rank ``process_id`` of
    ``num_processes``; a no-op for one process, as in the JAX package.

    ``backend``: by default "nccl" where this rank's device is a CUDA card,
    else "gloo".  For "nccl" the rank's card (``cuda:<rank % cards>``) is
    made the current device; "gloo" touches no card.  Two ranks that share
    one card need "gloo": NCCL refuses them."""
    if num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def process_info():
    """(rank, world size, local CUDA device count)."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return rank, world, cards


def host_local_rows(array: torch.Tensor, mesh: RayMesh):
    """(global ray indices, numpy values) of this rank's slice ``array``
    (rays on the leading axis): with a per-rank result file this is the
    reference's file-per-worker output, without any gather."""
    n = array.shape[0]
    start = local_rows(n * mesh.world_size, mesh).start
    return (np.arange(start, start + n, dtype=np.int64),
            array.detach().cpu().numpy())


def host_output_filename(base: str = "result") -> str:
    """``<base><rank>.nc`` (the reference's result<n>.nc, xrays.cpp:461)."""
    return f"{base}{process_info()[0]}.nc"
