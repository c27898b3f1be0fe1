"""Mid-trace checkpoints of a ray ensemble (``torch.save``).

Counterpart of ``graph_framework_tpu.io.checkpoint`` (Orbax there).  The
reference's only checkpoint is its NetCDF result file, through which the
three xrays phases talk (``io.output.ResultFile``); this module saves the
live ray state itself, so that a long trace can stop and resume without
the result file.  A checkpoint is a directory (``path/step_<step>`` with
``step``) of one file a rank, ``ray_state.rank<r>.pt``: the rank's slice
of the leaves by name, the slice's global offset and the ensemble's size,
as the JAX package writes each host's shards.  One process is a world of
one (offset 0, the whole ensemble).  A checkpoint restores under any
world size that divides the ensemble (or by one process, whole), each
rank reading the slices that cover its rows.  The leaves are saved from
the device they are on and restored to the template's device, the
mesh's, or ``device`` (without any of them, to the card).
"""

from __future__ import annotations

import pathlib
from typing import Optional

import torch

from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.parallel.mesh import RayMesh, local_rows

_SHARDS = "ray_state.rank*.pt"


def _shard_file(rank: int) -> str:
    return f"ray_state.rank{rank}.pt"


def _directory(path, step: Optional[int]) -> pathlib.Path:
    path = pathlib.Path(path).absolute()
    return path / f"step_{step}" if step is not None else path


def save_ray_state(path, state: RayState, *, step: Optional[int] = None,
                   force: bool = True,
                   mesh: Optional[RayMesh] = None) -> None:
    """Write ``state`` (a RayState, or any named tuple of tensors) as a
    checkpoint under ``path`` (``path/step_<step>`` with ``step``).
    ``force``: replace a checkpoint that is there already; otherwise
    FileExistsError.  ``mesh``: ``state`` is this rank's slice; every rank
    calls this, and it returns when all have written."""
    out = _directory(path, step)
    if any(out.glob(_SHARDS)) and not force:
        raise FileExistsError(f"checkpoint {out} exists (force=False)")
    n = state.x.shape[0]
    world, rank = (mesh.world_size, mesh.rank) if mesh else (1, 0)
    if mesh is not None:
        mesh.barrier()               # every rank has looked before any writes
    out.mkdir(parents=True, exist_ok=True)
    if rank == 0:
        for stale in out.glob(_SHARDS):
            if int(stale.name.split(".")[1][4:]) >= world:
                stale.unlink()
    name = _shard_file(rank)
    tmp = out / f".{name}.tmp"
    torch.save({"offset": n * rank, "total": n * world,
                "leaves": {f: leaf.detach() for f, leaf in
                           zip(state._fields, state)}}, tmp)
    tmp.replace(out / name)
    if mesh is not None:
        mesh.barrier()


def _pieces(directory: pathlib.Path):
    """(total rays, [(offset, leaves)]) of a checkpoint directory, the
    slices memory-mapped and checked to tile the ensemble once."""
    shards = [torch.load(f, map_location="cpu", weights_only=True, mmap=True)
              for f in sorted(directory.glob(_SHARDS))]
    if not shards:
        raise FileNotFoundError(f"no ray-state checkpoint in {directory}")
    total = shards[0]["total"]
    pieces = sorted((s["offset"], s["leaves"]) for s in shards)
    end = 0
    for offset, leaves in pieces:
        if list(leaves) != list(RayState._fields):
            raise ValueError(f"not a ray-state checkpoint: leaves "
                             f"{list(leaves)}")
        if offset != end:
            raise ValueError(f"checkpoint {directory}: slices cover rows up "
                             f"to {end}, the next starts at {offset}")
        end += next(iter(leaves.values())).shape[0]
    if end != total or any(s["total"] != total for s in shards):
        raise ValueError(f"checkpoint {directory}: slices cover {end} of "
                         f"{total} rays")
    return total, pieces


def restore_ray_state(path, template: Optional[RayState] = None, *,
                      step: Optional[int] = None, device=None,
                      mesh: Optional[RayMesh] = None) -> RayState:
    """Restore a checkpoint written by :func:`save_ray_state`.

    ``template``: a RayState of matching shapes and dtypes (the freshly
    initialised state, say) whose device, dtype and shapes the restored
    leaves take, checked; without one the leaves keep their saved dtypes.
    ``mesh``: restore this rank's slice (of a checkpoint written by any
    number of ranks, or by one process).  ``device``: where to put the
    leaves (default the template's, else the mesh's, else the card).
    """
    total, pieces = _pieces(_directory(path, step))
    rows = slice(0, total) if mesh is None else local_rows(total, mesh)
    leaves = {}
    for name in RayState._fields:
        parts = [piece[name][max(rows.start - offset, 0):
                             rows.stop - offset]
                 for offset, piece in pieces
                 if offset < rows.stop
                 and offset + piece[name].shape[0] > rows.start]
        leaves[name] = torch.cat(parts)
    if template is None:
        target = torch.device(device or (mesh.device if mesh else "cuda"))
        return RayState(*[leaves[f].to(target) for f in RayState._fields])
    out = []
    for name, like in zip(RayState._fields, template):
        leaf = leaves[name]
        if leaf.shape != like.shape or leaf.dtype != like.dtype:
            raise ValueError(
                f"checkpoint leaf {name} is {leaf.dtype} {tuple(leaf.shape)},"
                f" the template's {like.dtype} {tuple(like.shape)}")
        out.append(leaf.to(device or like.device))
    return RayState(*out)


def latest_step(path) -> Optional[int]:
    """Highest ``step_N`` saved under ``path`` (None when there is none) -
    where a restarted trace picks up after the last periodic checkpoint."""
    path = pathlib.Path(path)
    steps = [int(p.name.split("_", 1)[1]) for p in path.glob("step_*")
             if p.name.split("_", 1)[1].isdigit()
             and (p / _shard_file(0)).is_file()]
    return max(steps) if steps else None
