"""Mid-trace checkpoints of a ray ensemble (``torch.save``).

Counterpart of ``graph_framework_tpu.io.checkpoint`` (Orbax there).  The
reference's only checkpoint is its NetCDF result file, through which the
three xrays phases talk (``io.output.ResultFile``); this module saves the
live ray state itself, so that a long trace can stop and resume without
the result file.  A checkpoint is a directory holding ``ray_state.pt``, a
dict of the leaves by name; with ``step`` it is ``path/step_<step>``.
One card holds the whole state, so there are no shards: the leaves are
saved from the device they are on and restored to the template's device
(or to ``device``; without either, to the card).
"""

from __future__ import annotations

import pathlib
from typing import Optional

import torch

from graph_framework_tpu_torch.models.rays import RayState

_FILE = "ray_state.pt"


def _directory(path, step: Optional[int]) -> pathlib.Path:
    path = pathlib.Path(path).absolute()
    return path / f"step_{step}" if step is not None else path


def save_ray_state(path, state: RayState, *, step: Optional[int] = None,
                   force: bool = True) -> None:
    """Write ``state`` (a RayState, or any named tuple of tensors) as a
    checkpoint under ``path`` (``path/step_<step>`` with ``step``).
    ``force``: replace a checkpoint that is there already; otherwise
    FileExistsError."""
    out = _directory(path, step)
    if (out / _FILE).exists() and not force:
        raise FileExistsError(f"checkpoint {out} exists (force=False)")
    out.mkdir(parents=True, exist_ok=True)
    leaves = {name: leaf.detach() for name, leaf in
              zip(state._fields, state)}
    tmp = out / f".{_FILE}.tmp"
    torch.save(leaves, tmp)
    tmp.replace(out / _FILE)


def restore_ray_state(path, template: Optional[RayState] = None, *,
                      step: Optional[int] = None,
                      device=None) -> RayState:
    """Restore a checkpoint written by :func:`save_ray_state`.

    ``template``: a RayState of matching shapes and dtypes (the freshly
    initialised state, say) whose device, dtype and shapes the restored
    leaves take, checked; without one the leaves keep their saved dtypes.
    ``device``: where to put them (default the template's, else the
    card).
    """
    leaves = torch.load(_directory(path, step) / _FILE,
                        map_location="cpu", weights_only=True)
    if list(leaves) != list(RayState._fields):
        raise ValueError(f"not a ray-state checkpoint: leaves "
                         f"{list(leaves)}")
    if template is None:
        target = torch.device(device or "cuda")
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
             and (p / _FILE).is_file()]
    return max(steps) if steps else None
