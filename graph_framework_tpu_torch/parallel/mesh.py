"""Ray ensembles split across processes: one process per device.

Counterpart of ``graph_framework_tpu.parallel.mesh``.  The reference runs
one worker thread per device, each with its own graph and NetCDF file and
a contiguous share of the rays (graph_driver/xrays.cpp:419-527), with no
communication in the trace.  The JAX package runs one SPMD program over a
``Mesh("rays")`` and lets XLA insert the one collective the workload
needs.  Here each process of a ``torch.distributed`` group owns one device
and the contiguous slice ``[rank n / W, (rank + 1) n / W)`` of the rays,
and the collectives are explicit, two in all:

* Newton's ensemble max, once an iteration (``init_k(mesh=)``,
  :meth:`RayMesh.ensemble_max`; the reference's max-reduction kernel,
  cuda_context.hpp:954-995);
* config 5's loss and gradient sums, once a pass
  (``absorbed_power_grad(mesh=)``, :meth:`RayMesh.all_reduce_sum`).

The trace itself (``Solver.run``, ``Solver.trace``) runs on the local
slice and never communicates.  The spline tables are replicated: each
process holds the whole equilibrium on its device (:func:`replicate`).

Not ported: ``block_rays`` and ``make_blocked_sharded_fn``'s ``lax.map``
over blocks of the local slice.  They fix the TPU's working set; the port
traces 1M rays a card without blocking (``Solver.run``'s ``block_rays`` is
not ported either).  Start the group with :mod:`.distributed` first.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map

#: All-reduces launched by :class:`RayMesh` (Newton's ensemble max,
#: config 5's sums); ``chip_smoke.py`` reads it to show that a path went
#: through the collective.
all_reduce_calls = 0


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """This process's place in the ray split (the port's
    ``jax.sharding.Mesh``): the group's size and this process's rank, the
    rank's device, and the process group (None when no group is
    initialised: one process, whose collectives are the identity)."""
    world_size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    def ensemble_max(self, value: torch.Tensor) -> torch.Tensor:
        """The max of a 0-dim ``value`` over the ranks, NaN where any
        rank's is NaN, as ``.max()`` of the whole ensemble is.

        A MAX all-reduce alone does not give that: gloo's result depends
        on which rank holds the NaN.  So each rank sends the max of its
        non-NaN value (NaN as -inf) beside a NaN flag, one all-reduce of
        two numbers."""
        if self.group is None:
            return value
        nan = torch.isnan(value)
        packed = torch.stack([torch.where(nan, float("-inf"), value),
                              nan.to(value.dtype)])
        self._all_reduce(packed, dist.ReduceOp.MAX)
        return torch.where(packed[1] > 0, float("nan"), packed[0])

    def all_reduce_sum(self, tensors: Sequence[torch.Tensor]):
        """The sums over the ranks of ``tensors`` (one dtype), as one
        all-reduce of their concatenation."""
        if self.group is None:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self._all_reduce(flat, dist.ReduceOp.SUM)
        parts = flat.split([t.numel() for t in tensors])
        return [part.view_as(t) for part, t in zip(parts, tensors)]

    def barrier(self) -> None:
        """Wait until every rank reaches this point."""
        if self.group is None:
            return
        if dist.get_backend(self.group) == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def _all_reduce(self, tensor, op):
        global all_reduce_calls
        dist.all_reduce(tensor, op=op, group=self.group)
        all_reduce_calls += 1


def ray_mesh(device=None, group=None) -> RayMesh:
    """The mesh of this process: the initialised group (``group``, else
    the default one) or, with none initialised, one process.  ``device``:
    the rank's device, by default ``cuda:<rank % cards>``; without a CUDA
    card that raises, and the caller names ``device="cpu"`` for a CPU
    run."""
    if dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    else:
        group, rank, world = None, 0, 1
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("ray_mesh: no CUDA device; name "
                               "device='cpu' for a CPU run")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return RayMesh(world, rank, device, group)


def pad_to_devices(n: int, mesh: RayMesh) -> int:
    """Smallest multiple of the world size >= n (the reference gives the
    remainder rays to the low-numbered threads, xrays.cpp:424-432; padding
    with dead rays keeps every slice the same size)."""
    w = mesh.world_size
    return ((n + w - 1) // w) * w


def local_rows(n: int, mesh: RayMesh) -> slice:
    """This rank's rows of an ensemble of n rays."""
    if n % mesh.world_size:
        raise ValueError(
            f"{n} rays do not split over {mesh.world_size} ranks; pad the "
            f"ensemble to pad_to_devices(n, mesh) = "
            f"{pad_to_devices(n, mesh)} rays first")
    size = n // mesh.world_size
    return slice(mesh.rank * size, (mesh.rank + 1) * size)


def shard_rays(tree, mesh: RayMesh):
    """This rank's contiguous slice of every leaf of a ray ensemble (a
    RayState, or any tree of tensors with the rays on the leading axis),
    on the rank's device."""
    sizes = {leaf.shape[0] for leaf in tree_flatten(tree)[0]
             if isinstance(leaf, torch.Tensor)}
    if len(sizes) != 1:
        raise ValueError(f"leaves of {len(sizes)} ray counts {sorted(sizes)}"
                         f"; shard_rays needs one")
    rows = local_rows(sizes.pop(), mesh)
    return tree_map(lambda a: a[rows].to(mesh.device)
                    if isinstance(a, torch.Tensor) else a, tree)


def replicate(tree, mesh: RayMesh):
    """``tree`` (an equilibrium, or any tree of tensors) with every tensor
    on the rank's device: each process holds the whole tables."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: replicate(getattr(tree, f.name), mesh)
            for f in dataclasses.fields(tree) if f.init})
    return tree_map(lambda a: a.to(mesh.device)
                    if isinstance(a, torch.Tensor) else a, tree)


def _check_device(state, mesh: RayMesh) -> None:
    if state.x.device != mesh.device:
        raise ValueError(f"the slice is on {state.x.device}, the rank's "
                         f"device is {mesh.device}: shard_rays puts it there")


def sharded_trace_fn(solver, mesh: RayMesh, num_steps: int):
    """``state -> (final, trajectory)``: ``solver.trace`` over this rank's
    slice (from :func:`shard_rays`), whose rows it returns; no
    collective."""
    def run(state):
        _check_device(state, mesh)
        return solver.trace(state, num_steps)

    return run


def run_blocked_sharded(solver, state, num_steps: int, mesh: RayMesh):
    """``solver.run`` over this rank's slice: ``num_steps`` recorded steps,
    no trajectory, no collective.  ``Solver.run`` checks separability
    eagerly before its first step, so a symplectic solver of a Hamiltonian
    that is not separable raises "Hamiltonian is not separable." here, as
    the JAX function's eager guard makes it (solver.hpp:1076-1094)."""
    _check_device(state, mesh)
    return solver.run(state, num_steps)
