"""Top-level ray-tracing driver: Newton init + the time loop.

Counterpart of ``graph_framework_tpu.solver`` (reference:
solver.hpp:120-530, graph_driver/xrays.cpp:161-260).  PyTorch runs
eagerly, so the JAX package's ``lax.scan`` loops are Python loops here,
and the hot loop is one CUDA kernel launch per freeze window
(``Solver(window_kernel=True)``; kernels/efit_step.py).

Ported: fixed-dt rk2/rk4, plain or compensated, with or without frozen
cells and freeze windows; ``run``, ``trace`` and ``trace_segmented``.
Reverse mode runs through every plain path by autograd - the gradients of
trace endpoints with respect to the launch state (through ``init_k``'s
implicit root gradient) and to the spline tables - and through the window
kernel by its backward kernels; ``remat_substeps`` checkpoints the plain
path.  The compensated window kernel is forward-only.  The equilibrium
may be EFIT or VMEC (flux coordinates; frozen cells through its
``freeze_cells``, the fused geometry kernel K4 through its
``fused_mode_sums``); the window kernel is EFIT's.
Not ported yet: ``split_symplectic``, ``adaptive_rk4``, ``remat_policy``,
``block_rays`` and ``pad_rays`` (the kernel masks a ragged last block, so
the ray count needs no padding).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.utils.checkpoint

from graph_framework_tpu_torch.kernels.efit_step import (
    efit_window, frozen_window)
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.models.efit import EfitEquilibrium
from graph_framework_tpu_torch.models.rays import (
    RayState, dispersion_residual, make_ray_rhs)
from graph_framework_tpu_torch.ops.compensated import (
    CompCarry, compensated_stepper, init_comp_carry)
from graph_framework_tpu_torch.ops.integrators import INCREMENTS, STEPPERS
from graph_framework_tpu_torch.ops.newton import newton_solve


def make_ray_state(num_rays=None, *, t=0.0, w, x=0.0, y=0.0, z=0.0,
                   kx=0.0, ky=0.0, kz=0.0, dtype=torch.float64,
                   device="cuda") -> RayState:
    """Build a RayState from scalars or arrays, broadcast to num_rays, on
    ``device`` (the card unless the caller names another)."""
    leaves = dict(t=t, w=w, x=x, y=y, z=z, kx=kx, ky=ky, kz=kz)
    leaves = {k: torch.as_tensor(v, dtype=dtype, device=device)
              for k, v in leaves.items()}
    if num_rays is None:
        num_rays = max(v.shape[0] if v.ndim else 1 for v in leaves.values())
    return RayState(**{k: v.expand(num_rays).contiguous()
                       for k, v in leaves.items()})


def init_k(state: RayState, dispersion, eq, which: str = "kx", *,
           tolerance: Optional[float] = None, max_iterations: int = 1000,
           return_diagnostics: bool = False):
    """Newton-solve D = 0 for one wave-number component per ray
    (solver_interface::init -> dispersion::solve -> solver::newton,
    solver.hpp:252-298, dispersion.hpp:1450-1475).

    ``tolerance``: default None = dtype-aware - the reference's 1.0e-30
    (newton.hpp:39) for f64, 1.0e-10 otherwise.  In f32 the residual D^2
    bottoms out at rounding noise far above 1e-30, and further Newton
    steps then divide that noise by a small derivative and can wander to
    a neighbouring root; a tolerance the dtype resolves stops at the
    first root reached.
    """
    if tolerance is None:
        tolerance = 1.0e-30 if state.w.dtype == torch.float64 else 1.0e-10
    d_all = dispersion_residual(dispersion, eq)

    def f(kval):
        return d_all(*state._replace(**{which: kval}))

    k_solved, _, diag = newton_solve(
        f, getattr(state, which), tolerance=tolerance,
        max_iterations=max_iterations)
    out = state._replace(**{which: k_solved})
    if return_diagnostics:
        return out, diag
    return out


@dataclasses.dataclass(frozen=True)
class Solver:
    """A ray tracer for one (dispersion, equilibrium, method).

    ``method``: "rk2" | "rk4".  ``dt``: time step.  ``sub_steps``:
    integrator steps per recorded output step (xrays.cpp:246-254).
    ``compensated``: carry the state as (hi, lo) words with TwoSum
    accumulation (ops/compensated.py).  ``frozen_cells``: gather each
    ray's spline blocks once per freeze window and evaluate every stage
    against them (models/efit.FrozenCellEfit); ``freeze_every``: the
    window in substeps, dividing ``sub_steps``.  ``window_kernel``: run
    each freeze window as one launch of the CUDA window kernel
    (kernels/efit_step.py; the plain version on CPU tensors) - the
    counterpart of the JAX package's ``pallas_window``; its backward is a
    kernel too.  ``remat_substeps``: under autograd, keep only each
    integrator unit's input (a substep, or a freeze window when frozen -
    the JAX package's checkpointed stepper) and recompute the unit in the
    backward pass (``torch.utils.checkpoint``); the window kernel already
    recomputes inside its backward, so the two do not combine.
    """
    dispersion: Callable
    eq: object
    method: str = "rk4"
    dt: float = 1.0e-4
    sub_steps: int = 1
    compensated: bool = False
    frozen_cells: bool = False
    freeze_every: int = 1
    window_kernel: bool = False
    remat_substeps: bool = False

    def __post_init__(self):
        if self.method not in STEPPERS:
            raise ValueError(
                f"method {self.method!r} is not ported; available: "
                f"{sorted(STEPPERS)}")
        if self.sub_steps < 1:
            raise ValueError(f"sub_steps={self.sub_steps} must be >= 1")
        if self.frozen_cells and not hasattr(self.eq, "freeze_cells"):
            raise ValueError(
                f"{type(self.eq).__name__} has no freeze_cells "
                "(frozen-cell stepping is a spline-equilibrium "
                "optimization)")
        if self.freeze_every != 1:
            if not self.frozen_cells:
                raise ValueError("freeze_every needs frozen_cells=True")
            if self.freeze_every < 1 or self.sub_steps % self.freeze_every:
                raise ValueError(
                    f"freeze_every={self.freeze_every} must divide "
                    f"sub_steps={self.sub_steps}")
        if self.window_kernel:
            if not self.frozen_cells:
                raise ValueError("window_kernel needs frozen_cells=True")
            if not isinstance(self.eq, EfitEquilibrium):
                raise ValueError(
                    "window_kernel needs an EfitEquilibrium: the window "
                    "kernel is EFIT's, as pallas_window is in the JAX "
                    "package (VMEC steps its frozen windows in plain torch)")
            if self.dispersion is not cold_plasma:
                raise ValueError(
                    "window_kernel implements cold_plasma only")
            if self.remat_substeps:
                raise ValueError(
                    "remat_substeps is redundant with window_kernel: the "
                    "window's backward kernel already recomputes its "
                    "substeps; set remat_substeps=False")

    # -- the integration carry ---------------------------------------------
    def init_carry(self, state: RayState):
        """The RayState itself, or a CompCarry when compensated."""
        return init_comp_carry(state) if self.compensated else state

    @staticmethod
    def carry_state(carry) -> RayState:
        return carry.hi if isinstance(carry, CompCarry) else carry

    def step_fn(self):
        """The recorded step ``carry -> carry``: sub_steps integrator
        substeps, as sub_steps // freeze_every windows when frozen."""
        method, dt = self.method, self.dt
        if self.frozen_cells:
            windows, k = self.sub_steps // self.freeze_every, self.freeze_every
            if self.window_kernel:
                def window(c):
                    return efit_window(self.eq, c, method=method, dt=dt,
                                       steps=k,
                                       compensated=self.compensated)
            else:
                def window(c):
                    return frozen_window(self.eq, self.dispersion, c,
                                         method=method, dt=dt, steps=k,
                                         compensated=self.compensated)
        else:
            windows = self.sub_steps
            rhs = make_ray_rhs(self.dispersion, self.eq)
            if self.compensated:
                window = compensated_stepper(
                    lambda s: INCREMENTS[method](rhs, s, dt))
            else:
                def window(s):
                    return STEPPERS[method](rhs, s, dt)

        if self.remat_substeps:
            unit = window

            def window(c):
                return torch.utils.checkpoint.checkpoint(
                    unit, c, use_reentrant=False)

        def step(carry):
            for _ in range(windows):
                carry = window(carry)
            return carry

        return step

    # -- drivers -----------------------------------------------------------
    def run(self, state: RayState, num_steps: int,
            return_carry: bool = False):
        """Advance num_steps recorded steps with no trajectory storage -
        the configuration of the reference's benchmark loop
        (xrays_bench.cpp:97-101).  ``return_carry`` also returns the final
        integration carry (the compensated low words)."""
        step = self.step_fn()
        carry = self.init_carry(state)
        for _ in range(num_steps):
            carry = step(carry)
        if return_carry:
            return self.carry_state(carry), carry
        return self.carry_state(carry)

    def trace(self, state: RayState, num_steps: int):
        """Run num_steps recorded steps; returns (final_state, trajectory)
        with the trajectory a RayState of (num_steps + 1, rays) leaves,
        the initial state first (the per-step rows of solver.hpp
        write_step)."""
        step = self.step_fn()
        carry = self.init_carry(state)
        rows = [state]
        for _ in range(num_steps):
            carry = step(carry)
            rows.append(self.carry_state(carry))
        traj = RayState(*[torch.stack(leaf) for leaf in zip(*rows)])
        return self.carry_state(carry), traj

    def trace_segmented(self, state: RayState, num_steps: int,
                        writer: Callable[[int, RayState], None],
                        segment: int = 16):
        """Segment-buffered streaming: ``segment`` recorded rows are
        stacked on the device and copied to the host as ONE block per
        leaf; ``writer(i, row)`` then receives host (CPU) RayState rows
        in order, row 0 the initial state.

        On a CUDA device the copy is asynchronous into pinned memory and
        the next segment is queued before the previous block is handed to
        the writer, so writing overlaps compute (the reference's
        double-buffered writer thread, solver.hpp:418-424).
        """
        step = self.step_fn()
        cuda = state.x.is_cuda

        def to_host(rows):
            block = [torch.stack(leaf) for leaf in zip(*rows)]
            host = [b.to("cpu", non_blocking=cuda) for b in block]
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            return host, event

        def drain(pending):
            (host, event), start = pending
            if event is not None:
                event.synchronize()
            for j in range(host[0].shape[0]):
                writer(start + j, RayState(*[h[j] for h in host]))

        carry = self.init_carry(state)
        pending = (to_host([state]), 0)
        i = 1
        while i <= num_steps:
            k = min(segment, num_steps - i + 1)
            rows = []
            for _ in range(k):
                carry = step(carry)
                rows.append(self.carry_state(carry))
            nxt = (to_host(rows), i)
            drain(pending)
            pending = nxt
            i += k
        drain(pending)
        return self.carry_state(carry)
