"""Top-level ray-tracing driver: Newton init + the time loop.

Counterpart of ``graph_framework_tpu.solver`` (reference:
solver.hpp:120-530, graph_driver/xrays.cpp:161-260).  PyTorch runs
eagerly, so the JAX package's ``lax.scan`` loops are Python loops here,
and the hot loop is one CUDA kernel launch per freeze window
(``Solver(window_kernel=True)``; kernels/efit_step.py).

Ported: fixed-dt rk2/rk4, plain or compensated, with or without frozen
cells and freeze windows; ``split_simplextic`` (position-kick-position,
for separable Hamiltonians, checked at the first eager entry as the JAX
package checks it); ``adaptive_rk4``, whose per-ray (dt, lambda) persist
across recorded steps in an ``AdaptiveCarry``; ``run``, ``trace``,
``trace_streaming`` (``trace_segmented`` a row at a time),
``trace_segmented`` (host blocks of rows, with per-row ``extras``
evaluated on the device), ``carry_step_fn`` and ``step_fn``.  A complex
state (``complex_float``/``complex_double``) traces with holomorphic
derivatives, and ``init_k`` solves for a complex wave number.  Reverse
mode runs through every plain path by autograd - the gradients of trace
endpoints with respect to the launch state (through ``init_k``'s implicit
root gradient) and to the spline tables - and through the window kernel
by its backward kernels; ``remat_substeps`` checkpoints the plain path.
The compensated window kernel is forward-only.  The equilibrium may be
EFIT or VMEC (flux coordinates; frozen cells through its
``freeze_cells``, the fused geometry kernel K4 through its
``fused_mode_sums``), or an analytic one; the window kernel is EFIT's and
takes every real dispersion (``kernels.efit_step.KERNEL_DISPERSIONS``);
the two hot plasmas, complex only, are refused.
``remat_policy="spline_jet"`` keeps the spline tables' gathered blocks of
each checkpointed unit and recomputes the rest (:func:`remat_context`).
Under debug mode (``utils.set_debug``) each recorded step checks every
eager operation's output and raises at the first one that makes a NaN or
an inf (``utils.checked_step``, the JAX package's checkify float checks).
Spans (``telemetry``): ``gft.solver.run`` and ``gft.trace_segmented`` over
each call, and in the latter ``gft.trace.extras`` (a row's extras),
``gft.trace.copy`` (a block's stack and copy to the host) and
``gft.trace.drain`` (the wait for a block and the writer's calls).
Not ported: ``block_rays`` and ``pad_rays`` (the kernel
masks a ragged last block, so the ray count needs no padding), and the
jit caches of ``make_segment_fn``/``extras_jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.utils.checkpoint

from graph_framework_tpu_torch import telemetry
from graph_framework_tpu_torch.kernels.efit_step import (
    efit_window, frozen_window, kernel_dispersion_code)
from graph_framework_tpu_torch.models.efit import EfitEquilibrium
from graph_framework_tpu_torch.models.rays import (
    RayState, dispersion_residual, make_ray_rhs)
from graph_framework_tpu_torch.ops.adaptive import (
    AdaptiveCarry, adaptive_rk4_carry_step, init_adaptive_carry)
from graph_framework_tpu_torch.ops.compensated import (
    CompCarry, compensated_stepper, init_comp_carry)
from graph_framework_tpu_torch.ops.integrators import (
    INCREMENTS, STEPPERS, check_separable)
from graph_framework_tpu_torch.ops.newton import newton_solve
from graph_framework_tpu_torch.utils import checked_step


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
           return_diagnostics: bool = False, mesh=None):
    """Newton-solve D = 0 for one wave-number component per ray
    (solver_interface::init -> dispersion::solve -> solver::newton,
    solver.hpp:252-298, dispersion.hpp:1450-1475).

    ``tolerance``: default None = dtype-aware - the reference's 1.0e-30
    (newton.hpp:39) for f64 and complex128, 1.0e-10 otherwise.  In f32
    the residual D^2 bottoms out at rounding noise far above 1e-30, and
    further Newton steps then divide that noise by a small derivative and
    can wander to a neighbouring root; a tolerance the dtype resolves
    stops at the first root reached.  A complex state takes Newton in the
    complex plane with D's complex derivative (``ops.newton``).

    ``mesh``: ``state`` is this rank's slice of an ensemble split across
    processes (``parallel.shard_rays``); the convergence test then reads
    the max over every rank, so each ray's root is the one a single
    process finds (``ops.newton``).
    """
    if tolerance is None:
        fine = state.w.dtype in (torch.float64, torch.complex128)
        tolerance = 1.0e-30 if fine else 1.0e-10
    d_all = dispersion_residual(dispersion, eq)

    def f(kval):
        return d_all(*state._replace(**{which: kval}))

    k_solved, _, diag = newton_solve(
        f, getattr(state, which), tolerance=tolerance,
        max_iterations=max_iterations, mesh=mesh)
    out = state._replace(**{which: k_solved})
    if return_diagnostics:
        return out, diag
    return out


#: The remat policies of ``Solver(remat_policy=...)``: the ATen operations
#: whose outputs a checkpointed unit keeps for its backward pass.
#: "spline_jet" keeps what the spline tables' gathers return - every
#: ``table[index]`` of ops/spline.py and ``freeze_cells`` - so the
#: recompute evaluates the splines from the kept blocks without reading the
#: tables again (the JAX package names the jet's products for
#: ``save_only_these_names``; torch has no names on tensors, but the
#: gathers are the only ``aten.index.Tensor`` an EFIT substep runs).
REMAT_POLICIES = {"spline_jet": (torch.ops.aten.index.Tensor,)}


def remat_context(saved_ops):
    """The ``context_fn`` pair of a selective checkpoint that keeps the
    outputs of ``saved_ops`` and recomputes every other operation."""
    from torch.utils.checkpoint import (
        CheckpointPolicy, create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        if op in saved_ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


@dataclasses.dataclass(frozen=True)
class Solver:
    """A ray tracer for one (dispersion, equilibrium, method).

    ``method``: "rk2" | "rk4" | "split_simplextic" | "adaptive_rk4".
    ``dt``: time step (the initial per-ray step when adaptive).
    ``sub_steps``: integrator steps per recorded output step
    (xrays.cpp:246-254).
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
    ``remat_policy``: with ``remat_substeps``, None recomputes the whole
    unit; "spline_jet" keeps what the unit's spline-table gathers return
    and recomputes the rest (:func:`remat_context`).
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
    remat_policy: Optional[str] = None

    def __post_init__(self):
        if self.method not in set(STEPPERS) | {"adaptive_rk4"}:
            raise ValueError(f"unknown method {self.method!r}")
        if self.sub_steps < 1:
            raise ValueError(f"sub_steps={self.sub_steps} must be >= 1")
        if self.remat_policy is not None:
            if self.remat_policy not in REMAT_POLICIES:
                raise ValueError(
                    f"remat_policy={self.remat_policy!r}: one of "
                    f"{sorted(REMAT_POLICIES)} or None")
            if not self.remat_substeps:
                raise ValueError("remat_policy needs remat_substeps=True")
        if self.compensated and self.is_adaptive():
            raise ValueError("compensated accumulation supports the "
                             "fixed-dt methods only")
        if self.compensated and self.method not in INCREMENTS:
            raise ValueError(
                f"compensated accumulation needs an increment-form "
                f"stepper; available: {sorted(INCREMENTS)}")
        if self.frozen_cells:
            if self.method not in ("rk2", "rk4"):
                raise ValueError("frozen_cells supports rk2/rk4 only")
            if not hasattr(self.eq, "freeze_cells"):
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
            kernel_dispersion_code(self.dispersion)
            if self.remat_substeps:
                raise ValueError(
                    "remat_substeps is redundant with window_kernel: the "
                    "window's backward kernel already recomputes its "
                    "substeps; set remat_substeps=False")

    # -- the integration carry ---------------------------------------------
    def is_adaptive(self):
        return self.method == "adaptive_rk4"

    def _ensure_separable(self, state: RayState) -> None:
        """Refuse to symplectic-step a system that is not separable.

        The reference asserts separability symbolically when it builds the
        solver (solver.hpp:1076-1094, "Hamiltonian is not separable."); the
        numeric check needs a sample state, so it runs once, at the first
        entry with one (``init_carry``, ``step_fn``), as in the JAX
        package."""
        if self.method != "split_simplextic" or getattr(
                self, "_separability_ok", False):
            return
        if not check_separable(make_ray_rhs(self.dispersion, self.eq),
                               state):
            raise ValueError("Hamiltonian is not separable.")
        object.__setattr__(self, "_separability_ok", True)

    def init_carry(self, state: RayState):
        """The integration carry: the RayState itself, a CompCarry when
        compensated, or an AdaptiveCarry holding the persistent per-ray
        (dt, lambda) for adaptive_rk4 (the reference's device variables,
        solver.hpp:887-903)."""
        self._ensure_separable(state)
        if self.is_adaptive():
            return init_adaptive_carry(state, self.dt)
        return init_comp_carry(state) if self.compensated else state

    @staticmethod
    def carry_state(carry) -> RayState:
        if isinstance(carry, AdaptiveCarry):
            return carry.state
        return carry.hi if isinstance(carry, CompCarry) else carry

    def carry_step_fn(self):
        """The recorded step ``carry -> carry``: sub_steps integrator
        substeps, as sub_steps // freeze_every windows when frozen.  For
        adaptive_rk4 the per-ray (dt, lambda) persist and keep adapting
        across recorded steps, as the reference's variables do
        (solver.hpp:881-1006).  Under debug mode (``utils.set_debug``,
        when this is called) the step is a checked step."""
        method, dt = self.method, self.dt
        # inside a checkpointed unit the RHS keeps only its inputs
        keep = not self.remat_substeps
        if self.is_adaptive():
            windows = self.sub_steps
            rhs = make_ray_rhs(self.dispersion, self.eq,
                               keep_local_graph=keep)

            def window(c):
                return adaptive_rk4_carry_step(self.dispersion, self.eq,
                                               rhs, c)
        elif self.frozen_cells:
            windows, k = self.sub_steps // self.freeze_every, self.freeze_every
            if self.window_kernel:
                def window(c):
                    return efit_window(self.eq, c, method=method, dt=dt,
                                       steps=k,
                                       compensated=self.compensated,
                                       dispersion=self.dispersion)
            else:
                def window(c):
                    return frozen_window(self.eq, self.dispersion, c,
                                         method=method, dt=dt, steps=k,
                                         compensated=self.compensated,
                                         keep_local_graph=keep)
        else:
            windows = self.sub_steps
            rhs = make_ray_rhs(self.dispersion, self.eq,
                               keep_local_graph=keep)
            if self.compensated:
                window = compensated_stepper(
                    lambda s: INCREMENTS[method](rhs, s, dt))
            else:
                def window(s):
                    return STEPPERS[method](rhs, s, dt)

        if self.remat_substeps:
            unit = window
            policy = REMAT_POLICIES.get(self.remat_policy)
            extra = {} if policy is None else dict(
                context_fn=lambda: remat_context(policy))

            def window(c):
                return torch.utils.checkpoint.checkpoint(
                    unit, c, use_reentrant=False, **extra)

        def step(carry):
            for _ in range(windows):
                carry = window(carry)
            return carry

        return checked_step(step, f"the recorded step of Solver("
                                  f"{self.method!r})")

    def step_fn(self):
        """The recorded step over a plain RayState.  For adaptive_rk4 the
        (dt, lambda) adaptation persists across the sub_steps substeps of
        one call but starts afresh with each call, and a compensated step
        starts with zero low words (as the JAX package's step_fn); use
        run/trace (or carry_step_fn) for persistence across steps."""
        raw = self.carry_step_fn()

        def step(state: RayState) -> RayState:
            return self.carry_state(raw(self.init_carry(state)))

        return step

    # -- drivers -----------------------------------------------------------
    def run(self, state: RayState, num_steps: int,
            return_carry: bool = False):
        """Advance num_steps recorded steps with no trajectory storage -
        the configuration of the reference's benchmark loop
        (xrays_bench.cpp:97-101).  ``return_carry`` also returns the final
        integration carry (the compensated low words, or the adaptive
        carry's persisted per-ray dt and lambda)."""
        with telemetry.span("gft.solver.run"):
            step = self.carry_step_fn()
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
        step = self.carry_step_fn()
        carry = self.init_carry(state)
        rows = [state]
        for _ in range(num_steps):
            carry = step(carry)
            rows.append(self.carry_state(carry))
        traj = RayState(*[torch.stack(leaf) for leaf in zip(*rows)])
        return self.carry_state(carry), traj

    def trace_streaming(self, state: RayState, num_steps: int,
                        writer: Callable[[int, RayState], None]):
        """One recorded row at a time: :meth:`trace_segmented` with
        ``segment=1`` (host rows).  Returns the final state."""
        return self.trace_segmented(state, num_steps, writer, segment=1)

    def trace_segmented(self, state: RayState, num_steps: int,
                        writer: Callable, segment: int = 16,
                        extras: Optional[Callable] = None):
        """Segment-buffered streaming: ``segment`` recorded rows are
        stacked on the device and copied to the host as ONE block per
        leaf; ``writer(i, row)`` then receives host (CPU) rows in order,
        row 0 the initial state.

        ``extras``: ``state -> dict of tensors``, evaluated on the device
        for every recorded row (row 0 too) and copied in the same block;
        the writer then receives ``(RayState, extras_dict)`` rows (the
        per-row residual of the reference's solver kernel,
        solver.hpp:331).

        On a CUDA device the copy is asynchronous into pinned memory and
        the next segment is queued before the previous block is handed to
        the writer, so writing overlaps compute (the reference's
        double-buffered writer thread, solver.hpp:418-424).
        """
        step = self.carry_step_fn()
        cuda = state.x.is_cuda
        names = None

        def record(s):
            nonlocal names
            if extras is None:
                return list(s)
            with telemetry.span("gft.trace.extras"):
                ex = extras(s)
            names = list(ex)
            return list(s) + [ex[k] for k in names]

        def to_host(rows):
            with telemetry.span("gft.trace.copy"):
                block = [torch.stack(leaf) for leaf in zip(*rows)]
                host = [b.to("cpu", non_blocking=cuda) for b in block]
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record()
            return host, event

        def drain(pending):
            (host, event), start = pending
            with telemetry.span("gft.trace.drain"):
                if event is not None:
                    event.synchronize()
                nf = len(RayState._fields)
                for j in range(host[0].shape[0]):
                    row = RayState(*[h[j] for h in host[:nf]])
                    if extras is not None:
                        row = (row, {k: h[j] for k, h in zip(names,
                                                             host[nf:])})
                    writer(start + j, row)

        with telemetry.span("gft.trace_segmented"):
            carry = self.init_carry(state)
            pending = (to_host([record(state)]), 0)
            i = 1
            while i <= num_steps:
                k = min(segment, num_steps - i + 1)
                rows = []
                for _ in range(k):
                    carry = step(carry)
                    rows.append(record(self.carry_state(carry)))
                nxt = (to_host(rows), i)
                drain(pending)
                pending = nxt
                i += k
            drain(pending)
        return self.carry_state(carry)
