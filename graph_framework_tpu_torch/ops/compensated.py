"""Compensated (double-word) state accumulation.

Counterpart of ``graph_framework_tpu.ops.compensated``.  The ray state is
carried as (hi, lo) pairs and each integrator increment is folded in with
an exact TwoSum (Knuth 1969; branch-free, add/subtract only), while the
right-hand side runs in the working precision on the hi words.  The
per-substep update ``x <- x + dt k`` then no longer rounds against the
large state magnitude, which is the dominant trajectory error of an f32
trace; what remains is the right-hand side's own rounding noise.

The increment MUST come unfolded from the integrator (ops.integrators
INCREMENTS): ``step(hi) - hi`` recovers the already-rounded increment and
makes the compensation a no-op.

The CUDA window kernel (csrc/efit_window.cuh ``two_sum``) folds with the
same TwoSum.  Forward tracing only.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from graph_framework_tpu_torch.models.rays import RayState


class CompCarry(NamedTuple):
    """Double-word ray state: value = hi + lo (|lo| <= ulp(hi)/2)."""
    hi: RayState
    lo: RayState


def _two_sum(a, b):
    """Error-free transform: a + b = s + e exactly (no magnitude ordering
    assumed)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def init_comp_carry(state: RayState) -> CompCarry:
    return CompCarry(state, RayState(*[torch.zeros_like(a) for a in state]))


def comp_state(carry: CompCarry) -> RayState:
    """The plain state: hi is already the correctly rounded sum."""
    return carry.hi


def comp_state_f64(carry: CompCarry) -> RayState:
    """Promote to f64 with the low words re-added - the full-precision
    view for accuracy comparisons."""
    return RayState(*[h.double() + l.double()
                      for h, l in zip(carry.hi, carry.lo)])


def compensated_stepper(increment_fn: Callable) -> Callable:
    """Wrap an increment-form stepper ``state -> delta`` into a carry
    stepper ``CompCarry -> CompCarry`` that folds (delta + lo) into hi
    with TwoSum."""

    def step(carry: CompCarry) -> CompCarry:
        hi, lo = carry
        delta = increment_fn(hi)
        pairs = [_two_sum(h, d + l) for h, d, l in zip(hi, delta, lo)]
        return CompCarry(RayState(*[s for s, _ in pairs]),
                         RayState(*[e for _, e in pairs]))

    return step
