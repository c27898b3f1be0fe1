"""Power absorption along traced rays: the complex kamp update and binning.

Counterpart of ``graph_framework_tpu.models.absorption`` (reference:
absorption.hpp:111-487, xrays.cpp:598-793).  The reference
re-opens the trace's result file and, for every saved row, loads the
eight state arrays, runs a complex kernel that updates the wave amplitude
kamp, and writes it back; power binning then accumulates Im(kamp) dl
along each trajectory.

The kamp physics is complex (the hot-plasma Z function), and torch has
complex dtypes on the card, so only the native complex path is here: the
JAX package's split (re, im) forms for backends without complex dtypes
(``make_weak_damping_split``, ``hot_plasma_split``,
``make_root_finder_split``) have no counterpart.  Where the JAX package
differentiates the split weak damping of a real trace (its absorbed-power
loss), :func:`make_weak_damping_real` takes the real state with a complex
Z and is differentiable in the state and the tables.  The JAX package
evaluates one ray at a time under ``vmap``; here the rays are one batch
with the component axis leading, as in the rest of the port: positions
and wave vectors are (3, n), the contravariant basis (3, 3, n).
:func:`run_absorption`'s spans (``telemetry``), a row each:
``gft.absorption.read_row`` (the store's read and the copy to the
device), ``gft.absorption.update`` and ``gft.absorption.write_row``; the
weak damping's stages, each call: ``gft.weak_damping.dc`` (the geometry
and Dc), ``gft.weak_damping.dc_grad`` (dDc/dk) and ``gft.weak_damping.dw``
(Dw and kamp).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from graph_framework_tpu_torch import telemetry
from graph_framework_tpu_torch.models import dispersion as disp
from graph_framework_tpu_torch.models.rays import (
    RayState, LocalGraph, grad_tensors, rebind)
from graph_framework_tpu_torch.ops.newton import newton_solve
from graph_framework_tpu_torch.ops.special import holomorphic_grad, z_plasma

#: The result file's names of a ray state's leaves, in RayState order.
STATE_NAMES = ("time", "w", "x", "y", "z", "kx", "ky", "kz")


def _geometry(eq, state: RayState):
    """(pos, kcov, esup, kvec) of a batched state: esup (3 basis, 3
    components, n) in the state's dtype, kvec_j = sum_i kcov_i esup_ij."""
    pos = torch.stack([state.x, state.y, state.z])
    kcov = torch.stack([state.kx, state.ky, state.kz])
    esup = eq.esup(pos).to(kcov.dtype)
    if esup.dim() == 2:                      # one basis for every ray
        esup = esup[..., None].expand(3, 3, kcov.shape[1])
    kvec = torch.einsum("in,ijn->jn", kcov, esup)
    return pos, kcov, esup, kvec


def _weak_damping_kamp(eq, dw_fn, state: RayState, create_graph: bool):
    """kamp = |k| - Dw / (khat . dDc/dk) of a batched state (complex, or
    real with a complex Dw).  ``create_graph``: take dDc/dk against the
    state's own wave vector, differentiably (the state's leaves must
    require grad); otherwise against a detached copy."""
    t, w = state.t, state.w
    with telemetry.span("gft.weak_damping.dc"):
        pos, kcov, esup, kvec = _geometry(eq, state)
        klen = torch.sqrt((kvec * kvec).sum(dim=0))
        k_unit = kvec / klen
        with torch.enable_grad():
            kc = kcov if create_graph else kcov.detach().requires_grad_(True)
            dc = disp.cold_plasma_expansion(
                w, torch.einsum("in,ijn->jn", kc, esup), pos, t, eq)
    with telemetry.span("gft.weak_damping.dc_grad"):
        with torch.enable_grad():
            (ddc_dkcov,) = holomorphic_grad(dc, (kc,),
                                            create_graph=create_graph)
        # dDc/dk as a physical vector: sum_i dDc/dk_i e^i
        ddc_vec = torch.einsum("in,ijn->jn", ddc_dkcov, esup)
    with telemetry.span("gft.weak_damping.dw"):
        dw = dw_fn(w, kvec, pos, t, eq)
        return klen - dw / (k_unit * ddc_vec).sum(dim=0)


def make_weak_damping(eq, z_function=None):
    """Analytic weak-damping kamp update (absorption.hpp:328-432):

        kamp <- |k| - Dw / (khat . dDc/dk)

    with Dc the cold-plasma expansion and Dw the hot-plasma expansion,
    dDc/dk taken in covariant components and mapped through the
    contravariant basis (absorption.hpp:408-412).  Returns
    ``update(state) -> kamp`` over a complex RayState.

    ``z_function``: Z of the expansion, ``z_plasma`` by default - the
    reference's z_erfi analytically, without its exp(-zeta^2) erfi
    overflow at large zeta (what the reference's SAFE_MATH scrub covers,
    cuda_context.hpp:883-899).
    """
    dw_fn = disp.make_hot_plasma_expansion(z_function or z_plasma)

    def update(state: RayState):
        return _weak_damping_kamp(eq, dw_fn, state, False)

    return update


def make_weak_damping_real(eq, z_function=None):
    """The weak-damping kamp of a **real** ray state, differentiable in the
    state and in the tensors of ``eq`` that require grad - what the JAX
    package's ``make_weak_damping_split`` gives its absorbed-power loss
    (bench.py run_config5, tests/test_config5.py).

    For a real state only Z(zeta) is complex: ``update(state) -> kamp``
    returns it in the complex dtype of the state's precision (complex64
    for float32), with Im(kamp) the damping.  Under grad mode, when a leaf
    or a table requires grad, the update is one ``rays.LocalGraph`` node,
    which keeps only the state and the tables (each recorded step's kamp
    graph, second derivatives included, holds dozens of complex ray-sized
    tensors); its backward takes dDc/dk with ``create_graph=True`` against
    the state's own wave vector, so the gradient of kamp reaches the ray
    state and the tables through dDc/dk too.  Otherwise it evaluates as
    :func:`make_weak_damping` does."""
    dw_fn = disp.make_hot_plasma_expansion(z_function or z_plasma)
    closure = grad_tensors(eq)

    def kamp_of(*leaves, create_graph):
        fresh_eq = rebind(eq, closure, leaves[8:])
        return _weak_damping_kamp(fresh_eq, dw_fn, RayState(*leaves[:8]),
                                  create_graph)

    def update(state: RayState):
        if state.x.is_complex():
            raise TypeError("make_weak_damping_real takes a real ray "
                            "state (make_weak_damping takes a complex one)")
        if torch.is_grad_enabled() and (closure or any(
                a.requires_grad for a in state)):
            return LocalGraph.apply(kamp_of, False, *state, *closure)
        return _weak_damping_kamp(eq, dw_fn, RayState(
            *[a.detach() for a in state]), False)

    return update


def make_root_finder(eq, z_function=None, *, tolerance=1.0e-30,
                     max_iterations=1000, return_diagnostics=False):
    """Newton root-find of the full hot-plasma D for the complex amplitude
    correction (absorption.hpp:145-317):

        kamp := 0;  solve D_hot(k + kamp khat) = 0 for kamp;
        kamp <- |k| + kamp,

    with the converge_item loop of ``ops.newton`` (one readback an
    iteration).  Returns ``update(state) -> kamp``; with
    ``return_diagnostics``, ``update(state) -> (kamp, NewtonDiagnostics)``.
    """
    d_hot = disp.make_hot_plasma(z_function or z_plasma)

    def update(state: RayState):
        pos, _, _, kvec = _geometry(eq, state)
        klen = torch.sqrt((kvec * kvec).sum(dim=0))
        k_unit = kvec / klen

        def f(kamp):
            return d_hot(state.w, kvec + kamp * k_unit, pos, state.t, eq)

        kamp, _, diag = newton_solve(
            f, torch.zeros_like(state.w), tolerance=tolerance,
            max_iterations=max_iterations)
        out = klen + kamp
        return (out, diag) if return_diagnostics else out

    return update


def run_absorption(file, eq, method="weak_damping", *,
                   dtype=torch.complex128, device="cuda", writer=None,
                   update_fn: Optional[Callable] = None,
                   safe_math: bool = True):
    """Drive a kamp update over every row of a trace result file (the
    reference's per-time-index read/run/write loop, absorption.hpp:465-483,
    xrays.cpp:551-585), appending the complex variable "kamp".

    ``file``: a ``ResultFile`` (or a store with its methods); ``method``:
    "weak_damping" or "root_finder"; ``update_fn`` replaces the update.
    Rows are evaluated on ``device`` (the card unless the caller names
    another) in ``dtype``; ``writer`` (an ``AsyncWriter``) takes the kamp
    rows instead of ``file`` and is closed at the end.  ``safe_math``:
    scrub non-finite kamp to 0, as the reference's SAFE_MATH stores do
    (cuda_context.hpp:883-899).
    """
    update = update_fn or (make_weak_damping(eq) if method == "weak_damping"
                           else make_root_finder(eq))
    file.create_variable("kamp", complex_valued=True)
    try:
        _run_absorption_loop(file, update, dtype, device, safe_math, writer)
    finally:
        if writer is not None:
            writer.close()


def _run_absorption_loop(file, update, dtype, device, safe_math, writer):
    target = writer or file
    for i in range(file.num_steps):
        with telemetry.span("gft.absorption.read_row"):
            row = file.read_step(i, list(STATE_NAMES))
            state = RayState(*[torch.as_tensor(np.asarray(row[name]),
                                               dtype=dtype, device=device)
                               for name in STATE_NAMES])
        with telemetry.span("gft.absorption.update"):
            kamp = update(state)
            if safe_math:
                finite = (torch.isfinite(kamp.real)
                          & torch.isfinite(kamp.imag))
                kamp = torch.where(finite, kamp, torch.zeros_like(kamp))
        with telemetry.span("gft.absorption.write_row"):
            target.write_step(i, {"kamp": kamp})


def bin_power(x, y, z, kamp_imag):
    """Accumulate absorbed power along trajectories (xrays.cpp:673-793).

    Inputs are (num_steps + 1, num_rays) trajectory tensors, ``kamp_imag``
    Im(kamp).  Returns (power, d_power) of the same shape:

        dl_j      = |pos_j - pos_(j-1)|
        kdl_j     = Im(kamp_j) dl_j
        power_j   = exp(-2 sum_(i<j) kdl_i)       (power_0 = power_1 = 1)
        d_power_j = |power_j - power_(j-1)|

    the reference's running k_sum kernel, with p_next computed from the
    k_sum before its update (xrays.cpp:718-724).
    """
    pos = torch.stack([x, y, z], dim=-1)
    dl = torch.linalg.vector_norm(torch.diff(pos, dim=0), dim=-1)
    kdl = kamp_imag[1:] * dl
    ksum_before = torch.cat([torch.zeros_like(kdl[:1]),
                             torch.cumsum(kdl, dim=0)[:-1]])
    power_tail = torch.exp(-2.0 * ksum_before)
    power = torch.cat([torch.ones_like(power_tail[:1]), power_tail])
    d_power = torch.cat([torch.zeros_like(power[:1]),
                         torch.diff(power, dim=0).abs()])
    return power, d_power
