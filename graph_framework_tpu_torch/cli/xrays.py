"""xrays: RF ray tracing (the three-phase pipeline).

Counterpart of ``graph_framework_tpu.cli.xrays`` (reference:
xrays.cpp): trace rays (phase 1), compute the complex
absorption amplitude kamp over the saved trajectory (phase 2), bin the
absorbed power along each ray (phase 3).  The phases talk through the
result file, as the reference's do (xrays.cpp:1083-1111), so the file is
a checkpoint between them.

The option names are the reference's (xrays.cpp:808-880), as in the JAX
package:
 * init_<var>_mean/sigma/dist: per-ray initial sampling (uniform = every
   ray at the mean; normal = a gaussian spread; xrays.cpp:56-97);
 * use_cyl_xy: init_x is a radius and init_y an angle (xrays.cpp:76-136);
 * the first k component given by an init_k*_mean with a uniform
   distribution is Newton-solved, which puts every ray on the dispersion
   surface (xrays.cpp:192-204);
 * the step is dt = endtime/num_times, and a row is written every
   sub_steps integrator steps (xrays.cpp:240-254).

``--device`` (default ``cuda``) picks the torch device: the card unless
``--device=cpu`` is given; there is no fallback to the CPU.  On the card,
an EFIT run with no stack options takes the production stack, for every
dispersion of ``--dispersion`` (:func:`resolve_stack`).
``--window_kernel`` runs each freeze window as one launch of the CUDA
window kernel (the JAX package's ``--pallas_window``).  ``--debug`` turns
on debug mode (``utils.set_debug``) for the run: the first NaN or inf of a
recorded step or a kernel launch raises a located error (the JAX CLI's
checkify float checks).  ``--print_expressions`` prints, where the JAX CLI
prints the jaxpr of the ray RHS, the autograd graphs of D and of the six
RHS components on the first ray (:func:`expression_graph`), and on the
production stack the kernel unit each window launches.  Not carried over:
``--pallas_block_rows`` and the ray padding (the kernel masks a ragged
block).

The phase timers are spans (``telemetry``): ``gft.xrays.setup``,
``.init_k``, ``.compile``, ``.trace``, ``.absorption`` and ``.bin_power``
give ``setup_s``, ``init_s``, ``compile_s``, ``trace_s``, ``absorption_s``
and ``bin_power_s``; ``main``'s ``gft.xrays.equilibrium`` the rest of
``setup_s``.  ``--timing_json`` also keeps every span of the run and
writes their aggregate under ``"spans"``.

Usage:  python -m graph_framework_tpu_torch.cli.xrays \\
            --dispersion=cold_plasma --equilibrium=efit \\
            --equilibrium_file=efit.nc --num_rays=1000 ...
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from graph_framework_tpu_torch import telemetry

#: The dispersions of the option ``--dispersion`` (the JAX CLI's).
DISPERSION_CHOICES = ["simple", "bohm_gross", "ordinary_wave",
                      "extra_ordinary_wave", "cold_plasma",
                      "cold_plasma_expansion", "light_wave",
                      "acoustic_wave", "ion_cyclotron", "gaussian_well",
                      "stiff"]

#: The variables phase 1 writes.
TRACE_NAMES = ("time", "residual", "w", "x", "y", "z", "kx", "ky", "kz")


def build_parser():
    p = argparse.ArgumentParser(
        prog="xrays", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dispersion", default="simple",
                   choices=DISPERSION_CHOICES)
    p.add_argument("--solver", default=None,
                   choices=["rk2", "rk4", "split_simplextic",
                            "adaptive_rk4"],
                   help="integrator (default rk4, the reference's; on the "
                        "card an EFIT run takes the production stack "
                        "instead, see --portable)")
    p.add_argument("--portable", action="store_true",
                   help="force the reference-parity defaults (plain rk4, "
                        "f64, no frozen cells, compensation or window "
                        "kernel) on the card too.  Without it, an EFIT "
                        "run on the card with a dispersion the window "
                        "kernel implements and no stack options takes the "
                        "production stack: frozen rk2, a freeze window of "
                        "10 substeps (or the largest of 5, 2, 1 dividing "
                        "sub_steps), compensated f32 and the window "
                        "kernel")
    p.add_argument("--equilibrium", default="slab",
                   choices=["no_magnetic_field", "slab", "slab_density",
                            "slab_field", "gaussian_density", "efit",
                            "vmec"])
    p.add_argument("--equilibrium_file", default=None)
    p.add_argument("--num_rays", type=int, default=1000)
    p.add_argument("--num_times", type=int, default=1000)
    p.add_argument("--sub_steps", type=int, default=10)
    p.add_argument("--endtime", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=12345)
    for var in ("w", "x", "y", "z", "kx", "ky", "kz"):
        p.add_argument(f"--init_{var}_mean", type=float, default=None)
        p.add_argument(f"--init_{var}_sigma", type=float, default=0.0)
        p.add_argument(f"--init_{var}_dist", default="uniform",
                       choices=["uniform", "normal"])
    p.add_argument("--use_cyl_xy", action="store_true")
    p.add_argument("--print", dest="print_ray", action="store_true",
                   help="print a sampled ray each recorded step")
    p.add_argument("--print_expressions", action="store_true",
                   help="print the autograd graphs of D and the ray RHS "
                        "(and the kernel unit the windows launch)")
    p.add_argument("--absorption_model", default=None,
                   choices=["weak_damping", "root_find"])
    p.add_argument("--output", default="result0.nc")
    p.add_argument("--x64", action="store_true", default=None,
                   help="force f64 (the reference's default dtype; "
                        "resolved when omitted: f64, or compensated f32 "
                        "under the production stack)")
    p.add_argument("--f32", dest="x64", action="store_false")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="debug mode: the first NaN/inf of a recorded step "
                        "or a kernel launch raises a located error (the "
                        "sanitizer-build equivalent, CMakeLists.txt:"
                        "104-130)")
    p.add_argument("--vmec_fused", action="store_true",
                   help="VMEC geometry through the fused kernel K4 "
                        "(kernels/vmec_geom.py)")
    p.add_argument("--compensated", action="store_true",
                   help="double-word (hi, lo) state accumulation "
                        "(ops/compensated.py); rk2/rk4 only")
    p.add_argument("--freeze_every", type=int, default=1,
                   help="with --frozen_cells: gather the spline blocks "
                        "every N substeps (N divides sub_steps)")
    p.add_argument("--frozen_cells", action="store_true",
                   help="frozen-cell stepping: one spline-block gather a "
                        "freeze window serves every RK stage (spline "
                        "equilibria, rk2/rk4)")
    p.add_argument("--stream_segment", type=int, default=16,
                   help="copy N recorded rows to the host as one block "
                        "(Solver.trace_segmented); 1 = one row at a time")
    p.add_argument("--window_kernel", action="store_true",
                   help="with --frozen_cells over EFIT: run each freeze "
                        "window as one launch of the CUDA window kernel "
                        "(its plain version on the CPU)")
    p.add_argument("--timing_json", default=None,
                   help="write the phases' wall-clock seconds (setup, "
                        "init, warm-up step, trace, absorption, binning) "
                        "to this file as one JSON object, with the run's "
                        "spans (count, total and self seconds by name) "
                        "under \"spans\"")
    p.add_argument("--device", default="cuda",
                   help="torch device (default the card, cuda)")
    return p


def resolve_stack(args, device):
    """The integrator stack ``args`` asks for on ``device``, resolved: a
    copy of ``args`` with solver, frozen_cells, freeze_every, compensated,
    window_kernel and x64 set.

    The production stack - frozen rk2, freeze_every the largest of (10, 5,
    2, 1) dividing sub_steps, compensated, the window kernel, f32 - is
    taken on a CUDA device over EFIT when no integrator or stack option
    was given and the dispersion is one the window kernel implements
    (``kernels.efit_step.KERNEL_DISPERSIONS``: every dispersion of
    DISPERSION_CHOICES).  Otherwise the reference's defaults hold: rk4 in
    f64.  An explicit ``--window_kernel`` with a dispersion the kernel
    does not implement (a hot plasma) raises ValueError, on every
    device."""
    from graph_framework_tpu_torch.kernels.efit_step import (
        KERNEL_DISPERSIONS, kernel_dispersion_code)
    from graph_framework_tpu_torch.models.dispersion import DISPERSIONS

    out = copy.copy(args)
    dispersion = DISPERSIONS[args.dispersion]
    explicit = (args.frozen_cells or args.compensated or args.window_kernel
                or args.freeze_every != 1)
    candidate = (args.solver is None and not args.portable
                 and torch.device(device).type == "cuda"
                 and args.equilibrium == "efit" and not explicit)
    production = candidate and dispersion in KERNEL_DISPERSIONS
    if candidate and not production and args.verbose:
        print(f"reference-parity stack (rk4, f64): the window kernel does "
              f"not implement {args.dispersion}", file=sys.stderr)
    if out.solver is None:
        out.solver = "rk2" if production else "rk4"
    if production:
        out.frozen_cells = out.compensated = out.window_kernel = True
        out.freeze_every = next(k for k in (10, 5, 2, 1)
                                if args.sub_steps % k == 0)
        if out.x64 is None:
            out.x64 = False
        if args.verbose:
            print(f"production stack: frozen rk2 freeze_every="
                  f"{out.freeze_every} compensated window_kernel f32 (use "
                  f"--portable for plain rk4)", file=sys.stderr)
    if out.x64 is None:
        out.x64 = True
    if out.window_kernel:
        kernel_dispersion_code(dispersion)
    return out


def sample_initial(args, rng, num_rays, var, default=0.0):
    """set_variable (xrays.cpp:56-74)."""
    mean = getattr(args, f"init_{var}_mean")
    if mean is None:
        mean = default
    if getattr(args, f"init_{var}_dist") == "normal":
        return rng.normal(mean, getattr(args, f"init_{var}_sigma"),
                          num_rays)
    return np.full(num_rays, mean)


def make_equilibrium(args, dtype, device):
    """The equilibrium of ``--equilibrium`` (EFIT and VMEC from
    ``--equilibrium_file``, which needs h5py) on ``device``."""
    from graph_framework_tpu_torch.models import equilibrium as analytic
    from graph_framework_tpu_torch.models.efit import make_efit
    from graph_framework_tpu_torch.models.vmec import make_vmec

    name = args.equilibrium
    if name == "efit":
        return make_efit(args.equilibrium_file, dtype=dtype, device=device)
    if name == "vmec":
        return make_vmec(args.equilibrium_file, dtype=dtype, device=device,
                         fused_mode_sums=args.vmec_fused)
    return getattr(analytic, f"make_{name}")()


class XraysRun(NamedTuple):
    """What :func:`run_xrays` did: the phases' timings (the
    ``--timing_json`` object), the launch state after the Newton init,
    and the Solver of phase 1."""
    timings: dict
    initial: object
    solver: object


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_xrays(args, eq, open_store: Callable, *, setup_s=0.0) -> XraysRun:
    """The three phases over ``eq``, for ``args`` resolved by
    :func:`resolve_stack`.

    ``open_store(path, mode, num_rays=None)`` opens the result store at
    ``args.output``: mode "w" creates it for ``num_rays`` rays (phase 1),
    "r+" reopens it (phases 2 and 3).  ``main`` passes
    ``cli.open_result_file``; any store with ``ResultFile``'s methods will
    do.  ``setup_s``: seconds already spent on the
    set-up (building ``eq``), added to the timing ``setup_s``.
    ``args.debug`` turns debug mode on for the run (and restores it
    after).  With ``args.timing_json`` the run keeps its spans
    (``telemetry.enable``) and adds their aggregate to the timings as
    ``"spans"``: name -> count, total and self seconds."""
    from graph_framework_tpu_torch import utils

    keep = bool(getattr(args, "timing_json", None))
    kept = telemetry.enable(True) if keep else None
    since = telemetry.snapshot()
    previous = utils.debug_enabled()
    utils.set_debug(previous or getattr(args, "debug", False))
    try:
        with torch.no_grad():
            run = _run(args, eq, open_store, setup_s)
    finally:
        utils.set_debug(previous)
        if keep:
            telemetry.enable(kept)
    if keep:
        run.timings["spans"] = telemetry.summary(since)
    return run


def expression_graph(dispersion, eq, state) -> str:
    """The autograd graphs of D and of the ray RHS at the first ray of
    ``state``, as text: one line a node, ``n<id> = <node>(<inputs>)``,
    shared nodes once, the leaves by name (what ``--print_expressions``
    prints in place of the JAX CLI's jaxpr)."""
    from graph_framework_tpu_torch.models.rays import dispersion_residual
    from graph_framework_tpu_torch.ops.special import holomorphic_grad

    one = [leaf[:1].detach().clone() for leaf in state]
    names = ("w", "x", "y", "z", "kx", "ky", "kz")
    leaves = [a.requires_grad_(True) for a in one[1:]]
    with torch.enable_grad():
        d = dispersion_residual(dispersion, eq)(one[0], *leaves)
        grads = holomorphic_grad(d, leaves, create_graph=True,
                                 allow_unused=True)
        dw, dx, dy, dz, dkx, dky, dkz = [
            torch.zeros_like(a) if g is None else g
            for a, g in zip(leaves, grads)]
        rhs = {"D": d, "dx/dt": -dkx / dw, "dy/dt": -dky / dw,
               "dz/dt": -dkz / dw, "dkx/dt": dx / dw, "dky/dt": dy / dw,
               "dkz/dt": dz / dw}
    ids, lines = {}, []
    leaf_names = {id(a): n for a, n in zip(leaves, names)}

    def name_of(fn):
        if fn is None:
            return "const"
        var = getattr(fn, "variable", None)
        if var is not None:
            return leaf_names.get(id(var), "table")
        if fn not in ids:
            args = [name_of(nxt) for nxt, _ in fn.next_functions]
            ids[fn] = f"n{len(ids)}"
            lines.append(f"  {ids[fn]} = {fn.name()}({', '.join(args)})")
        return ids[fn]

    outs = [f"  {label} = {name_of(t.grad_fn)}" for label, t in rhs.items()]
    return "\n".join(["autograd graph of D and the ray RHS (first ray):",
                      *lines, *outs])


def _run(args, eq, open_store, setup_s):
    from graph_framework_tpu_torch.io.output import AsyncWriter, state_row
    from graph_framework_tpu_torch.models.dispersion import DISPERSIONS
    from graph_framework_tpu_torch.models.rays import RayState, residual_fn
    from graph_framework_tpu_torch.solver import Solver, init_k

    device = torch.device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    rng = np.random.default_rng(args.seed)
    n = args.num_rays
    timings = {}

    # initial conditions (xrays.cpp:56-136)
    with telemetry.Span("gft.xrays.setup") as span:
        vals = {v: sample_initial(args, rng, n, v)
                for v in ("w", "x", "y", "z", "kx", "ky", "kz")}
        if args.use_cyl_xy:
            radius = sample_initial(args, rng, n, "x")
            phi = sample_initial(args, rng, n, "y")
            vals["x"] = radius * np.cos(phi)
            vals["y"] = radius * np.sin(phi)
        state = RayState(
            t=torch.zeros(n, dtype=dtype, device=device),
            **{k: torch.as_tensor(v, dtype=dtype, device=device)
               for k, v in vals.items()})
        dfun = DISPERSIONS[args.dispersion]
    timings["setup_s"] = setup_s + span.seconds

    # Newton init of the first k component given as a bare mean
    # (xrays.cpp:192-204)
    for which in ("kx", "ky", "kz"):
        if (getattr(args, f"init_{which}_mean") is not None
                and getattr(args, f"init_{which}_dist") == "uniform"):
            with telemetry.Span("gft.xrays.init_k") as span:
                state = init_k(state, dfun, eq, which)
                _sync(device)
            timings["init_s"] = span.seconds
            if args.verbose:
                print(f"init {which}: {timings['init_s']:.3f} s",
                      file=sys.stderr)
            break

    dt = args.endtime / args.num_times
    num_steps = args.num_times // args.sub_steps
    sol = Solver(dfun, eq, method=args.solver, dt=dt,
                 sub_steps=args.sub_steps, compensated=args.compensated,
                 frozen_cells=args.frozen_cells,
                 freeze_every=args.freeze_every,
                 window_kernel=args.window_kernel)
    res = residual_fn(dfun, eq)
    if args.print_expressions:
        print(expression_graph(dfun, eq, state))
        if args.window_kernel:
            from graph_framework_tpu_torch.kernels.efit_step import (
                KERNEL_TAILS, kernel_dispersion_code)
            tag = KERNEL_TAILS[kernel_dispersion_code(dfun)].tag
            unit = f"efit_window{'_' + tag if tag else ''}.cu"
            print(f"kernel unit of each freeze window: "
                  f"graph_framework_tpu_torch/csrc/{unit} (K1, "
                  f"gft_efit_window: {args.solver}, "
                  f"{args.sub_steps // args.freeze_every} windows of "
                  f"{args.freeze_every} substeps a recorded step, "
                  f"{'compensated ' if args.compensated else ''}"
                  f"{'f64' if args.x64 else 'f32'})")
    sample = int(rng.integers(0, n))

    def show(i, s):
        if args.print_ray:
            print(f"step {i}: t={float(s.t[sample]):.6g} "
                  f"x={float(s.x[sample]):.6g} y={float(s.y[sample]):.6g} "
                  f"z={float(s.z[sample]):.6g}")

    with open_store(args.output, "w", num_rays=n) as f:
        for name in TRACE_NAMES:
            f.create_variable(name)
        writer = AsyncWriter(f)

        def write(i, row):                # host rows and their residual
            s, ex = row
            writer.write_step(i, state_row(s, residual=ex["residual"]))
            show(i, s)

        seg = max(1, min(args.stream_segment, num_steps))

        # one recorded step and the residual, apart from the trace: the
        # reference's compile-vs-steps timers (xrays_bench.cpp:41-44);
        # here it holds the kernels' first-use build
        with telemetry.Span("gft.xrays.compile") as span:
            warm = (sol.carry_step_fn()(sol.init_carry(state)), res(state))
            _sync(device)
            del warm
        timings["compile_s"] = span.seconds

        with telemetry.Span("gft.xrays.trace") as span:
            sol.trace_segmented(state, num_steps, write, segment=seg,
                                extras=lambda s: {"residual": res(s)})
            writer.close()
        el = span.seconds
        timings["trace_s"] = el
        timings["trace_ray_steps_per_s"] = n * num_steps * args.sub_steps / el
        if args.verbose:
            print(f"trace: {el:.3f} s = "
                  f"{timings['trace_ray_steps_per_s']:.6g} ray-steps/s",
                  file=sys.stderr)

    # phases 2 and 3: absorption and power binning (xrays.cpp:598-793)
    if args.absorption_model:
        from graph_framework_tpu_torch.models.absorption import (
            bin_power, run_absorption)
        method = ("weak_damping" if args.absorption_model == "weak_damping"
                  else "root_finder")
        with telemetry.Span("gft.xrays.absorption") as absorbing, \
                open_store(args.output, "r+") as f:
            # the kamp rows go through a writer thread, so each row's
            # write overlaps the next row's evaluation (absorption.hpp:
            # 465-483)
            run_absorption(f, eq, method=method, device=device,
                           writer=AsyncWriter(f))
            absorbing.stop()
            timings["absorption_s"] = absorbing.seconds
            with telemetry.Span("gft.xrays.bin_power") as span:
                nt = f.num_steps
                rows = [f.read_step(i, ["x", "y", "z"]) for i in range(nt)]
                kamp = np.stack([f.read_step(i, ["kamp"],
                                             complex_valued=True)["kamp"]
                                 for i in range(nt)])
                xyz = [torch.as_tensor(np.stack([r[c] for r in rows]),
                                       device=device)
                       for c in ("x", "y", "z")]
                power, d_power = bin_power(
                    *xyz, torch.as_tensor(kamp.imag, device=device))
                power, d_power = power.cpu(), d_power.cpu()
                f.create_variable("power")
                f.create_variable("d_power")
                pw = AsyncWriter(f)
                for i in range(nt):
                    pw.write_step(i, {"power": power[i],
                                      "d_power": d_power[i]})
                pw.close()
            timings["bin_power_s"] = span.seconds
        if args.verbose:
            print(f"power: min {float(power.min()):.6g}", file=sys.stderr)

    timings.update(num_rays=n, num_times=args.num_times,
                   sub_steps=args.sub_steps, solver=args.solver,
                   dispersion=args.dispersion,
                   equilibrium=args.equilibrium,
                   absorption_model=args.absorption_model,
                   backend=str(device))
    return XraysRun(timings, state, sol)


def main(argv=None):
    args = build_parser().parse_args(argv)
    args = resolve_stack(args, args.device)
    from graph_framework_tpu_torch.cli import open_result_file

    with telemetry.Span("gft.xrays.equilibrium") as span:
        eq = make_equilibrium(args,
                              torch.float64 if args.x64 else torch.float32,
                              torch.device(args.device))

    run = run_xrays(args, eq, open_result_file, setup_s=span.seconds)
    if args.timing_json:
        with open(args.timing_json, "w") as fh:
            json.dump(run.timings, fh)
    return run


if __name__ == "__main__":
    main()
