"""xrays_bench: the fixed benchmark (graph_benchmark/xrays_bench.cpp).

Counterpart of ``graph_framework_tpu.cli.xrays_bench``: 100k rays x 1000
steps (sub_steps=10), rk4 + cold plasma + EFIT, with the reference's
setup/init/compile/steps timers, run for each requested dtype (float,
double, complex_float, complex_double).  Here "compile" is the first
recorded step, which holds the first-use costs.  ``--device`` picks the
torch device (the card by default).  The timers are the spans
``gft.xrays_bench.setup``, ``.init_k``, ``.compile`` and ``.steps``
(``telemetry``).
"""

from __future__ import annotations

import argparse

import torch

from graph_framework_tpu_torch import telemetry

DTYPES = {"float": torch.float32, "double": torch.float64,
          "complex_float": torch.complex64,
          "complex_double": torch.complex128}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_one(dtype_name, efit_file, num_rays, num_times, sub_steps, *,
              eq=None, device="cuda"):
    """Time one dtype: setup (the equilibrium, unless ``eq`` is given
    already built, and the launch), the Newton init, the first recorded
    step and the remaining steps.  Prints the reference's lines and
    returns ``{"setup_s", "init_s", "compile_s", "steps_s",
    "ray_steps_per_s", "final"}``."""
    from graph_framework_tpu_torch.models import dispersion as disp
    from graph_framework_tpu_torch.models.efit import make_efit
    from graph_framework_tpu_torch.solver import (
        Solver, init_k, make_ray_state)

    dtype = DTYPES[dtype_name]
    print(f"{dtype_name} ".ljust(80, "-"))
    with torch.no_grad():
        with telemetry.Span("gft.xrays_bench.setup") as span:
            if eq is None:
                eq = make_efit(efit_file, device=device, dtype=(
                    torch.float64
                    if dtype_name in ("double", "complex_double")
                    else torch.float32))
            # xrays_bench.cpp:63-72's launch with ky = 150: the
            # reference's ky = kz = 0 launch sits where the two branches
            # meet
            state = make_ray_state(num_rays, w=500.0, x=2.5, y=0.0, z=0.0,
                                   kx=-600.0, ky=150.0, kz=0.0, dtype=dtype,
                                   device=device)
            num_steps = num_times // sub_steps
            sol = Solver(disp.cold_plasma, eq, method="rk4",
                         dt=1.0 / num_times, sub_steps=sub_steps)
        out = {"setup_s": span.seconds}
        print(f"Setup Time {out['setup_s']:.3f}s")

        with telemetry.Span("gft.xrays_bench.init_k") as span:
            state = init_k(state, disp.cold_plasma, eq, "kx",
                           tolerance=1e-10, max_iterations=200)
            _sync(device)
        out["init_s"] = span.seconds
        print(f"Init Time {out['init_s']:.3f}s")

        step = sol.step_fn()
        with telemetry.Span("gft.xrays_bench.compile") as span:
            state = step(state)
            _sync(device)
        out["compile_s"] = span.seconds
        print(f"Compile(+1st step) Time {out['compile_s']:.3f}s")

        with telemetry.Span("gft.xrays_bench.steps") as span:
            for _ in range(num_steps - 1):
                state = step(state)
            _sync(device)
        el = span.seconds
    out["steps_s"] = el
    out["ray_steps_per_s"] = num_rays * (num_steps - 1) * sub_steps / el
    out["final"] = state
    print(f"Time Steps {el:.3f}s ({out['ray_steps_per_s']:.4g} "
          f"ray-steps/s)")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="xrays_bench", description=__doc__)
    p.add_argument("--equilibrium_file", required=True)
    p.add_argument("--num_rays", type=int, default=100_000)
    p.add_argument("--num_times", type=int, default=1000)
    p.add_argument("--sub_steps", type=int, default=10)
    p.add_argument("--dtypes", default="float",
                   help="comma list: float,double,complex_float,"
                        "complex_double")
    p.add_argument("--device", default="cuda",
                   help="torch device (default the card, cuda)")
    args = p.parse_args(argv)
    return {name.strip(): bench_one(
        name.strip(), args.equilibrium_file, args.num_rays, args.num_times,
        args.sub_steps, device=args.device)
        for name in args.dtypes.split(",")}


if __name__ == "__main__":
    main()
