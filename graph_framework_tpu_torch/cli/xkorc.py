"""xkorc: relativistic Boris particle pushing in an EFIT field.

Counterpart of ``graph_framework_tpu.cli.xkorc`` (graph_korc/xkorc.cpp):
the reference's defaults (1e6 particles, 1e6 steps, dt = 0.5
gyro-normalized, u = (0, 0.99, 0.1) c from x = 1.7 m), scaled down by
flags for interactive runs.  ``--device`` picks the torch device (the
card by default).  The result file needs h5py.  The run's timer is the
span ``gft.xkorc.run`` (``telemetry``).
"""

from __future__ import annotations

import argparse

import torch

from graph_framework_tpu_torch import telemetry

PARTICLE_NAMES = ("x", "y", "z", "ux", "uy", "uz", "gamma")


def build_parser():
    p = argparse.ArgumentParser(prog="xkorc", description=__doc__)
    p.add_argument("--equilibrium_file", required=True)
    p.add_argument("--num_particles", type=int, default=1_000_000)
    p.add_argument("--num_steps", type=int, default=1_000_000)
    p.add_argument("--dt", type=float, default=0.5)
    p.add_argument("--output", default="korc_0.nc")
    p.add_argument("--f32", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default the card, cuda)")
    return p


def run_xkorc(args, eq, open_store):
    """Push the particles through ``eq`` (on ``args.device``) and write
    their final state as row 0 of ``open_store(args.output, "w",
    num_rays=n)``.
    Returns (final ParticleState, particle-steps/s)."""
    from graph_framework_tpu_torch.models.korc import run_korc

    dtype = torch.float32 if args.f32 else torch.float64
    with telemetry.Span("gft.xkorc.run") as span:
        st = run_korc(eq, num_particles=args.num_particles,
                      num_steps=args.num_steps, dt=args.dt, dtype=dtype,
                      device=args.device)
        float(st.x[0])                     # readback: the run has finished
    el = span.seconds
    rate = args.num_particles * args.num_steps / el
    print(f"Run Time: {el:.2f}s = {rate:.3g} particle-steps/s")
    with open_store(args.output, "w", num_rays=args.num_particles) as f:
        for name in PARTICLE_NAMES:
            f.create_variable(name)
        f.write_step(0, {name: getattr(st, name) for name in PARTICLE_NAMES})
    return st, rate


def main(argv=None):
    from graph_framework_tpu_torch.cli import open_result_file
    from graph_framework_tpu_torch.models.efit import make_efit

    args = build_parser().parse_args(argv)
    eq = make_efit(args.equilibrium_file, device=args.device,
                   dtype=torch.float32 if args.f32 else torch.float64)
    return run_xkorc(args, eq, open_result_file)


if __name__ == "__main__":
    main()
