"""xpic: the 1D electrostatic PIC demo (graph_pic/xpic.cpp).

Counterpart of ``graph_framework_tpu.cli.xpic``.  ``--device`` picks the
torch device (the card by default); on the card the deposit is the CUDA
kernel K6, on the CPU its plain version (the JAX package's ``--deposit``
choice is the tensors' device here).  The result files need h5py.  The
run's timer is the span ``gft.xpic.run`` (``telemetry``).
"""

from __future__ import annotations

import argparse

from graph_framework_tpu_torch import telemetry


def build_parser():
    p = argparse.ArgumentParser(prog="xpic", description=__doc__)
    p.add_argument("--num_particles", type=int, default=1_000_000)
    p.add_argument("--num_grid", type=int, default=1000)
    p.add_argument("--num_steps", type=int, default=1000)
    p.add_argument("--dt", type=float, default=1.0e-5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--particles_output", default="pic_particles.nc")
    p.add_argument("--fields_output", default="pic_fields.nc")
    p.add_argument("--device", default="cuda",
                   help="torch device (default the card, cuda)")
    return p


def run_xpic(args, open_store):
    """Run the PIC loop on ``args.device`` and write the particles to
    ``open_store(args.particles_output, "w", num_rays=particles)`` and the
    fields to ``open_store(args.fields_output, "w", num_rays=grid)``.
    Returns (final PicState, particle-steps/s)."""
    from graph_framework_tpu_torch.models.pic import run_pic

    with telemetry.Span("gft.xpic.run") as span:
        st = run_pic(num_particles=args.num_particles,
                     num_grid=args.num_grid, num_steps=args.num_steps,
                     dt=args.dt, seed=args.seed, device=args.device)
        float(st.x[0])                     # readback: the run has finished
    el = span.seconds
    rate = args.num_particles * args.num_steps / el
    print(f"Run Time: {el:.2f}s = {rate:.3g} particle-steps/s")
    with open_store(args.particles_output, "w",
                    num_rays=args.num_particles) as f:
        f.create_variable("x")
        f.create_variable("vpara")
        f.write_step(0, {"x": st.x, "vpara": st.vpara})
    with open_store(args.fields_output, "w", num_rays=args.num_grid) as f:
        f.create_variable("epara")
        f.create_variable("n")
        f.write_step(0, {"epara": st.epara, "n": st.n})
    return st, rate


def main(argv=None):
    from graph_framework_tpu_torch.cli import open_result_file

    args = build_parser().parse_args(argv)
    return run_xpic(args, open_result_file)


if __name__ == "__main__":
    main()
