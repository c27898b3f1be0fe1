"""Time the EFIT window K1, the slab push K5, the grid deposit K6 and the
VMEC geometry jet K4 of two source trees on one card, in turns.

    python3 -m graph_framework_tpu_torch.tools.kernel_ab OTHER_TREE

from the root of one tree, with OTHER_TREE the root of another (an
unpacked ``git archive`` of an earlier commit, say).  Each tree builds and
runs its own package, in a subprocess whose working directory is that
tree, in the order other, this, this, other.  A run measures at the main
path's shapes: K1 one f32 compensated rk2 window of K = 10 substeps over
100k rays and over 1M rays of ``chip_smoke.launch`` (kx from ``init_k``),
and the O and X modes' K1 likewise over 100k rays;
K6 one deposit of 1M particles onto 1000 grid points f32 from
``run_pic``'s start (``pic_start``), its device time the sum of all the
device work of a call (the two trees launch different kernels); K5 one
launch of 1e8 particles f32 x 100 steps from
``chip_smoke.phase_slab_push``'s start, K4 one call of 100k rays x 86
modes f32 at the VMEC launch (``chip_smoke.vmec_launch``), and again with
every ray's s at 0.5 (one radial cell); for each the median device ms of
the launches in a profiler trace and the CUDA-event ms of a wrapper call
(``chip_smoke.profile_kernel``, ``device_work``, ``event_ms``), and
registers and spills of the variants of K1, K2 and K3 of cold plasma and
the two modes, and of K4, K5 and K6, from the build's ptxas log.  This tree's
``chip_smoke.sass_per_item`` then counts each tree's SASS instructions a
K5 step and a K4 mode.  Prints one JSON line per run.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import chip_smoke

# what each tree runs: only names both trees' chip_smoke and package have
_RUN = r"""
import json, torch
import chip_smoke as c
from graph_framework_tpu_torch.kernels import boris, build, efit_step, vmec_geom
from graph_framework_tpu_torch.kernels import deposit as k6
from graph_framework_tpu_torch.models.dispersion import (
    cold_plasma, extra_ordinary_wave, ordinary_wave)
from graph_framework_tpu_torch.models.korc import (
    ParticleState, initialize_gamma)
from graph_framework_tpu_torch.models.pic import make_grid, pic_start
from graph_framework_tpu_torch.ops.compensated import init_comp_carry
from graph_framework_tpu_torch.solver import init_k
build.load()
dev = torch.device("cuda", 0)
eq = c.synthetic_equilibrium(torch.float32, dev)
k1 = {}
for rays in (100_000, 1_000_000):
    carry = init_comp_carry(init_k(c.launch(rays, torch.float32, dev),
                                   cold_plasma, eq))
    window = lambda: efit_step.efit_window(
        eq, carry, method="rk2", dt=c.DT, steps=c.FREEZE_EVERY,
        compensated=True)
    k1[rays] = dict(
        ms=c.profile_kernel(lambda: [window() for _ in range(20)])[0],
        events_ms=c.event_ms(window, 20))
    del carry
modes = {}
for name, disp in (("omode", ordinary_wave), ("xmode", extra_ordinary_wave)):
    carry = init_comp_carry(init_k(c.launch(100_000, torch.float32, dev),
                                   disp, eq))
    window = lambda: efit_step.efit_window(
        eq, carry, method="rk2", dt=c.DT, steps=c.FREEZE_EVERY,
        compensated=True, dispersion=disp)
    modes[name] = dict(
        ms=c.profile_kernel(lambda: [window() for _ in range(20)])[0],
        events_ms=c.event_ms(window, 20))
    del carry
st = pic_start(1_000_000, 1000, c.SEED, torch.float32, dev)
grid = make_grid(1000, 2.0 / 999.0, -1.0, torch.float32, dev)
ones = torch.ones_like(st.x)
deposit = lambda: k6.deposit(st.x, ones, grid)
deposit()
k6_ms = c.device_work(lambda: [deposit() for _ in range(20)])[1] / 20
k6_events = c.event_ms(deposit, 20)
del st, ones
n = 100_000_000
full = lambda a: torch.full((n,), a, dtype=torch.float32, device=dev)
start = list(initialize_gamma(ParticleState(
    full(1.7), full(0.0), full(0.0), full(0.0), full(0.99), full(0.1),
    full(1.0)))[:6])
push = boris.make_slab_push(**c.SLAB, steps=c.SLAB_STEPS)
k5 = c.profile_kernel(lambda: [push(*start) for _ in range(3)],
                      kernel=("slab_push_kernel",))[0]
k5_events = c.event_ms(lambda: push(*start), 3)
del start
eq = c.synthetic_vmec(torch.float32, dev)
st = c.vmec_launch(100_000, torch.float32, dev)
coords = [a.contiguous() for a in (st.x, st.y, st.z)]
tables = vmec_geom.jet_tables(eq)
k4 = c.profile_kernel(
    lambda: [vmec_geom.geometry_jet(*coords, tables) for _ in range(20)],
    kernel=("vmec_geom_kernel",))[0]
k4_events = c.event_ms(lambda: vmec_geom.geometry_jet(*coords, tables), 50)
# every ray in one radial cell: the coefficient loads of a warp meet one
# cache line each
one_cell = [torch.full_like(coords[0], 0.5)] + coords[1:]
k4_one_cell = c.profile_kernel(
    lambda: [vmec_geom.geometry_jet(*one_cell, tables) for _ in range(20)],
    kernel=("vmec_geom_kernel",))[0]
summary = c.ptxas_summary(build.build_log)
# the variants both trees build: cold plasma's (no tag) and the modes'
kept = ("f32", "f64", "omode", "xmode", "K2", "K3", "K4", "K5", "K6")
same = lambda k: (k.split()[0].split("/")[0] in kept
                  and (k.split()[0] not in ("K2", "K3")
                       or k.split()[1].split("/")[0] in kept))
print(json.dumps(dict(
    library=str(build.library_path()), k1=k1, k1_modes=modes, k6_ms=k6_ms,
    k6_events_ms=k6_events, k5_ms=k5, k5_events_ms=k5_events,
    k4_ms=k4, k4_events_ms=k4_events, k4_one_cell_ms=k4_one_cell,
    ptxas={k: v for k, v in summary.items() if same(k)})))
"""


def sass_counts(library):
    """SASS instructions a K5 step (3 MUFU.RSQ a step) and a K4 mode (its
    coefficients in 3 vector loads, or 12 scalar ones and, where a tree
    loads them, xm and xn) in ``library``'s f32 kernels; and every loop of
    K4 as (instructions, loads)."""
    k4 = next(v for k, v in chip_smoke.sass_functions(library).items()
              if "vmec_geom_kernelIfE" in k)
    return dict(
        k5_step=chip_smoke.hot_loop_sass(
            "slab_push_kernel", [("MUFU.RSQ", 3)], library),
        k4_mode=chip_smoke.hot_loop_sass(
            "vmec_geom_kernel", [("LDG.E.128", 3), ("LDG", 14), ("LDG", 12)],
            library),
        k4_loops=[(len(body), sum("LDG" in i for i in body))
                  for body in chip_smoke.sass_loops(k4)])


def run(tree):
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: {proc.stderr[-3000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    row.update(tree=str(tree), sass=sass_counts(row["library"]))
    return row


def main(argv):
    this = pathlib.Path(__file__).resolve().parents[2]
    other = pathlib.Path(argv[1]).resolve()
    for tree in (other, this, this, other):
        print(json.dumps(run(tree)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
