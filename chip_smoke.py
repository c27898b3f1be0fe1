#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

The main path is the ``xrays`` ray trace: cold-plasma rays over an EFIT
tokamak equilibrium, in the reference benchmark's configuration (100k
rays, 1000 recorded steps x 10 substeps, endtime 1.0), through the
library entry points ``init_k`` and ``Solver.run`` with the production
stack - frozen-cell rk2, a 10-substep freeze window, compensated f32
accumulation and the hand-written CUDA window kernel (K1).  The second
path is reverse mode through it: gradients of trace endpoints with
respect to the launch state and the spline tables, through the window
kernel's backward kernels K2 and K3 (``torch.autograd.grad`` over
``Solver.run`` with the plain f32 window).  Phases, one line each (any
failed check raises and the script exits non-zero):

1. device: the card's name and, on its own line, ``nvidia-smi``'s
   name and power limit; no CUDA card is a failure, never a CPU run;
2. build: ``nvcc`` builds ``csrc/*.cu`` (one process per source);
   registers and spills of every kernel variant, the 16 of each of the
   eleven dispersions required (K1 f32, f64 x rk2, rk4 x plain,
   compensated; K2, K3 x f32, f64 x rk2, rk4), and none spilled for K1 f32
   rk2 (plain and compensated) and K2 f32 rk2 of each dispersion, the main
   paths' forward and backward;
3. K1 vs plain PyTorch version at 4099 rays (a ragged count): rk2/rk4
   x plain/compensated x f32/f64, one recorded step at K = 10 and K = 5,
   each within a limit that lies well below what a wrong kernel shows;
   3a. the same for K2 and K3 against autograd of the plain version, with
   random cotangents;
   3b. the O- and X-mode instances of K1 (all eight variants), K2 and K3
   (f32 and f64, rk2 and rk4) against their plain versions at K = 10,
   under the same limits, each also 10x below the other mode's window;
   3c. the same for the other eight tails (cold_plasma_expansion,
   bohm_gross, light_wave, ion_cyclotron, acoustic_wave, simple,
   gaussian_well, stiff), each from its own launch and step
   (TAIL_LAUNCH), each limit 10x below the tail's wrong kernels (rays that
   stood still, stages that keep t, a backward that passes the cotangent
   through, ...: TAIL_K1_ORDER_BLIND, TAIL_BWD_WRONGS); the last three
   read no table and have no K3;
4. main path at full width: 100k rays f32 compensated, then f64 plain,
   then 1M rays for 100 recorded steps; launch counts, validity,
   residuals, the f32/f64 endpoint gap, and ray-steps/s;
   4b'. (phase b) fwd+bwd at full width: the gradient of bench.py's
   endpoint loss with respect to the launch state over 100k rays x 1000
   x 10, twice - the first pass allocates the graph's memory, the
   second finds it cached (K1 and K2 launch counts, finite gradients,
   ray-steps/s, the memory the autograd graph holds) - then table
   gradients over 100k x 100 x 10 through K3;
   4b5. (phase b5) config 5, the gradient of the absorbed power with
   respect to the psi tables and the launch kz (bench.py run_config5) in
   its kernel form at bench's shape: 1M rays f32 x 20 x 10 rk4, K = 10,
   weak damping after each recorded step, 8 ray batches; first at 4099
   rays against its plain frozen form on the card (BWD_TOL), then twice
   at 1M (K1 and K3 launches, one each a window, no K2; the value between
   0 and the ray count; finite gradients, dL/dpsi nonzero; fwd+bwd
   ray-steps/s, peak memory), and one batch's device time split between
   K1, K3, the table scatter (K3's block cotangents and the weak
   damping's gathers' transpose) and the eager weak damping;
   4b7. (phase b7) the spline tables' gradient scatter
   (``csrc/table_scatter.cu``): the 40 calls of one config-5 batch of 125k
   rays, uniform cells and ragged row counts against the plain version on
   the CPU in f32 and f64 (``TABLE_SCATTER_EPS``, integer rows exactly),
   then its time against its bound and the library's ``index_put_``;
   4b6. (phase b6) ``Solver(remat_policy=...)``: None against
   "spline_jet" at 100k rays on the plain frozen path with
   ``remat_substeps``, seconds, peak memory and equal gradients;
   4c'. (phase c) the gradient through ``init_k`` and the kernels against
   central differences, f64;
   4d. the O- and X-mode main paths: 100k rays x 1000 x 10 compensated f32
   rk2 through K1 (launch count, validity, max D^2, the gap to f64 from
   the same root, the smallest w^2 - wh^2 over the run, K1's device ms
   beside its bound), then fwd+bwd over 100 recorded steps through K1 and
   K2 and table gradients over 10 through K3;
   4e. the other eight tails' main paths: 100k rays x 100 x 10 (the
   expansion, which users trace for ECRH, x 1000) compensated f32 rk2
   through K1 from each one's launch (launch count, finite, on the table
   where the tail reads it, the gap to f64 from the same root against the
   plain version's f32 gap, TAIL_GAP_FACTOR, on a subset and over the
   whole run), then fwd+bwd through K1 and K2 and, where the tail reads
   the map, table gradients through K3 (the expansion 100 and 10 recorded
   steps, the others one each);
5. ``trace_segmented``: 32 recorded rows of 100k rays kept in memory;
6. the plain version's ray-steps/s on the card beside the kernel's;
7. each kernel's milliseconds per window (on the device and by CUDA
   events) beside its plain version's and its bound with the bound's
   basis, each held to its limit on that main-path window, and K3's
   scatter into the tables (two table scatter launches,
   ``kernels/table_scatter.py``) timed apart.

The particle paths follow (``xkorc``'s Boris push, ``xpic``'s PIC loop),
with the hand-written kernels K5 (the slab push, ``csrc/boris.cu``) and K6
(the grid deposit, ``csrc/deposit.cu``):

8. K5 vs plain version at 100 003 particles, f32 and f64, one launch of
   100 steps, within a limit that lies well below what a kernel one step
   short shows;
9. K5 at full width, bench.py's korc configuration: 1e8 particles f32,
   10 launches of 100 steps; particle-steps/s, launch count, the drift of
   sqrt(1 + u.u), and the plain version's rate over one launch;
10. ``run_korc`` through the EFIT field (plain PyTorch): 1e6 particles f64
   x 1000 steps; the axis field, particle-steps/s, validity, gamma drift;
11. K6 vs plain version at 100 003 particles, G 1000 and 1001, a mask with
   zeros, f32 and f64; wrong deposits (mask ignored, the last chunk
   dropped, each point summing only its own bin's particles) and a second
   launch equal bit for bit; the working type's exp is +0 at K6's reach;
12. ``run_pic`` at full width, bench.py's pic configuration: 1M particles x
   1000 grid points f32 x 50 steps, 50 K6 launches, against the same steps
   with the plain deposit;
13. K5's and K6's milliseconds beside their plain versions' and bounds
   (K6 by kernel, and its bound's basis: the pairs within reach of this
   run's particles); K5's special-function floor and the SASS instructions
   of its step loop (``cuobjdump``).

Then the VMEC stellarator ray trace, with the hand-written kernels K4 (the
fused geometry jet, ``csrc/vmec_geom.cu``) and K7 (the mode sums,
``csrc/vmec_modes.cu``):

14. K4 vs plain version at 4099 rays, f32 and f64, all 27 jet sums, s
   over both clamps, past both table ends and on the cell edges; the VJP
   of its autograd Function against autograd of the plain jet; each limit
   10x below what a kernel that drops the last mode, reads lmns on the full
   grid or swaps two Jacobian rows shows; in f32 the kernel and the plain
   version each against the f64 plain version;
15. K7 vs plain version at 4099 rays x 86 modes, f32 and f64, forward and
   VJP, 10x below a kernel one mode short or a VJP with two cotangents
   swapped;
16. the VMEC main path at full width, bench.py's fused_rk2 leg: 100k rays
   x 86 modes f32, rk2, 10 substeps, ``fused_mode_sums=True`` (K4), at
   least 100 recorded steps; K4's launch count, validity, max D^2,
   ray-steps/s and the device's busy share; then against the unfused plain
   path, and the frozen-radial rk2 path (K = 10, plain torch);
17. K4's and K7's milliseconds beside their plain versions' and bounds;
   the SASS instructions of K4's mode loop.

18. the referee fixtures (tests/fixtures/golden_*.npz) on the card in
   f64: ``init_k`` and the trajectories of configs 1, 2 and 2b (O mode, X
   mode, Bohm-Gross) at tests/test_reference_parity.py's tolerances, and
   two adaptive_rk4 steps of the stiff system against its analytic
   referee.

Then the xrays pipeline as users run it, through the port's CLI:

19. ``cli/xrays.run_xrays``, the phase function of ``python -m
   graph_framework_tpu_torch.cli.xrays``, on the synthetic map: cold
   plasma, 100k rays x 100 rows x 10 steps of dt 1e-4, this script's
   launch as CLI options, 16 rows a host block, weak-damping absorption
   and power binning, into an in-memory stand-in of the result file
   (``MemoryFiles``: the card's machine has no h5py).  The CLI's own stack
   choice (frozen rk2, K = 10, compensated, K1, f32), K1's launches (100
   windows and the warm-up step's), the last row against
   ``Solver.trace_segmented`` bit for bit, every row finite and on the
   table, kamp finite and, on three rows, within 1e-10 of the CPU's
   complex128 evaluation, power <= 1 and non-increasing; the phases'
   timings.  Then the root finder over the first 11 rows (iterations,
   converged share, seconds).  19d runs the trace again with
   ``--dispersion=cold_plasma_expansion`` (ECRH) and no stack options:
   the production stack, 101 launches of the expansion's K1, the last row
   against ``trace_segmented``, every row finite and on the table.  At
   phase 19's launch kamp is real (zeta ~ 25)
   and power stays 1, so 19c runs the CLI again at a launch near the
   map's electron cyclotron resonance (100k rays x 10 rows x 10 steps):
   power falls on at least 99% of the rays, and kamp (also at a complex
   kx), the root finder and bin_power on the card agree with the CPU's
   ray by ray; ``xrays_bench.bench_one`` (float at 100k rays,
   complex_double at 10k) and ``xpic``'s phase function through K6
   (19b);
20. ``wofz``, ``erf_complex``, ``dawson`` and ``erfcx`` on the card in
   complex128/float64 and complex64/float32 at about 1e6 points over every
   branch, against scipy.special.

Then the embedding layer, the reference's graph API (``expr.py``,
``capi_bridge.py``, ``capi/``):

21. a light wave D = w^2 - c^2 k^2 - wp^2(x, z) built through the port's
   graph API at 1M rays: (a) ``expr.newton``'s converge item for kx, wp^2
   a piecewise_2D over the synthetic map's 129 x 129 grid, f64 and f32,
   against the closed-form root (1e-10 in f64; in f32 a limit derived from
   the rounding of D) and on 4099 rays against the same Workflow on the CPU
   in f64; (b) a loop item of 100 explicit ray steps from df of D (wp^2 an
   analytic profile of graph nodes), f64 and f32, against the CPU's f64
   run on 4099 rays, each limit 10x below what the graph with one setter's
   sign flipped shows; seconds, device operations and device ms a run (the
   profiler), busy share and peak memory of each; (c) ``libgraph_tpu_torch.so``
   built from the checkout with gcc, the unchanged ``capi/c_binding_test.c``
   linked against it and run on the card (``GRAPH_TORCH_DEVICE`` unset).

Then the ray ensemble split across processes (``parallel``), its ranks
processes of this script (``--phase22-rank``) that load the kernel library
phase 2 built:

22. the card's compute mode; (a) two ranks on the one card, gloo (NCCL
   refuses two ranks on one device): each solves its 500k-ray slice of
   phase 4c's launch with ``init_k(mesh=)`` (4c's Newton iterations, one
   ensemble-max all-reduce an iteration and the last test's) and runs
   ``Solver.run`` on the production stack for 100 x 10 (100 K1 launches a
   rank), its rows equal to 4c's bit for bit and ``host_local_rows``
   partitioning the rays; the checkpoint the ranks saved, restored by this
   process, equal to 4c's rows; config 5's kernel form over each rank's
   half of phase b5's launch in 4 batches of 125k (80 K1 and 80 K3
   launches a rank, no K2), the sums every rank returns within
   ``config5_limits`` of b5's (the batches' f32 association and b5's own
   pass-to-pass spread from K3's atomics), each limit 10x below what a
   wrong reduction shows (a rank's share: its slice's sums without the
   all-reduce, from a second, untimed call); (b) one rank, NCCL: the same trace and Newton
   solve through NCCL's all-reduce, rows bit for bit; the walls, each
   collective's milliseconds a call, config 5's fwd+bwd ray-steps/s under
   two ranks and the peak memory of each rank.

After each group of phases a ``[lap]`` line gives its wall seconds.  It
then prints the kernel table as one JSON line (the seven kernels and
the instances of K1, K2 and K3 for the other ten dispersions; the lines of
cold plasma's and the expansion's K1 and of K6 also carry their launches
on the CLI paths) and, last, the device line
``{"ok": true, "device": {...}}``.

The equilibria are built in memory (no file, no ``h5py``): a smooth
up-down symmetric tokamak flux map on a 129 x 129 grid with 129-knot
profiles, chosen so that the cold-plasma wave propagates everywhere the
rays go - see :func:`synthetic_samples` (phase 10 moves its axis:
``KORC_AXIS``) - and a W7-X-like stellarator with the reference VMEC
file's shapes (:func:`synthetic_vmec_samples`).  Weights-free: everything
is made from ``SEED``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import socket
import subprocess
import sys
import tempfile
import time
import types
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from graph_framework_tpu_torch.constants import (
    ME, Q, cyclotron_frequency, plasma_frequency_squared)
from graph_framework_tpu_torch.kernels import (
    boris, build, efit_step, vmec_geom, vmec_modes, vmec_rhs)
from graph_framework_tpu_torch.kernels import deposit as k6
from graph_framework_tpu_torch.kernels import table_scatter
from graph_framework_tpu_torch import expr
from graph_framework_tpu_torch.cli import xpic, xrays, xrays_bench
from graph_framework_tpu_torch.io.checkpoint import (
    restore_ray_state, save_ray_state)
from graph_framework_tpu_torch.io.output import host_array
from graph_framework_tpu_torch.models import absorbed_power, absorption
from graph_framework_tpu_torch.models.dispersion import (
    DISPERSIONS, bohm_gross, cold_plasma, extra_ordinary_wave,
    ordinary_wave, stiff)
from graph_framework_tpu_torch.models.equilibrium import (
    make_gaussian_density, make_no_magnetic_field, make_slab_density)
from graph_framework_tpu_torch.models.efit import efit_from_tables
from graph_framework_tpu_torch.models.korc import (
    ParticleState, initialize_gamma, run_korc)
from graph_framework_tpu_torch.models.pic import (
    WIDTH, PicState, make_grid, make_push_step, pic_start, run_pic)
from graph_framework_tpu_torch.models.rays import (
    RayDerivatives, RayState, dispersion_residual, residual_fn)
from graph_framework_tpu_torch.models.vmec import vmec_from_tables
from graph_framework_tpu_torch.ops import integrators, special
from graph_framework_tpu_torch.ops import tables as ops_tables
from graph_framework_tpu_torch.ops.compensated import (
    CompCarry, comp_state_f64, init_comp_carry)
from graph_framework_tpu_torch.ops.tables import piecewise_2d
from graph_framework_tpu_torch.parallel import (
    distributed, ray_mesh, run_blocked_sharded, shard_rays)
from graph_framework_tpu_torch.parallel import mesh as pmesh
from graph_framework_tpu_torch.solver import Solver, init_k, make_ray_state
from graph_framework_tpu_torch.tools.make_splines import (
    efit_tables, vmec_tables)

SEED = 0

# -- the synthetic equilibrium -----------------------------------------------
# A tokamak of major radius R0 = 2.0 m, minor radius 0.9 m, elongation 1.5,
# toroidal field B0 = 0.35 T on axis (fpol = R0 B0, B_phi = fpol / R) and a
# poloidal flux psi = PSI0 ((R - R0)^2 / a^2 + Z^2 / (kappa a)^2), so the
# edge poloidal field is about a tenth of the toroidal one (q ~ 2).  Core
# density 2e18 m^-3 and temperature 2 keV, with the same tanh pedestal
# shape for both: the reference's ne <- te table quirk
# (equilibrium.hpp:1478) then leaves ne unchanged.  For the launch
# frequency w = 500 / m (omega = 1.5e11 rad/s), on the grid the plasma
# frequency is at most 266 / m, the electron cyclotron frequency at most
# 411 / m (0.7 T at R = 1 m), the upper hybrid frequency at most 411 / m
# and the R cutoff at most 464 / m (388 / m on axis), so w stays above
# every cutoff and resonance: both cold-plasma branches propagate.
R0, A_MINOR, KAPPA, B0, PSI0 = 2.0, 0.9, 1.5, 0.35, 0.04
NE0, TE0 = 2.0e18, 2.0e3
GRID = 129                   # grid points in R and Z; profile knots
R_RANGE, Z_RANGE = (1.0, 3.0), (-1.0, 1.0)

# The particle push through EFIT (phase k) runs on the same flux map with
# its magnetic axis 3 cm above the midplane and the flux there 1% of PSI0
# below psimin (KORC_AXIS, keyword arguments of synthetic_samples).  The
# reference's axis find (characteristic_field: simultaneous Newton steps
# on R and Z of the normalized flux from (1.7, 0), step 0.1) divides by
# dpsi/dz, which vanishes at z = 0 on an up-down symmetric map, and where
# psimin is the axis flux it hunts a double root whose iterates wander
# with the rounding: there it walks off the table, in the JAX package as
# in the port (|B| of 1e6-1e11 T), and the two land apart.  With
# KORC_AXIS the normalized flux has a simple root on a contour 9 cm from
# the axis: both packages stop on it after about 190 iterations at
# (1.9114, 0.0060) m, |B| = 0.36625 T, within 5e-13 of each other.
KORC_AXIS = dict(z_axis=0.03, psi_axis=-0.01 * PSI0)

# -- the synthetic stellarator (VMEC) -----------------------------------------
# A W7-X-like rotating-ellipse stellarator of five field periods in VMEC
# flux coordinates (s, u, v), with the reference file's shapes: 86 modes
# (xm 0..9, xn = 5 n, n in -4..4; 90 grid slots), 199 full-grid knots on s
# in [-1, 1] (ds = 1/99) and a half grid shifted by ds / 2.  The surface of
# label s has the mean radius rho(s) = A sqrt((s + HOLLOW) / (1 + HOLLOW)):
# rho^2 is linear in s, as the toroidal flux phi = signj dphi s is, so the
# Jacobian and the toroidal field are smooth and finite on the whole table
# (s = -1 is the surface rho = A / 3, not a singular axis).  R00 5.5 m,
# A 0.5 m, elongation KAPPA, a rotating ellipse (m, n) = (1, 1) and a
# helical axis excursion (0, 1); every other mode carries
# SHAPE DECAY^(m + |n|) (rho / A)^m, and lambda LAMBDA times the same.
# The profiles are the analytic ones of the reference: ne = 1e19 (1 -
# |s|^1.5)^2, te = 1 keV times the same.  For the launch frequency w = 900
# /m (omega = 2.7e11 rad/s): the plasma frequency is at most 595 /m (s =
# 0), the electron cyclotron frequency about 264 /m (B0 0.45 T), the upper
# hybrid frequency at most 652 /m and the R cutoff at most 796 /m, so w
# lies above every cutoff and resonance and both branches propagate.
VMEC_KNOTS, VMEC_NFP = 199, 5.0
VMEC_R00, VMEC_A, VMEC_HOLLOW, VMEC_KAPPA = 5.5, 0.5, 1.25, 1.1
VMEC_ELLIPSE, VMEC_AXIS, VMEC_SHAPE, VMEC_DECAY = 0.25, 0.04, 0.02, 0.6
VMEC_LAMBDA, VMEC_B0, VMEC_IOTA = 0.05, 0.45, (0.9, 0.1)
# The VMEC launch (bench.py:151-152, config 4): w 900 /m at (s, u, v) =
# (0.5, 0.5, 0), kx (the covariant s component) solved by init_k from 500
# (it lands near 99: the O-mode root), ky = kz = 0; s and u spread
# normally so that the rays differ.  bench.py's fused_rk2 leg: rk2, 10
# substeps of dt 2.5e-6 a recorded step (endtime 0.025 over 1000 steps).
# Over 1000 recorded steps the rays move some 0.15 in s: they stay inside
# 0 < s < 1, where both branches propagate (above).
VMEC_W0, VMEC_S0, VMEC_U0, VMEC_KX0 = 900.0, 0.5, 0.5, 500.0
VMEC_S_SPREAD, VMEC_U_SPREAD = 0.01, 0.05
VMEC_DT, VMEC_SUB_STEPS = 2.5e-6, 10

# -- the launch (the reference benchmark's values, bench.py:171) -------------
W0, X0, KX0, KY0 = 500.0, 2.5, -500.0, 150.0
X_SPREAD, KY_SPREAD = 0.02, 10.0    # normal spreads of x [m] and ky [1/m]
DT, SUB_STEPS, FREEZE_EVERY = 1.0e-4, 10, 10   # endtime 1.0: 1000 x 10 x dt

# -- tolerances of the kernel against its plain version ----------------------
# Per leaf, the largest deviation over the rays divided by the scale of its
# group (t, w, |position|, |wave vector|); for compensated carries it is the
# deviation of the double-word values hi + lo, so a lost low word shows in
# f64 as well.  The two sides differ only in rounding (the kernel's
# hand-written reverse sweep multiplies by reciprocals where autograd of
# the plain version divides; FMA contraction; operation order).  Keyed by (dtype, compensated),
# each limit sits about 20x above the deviation read on the card over one
# recorded step at 4099 rays (NVIDIA H100 80GB HBM3, 700.00 W) by the
# forward-mode kernel, and above what the reverse-sweep kernel reads:
#   f32 plain   read 9.3e-8 (both): one-ulp flips of x (ulp(2.5) / 2.5 =
#               9.5e-8);
#   f32 comp    read 4.8e-11, 1.4e-10 / 1.5e-10 (rk2 / rk4) since the
#               reciprocals: the rounding of the increments themselves;
#               6.7x below the limit, which is kept;
#   f64 plain   read 1.7e-16 (both): one-ulp flips;
#   f64 comp    read 7.4e-20, 7.9e-20 since: the increments' rounding.
# Phase 3 also measures, on the plain version, what a wrong kernel would
# show, and asserts that the limit lies SEPARATION times below it: the
# compensated run against the same run with the low words dropped (read
# 4.6e-7 in f32, 5.9e-16 in f64) and, where the rounding leaves room for
# it (CAN_SEE_ORDER), rk2 against rk4 (read 1.9e-12 in f64; under the f32
# rounding).  A wrong order, Euler included, thus fails in f64, and the f32
# variants run the same increment<T, METHOD> template of the kernel.
TOL = {(torch.float32, False): 2.0e-6, (torch.float32, True): 1.0e-9,
       (torch.float64, False): 4.0e-15, (torch.float64, True): 1.5e-18}
SEPARATION = 10.0
CAN_SEE_ORDER = {(torch.float32, False): False,
                 (torch.float32, True): False,
                 (torch.float64, False): True, (torch.float64, True): True}
# Compensated f32 against f64 after 1000 recorded steps (phase 4b), from
# the same f32 Newton root (read 2.5e-8) and from each one's own root
# (read 4.4e-7, mostly the f32 root's error); about 20x above the readings.
# The uncompensated f32 run's gap is measured beside it (read 7.4e-5) and
# must lie SEPARATION times above the same-root limit.
GAP_TOL = {"f32 root": 5.0e-7, "own root": 1.0e-5}

# -- tolerances of the backward kernels against their plain versions ---------
# Per leaf of the state cotangent, and per table of the scattered block
# cotangents: the largest deviation over the rays (table rows) divided by
# the largest magnitude of that leaf (table) in the plain version, over one
# recorded step from seeded normal cotangents at 4099 rays.  The plain
# version is torch.autograd of frozen_window (reverse over reverse); the
# kernels transpose by hand and take the Hessian-vector products forward
# over a hand-written reverse sweep, and the table scatter adds with
# atomics, so the two round differently.  Each limit sits about 20x above
# what the card read (NVIDIA H100 80GB HBM3, 700.00 W):
#   f32 state  read 8.3e-7;   f32 tables read 4.2e-6 (5.4e-6 since the
#   sweep is the hand-written reverse one);
#   f64 state  read 9.3e-16;  f64 tables read 1.2e-14.
# Phase 3a also measures on the plain version what a wrong backward shows
# and asserts that each limit lies SEPARATION times below it: the transpose
# without v_w (D_w's dependence on the state dropped; read 3.8e-3 state,
# 6.7e-3 tables in both dtypes) and, in f64, the other Runge-Kutta order's
# transpose (read 2.6e-9 state, 2.8e-5 tables).
BWD_TOL = {torch.float32: {"state": 2.0e-5, "tables": 1.0e-4},
           torch.float64: {"state": 2.0e-14, "tables": 2.5e-13}}
# Config 5's K3 line (a 125k-ray batch at CONFIG5_LAUNCH, rk4, dt 1 / 200,
# seeded cotangents) cannot take BWD_TOL: 6 cm outside the resonance the
# window's transpose is ill-conditioned in f32, and the f32 plain version
# itself lies up to 40x BWD_TOL from the plain version in f64 on the same
# inputs (x's cotangent; the record prints it).  There the kernel is held
# to the f64 plain version instead, as phase 14 holds K4: per part (state,
# tables), at most BWD_REFEREE_FACTOR times as far from it as the f32
# plain version.  The loss's own cotangents are better conditioned: phase
# b5's referee holds that batch's value and gradients to BWD_TOL.
BWD_REFEREE_FACTOR = 2.0
# Phase c: the directional derivative along the gradient against central
# differences (tests/test_gradients.py's rtol and step sizes).
FD_RTOL = 1.0e-5
FD_STEP = {"launch": 1.0e-3, "psi_coeffs": 1.0e-7}


# -- config 5: the gradient of the absorbed power (phase b5) -----------------
# bench.py's run_config5 at its shape (1M rays f32, 20 recorded steps x 10
# substeps, dt 1 / 200, K = 10, 8 ray batches) on the synthetic map.  The
# launch must absorb: at the main path's launch zeta ~ 25, kamp is real and
# the loss would be 0.  w 250 /m puts the electron cyclotron resonance at
# R = 1.64 m (ec = 410 / R /m); the rays start 6 cm outside it with kx > 0
# (kx solved from 200 /m: 181-210 /m) and move away from it, so the damping
# is strongest at the start and no ray crosses the resonance, where the weak
# damping's Dw / (khat . dDc/dk) and its gradient blow up.  About a quarter
# of the power is absorbed (phase b5: 237751 of 1M rays, NVIDIA H100 80GB
# HBM3, 700.00 W).  kz0 50 /m, well away from 0, where the up-down symmetric
# map makes dL/dkz vanish.
CONFIG5_KZ = 50.0
CONFIG5_LAUNCH = dict(w=250.0, x=1.7, x_spread=0.005, kx=200.0, ky=100.0,
                      ky_spread=5.0, kz=CONFIG5_KZ)   # launch()'s keywords
CONFIG5_STEPS, CONFIG5_SUB, CONFIG5_BATCHES = 20, 10, 8


def synthetic_samples(grid=GRID, z_axis=0.0, psi_axis=0.0):
    """Gridded samples of the synthetic equilibrium, the keyword arguments
    of ``tools.make_splines.efit_tables`` / ``write_efit_file``, with the
    magnetic axis at (R0, ``z_axis``) and the flux ``psi_axis`` there."""
    r = np.linspace(*R_RANGE, grid)
    z = np.linspace(*Z_RANGE, grid)
    psi = PSI0 * ((r[:, None] - R0) ** 2 / A_MINOR ** 2
                  + (z[None, :] - z_axis) ** 2 / (KAPPA * A_MINOR) ** 2
                  ) + psi_axis
    psi_profile = np.linspace(0.0, 1.02 * psi.max(), grid)
    s = psi_profile / PSI0                       # 1 at the plasma edge
    shape = 0.005 + 0.995 * 0.5 * (1.0 - np.tanh((s - 0.8) / 0.12))
    ne, te = NE0 * shape, TE0 * shape
    return dict(r=r, z=z, psi=psi, psi_profile=psi_profile, ne=ne, te=te,
                pressure=2.0 * Q * ne * te,
                fpol=np.full_like(psi_profile, R0 * B0))


def synthetic_vmec_samples(knots=VMEC_KNOTS):
    """Gridded samples of the synthetic stellarator, the keyword arguments
    of ``tools.make_splines.vmec_tables`` / ``write_vmec_file``: ``knots``
    full-grid knots on s in [-1, 1] (ds = 2 / (knots - 1)), the half grid
    shifted by ds / 2, and the 86 modes of the reference's file."""
    s_full = np.linspace(-1.0, 1.0, knots)
    ds = s_full[1] - s_full[0]
    s_half = s_full[:-1] + 0.5 * ds
    xm, xn = vmec_mode_numbers()

    def coefficients(s):
        """(rmnc, zmns, lmns) of every mode at the radii ``s``."""
        rho = VMEC_A * np.sqrt((s + VMEC_HOLLOW) / (1.0 + VMEC_HOLLOW))
        x = rho / VMEC_A
        rmnc = np.zeros((xm.size, s.size))
        zmns = np.zeros((xm.size, s.size))
        lmns = np.zeros((xm.size, s.size))
        for k, (m, n) in enumerate(zip(xm, xn / VMEC_NFP)):
            decay = VMEC_DECAY ** (m + abs(n)) * x ** m
            sign = (-1.0) ** (m + n)
            rmnc[k] = VMEC_SHAPE * sign * decay
            zmns[k] = -VMEC_SHAPE * decay
            lmns[k] = VMEC_LAMBDA * sign * decay
            if (m, n) == (0, 0):
                rmnc[k], zmns[k], lmns[k] = VMEC_R00, 0.0, 0.0
            elif (m, n) == (1, 0):
                rmnc[k], zmns[k] = rho, VMEC_KAPPA * rho
            elif (m, n) == (1, 1):
                rmnc[k], zmns[k] = VMEC_ELLIPSE * rho, -VMEC_ELLIPSE * rho
            elif (m, n) == (0, 1):
                rmnc[k], zmns[k] = VMEC_AXIS, -VMEC_AXIS
        return rmnc, zmns, lmns

    rmnc, zmns, _ = coefficients(s_full)
    _, _, lmns = coefficients(s_half)
    # toroidal flux phi = signj dphi s gives B_phi = VMEC_B0 (the Jacobian
    # of the circular part is rho rho' R = R A^2 / (2 (1 + VMEC_HOLLOW)));
    # chi' = iota phi' with the rotational transform iota(s) of VMEC_IOTA
    dphi = VMEC_B0 * VMEC_A ** 2 / (2.0 * (1.0 + VMEC_HOLLOW))
    iota0, iota1 = VMEC_IOTA
    chi = -dphi * (iota0 * s_full + 0.5 * iota1 * s_full ** 2)
    return dict(s_full=s_full, s_half=s_half, chi=chi, rmnc=rmnc,
                zmns=zmns, lmns=lmns, xm=xm, xn=xn, signj=-1.0, dphi=dphi)


def vmec_mode_numbers():
    """The reference file's 86 modes (VMEC's order): m = 0 with
    n = 0..4, then m = 1..9 with n = -4..4; xn = VMEC_NFP n."""
    pairs = [(0, n) for n in range(5)] + [
        (m, n) for m in range(1, 10) for n in range(-4, 5)]
    m, n = np.array(pairs, dtype=np.float64).T
    return m, VMEC_NFP * n


def synthetic_vmec(dtype, device, knots=VMEC_KNOTS, **options):
    """The synthetic stellarator on ``device``; ``options``: those of
    ``models.vmec.vmec_from_tables`` (``fused_mode_sums``, ...)."""
    return vmec_from_tables(vmec_tables(**synthetic_vmec_samples(knots)),
                            dtype=dtype, device=device, **options)


def vmec_launch_arrays(n, seed=SEED):
    """The VMEC launch of n rays as float64 numpy arrays (the leaves of a
    RayState, kx unsolved): s and u normal around the launch."""
    rng = np.random.default_rng(seed)
    full = np.ones(n)
    return dict(t=0.0 * full, w=VMEC_W0 * full,
                x=VMEC_S0 + VMEC_S_SPREAD * rng.standard_normal(n),
                y=VMEC_U0 + VMEC_U_SPREAD * rng.standard_normal(n),
                z=0.0 * full, kx=VMEC_KX0 * full, ky=0.0 * full,
                kz=0.0 * full)


def vmec_rhs_state(n, dtype, device, seed=SEED):
    """n rays for the VMEC ray RHS (K8 against its plain version and the
    eager RHS): s uniform on (0.05, 0.95), u and v over a turn, w at the
    launch's, (k_s, k_u, k_v) nonzero and off the dispersion's root."""
    rng = np.random.default_rng(seed)
    leaves = dict(t=np.zeros(n), w=np.full(n, VMEC_W0),
                  x=rng.uniform(0.05, 0.95, n),
                  y=rng.uniform(0.0, 2.0 * np.pi, n),
                  z=rng.uniform(0.0, 2.0 * np.pi, n),
                  kx=rng.uniform(50.0, 150.0, n), ky=rng.uniform(-5.0, 5.0, n),
                  kz=rng.uniform(-5.0, 5.0, n))
    return RayState(**{k: torch.tensor(a, dtype=dtype, device=device)
                       for k, a in leaves.items()})


def vmec_launch(n, dtype, device, seed=SEED):
    """:func:`vmec_launch_arrays` as a RayState on ``device``."""
    return make_ray_state(n, dtype=dtype, device=device, **{
        k: torch.from_numpy(a) for k, a in vmec_launch_arrays(n,
                                                                seed).items()})


def synthetic_equilibrium(dtype, device, grid=GRID, **axis):
    """The synthetic equilibrium on ``device``; ``axis``: the z_axis and
    psi_axis of :func:`synthetic_samples`."""
    return efit_from_tables(efit_tables(**synthetic_samples(grid, **axis)),
                            dtype=dtype, device=device)


def launch(n, dtype, device, seed=SEED, w=W0, x=X0, kx=KX0, ky=KY0,
           x_spread=X_SPREAD, ky_spread=KY_SPREAD, kz=0.0):
    """n rays (as cli/xrays.py:230-259 builds them): w fixed, x and ky
    normal around the launch, the rest fixed, kx solved by init_k."""
    rng = np.random.default_rng(seed)
    x = x + x_spread * rng.standard_normal(n)
    ky = ky + ky_spread * rng.standard_normal(n)
    return make_ray_state(n, w=w, x=torch.from_numpy(x), kx=kx,
                          ky=torch.from_numpy(ky), kz=kz, dtype=dtype,
                          device=device)


def production_solver(eq, *, compensated=True, window_kernel=True,
                      dispersion=cold_plasma):
    return Solver(dispersion, eq, method="rk2", dt=DT,
                  sub_steps=SUB_STEPS, frozen_cells=True,
                  freeze_every=FREEZE_EVERY, compensated=compensated,
                  window_kernel=window_kernel)


class MemoryStore:
    """An in-memory stand-in for ``io.output.ResultFile`` (its methods,
    no file, no h5py): each variable's rows as host numpy arrays, float64
    or complex128 as the file stores them."""

    def __init__(self, num_rays=None):
        self.num_rays = num_rays
        self.rows = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        pass

    def create_variable(self, name, complex_valued=False):
        self.rows.setdefault(name, {})

    def variables(self):
        return list(self.rows)

    @property
    def num_steps(self):
        return max((max(r) + 1 for r in self.rows.values() if r),
                   default=0)

    def write_step(self, index, values):
        for name, value in values.items():
            value = host_array(value)
            kind = np.complex128 if np.iscomplexobj(value) else np.float64
            self.rows[name][index] = value.astype(kind)

    def read_step(self, index, names, complex_valued=False):
        return {name: self.rows[name][index] for name in names}

    def stack(self, name):
        """The (rows, rays) array of one variable."""
        return np.stack([self.rows[name][i] for i in range(self.num_steps)])

    def nbytes(self):
        return sum(a.nbytes for r in self.rows.values() for a in r.values())


class MemoryFiles(dict):
    """Path -> MemoryStore.  ``open`` is a store factory with
    ``cli.open_result_file``'s signature, as the CLIs' phase functions
    take it: mode "w" starts the path's store afresh, "r+" reopens it."""

    def open(self, path, mode, num_rays=None):
        if mode == "w":
            self[path] = MemoryStore(num_rays)
        return self[path]


def leaf_deviations(a, b):
    """Per-leaf max |a - b| over the rays, in f64.  For CompCarry arguments
    it is the deviation of the double-word values, (hi_a - hi_b) + (lo_a -
    lo_b): exact for nearby hi words, so a lost low word shows in f64 too."""
    if isinstance(a, CompCarry):
        diffs = [(ha.double() - hb.double()) + (la.double() - lb.double())
                 for ha, hb, la, lb in zip(a.hi, b.hi, a.lo, b.lo)]
    else:
        diffs = [la.double() - lb.double() for la, lb in zip(a, b)]
    return {f: _no_nan(d.abs().max()) for f, d in zip(RayState._fields,
                                                      diffs)}


def _no_nan(x):
    """A deviation as a float, inf where it is NaN: a NaN on either side
    fails every limit (Python's max() and <= would pass it)."""
    x = float(x)
    return float("inf") if x != x else x


def leaf_errors(a, b):
    """:func:`leaf_deviations` relative to the scale of each leaf's group
    in b: t, w, position (x, y, z), wave vector (kx, ky, kz)."""
    ref = b.hi if isinstance(b, CompCarry) else b

    def scale(*leaves):
        return max(float(l.abs().max()) for l in leaves) or 1.0

    groups = {"t": scale(ref.t), "w": scale(ref.w),
              "pos": scale(ref.x, ref.y, ref.z),
              "k": scale(ref.kx, ref.ky, ref.kz)}
    of = dict(t="t", w="w", x="pos", y="pos", z="pos",
              kx="k", ky="k", kz="k")
    return {f: _no_nan(d / groups[of[f]])
            for f, d in leaf_deviations(a, b).items()}


def in_domain(state, eq):
    """Rays whose state is finite and whose position lies in the table
    (bench.py:304-311)."""
    r = torch.sqrt(state.x * state.x + state.y * state.y)
    nr, nz = eq.psi_coeffs.shape[:2]
    finite = torch.stack([torch.isfinite(l) for l in state]).all(dim=0)
    return (finite & (r >= eq.rmin) & (r <= eq.rmin + eq.dr * nr)
            & (state.z >= eq.zmin) & (state.z <= eq.zmin + eq.dz * nz))


def timed(fn, pick=lambda out: out):
    """(result, seconds): synchronize, run, synchronize and read a scalar
    back (a launch queue that reads as finished is not proof of work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    float(pick(out).x[0])
    return out, time.perf_counter() - t0


def event_ms(fn, reps):
    """Mean device milliseconds of fn over reps calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def profile_kernel(fn, kernel=("efit_window_kernel",)):
    """Run fn once under torch.profiler.  Returns (device ms per launch
    from the CUDA trace - for each name in ``kernel`` the median duration
    of the kernels whose name holds it, summed over the names; None if
    the trace shows no device time - the number of launches the trace
    holds of the first name, and the device-timeline ms of the whole call
    from CUDA events).  The trace can miss a launch or hold one without
    its duration (in some runs), hence the median of what it holds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    per_launch, counts = 0.0, []
    for name in kernel:
        us = [e.device_time_total for e in events if name in e.name]
        counts.append(len(us))
        timed_us = [t for t in us if t > 0]
        if not timed_us:
            return None, counts[0], start.elapsed_time(stop)
        per_launch += float(np.median(timed_us)) / 1000.0
    return per_launch, counts[0], start.elapsed_time(stop)


def cuda_events(fn):
    """Run fn once under torch.profiler: (the CUDA events of its trace -
    kernels, copies, fills - and the call's wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA], wall_ms


def device_work(fn, part=None):
    """Run fn once under torch.profiler: (the device operations the CUDA
    trace holds - kernels, copies, fills - and their summed device ms;
    with ``part``, also the summed ms of those whose name holds it)."""
    events, _ = cuda_events(fn)
    total = sum(e.device_time_total for e in events) / 1000.0
    if part is None:
        return len(events), total
    return len(events), total, sum(
        e.device_time_total for e in events if part in e.name) / 1000.0


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing was run")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[1 device] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; nvcc {build.find_nvcc()}")
    print(smi)
    return name, smi


#: The window kernels' tails by their struct names (csrc/efit_adjoint.cuh)
#: and tags (efit_step.KERNEL_TAILS), the longer names first
#: ("ColdPlasmaExpansion" before cold plasma, which has no tag;
#: "ExtraOrdinaryWave" before "OrdinaryWave").
PTXAS_TAGS = tuple(sorted(((t.struct, t.tag) for t in efit_step.KERNEL_TAILS
                           if t.tag), key=lambda pair: -len(pair[0])))


def ptxas_summary(log):
    """{variant: 'N registers, ... spill ...'} from nvcc's -Xptxas -v log;
    the variant is read from the mangled name of efit_window_kernel<T,
    METHOD, COMPENSATED, Disp> (K1: f32/rk2/plain, ... for cold plasma,
    omode f32/rk2/plain, xmode f32/rk2/plain, stiff f32/rk2/plain, ... for
    the other tails, PTXAS_TAGS), of
    efit_window_bwd_kernel<T, METHOD, TAB, Disp> (K2 f32/rk2 without the
    table cotangents, K3 f32/rk2 with them; K2 omode f32/rk2, ...), of
    slab_push_kernel<T> (K5 f32,
    K5 f64), of K6's seven kernels deposit_{setup, count, bins,
    scatter, tile, finish}_kernel<T> and deposit_rows_kernel (K6 tile f32,
    K6 bins f64, K6 rows, ...), or of
    vmec_geom_kernel<T> and vmec_modes_kernel<T> (K4 f32, K7 f64, ...)."""
    out, variant = {}, None
    for line in log.splitlines():
        m = re.search(
            r"efit_window_(bwd_)?kernelI([fd])Li([24])ELb([01])", line)
        p = re.search(
            r"(slab_push|deposit_(?:setup|count|rows|bins|scatter|tile|"
            r"finish)|vmec_geom|vmec_modes)_kernel(?:I([fd])E)?", line)
        if p and "Compiling entry function" in line:
            # K6's rows kernel counts integers: no dtype
            dtype = {"f": " f32", "d": " f64", None: ""}[p[2]]
            variant = {"slab_push": f"K5{dtype}",
                       "vmec_geom": f"K4{dtype}",
                       "vmec_modes": f"K7{dtype}"}.get(
                p[1], f"K6 {p[1][len('deposit_'):]}{dtype}")
            out[variant] = []
        elif m:
            dtype = "f32" if m[2] == "f" else "f64"
            mode = next((f"{tag} " for struct, tag in PTXAS_TAGS
                         if struct in line), "")
            if m[1]:
                variant = (f"{'K3' if m[4] == '1' else 'K2'} {mode}{dtype}/"
                           f"rk{m[3]}")
            else:
                variant = (f"{mode}{dtype}/rk{m[3]}/"
                           f"{'comp' if m[4] == '1' else 'plain'}")
            out[variant] = []
        elif variant and ("spill" in line or "registers" in line):
            out[variant].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in sorted(out.items())}


def spill_bytes(info):
    """Spill stores + loads in bytes of one ptxas_summary entry; raises if
    ptxas printed no spill line for it."""
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
    if m is None:
        raise AssertionError(f"no spill line in ptxas's summary: {info!r}")
    return int(m[1]) + int(m[2])


def sass_functions(lib_path):
    """{mangled name: [(address, instruction text), ...]} of every kernel in
    the built library, from ``cuobjdump -sass`` (beside nvcc)."""
    import pathlib

    tool = pathlib.Path(build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            name = m[1]
            out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name and m:
            out[name].append((int(m[1], 16), m[2]))
    return out


def sass_loops(code):
    """The loops of one function's SASS: for each backward branch, the
    instructions from its target to the branch, both included."""
    loops = []
    for addr, ins in code:
        m = re.search(r"\bBRA(?:\.\w+)*\s+(?:[^,]+,\s*)?0x([0-9a-f]+)", ins)
        if m and int(m[1], 16) <= addr:
            target = int(m[1], 16)
            loops.append([i for a, i in code if target <= a <= addr])
    return loops


def sass_per_item(code, marker, per_item):
    """SASS instructions a work item of a kernel's hot loop: of the loops
    whose count of ``marker`` instructions is a nonzero multiple of
    per_item, the one with the most (the smallest body on a tie: an inner
    loop before the loop around it), over marker count / per_item items
    (the compiler may unroll); with its MUFU and branch instructions an
    item.  None if no loop qualifies."""
    loops = [(sum(marker in i for i in body), -len(body), body)
             for body in sass_loops(code)]
    loops = [x for x in loops if x[0] and x[0] % per_item == 0]
    if not loops:
        return None
    hits, _, best = max(loops, key=lambda x: x[:2])
    items = hits // per_item
    ops = [re.sub(r"^@!?U?P\w+\s+", "", i).split()[0].split(".")[0]
           for i in best]
    return dict(per_item=len(best) / items, unrolled=items,
                mufu=sum(o == "MUFU" for o in ops) / items,
                branches=sum(o == "BRA" for o in ops) / items)


def hot_loop_sass(kernel, tries, library=None):
    """:func:`sass_per_item` of the f32 instance of ``kernel`` in
    ``library`` (the built one by default) for the first (marker,
    per_item) of ``tries`` that finds its loop; or the reason the SASS
    could not be read."""
    try:
        funcs = sass_functions(library or build.library_path())
        code = next(v for n, v in funcs.items() if f"{kernel}IfE" in n)
        return next((r for r in (sass_per_item(code, marker, per_item)
                                 for marker, per_item in tries) if r), None)
    except (OSError, RuntimeError, subprocess.CalledProcessError,
            StopIteration) as err:
        return f"not measured ({type(err).__name__}: {err})"


def phase_build():
    t0 = time.perf_counter()
    build.load()
    seconds = time.perf_counter() - t0
    print(f"[2 build] {seconds:.2f} s ({len(list(build.CSRC.glob('*.cu')))}"
          f" nvcc processes in parallel, then a link); ptxas per kernel "
          f"variant:")
    summary = ptxas_summary(build.build_log)
    for variant, info in summary.items():
        print(f"    {variant}: {info}")
    modes = [""] + [f"{tag} " for tag in KERNEL_TAGS]
    # K3 only for the tails that read the map
    bwd = [(k, d) for d in modes for k in ("K2", "K3")
           if k == "K2" or reads_map(KERNEL_TAGS.get(d.strip(), cold_plasma))]
    window = [f"{k} {d}{t}/rk{m}" for k, d in bwd
              for t in ("f32", "f64") for m in (2, 4)] + [
        f"{d}{t}/rk{m}/{c}" for d in modes for t in ("f32", "f64")
        for m in (2, 4) for c in ("plain", "comp")]
    missing = [v for v in window if v not in summary]
    if missing:
        raise AssertionError(f"ptxas printed nothing for {missing}")
    # the main paths' forward and backward keep their live sets in
    # registers, for each dispersion
    for variant in [f"{d}f32/rk2/{c}" for d in modes
                    for c in ("plain", "comp")] + [
            f"K2 {d}f32/rk2" for d in modes]:
        if spill_bytes(summary[variant]) != 0:
            raise AssertionError(f"{variant} spills: {summary[variant]}")


def run_windows(eq, carry, method, k, compensated, kernel,
                dispersion=cold_plasma, dt=DT):
    """One recorded step (SUB_STEPS // k freeze windows of k substeps) from
    ``carry``, through the kernel's wrapper or its plain version."""
    for _ in range(SUB_STEPS // k):
        if kernel:
            carry = efit_step.efit_window(eq, carry, method=method, dt=dt,
                                          steps=k, compensated=compensated,
                                          dispersion=dispersion)
        else:
            carry = efit_step.frozen_window(eq, dispersion, carry,
                                            method=method, dt=dt, steps=k,
                                            compensated=compensated)
    return carry


#: The dispersion a kernel of each mode is held apart from: a kernel that
#: ran the other mode's tail (phase 3b's "other dispersion").
OTHER_MODE = {ordinary_wave: extra_ordinary_wave,
              extra_ordinary_wave: ordinary_wave}


def check_window(eq, st, method, k, compensated, dispersion=cold_plasma,
                 dt=DT):
    """Kernel against plain version over one recorded step from the state
    ``st``.  Returns a row: the worst relative leaf deviation, its limit,
    the deviations the plain version shows for a wrong kernel (the other
    Runge-Kutta order; the low words dropped; for the O and X modes, the
    other mode's window; for stiff, stages that keep t) and ``fail``, the
    names of the checks that failed."""
    key = (st.x.dtype, compensated)
    start = init_comp_carry(st) if compensated else st
    plain = run_windows(eq, start, method, k, compensated, False,
                        dispersion, dt)

    def worst(state):
        return max(leaf_errors(state, plain).values())

    tag = tail_of(dispersion)
    row = {"dev": worst(run_windows(eq, start, method, k, compensated,
                                    True, dispersion, dt)),
           "limit": TAIL_TOL.get((tag, *key), TOL[key])}
    if CAN_SEE_ORDER[key] and tag not in TAIL_K1_ORDER_BLIND:
        other = "rk4" if method == "rk2" else "rk2"
        row["other order"] = worst(run_windows(eq, start, other, k,
                                               compensated, False,
                                               dispersion, dt))
    if CAN_SEE_ORDER[key]:
        if dispersion is stiff:
            with frozen_stage_t():
                row["stages keep t"] = worst(run_windows(
                    eq, start, method, k, compensated, False, dispersion,
                    dt))
    if compensated:
        row["low words dropped"] = worst(init_comp_carry(run_windows(
            eq, st, method, k, False, False, dispersion, dt)))
    if dispersion in OTHER_MODE:
        row["other dispersion"] = worst(run_windows(
            eq, start, method, k, compensated, False,
            OTHER_MODE[dispersion]))
    if tag is not None:
        moved = leaf_errors(start, plain)
        row["stood still"] = max(moved[f] for f in RayState._fields[2:])
    row["fail"] = ([] if row["dev"] <= row["limit"] else ["dev"]) + [
        s for s in ("other order", "low words dropped", "other dispersion",
                    "stages keep t", "stood still")
        if s in row and not row[s] >= SEPARATION * row["limit"]]
    return row


def phase_kernel_vs_plain(device, n=4099):
    rows = {}
    for dtype in (torch.float32, torch.float64):
        eq = synthetic_equilibrium(dtype, device)
        st = init_k(launch(n, dtype, device, seed=SEED + 1), cold_plasma,
                    eq)
        for method in ("rk2", "rk4"):
            for comp in (False, True):
                for k in (10, 5):
                    rows[f"{str(dtype)[6:]}/{method}/"
                         f"{'comp' if comp else 'plain'}/K={k}"] = \
                        check_window(eq, st, method, k, comp)
    print(f"[3 kernel vs plain, {n} rays, 1 recorded step] worst relative "
          f"leaf deviation against its limit, and what a wrong kernel "
          f"would show: {json.dumps(rows)}")
    failed = {key: row for key, row in rows.items() if row["fail"]}
    if failed:
        raise AssertionError(f"kernel vs plain: {failed}")


# -- reverse mode -------------------------------------------------------------


def endpoint_loss(s):
    """bench.py's endpoint functional (run_grad): the mean final position
    and wave-vector sum."""
    return (s.x.sum() + s.y.sum() + s.z.sum() + s.kx.sum()) / s.x.shape[0]


def random_cotangent(like, seed):
    rng = np.random.default_rng(seed)
    return RayState(*[torch.from_numpy(rng.standard_normal(like.x.shape[0]))
                      .to(like.x) for _ in RayState._fields])


def rhs_without_vw(dispersion, feq, keep_local_graph=True):
    """A wrong ray RHS for the separation check: the values of
    make_ray_rhs, but 1/D_w is held constant in the transpose, so the
    cotangent loses D_w's dependence on the state (v_w of the kernels).
    Plain autograd: ``keep_local_graph`` (make_ray_rhs's) has no use
    here."""
    d_all = dispersion_residual(dispersion, feq)

    def rhs(s):
        args = [leaf.view_as(leaf) for leaf in
                (s.w, s.x, s.y, s.z, s.kx, s.ky, s.kz)]
        g = torch.autograd.grad(d_all(s.t, *args).sum(), args,
                                create_graph=True, allow_unused=True)
        g = [torch.zeros_like(a) if d is None else d
             for a, d in zip(args, g)]
        inv = (1.0 / g[0]).detach()
        return RayDerivatives(-g[4] * inv, -g[5] * inv, -g[6] * inv,
                              g[1] * inv, g[2] * inv, g[3] * inv)

    return rhs


def step_vjp(eq, st, ct, method, k, how, tables, dispersion=cold_plasma,
             dt=DT):
    """The VJP of one recorded step (SUB_STEPS // k plain windows) from
    ``st`` for the output cotangent ``ct``: (state cotangent, psi-table
    and profile-table cotangents or None).  ``how``: "kernel" (K2, or K3
    with ``tables``), "plain" (autograd of frozen_window), or a wrong
    backward on the plain version: "v_w dropped", "other order", "other
    dispersion" (the other mode's, OTHER_MODE), "stages keep t"
    (frozen_stage_t), or "passed through" (``ct`` itself, zero tables)."""
    inputs = [st]
    for _ in range(SUB_STEPS // k - 1):
        inputs.append(efit_step.frozen_window(
            eq, dispersion, inputs[-1], method=method, dt=dt, steps=k,
            compensated=False))
    order = method
    if how == "other order":
        order = "rk4" if method == "rk2" else "rk2"
    transpose = (OTHER_MODE[dispersion] if how == "other dispersion"
                 else dispersion)
    if how == "passed through":
        zeros = (torch.zeros_like(eq.psi_coeffs),
                 torch.zeros_like(eq.profile_coeffs))
        return ct, zeros if tables else None
    d_tabs = None
    for s in reversed(inputs):
        if how == "kernel":
            vjp = efit_step.efit_window_vjp(eq, s, ct, method=method,
                                            dt=dt, steps=k, tables=tables,
                                            dispersion=dispersion)
        elif how in ("v_w dropped", "stages keep t"):
            with (mock.patch.object(efit_step, "make_ray_rhs",
                                    rhs_without_vw)
                  if how == "v_w dropped" else frozen_stage_t()):
                vjp = efit_step.frozen_window_vjp_blocks(
                    eq, s, ct, method=order, dt=dt, steps=k,
                    dispersion=dispersion)
        else:
            vjp = efit_step.frozen_window_vjp_blocks(
                eq, s, ct, method=order, dt=dt, steps=k,
                dispersion=transpose)
        ct = vjp.state
        if tables:
            tabs = efit_step.scatter_block_cotangents(eq, vjp)
            d_tabs = tabs if d_tabs is None else tuple(
                a + b for a, b in zip(d_tabs, tabs))
    return ct, d_tabs


def relative_deviations(got, want):
    """Per tensor (leaf or table): max |got - want| / max |want|."""
    return [_no_nan((a.double() - b.double()).abs().max()
                    / b.double().abs().max().clamp_min(1e-300))
            for a, b in zip(got, want)]


def check_window_bwd(eq, st, method, k, seed, dispersion=cold_plasma,
                     dt=DT):
    """K2 and K3 against autograd of the plain version over one recorded
    step from ``st`` with seeded cotangents.  Returns a row: the worst
    relative deviation of the state cotangent (K2 and K3) and of the
    tables (K3), their limits, what the wrong backwards show, and
    ``fail``.  Cold plasma's and the modes' wrong backwards are "v_w
    dropped", "other order" (f64) and "other dispersion" (the modes); the
    other tails' are TAIL_BWD_WRONGS's.  A dispersion that reads no table
    has no K3 and no table cotangents: K2 alone is held to the state's
    limit (``"tables"`` is None), and its wrong backwards by the state
    alone."""
    ct = random_cotangent(st, seed)
    tol = BWD_TOL[st.x.dtype]
    tables = reads_map(dispersion)
    want_st, want_tab = step_vjp(eq, st, ct, method, k, "plain", tables,
                                 dispersion, dt)
    k2, _ = step_vjp(eq, st, ct, method, k, "kernel", False, dispersion, dt)
    row = {"state": max(relative_deviations(k2, want_st)), "tables": None,
           "limits": tol}
    if tables:
        k3, k3_tab = step_vjp(eq, st, ct, method, k, "kernel", True,
                              dispersion, dt)
        row["state"] = max(row["state"],
                           max(relative_deviations(k3, want_st)))
        row["tables"] = max(relative_deviations(k3_tab, want_tab))
    tag = tail_of(dispersion)
    if tag is not None:
        wrongs = TAIL_BWD_WRONGS[tag][st.x.dtype == torch.float64]
    else:
        wrongs = ["v_w dropped"] + (
            ["other order"] if CAN_SEE_ORDER[st.x.dtype, False] else []) + (
            ["other dispersion"] if dispersion in OTHER_MODE else [])
    parts = ("state", "tables") if tables else ("state",)
    for how in wrongs:
        w_st, w_tab = step_vjp(eq, st, ct, method, k, how, tables,
                               dispersion, dt)
        row[how] = {"state": max(relative_deviations(w_st, want_st))}
        if tables:
            row[how]["tables"] = max(relative_deviations(w_tab, want_tab))
    row["fail"] = [part for part in parts
                   if not row[part] <= tol[part]] + [
        f"{how} {part}" for how in wrongs for part in parts
        if not row[how][part] >= SEPARATION * tol[part]]
    return row


def phase_bwd_vs_plain(device, n=4099):
    rows = {}
    for dtype in (torch.float32, torch.float64):
        eq = synthetic_equilibrium(dtype, device)
        st = init_k(launch(n, dtype, device, seed=SEED + 1), cold_plasma,
                    eq)
        for method in ("rk2", "rk4"):
            for k in (10, 5):
                rows[f"{str(dtype)[6:]}/{method}/K={k}"] = \
                    check_window_bwd(eq, st, method, k, SEED + 2)
    print(f"[3a K2/K3 vs plain, {n} rays, 1 recorded step, seeded "
          f"cotangents] worst relative deviation of the state cotangent "
          f"and of the table cotangents against their limits, and what a "
          f"wrong backward would show: {json.dumps(rows)}")
    failed = {key: row for key, row in rows.items() if row["fail"]}
    if failed:
        raise AssertionError(f"backward kernels vs plain: {failed}")


#: The O and X modes the window kernels implement beside cold plasma
#: (codes 1 and 2 of efit_step.KERNEL_TAILS), by their tags.
MODES = {t.tag: t.dispersion for t in efit_step.KERNEL_TAILS[1:3]}


def phase_modes_vs_plain(device, n=4099):
    """Phase 3b: K1 (all eight variants, K = 10) and K2/K3 (f32 and f64,
    rk2 and rk4, K = 10) of the O and X modes against their plain
    versions over one recorded step, under the limits of phases 3 and 3a,
    each with its separation from a wrong kernel (the other mode among
    them)."""
    rows = {}
    for dtype in (torch.float32, torch.float64):
        eq = synthetic_equilibrium(dtype, device)
        for mode, disp in MODES.items():
            st = init_k(launch(n, dtype, device, seed=SEED + 1), disp, eq)
            for method in ("rk2", "rk4"):
                for comp in (False, True):
                    rows[f"K1 {mode} {str(dtype)[6:]}/{method}/"
                         f"{'comp' if comp else 'plain'}"] = check_window(
                        eq, st, method, FREEZE_EVERY, comp, disp)
                rows[f"K2/K3 {mode} {str(dtype)[6:]}/{method}"] = \
                    check_window_bwd(eq, st, method, FREEZE_EVERY,
                                     SEED + 2, disp)
    print(f"[3b O and X modes: K1, K2/K3 vs plain, {n} rays, 1 recorded "
          f"step, K={FREEZE_EVERY}] worst relative deviations against "
          f"their limits, and what a wrong kernel would show: "
          f"{json.dumps(rows)}")
    failed = {key: row for key, row in rows.items() if row["fail"]}
    if failed:
        raise AssertionError(f"O/X kernels vs plain: {failed}")


# -- the other eight tails of the window kernels (phases 3c and 4e) ----------
# Each dispersion of the kernels beside cold plasma and the two modes
# (codes 3-10 of efit_step.KERNEL_TAILS), by the tag of its sources
# (csrc/efit_window_<tag>.cu) and of count_ops' keys, in the order users
# trace them through a tokamak.
TAILS = {t.tag: t.dispersion for t in efit_step.KERNEL_TAILS[3:]}
# Each tail's launch on the synthetic map: launch()'s keywords, the k
# component init_k solves (None: the state as launched, D not zero) and
# the substep dt, chosen so that every ray stays finite - and, where the
# tail reads the map, on the table - for 1000 substeps:
#   expansion  phase 19's launch: kx has a root near -400 /m;
#   bohm       ky solved near 3.9e3 /m: k_par lies along the toroidal B
#              (y at the launch), so kx barely moves it;
#   light      phase 19's launch: kx near -395 /m;
#   ioncyc     a fixed state with k ~ 1e-2 /m: D = wce - kperp^2 vs^2 - w^2
#              has no real root (wce < 0: the electron's charge, as the
#              reference writes it), and vs^2 ~ 3e9 (the ion temperature
#              of the reference's ni = te quirk, ti ~ ne) moves the rays at
#              some 6e4 c, so dt is 1e-9;
#   acoustic   ky solved near 9e-3 /m, kx 0: the same vs^2, the same dt;
#   simple     phase 19's launch;
#   gwell      x = 0.3 m, inside the well exp(-(x^2 + y^2) / 0.1) and off
#              the map (the tail reads no table);
#   stiff      w = 1, x = 0.9 m, kx solved near 1e-2: dkx/dt = 1e3 kx, so
#              dt 1e-5 keeps kx below e^10 its start over 1000 substeps,
#              and rk2/rk4 stable (1e3 dt = 0.01).
TAIL_LAUNCH = {
    "expansion": ({}, "kx", DT), "bohm": (dict(ky=4000.0, ky_spread=100.0),
                                          "ky", DT),
    "light": ({}, "kx", DT),
    "ioncyc": (dict(kx=0.01, ky=0.005, ky_spread=0.001), None, 1.0e-9),
    "acoustic": (dict(kx=0.0, ky=0.01, ky_spread=0.001), "ky", 1.0e-9),
    "simple": ({}, "kx", DT), "gwell": (dict(x=0.3), "kx", DT),
    "stiff": (dict(w=1.0, x=0.9, kx=0.01, ky=0.0, ky_spread=0.0), "kx",
              1.0e-5)}


# The wrong kernels phase 3c holds each tail's kernels apart from, where
# the dtype shows them (the separations read on the plain versions on the
# CPU, 1024 rays, one recorded step).  K1: rays that stood still (every
# tail, both dtypes: at least 2.4e-4 of the position's scale, ioncyc's and
# acoustic's at dt 1e-9), the low words dropped (compensated), stiff's
# stages that keep t (f64: 4.9e-7), and in f64 the other Runge-Kutta order
# except for simple, whose straight rays rk2 and rk4 advance alike (read
# 6.3e-20), and bohm, whose RHS varies too little over a window (3.9e-16).
# K2/K3, as (f32, f64): "v_w dropped" shows where D_w depends on the state
# beyond w (expansion 2.8e-3, gwell 2.7e-3; simple 7.3e-6, f64 only); where
# D_w = -2w it moves w's cotangent alone (bohm 4.0e-5, light 2.3e-6,
# ioncyc 1.5e-6 in f32), and a backward that passes the cotangent through
# unchanged shows instead (1.5e-2 to 6.4e-2 over a window; 1 for tables;
# simple's window is the identity within 2e-6); "other order" in f64
# except for simple (2.9e-15); stiff's "stages keep t" in f64 (5.6e-7).
# Table parts are held apart only where the tail reads the map.
TAIL_K1_ORDER_BLIND = ("simple", "bohm")
# The compensated K1's deviation is the rounding of the substeps'
# increments, so it scales with how far a substep moves a leaf against
# its scale: 3.2e-5 for cold plasma at its launch (TOL's readings), 3.1e-4
# for gwell, 1.0e-2 for stiff (dkx/dt = 1e3 kx at dt 1e-5; the CPU, 512
# rays, one rk2 substep).  Stiff's compensated limits are therefore their
# own, about 4x above the card's readings (NVIDIA H100 80GB HBM3, 700.00
# W, phase 3c at 4099 rays: f32 2.39e-9 rk2, 2.05e-9 rk4; f64 4.46e-18,
# 3.18e-18) and SEPARATION below the low words dropped (f32 2.08e-7, f64
# 3.30e-16); every other tail is held to TOL.
TAIL_TOL = {("stiff", torch.float32, True): 1.0e-8,
            ("stiff", torch.float64, True): 2.0e-17}
TAIL_BWD_WRONGS = {
    "expansion": (["v_w dropped"], ["v_w dropped", "other order"]),
    "simple": ([], ["v_w dropped", "passed through"]),
    "gwell": (["v_w dropped"], ["v_w dropped", "other order"]),
    "stiff": (["passed through"],
              ["passed through", "stages keep t", "other order"])}
for _tag in ("bohm", "light", "ioncyc", "acoustic"):
    TAIL_BWD_WRONGS[_tag] = (["passed through"],
                             ["passed through", "other order"])


def tail_of(dispersion):
    """The TAILS tag of ``dispersion``, or None (cold plasma, a mode)."""
    return next((t for t, d in TAILS.items() if d is dispersion), None)


def tail_launch(tag, n, eq, seed=SEED):
    """(launch state of ``tag``'s TAIL_LAUNCH over the synthetic map ``eq``,
    in its dtype and on its device; its dt): n rays, the k component solved
    by init_k where the launch names one."""
    options, solve, dt = TAIL_LAUNCH[tag]
    like = eq.psi_coeffs
    state = launch(n, like.dtype, like.device, seed=seed, **options)
    if solve is not None:
        state = init_k(state, TAILS[tag], eq, solve)
    return RayState(*[leaf.detach().contiguous() for leaf in state]), dt


def reads_map(dispersion):
    """Whether the window kernels of ``dispersion`` read the map's tables
    (its rays must stay on the table) or not (simple, gaussian_well,
    stiff: their rays may leave it)."""
    return dispersion not in efit_step.TABLE_FREE


def frozen_stage_t():
    """A context in which the plain version's Runge-Kutta stages keep the
    substep's t (ops/integrators.py _shift with no dt_shift): the wrong
    window a kernel would run whose stages do not advance t, which only
    stiff's D can tell apart."""
    shift = integrators._shift
    return mock.patch.object(
        integrators, "_shift",
        lambda state, d, f, dt_shift: shift(state, d, f, 0.0))


def upper_hybrid_gap(eq, state):
    """The smallest w^2 - wh^2 over the rays (wh^2 = wpe^2 + wce^2): the
    distance of the X mode's D from its pole."""
    pq = eq.plasma_quantities(torch.stack([state.x, state.y, state.z]))
    wpe2 = plasma_frequency_squared(pq.ne, Q, ME)
    wce = cyclotron_frequency(-Q, torch.sqrt((pq.b * pq.b).sum(dim=0)), ME)
    return float((state.w * state.w - (wpe2 + wce * wce)).min())


def phase_modes_main(device, n=100_000, steps=1000, steps_grad=100,
                     steps_tab=10, samples=10):
    """Phase 4d: the O- and X-mode main paths at full width - n rays x
    steps x SUB_STEPS, compensated f32 rk2 K = 10 through K1 - then f64
    plain from the same f32 root (the endpoint gap), the smallest
    w^2 - wh^2 over the run (``samples`` points of a second run), and
    fwd+bwd through K1 and K2 (steps_grad recorded steps) and table
    gradients through K3 (steps_tab).  Returns {mode: (eq, launch state,
    K1 launches, K2 launches, K3 launches)}."""
    out = {}
    windows = SUB_STEPS // FREEZE_EVERY
    eq64 = synthetic_equilibrium(torch.float64, device)
    for mode, disp in MODES.items():
        eq = synthetic_equilibrium(torch.float32, device)
        st, init_s = timed(lambda: init_k(launch(n, torch.float32, device),
                                          disp, eq))
        sol = production_solver(eq, dispersion=disp)
        efit_step.efit_window_launches = 0
        (final, carry), secs = timed(
            lambda: sol.run(st, steps, return_carry=True),
            pick=lambda o: o[0])
        launches = efit_step.efit_window_launches
        if launches != steps * windows:
            raise AssertionError(f"{mode}: {launches} K1 launches, "
                                 f"expected {steps * windows}")
        ok = in_domain(final, eq)
        frac = float(ok.double().mean())
        res = float(residual_fn(disp, eq)(final).max())
        same = RayState(*[leaf.double() for leaf in st])
        final64 = production_solver(eq64, compensated=False,
                                    dispersion=disp).run(same, steps)
        gap = max(leaf_errors(comp_state_f64(carry), final64).values())
        gaps = [upper_hybrid_gap(eq, st)]
        s = st
        for _ in range(samples):
            s = production_solver(eq, compensated=False,
                                  dispersion=disp).run(s, steps // samples)
            gaps.append(upper_hybrid_gap(eq, s))
        rate = n * steps * SUB_STEPS / secs
        k1_ms, _, _ = profile_kernel(lambda: [efit_step.efit_window(
            eq, init_comp_carry(st), method="rk2", dt=DT, steps=FREEZE_EVERY,
            compensated=True, dispersion=disp) for _ in range(20)])
        b_ms, b_by, basis = window_bound(eq, n, f"K1 {mode} rk2 comp")
        print(f"[4d {mode} main f32 compensated] {n} rays x {steps} x "
              f"{SUB_STEPS}: init_k {init_s:.3f} s, run {secs:.3f} s = "
              f"{rate:.6e} ray-steps/s; {launches} K1 launches; in table "
              f"{frac}; max D^2 {res:.3e}; largest relative gap to f64 "
              f"from the same root {gap:.3e} (limit {GAP_TOL['f32 root']});"
              f" smallest w^2 - wh^2 over the run {min(gaps):.6e} /m^2 "
              f"(w^2 = {W0 * W0:.6e}); K1 on the device {k1_ms} ms a "
              f"window against its bound {b_ms:.4f} ms by {b_by} ({basis})")
        if frac != 1.0 or not np.isfinite(res) or not gap <= GAP_TOL[
                "f32 root"] or not min(gaps) > 0.1 * W0 * W0:
            raise AssertionError(f"{mode} main path: in table {frac}, max "
                                 f"D^2 {res}, gap {gap}, w^2 - wh^2 "
                                 f"{min(gaps)}")

        sol = production_solver(eq, compensated=False, dispersion=disp)
        leaves = [leaf.detach().clone().requires_grad_(True) for leaf in st]
        reset_launch_counts()
        (loss, grads), secs = timed(lambda: _loss_and_grads(
            lambda: sol.run(RayState(*leaves), steps_grad), leaves),
            pick=lambda o: RayState(*o[1]))
        counts = launch_counts()
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        psi = eq.psi_coeffs.clone().requires_grad_(True)
        prof = eq.profile_coeffs.clone().requires_grad_(True)
        eqt = dataclasses.replace(eq, psi_coeffs=psi, profile_coeffs=prof)
        reset_launch_counts()
        _, tab_grads = _loss_and_grads(
            lambda: production_solver(eqt, compensated=False,
                                      dispersion=disp).run(st, steps_tab),
            [psi, prof])
        counts_tab = launch_counts()
        tab_ok = all(bool(torch.isfinite(g).all()) and float(
            g.abs().max()) > 0 for g in tab_grads)
        print(f"[4d {mode} fwd+bwd f32 rk2] {n} rays x {steps_grad} x "
              f"{SUB_STEPS}: {secs:.3f} s = "
              f"{n * steps_grad * SUB_STEPS / secs:.6e} fwd+bwd "
              f"ray-steps/s (first pass); launches K1/K2/K3 {counts}; "
              f"finite {finite}; table gradients over {steps_tab} steps: "
              f"launches {counts_tab}, finite and nonzero {tab_ok}")
        if (counts != (steps_grad * windows, steps_grad * windows, 0)
                or counts_tab != (steps_tab * windows, 0,
                                  steps_tab * windows)
                or not (finite and tab_ok)):
            raise AssertionError(f"{mode} gradients: launches {counts}, "
                                 f"{counts_tab}; finite {finite}, {tab_ok}")
        out[mode] = (eq, st, launches, counts[1], counts_tab[2])
    return out


def phase_tails_vs_plain(device, n=4099):
    """Phase 3c: each of the other eight tails' K1 (all eight variants,
    K = 10) and K2/K3 (f32 and f64, rk2 and rk4, K = 10) against their
    plain versions over one recorded step from the tail's own launch and
    step (TAIL_LAUNCH), under the limits of phases 3 and 3a, each with its
    separation from the tail's wrong kernels (TAIL_K1_ORDER_BLIND,
    TAIL_BWD_WRONGS)."""
    rows = {}
    for dtype in (torch.float32, torch.float64):
        eq = synthetic_equilibrium(dtype, device)
        for tag, disp in TAILS.items():
            st, dt = tail_launch(tag, n, eq, seed=SEED + 1)
            for method in ("rk2", "rk4"):
                for comp in (False, True):
                    rows[f"K1 {tag} {str(dtype)[6:]}/{method}/"
                         f"{'comp' if comp else 'plain'}"] = check_window(
                        eq, st, method, FREEZE_EVERY, comp, disp, dt)
                rows[f"K2/K3 {tag} {str(dtype)[6:]}/{method}"] = \
                    check_window_bwd(eq, st, method, FREEZE_EVERY,
                                     SEED + 2, disp, dt)
    print(f"[3c the other eight tails: K1, K2/K3 vs plain, {n} rays, 1 "
          f"recorded step, K={FREEZE_EVERY}] worst relative deviations "
          f"against their limits, and what a wrong kernel would show: "
          f"{json.dumps(rows)}")
    failed = {key: row for key, row in rows.items() if row["fail"]}
    if failed:
        raise AssertionError(f"tail kernels vs plain: {failed}")


# Phase 4e: each tail's compensated f32 run through K1 against f64 from the
# same root may lie TAIL_GAP_FACTOR times as far from it as the plain
# version's compensated f32 run does (the first TAIL_GAP_RAYS rays over
# TAIL_GAP_STEPS recorded steps; the plain version is too slow for the
# whole run): the tails' D differ too much in their conditioning (acoustic
# _wave's D is a difference of nearly equal terms, stiff's kx grows as
# e^(1e3 t)) for cold plasma's GAP_TOL to fit them, so each is held to
# its own plain version's f32 rounding, as K4_REFEREE_FACTOR holds K4.
# Both gaps are the position's and k's (ray_gap), 1e-10 to 5e-8 here; the
# kernel's source built on the host (tools/count_ops.host_library, 1024
# rays) read 0.83 (light) to 2.64 (expansion) times the plain version's:
# rounding in another order, with reciprocals.  A kernel with a wrong term
# lies orders of magnitude further (phase 3c).  The whole run's gap (all
# rays, every step) is held to the same factor of the plain version's
# subset gap grown in proportion to the steps, as rounding that adds up in
# one direction grows (NVIDIA H100 80GB HBM3, 700.00 W, phase 4e: the
# whole-run gaps read 0.51 (ioncyc) to 2.43 (gwell) times that).
TAIL_GAP_FACTOR = 5.0
TAIL_GAP_RAYS, TAIL_GAP_STEPS = 4099, 20


def ray_gap(a, b):
    """The largest relative deviation of the position and wave-vector
    leaves (leaf_errors): t's is the f32 rounding of dt alone (2.5e-8 at dt
    1e-4) and w does not move, so they would hide the rays' own gap."""
    errors = leaf_errors(a, b)
    return max(errors[f] for f in RayState._fields[2:])


def tail_solver(eq, dispersion, dt, *, compensated=True,
                window_kernel=True):
    """production_solver for a tail's dispersion and step."""
    return Solver(dispersion, eq, method="rk2", dt=dt,
                  sub_steps=SUB_STEPS, frozen_cells=True,
                  freeze_every=FREEZE_EVERY, compensated=compensated,
                  window_kernel=window_kernel)


def phase_tails_main(device, n=100_000, steps=100, steps_long=1000,
                     steps_grad=100, steps_tab=10, check_launches=True):
    """Phase 4e: the other eight tails at full width - n rays x steps x
    SUB_STEPS compensated f32 rk2 K = 10 through K1 (cold_plasma_expansion,
    which users trace for ECRH, steps_long) from each tail's launch - then
    f64 plain through K1 from the same root (the endpoint gap, and
    TAIL_GAP_FACTOR against the plain version's f32 gap), and gradients:
    fwd+bwd through K1 and K2 (the expansion steps_grad recorded steps,
    the others one) and, where the tail reads the map, table gradients
    through K3 (steps_tab, one; the others' tables take none).
    ``check_launches``: hold the launch counts (a rehearsal on the CPU,
    where the wrappers launch nothing, does not).  Returns {tag: (eq,
    launch state, dt, K1, K2, K3 launches (None: no K3))}."""
    out = {}
    windows = SUB_STEPS // FREEZE_EVERY
    eq = synthetic_equilibrium(torch.float32, device)
    eq64 = synthetic_equilibrium(torch.float64, device)
    for tag, disp in TAILS.items():
        long = tag == "expansion"
        k1_steps = steps_long if long else steps
        (st, dt), init_s = timed(lambda: tail_launch(tag, n, eq),
                                 pick=lambda o: o[0])
        reset_launch_counts()
        (final, carry), secs = timed(
            lambda: tail_solver(eq, disp, dt).run(st, k1_steps,
                                                  return_carry=True),
            pick=lambda o: o[0])
        launches = efit_step.efit_window_launches
        finite = all(bool(torch.isfinite(leaf).all()) for leaf in final)
        frac = (float(in_domain(final, eq).double().mean())
                if reads_map(disp) else None)
        same = RayState(*[leaf.double() for leaf in st])
        final64 = tail_solver(eq64, disp, dt, compensated=False).run(
            same, k1_steps)
        gap = ray_gap(comp_state_f64(carry), final64)
        sub = RayState(*[leaf[:TAIL_GAP_RAYS].contiguous() for leaf in st])
        ref = tail_solver(eq64, disp, dt, compensated=False).run(
            RayState(*[leaf.double() for leaf in sub]), TAIL_GAP_STEPS)
        gaps = {}
        for name, kernel in (("kernel", True), ("plain", False)):
            _, c = tail_solver(eq, disp, dt, window_kernel=kernel).run(
                sub, TAIL_GAP_STEPS, return_carry=True)
            gaps[name] = ray_gap(comp_state_f64(c), ref)
        rate = n * k1_steps * SUB_STEPS / secs
        gap_limit = (TAIL_GAP_FACTOR * gaps["plain"]
                     * max(k1_steps, TAIL_GAP_STEPS) / TAIL_GAP_STEPS)
        print(f"[4e {tag} main f32 compensated] {n} rays x {k1_steps} x "
              f"{SUB_STEPS}, dt {dt}: init {init_s:.3f} s, run {secs:.3f} s "
              f"= {rate:.6e} ray-steps/s; {launches} K1 launches; finite "
              f"{finite}; in table {frac}; largest relative gap of the "
              f"position and k to f64 from the same root {gap:.3e} (limit "
              f"{gap_limit:.3e}); over {TAIL_GAP_STEPS} steps of "
              f"{TAIL_GAP_RAYS} rays the kernel's gap {gaps['kernel']:.3e} "
              f"and the plain version's {gaps['plain']:.3e} (factor limit "
              f"{TAIL_GAP_FACTOR})")
        if ((check_launches and launches != k1_steps * windows)
                or not finite
                or frac not in (None, 1.0)
                or not gaps["kernel"] <= TAIL_GAP_FACTOR * gaps["plain"]
                or not gap <= gap_limit):
            raise AssertionError(
                f"{tag} main path: {launches} K1 launches (expected "
                f"{k1_steps * windows}), finite {finite}, in table {frac}, "
                f"gaps {gaps}, whole run {gap} (limit {gap_limit})")

        g_steps, t_steps = (steps_grad, steps_tab) if long else (1, 1)
        sol = tail_solver(eq, disp, dt, compensated=False)
        leaves = [leaf.detach().clone().requires_grad_(True) for leaf in st]
        reset_launch_counts()
        (_, grads), secs = timed(lambda: _loss_and_grads(
            lambda: sol.run(RayState(*leaves), g_steps), leaves),
            pick=lambda o: RayState(*o[1]))
        counts = launch_counts()
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        tab_text, counts_tab, tab_ok = "the tables take none", None, True
        if reads_map(disp):
            psi = eq.psi_coeffs.clone().requires_grad_(True)
            prof = eq.profile_coeffs.clone().requires_grad_(True)
            eqt = dataclasses.replace(eq, psi_coeffs=psi,
                                      profile_coeffs=prof)
            reset_launch_counts()
            _, tab_grads = _loss_and_grads(
                lambda: tail_solver(eqt, disp, dt, compensated=False).run(
                    st, t_steps), [psi, prof])
            counts_tab = launch_counts()
            tab_ok = all(bool(torch.isfinite(g).all())
                         and float(g.abs().max()) > 0 for g in tab_grads)
            tab_text = (f"table gradients over {t_steps} steps: launches "
                        f"{counts_tab}, finite and nonzero {tab_ok}")
        print(f"[4e {tag} fwd+bwd f32 rk2] {n} rays x {g_steps} x "
              f"{SUB_STEPS}: {secs:.3f} s = "
              f"{n * g_steps * SUB_STEPS / secs:.6e} fwd+bwd ray-steps/s "
              f"(first pass); launches K1/K2/K3 {counts}; finite {finite}; "
              f"{tab_text}")
        if (check_launches and (
                counts != (g_steps * windows, g_steps * windows, 0)
                or counts_tab not in (None, (t_steps * windows, 0,
                                             t_steps * windows)))
                or not (finite and tab_ok)):
            raise AssertionError(f"{tag} gradients: launches {counts}, "
                                 f"{counts_tab}; finite {finite}, {tab_ok}")
        out[tag] = (eq, st, dt, launches, counts[1],
                    counts_tab and counts_tab[2])
    return out


def _loss_and_grads(run, wrt):
    """(endpoint loss of ``run()``, its gradients with respect to
    ``wrt``)."""
    loss = endpoint_loss(run())
    return loss, torch.autograd.grad(loss, wrt)


# -- the referee fixtures on the card ----------------------------------------
# tests/fixtures/golden_*.npz: an independent referee's trajectories
# (scipy DOP853 at rtol 1e-12 with finite-difference ray equations), as
# tests/test_reference_parity.py holds the JAX package to them and
# tests/test_torch_referee.py the port on the CPU.  Same tolerances.
REFEREE = {"golden_config1_omode_slab": (ordinary_wave, make_slab_density,
                                         1.0e-3),
           "golden_config2_xmode_slab": (extra_ordinary_wave,
                                         make_slab_density, 1.0e-3),
           "golden_config2_bohm_gross": (bohm_gross, make_gaussian_density,
                                         2.5e-4)}
# the adaptive stiff fixture: steps taken on the card (the CPU test takes
# 10; each step is a Newton loop of eager rk4 steps with their gradients,
# some 150 device operations an iteration)
REFEREE_ADAPTIVE_STEPS = 2


def referee_fixture(name):
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "tests" / "fixtures"
    return dict(np.load(path / f"{name}.npz"))


def referee_launch(gold, k, device):
    p = gold["p_launch"]
    return make_ray_state(
        p.shape[0], w=float(gold["w"]), x=torch.from_numpy(p[:, 0]),
        y=torch.from_numpy(p[:, 1]), z=torch.from_numpy(p[:, 2]),
        kx=torch.from_numpy(k[:, 0]), ky=torch.from_numpy(k[:, 1]),
        kz=torch.from_numpy(k[:, 2]), dtype=torch.float64, device=device)


def phase_referee(device):
    """Phase 18: the referee fixtures on the card, f64 CUDA tensors:
    init_k and the recorded trajectories of configs 1, 2 and 2b
    (tests/test_reference_parity.py's tolerances), and adaptive_rk4 on
    the stiff system against the analytic referee at the landed times."""
    rows = {}
    t0 = time.perf_counter()
    for name, (disp, make_eq, dt) in REFEREE.items():
        gold = referee_fixture(name)
        eq = make_eq()
        which = ("kx", "ky", "kz")[int(gold["which"])]
        st = init_k(referee_launch(gold, gold["k_guess"], device), disp, eq,
                    which, tolerance=1.0e-24, max_iterations=100)
        k = torch.stack([st.kx, st.ky, st.kz], dim=1).cpu().numpy()
        n_rec = len(gold["t_record"]) - 1
        sub = int(round(float(gold["t_record"][-1]) / n_rec / dt))
        _, traj = Solver(disp, eq, method="rk4", dt=dt,
                         sub_steps=sub).trace(
            referee_launch(gold, gold["k_init"], device), n_rec)
        ours = torch.stack(list(traj[2:]), dim=-1).transpose(0, 1).cpu()
        ref = gold["traj"]
        k_scale = float(np.abs(gold["k_init"]).max())
        init_dev = np.abs(k - gold["k_init"]) - 1e-9 * np.abs(
            gold["k_init"])
        pos_dev = np.abs(ours[..., :3].numpy() - ref[..., :3]) - 1e-6 * \
            np.abs(ref[..., :3])
        k_dev = np.abs(ours[..., 3:].numpy() - ref[..., 3:]) - 1e-6 * \
            np.abs(ref[..., 3:])
        rows[name] = {"init_k excess": float(init_dev.max() - 1e-9),
                      "position excess": float(pos_dev.max() - 1e-8),
                      "k excess": float(k_dev.max() - 2e-8 * k_scale)}
    t_traj = time.perf_counter() - t0
    gold = referee_fixture("golden_adaptive_stiff")
    sol = Solver(stiff, make_no_magnetic_field(), method="adaptive_rk4",
                 dt=1.0e-4, sub_steps=1)
    step = sol.carry_step_fn()
    carry = sol.init_carry(make_ray_state(1, w=float(gold["w"]), x=1.0,
                                          kx=1.0, dtype=torch.float64,
                                          device=device))
    ts, ref = gold["t_record"], gold["traj"][0]
    worst = {"x excess": -np.inf, "kx excess": -np.inf}
    for i in range(REFEREE_ADAPTIVE_STEPS):
        carry = step(carry)
        if i == 0:
            first_dt = float(carry.dt[0])
        s = sol.carry_state(carry)
        t = float(s.t[0])
        x_ref = float(np.interp(t, ts, ref[:, 0]))
        k_ref = float(np.interp(t, ts, ref[:, 3]))
        worst["x excess"] = max(worst["x excess"],
                                abs(float(s.x[0]) - x_ref) - 5e-8)
        worst["kx excess"] = max(worst["kx excess"], abs(
            float(s.kx[0]) - k_ref) - 1e-5 * abs(k_ref))
    worst["first dt"] = first_dt
    rows["golden_adaptive_stiff"] = worst
    print(f"[18 referee fixtures on the card, f64] deviation beyond each "
          f"tolerance (must be <= 0): {json.dumps(rows)}; init_k and "
          f"trajectories {t_traj:.1f} s, {REFEREE_ADAPTIVE_STEPS} adaptive "
          f"steps {time.perf_counter() - t0 - t_traj:.1f} s")
    bad = {k: v for k, v in rows.items()
           if any(x > 0 for key, x in v.items() if key.endswith("excess"))}
    if bad or not abs(first_dt - 1.0e-4) > 1.0e-6:
        raise AssertionError(f"referee fixtures on the card: {rows}")


def reset_launch_counts():
    efit_step.efit_window_launches = 0
    efit_step.efit_window_bwd_launches = 0
    efit_step.efit_window_bwd_tab_launches = 0


def launch_counts():
    return (efit_step.efit_window_launches,
            efit_step.efit_window_bwd_launches,
            efit_step.efit_window_bwd_tab_launches)


def phase_grad_main(device, n=100_000, steps=1000, steps_tab=100):
    """Phase b: fwd+bwd at full width through K1 and K2, twice, then table
    gradients through K3.  The first pass allocates the autograd graph's
    memory from the card (cudaMalloc, through the caching allocator); the
    second finds it cached, as every pass after the first in a training
    loop does.  Returns the launch counts of the second pass and of the
    table run."""
    eq = synthetic_equilibrium(torch.float32, device)
    root = init_k(launch(n, torch.float32, device), cold_plasma, eq)
    sol = production_solver(eq, compensated=False)
    windows = steps * (SUB_STEPS // FREEZE_EVERY)
    for attempt in ("first pass", "second pass"):
        leaves = [leaf.detach().clone().requires_grad_(True)
                  for leaf in root]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss = endpoint_loss(sol.run(RayState(*leaves), steps))
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        graph_bytes = torch.cuda.memory_allocated() - before
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        float(grads[2][0])
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        rate = n * steps * SUB_STEPS / seconds
        print(f"[b fwd+bwd f32 rk2 K={FREEZE_EVERY}, {attempt}] {n} rays x "
              f"{steps} x {SUB_STEPS}: forward {t_fwd:.3f} s, forward + "
              f"backward {seconds:.3f} s = {rate:.6e} fwd+bwd ray-steps/s; "
              f"launches K1/K2/K3 {counts}; graph holds "
              f"{graph_bytes / 1e9:.3f} GB, the allocator reserves "
              f"{torch.cuda.memory_reserved() / 1e9:.3f} GB; loss "
              f"{float(loss.detach()):.6f}; max |dL/d leaf| "
              f"{json.dumps({f: float(g.abs().max()) for f, g in zip(RayState._fields, grads)})}")
        if counts != (windows, windows, 0) or not finite:
            raise AssertionError(f"fwd+bwd: launches {counts}, finite "
                                 f"{finite}")
        del loss, grads, leaves

    psi = eq.psi_coeffs.clone().requires_grad_(True)
    prof = eq.profile_coeffs.clone().requires_grad_(True)
    eqt = dataclasses.replace(eq, psi_coeffs=psi, profile_coeffs=prof)
    reset_launch_counts()
    t0 = time.perf_counter()
    loss = endpoint_loss(production_solver(eqt, compensated=False).run(
        root, steps_tab))
    d_psi, d_prof = torch.autograd.grad(loss, [psi, prof])
    torch.cuda.synchronize()
    seconds_tab = time.perf_counter() - t0
    counts_tab = launch_counts()
    windows_tab = steps_tab * (SUB_STEPS // FREEZE_EVERY)
    ok = all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
             for g in (d_psi, d_prof))
    print(f"[b table gradients] {n} rays x {steps_tab} x {SUB_STEPS}: "
          f"{seconds_tab:.3f} s = "
          f"{n * steps_tab * SUB_STEPS / seconds_tab:.6e} fwd+bwd "
          f"ray-steps/s; launches K1/K2/K3 {counts_tab}; max |dL/dpsi| "
          f"{float(d_psi.abs().max()):.6e}, max |dL/dprof| "
          f"{float(d_prof.abs().max()):.6e}, "
          f"{int((d_psi != 0).sum())} psi and {int((d_prof != 0).sum())} "
          f"profile coefficients touched")
    if counts_tab != (windows_tab, 0, windows_tab) or not ok:
        raise AssertionError(f"table gradients: launches {counts_tab}, "
                             f"finite and nonzero {ok}")
    return counts, counts_tab


def device_split(fn, parts):
    """Run fn once under torch.profiler: the device ms of the CUDA
    operations whose names hold each of ``parts``' substrings (a dict label
    -> tuple of substrings; the first label that matches takes an
    operation) and of the others ("other"), their total, and the wall ms
    of the call."""
    events, wall_ms = cuda_events(fn)
    split = {label: 0.0 for label in (*parts, "other")}
    for e in events:
        label = next((k for k, names in parts.items()
                      if any(name in e.name for name in names)), "other")
        split[label] += e.device_time_total / 1000.0
    return split, sum(split.values()), wall_ms


def phase_config5(device, n=1_000_000, n_ref=4099, steps=CONFIG5_STEPS,
                  batches=CONFIG5_BATCHES, check_launches=True):
    """Phase b5: config 5, the gradient of the absorbed power with respect
    to the psi tables and the launch kz (bench.py run_config5), in its
    kernel form at bench's shape: n rays f32, ``steps`` recorded steps x
    CONFIG5_SUB substeps of rk4 in windows of K = 10, weak damping after
    each recorded step, in ``batches`` ray batches whose losses and
    gradients add up (models.absorbed_power.absorbed_power_grad).  First
    the referee: over n_ref rays and over the first batch (the shape each
    K1 and K3 launch of the path sees), the kernel form against the plain
    frozen form on the card (value and dL/dkz to BWD_TOL's state limit
    relative to themselves, dL/dpsi to its tables limit relative to its
    largest magnitude).  Then two passes over the n rays (the first
    allocates): K1, K2 and K3 launches (one K1 and one K3 a window, no
    K2), the value between 0 and n, finite gradients, dL/dpsi nonzero;
    fwd+bwd ray-steps/s of the second pass (bench.py:1047's definition),
    its peak memory, and one batch's device time split between K1, K3,
    the scatter into the tables and the eager rest (the weak damping and
    its double backward), with the device's busy share of a batch of the
    second pass (the device ms over that pass's seconds a batch: the
    profiler slows the host several times over).  Returns the second
    pass's launch counts, the equilibrium and the first batch's launch
    state (kz set to kz0), for the K1 and K3 lines at that batch, and
    each pass's seconds and (value, dL/dpsi, dL/dkz) on the host, which
    phase 22 holds its ranks' sums to.
    ``check_launches``: hold the launch counts (not on CPU tensors, where
    no kernel launches)."""
    sub, nb = CONFIG5_SUB, batches
    eq = synthetic_equilibrium(torch.float32, device)
    root = init_k(launch(n, torch.float32, device, **CONFIG5_LAUNCH),
                  cold_plasma, eq)
    psi, kz0 = eq.psi_coeffs, CONFIG5_KZ
    batch = absorbed_power.ray_batches(root, nb)[0]

    def grad(state, form, batches=1):
        return absorbed_power.absorbed_power_grad(
            eq, state, steps, sub, psi, kz0, form=form, batches=batches)

    tol = BWD_TOL[torch.float32]
    limits = {"value": tol["state"], "dL/dkz": tol["state"],
              "dL/dpsi": tol["tables"]}
    for part in (RayState(*[leaf[:n_ref] for leaf in root]), batch):
        t0 = time.perf_counter()
        got, want = grad(part, "kernel"), grad(part, "frozen")
        seconds = time.perf_counter() - t0
        dev = {"value": relative_deviations([got[0]], [want[0]])[0],
               "dL/dkz": relative_deviations([got[1][1]], [want[1][1]])[0],
               "dL/dpsi": relative_deviations([got[1][0]],
                                              [want[1][0]])[0]}
        print(f"[b5 config 5 referee] {part.x.shape[0]} rays, kernel form "
              f"against the plain frozen form on the card: value "
              f"{float(got[0]):.6f} / {float(want[0]):.6f}, dL/dkz "
              f"{float(got[1][1]):.6e} / {float(want[1][1]):.6e}; relative "
              f"deviations {json.dumps(dev)} (limits {json.dumps(limits)}); "
              f"both forms {seconds:.3f} s")
        if not all(dev[k] <= limits[k] for k in dev):
            raise AssertionError(f"config 5 referee at {part.x.shape[0]} "
                                 f"rays: {dev}, limits {limits}")
        del got, want

    windows = nb * steps * (sub // absorbed_power.FREEZE_EVERY)
    passes = []
    for attempt in ("first pass", "second pass"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_launch_counts()
        t0 = time.perf_counter()
        value, (g_psi, g_kz) = grad(root, "kernel", nb)
        torch.cuda.synchronize()
        float(value)
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() - before
        finite = bool(torch.isfinite(g_psi).all() and torch.isfinite(g_kz))
        rate = n * steps * sub / seconds
        print(f"[b5 config 5 kernel form, {attempt}] {n} rays f32 x {steps} "
              f"x {sub} rk4 K={absorbed_power.FREEZE_EVERY} in {nb} batches "
              f"at w {CONFIG5_LAUNCH['w']} /m, R {CONFIG5_LAUNCH['x']} m, "
              f"kz0 {kz0} /m: {seconds:.3f} s = {rate:.6e} fwd+bwd "
              f"ray-steps/s; launches K1/K2/K3 {counts} ({windows} windows); "
              f"peak memory above the inputs {peak / 1e9:.3f} GB "
              f"(max_memory_allocated); absorbed power {float(value):.3f} of "
              f"{n}; dL/dkz {float(g_kz):.6e}; max |dL/dpsi| "
              f"{float(g_psi.abs().max()):.6e}, "
              f"{int((g_psi != 0).sum())} psi coefficients touched")
        ok = ((not check_launches or counts == (windows, 0, windows))
              and finite
              and 0.0 < float(value) < n and float(g_psi.abs().max()) > 0)
        if not ok:
            raise AssertionError(
                f"config 5: launches {counts} (want {windows}, 0, "
                f"{windows}), finite {finite}, value {float(value)}")
        passes.append(dict(seconds=seconds, sums=[
            t.detach().cpu() for t in (value, g_psi, g_kz)]))
        del g_psi, g_kz

    batch_ms = 1e3 * seconds / nb
    split, total, wall = device_split(
        lambda: grad(batch, "kernel"),
        {"K1": ("efit_window_kernel",), "K3": ("efit_window_bwd_kernel",),
         "table scatter": ("table_scatter_kernel",
                           "indexing_backward_kernel")})
    print(f"[b5 config 5 where the time goes] one batch of "
          f"{batch.x.shape[0]} rays under the profiler: device ms "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})} of "
          f"{total:.3f} ms on the device ({wall:.3f} ms of wall under the "
          f"profiler); a batch of the second pass took {batch_ms:.3f} ms of "
          f"wall, so the device is busy {total / batch_ms:.4f} of it; the "
          f"table scatter is the transpose of every table gather: K3's "
          f"block cotangents (scatter_block_cotangents) and the weak "
          f"damping's gathers'; other is the eager weak damping, its double "
          f"backward, dl and the loss")
    return (counts, eq, batch._replace(kz=torch.full_like(batch.kz, kz0)),
            passes)


# -- the spline tables' gradient scatter (phase b7) --------------------------
# csrc/table_scatter.cu against the plain version on the CPU in float64, per
# cell relative to the sum of its rows' magnitudes, in units of the working
# type's eps: the kernel's chain of roundings (a five-level tree in the warp,
# a block's shared adds, then one global atomic a block: some 300 at most on
# 132 SMs) puts its worst case near 300, its typical error near 10.  A row
# dropped or added twice shows 1 / (rows of the cell) of the cell's scale:
# above 1e-5 here, 300 eps in f32; so integer-valued rows (|value| <= 8,
# every partial sum exact in f32 whatever its order) are held to the plain
# version exactly as well.
TABLE_SCATTER_EPS = 256


def config5_scatter_calls(device, n=125_000, steps=CONFIG5_STEPS):
    """The table scatters of one config-5 batch of n rays in its kernel
    form (``steps`` recorded steps): each call's (rows, cells, table rows),
    recorded where ``ops.tables`` calls the wrapper, in the order the
    backward makes them."""
    eq = synthetic_equilibrium(torch.float32, device)
    root = init_k(launch(n, torch.float32, device, **CONFIG5_LAUNCH),
                  cold_plasma, eq)
    calls = []

    def record(grad, idx, cells):
        calls.append((grad.detach().clone(), idx.clone(), cells))
        return table_scatter.table_scatter(grad, idx, cells)

    with mock.patch.object(ops_tables, "table_scatter", record):
        absorbed_power.absorbed_power_grad(
            eq, root, steps, CONFIG5_SUB, eq.psi_coeffs, CONFIG5_KZ,
            form="kernel")
    return calls


def check_table_scatter(grad, idx, cells, seed=SEED):
    """The kernel against the plain version on the CPU: (the largest
    deviation of a cell over eps times its scale, whether integer-valued
    rows came out exact)."""
    got = table_scatter.table_scatter(grad, idx, cells)
    g64, i64 = grad.detach().double().cpu(), idx.cpu()
    want = table_scatter.table_scatter_plain(g64, i64, cells)
    scale = table_scatter.table_scatter_plain(g64.abs(), i64, cells)
    eps = torch.finfo(grad.dtype).eps
    dev = (got.double().cpu() - want).abs() / (eps * scale)
    ratio = float(torch.nan_to_num(dev, nan=0.0).max())
    rng = torch.Generator(device=grad.device).manual_seed(seed)
    ints = torch.randint(-8, 9, grad.shape, generator=rng,
                         device=grad.device).to(grad.dtype)
    exact = torch.equal(
        table_scatter.table_scatter(ints, idx, cells).cpu(),
        table_scatter.table_scatter_plain(ints.cpu(), i64, cells))
    return ratio, exact


def table_scatter_bound(n, width, cells, dtype):
    """(bound ms, bound by, bytes): an addition a row's value, against the
    rows and the index read once and the table gradient zeroed and written
    once (:func:`bound`)."""
    size = torch.finfo(dtype).bits // 8
    nbytes = n * width * size + n * 8 + 2 * cells * width * size
    return (*bound(n * width, nbytes, dtype), nbytes)


def phase_table_scatter(device, n=125_000, steps=CONFIG5_STEPS):
    """Phase b7: the spline tables' gradient scatter (csrc/table_scatter.cu,
    the transpose of ``ops.tables.gather_rows``).  The real calls of one
    config-5 batch of n rays (the weak damping's psi gathers, two a recorded
    step) and, with their rows, uniform cells over the whole table and
    ragged row counts: the kernel against the plain version on the CPU in
    f32 and f64 (TABLE_SCATTER_EPS; integer rows exact); then its time at
    the batch's real calls and at uniform cells, by CUDA events (wrapper and
    its zeroed output) and on the device (the profiler), against its bound
    (bytes) and against the library's ``index_put_`` with accumulate
    (``library_ms``, the port's path before the kernel, which it no longer
    calls).  Returns the kernel's record for the kernel table."""
    before = table_scatter.table_scatter_launches
    calls = config5_scatter_calls(device, n, steps)
    launched = table_scatter.table_scatter_launches - before
    # and K3's two a window: its psi and profile block cotangents
    k3_scatters = 2 * steps * CONFIG5_SUB // absorbed_power.FREEZE_EVERY
    if len(calls) != 2 * steps or launched != len(calls) + k3_scatters:
        raise AssertionError(f"b7: {len(calls)} table scatters recorded at "
                             f"the gathers and {launched} launched in a "
                             f"batch; want {2 * steps} and "
                             f"{2 * steps + k3_scatters}")
    distinct = [int(torch.unique(idx).numel()) for _, idx, _ in calls]
    largest = [int(torch.bincount(idx).max()) for _, idx, _ in calls]
    grad, idx, cells = calls[len(calls) // 2]
    width = grad.shape[1]
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    uniform = torch.randint(0, cells, idx.shape, generator=gen,
                            device=device)
    cases = {f"call {k}": (g, i) for k, (g, i, _) in enumerate(calls)}
    cases.update({"uniform": (grad, uniform),
                  "ragged 4099": (grad[:4099], idx[:4099]),
                  "ragged 1": (grad[:1], idx[:1]),
                  "one cell": (grad, torch.full_like(idx, int(idx[0])))})
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for name, (g, i) in cases.items():
            ratio, exact = check_table_scatter(g.to(dtype), i, cells)
            key = f"{'f32' if dtype == torch.float32 else 'f64'} {name}"
            worst[key] = round(ratio, 3)
            if not exact or not ratio <= TABLE_SCATTER_EPS:
                raise AssertionError(f"b7 table scatter {key}: {ratio} eps "
                                     f"of the cell's scale (limit "
                                     f"{TABLE_SCATTER_EPS}), integer rows "
                                     f"exact {exact}")
    print(f"[b7 table scatter check] a batch of {n} rays f32: {len(calls)} "
          f"scatters of ({grad.shape[0]}, {width}) rows into {cells} cells, "
          f"distinct cells a call {distinct}, the largest cell's rows "
          f"{largest}; largest deviation in eps of the cell's scale "
          f"(limit {TABLE_SCATTER_EPS}) {json.dumps(worst)}; integer rows "
          f"exact in every case")

    times = {}
    for name, i in (("config 5", idx), ("uniform", uniform)):
        ms = event_ms(lambda: table_scatter.table_scatter(grad, i, cells), 50)
        dev_ms, _, _ = profile_kernel(
            lambda: [table_scatter.table_scatter(grad, i, cells)
                     for _ in range(10)], kernel=("table_scatter_kernel",))
        lib_ms = event_ms(lambda: torch.zeros(
            (cells, width), dtype=grad.dtype, device=device).index_put_(
                (i,), grad, accumulate=True), 3)
        times[name] = dict(ms=ms, device_ms=dev_ms, library_ms=lib_ms)
    g_cpu, i_cpu = grad.cpu(), idx.cpu()
    t0 = time.perf_counter()
    table_scatter.table_scatter_plain(g_cpu, i_cpu, cells)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    b_ms, b_by, nbytes = table_scatter_bound(grad.shape[0], width, cells,
                                             grad.dtype)
    print(f"[b7 table scatter time] ({grad.shape[0]}, {width}) f32 rows into "
          f"{cells} cells: {json.dumps(times)} (ms a call: CUDA events, the "
          f"zeroed output included; the kernel on the device; the library's "
          f"index_put_ with accumulate); bound {b_ms:.6f} ms ({b_by}, "
          f"{nbytes} B); plain version on the host's CPU {plain_ms:.3f} ms")
    return {"name": "table_scatter", "route": "cuda",
            "source": "graph_framework_tpu_torch/csrc/table_scatter.cu",
            "replaces": None, "launches": launched,
            "max_eps_of_scale": max(worst.values()),
            "ms": times["config 5"]["ms"],
            "device_ms": times["config 5"]["device_ms"],
            "uniform": times["uniform"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": times["config 5"]["library_ms"]}


def phase_remat_policy(device, n=100_000, steps=2):
    """Phase b6: Solver(remat_policy=...) at phase b's width (100k rays
    f32, rk2, frozen windows of K = 10) over ``steps`` recorded steps of
    the plain frozen path with ``remat_substeps`` (the window kernel
    recomputes inside its backward and takes no remat): the gradient of
    the endpoint loss with respect to the launch state, with the policy
    None (recompute each window) and "spline_jet" (keep the spline
    gathers' blocks), in turns None, spline_jet, spline_jet, None; the
    seconds and peak memory of each pass, and the gradients of the two
    policies against each other (1e-6 of each leaf's scale), after one
    untimed pass that warms the allocator."""
    eq = synthetic_equilibrium(torch.float32, device)
    root = init_k(launch(n, torch.float32, device), cold_plasma, eq)
    rows, grads = [], {}
    for policy in ("warm-up", None, "spline_jet", "spline_jet", None):
        sol = Solver(cold_plasma, eq, method="rk2", dt=DT,
                     sub_steps=SUB_STEPS, frozen_cells=True,
                     freeze_every=FREEZE_EVERY, remat_substeps=True,
                     remat_policy=None if policy == "warm-up" else policy)
        leaves = [leaf.detach().clone().requires_grad_(True)
                  for leaf in root]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        g = torch.autograd.grad(endpoint_loss(sol.run(RayState(*leaves),
                                                      steps)), leaves,
                                allow_unused=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if policy == "warm-up":
            continue
        rows.append({"policy": policy, "seconds": seconds,
                     "fwd+bwd ray-steps/s": n * steps * SUB_STEPS / seconds,
                     "peak GB": (torch.cuda.max_memory_allocated()
                                 - before) / 1e9})
        grads[policy] = [torch.zeros_like(a) if d is None else d
                         for a, d in zip(leaves, g)]
    dev = max(relative_deviations(grads["spline_jet"], grads[None]))
    print(f"[b6 remat_policy] {n} rays f32 x {steps} x {SUB_STEPS} rk2, "
          f"frozen K={FREEZE_EVERY}, remat_substeps, plain torch: "
          f"{json.dumps(rows)}; gradients spline_jet vs None: {dev:.3e} "
          f"(limit 1e-6)")
    if not dev <= 1e-6:
        raise AssertionError(f"remat_policy: spline_jet's gradients "
                             f"deviate {dev} from None's")
    return rows


def phase_grad_fd(device, n=256, steps=20):
    """Phase c: d(endpoint loss) through init_k and the kernels, along
    the gradient, against central differences (f64).

    A frozen-window trace is only piecewise smooth in the launch: a ray
    whose window base crosses a cell boundary switches to the neighbouring
    cell's polynomial, a jump far below the rounding of one step but
    present in every difference quotient.  On the CPU, over these 256 rays
    the quotient lies 2.7e-6 (20 recorded steps) and 6.3e-6 (50) from the
    gradient for any step from 1e-4 to 3e-3, while the same trace without
    frozen cells agrees to 3.5e-8: the trace is kept at 20 recorded
    steps."""
    eq = synthetic_equilibrium(torch.float64, device)
    start = launch(n, torch.float64, device, seed=SEED + 3)

    def loss(st, e):
        root = init_k(st, cold_plasma, e)
        return endpoint_loss(production_solver(e, compensated=False).run(
            root, steps))

    def loss_launch(x, ky):
        return loss(start._replace(x=x, ky=ky), eq)

    def loss_psi(psi):
        return loss(start, dataclasses.replace(eq, psi_coeffs=psi))

    rows = {}
    x = start.x.clone().requires_grad_(True)
    ky = start.ky.clone().requires_grad_(True)
    reset_launch_counts()
    g = torch.autograd.grad(loss_launch(x, ky), [x, ky])
    counts = launch_counts()
    norm = float(torch.sqrt(sum((a * a).sum() for a in g)))
    v = [a / norm for a in g]
    h = FD_STEP["launch"]
    with torch.no_grad():
        fd = (loss_launch(start.x + h * v[0], start.ky + h * v[1])
              - loss_launch(start.x - h * v[0], start.ky - h * v[1])) / (2 * h)
    rows["launch (x, ky)"] = {"grad": norm, "fd": float(fd)}

    psi = eq.psi_coeffs.clone().requires_grad_(True)
    (gp,) = torch.autograd.grad(loss_psi(psi), [psi])
    norm = float(gp.norm())
    v = gp / norm
    h = FD_STEP["psi_coeffs"]
    with torch.no_grad():
        fd = (loss_psi(eq.psi_coeffs + h * v)
              - loss_psi(eq.psi_coeffs - h * v)) / (2 * h)
    rows["psi_coeffs"] = {"grad": norm, "fd": float(fd)}
    for row in rows.values():
        row["rel"] = abs(row["grad"] - row["fd"]) / abs(row["fd"])
    print(f"[c gradient vs central differences, f64, {n} rays x {steps} x "
          f"{SUB_STEPS}, through init_k] directional derivative along the "
          f"gradient: {json.dumps(rows)}, rtol {FD_RTOL}; launches "
          f"K1/K2/K3 of the launch gradient {counts}")
    windows = steps * (SUB_STEPS // FREEZE_EVERY)
    bad = {k: r for k, r in rows.items() if not r["rel"] <= FD_RTOL}
    if bad or counts != (windows, windows, 0):
        raise AssertionError(f"gradient vs central differences: {rows}, "
                             f"launches {counts}")


def run_main(eq, state, steps, compensated):
    """Solver.run of the production stack over ``steps`` recorded steps,
    timed; checks the launch count.  Returns (final, carry, rate)."""
    sol = production_solver(eq, compensated=compensated)
    efit_step.efit_window_launches = 0
    (final, carry), seconds = timed(
        lambda: sol.run(state, steps, return_carry=True),
        pick=lambda out: out[0])
    launches = efit_step.efit_window_launches
    expected = steps * (SUB_STEPS // FREEZE_EVERY)
    if launches != expected:
        raise AssertionError(f"{launches} window launches, expected "
                             f"{expected}")
    rate = state.x.shape[0] * steps * SUB_STEPS / seconds
    return final, carry, rate, seconds, launches


def check_rays(label, final, eq, n):
    ok = in_domain(final, eq)
    frac = float(ok.double().mean())
    res = float(residual_fn(cold_plasma, eq)(final).max())
    if frac != 1.0 or not np.isfinite(res):
        raise AssertionError(f"{label}: {frac} of {n} rays finite and in "
                             f"the table; max D^2 {res}")
    return frac, res


def phase_main(device, n=100_000, steps=1000, n_big=1_000_000,
               steps_big=100):
    out = {}
    eq32 = synthetic_equilibrium(torch.float32, device)
    eq64 = synthetic_equilibrium(torch.float64, device)
    st32, init_s = timed(
        lambda: init_k(launch(n, torch.float32, device), cold_plasma, eq32))
    final32, carry32, rate, secs, launches = run_main(eq32, st32, steps,
                                                      True)
    out["launches"] = launches
    frac, res = check_rays("f32", final32, eq32, n)
    print(f"[4a main f32 compensated] {n} rays x {steps} x {SUB_STEPS}: "
          f"init_k {init_s:.3f} s, run {secs:.3f} s = {rate:.6e} "
          f"ray-steps/s; {launches} launches; in table {frac}; "
          f"max D^2 {res:.3e}")
    out["rate_f32"] = rate

    st64 = init_k(launch(n, torch.float64, device), cold_plasma, eq64)
    final64, _, rate64, secs64, launches64 = run_main(eq64, st64, steps,
                                                      False)
    frac64, res64 = check_rays("f64", final64, eq64, n)
    # the gap to f64 from f64's own Newton root, and from f32's root
    # promoted (the integration alone)
    same = RayState(*[leaf.double() for leaf in st32])
    final64s = production_solver(eq64, compensated=False).run(same, steps)
    uncomp32 = production_solver(eq32, compensated=False).run(st32, steps)
    gaps = {label: max(leaf_errors(comp_state_f64(carry32), ref).values())
            for label, ref in (("own root", final64), ("f32 root", final64s))}
    gaps["uncompensated f32, f32 root"] = max(
        leaf_errors(uncomp32, final64s).values())
    print(f"[4b main f64 plain] run {secs64:.3f} s = {rate64:.6e} "
          f"ray-steps/s; {launches64} launches; in table {frac64}; max "
          f"D^2 {res64:.3e}; largest relative gap to f64 {json.dumps(gaps)}"
          f", limits {json.dumps(GAP_TOL)}")
    if not (all(gaps[label] <= limit for label, limit in GAP_TOL.items())
            and gaps["uncompensated f32, f32 root"]
            >= SEPARATION * GAP_TOL["f32 root"]):
        raise AssertionError(f"compensated f32 vs f64: {gaps}")

    n1m, steps1m = n_big, steps_big
    st1m, diag1m = init_k(launch(n1m, torch.float32, device), cold_plasma,
                          eq32, return_diagnostics=True)
    final1m, _, rate1m, secs1m, launches1m = run_main(eq32, st1m, steps1m,
                                                      True)
    frac1m, res1m = check_rays("1M", final1m, eq32, n1m)
    print(f"[4c main 1M f32 compensated] {n1m} rays x {steps1m} x "
          f"{SUB_STEPS}: init_k {diag1m.iterations} iterations, run "
          f"{secs1m:.3f} s = {rate1m:.6e} ray-steps/s; {launches1m} "
          f"launches; in table {frac1m}; max D^2 {res1m:.3e}")
    # phase 22 holds the ranks' rows to these, bit for bit
    out["one_process"] = dict(
        rows=RayState(*[leaf.cpu() for leaf in final1m]),
        iterations=diag1m.iterations, seconds=secs1m)
    return out, eq32, st32


def phase_segmented(eq, state, steps=32):
    rows = []
    sol = production_solver(eq)
    final = sol.trace_segmented(state, steps, lambda i, row: rows.append(
        (i, row)))
    if [i for i, _ in rows] != list(range(steps + 1)):
        raise AssertionError(f"trace_segmented wrote {len(rows)} rows")
    finite = all(bool(torch.isfinite(l).all()) for _, row in rows
                 for l in row)
    if not finite or rows[-1][1].x.device.type != "cpu":
        raise AssertionError("trace_segmented rows not finite host rows")
    if not torch.equal(rows[-1][1].x, final.x.cpu()):
        raise AssertionError("last row is not the final state")
    print(f"[5 trace_segmented] {len(rows)} rows of {state.x.shape[0]} "
          f"rays, all finite")


def phase_plain_timing(eq, state, kernel_rate, steps=2):
    sol = production_solver(eq, window_kernel=False)
    _, seconds = timed(lambda: sol.run(state, steps))
    rate = state.x.shape[0] * steps * SUB_STEPS / seconds
    print(f"[6 plain version] {state.x.shape[0]} rays x {steps} x "
          f"{SUB_STEPS}: {rate:.6e} ray-steps/s (kernel {kernel_rate:.6e},"
          f" x{kernel_rate / rate:.1f})")


#: Every dispersion of the window kernels but cold plasma, by its tag.
KERNEL_TAGS = {**MODES, **TAILS}


def kernel_record(eq, state, launches, mode="", dt=DT, busy=True,
                  method="rk2", compensated=True, label=""):
    """The kernel line of K1 for the dispersion of ``mode`` ("": cold
    plasma, or a key of KERNEL_TAGS) at its step ``dt``: kernel vs plain on
    one window of a path (the main path's: 100k rays, f32 compensated rk2,
    K = 10; config 5's: a batch, f32 plain rk4, ``label`` " rk4"), error
    and milliseconds of each; with ``busy``, also the kernel's busy share
    of 50 recorded steps of Solver.run."""
    disp = KERNEL_TAGS.get(mode, cold_plasma)
    tag = f" {mode}" if mode else ""
    variant = (f"f32 {'compensated' if compensated else 'plain'} {method} "
               f"K={FREEZE_EVERY}")
    carry = init_comp_carry(state) if compensated else state
    kern = run_windows(eq, carry, method, FREEZE_EVERY, compensated, True,
                       disp, dt)
    plain = run_windows(eq, carry, method, FREEZE_EVERY, compensated, False,
                        disp, dt)
    err = max(d for f, d in leaf_deviations(kern, plain).items()
              if f not in ("t", "w"))
    rel = max(leaf_errors(kern, plain).values())
    if not rel <= TAIL_TOL.get((mode, torch.float32, compensated),
                               TOL[torch.float32, compensated]):
        raise AssertionError(f"window{tag}{label} ({variant}): kernel vs "
                             f"plain {rel}")

    def kern_call():
        return efit_step.efit_window(eq, carry, method=method, dt=dt,
                                     steps=FREEZE_EVERY,
                                     compensated=compensated,
                                     dispersion=disp)

    def plain_call():
        return efit_step.frozen_window(eq, disp, carry, method=method,
                                       dt=dt, steps=FREEZE_EVERY,
                                       compensated=compensated)

    ms = event_ms(kern_call, 20)
    plain_ms = event_ms(plain_call, 3)
    kernel_ms, _, _ = profile_kernel(
        lambda: [kern_call() for _ in range(20)])
    share_text = ""
    if busy:
        sol = production_solver(eq, dispersion=disp)
        launch_ms, seen, wall_ms = profile_kernel(lambda: sol.run(state, 50))
        busy_ms = None if launch_ms is None else launch_ms * seen
        share = None if busy_ms is None else busy_ms / wall_ms
        share_text = (f"; over 50 recorded steps of Solver.run the kernel "
                      f"is busy {busy_ms} of {wall_ms:.3f} device ms (share "
                      f"{share})")
    print(f"[7{tag}{label} kernel time] {state.x.shape[0]} rays, "
          f"{variant}: {ms:.4f} ms per window call (CUDA events, wrapper "
          f"included); kernel on the device {kernel_ms} ms (profiler); "
          f"plain version {plain_ms:.4f} ms per window; max abs error "
          f"{err:.3e}, worst relative leaf deviation {rel:.3e}{share_text}")
    b_ms, b_by, basis = window_bound(
        eq, state.x.shape[0],
        f"K1{tag} {method} {'comp' if compensated else 'plain'}")
    print(f"[7 efit_window{tag}{label} bound] {b_ms:.4f} ms, by {b_by} "
          f"({basis})")
    source = (f"graph_framework_tpu_torch/csrc/efit_window_{mode}.cu"
              if mode else "graph_framework_tpu_torch/csrc/efit_window.cu")
    return {"name": f"efit_window{tag}{label}", "route": "cuda",
            "source": source,
            "replaces": "graph_framework_tpu/pallas/efit_step.py:159",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def bwd_kernel_records(eq, state, launches, launches_tab, mode="",
                       dt=DT, method="rk2", label="", referee=None):
    """The K2 and K3 lines (phase d) for the dispersion of ``mode`` (as
    kernel_record; no K3 line for a tail that reads no table, and no K2
    line when ``launches`` is None): each backward kernel against its
    plain version on one window of a path (the main path's: 100k rays,
    f32 plain rk2, K = 10; config 5's: a batch, rk4, ``label`` " rk4"),
    from seeded cotangents, held to BWD_TOL as phase 3a holds them, or,
    given ``referee`` (the equilibrium in f64), to the plain version in
    f64 on the same inputs at BWD_REFEREE_FACTOR times the f32 plain
    version's own distance to it: absolute error and milliseconds, by
    CUDA events per wrapper call and by the profiler on the device."""
    ct = random_cotangent(state, SEED + 4)
    tag = f" {mode}" if mode else ""
    disp = KERNEL_TAGS.get(mode, cold_plasma)
    kw = dict(method=method, dt=dt, steps=FREEZE_EVERY, dispersion=disp)
    tol = BWD_TOL[state.x.dtype]
    records = []
    kernels = ((False, "efit_window_bwd", 260, launches,
                efit_step.frozen_window_vjp),
               (True, "efit_window_bwd_tab", 318, launches_tab,
                efit_step.frozen_window_vjp_blocks))[:1 + reads_map(disp)]
    for tables, name, line, count, plain in kernels:
        if count is None:
            continue
        def kern_call():
            return efit_step.efit_window_vjp(eq, state, ct, tables=tables,
                                             **kw)

        def plain_call():
            return plain(eq, state, ct, **kw)

        def parts(out):
            """The cotangents by BWD_TOL's parts: state (, tables)."""
            state = list(out if isinstance(out, RayState) else out.state)
            if not tables:
                return {"state": state}
            return {"state": state,
                    "tables": [out.psi_block, out.prof_block]}

        def deviations(a, b):
            return {part: max(relative_deviations(a[part], b[part]))
                    for part in a}

        got, want = kern_call(), plain_call()
        dev = deviations(parts(got), parts(want))
        limits, f64 = tol, ""
        if referee is not None:
            ref = parts(plain(referee, RayState(*[a.double() for a in state]),
                              RayState(*[a.double() for a in ct]), **kw))
            own = deviations(parts(want), ref)
            dev = deviations(parts(got), ref)
            limits = {part: BWD_REFEREE_FACTOR * own[part] for part in own}
            f64 = (f" against the plain version in f64 (the f32 plain "
                   f"version's own deviations {own})")
        pairs = [pair for part in parts(got)
                 for pair in zip(parts(got)[part], parts(want)[part])]
        if tables and not (torch.equal(got.psi_cell, want.psi_cell)
                           and torch.equal(got.prof_cell, want.prof_cell)):
            raise AssertionError(f"{name}: cells differ from the plain "
                                 f"version's")
        if not all(dev[part] <= limits[part] for part in dev):
            raise AssertionError(f"window {name}{tag}{label}: kernel "
                                 f"{dev}{f64}, limits {limits}")
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in pairs)
        ms = event_ms(kern_call, 10)
        plain_ms = event_ms(plain_call, 2)
        kernel_ms, _, _ = profile_kernel(
            lambda: [kern_call() for _ in range(10)],
            kernel=("efit_window_bwd_kernel",))
        scatter = ""
        if tables:
            # EfitWindow's backward adds K3's blocks into the tables after
            # the kernel: two table scatter launches
            scatter_ms = event_ms(
                lambda: efit_step.scatter_block_cotangents(eq, got), 10)
            scatter = (f"; the scatter into the tables "
                       f"(scatter_block_cotangents) {scatter_ms:.4f} ms "
                       f"apart (CUDA events)")
        print(f"[7 {name}{tag}{label} time] {state.x.shape[0]} rays, f32 "
              f"{method} K={FREEZE_EVERY}: {ms:.4f} ms per window call (CUDA "
              f"events, wrapper included); kernel on the device "
              f"{kernel_ms} ms (profiler); plain version "
              f"(autograd of frozen_window) {plain_ms:.4f} ms; max abs "
              f"error {err:.3e}; relative deviations {dev}{f64} (limits "
              f"{limits}){scatter}")
        b_ms, b_by, basis = window_bound(
            eq, state.x.shape[0],
            f"{'K3' if tables else 'K2'}{tag} {method}")
        print(f"[7 {name}{tag}{label} bound] {b_ms:.4f} ms, by {b_by} "
              f"({basis})")
        records.append({
            "name": f"{name}{tag}{label}", "route": "cuda",
            "source": "graph_framework_tpu_torch/csrc/efit_window_bwd.cuh",
            "replaces": f"graph_framework_tpu/pallas/efit_step.py:{line}",
            "launches": count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    return records


# -- the particle paths: K5 (slab push) and K6 (deposit) ----------------------
# bench.py's korc configuration (bench.py:393-412): the slab field of
# make_slab, b0 = b1 = 1, b_shear 0.1, larmor 1, dt 0.5; 100 steps a launch.
SLAB = dict(dt=0.5, b0=1.0, b1=1.0, b_shear=0.1, larmor=1.0)
SLAB_STEPS = 100
# K5 against its plain version over one 100-step launch of 100 003
# particles: per leaf, max |kernel - plain| over that leaf's max |plain|.
# The kernel folds b_shear / b0 and b1 / b0 in double, takes 1/gamma and
# 1/gamma' as reciprocal square roots, and keeps u_z (csrc/boris.cu); in
# f32 these are the card's approximations rsqrt.approx (relative error
# below 2^-22.9) and rcp.approx (1 ulp), with no Newton step.  Why none is
# needed: an error d in 1/gamma' turns each step's rotation, about 0.17
# rad in this ensemble (gamma up to 3.3), by a relative d, so 100 steps
# move the gyro phase by at most 100 x 0.17 x 1.4e-7 = 2.4e-6 rad and
# the leaves by about that relative amount - 200x below the f32 limit;
# an error in 1/gamma changes h, and so u', by the same relative 1.4e-7 a
# step.  The rest is rounding in another order, which the first form
# (the plain version's algebra with FMA contraction) read at 2.4e-5 in f32
# and 4.1e-14 in f64, and this form at 3.4e-5 / 4.3e-14 (NVIDIA H100 80GB
# HBM3, 700.00 W; its host build 2.0e-5 / 3.4e-14,
# tests/test_torch_kernels_host.py).  A
# kernel one step short shows 0.18 (asserted SEPARATION above the limit).
# Gamma carried from the launch's start instead of recovered is no wrong
# kernel here: gamma is invariant in a pure magnetic field, so it changes
# only the rounding (read 2.1e-5 in f32, 4.1e-14 in f64) and is reported,
# not asserted.
K5_TOL = {torch.float32: 5.0e-4, torch.float64: 1.0e-12}
# K6 against its plain version (100 003 particles, G 1000 and 1001, a mask
# with zeros): n and e, each relative to its max.  n: the kernel sums only
# the pairs within reach, every other term being exactly +0 in the working
# type (kernels/deposit.py REACH), so the two differ by the order of the
# sums alone.  e: the kernel takes coef (S1 - g S0) from S0 = sum m and
# S1 = sum x m where the plain version sums coef (x - g) m over the pairs.
# S0 of unit weights is exact in f32 up to 2^24 particles; S1 (|S1| <=
# sum |x| m) and g S0 each round once relative to max |e| ~ coef max|g| S0,
# and the difference and the product by coef once more: a few ulp of
# max |e|, as the plain version's own sums of 1e5 terms.  Read on the
# card (NVIDIA H100 80GB HBM3, 700.00 W) by the two-pass kernel that
# summed every pair: f32 5.7e-7, f64 7.9e-16; by the kernel over the pairs
# within reach: 2.8e-7 to 4.7e-7, 8.7e-16 to 1.1e-15.  A deposit that
# drops the ragged last chunk shows 1.0e-2, one that ignores the mask
# 0.12, and one whose points sum only their own bin's particles (bins of
# the reach's width) 0.39-0.46: each asserted SEPARATION above the limit.
K6_TOL = {torch.float32: 1.0e-5, torch.float64: 1.5e-14}
# xpic at full width, the kernel's 50 steps against the plain deposit's
# from the same start, per leaf relative to its max: f32 sums of 1M terms
# in another order (read 5.5e-7; the positions barely move at dt 1e-14,
# so the difference does not grow).
PIC_TOL = 1.0e-5
# Operations per ray and window of FREEZE_EVERY substeps of the window
# kernels on the main path (rk2) and on config 5's (rk4), counted over the
# kernels' own source by graph_framework_tpu_torch/tools/count_ops.py
# (tests/test_torch_common.py holds these to it).  Each counts what the function needs, each operation
# once: K1's source does just that (the freeze, the stages with D's gradient
# by the hand-written reverse sweep, the compensation: 8812 a ray; its
# forward-mode form did 44 892), and K2's and K3's take each stage's
# gradient three times (38 065 / 41 385 a ray).
WINDOW_OPS = {"K1 rk2 comp": 8812, "K2 rk2": 22892, "K3 rk2": 26212,
              "K1 omode rk2 comp": 6252, "K2 omode rk2": 15172,
              "K3 omode rk2": 18172, "K1 xmode rk2 comp": 6712,
              "K2 xmode rk2": 16552, "K3 xmode rk2": 19552,
              "K1 expansion rk2 comp": 8332, "K2 expansion rk2": 21212,
              "K3 expansion rk2": 24212, "K1 bohm rk2 comp": 6152,
              "K2 bohm rk2": 14352, "K3 bohm rk2": 17672,
              "K1 light rk2 comp": 5152, "K2 light rk2": 11252,
              "K3 light rk2": 14252, "K1 ioncyc rk2 comp": 7112,
              "K2 ioncyc rk2": 17032, "K3 ioncyc rk2": 20672,
              "K1 acoustic rk2 comp": 6752, "K2 acoustic rk2": 15932,
              "K3 acoustic rk2": 19572, "K1 simple rk2 comp": 1260,
              "K2 simple rk2": 2210, "K1 gwell rk2 comp": 1440,
              "K2 gwell rk2": 2790, "K1 stiff rk2 comp": 1050,
              "K2 stiff rk2": 1400,
              # config 5's windows: plain rk4, cold plasma
              "K1 rk4 plain": 16702, "K3 rk4": 52742}
# Peak rates of one H100 SXM (NVIDIA's data sheet): f32 and f64 outside the
# tensor cores, and the HBM rate.  bound_ms is the larger of ops / peak and
# bytes / rate.
PEAK_OPS = {torch.float32: 67.0e12, torch.float64: 34.0e12}
PEAK_BYTES = 3.35e12


def bound(ops, nbytes, dtype):
    """(bound_ms, bound_by) of work that does ``ops`` operations of
    ``dtype`` and must move ``nbytes``."""
    t_ops = 1e3 * ops / PEAK_OPS[dtype]
    t_bytes = 1e3 * nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def window_bound(eq, n, kernel):
    """One f32 window of ``kernel`` (a key of WINDOW_OPS: "K1 rk2 comp",
    "K2 omode rk2", ...; a tail that reads no table has no K3) over n
    rays: WINDOW_OPS a ray; the bytes of the state leaves in and out (8 in
    and 8 out for K1, and as many low words when compensated; 8 in, 8
    cotangents in and 8 out for K2; and K3's 32 block cotangents and 2
    cell rows a ray), and the two tables read once (none for a tail that
    reads no table).  Returns (bound_ms, bound_by, both sides as text)."""
    size = 4
    per_ray = {"K1": 16 * size, "K2": 24 * size,
               "K3": 56 * size + 16}[kernel[:2]]
    if kernel.endswith(" comp"):
        per_ray += 16 * size
    tag = kernel.split()[1]
    tables = size * (eq.psi_coeffs.numel() + eq.profile_coeffs.numel())
    if tag in TAILS and not reads_map(TAILS[tag]):
        tables = 0
    ops, nbytes = WINDOW_OPS[kernel] * n, per_ray * n + tables
    return (*bound(ops, nbytes, torch.float32),
            f"{WINDOW_OPS[kernel]} operations a ray and window: "
            f"{bound_sides(ops, nbytes)}")


def slab_bound(n, dtype, steps=SLAB_STEPS):
    """One slab push launch: SLAB_PUSH_OPS a particle-step; the six state
    arrays read once and written once."""
    size = torch.finfo(dtype).bits // 8
    return bound(boris.SLAB_PUSH_OPS * n * steps, 12 * n * size, dtype)


def mufu_floor_ms(n, steps, mufu_per_step):
    """The special-function unit's floor of a slab push launch: n x steps x
    mufu_per_step MUFU instructions at 16 a clock on each SM (the CUDA
    programming guide's throughput table, compute capability 9.0), at the
    card's largest SM clock (``nvidia-smi``): (ms, clock MHz)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * n * steps * mufu_per_step / (sms * 16 * mhz * 1e6), mhz


def pairs_in_reach(x, mask, grid, width=WIDTH):
    """The (particle, grid point) pairs whose term exp(dx^2 / -w) m is not
    +0 in the working type: |dx| below sqrt(EXP_UNDERFLOW w), m nonzero.
    Counted over the sorted positions (measuring code, not the kernel)."""
    xs = torch.sort(x[mask != 0])[0]
    r = float(np.sqrt(k6.EXP_UNDERFLOW[x.dtype] * width))
    inside = (torch.searchsorted(xs, grid + r, right=True)
              - torch.searchsorted(xs, grid - r, right=False))
    return int(inside.sum())


def deposit_bound(x, mask, grid, width=WIDTH):
    """One deposit as the function needs it: DEPOSIT_OPS a pair within
    reach (this run's positions), a particle (e's two sums and its bin)
    and a grid point (e); the bytes of x and the mask read, the binned
    copy of the particles within the kernels' range written and read, the
    grid read, n and e written.  Returns (bound_ms, bound_by, basis)."""
    p, g, dtype = x.shape[0], grid.shape[0], x.dtype
    size = torch.finfo(dtype).bits // 8
    pairs = pairs_in_reach(x, mask, grid, width)
    r = k6.reach(width, dtype)
    binned = int(((x >= grid.min() - r) & (x <= grid.max() + r)).sum())
    ops_of = k6.DEPOSIT_OPS
    ops = (ops_of["per_pair"] * pairs + ops_of["per_particle"] * p
           + ops_of["per_point"] * g)
    nbytes = (2 * p + 4 * binned + 3 * g) * size
    basis = (f"{pairs} pairs within reach ({pairs / (p * g):.4f} of P x "
             f"G), {binned} particles binned; {bound_sides(ops, nbytes, dtype)}")
    return (*bound(ops, nbytes, dtype), basis)


def particle_ensemble(n, dtype, device, seed):
    """n particles (the six leaves of the slab push), as the JAX kernel
    test builds them: x in [1.5, 2], y and z in [-0.5, 0.5], velocity
    fractions (ux in [-0.3, 0.3], 0.9, 0.1) through initialize_gamma."""
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(1.5, 2.0, n), rng.uniform(-0.5, 0.5, n),
            rng.uniform(-0.5, 0.5, n), rng.uniform(-0.3, 0.3, n),
            np.full(n, 0.9), np.full(n, 0.1), np.ones(n)]
    st = initialize_gamma(ParticleState(*[
        torch.from_numpy(c).to(dtype=dtype, device=device) for c in cols]))
    return list(st[:6])


def slab_push_gamma_carried(leaves, steps):
    """A wrong slab push for the separation check: gamma held at its value
    at the launch's start instead of recovered from u each step (the first
    of the three square roots of each step of the plain version)."""
    g0 = torch.sqrt(1.0 + sum(u * u for u in leaves[3:]))
    sqrt, calls = torch.sqrt, [0]

    def first_is_gamma(a):
        calls[0] += 1
        return g0 if calls[0] % 3 == 1 else sqrt(a)

    with mock.patch.object(torch, "sqrt", first_is_gamma):
        return boris.slab_push_plain(*leaves, **SLAB, steps=steps)


def phase_slab_vs_plain(device, n=100_003):
    """Phase 8: K5 against its plain version over one launch of 100 steps,
    f32 and f64, and what a wrong kernel shows on the plain version: one
    step fewer (asserted SEPARATION above the limit) and gamma carried
    from the start (reported: gamma is invariant in a pure magnetic field,
    so carrying it changes only the rounding)."""
    rows = {}
    for dtype in (torch.float32, torch.float64):
        leaves = particle_ensemble(n, dtype, device, SEED + 5)
        push = boris.make_slab_push(**SLAB, steps=SLAB_STEPS)
        plain = boris.slab_push_plain(*leaves, **SLAB, steps=SLAB_STEPS)
        row = {"dev": max(relative_deviations(push(*leaves), plain)),
               "limit": K5_TOL[dtype]}
        row["one step fewer"] = max(relative_deviations(
            boris.slab_push_plain(*leaves, **SLAB, steps=SLAB_STEPS - 1),
            plain))
        row["gamma carried"] = max(relative_deviations(
            slab_push_gamma_carried(leaves, SLAB_STEPS), plain))
        row["fail"] = (([] if row["dev"] <= row["limit"] else ["dev"])
                       + ([] if row["one step fewer"]
                          >= SEPARATION * row["limit"]
                          else ["one step fewer"]))
        rows[str(dtype)[6:]] = row
    print(f"[8 K5 vs plain, {n} particles, {SLAB_STEPS} steps] worst "
          f"relative leaf deviation against its limit, and what a wrong "
          f"kernel would show: {json.dumps(rows)}")
    failed = {key: row for key, row in rows.items() if row["fail"]}
    if failed:
        raise AssertionError(f"slab push vs plain: {failed}")


def gamma_of(leaves):
    ux, uy, uz = leaves[3:]
    return torch.sqrt(1.0 + ux * ux + uy * uy + uz * uz)


def phase_slab_push(device, n=100_000_000, launches=10):
    """Phase 9: K5 at full width, bench.py's korc configuration: n
    particles f32 at x 1.7, u (0, 0.99, 0.1) c through initialize_gamma,
    ``launches`` launches of 100 steps; then one 100-step launch of the
    plain version at the same size.  Returns what the kernel record
    needs."""
    dtype = torch.float32

    def full(value):
        return torch.full((n,), value, dtype=dtype, device=device)

    st = initialize_gamma(ParticleState(full(1.7), full(0.0), full(0.0),
                                        full(0.0), full(0.99), full(0.1),
                                        full(1.0)))
    start = list(st[:6])
    g0 = st.gamma
    del st
    push = boris.make_slab_push(**SLAB, steps=SLAB_STEPS)
    push(*[a[:1].contiguous() for a in start])        # load the module
    boris.slab_push_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    leaves = start
    for _ in range(launches):
        leaves = push(*leaves)
    torch.cuda.synchronize()
    float(leaves[0][0])
    seconds = time.perf_counter() - t0
    count = boris.slab_push_launches
    rate = n * SLAB_STEPS * launches / seconds
    finite = all(bool(torch.isfinite(a).all()) for a in leaves)
    drift = float(((gamma_of(leaves) - g0).abs() / g0).max())
    del leaves
    plain, plain_s = timed(
        lambda: boris.slab_push_plain(*start, **SLAB, steps=SLAB_STEPS),
        pick=lambda out: types.SimpleNamespace(x=out[0]))
    plain_rate = n * SLAB_STEPS / plain_s
    kern = push(*start)
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(kern, plain))
    rel = max(relative_deviations(kern, plain))
    del kern, plain
    print(f"[9 K5 full width] {n} particles f32 x {launches} launches x "
          f"{SLAB_STEPS} steps: {seconds:.4f} s = {rate:.6e} "
          f"particle-steps/s; {count} launches; all finite {finite}; "
          f"largest relative drift of sqrt(1 + u.u) from its start "
          f"{drift:.3e}; plain version, one launch: {plain_s:.4f} s = "
          f"{plain_rate:.6e} particle-steps/s; first launch kernel vs "
          f"plain: max abs {err:.3e}, relative {rel:.3e}; the allocator "
          f"peaked at {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if count != launches or not finite or not rel <= K5_TOL[dtype]:
        raise AssertionError(f"slab push: {count} launches, finite "
                             f"{finite}, kernel vs plain {rel}")
    return dict(start=start, launches=count, err=err,
                plain_ms=1e3 * plain_s)


def phase_korc_efit(device, n=1_000_000, steps=1000):
    """Phase 10: xkorc through the EFIT field (plain PyTorch, no kernel):
    run_korc with xkorc's 1e6 particles in f64 for ``steps`` steps (the
    reference's 1e6 steps cut to keep the smoke in its time limit)."""
    eq = synthetic_equilibrium(torch.float64, device, **KORC_AXIS)
    b0, axis_s = timed(lambda: eq.characteristic_field(),
                       pick=lambda out: types.SimpleNamespace(x=out[None]))
    st, seconds = timed(lambda: run_korc(eq, n, steps, dt=0.5,
                                         dtype=torch.float64, device=device))
    g0 = 1.0 / np.sqrt(1.0 - (0.99 ** 2 + 0.1 ** 2))
    r = torch.sqrt(st.x * st.x + st.y * st.y)
    finite = all(bool(torch.isfinite(a).all()) for a in st)
    inside = bool(((r > 0.5) & (r < 3.0)).all())
    drift = float(((st.gamma - g0).abs() / g0).max())
    rate = n * steps / seconds
    print(f"[10 xkorc through EFIT, f64] characteristic field "
          f"{float(b0):.9f} T ({axis_s:.3f} s); {n} particles x {steps} "
          f"steps (dt 0.5 gyro periods / 2 pi): {seconds:.3f} s = "
          f"{rate:.6e} particle-steps/s; all finite {finite}; R in (0.5, "
          f"3.0) m {inside} (R from {float(r.min()):.4f} to "
          f"{float(r.max()):.4f} m); largest relative drift of gamma "
          f"{drift:.3e}")
    if not (finite and inside and 0.3 < float(b0) < 0.4):
        raise AssertionError(f"xkorc: finite {finite}, inside {inside}, "
                             f"b0 {float(b0)}")


def deposit_inputs(n, g, dtype, device, seed):
    """n particles 0.25 N(0, 1) with a mask that drops about one in ten,
    and g grid points on [-1, 1] (run_pic's grid)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(0.25 * rng.standard_normal(n))
    mask = torch.from_numpy((rng.uniform(size=n) > 0.1).astype(np.float64))
    grid = make_grid(g, 2.0 / (g - 1.0), -1.0, dtype, device)
    return x.to(dtype=dtype, device=device), mask.to(dtype=dtype,
                                                     device=device), grid


def deposit_own_bin(x, mask, grid, width=WIDTH):
    """A wrong deposit for the separation check: each grid point sums n
    only over the particles of its own bin (bins of the reach's width from
    the grid's start), e as the plain version."""
    r = k6.reach(width, x.dtype)
    lo = float(grid.min()) - r
    bin_x, bin_g = torch.floor((x - lo) / r), torch.floor((grid - lo) / r)
    n = torch.zeros_like(grid)
    for start in range(0, x.shape[0], 4096):
        xb, mb = x[start:start + 4096], mask[start:start + 4096]
        dx = xb[None, :] - grid[:, None]
        same = bin_x[None, start:start + 4096] == bin_g[:, None]
        n = n + torch.sum(torch.exp(dx * dx / -width) * mb * same, dim=1)
    return n, k6.deposit_plain(x, mask, grid, width=width)[1]


def exp_at_reach(device):
    """{dtype: (exp(-EXP_UNDERFLOW), exp(-REACH), exp(1 - EXP_UNDERFLOW))}
    on the card, in the working type: the first two must be +0 (beyond K6's
    reach every term is +0), the third not (the threshold is tight)."""
    return {str(dtype)[6:]: [float(torch.exp(torch.tensor(
        -a, dtype=dtype, device=device))) for a in (
            k6.EXP_UNDERFLOW[dtype], k6.REACH[dtype],
            k6.EXP_UNDERFLOW[dtype] - 1.0)]
        for dtype in (torch.float32, torch.float64)}


def phase_deposit_vs_plain(device, n=100_003):
    """Phase 11: K6 against its plain version, G = 1000 and a ragged
    1001, a mask with zeros, f32 and f64; what a wrong kernel shows on
    the plain version (the mask ignored; the ragged last chunk of
    particles dropped; each point summing only its own bin's particles),
    each asserted SEPARATION above the limit; two launches on the same
    inputs equal bit for bit; and exp of the working type +0 at K6's
    reach."""
    rows = {}
    exps = exp_at_reach(device)
    for dtype in (torch.float32, torch.float64):
        for g in (1000, 1001):
            x, mask, grid = deposit_inputs(n, g, dtype, device, SEED + 6)
            got = k6.deposit(x, mask, grid)
            again = k6.deposit(x, mask, grid)
            plain = k6.deposit_plain(x, mask, grid)
            full = (n // k6.CHUNK) * k6.CHUNK
            row = {"dev": max(relative_deviations(got, plain)),
                   "limit": K6_TOL[dtype],
                   "mask ignored": max(relative_deviations(
                       k6.deposit_plain(x, torch.ones_like(mask), grid),
                       plain)),
                   "last chunk dropped": max(relative_deviations(
                       k6.deposit_plain(x[:full], mask[:full], grid),
                       plain)),
                   "own bin only": max(relative_deviations(
                       deposit_own_bin(x, mask, grid), plain)),
                   "bitwise repeat": all(torch.equal(a, b)
                                         for a, b in zip(got, again))}
            row["fail"] = (
                ([] if row["dev"] <= row["limit"] else ["dev"])
                + [w for w in ("mask ignored", "last chunk dropped",
                               "own bin only")
                   if not row[w] >= SEPARATION * row["limit"]]
                + ([] if row["bitwise repeat"] else ["bitwise repeat"]))
            rows[f"{str(dtype)[6:]}/G={g}"] = row
    print(f"[11 K6 vs plain, {n} particles] worst relative deviation of n "
          f"and e against the limit, what a wrong kernel would show, and "
          f"whether a second launch repeats the first bit for bit: "
          f"{json.dumps(rows)}; exp on the card at -EXP_UNDERFLOW, at "
          f"-REACH and 1 above the first: {json.dumps(exps)}")
    failed = {key: row for key, row in rows.items() if row["fail"]}
    if any(v[0] != 0.0 or v[1] != 0.0 or not v[2] > 0.0
           for v in exps.values()):
        failed["exp at reach"] = exps
    if failed:
        raise AssertionError(f"deposit vs plain: {failed}")


def phase_pic(device, n=1_000_000, g=1000, steps=50, dt=1.0e-14):
    """Phase 12: xpic at full width, bench.py's pic configuration
    (bench.py:519-535): run_pic with n particles, g grid points, ``steps``
    steps of dt, f32, one K6 launch a step; then the same steps from the
    same start with the plain deposit.  Returns what the record needs."""
    dtype = torch.float32
    k6.deposit_launches = 0
    final, seconds = timed(lambda: run_pic(n, g, steps, dt=dt, seed=SEED,
                                           dtype=dtype, device=device))
    count = k6.deposit_launches
    rate = n * steps / seconds
    finite = all(bool(torch.isfinite(a).all()) for a in final)
    scale, offset = 2.0 / (g - 1.0), -1.0
    grid = make_grid(g, scale, offset, dtype, device)
    push = make_push_step(scale, offset, dt)
    st = pic_start(n, g, SEED, dtype, device)
    with torch.no_grad():
        for _ in range(steps):
            dens, field = k6.deposit_plain(st.x, torch.ones_like(st.x), grid)
            st = push(st._replace(n=dens, epara=field))
    devs = dict(zip(PicState._fields, relative_deviations(final, st)))
    # where the wall goes: the same run under the profiler
    ops, busy_ms, k6_ms = device_work(
        lambda: run_pic(n, g, steps, dt=dt, seed=SEED, dtype=dtype,
                        device=device), part="deposit_")
    print(f"[12 xpic full width] {n} particles x {g} grid points f32 x "
          f"{steps} steps, dt {dt}: {seconds:.4f} s = {rate:.6e} "
          f"particle-steps/s = {rate * g:.6e} pair-updates/s; {count} K6 "
          f"launches; all finite {finite}; n.max() {float(final.n.max()):.6e}"
          f"; against the plain deposit's run, relative deviation "
          f"{json.dumps(devs)}, limit {PIC_TOL}; under the profiler "
          f"{ops} device operations, {busy_ms:.3f} ms of device time "
          f"against {1e3 * seconds:.3f} ms of wall, K6's kernels "
          f"{k6_ms:.3f} ms of it")
    if (count != steps or not finite or not float(final.n.max()) > 0
            or not max(devs.values()) <= PIC_TOL):
        raise AssertionError(f"xpic: {count} launches, finite {finite}, "
                             f"deviations {devs}")
    return dict(x=final.x, grid=grid, launches=count)


#: K6's kernels, in launch order (csrc/deposit.cu).
DEPOSIT_KERNELS = ("deposit_setup_kernel", "deposit_count_kernel",
                   "deposit_rows_kernel", "deposit_bins_kernel",
                   "deposit_scatter_kernel", "deposit_tile_kernel",
                   "deposit_finish_kernel")


def deposit_device_ms(x, mask, grid, reps=20):
    """K6's device ms a call (the profiler's median launch of each of its
    kernels, summed) and the ms of each kernel."""
    by_kernel = {}
    for name in DEPOSIT_KERNELS:
        by_kernel[name], _, _ = profile_kernel(
            lambda: [k6.deposit(x, mask, grid) for _ in range(reps)],
            kernel=(name,))
    known = [v for v in by_kernel.values() if v is not None]
    total = sum(known) if len(known) == len(by_kernel) else None
    return total, by_kernel


def particle_kernel_records(slab, pic):
    """The K5 and K6 lines (phase 13): milliseconds per wrapper call by
    CUDA events and on the device by the profiler, at the main path's
    shapes (1e8 particles x 100 steps; 1M particles x 1000 grid points),
    beside the plain version's, and the bound."""
    push = boris.make_slab_push(**SLAB, steps=SLAB_STEPS)
    start = slab["start"]
    n = start[0].shape[0]
    ms = event_ms(lambda: push(*start), 3)
    dev_ms, _, _ = profile_kernel(lambda: [push(*start) for _ in range(3)],
                                  kernel=("slab_push_kernel",))
    b_ms, b_by = slab_bound(n, torch.float32)
    # a step takes 3 rsqrt (MUFU.RSQ) in f32
    sass = hot_loop_sass("slab_push_kernel", [("MUFU.RSQ", 3)])
    mufu = sass["mufu"] if isinstance(sass, dict) else 4
    floor_ms, mhz = mufu_floor_ms(n, SLAB_STEPS, mufu)
    print(f"[13 slab_push time] {n} particles f32 x {SLAB_STEPS} steps: "
          f"{ms:.4f} ms per launch (CUDA events, wrapper included); kernel "
          f"on the device {dev_ms} ms (profiler); plain "
          f"version {slab['plain_ms']:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by}, {boris.SLAB_PUSH_OPS} operations a step); "
          f"special-function floor {floor_ms:.4f} ms ({mufu} MUFU a step, "
          f"16 a clock an SM at {mhz:.0f} MHz); SASS of the step loop "
          f"{json.dumps(sass)}")
    records = [{"name": "slab_push", "route": "cuda",
                "source": "graph_framework_tpu_torch/csrc/boris.cu",
                "replaces": "graph_framework_tpu/pallas/boris.py:36",
                "launches": slab["launches"], "max_abs_err": slab["err"],
                "ms": ms, "plain_ms": slab["plain_ms"], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None}]
    del start

    x, grid = pic["x"], pic["grid"]
    mask = torch.ones_like(x)
    got, want = k6.deposit(x, mask, grid), k6.deposit_plain(x, mask, grid)
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got, want))
    ms = event_ms(lambda: k6.deposit(x, mask, grid), 20)
    plain_ms = event_ms(lambda: k6.deposit_plain(x, mask, grid), 2)
    dev_ms, by_kernel = deposit_device_ms(x, mask, grid)
    b_ms, b_by, basis = deposit_bound(x, mask, grid)
    print(f"[13 deposit time] {x.shape[0]} particles x {grid.shape[0]} "
          f"grid points f32: {ms:.4f} ms per call (CUDA events, seven "
          f"kernels, wrapper included); kernels on the device "
          f"{dev_ms} ms (profiler; by kernel {json.dumps(by_kernel)}); "
          f"plain version {plain_ms:.4f} ms; bound {b_ms:.4f} ms, by {b_by} "
          f"({basis}); max abs error "
          f"{err:.3e} (n up to {float(want[0].abs().max()):.3e}, e up to "
          f"{float(want[1].abs().max()):.3e})")
    records.append({"name": "deposit", "route": "cuda",
                    "source": "graph_framework_tpu_torch/csrc/deposit.cu",
                    "replaces": "graph_framework_tpu/pallas/deposit.py:26",
                    "launches": pic["launches"], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None})
    return records


# -- the VMEC path: K4 (the fused geometry jet) and K7 (the mode sums) --------
# K4 against its plain version at 4099 rays over s in [-1.1, 1.1] (both
# clamps, extrapolation past either end, the cell edges of both grids): per
# jet sum, max |kernel - plain| over max |plain|, the worst sum against the
# limit; the VJP of FusedGeometry against autograd of the plain jet the same
# way, per coordinate.  The two differ only in rounding (FMA contraction,
# the order of the sums over 86 modes).  Each limit sits 25-30x above
# what the card read (NVIDIA H100 80GB HBM3, 700.00 W): jet f32 7.7e-7,
# f64 1.6e-15; VJP f32 3.2e-7, f64 6.9e-16.
# On the plain version a kernel that drops the last mode shows 1.4e-2, one
# that reads lmns on the full grid 4.6e-2, a VJP with two rows of JVP_IDX
# swapped 1.3 (asserted SEPARATION above the limit).  Phase 17 holds K4
# and K7 to the same limits at the main path's 100k rays, each sum
# relative to its scale over these rays (wide_scales).
K4_TOL = {torch.float32: 2.0e-5, torch.float64: 5.0e-14}
# The kernel reaches each mode's trig by rotations from the sincos of u and
# nfp v (csrc/vmec_geom.cu), not from sincos of the angle xm u - xn v
# rounded as eager torch rounds it, so it and the plain version differ by
# that rounding too (|angle| eps, some 1e-5 rad at phase
# 14's angles up to 180 rad; the card reads 2.0e-6 f32 and 4.0e-15 f64
# per sum, NVIDIA H100 80GB HBM3, 700.00 W).  Phase 14 therefore also
# holds both, in f32, to the f64 plain version on the same inputs: the
# kernel's worst sum may lie at most K4_REFEREE_FACTOR times as far from it
# as the f32 plain version's (the card: 2.68e-6 against 2.71e-6).
K4_REFEREE_FACTOR = 2.0
# K7 against its plain version (4099 rays x 86 modes): per sum, likewise
# (the warp's shuffle tree sums in another order); the card read f32
# 1.5e-7, f64 2.4e-16 (VJP, the plain adjoint, 2.2e-7 / 3.6e-16); a kernel
# one mode short shows 1.0e-3, a VJP that swaps two cotangents 2.2.
K7_TOL = {torch.float32: 2.0e-5, torch.float64: 5.0e-14}
# K8 (csrc/vmec_rhs.cu) against its plain version on the same jet: per
# derivative, relative to its largest magnitude.  The two take the same
# hand chain and differ only in rounding (FMA contraction, sincos): the
# host build of the source reads 3.2e-7 f32 and 2.3e-16 f64 over 301 of
# vmec_rhs_state's rays.  A ray where D_w nears 0 (one in a few thousand of
# them) amplifies every rounding, the f32 plain version's against f64 too:
# one such ray of 4099 read 2.3e-3 f32 and 1.9e-12 f64 on the card (NVIDIA
# H100 80GB HBM3, 700.00 W), so the tests keep their seeded rays.
K8_TOL = {torch.float32: 1.0e-5, torch.float64: 1.0e-13}
# Phase 17's K8 line at the main path's rays (phase 16's final state, all
# near one launch): there D_s is a sum of terms that cancel, and the card
# read the kernel 1.9e-5 of dk_s/dt's scale from the f32 plain version, above
# K8_TOL.  So, as phase 14 holds K4, that line holds both in f32 to the f64
# plain version on the same inputs: the kernel's worst derivative may lie at
# most K8_REFEREE_FACTOR times as far from it as the f32 plain version's.
K8_REFEREE_FACTOR = 2.0
# Phase 16: the fused trace against the unfused plain path over a few
# recorded steps, per leaf relative to max(1, its scale):
# test_pallas_vmec_geom.py's test_fused_trace_matches_default tolerance,
# also held by the frozen-radial trace against the fused one.  Over three
# steps it checks the routing, not K4's arithmetic (phases 14 and 17 do):
# phase 16c prints what the wrong kernels of phase 14 read against it.
VMEC_TRACE_TOL = 1.0e-4
# Wall seconds phase 16 spends on its main run (at least 100 recorded
# steps, at most 1000: bench.py's endtime 0.025).
VMEC_MAIN_SECONDS = 45.0


def bound_sides(ops, nbytes, dtype=torch.float32):
    """Both sides of :func:`bound`, as text."""
    return (f"{ops} operations: {1e3 * ops / PEAK_OPS[dtype]:.4f} ms; "
            f"{nbytes} bytes: {1e3 * nbytes / PEAK_BYTES:.4f} ms")


def relative_rows(got, want, scale=None):
    """Per row of (k, n) tensors: max |got - want| over max |want|, or over
    ``scale`` (k,), the rows' scales taken from other inputs."""
    got, want = got.double(), want.double()
    if scale is None:
        scale = want.abs().amax(1)
    return ((got - want).abs().amax(1)
            / scale.double().clamp_min(1e-300)).tolist()


def wide_scales(device):
    """The K4 jet's and the K7 sums' scales per row (max |plain|) over
    phase 14's and phase 15's rays, which span the tables.  Phase 17 holds
    the kernels at the main path's rays to these: there every ray lies
    near one launch, where some sums cancel to 1e-3 of their terms, while
    a sum's f32 rounding follows its terms."""
    _, tables, coords = k4_inputs(4099, torch.float32, device, SEED + 7)
    u, v, blocks, xm, xn = k7_inputs(4099, torch.float32, device, SEED + 9)
    return (vmec_geom.reference_jet(*coords, tables).abs().amax(1),
            torch.stack(vmec_modes.reference_forward(u, v, *blocks, xm, xn))
            .abs().amax(1))


def drop_last_mode(tables):
    """K4's tables without their last mode (a wrong kernel)."""
    g = tables.lm.shape[-1]
    rz = torch.cat([tables.rz[..., :g - 1], tables.rz[..., g:2 * g - 1]],
                   dim=-1)
    return vmec_geom.make_jet_tables(
        rz.contiguous(), tables.lm[..., :-1].contiguous(),
        tables.xm[:-1].contiguous(), tables.xn[:-1].contiguous(),
        tables.sminf, tables.sminh, tables.ds)


def k4_inputs(n, dtype, device, seed):
    """The synthetic stellarator's K4 tables and n rays (s, u, v): s
    uniform on [-1.1, 1.1] with the first rays on the knots of both grids
    and past both ends of the tables, u and v uniform on [0, 2 pi]."""
    eq = synthetic_vmec(dtype, device)
    tables = vmec_geom.jet_tables(eq)
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1.1, 1.1, n)
    edges = np.concatenate([
        eq.sminf + eq.ds * np.arange(0, VMEC_KNOTS, 7),
        eq.sminh + eq.ds * np.arange(0, VMEC_KNOTS - 1, 11),
        [-1.25, -1.0 - 1e-3, 1.0 + 1e-3, 1.25]])
    s[:edges.size] = edges
    u, v = rng.uniform(0.0, 2 * np.pi, (2, n))
    return eq, tables, [torch.from_numpy(a).to(dtype=dtype, device=device)
                        for a in (s, u, v)]


def phase_k4_vs_plain(device, n=4099):
    """Phase 14: K4 against its plain version, all 27 sums, f32 and f64,
    with what wrong kernels show on the plain version; the VJP of
    FusedGeometry against autograd of the plain jet, seeded cotangents;
    and in f32 the kernel and the plain version each against the f64
    plain version (``K4_REFEREE_FACTOR``)."""
    rows = {}
    swapped = list(vmec_geom.JVP_IDX)
    swapped[3], swapped[4] = swapped[4], swapped[3]
    for dtype in (torch.float32, torch.float64):
        eq, tables, coords = k4_inputs(n, dtype, device, SEED + 7)
        want = vmec_geom.reference_jet(*coords, tables)
        got = vmec_geom.geometry_jet(*coords, tables)
        devs = relative_rows(got, want)
        worst = int(np.argmax(devs))
        row = {"dev": devs[worst], "worst sum": vmec_geom.JET_NAMES[worst],
               "limit": K4_TOL[dtype],
               "last mode dropped": max(relative_rows(
                   vmec_geom.reference_jet(*coords, drop_last_mode(tables)),
                   want)),
               "lmns on the full grid": max(relative_rows(
                   vmec_geom.reference_jet(*coords, tables._replace(
                       sminh=tables.sminf)), want))}
        rng = np.random.default_rng(SEED + 8)
        cts = [torch.from_numpy(rng.standard_normal(n)).to(coords[0])
               for _ in range(10)]
        leaves = [a.clone().requires_grad_(True) for a in coords]

        def vjp(fn):
            return torch.stack(torch.autograd.grad(fn(), leaves, cts))

        want_vjp = vjp(lambda: vmec_geom.reference_jet(
            *leaves, tables)[:10].unbind(0))
        row["vjp"] = max(relative_rows(vjp(lambda: vmec_geom.FusedGeometry
                                           .apply(*leaves, tables)),
                                       want_vjp))
        with mock.patch.object(vmec_geom, "JVP_IDX", swapped):
            row["vjp, dru and drv rows swapped"] = max(relative_rows(
                vjp(lambda: vmec_geom.FusedGeometry.apply(*leaves, tables)),
                want_vjp))
        lim = row["limit"]
        row["fail"] = [k for k in ("dev", "vjp") if not row[k] <= lim] + [
            k for k in ("last mode dropped", "lmns on the full grid",
                        "vjp, dru and drv rows swapped")
            if not row[k] >= SEPARATION * lim]
        if dtype == torch.float32:
            # both f32 versions against the f64 plain version, same inputs
            t64 = vmec_geom.make_jet_tables(
                *[a.double() for a in tables[:4]], tables.sminf,
                tables.sminh, tables.ds)
            ref = vmec_geom.reference_jet(*[a.double() for a in coords], t64)
            row["kernel vs f64 plain"] = max(relative_rows(got, ref))
            row["plain vs f64 plain"] = max(relative_rows(want, ref))
            row["referee factor"] = K4_REFEREE_FACTOR
            if not (row["kernel vs f64 plain"]
                    <= K4_REFEREE_FACTOR * row["plain vs f64 plain"]):
                row["fail"].append("kernel vs f64 plain")
        rows[str(dtype)[6:]] = row
    print(f"[14 K4 vs plain, {n} rays, s in [-1.1, 1.1] with the clamps "
          f"and the cell edges] worst relative deviation of the 27 jet sums "
          f"and of the VJP against the limit, and what wrong kernels show: "
          f"{json.dumps(rows)}")
    failed = {key: row for key, row in rows.items() if row["fail"]}
    if failed:
        raise AssertionError(f"vmec_geom vs plain: {failed}")


def k7_inputs(n, dtype, device, seed):
    """n rays' K7 inputs from the synthetic stellarator: u, v uniform on
    [0, 2 pi], the five per-mode radial blocks at s uniform on [0.05,
    0.95] (``VmecEquilibrium.radial_modes``), and the 86 modes' numbers."""
    eq = synthetic_vmec(dtype, device)
    rng = np.random.default_rng(seed)
    s, u, v = [torch.from_numpy(a).to(dtype=dtype, device=device) for a in (
        rng.uniform(0.05, 0.95, n), *rng.uniform(0.0, 2 * np.pi, (2, n)))]
    blocks = [b.contiguous() for b in eq.radial_modes(s)]
    return u, v, blocks, eq.xm, eq.xn


def phase_k7_vs_plain(device, n=4099):
    """Phase 15: K7 against its plain version, f32 and f64, forward and
    the first-order VJP of make_mode_sums (against autograd of the plain
    forward), with what a kernel one mode short and a VJP that swaps the
    dl/du and dl/dv cotangents show."""
    rows = {}
    for dtype in (torch.float32, torch.float64):
        u, v, blocks, xm, xn = k7_inputs(n, dtype, device, SEED + 9)
        want = torch.stack(vmec_modes.reference_forward(u, v, *blocks, xm,
                                                        xn))
        row = {"dev": max(relative_rows(torch.stack(vmec_modes.mode_sums(
                   u, v, *blocks, xm, xn)), want)),
               "limit": K7_TOL[dtype],
               "last mode dropped": max(relative_rows(torch.stack(
                   vmec_modes.reference_forward(
                       u, v, *[b[:, :-1] for b in blocks], xm[:-1],
                       xn[:-1])), want))}
        rng = np.random.default_rng(SEED + 10)
        cts = [torch.from_numpy(rng.standard_normal(n)).to(u)
               for _ in range(10)]
        leaves = [a.clone().requires_grad_(True) for a in (u, v, *blocks)]
        f = vmec_modes.make_mode_sums(xm, xn)

        def vjp(fn, c):
            return torch.cat([g.reshape(-1, n) for g in torch.autograd.grad(
                fn(*leaves), leaves, c)])

        want_vjp = vjp(lambda *a: vmec_modes.reference_forward(*a, xm, xn),
                       cts)
        row["vjp"] = max(relative_rows(vjp(f, cts), want_vjp))
        row["vjp, dl/du and dl/dv cotangents swapped"] = max(relative_rows(
            vjp(f, cts[:8] + [cts[9], cts[8]]), want_vjp))
        lim = row["limit"]
        row["fail"] = [k for k in ("dev", "vjp") if not row[k] <= lim] + [
            k for k in ("last mode dropped",
                        "vjp, dl/du and dl/dv cotangents swapped")
            if not row[k] >= SEPARATION * lim]
        rows[str(dtype)[6:]] = row
    print(f"[15 K7 vs plain, {n} rays x {xm.shape[0]} modes] worst relative "
          f"deviation of the ten sums and of the VJP against the limit, and "
          f"what wrong kernels show: {json.dumps(rows)}")
    failed = {key: row for key, row in rows.items() if row["fail"]}
    if failed:
        raise AssertionError(f"vmec_modes vs plain: {failed}")


def vmec_solver(eq, **frozen):
    return Solver(cold_plasma, eq, method="rk2", dt=VMEC_DT,
                  sub_steps=VMEC_SUB_STEPS, **frozen)


def in_flux_domain(state):
    """Rays whose state is finite and whose s lies in (0, 1)."""
    finite = torch.stack([torch.isfinite(l) for l in state]).all(dim=0)
    return finite & (state.x > 0.0) & (state.x < 1.0)


def trace_deviation(got, want):
    """Worst leaf deviation relative to max(1, the leaf's scale)."""
    return max(float((a.double() - b.double()).abs().max())
               / max(1.0, float(b.double().abs().max()))
               for a, b in zip(got, want))


def phase_vmec_main(device, n=100_000, steps_check=3, steps_frozen=20):
    """Phase 16: the VMEC ray trace at full width, bench.py's fused_rk2
    leg: n rays f32 through init_k and Solver.run with fused_mode_sums
    (K4), rk2, 10 substeps of dt 2.5e-6, as many recorded steps (100 to
    1000) as fit in VMEC_MAIN_SECONDS; K4's launches against 2 x substeps
    and init_k's evaluations, K8's (the value RHS) against 2 x substeps;
    validity, max D^2 and ray-steps/s.  Then the
    fused trace against the unfused plain path, and the frozen-radial rk2
    path (K = 10, plain torch) against the fused one, over a few steps."""
    eq = synthetic_vmec(torch.float32, device, fused_mode_sums=True)
    vmec_geom.vmec_geom_launches = 0
    (st, diag), init_s = timed(
        lambda: init_k(vmec_launch(n, torch.float32, device), cold_plasma,
                       eq, return_diagnostics=True),
        pick=lambda out: out[0])
    init_launches = vmec_geom.vmec_geom_launches
    sol = vmec_solver(eq)
    _, probe_s = timed(lambda: sol.run(st, 5))
    steps = int(min(1000, max(100, VMEC_MAIN_SECONDS * 5 / probe_s)))
    vmec_geom.vmec_geom_launches = vmec_rhs.vmec_rhs_launches = 0
    final, seconds = timed(lambda: sol.run(st, steps))
    launches = vmec_geom.vmec_geom_launches
    rhs_launches = vmec_rhs.vmec_rhs_launches
    expected = 2 * steps * VMEC_SUB_STEPS
    frac = float(in_flux_domain(final).double().mean())
    res = float(residual_fn(cold_plasma, eq)(final).max())
    rate = n * steps * VMEC_SUB_STEPS / seconds
    print(f"[16a VMEC main f32 rk2 fused (K4)] {n} rays x {steps} x "
          f"{VMEC_SUB_STEPS} (dt {VMEC_DT}): init_k {init_s:.3f} s "
          f"({diag.iterations} Newton iterations, {init_launches} K4 "
          f"launches, expected {diag.iterations + 2}); run {seconds:.3f} s = "
          f"{rate:.6e} ray-steps/s; {launches} K4 and {rhs_launches} K8 "
          f"launches (each 2 x {steps * VMEC_SUB_STEPS} substeps = "
          f"{expected}); finite with 0 < "
          f"s < 1: {frac}; s from {float(final.x.min()):.4f} to "
          f"{float(final.x.max()):.4f}; max D^2 {res:.3e}")
    if (launches != expected or rhs_launches != expected
            or init_launches != diag.iterations + 2
            or frac != 1.0 or not np.isfinite(res)):
        raise AssertionError(f"VMEC main path: launches {launches} / "
                             f"{rhs_launches} / {init_launches}, in domain "
                             f"{frac}, D^2 {res}")
    ops, dev_ms = device_work(lambda: sol.run(st, 2))
    step_ms = 1e3 * seconds / steps
    print(f"[16b VMEC where the time goes] 2 recorded steps under the "
          f"profiler: {ops} device operations ({ops / (2 * VMEC_SUB_STEPS):.1f} "
          f"a substep), {dev_ms / 2:.3f} ms of device time a recorded step "
          f"against {step_ms:.3f} ms of wall a step in the run above: busy "
          f"share {dev_ms / 2 / step_ms:.4f}")

    unfused = dataclasses.replace(eq, fused_mode_sums=False)
    fused_short = sol.run(st, steps_check)
    (plain_short, plain_s) = timed(
        lambda: vmec_solver(unfused).run(st, steps_check))
    dev_plain = trace_deviation(fused_short, plain_short)
    fused_frozen_ref = sol.run(st, steps_frozen)
    vmec_geom.vmec_geom_launches = vmec_rhs.vmec_rhs_launches = 0
    frozen, frozen_s = timed(lambda: vmec_solver(
        eq, frozen_cells=True, freeze_every=VMEC_SUB_STEPS).run(
            st, steps_frozen))
    frozen_launches = vmec_geom.vmec_geom_launches + vmec_rhs.vmec_rhs_launches
    dev_frozen = trace_deviation(frozen, fused_frozen_ref)
    tables = vmec_geom.jet_tables(eq)
    wrong = {}
    for name, bad in (("last mode dropped", drop_last_mode(tables)),
                      ("lmns on the full grid",
                       tables._replace(sminh=tables.sminf))):
        eq_bad = dataclasses.replace(eq)
        eq_bad._cache["jet"] = bad
        wrong[name] = trace_deviation(
            vmec_solver(eq_bad).run(st, steps_check), plain_short)
    print(f"[16c VMEC checks] fused vs unfused plain path over "
          f"{steps_check} recorded steps: {dev_plain:.3e} (limit "
          f"{VMEC_TRACE_TOL}; unfused {n * steps_check * VMEC_SUB_STEPS / plain_s:.6e} "
          f"ray-steps/s); frozen-radial rk2 K={VMEC_SUB_STEPS} (plain torch, "
          f"{frozen_launches} K4 and K8 launches) over {steps_frozen} steps: "
          f"{n * steps_frozen * VMEC_SUB_STEPS / frozen_s:.6e} ray-steps/s, "
          f"against the fused trace {dev_frozen:.3e} (limit "
          f"{VMEC_TRACE_TOL}); finite with 0 < s < 1: "
          f"{float(in_flux_domain(frozen).double().mean())}; the wrong "
          f"kernels of phase 14 against the unfused path over "
          f"{steps_check} steps: {json.dumps(wrong)}")
    if not (dev_plain <= VMEC_TRACE_TOL and dev_frozen <= VMEC_TRACE_TOL
            and frozen_launches == 0
            and bool(in_flux_domain(frozen).all())):
        raise AssertionError(f"VMEC checks: unfused {dev_plain}, frozen "
                             f"{dev_frozen}, {frozen_launches} launches")
    return dict(eq=eq, state=final, launches=launches,
                rhs_launches=rhs_launches)


def vmec_rhs_record(main, tables, coords):
    """Phase 17's K8 line: the ray RHS kernel over the final state of phase
    16 and K4's jet there.  The kernel and the f32 plain version on the
    same jet are each held to the f64 plain version on the same inputs
    (per derivative, relative to its largest magnitude;
    ``K8_REFEREE_FACTOR``), the kernel's deviation from the f32 plain
    version printed beside K8_TOL, and the plain version with a planted
    fault (tests/test_torch_vmec_rhs.py's) against the f64 one; wrapper ms
    by CUDA events, device ms by the profiler, the plain version's ms and
    the bound.  K8 reads six leaves (not u), 26 jet rows (not Z itself)
    and the chi table, and writes six rows."""
    eq, st = main["eq"], main["state"]
    n = st.x.shape[0]
    leaves = [a.contiguous()
              for a in (st.w, st.x, st.y, st.z, st.kx, st.ky, st.kz)]
    jet = vmec_geom.geometry_jet(*coords, tables)
    params = vmec_rhs.rhs_params(eq)
    got = vmec_rhs.ray_rhs(leaves, jet, params)
    want = vmec_rhs.ray_rhs_plain(leaves, jet, params)
    args64 = ([a.double() for a in leaves], jet.double(),
              params._replace(chi=params.chi.double()))
    ref = vmec_rhs.ray_rhs_plain(*args64)
    err = float(max((a.double() - b.double()).abs().max()
                    for a, b in zip(got, want)))
    devs = relative_deviations(got, want)
    worst = int(np.argmax(devs))
    kernel_ref = max(relative_deviations(got, ref))
    plain_ref = max(relative_deviations(want, ref))
    chi_jet, densities = vmec_rhs._chi_jet, vmec_rhs._densities
    wrong = {}
    for name, attr, fault in (
            ("d2chi/ds2 left out", "_chi_jet", lambda s, q: vmec_rhs._Dual(
                chi_jet(s, q).v, (torch.zeros_like(s),) * 3)),
            ("ion density te = 1e-16 ne", "_densities", lambda s: (
                densities(s)[0], tuple(1e-16 * a for a in densities(s)[0])))):
        with mock.patch.object(vmec_rhs, attr, fault):
            wrong[name] = max(relative_deviations(
                vmec_rhs.ray_rhs_plain(*args64), ref))
    del got, want, ref, args64
    ms = event_ms(lambda: vmec_rhs.ray_rhs(leaves, jet, params), 50)
    plain_ms = event_ms(lambda: vmec_rhs.ray_rhs_plain(leaves, jet, params),
                        5)
    dev_ms, _, _ = profile_kernel(
        lambda: [vmec_rhs.ray_rhs(leaves, jet, params) for _ in range(20)],
        kernel=("vmec_rhs_kernel",))
    ops = n * vmec_rhs.RHS_OPS["per_ray"]
    nbytes = 4 * (n * (6 + (len(vmec_geom.JET_NAMES) - 1) + 6)
                  + params.chi.numel())
    b_ms, b_by = bound(ops, nbytes, torch.float32)
    print(f"[17 vmec_rhs time] {n} rays f32: {ms:.5f} ms per call (CUDA "
          f"events, wrapper included); kernel on the device {dev_ms} ms "
          f"(profiler); plain version {plain_ms:.4f} ms; bound "
          f"{b_ms:.5f} ms, by {b_by} ({bound_sides(ops, nbytes)}); max abs "
          f"error {err:.3e}; worst derivative's deviation from the f32 "
          f"plain version relative to its scale {devs[worst]:.3e} (the "
          f"{('s', 'u', 'v', 'k_s', 'k_u', 'k_v')[worst]} row; K8_TOL "
          f"{K8_TOL[torch.float32]}); against the f64 plain version: the "
          f"kernel {kernel_ref:.3e}, the f32 plain version {plain_ref:.3e} "
          f"(factor {K8_REFEREE_FACTOR}); the plain version with a planted "
          f"fault {json.dumps(wrong)}; "
          f"launches on the main path {main['rhs_launches']}")
    if not kernel_ref <= K8_REFEREE_FACTOR * plain_ref:
        raise AssertionError(f"vmec_rhs vs f64 plain at {n} rays: "
                             f"{kernel_ref} against {plain_ref}")
    return {"name": "vmec_rhs", "route": "cuda",
            "source": "graph_framework_tpu_torch/csrc/vmec_rhs.cu",
            "replaces": None, "launches": main["rhs_launches"],
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def vmec_kernel_records(main):
    """Phase 17: the K4, K8 and K7 lines at the main path's shapes (100k
    rays f32, the final state of phase 16; K8 over K4's jet there; K7 over
    the same rays' 86-mode blocks): each held to its plain version
    (K4_TOL, K7_TOL, per sum relative to its scale over the tables,
    ``wide_scales``; what phase 14's dropped mode reads there beside it;
    K8 and its plain version to the f64 plain version,
    ``K8_REFEREE_FACTOR``),
    milliseconds per wrapper call by CUDA events and on the device by the
    profiler, the plain version's, the error and the bound."""
    eq, st = main["eq"], main["state"]
    n = st.x.shape[0]
    tables = vmec_geom.jet_tables(eq)
    coords = [a.contiguous() for a in (st.x, st.y, st.z)]
    jet_scale, sum_scale = wide_scales(st.x.device)
    got = vmec_geom.geometry_jet(*coords, tables)
    want = vmec_geom.reference_jet(*coords, tables)
    err = float((got.double() - want.double()).abs().max())
    devs = relative_rows(got, want, jet_scale)
    worst = int(np.argmax(devs))
    dev, dropped = devs[worst], max(relative_rows(vmec_geom.reference_jet(
        *coords, drop_last_mode(tables)), want, jet_scale))
    del got, want
    ms = event_ms(lambda: vmec_geom.geometry_jet(*coords, tables), 50)
    plain_ms = event_ms(lambda: vmec_geom.reference_jet(*coords, tables), 5)
    dev_ms, _, _ = profile_kernel(
        lambda: [vmec_geom.geometry_jet(*coords, tables) for _ in range(20)],
        kernel=("vmec_geom_kernel",))
    g = tables.lm.shape[-1]
    jet_ops = vmec_geom.JET_OPS
    ops = (n * (jet_ops["per_ray_fixed"] + jet_ops["per_mode"] * g)
           + jet_ops["table_fixed"] + jet_ops["table_per_mode"] * g)
    nbytes = 4 * (n * (3 + len(vmec_geom.JET_NAMES)) + tables.rz.numel()
                  + tables.lm.numel() + 2 * g)
    b_ms, b_by = bound(ops, nbytes, torch.float32)
    # a mode loads its 12 coefficients in 3 vector loads (LDG.E.128)
    sass = hot_loop_sass("vmec_geom_kernel", [("LDG.E.128", 3)])
    print(f"[17 vmec_geom time] {n} rays x {g} modes f32: {ms:.4f} ms "
          f"per call (CUDA events, wrapper included); kernel on the device "
          f"{dev_ms} ms (profiler); plain version {plain_ms:.4f} ms; bound "
          f"{b_ms:.4f} ms, by {b_by} ({bound_sides(ops, nbytes)}); SASS of "
          f"the mode loop {json.dumps(sass)}; max "
          f"abs error {err:.3e}; worst sum's deviation relative to its "
          f"scale {dev:.3e} ({vmec_geom.JET_NAMES[worst]}; limit "
          f"{K4_TOL[torch.float32]}; the last mode dropped {dropped:.3e})")
    if not dev <= K4_TOL[torch.float32]:
        raise AssertionError(f"vmec_geom vs plain at {n} rays: {dev}")
    records = [{"name": "vmec_geom", "route": "cuda",
                "source": "graph_framework_tpu_torch/csrc/vmec_geom.cu",
                "replaces": "graph_framework_tpu/pallas/vmec_geom.py:163",
                "launches": main["launches"], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}]
    records.append(vmec_rhs_record(main, tables, coords))

    blocks = [b.contiguous() for b in eq.radial_modes(coords[0])]
    args = (coords[1], coords[2], *blocks, eq.xm, eq.xn)
    m = eq.xm.shape[0]
    got = torch.stack(vmec_modes.mode_sums(*args))
    want = torch.stack(vmec_modes.reference_forward(*args))
    err = float((got.double() - want.double()).abs().max())
    dev = max(relative_rows(got, want, sum_scale))
    del got, want
    ms = event_ms(lambda: vmec_modes.mode_sums(*args), 50)
    plain_ms = event_ms(lambda: vmec_modes.reference_forward(*args), 5)
    dev_ms, _, _ = profile_kernel(
        lambda: [vmec_modes.mode_sums(*args) for _ in range(20)],
        kernel=("vmec_modes_kernel",))
    ops = n * (vmec_modes.MODE_SUM_OPS["per_ray_fixed"]
               + vmec_modes.MODE_SUM_OPS["per_mode"] * m)
    nbytes = 4 * (n * (2 + 5 * m + len(vmec_modes.SUM_NAMES)) + 2 * m)
    b_ms, b_by = bound(ops, nbytes, torch.float32)
    print(f"[17 vmec_modes time] {n} rays x {m} modes f32: {ms:.4f} ms per "
          f"call (CUDA events, wrapper included); kernel on the device "
          f"{dev_ms} ms (profiler); plain version {plain_ms:.4f} ms; bound "
          f"{b_ms:.4f} ms, by {b_by} ({bound_sides(ops, nbytes)}); max "
          f"abs error {err:.3e}; worst sum's deviation relative to its "
          f"scale {dev:.3e} (limit {K7_TOL[torch.float32]}); launches on "
          f"the main path 0 (no path calls K7)")
    if not dev <= K7_TOL[torch.float32]:
        raise AssertionError(f"vmec_modes vs plain at {n} rays: {dev}")
    records.append({"name": "vmec_modes", "route": "cuda",
                    "source": "graph_framework_tpu_torch/csrc/vmec_modes.cu",
                    "replaces": "graph_framework_tpu/pallas/vmec_modes.py:35",
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None})
    return records


# -- the xrays pipeline through its CLI (phases 19 and 20) -------------------
# Phase 19 drives the port's xrays phase function (cli/xrays.run_xrays) as
# `python -m graph_framework_tpu_torch.cli.xrays` would on the card, over
# the synthetic map (no efit.nc, no h5py there: the rows go to
# MemoryFiles): cold plasma, 100k rays, 100 recorded rows x 10 substeps =
# 1000 steps of dt 1e-4 (xrays_bench's shape, uncut), this script's launch
# as CLI options, 16 rows a host block, weak-damping absorption and power
# binning.  kamp on three rows is evaluated again on the CPU, complex128
# over the same f32 tables; the card's complex128 differs from it only in
# rounding.
PIPELINE_ROWS = 100                  # recorded rows after the launch row
KAMP_RTOL = 1.0e-10
KAMP_ROWS = (0, 50, 100)
ROOT_FIND_ROWS = 11


def xrays_args(n, *extra):
    """The CLI options of phase 19 (``--device`` left at the card)."""
    return xrays.build_parser().parse_args([
        "--dispersion=cold_plasma", "--equilibrium=efit",
        f"--num_rays={n}", f"--num_times={10 * PIPELINE_ROWS}",
        "--sub_steps=10", f"--endtime={DT * 10 * PIPELINE_ROWS}",
        f"--init_w_mean={W0}", f"--init_x_mean={X0}",
        "--init_x_dist=normal", f"--init_x_sigma={X_SPREAD}",
        f"--init_ky_mean={KY0}", "--init_ky_dist=normal",
        f"--init_ky_sigma={KY_SPREAD}", f"--init_kx_mean={KX0}",
        "--stream_segment=16", f"--seed={SEED}", *extra])


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def state_of_row(store, i, dtype, device):
    """Row i of a stored trace as a RayState."""
    row = store.read_step(i, list(absorption.STATE_NAMES))
    return RayState(*[torch.as_tensor(row[n], dtype=dtype, device=device)
                      for n in absorption.STATE_NAMES])


def phase_xrays(device, n=100_000, check_launches=True, options=(),
                with_absorption=True, label="19"):
    """Phase 19: the xrays pipeline at full width through the CLI's phase
    function; then the root finder over the first ROOT_FIND_ROWS rows.
    ``options``: more CLI options (a rehearsal on the CPU names the
    production stack's; phase 19d the dispersion); without
    ``with_absorption`` the trace alone (phase 1), checked as phase 19
    checks it, with no weak damping, kamp or root finder."""
    args = xrays.resolve_stack(xrays_args(
        n, *(["--absorption_model=weak_damping"] if with_absorption
             else []),
        f"--device={device}", *options), device)
    disp = DISPERSIONS[args.dispersion]
    stack = (args.solver, args.frozen_cells, args.freeze_every,
             args.compensated, args.window_kernel, args.x64)
    if check_launches and stack != ("rk2", True, 10, True, True, False):
        raise AssertionError(f"the CLI's stack on the card: {stack}")
    eq = synthetic_equilibrium(torch.float32, device)
    files = MemoryFiles()
    reset_launch_counts()
    t0 = time.perf_counter()
    run = xrays.run_xrays(args, eq, files.open)
    wall = time.perf_counter() - t0
    store = files[args.output]
    launches = efit_step.efit_window_launches
    windows = PIPELINE_ROWS * args.sub_steps // args.freeze_every
    warm_up = args.sub_steps // args.freeze_every
    if check_launches and launches != windows + warm_up:
        raise AssertionError(f"phase {label}: {launches} K1 launches, "
                             f"expected {windows} + {warm_up}")

    # the trace's last row against Solver.trace_segmented from the same
    # launch state (same kernels, same inputs: bit for bit); where phase
    # 1's time goes: the same trace without the writer, without the
    # residual, and the recorded steps alone (Solver.run)
    res = residual_fn(disp, eq)

    def seconds(fn):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        return out, time.perf_counter() - t0

    with torch.no_grad():
        final, seg_s = seconds(lambda: run.solver.trace_segmented(
            run.initial, PIPELINE_ROWS, lambda i, row: None))
        _, extras_s = seconds(lambda: run.solver.trace_segmented(
            run.initial, PIPELINE_ROWS, lambda i, row: None, segment=16,
            extras=lambda st: {"residual": res(st)}))
        _, run_s = seconds(lambda: run.solver.run(run.initial,
                                                  PIPELINE_ROWS))
    phase1 = {"trace_s (CLI: residual, writer, store)": run.timings[
        "trace_s"], "trace_segmented with the residual, no writer":
        extras_s, "trace_segmented, no residual, no writer": seg_s,
        "Solver.run (no rows)": run_s}
    last = state_of_row(store, store.num_steps - 1, torch.float64, "cpu")
    same = all(torch.equal(a, b.double().cpu()) for a, b in zip(last, final))
    xyz = [torch.from_numpy(store.stack(c)) for c in ("x", "y", "z")]
    r = torch.sqrt(xyz[0] ** 2 + xyz[1] ** 2)
    nr, nz = eq.psi_coeffs.shape[:2]
    leaves = [torch.from_numpy(store.stack(name))
              for name in absorption.STATE_NAMES]
    finite = all(bool(torch.isfinite(l).all()) for l in leaves)
    inside = bool(((r >= eq.rmin) & (r <= eq.rmin + eq.dr * nr)
                   & (xyz[2] >= eq.zmin)
                   & (xyz[2] <= eq.zmin + eq.dz * nz)).all())
    t = run.timings
    trace_text = (
        f"{n} rays x {PIPELINE_ROWS} rows x {args.sub_steps} steps, "
        f"{args.dispersion}, synthetic EFIT, production stack {stack}, into "
        f"MemoryStore (the card has no h5py: no file written), "
        f"{store.nbytes() / 1e9:.3f} GB of host rows; timings "
        f"{json.dumps(t)}; wall {wall:.3f} s; {launches} K1 launches; last "
        f"row equals trace_segmented bit for bit: {same}; all rows finite "
        f"{finite}, in the psi grid {inside}")
    if not with_absorption:
        print(f"[{label} xrays CLI] {trace_text}; phase 1's seconds by what "
              f"it does: {json.dumps(phase1)}")
        if not (same and finite and inside):
            raise AssertionError(f"phase {label}: the trace's checks failed")
        return {"launches": launches, "timings": t}
    kamp = store.stack("kamp")
    power = store.stack("power")

    # kamp on three rows: the card against the CPU, complex128
    cpu_eq = synthetic_equilibrium(torch.float32, "cpu")
    update = absorption.make_weak_damping(cpu_eq)
    kamp_dev = 0.0
    with torch.no_grad():
        for i in KAMP_ROWS:
            want = update(state_of_row(store, i, torch.complex128, "cpu"))
            ok = torch.isfinite(want.real) & torch.isfinite(want.imag)
            want = torch.where(ok, want, torch.zeros_like(want)).numpy()
            kamp_dev = max(kamp_dev, float(np.abs(kamp[i] - want).max()
                                           / np.abs(want).max()))
    print(f"[19 xrays CLI] {trace_text}; "
          f"kamp finite {bool(np.isfinite(kamp).all())}, zero (scrubbed or "
          f"undamped) {int((kamp == 0).sum())}, max |Im kamp| "
          f"{float(np.abs(kamp.imag).max()):.6e}; kamp rows {KAMP_ROWS} "
          f"against the CPU complex128 evaluation: {kamp_dev:.3e} (limit "
          f"{KAMP_RTOL}); power min {float(power.min()):.9f}")
    rates = {"trace ray-steps/s": t["trace_ray_steps_per_s"],
             "absorption ray-rows/s": n * store.num_steps
             / t["absorption_s"],
             "bin_power ray-rows/s": n * store.num_steps / t["bin_power_s"]}
    print(f"[19 xrays CLI rates] {json.dumps(rates)}; phase 1's seconds "
          f"by what it does: {json.dumps(phase1)}")
    if not (same and finite and inside and np.isfinite(kamp).all()
            and kamp_dev <= KAMP_RTOL and (power <= 1.0).all()
            and (np.diff(power, axis=0) <= 0.0).all()):
        raise AssertionError("phase 19: the pipeline's checks failed")

    # the root finder over the first rows
    rows = MemoryStore(n)
    for name in absorption.STATE_NAMES:
        rows.create_variable(name)
        for i in range(ROOT_FIND_ROWS):
            rows.rows[name][i] = store.rows[name][i]
    finder = absorption.make_root_finder(eq, return_diagnostics=True)
    diags = []

    def update_rf(state):
        kamp_rf, diag = finder(state)
        diags.append(diag)
        return kamp_rf

    t0 = time.perf_counter()
    with torch.no_grad():
        absorption.run_absorption(rows, eq, update_fn=update_rf,
                                  device=device)
    sync(device)
    seconds = time.perf_counter() - t0
    kamp_rf = rows.stack("kamp")
    print(f"[19 root_find] {n} rays x {ROOT_FIND_ROWS} rows: {seconds:.3f} "
          f"s; iterations {[d.iterations for d in diags]}; converged share "
          f"{sum(d.converged for d in diags) / len(diags)}; final max "
          f"|D|^2 {[float(d.residual) for d in diags]}; kamp finite "
          f"{bool(np.isfinite(kamp_rf).all())}")
    if not np.isfinite(kamp_rf).all():
        raise AssertionError("phase 19: root-find kamp not finite")
    return {"launches": launches, "timings": t}


# Phase 19's damped leg (19c): tests/test_torch_absorption.py's "efit"
# launch near the synthetic map's electron cyclotron resonance on its axis
# (R = 2 m, B along y), as CLI options: w 215 /m, x normal around 2.0 m,
# a parallel ky normal around 100 /m, kx Newton-solved from 50 /m.  zeta is
# of order 1 there, so kamp has an imaginary part and power falls along
# nearly every ray; the few rays launched almost parallel (kx ~ 0) get an
# Im kamp of about -1e-7, so their power rises by about 3e-8 (the JAX
# package's weak damping gives the same sign there), and power's
# monotonicity is not asked here.  The card's kamp on three rows, again
# with i 20 /m added to kx (a complex gradient of Dc), the root finder on
# the middle row (at test_absorption.py's tolerance 1e-24) and bin_power
# are each held to the same function on the CPU over the same rows, ray by
# ray.
DAMPED = dict(w=215.0, x=2.0, x_spread=0.01, ky=100.0, ky_spread=5.0,
              kx=50.0)                  # launch()'s keywords
DAMPED_OPTIONS = (
    f"--init_w_mean={DAMPED['w']}", f"--init_x_mean={DAMPED['x']}",
    f"--init_x_sigma={DAMPED['x_spread']}",
    f"--init_ky_mean={DAMPED['ky']}",
    f"--init_ky_sigma={DAMPED['ky_spread']}",
    f"--init_kx_mean={DAMPED['kx']}")
DAMPED_ROWS = 10                     # recorded rows after the launch row
DAMPED_KAMP_ROWS = (0, 5, 10)
DAMPED_SHARE = 0.99                  # rays whose power falls, at least
ROOT_CHECK_RAYS = 2048               # rays the CPU root-finds again
POWER_ATOL = 1.0e-12                 # bin_power, card against CPU (f64)


def per_ray_deviation(got, want):
    """max over the rays of |got - want| / |want|, where ``want`` is
    finite, and whether ``got`` is 0 (the SAFE_MATH scrub) or non-finite
    wherever ``want`` is not finite."""
    got, want = np.asarray(got), np.asarray(want)
    ok = np.isfinite(want)
    with np.errstate(invalid="ignore"):
        dev = np.abs(got[ok] - want[ok]) / np.abs(want[ok])
    scrubbed = bool(((got[~ok] == 0) | ~np.isfinite(got[~ok])).all())
    return float(dev.max()), scrubbed


def phase_xrays_damped(device, n=100_000, check_launches=True, options=()):
    """Phase 19c: the CLI's phase function at the damped launch
    (DAMPED_OPTIONS), DAMPED_ROWS rows x 10 steps, weak damping and power;
    kamp, the root finder and bin_power on the card against the CPU."""
    args = xrays.resolve_stack(xrays_args(
        n, f"--num_times={10 * DAMPED_ROWS}",
        f"--endtime={DT * 10 * DAMPED_ROWS}", *DAMPED_OPTIONS,
        "--absorption_model=weak_damping", f"--device={device}", *options),
        device)
    eq = synthetic_equilibrium(torch.float32, device)
    cpu_eq = synthetic_equilibrium(torch.float32, "cpu")
    files = MemoryFiles()
    reset_launch_counts()
    run = xrays.run_xrays(args, eq, files.open)
    launches = efit_step.efit_window_launches
    store = files[args.output]
    kamp, power = store.stack("kamp"), store.stack("power")

    # kamp on three rows, and with i 20 /m added to kx
    weak_cpu = absorption.make_weak_damping(cpu_eq)
    weak_dev = absorption.make_weak_damping(eq)
    kamp_dev = kamp_dev_complex = 0.0
    scrubbed = True
    with torch.no_grad():
        for i in DAMPED_KAMP_ROWS:
            row = state_of_row(store, i, torch.complex128, "cpu")
            dev, scr = per_ray_deviation(kamp[i], weak_cpu(row).numpy())
            row = row._replace(kx=row.kx + 20j)
            got = weak_dev(RayState(*[l.to(device) for l in row]))
            dev_c, scr_c = per_ray_deviation(got.cpu().numpy(),
                                             weak_cpu(row).numpy())
            kamp_dev = max(kamp_dev, dev)
            kamp_dev_complex = max(kamp_dev_complex, dev_c)
            scrubbed = scrubbed and scr and scr_c

    # the root finder on the middle row: the whole row on the card, timed;
    # its first ROOT_CHECK_RAYS rays on the card and on the CPU
    mid = state_of_row(store, DAMPED_ROWS // 2, torch.complex128, "cpu")
    finder = absorption.make_root_finder(eq, tolerance=1e-24,
                                         return_diagnostics=True)
    with torch.no_grad():
        sync(device)
        t0 = time.perf_counter()
        kamp_rf, diag = finder(RayState(*[l.to(device) for l in mid]))
        sync(device)
        rf_s = time.perf_counter() - t0
        part = RayState(*[l[:ROOT_CHECK_RAYS] for l in mid])
        got, diag_part = finder(RayState(*[l.to(device) for l in part]))
        want, diag_cpu = absorption.make_root_finder(
            cpu_eq, tolerance=1e-24, return_diagnostics=True)(part)
    rf_dev, rf_scrubbed = per_ray_deviation(got.cpu().numpy(),
                                            want.numpy())

    # bin_power on the card (the CLI's) against the CPU over the same rows
    xyz = [torch.from_numpy(store.stack(c)) for c in ("x", "y", "z")]
    want_power, _ = absorption.bin_power(*xyz,
                                         torch.from_numpy(kamp.imag))
    power_dev = float(np.abs(power - want_power.numpy()).max())
    lost = float((power[-1] < 1.0).mean())
    t = run.timings
    print(f"[19c xrays CLI, damped launch] {n} rays x {DAMPED_ROWS} rows x "
          f"{args.sub_steps} steps at {' '.join(DAMPED_OPTIONS)}: timings "
          f"{json.dumps(t)}; {launches} K1 launches; max |Im kamp| "
          f"{float(np.abs(kamp.imag).max()):.6e}, rays with Im kamp < 0 "
          f"on a row {int((kamp.imag < 0).any(axis=0).sum())}, zero "
          f"(scrubbed) {int((kamp == 0).sum())}; power min "
          f"{float(power.min()):.9f}, max {float(power.max()):.12f}, share "
          f"of rays that lost power {lost} (at least {DAMPED_SHARE}); kamp "
          f"rows {DAMPED_KAMP_ROWS} against the CPU, ray by ray "
          f"{kamp_dev:.3e}, with kx + 20j {kamp_dev_complex:.3e} (limit "
          f"{KAMP_RTOL}); root finder on row {DAMPED_ROWS // 2}: "
          f"{rf_s:.3f} s, {diag.iterations} iterations, converged "
          f"{diag.converged}, max |D|^2 {float(diag.residual):.3e}, max "
          f"|Im kamp| {float(kamp_rf.imag.abs().max()):.6e}; its first "
          f"{ROOT_CHECK_RAYS} rays against the CPU, ray by ray "
          f"{rf_dev:.3e} ({diag_part.iterations} and "
          f"{diag_cpu.iterations} iterations, max |D|^2 "
          f"{float(diag_part.residual):.3e} and "
          f"{float(diag_cpu.residual):.3e}; limit {KAMP_RTOL}); bin_power "
          f"against the CPU {power_dev:.3e} (limit {POWER_ATOL})")
    checks = {
        "launches": not check_launches or launches == DAMPED_ROWS + 1,
        "kamp finite": bool(np.isfinite(kamp).all()),
        "damped": float(power.min()) < 0.999 and lost >= DAMPED_SHARE,
        "kamp": kamp_dev <= KAMP_RTOL and scrubbed,
        "kamp at complex kx": kamp_dev_complex <= KAMP_RTOL,
        "root finder": rf_dev <= KAMP_RTOL and rf_scrubbed
        and float(want.imag.abs().max()) > 0.01,
        "bin_power": power_dev <= POWER_ATOL}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 19c: {failed}")


def special_points(n, seed=SEED):
    """About n complex points over every branch of w and erf: the
    continued fraction's |z| >= 6 and the switch at |z| = 6, the series
    disk |z| < 0.2, both axes, the lower half-plane, and the overflow edges
    of exp(-z^2) on the imaginary axis."""
    rng = np.random.default_rng(seed)
    m = n // 5
    ring = 6.0 * np.exp(2j * np.pi * rng.random(m)) * (
        1.0 + 0.02 * rng.standard_normal(m))
    edge = 1j * np.concatenate([np.linspace(-27.5, -25.5, m // 2),
                                np.linspace(25.5, 27.5, m // 2)])
    return np.concatenate([
        rng.uniform(-12, 12, m) + 1j * rng.uniform(-8, 8, m),
        ring, 0.2 * np.sqrt(rng.random(m)) * np.exp(
            2j * np.pi * rng.random(m)),
        rng.uniform(-10, 10, m // 2) + 0j, 1j * rng.uniform(-10, 10, m // 2),
        edge + rng.uniform(-0.5, 0.5, edge.size)])


# Phase 20 holds each function to scipy.special (float64 on the host, at
# the points as the working dtype holds them) by the JAX package's test
# limits in complex128/float64 (tests/test_special.py): wofz 5e-13 and erf
# 2e-12 of the value's magnitude; dawson rtol 1e-12 with atol 1e-15;
# erfcx rtol 1e-12.  complex64/float32 have no JAX test: f32 rounding,
# about 200 ulp.  erf has complex zeros, where no relative limit holds in
# f32, so complex64 deviations are taken against max(|value|, 1).  Points
# count where scipy's value, and exp(-z^2) (a factor of both formulas,
# as in the JAX package), lie inside the dtype's range.
SPECIAL_TOL = {
    "wofz c128": (5e-13, 0.0), "erf_complex c128": (2e-12, 0.0),
    "dawson f64": (1e-12, 1e-15), "erfcx f64": (1e-12, 0.0),
    "wofz c64": (2e-5, 2e-5), "erf_complex c64": (2e-5, 2e-5),
    "dawson f32": (0.0, 1e-6), "erfcx f32": (1e-5, 0.0)}


def phase_special(device, n=1_000_002):
    """Phase 20: wofz, erf_complex, dawson and erfcx on the card in
    complex128/float64 and complex64/float32 over ``special_points``
    against scipy.special: |got - want| <= rtol |want| + atol
    (SPECIAL_TOL) wherever scipy's value lies inside the dtype's range,
    and the same points finite."""
    import scipy.special as sps

    z = special_points(n)
    x = np.concatenate([z.real, z.imag])
    reference = {"wofz": sps.wofz, "erf_complex": sps.erf,
                 "dawson": sps.dawsn, "erfcx": sps.erfcx}
    rows = {}
    for tag, cdt, rdt in (("128", torch.complex128, torch.float64),
                          ("64", torch.complex64, torch.float32)):
        top = torch.finfo(rdt).max / 10.0
        for name, points, dt in (("wofz", z, cdt), ("erf_complex", z, cdt),
                                 ("dawson", x, rdt), ("erfcx", x, rdt)):
            key = f"{name} {'c' if dt.is_complex else 'f'}" + (
                tag if dt.is_complex else {"128": "64", "64": "32"}[tag])
            pt = torch.as_tensor(points, device=device).to(dt)
            getattr(special, name)(pt)       # first use: kernels' set-up
            sync(device)
            t0 = time.perf_counter()
            got = getattr(special, name)(pt)
            sync(device)
            ms = 1e3 * (time.perf_counter() - t0)
            host = pt.cpu().to(torch.complex128 if dt.is_complex
                               else torch.float64).numpy()
            want = reference[name](host)
            got = got.cpu().to(torch.complex128 if dt.is_complex
                               else torch.float64).numpy()
            rtol, atol = SPECIAL_TOL[key]
            with np.errstate(invalid="ignore", over="ignore"):
                inside = np.isfinite(want) & (np.abs(want) < top)
                if dt.is_complex:
                    # exp(-z^2), a factor of both formulas, within range
                    inside &= (host.imag ** 2 - host.real ** 2
                               < np.log(torch.finfo(rdt).max))
                excess = (np.abs(got - want) - rtol * np.abs(want) - atol
                          * (np.maximum(np.abs(want), 1.0)
                             if dt.is_complex else 1.0))[inside]
            rows[key] = dict(points=int(pt.numel()), ms=ms,
                             worst_excess=float(excess.max()),
                             finite=bool(np.isfinite(got[inside]).all()))
    print(f"[20 special functions on the card] {z.size} complex points "
          f"(|z| = 6 ring, series disk, axes, lower half-plane, overflow "
          f"edges), {x.size} real; per function and dtype the worst "
          f"|got - scipy| - (rtol |scipy| + atol) (must be <= 0) and the "
          f"second call's wall ms: {json.dumps(rows)}; limits (rtol, atol) "
          f"{json.dumps(SPECIAL_TOL)}")
    bad = {k: v for k, v in rows.items()
           if not (v["worst_excess"] <= 0.0 and v["finite"])}
    if bad:
        raise AssertionError(f"phase 20: {bad}")


# -- the embedding layer (phase 21) --------------------------------------------
# A light wave D = w^2 - c^2 (kx^2 + ky^2 + kz^2) - wp^2(x, z) built through
# the port's graph API (expr.py), in the port's normalized units (w = omega
# / c in 1/m, so c^2 = 1: the constant folds away as the reference's
# reduce() folds it), at the EFIT main path's 1M-ray width.  21a: wp^2 is a
# piecewise_2D over the synthetic map's 129 x 129 grid (wp^2 of the density
# of synthetic_samples at each node, its values rounded to f32 so that the
# f32 and f64 graphs gather the same numbers); the launch positions lie at
# cell centres (1 + (i + 1/2) / 64 m: exact in f32, so the f32 graph's
# truncated index is the f64 one's; a position next to a cell edge would
# fall into the neighbouring cell in f32).  21b: wp^2 is the analytic
# profile EMBED_WP0_2 exp(-((x - R0)^2 + z^2) / EMBED_A^2) built from graph
# nodes, since a table node's df is 0 (expr.py, as in the reference).
EMBED_C2 = 1.0
EMBED_KX_GUESS = 500.0
EMBED_KZ_SPREAD = 10.0
EMBED_MAX_ITER = 40
EMBED_WP0_2, EMBED_A = 7.0e4, 0.5
EMBED_DT, EMBED_STEPS = 1.0e-3, 100
# Limits of 21a: kx against the closed-form root sqrt((w^2 - wp^2)/c^2 -
# ky^2 - kz^2) with wp^2 from ops.tables.piecewise_2d on the same table, in
# f64, and the card's f64 Newton against the CPU's f64 run of the same
# Workflow at EMBED_REFEREE_RAYS rays (the same IEEE operations in the
# same order: a few ulp).  f32 (derived): D = w^2 - (kx^2 + ky^2 + kz^2) -
# wp^2 rounds to within about 3 eps S, S = w^2 + k^2 + wp^2, so Newton
# stalls where |D| is that, kx within 3 eps S / (2 kx^2) of the root, and
# kx itself rounds by eps / 2: the limit is EMBED_F32_SAFETY times
# eps (1/2 + 3 S / (2 kx^2)) at the worst ray (about 1.2e-6 here).
EMBED_F64_TOL = 1.0e-10
EMBED_REFEREE_F64_TOL = 1.0e-12
EMBED_F32_SAFETY = 2.0
EMBED_REFEREE_RAYS = 4099
# Limits of 21b, per group (position, wave vector) relative to its scale,
# against the CPU's f64 run at EMBED_REFEREE_RAYS rays: a step rounds each
# leaf by eps / 2 of its scale and its increment (dt times a rate) by a
# few eps of itself, and the rays separate slowly over 0.1 m (the profile's
# scale is 0.5 m), so EMBED_LOOP_ULPS eps a step, over the steps.  Each
# limit must lie SEPARATION times below what a wrong graph shows (the
# kx setter with its sign flipped).
EMBED_LOOP_ULPS = 4.0


def embedding_table():
    """wp^2 (1/m^2) of the synthetic map's density on its 129 x 129 grid,
    rounded to f32; and (dr, rmin, dz, zmin) of its cells."""
    s = synthetic_samples()
    ne = np.interp(s["psi"], s["psi_profile"], s["ne"])
    table = plasma_frequency_squared(ne, Q, ME)
    dr = (R_RANGE[1] - R_RANGE[0]) / (GRID - 1)
    dz = (Z_RANGE[1] - Z_RANGE[0]) / (GRID - 1)
    return (table.astype(np.float32).astype(np.float64),
            (dr, R_RANGE[0], dz, Z_RANGE[0]))


def _f32_values(arrays):
    return {k: v.astype(np.float32).astype(np.float64)
            for k, v in arrays.items()}


def embedding_launch(n, seed=SEED):
    """21a's launch as f32-representable float64 arrays: x and z at cell
    centres of the table (both ends' cells excluded), y 0, w W0, ky and kz
    spread normally, kx the Newton guess."""
    rng = np.random.default_rng(seed)
    dr, rmin, dz, zmin = embedding_table()[1]
    cells = rng.integers(1, GRID - 2, size=(2, n))
    return _f32_values(dict(
        w=np.full(n, W0), x=rmin + (cells[0] + 0.5) * dr, y=np.zeros(n),
        z=zmin + (cells[1] + 0.5) * dz, kx=np.full(n, EMBED_KX_GUESS),
        ky=KY0 + KY_SPREAD * rng.standard_normal(n),
        kz=EMBED_KZ_SPREAD * rng.standard_normal(n)))


def loop_launch(n, seed=SEED):
    """21b's launch: positions within 0.3 m of the profile's centre, kx on
    the dispersion surface of the analytic profile (f32-representable)."""
    rng = np.random.default_rng(seed + 1)
    launch = embedding_launch(n, seed)
    launch["x"] = R0 + 0.3 * (2.0 * rng.random(n) - 1.0)
    launch["z"] = 0.3 * (2.0 * rng.random(n) - 1.0)
    wp2 = EMBED_WP0_2 * np.exp(-((launch["x"] - R0) ** 2 + launch["z"] ** 2)
                               / EMBED_A ** 2)
    launch["kx"] = np.sqrt(launch["w"] ** 2 - wp2 - launch["ky"] ** 2
                           - launch["kz"] ** 2)
    return _f32_values(launch)


def light_wave(v, wp2):
    """D = w^2 - c^2 (kx^2 + ky^2 + kz^2) - wp^2 on the graph's variables."""
    return (v["w"] * v["w"] - expr.constant(EMBED_C2)
            * (v["kx"] * v["kx"] + v["ky"] * v["ky"] + v["kz"] * v["kz"])
            - wp2)


def embedding_variables(launch, dtype, device, rays=slice(None)):
    return {name: expr.variable(len(value[rays]), value[rays], name,
                                dtype=dtype, device=device)
            for name, value in launch.items()}


def embedding_newton(launch, dtype, device, rays=slice(None)):
    """21a's Workflow: expr.newton for kx, D over the table.  Returns the
    compiled workflow and its variables."""
    table, (dr, rmin, dz, zmin) = embedding_table()
    v = embedding_variables(launch, dtype, device, rays)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    wp2 = expr.piecewise_2D(table.astype(np_dtype), GRID, v["x"], dr, rmin,
                            v["z"], dz, zmin)
    work = expr.Workflow(device=device)
    expr.newton(work, [v["kx"]], list(v.values()), light_wave(v, wp2),
                max_iterations=EMBED_MAX_ITER)
    work.compile()
    return work, v


def embedding_loop(launch, dtype, device, rays=slice(None), wrong=False):
    """21b's Workflow: a loop item of EMBED_STEPS explicit ray steps from
    df of D (position by -dD/dk / dD/dw, k by dD/dx / dD/dw; all setters
    read the state before the step), D over the analytic profile.  With
    ``wrong``, the kx setter's sign is flipped."""
    v = embedding_variables(launch, dtype, device, rays)
    wp2 = expr.constant(EMBED_WP0_2) * expr.exp(
        -((v["x"] - R0) * (v["x"] - R0) + v["z"] * v["z"])
        / expr.constant(EMBED_A ** 2))
    d = light_wave(v, wp2)
    dw = d.df(v["w"])
    dt = expr.constant(EMBED_DT)
    pairs = (("x", "kx"), ("y", "ky"), ("z", "kz"))
    setters = [(v[p] - dt * d.df(v[k]) / dw, v[p]) for p, k in pairs]
    setters += [(v[k] + (-1.0 if wrong and k == "kx" else 1.0) * dt
                 * d.df(v[p]) / dw, v[k]) for p, k in pairs]
    work = expr.Workflow(device=device)
    work.add_loop_item(list(v.values()), [], setters, loops=EMBED_STEPS)
    work.compile()
    return work, v


def embedding_reset(work, v, launch):
    for name, value in launch.items():
        work.copy_to_device(v[name], torch.as_tensor(value).to(
            v[name].data.dtype))


def ray_group_deviations(got, want):
    """Per group (position x, y, z; wave vector kx, ky, kz) the largest
    |got - want| over the rays relative to the group's scale in want."""
    out = {}
    for group, names in (("pos", ("x", "y", "z")), ("k", ("kx", "ky", "kz"))):
        scale = max(float(np.abs(want[n]).max()) for n in names) or 1.0
        out[group] = max(_no_nan(np.abs(got[n] - want[n]).max())
                         for n in names) / scale
    return out


def host_state(v, rays=slice(None)):
    return {n: v[n].data.double().cpu().numpy()[rays]
            for n in ("x", "y", "z", "kx", "ky", "kz")}


def workflow_stats(work, reset, device):
    """A run of ``work`` after ``reset`` and a warm-up run (the first run
    pays each kernel's first launch): seconds (synchronized), device
    operations and device ms of a third run under the profiler, the busy
    share (device ms over the timed run's wall) and the peak memory of the
    runs above what was allocated before them."""
    reset()
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    work.run()
    reset()
    sync(device)
    t0 = time.perf_counter()
    work.run()
    sync(device)
    seconds = time.perf_counter() - t0
    reset()
    sync(device)
    ops, device_ms = device_work(work.run)
    return dict(seconds=seconds, device_ops=ops, device_ms=device_ms,
                busy=device_ms / (1e3 * seconds),
                peak_gb=(torch.cuda.max_memory_allocated() - start) / 1e9)


def phase_embedding(device, n=1_000_000, n_ref=EMBED_REFEREE_RAYS,
                    c_device=None):
    """Phase 21, the embedding layer (expr.py, capi_bridge.py, capi/): 21a
    Newton's converge item for kx over the table at ``n`` rays, f64 and
    f32, against the closed-form root and, on ``n_ref`` rays, the same
    Workflow on the CPU in f64; 21b a loop item of EMBED_STEPS ray steps
    from df of D at ``n`` rays, f64 and f32, against the CPU's f64 run on
    ``n_ref`` rays, each limit SEPARATION times below a wrong graph's
    deviation; 21c libgraph_tpu_torch.so built from the checkout and the
    unchanged capi/c_binding_test.c run against it with
    GRAPH_TORCH_DEVICE ``c_device`` (None: unset, the card)."""
    from graph_framework_tpu_torch.capi import build as capi_build

    cpu = torch.device("cpu")
    refs = slice(0, n_ref)
    table, (dr, rmin, dz, zmin) = embedding_table()
    launch = embedding_launch(n)
    lt = {k: torch.as_tensor(v, device=device) for k, v in launch.items()}
    wp2 = piecewise_2d(torch.as_tensor(table, device=device), lt["x"], dr,
                       rmin, lt["z"], dz, zmin)
    root = torch.sqrt((lt["w"] ** 2 - wp2) / EMBED_C2 - lt["ky"] ** 2
                      - lt["kz"] ** 2).cpu().numpy()
    cpu_work, cpu_v = embedding_newton(launch, torch.float64, cpu, refs)
    cpu_work.run()
    cpu_root = cpu_v["kx"].data.numpy()
    s = (launch["w"] ** 2 + root ** 2 + launch["ky"] ** 2
         + launch["kz"] ** 2 + wp2.cpu().numpy())
    f32_limit = EMBED_F32_SAFETY * float(np.finfo(np.float32).eps) * float(
        np.max(0.5 + 1.5 * s / root ** 2))
    limits = {torch.float64: (EMBED_F64_TOL, EMBED_REFEREE_F64_TOL),
              torch.float32: (f32_limit, f32_limit)}
    rows, checks = {}, {}
    for dtype in (torch.float64, torch.float32):
        work, v = embedding_newton(launch, dtype, device)
        stats = workflow_stats(work, lambda: embedding_reset(work, v, launch),
                               device)
        item = work.items[0]
        kx = v["kx"].data.double().cpu().numpy()
        closed = _no_nan(np.max(np.abs(kx - root) / np.abs(root)))
        referee = _no_nan(np.max(np.abs(kx[refs] - cpu_root)
                                 / np.abs(cpu_root)))
        tag = "f64" if dtype == torch.float64 else "f32"
        rows[tag] = dict(stats, iterations=item.iterations,
                         schedule_nodes=len(item.schedule),
                         vs_closed_form=closed, vs_cpu_f64=referee,
                         limits=limits[dtype])
        checks[f"21a {tag} closed form"] = closed <= limits[dtype][0]
        checks[f"21a {tag} cpu"] = referee <= limits[dtype][1]
        del work, v
    print(f"[21a embedding: Newton's converge item for kx] {n} rays, D = "
          f"w^2 - c^2 k^2 - wp^2(x, z) over the {GRID} x {GRID} table; per "
          f"dtype the seconds a run, device operations and device ms a run "
          f"(the profiler), busy share, peak GB, iterations, schedule nodes, "
          f"max relative |kx - closed form| and |kx - CPU f64| on {n_ref} "
          f"rays, and their limits: {json.dumps(rows)}")

    loop = loop_launch(n)
    cpu_work, cpu_v = embedding_loop(loop, torch.float64, cpu, refs)
    cpu_work.run()
    want = host_state(cpu_v)
    bad_work, bad_v = embedding_loop(loop, torch.float64, cpu, refs,
                                     wrong=True)
    bad_work.run()
    wrong = ray_group_deviations(host_state(bad_v), want)
    loop_rows = {}
    for dtype in (torch.float64, torch.float32):
        work, v = embedding_loop(loop, dtype, device)
        stats = workflow_stats(work, lambda: embedding_reset(work, v, loop),
                               device)
        dev = ray_group_deviations(host_state(v, refs), want)
        limit = EMBED_LOOP_ULPS * EMBED_STEPS * float(torch.finfo(dtype).eps)
        finite = all(bool(torch.isfinite(v[n].data).all())
                     for n in ("x", "y", "z", "kx", "ky", "kz"))
        tag = "f64" if dtype == torch.float64 else "f32"
        loop_rows[tag] = dict(stats, schedule_nodes=len(
            work.items[0].schedule), vs_cpu_f64=dev, limit=limit)
        checks[f"21b {tag} cpu"] = max(dev.values()) <= limit and finite
        checks[f"21b {tag} separation"] = (
            SEPARATION * limit <= max(wrong.values()))
        del work, v
    print(f"[21b embedding: a loop item of {EMBED_STEPS} ray steps from df "
          f"of D] {n} rays, dt {EMBED_DT}; the wrong graph (kx's setter sign "
          f"flipped) against the right one on the CPU: {json.dumps(wrong)}; "
          f"per dtype the seconds a run, device operations and device ms a "
          f"run (the profiler), busy share, peak GB, schedule nodes, the "
          f"deviation from the CPU's f64 run on {n_ref} rays by group and "
          f"its limit: {json.dumps(loop_rows)}")

    t0 = time.perf_counter()
    probe = capi_build.probe()
    exe = capi_build.build_program("c_binding_test.c")
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = subprocess.run([str(exe)], env=capi_build.program_env(c_device),
                         capture_output=True, text=True, timeout=600)
    ran = time.perf_counter() - t0
    passed = (run.returncode == 0
              and "All C binding tests passed." in run.stdout)
    checks["21c C binding"] = passed
    print(f"[21c embedding: the C library] probe {json.dumps(probe)}; "
          f"{exe.parent.name}/{capi_build.LIBRARY} and c_binding_test built "
          f"in {built:.3f} s; GRAPH_TORCH_DEVICE "
          f"{'unset (the card)' if c_device is None else c_device}: exit "
          f"{run.returncode} in {ran:.3f} s; "
          f"{' / '.join(run.stdout.strip().splitlines())}")
    if not passed:
        print(run.stderr[-4000:], file=sys.stderr)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 21: {failed}")
    return rows, loop_rows


# xrays_bench's depth in phase 19b: 20 recorded steps of 10 (the CLI's
# default is 100; its eager rk4 is launch-bound, 32 ms a step at 100k
# rays f32, so the rate does not depend on the depth).
BENCH_TIMES = 200


def phase_cli_extras(device, n_float=100_000, n_complex=10_000,
                     particles=100_000, check_launches=True):
    """xrays_bench's bench_one on the synthetic map (float at 100k rays,
    complex_double at 10k), and xpic's phase function through the card's
    K6 into MemoryStore stand-ins."""
    out = {}
    for name, n, dtype in (("float", n_float, torch.float32),
                           ("complex_double", n_complex, torch.float64)):
        eq = synthetic_equilibrium(dtype, device)
        res = xrays_bench.bench_one(name, None, n, BENCH_TIMES, 10, eq=eq,
                                    device=device)
        fin = res.pop("final")
        ok = all(bool(torch.isfinite(l).all()) for l in fin)
        out[name] = dict(res, rays=n, finite=ok)
        if not ok:
            raise AssertionError(f"xrays_bench {name}: not finite")
    stores = MemoryFiles()
    pic_args = xpic.build_parser().parse_args([
        f"--num_particles={particles}", "--num_grid=1000", "--num_steps=10",
        "--dt=1e-14", f"--seed={SEED}", f"--device={device}"])
    k6.deposit_launches = 0
    final, rate = xpic.run_xpic(pic_args, stores.open)
    launches = k6.deposit_launches
    dens = stores[pic_args.fields_output].read_step(0, ["n"])["n"]
    print(f"[19b xrays_bench and xpic CLIs] {json.dumps(out)}; xpic "
          f"{particles} particles x 1000 grid x 10 steps: {rate:.6e} "
          f"particle-steps/s, {launches} K6 launches, n.max() "
          f"{float(dens.max()):.6e}, rows in MemoryStore")
    if (check_launches and launches != 10) or not dens.max() > 0:
        raise AssertionError("xpic CLI: K6 was not launched each step")
    return launches


# -- ray ensembles split across processes (phase 22) ---------------------------
# Phase 22 runs its ranks as processes of this script (``RANK_FLAG``), each
# on the card with the kernel library phase 2 built (build.load finds the
# keyed file: no rank runs nvcc).  22a: two ranks on the one card, gloo
# (NCCL refuses two ranks on one device; gloo all-reduces CUDA tensors
# through the host).  22b: one rank, NCCL, whose all-reduce of one rank is
# the identity: the collectives are on the path, and its rows are the one
# process's.
RANK_FLAG = "--phase22-rank"
PARALLEL_TIMEOUT = 300               # seconds a rank may take
PARALLEL_LEGS = (("22a", 2, "gloo", True), ("22b", 1, "nccl", False))
COLLECTIVE_REPS = 20
# Config 5 in two ranks (1M rays, 4 batches of 125k a rank) against phase
# b5's one process (8 batches of the same rays).  A batch's value and its
# dL/dkz are the same bit for bit in both (K1 and the eager weak damping
# are deterministic, and dL/dkz sums per-ray cotangents); the order in which
# the 8 batches' sums are added differs: at most 2 (B - 1) roundings of
# u = 2^-24 each, relative to the sum when the batches add with one sign.
# dL/dpsi also carries the table scatter's atomics, whose order changes from
# run to run: phase b5's two passes differ by that alone, read in this run.  The
# limit of each quantity is CONFIG5_SUM_FACTOR times the larger of the two,
# and it must lie SEPARATION times below what a wrong reduction shows (one
# rank's share dropped, or counted twice).
CONFIG5_SUM_FACTOR = 20.0
F32_UNIT_ROUNDOFF = 2.0 ** -24


def parallel_rank(cfg):
    """One rank of phase 22 (``python3 chip_smoke.py --phase22-rank
    CONFIG``): joins the group, solves its slice of phase 4c's 1M-ray launch
    with ``init_k(mesh=)`` and traces it with ``Solver.run`` on the
    production stack; with ``cfg["config5"]`` it also saves a checkpoint
    and runs config 5's kernel form over its slice of phase b5's launch.
    Writes its rows and sums under ``cfg["out"]`` and prints one RANK line
    of JSON."""
    device = torch.device(cfg["device"])
    cuda = device.type == "cuda"
    if not cuda:
        torch.set_num_threads(1)
    world, rank = cfg["world"], cfg["rank"]
    address = f"localhost:{cfg['port']}"
    if cuda:
        # the rank's card, current before any CUDA call (initialize() makes
        # it current for NCCL only)
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if world > 1:
        distributed.initialize(address, world, rank, backend=cfg["backend"])
    else:
        # initialize() is a no-op for one process, as in the JAX package;
        # a group of one puts the backend's all-reduce on the path
        dist.init_process_group(cfg["backend"],
                                init_method=f"tcp://{address}",
                                world_size=1, rank=0)
    mesh = ray_mesh(device=cfg["device"])
    out, info = cfg["out"], {}

    def wall(fn):
        mesh.barrier()
        sync(mesh.device)
        t0 = time.perf_counter()
        result = fn()
        sync(mesh.device)
        return result, time.perf_counter() - t0

    def collective_ms(fn):
        _, seconds = wall(lambda: [fn() for _ in range(COLLECTIVE_REPS)])
        return 1e3 * seconds / COLLECTIVE_REPS

    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    eq = synthetic_equilibrium(torch.float32, mesh.device)
    pmesh.all_reduce_calls = 0
    (root, diag), info["newton_s"] = wall(lambda: init_k(
        shard_rays(launch(cfg["n"], torch.float32, mesh.device), mesh),
        cold_plasma, eq, return_diagnostics=True, mesh=mesh))
    info.update(iterations=diag.iterations,
                newton_all_reduces=pmesh.all_reduce_calls,
                newton_all_reduce_ms=collective_ms(
                    lambda: mesh.ensemble_max(diag.residual)))
    solver = production_solver(eq)
    run_blocked_sharded(solver, root, 1, mesh)     # K1's first launch
    reset_launch_counts()
    final, info["trace_s"] = wall(lambda: run_blocked_sharded(
        solver, root, cfg["steps"], mesh))
    info["launches"] = launch_counts()
    idx, _ = distributed.host_local_rows(final.x, mesh)
    torch.save(dict(idx=torch.from_numpy(idx),
                    rows=[leaf.cpu() for leaf in final]),
               f"{out}/rows{rank}.pt")
    if cfg["config5"]:
        save_ray_state(f"{out}/checkpoint", final, mesh=mesh)
        c5_root = init_k(shard_rays(launch(
            cfg["n"], torch.float32, mesh.device, **CONFIG5_LAUNCH), mesh),
            cold_plasma, eq, mesh=mesh)

        def config5(rank_mesh):
            value, grads = absorbed_power.absorbed_power_grad(
                eq, c5_root, cfg["c5_steps"], CONFIG5_SUB, eq.psi_coeffs,
                CONFIG5_KZ, form="kernel", batches=cfg["c5_batches"],
                mesh=rank_mesh)
            return [value, *grads]

        reset_launch_counts()
        sums, info["config5_s"] = wall(lambda: config5(mesh))
        info["config5_launches"] = launch_counts()
        info["config5_all_reduce_ms"] = collective_ms(
            lambda: mesh.all_reduce_sum(sums))
        # this rank's share (its slice without the all-reduce), untimed:
        # what a wrong reduction drops or counts twice
        share = config5(None)
        torch.save(dict(sums=[t.cpu() for t in sums],
                        share=[t.cpu() for t in share]),
                   f"{out}/config5_{rank}.pt")
    info["peak_gb"] = (torch.cuda.max_memory_allocated(mesh.device) / 1e9
                       if cuda else 0.0)
    mesh.barrier()
    dist.destroy_process_group()
    print("RANK " + json.dumps(info), flush=True)
    return 0


def run_ranks(configs):
    """Start one process a config, all together, and wait for each with
    its own timeout; kill every one that is left when one fails.  Returns
    the ranks' RANK lines."""
    procs = [subprocess.Popen(
        [sys.executable, __file__, RANK_FLAG, json.dumps(cfg)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cfg in configs]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=PARALLEL_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for cfg, proc, text in zip(configs, procs, outs):
        if proc.returncode != 0:
            raise AssertionError(f"phase 22 rank {cfg['rank']} of "
                                 f"{cfg['world']} exited "
                                 f"{proc.returncode}:\n{text[-4000:]}")
    return [json.loads(next(line[5:] for line in text.splitlines()
                            if line.startswith("RANK ")))
            for text in outs]


def config5_limits(passes, batches):
    """Phase 22's config 5 limits (value, dL/dpsi, dL/dkz): the batches'
    association bound, or b5's two passes' deviation, CONFIG5_SUM_FACTOR
    times the larger (see CONFIG5_SUM_FACTOR)."""
    association = 2 * (batches - 1) * F32_UNIT_ROUNDOFF
    return [CONFIG5_SUM_FACTOR * max(association, r) for r in
            relative_deviations(passes[0]["sums"], passes[1]["sums"])]


def phase_parallel(device, reference, n=1_000_000, steps=100,
                   c5_steps=CONFIG5_STEPS, c5_batches=CONFIG5_BATCHES,
                   legs=PARALLEL_LEGS, check_launches=True):
    """Phase 22: ray ensembles split across processes (``parallel``) on the
    card, each leg's ranks against ``reference``, phase 4c's one process
    (``one_process``: its rows, Newton iterations and seconds) and phase
    b5's (``config5``: its two passes).  Each rank: ``init_k(mesh=)`` (the
    iterations of one process, one ensemble-max all-reduce an iteration
    and the last test's), ``Solver.run`` over n / W rays x ``steps``
    (``steps`` K1 launches), its rows equal to the one process's bit for
    bit, ``host_local_rows`` partitioning the rays.  Where the leg runs
    config 5: the checkpoint its ranks saved restored by this process
    equal to the one process's rows, and config 5's kernel form in
    ``c5_batches`` / W batches a rank (K1 and K3 launches, no K2; every
    rank's sums the same) within ``config5_limits`` of b5's, each limit
    SEPARATION times below a wrong reduction."""
    one, c5 = reference["one_process"], reference["config5"]
    if device.type == "cuda":
        mode = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_mode",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(f"[22 compute mode] {mode}")
        torch.cuda.empty_cache()
    failed = []
    for leg, world, backend, with_c5 in legs:
        with tempfile.TemporaryDirectory(prefix=f"phase{leg}_") as out:
            port = free_port()
            infos = run_ranks([dict(
                device=device.type, world=world, rank=rank, port=port,
                backend=backend, out=out, n=n, steps=steps,
                config5=with_c5, c5_steps=c5_steps,
                c5_batches=c5_batches // world) for rank in range(world)])
            rows = [torch.load(f"{out}/rows{r}.pt") for r in range(world)]
            idx = torch.cat([r["idx"] for r in rows])
            bits = all(torch.equal(got, want[r["idx"]]) for r in rows
                       for got, want in zip(r["rows"], one["rows"]))
            checks = {
                "iterations": [i["iterations"] for i in infos]
                == [one["iterations"]] * world,
                "one all-reduce an iteration": all(
                    i["newton_all_reduces"] == i["iterations"] + 1
                    for i in infos),
                "rows bit for bit": bits,
                "host_local_rows partitions": torch.equal(
                    idx, torch.arange(n))}
            if check_launches:
                windows = steps * (SUB_STEPS // FREEZE_EVERY)
                checks["K1 launches"] = all(
                    tuple(i["launches"]) == (windows, 0, 0) for i in infos)
            if with_c5:
                whole = restore_ray_state(f"{out}/checkpoint", device="cpu")
                checks["checkpoint restored whole"] = all(
                    torch.equal(a, b) for a, b in zip(whole, one["rows"]))
            trace_s = max(i["trace_s"] for i in infos)
            print(f"[{leg} parallel, {world} rank(s), {backend}] {n} rays "
                  f"f32 x {steps} x {SUB_STEPS} on the production stack: "
                  f"init_k {[i['iterations'] for i in infos]} iterations "
                  f"(one process {one['iterations']}), with the launch "
                  f"{max(i['newton_s'] for i in infos):.3f} s, the "
                  f"ensemble max's all-reduce "
                  f"{[round(i['newton_all_reduce_ms'], 4) for i in infos]} "
                  f"ms a call; trace {trace_s:.3f} s = "
                  f"{n * steps * SUB_STEPS / trace_s:.6e} ray-steps/s "
                  f"(one process {one['seconds']:.3f} s), by rank "
                  f"{[round(i['trace_s'], 4) for i in infos]} s; launches "
                  f"K1/K2/K3 {[i['launches'] for i in infos]}; peak memory "
                  f"{[round(i['peak_gb'], 3) for i in infos]} GB a rank; "
                  f"checks {json.dumps(checks)}")
            if with_c5:
                failed += parallel_config5(leg, out, infos, c5, n, c5_steps,
                                           c5_batches, check_launches)
            failed += [f"{leg}: {k}" for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 22: {failed}")


def parallel_config5(leg, out, infos, c5, n, steps, batches,
                     check_launches):
    """Phase 22's config 5 checks and line; returns the failed checks."""
    world = len(infos)
    ranks = [torch.load(f"{out}/config5_{r}.pt") for r in range(world)]
    sums, want = ranks[0]["sums"], c5["passes"][1]["sums"]
    names = ("value", "dL/dpsi", "dL/dkz")
    dev = dict(zip(names, relative_deviations(sums, want)))
    limits = dict(zip(names, config5_limits(c5["passes"], batches)))
    repeat = dict(zip(names, relative_deviations(*[
        p["sums"] for p in c5["passes"]])))
    wrong = {name: min(
        relative_deviations([s + sign * r["share"][k]], [w])[0]
        for r in ranks for sign in (-1.0, 1.0))
        for k, (name, s, w) in enumerate(zip(names, sums, want))}
    windows = batches // world * steps * (CONFIG5_SUB
                                           // absorbed_power.FREEZE_EVERY)
    checks = {
        "every rank's sums": all(
            torch.equal(a, b) for r in ranks for a, b in zip(r["sums"], sums)),
        "within the limits": all(dev[k] <= limits[k] for k in names),
        "limits below a wrong reduction": all(
            SEPARATION * limits[k] <= wrong[k] for k in names)}
    if check_launches:
        checks["K1/K2/K3 launches"] = all(
            tuple(i["config5_launches"]) == (windows, 0, windows)
            for i in infos)
    seconds = max(i["config5_s"] for i in infos)
    print(f"[{leg} config 5 in {world} ranks] {n} rays f32 x {steps} x "
          f"{CONFIG5_SUB} rk4, {batches // world} batches a rank: "
          f"{seconds:.3f} s = {n * steps * CONFIG5_SUB / seconds:.6e} "
          f"fwd+bwd ray-steps/s (phase b5's one process: first pass "
          f"{c5['passes'][0]['seconds']:.3f} s, second "
          f"{c5['passes'][1]['seconds']:.3f} s); launches K1/K2/K3 "
          f"{[i['config5_launches'] for i in infos]}; the sums' all-reduce "
          f"{[round(i['config5_all_reduce_ms'], 4) for i in infos]} ms a "
          f"call; value {float(sums[0]):.3f} (one process "
          f"{float(want[0]):.3f}); relative deviations from b5's second "
          f"pass {json.dumps(dev)} (b5's two passes apart "
          f"{json.dumps(repeat)}), limits {json.dumps(limits)}, a wrong "
          f"reduction {json.dumps(wrong)}; checks {json.dumps(checks)}")
    return [f"{leg} config 5: {k}" for k, ok in checks.items() if not ok]


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    started = [time.perf_counter()]

    def lap(phases):
        # each group of phases' wall seconds, to read where the smoke's
        # time goes
        now = time.perf_counter()
        print(f"[lap] phases {phases}: {now - started[-1]:.1f} s")
        started.append(now)

    name, _ = phase_device()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    lap("1-2")
    phase_kernel_vs_plain(device)
    phase_bwd_vs_plain(device)
    phase_modes_vs_plain(device)
    phase_tails_vs_plain(device)
    lap("3-3c")
    out, eq32, st32 = phase_main(device)
    lap("4a-4c")
    counts, counts_tab = phase_grad_main(device)
    lap("b")
    counts_c5, eq_c5, batch_c5, passes_c5 = phase_config5(device)
    lap("b5")
    scatter_record = phase_table_scatter(device)
    lap("b7")
    phase_remat_policy(device)
    phase_grad_fd(device)
    lap("b6, c")
    phase_segmented(eq32, st32)
    phase_plain_timing(eq32, st32, out["rate_f32"])
    lap("5-6")
    records = [kernel_record(eq32, st32, out["launches"]), scatter_record]
    records += bwd_kernel_records(eq32, st32, counts[1], counts_tab[2])
    del eq32, st32
    # config 5's windows: plain rk4 at one batch of its path, dt 1 / 200
    c5_dt = 1.0 / (CONFIG5_STEPS * CONFIG5_SUB)
    records.append(kernel_record(eq_c5, batch_c5, counts_c5[0], dt=c5_dt,
                                 busy=False, method="rk4",
                                 compensated=False, label=" rk4"))
    records += bwd_kernel_records(
        eq_c5, batch_c5, None, counts_c5[2], dt=c5_dt, method="rk4",
        label=" rk4",
        referee=synthetic_equilibrium(torch.float64, batch_c5.x.device))
    del eq_c5, batch_c5
    lap("7")
    for mode, (eq, st, k1, k2, k3) in phase_modes_main(device).items():
        records.append(kernel_record(eq, st, k1, mode))
        records += bwd_kernel_records(eq, st, k2, k3, mode)
    for tag, (eq, st, dt, k1, k2, k3) in phase_tails_main(device).items():
        records.append(kernel_record(eq, st, k1, tag, dt, busy=False))
        records += bwd_kernel_records(eq, st, k2, k3, tag, dt)
    del eq, st
    lap("4d, 4e and their 7")
    phase_slab_vs_plain(device)
    slab = phase_slab_push(device)
    phase_korc_efit(device)
    phase_deposit_vs_plain(device)
    pic = phase_pic(device)
    records += particle_kernel_records(slab, pic)
    lap("8-13")
    phase_k4_vs_plain(device)
    phase_k7_vs_plain(device)
    records += vmec_kernel_records(phase_vmec_main(device))
    lap("14-17")
    phase_referee(device)
    lap("18")
    pipeline = phase_xrays(device)
    expansion = phase_xrays(
        device, options=("--dispersion=cold_plasma_expansion",),
        with_absorption=False, label="19d")
    phase_xrays_damped(device)
    pic_cli = phase_cli_extras(device)
    lap("19-19d")
    phase_special(device)
    phase_embedding(device)
    lap("20-21")
    phase_parallel(device, {"one_process": out["one_process"],
                            "config5": {"passes": passes_c5}})
    lap("22")
    for record in records:
        if record["name"] == "efit_window":
            record["launches_xrays_cli"] = pipeline["launches"]
        if record["name"] == "efit_window expansion":
            record["launches_xrays_cli"] = expansion["launches"]
        if record["name"] == "deposit":
            record["launches_xpic_cli"] = pic_cli
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [RANK_FLAG]:
        sys.exit(parallel_rank(json.loads(sys.argv[2])))
    sys.exit(main())
