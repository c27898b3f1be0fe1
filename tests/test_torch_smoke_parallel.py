"""chip_smoke's phase 22 (ray ensembles split across processes) rehearsed
at 4096 rays on the CPU: its ranks are processes of chip_smoke.py's worker
mode (gloo; the 22b leg also gloo here, where torch has no NCCL), held to
the one-process runs the test makes as phases 4c and b5 make them on the
card: rows and Newton iterations equal, the checkpoint restored whole,
config 5's sums within their limits and those limits 10x below a wrong
reduction.  On CPU tensors no kernel launches, so the launch counts are
not held."""

import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch.models.absorbed_power import (
    absorbed_power_grad)

N, STEPS, C5_STEPS, C5_BATCHES = 4096, 3, 2, 4
LEGS = (("22a", 2, "gloo", True), ("22b", 1, "gloo", False))


@pytest.fixture(scope="module")
def reference():
    """Phase 4c's and phase b5's one-process results at this size."""
    cpu = torch.device("cpu")
    eq = chip_smoke.synthetic_equilibrium(torch.float32, cpu)
    root, diag = chip_smoke.init_k(
        chip_smoke.launch(N, torch.float32, cpu), chip_smoke.cold_plasma,
        eq, return_diagnostics=True)
    final = chip_smoke.production_solver(eq).run(root, STEPS)
    c5_root = chip_smoke.init_k(
        chip_smoke.launch(N, torch.float32, cpu, **chip_smoke.CONFIG5_LAUNCH),
        chip_smoke.cold_plasma, eq)
    passes = []
    for _ in range(2):
        value, grads = absorbed_power_grad(
            eq, c5_root, C5_STEPS, chip_smoke.CONFIG5_SUB, eq.psi_coeffs,
            chip_smoke.CONFIG5_KZ, form="kernel", batches=C5_BATCHES)
        passes.append(dict(seconds=1.0, sums=[value, *grads]))
    return {"one_process": dict(rows=final, iterations=diag.iterations,
                                seconds=1.0),
            "config5": {"passes": passes}}


def test_parallel_phase_rehearses_on_the_cpu(reference, capsys):
    chip_smoke.phase_parallel(torch.device("cpu"), reference, n=N, steps=STEPS,
                              c5_steps=C5_STEPS, c5_batches=C5_BATCHES,
                              legs=LEGS, check_launches=False)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split("]")[0] for line in lines] == [
        "[22a parallel, 2 rank(s), gloo", "[22a config 5 in 2 ranks",
        "[22b parallel, 1 rank(s), gloo"]
    assert all('false' not in line.split("checks")[-1] for line in lines)


def test_parallel_phase_fails_on_a_wrong_row(reference):
    """A one-process row that the ranks do not reproduce fails the phase
    (the leg 22b alone, one rank)."""
    rows = reference["one_process"]["rows"]
    x = rows.x.clone()
    x[N - 1] = torch.nextafter(x[N - 1], torch.tensor(10.0))
    wrong = dict(reference, one_process=dict(
        reference["one_process"], rows=rows._replace(x=x)))
    with pytest.raises(AssertionError, match="rows bit for bit"):
        chip_smoke.phase_parallel(torch.device("cpu"), wrong, n=N,
                                  steps=STEPS, legs=LEGS[1:],
                                  check_launches=False)


def test_config5_limits_come_from_the_rounding():
    """The association bound 2 (B - 1) u for a deterministic sum, and b5's
    two passes' deviation where they differ, each times the factor."""
    same = [torch.tensor(3.0), torch.ones(4), torch.tensor(-1.0)]
    apart = [same[0], torch.tensor([1.0, 1.0, 1.0, 1.25]), same[2]]
    limits = chip_smoke.config5_limits(
        [dict(sums=same), dict(sums=apart)], batches=8)
    bound = chip_smoke.CONFIG5_SUM_FACTOR * 14 * 2.0 ** -24
    assert limits[0] == limits[2] == bound
    assert limits[1] == pytest.approx(
        chip_smoke.CONFIG5_SUM_FACTOR * 0.25 / 1.25)


def test_rank_mode_needs_the_card():
    """A rank asked for the card where there is none fails; it never runs
    on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(AssertionError, match="exited"):
        chip_smoke.run_ranks([dict(
            device="cuda", world=1, rank=0, port=chip_smoke.free_port(),
            backend="gloo", out="unused", n=8, steps=1, config5=False,
            c5_steps=1, c5_batches=1)])
