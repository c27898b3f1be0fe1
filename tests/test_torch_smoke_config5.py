"""chip_smoke's phases b5 (config 5, the gradient of the absorbed power)
and b6 (remat_policy) rehearsed at a few rays on the CPU, so that a broken
check shows before a chip run."""

from unittest import mock

import torch

import chip_smoke


def test_config5_phase_rehearses_on_the_cpu():
    """Phase b5 at 64 rays x 2 recorded steps in 2 batches (its referee at
    32 rays and at the first batch): on CPU tensors the kernel form runs
    the plain frozen window, so the referee's deviations are zero and no
    launch is counted; what runs is every other check - the loss between
    0 and the ray count, finite and nonzero gradients - and the
    profiler's split."""
    cpu = torch.device("cpu")
    with mock.patch.multiple(
            torch.cuda, synchronize=lambda *a: None,
            reset_peak_memory_stats=lambda *a: None,
            memory_allocated=lambda *a: 0,
            max_memory_allocated=lambda *a: 0):
        counts, k9, eq, batch, passes = chip_smoke.phase_config5(
            cpu, n=64, n_ref=32, steps=2, batches=2, check_launches=False)
    assert counts == (0, 0, 0) and k9 == (0, 0)
    # both passes' sums, on the host, for phase 22; the CPU's are the same
    assert len(passes) == 2 and all(
        torch.equal(a, b) for a, b in zip(passes[0]["sums"],
                                          passes[1]["sums"]))
    # the first batch, at kz0, for config 5's K1 and K3 lines
    assert batch.x.shape == (32,) and eq.psi_coeffs.dtype == torch.float32
    assert torch.all(batch.kz == chip_smoke.CONFIG5_KZ)


def test_remat_policy_phase_rehearses_on_the_cpu():
    """Phase b6 at 32 rays x 1 recorded step."""
    cpu = torch.device("cpu")
    with mock.patch.multiple(
            torch.cuda, synchronize=lambda *a: None,
            reset_peak_memory_stats=lambda *a: None,
            memory_allocated=lambda *a: 0,
            max_memory_allocated=lambda *a: 0):
        rows = chip_smoke.phase_remat_policy(cpu, n=32, steps=1)
    assert [r["policy"] for r in rows] == [None, "spline_jet",
                                           "spline_jet", None]


def test_config5_kernel_lines_rehearse_on_the_cpu():
    """Config 5's K1 and K3 lines (plain rk4 at a batch of its launch, dt
    1 / 200; K3 held to the plain version in f64) at 64 rays on the CPU,
    where each wrapper runs its plain version: the lines carry the path's
    launch counts, the rk4 bounds and every key of the kernels line."""
    cpu = torch.device("cpu")
    eq = chip_smoke.synthetic_equilibrium(torch.float32, cpu)
    root = chip_smoke.init_k(
        chip_smoke.launch(64, torch.float32, cpu,
                          **chip_smoke.CONFIG5_LAUNCH),
        chip_smoke.cold_plasma, eq)
    batch = root._replace(kz=torch.full_like(root.kz, chip_smoke.CONFIG5_KZ))
    dt = 1.0 / (chip_smoke.CONFIG5_STEPS * chip_smoke.CONFIG5_SUB)
    with mock.patch.multiple(chip_smoke, event_ms=lambda fn, reps: 1.0,
                             profile_kernel=lambda fn, kernel=None: (
                                 None, 0, 1.0)):
        records = [chip_smoke.kernel_record(
            eq, batch, 160, dt=dt, busy=False, method="rk4",
            compensated=False, label=" rk4")]
        records += chip_smoke.bwd_kernel_records(
            eq, batch, None, 160, dt=dt, method="rk4", label=" rk4",
            referee=chip_smoke.synthetic_equilibrium(torch.float64, cpu))
        # the main path's K2 and K3 lines, held to BWD_TOL, and K2's
        # against the f64 plain version
        main = chip_smoke.bwd_kernel_records(eq, batch, 1000, 100)
        main += chip_smoke.bwd_kernel_records(
            eq, batch, 1000, None,
            referee=chip_smoke.synthetic_equilibrium(torch.float64, cpu))
    assert [r["name"] for r in records] == ["efit_window rk4",
                                            "efit_window_bwd_tab rk4"]
    assert [r["name"] for r in main] == ["efit_window_bwd",
                                         "efit_window_bwd_tab",
                                         "efit_window_bwd"]
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    for record, ops in zip(records, ("K1 rk4 plain", "K3 rk4")):
        assert set(record) == keys and record["launches"] == 160
        want, _, _ = chip_smoke.window_bound(eq, 64, ops)
        assert record["bound_ms"] == want
        assert record["max_abs_err"] == 0.0
