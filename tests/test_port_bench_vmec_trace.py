"""The VMEC trace job (``port_bench/jobs/vmec_trace.py``) driven on the CPU
at 64 rays x 2 recorded steps over all 86 modes, against the float64
PyTorch reference (``port_bench/reference/vmec_cold.py``).

The program runs its plain versions here (K4's is ``reference_jet``).  In
float32, the configuration's precision, a sound run reads about 2e-4
(trace) and 2e-3 (drift), the float32 Newton's stop and the uncompensated
sum of 20 increments onto s near 0.5, and 5e-6 (geometry: B, e^s and the
Jacobian at the final positions).  In float64 the program's own geometry
(the unfused mode grid) and the reference's autograd agree to rounding.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from port_bench import harness, inputs_vmec, program_spans, readings
from port_bench.jobs import vmec_trace

CELL = "w7x_vmec_100k.trace"
SMALL = dict(rays=64, steps=2)


def _cell():
    return harness.find_cell(harness.load_spec(), CELL)


@contextlib.contextmanager
def _perturbed(seed, spread=0.1):
    """The benchmark's stellarator with every mode's rmnc, zmns and lmns
    but R00's scaled by 1 + spread N(0, 1) drawn from ``seed``: the map's
    weights, which the program and the reference both take."""
    make = inputs_vmec.vmec_samples

    def perturbed(m):
        samples = make(m)
        rng = np.random.default_rng([seed, 2])
        for key in ("rmnc", "zmns", "lmns"):
            table = samples[key]
            table[1:] *= 1.0 + spread * rng.standard_normal(
                (table.shape[0] - 1, 1))
        return samples

    with mock.patch.object(inputs_vmec, "vmec_samples", perturbed):
        yield


def _run(seed, **over):
    result, _ = harness.run(CELL, seed, 0.2, 0, device="cpu",
                            overrides={**SMALL, **over})
    return result


def _values(result):
    return {k: v["value"] for k, v in result["checks"].items()}


def test_inputs_are_the_smoke_runs_stellarator():
    """The configuration's numbers give the smoke run's stellarator and
    launch exactly."""
    _, config, _ = _cell()
    got = inputs_vmec.vmec_samples(config["equilibrium"])
    want = chip_smoke.synthetic_vmec_samples()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    seed = 2 ** 31 + 11
    launch = inputs_vmec.launch(300, config["launch"], seed)
    for key, value in chip_smoke.vmec_launch_arrays(300, seed).items():
        np.testing.assert_array_equal(launch[key], value, err_msg=key)


def test_program_matches_the_reference_in_float64():
    """In float64 the program's unfused geometry and the reference's
    autograd of its own direct mode sums agree to rounding, on a perturbed
    map: the two compute the same equations."""
    seed = 2 ** 31 + 7
    with _perturbed(seed):
        result = _run(seed, dtype="float64")
    gaps = _values(result)
    assert result["correct"], gaps
    assert gaps["trace_gap"] < 1e-12 and gaps["drift_gap"] < 1e-11, gaps
    assert gaps["geometry_gap"] < 1e-12, gaps


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 19, 4_000_000_007])
def test_sound_run_is_correct(seed):
    """The configuration's float32 on seeded perturbations of the mode
    amplitudes (the map's weights) reads within the cell's limits."""
    with _perturbed(seed):
        result = _run(seed)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


def _unchanged(run):
    def unchanged(self, state, num_steps, **kw):
        return state
    return unchanged


def _half(run):
    def half(self, state, num_steps, **kw):
        out = run(self, state, num_steps, **kw)
        n = state.x.shape[0] // 2
        return type(state)(*[torch.cat([o[:n], s[n:]])
                             for o, s in zip(out, state)])
    return half


def _non_finite(run):
    def non_finite(self, state, num_steps, **kw):
        out = run(self, state, num_steps, **kw)
        return out._replace(x=out.x * float("nan"))
    return non_finite


def _k4_fault(fault):
    """K4's tables made wrong as phase 14 of ``chip_smoke.py`` makes them:
    the last mode (m 9, n 4) dropped, or lmns read on the full grid."""
    from graph_framework_tpu_torch.kernels import vmec_geom

    make = vmec_geom.jet_tables

    def wrong(eq):
        tables = make(eq)
        if fault == "last_mode_dropped":
            return chip_smoke.drop_last_mode(tables)
        return tables._replace(sminh=tables.sminf)

    return mock.patch.object(vmec_geom, "jet_tables", wrong)


@pytest.mark.parametrize("fault", ["last_mode_dropped", "lmns_full_grid",
                                   "unchanged", "half", "non_finite"])
def test_a_planted_fault_is_not_correct(fault):
    """Each planted fault fails the cell's own limits in float32.  A wrong
    K4 (its last mode dropped, or lmns read on the full grid) fails the
    geometry check, which sees B where the trace barely does; a unit that
    returns its input, or advances half the rays, fails the trace's; one
    that leaves the map fails every check without raising."""
    from graph_framework_tpu_torch import solver

    seed = 2 ** 31 + 23
    if fault in ("last_mode_dropped", "lmns_full_grid"):
        with _k4_fault(fault):
            result = _run(seed)
        check = result["checks"]["geometry_gap"]
        assert check["value"] > check["limit"], result["checks"]
    else:
        planted = {"unchanged": _unchanged, "half": _half,
                   "non_finite": _non_finite}[fault]
        with mock.patch.object(solver.Solver, "run",
                               planted(solver.Solver.run)):
            result = _run(seed)
    assert not result["correct"], result["checks"]


def test_the_control_is_not_correct():
    """The program with its mode tables rounded to bfloat16 (the control)
    reads above a limit of the cell, where the configuration's float32
    reads below every limit."""
    seed = 2 ** 31 + 29
    sound, control = readings.readings(CELL, [seed], [seed], device="cpu",
                                       overrides=SMALL)
    limits = _cell()[2]["limits"]
    assert all(sound[k] <= lim for k, lim in limits.items()), sound
    assert any(control[k] > lim for k, lim in limits.items()), control


def test_a_traced_run_shows_the_rhs_spans():
    """Under the profiler a unit holds two ``gft.ray_rhs`` spans a rk2
    substep; the traced cell reports the RHS's host time, and no device
    metric on the CPU."""
    _, config, traffic = _cell()
    job = vmec_trace.Job({**config, **SMALL}, traffic, 31, "cpu")
    job.setup()
    trace = harness._traced(job, 1)[0]
    rhs = program_spans.named(trace, "gft.ray_rhs")
    assert len(rhs) == 2 * SMALL["steps"] * config["sub_steps"]
    assert trace.info["substeps_per_run"] == \
        SMALL["steps"] * config["sub_steps"]
    result, _ = harness.run(CELL, 31, 0.2, 1, device="cpu",
                            overrides=SMALL)
    assert set(result["metrics"]) == {"rhs_host_us.vmec"}
    assert result["metrics"]["rhs_host_us.vmec"]["value"] > 0.0
