"""The pipeline and config 5 jobs driven on the CPU at a small size
against their references: a sound run is correct; each fault the cell can
have, planted under the timed path, makes ``correct`` false; and so does
the control, the reference with its tables in bfloat16."""

from unittest import mock

import pytest
import torch

from port_bench import harness, readings

PIPELINE = "xrays_bench_100k.pipeline"
GRAD = "absorbed_power_1m.absorbed_power_grad"
# 1024 rays: the float32 Newton needs an ensemble that large to reach its
# rounding; the pipeline's rows and config 5's batches cut to a CPU's size
SIZE = {PIPELINE: ({"rays": 1024}, {"rows": 30, "check_rays": 64}),
        GRAD: ({"rays": 1024, "batches": 16, "steps": 6, "dt": 1.0 / 60}, {})}


@pytest.fixture
def small(monkeypatch):
    """harness.find_cell with the cell's traffic cut to SIZE."""
    find = harness.find_cell

    def cut(spec, workload, root=harness.ROOT):
        cell, config, traffic = find(spec, workload, root)
        return cell, config, {**traffic, **SIZE[workload][1]}

    monkeypatch.setattr(harness, "find_cell", cut)


def _run(cell):
    return harness.run(cell, 23, 0.1, 0, device="cpu",
                       overrides=SIZE[cell][0])[0]


@pytest.mark.parametrize("cell", [PIPELINE, GRAD])
def test_sound_run_is_correct(small, cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


def _unchanged(eq, carry, **kw):
    return carry


def _half(window):
    """The window advances only the first half of the rays."""
    def mix(out, carry):
        n = carry.shape[0] // 2
        return torch.cat([out[:n], carry[n:]])

    def half(eq, carry, **kw):
        out = window(eq, carry, **kw)
        if hasattr(carry, "hi"):                  # a compensated carry
            return type(out)(type(out.hi)(*map(mix, out.hi, carry.hi)),
                             type(out.lo)(*map(mix, out.lo, carry.lo)))
        return type(out)(*map(mix, out, carry))
    return half


def _faults():
    from graph_framework_tpu_torch import solver
    from graph_framework_tpu_torch.models import absorbed_power, absorption

    window = solver.efit_window
    weak = absorption.make_weak_damping
    grad = absorbed_power.absorbed_power_grad
    batches = absorbed_power.ray_batches

    def altered_kamp(eq):
        update = weak(eq)
        return lambda state: update(state) * (1.0 + 1e-3)

    def altered_grad(*a, **kw):
        value, (g_psi, g_kz) = grad(*a, **kw)
        return value, (g_psi * (1.0 + 1e-2), g_kz)

    def half_batch(state, n):
        return [type(state)(*[leaf[: leaf.shape[0] // 2] for leaf in state])
                for state in batches(state, n)]

    return {
        (PIPELINE, "unchanged"): (solver, "efit_window", _unchanged),
        (PIPELINE, "half"): (solver, "efit_window", _half(window)),
        (PIPELINE, "altered"): (absorption, "make_weak_damping",
                                altered_kamp),
        (GRAD, "unchanged"): (solver, "efit_window", _unchanged),
        (GRAD, "half"): (absorbed_power, "ray_batches", half_batch),
        (GRAD, "altered"): (absorbed_power, "absorbed_power_grad",
                            altered_grad)}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in (PIPELINE, GRAD)
    for f in ("unchanged", "half", "altered")])
def test_a_fault_under_the_timed_path_is_not_correct(small, cell, fault):
    target, name, planted = _faults()[cell, fault]
    with mock.patch.object(target, name, planted):
        result = _run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", [PIPELINE, GRAD])
def test_the_control_is_not_correct(small, cell):
    rows = readings.readings(cell, [], [29], device="cpu",
                             overrides=SIZE[cell][0])
    limits = harness.find_cell(harness.load_spec(), cell)[2]["limits"]
    failed = [k for k, lim in limits.items() if rows[0][k] > lim]
    assert failed, rows
