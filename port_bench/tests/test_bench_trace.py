"""The trace job driven on the CPU against the NumPy reference: a sound
run is correct; each fault the cell can have, planted under the timed
path, makes ``correct`` false; and so does the control, the program's
uncompensated float32."""

from unittest import mock

import pytest
import torch

from port_bench import harness, readings

CELL = "xrays_bench_100k.trace"
# float64 on the CPU: the program's plain versions of K1 then sit at the
# reference's rounding, and any fault stands out by orders of magnitude
F64 = dict(rays=2048, steps=4, dtype="float64", compensated=False)


def _run(**over):
    return harness.run(CELL, 17, 0.5, 0, device="cpu",
                       overrides={**F64, **over})[0]


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["checks"]["trace_gap"]["value"] < 1e-9


def _unchanged(eq, carry, **kw):
    return carry


def _half(window):
    def half(eq, carry, **kw):
        out = window(eq, carry, **kw)
        n = carry.x.shape[0] // 2
        return type(carry)(*[torch.cat([o[:n], c[n:]])
                             for o, c in zip(out, carry)])
    return half


def _altered(window):
    def altered(eq, carry, **kw):
        out = window(eq, carry, **kw)
        return out._replace(kx=out.kx * (1.0 + 1e-4))
    return altered


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_fault_under_the_timed_path_is_not_correct(fault):
    from graph_framework_tpu_torch import solver

    window = solver.efit_window
    planted = {"unchanged": _unchanged, "half": _half(window),
               "altered": _altered(window)}[fault]
    with mock.patch.object(solver, "efit_window", planted):
        result = _run()
    assert not result["correct"], result["checks"]


def test_the_control_is_not_correct():
    """The program's uncompensated path in float32 (the control) reads
    above the limit, where the configuration's compensated path reads
    below it (1024 rays: the float32 Newton needs an ensemble that
    large to reach its rounding)."""
    size = dict(rays=1024, steps=60)
    rows = readings.readings(CELL, [21], [21], device="cpu", overrides=size)
    limit = harness.find_cell(harness.load_spec(), CELL)[2]["limits"][
        "trace_gap"]
    sound, control = (r["trace_gap"] for r in rows)
    assert sound < limit < control
