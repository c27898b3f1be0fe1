"""chip_smoke's phase 21 (the embedding layer) rehearsed at a few thousand
rays on the CPU, so that a broken check shows before a chip run: the
Newton and loop Workflows in f64 and f32 against the closed form and the
CPU's f64 run (on the CPU the f32 legs are the real test of the limits
chip_smoke derives), the wrong graph's separation, and the C library
with GRAPH_TORCH_DEVICE=cpu."""

import shutil
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch import expr
from graph_framework_tpu_torch.ops.tables import piecewise_2d


def test_embedding_phase_rehearses_on_the_cpu():
    if shutil.which("gcc") is None:
        pytest.skip("the C leg needs gcc")
    with mock.patch.multiple(
            torch.cuda, synchronize=lambda *a: None,
            reset_peak_memory_stats=lambda *a: None,
            memory_allocated=lambda *a: 0,
            max_memory_allocated=lambda *a: 0):
        rows, loop_rows = chip_smoke.phase_embedding(
            torch.device("cpu"), n=6000, n_ref=4099, c_device="cpu")
    for row in rows.values():
        assert 2 <= row["iterations"] <= chip_smoke.EMBED_MAX_ITER
        assert row["vs_closed_form"] <= row["limits"][0]
    assert rows["f64"]["vs_cpu_f64"] == 0.0
    assert loop_rows["f64"]["vs_cpu_f64"] == {"pos": 0.0, "k": 0.0}
    assert 0.0 < max(loop_rows["f32"]["vs_cpu_f64"].values()) \
        <= loop_rows["f32"]["limit"]


def test_launch_lies_at_cell_centres():
    """21a's positions are cell centres in f32 as in f64, so both graphs
    gather the same table cell; the table's values are f32 numbers."""
    table, (dr, rmin, dz, zmin) = chip_smoke.embedding_table()
    launch = chip_smoke.embedding_launch(1000)
    assert np.array_equal(table, table.astype(np.float32).astype(np.float64))
    for name, scale, offset in (("x", dr, rmin), ("z", dz, zmin)):
        cell = (launch[name] - offset) / scale
        assert np.all(cell - np.floor(cell) == 0.5), name
        assert np.array_equal(
            np.floor((launch[name].astype(np.float32) - np.float32(offset))
                     / np.float32(scale)), np.floor(cell))
    wp2 = piecewise_2d(torch.as_tensor(table),
                       torch.as_tensor(launch["x"]), dr, rmin,
                       torch.as_tensor(launch["z"]), dz, zmin)
    assert float(wp2.max()) < launch["w"][0] ** 2 - float(
        (launch["ky"] ** 2 + launch["kz"] ** 2).max())


def test_loop_item_is_the_ray_equations():
    """21b's setters are one explicit Euler step of the ray equations:
    one step of the loop Workflow against the same step written with
    autograd of D (f64, 64 rays)."""
    launch = chip_smoke.loop_launch(64)
    with mock.patch.object(chip_smoke, "EMBED_STEPS", 1):
        work, v = chip_smoke.embedding_loop(launch, torch.float64, "cpu")
    work.run()
    t = {k: torch.tensor(a, requires_grad=True) for k, a in launch.items()}
    wp2 = chip_smoke.EMBED_WP0_2 * torch.exp(
        -((t["x"] - chip_smoke.R0) ** 2 + t["z"] ** 2)
        / chip_smoke.EMBED_A ** 2)
    d = (t["w"] ** 2 - chip_smoke.EMBED_C2 * (
        t["kx"] ** 2 + t["ky"] ** 2 + t["kz"] ** 2) - wp2).sum()
    grads = {k: torch.zeros(64, dtype=torch.float64) if g is None else g
             for k, g in zip(t, torch.autograd.grad(
                 d, list(t.values()), allow_unused=True))}
    dt = chip_smoke.EMBED_DT
    for p, k in (("x", "kx"), ("y", "ky"), ("z", "kz")):
        np.testing.assert_allclose(
            v[p].data.numpy(), launch[p] - dt * (grads[k] / grads["w"])
            .numpy(), rtol=1e-14, atol=1e-15)
        np.testing.assert_allclose(
            v[k].data.numpy(), launch[k] + dt * (grads[p] / grads["w"])
            .numpy(), rtol=1e-14, atol=1e-15)
    assert isinstance(work.items[0].schedule[-1], expr.Expr)
