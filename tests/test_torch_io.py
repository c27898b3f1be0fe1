"""The port's result files (io/output.py) against the JAX package's: the
same calls write the same NetCDF4 layout (datasets, shapes, types,
dimension scales and their attachments, ``_Netcdf4Dimid``, the
non-coordinate name of the 2D ``time``, the complex ``ray_dim``), each
package reads the other's file, and the asynchronous writer keeps the
order of its rows and surfaces a failed write.
"""

import h5py
import numpy as np
import pytest
import torch

from graph_framework_tpu.io.output import ResultFile as JaxResultFile
from graph_framework_tpu_torch.io import AsyncWriter, ResultFile, state_row
from graph_framework_tpu_torch.models.rays import RayState

NAMES = ("time", "x", "y", "z", "w", "kx", "ky", "kz", "residual")


def rows(num_rays=4, steps=3):
    rng = np.random.default_rng(0)
    return [dict({n: rng.standard_normal(num_rays) for n in NAMES},
                 kamp=rng.standard_normal(num_rays)
                 + 1j * rng.standard_normal(num_rays))
            for _ in range(steps)]


def write(path, cls, data, num_rays=4):
    with cls(path, num_rays=num_rays) as f:
        for name in NAMES:
            f.create_variable(name)
        f.create_variable("kamp", complex_valued=True)
        for i, row in enumerate(data):
            f.write_step(i, row)
    return path


def read_all(path, cls):
    with cls(path, mode="r") as f:
        return {n: np.stack([f.read_step(i, [n], complex_valued=n == "kamp")
                             [n] for i in range(f.num_steps)])
                for n in f.variables()}


def layout(path):
    """Every object of the file: its kind, shape, maxshape, dtype, chunks
    and attributes, with dimension-list references resolved to names."""
    out = {}
    with h5py.File(path, "r") as h:
        out["/"] = {k: h.attrs[k] for k in h.attrs}

        def attrs(ds):
            got = {}
            for key in ds.attrs:
                value = ds.attrs[key]
                if key == "DIMENSION_LIST":
                    value = [[h[ref].name for ref in refs] for refs in value]
                elif key == "REFERENCE_LIST":
                    value = (value.dtype.descr,
                             sorted((h[r].name, int(d)) for r, d in value))
                elif isinstance(value, np.ndarray):
                    value = (value.dtype.str, value.tolist())
                else:
                    value = (type(value).__name__, value)
                got[key] = value
            return got

        for name, ds in h.items():
            out[name] = (ds.shape, ds.maxshape, ds.dtype.str, ds.chunks,
                         attrs(ds))
    return out


def test_layout_matches_jax(tmp_path):
    """The same datasets, dimension scales (CLASS, NAME, _Netcdf4Dimid),
    attachments and root attributes as the JAX package writes."""
    data = rows()
    port = layout(write(tmp_path / "port.nc", ResultFile, data))
    want = layout(write(tmp_path / "jax.nc", JaxResultFile, data))
    assert port == want
    assert "_nc4_non_coord_time" in port and "time" in port
    assert port["ray_dim"][0] == (2,)
    assert port["kamp"][0] == (3, 4, 2)


@pytest.mark.parametrize("writer,reader", [(ResultFile, JaxResultFile),
                                           (JaxResultFile, ResultFile)])
def test_each_package_reads_the_others_file(tmp_path, writer, reader):
    data = rows()
    got = read_all(write(tmp_path / "r.nc", writer, data), reader)
    assert sorted(got) == sorted(NAMES + ("kamp",))
    for name in NAMES + ("kamp",):
        np.testing.assert_array_equal(got[name],
                                      np.stack([r[name] for r in data]))


def test_reopen_append_and_complex_pairs(tmp_path):
    """r+ reopens a file, keeps num_rays, appends a variable whose rows
    fill in later (num_steps is the longest variable's), and stores a
    complex row as (re, im) pairs along ray_dim, inf parts kept."""
    path = tmp_path / "r.nc"
    with ResultFile(path, num_rays=3) as f:
        f.create_variable("x")
        for i in range(4):
            f.write_step(i, {"x": torch.full((3,), float(i))})
    with ResultFile(path, mode="r+") as f:
        assert f.num_rays == 3 and f.num_steps == 4
        f.create_variable("kamp", complex_valued=True)
        f.write_step(0, {"kamp": torch.tensor(
            [1 + 2j, complex(0.0, np.inf), 3.0])})
        assert f.num_steps == 4
        k = f.read_step(0, ["kamp"], complex_valued=True)["kamp"]
    assert k[0] == 1 + 2j and k[1].real == 0 and np.isinf(k[1].imag)
    with h5py.File(path, "r") as h:
        np.testing.assert_array_equal(h["kamp"][0, 0], [1.0, 2.0])


def test_state_row_and_tensors(tmp_path):
    """state_row maps a RayState to the reference's names; tensors (a
    conjugate view included) are written as their values."""
    state = RayState(*[torch.arange(3.0) + i for i in range(8)])
    row = state_row(state, residual=torch.zeros(3))
    assert list(row) == ["time", "w", "x", "y", "z", "kx", "ky", "kz",
                         "residual"]
    with ResultFile(tmp_path / "r.nc", num_rays=3) as f:
        f.create_variable("kamp", complex_valued=True)
        f.write_step(0, {"kamp": torch.tensor([1 + 1j, 2j, 3.0]).conj()})
        k = f.read_step(0, ["kamp"], complex_valued=True)["kamp"]
    np.testing.assert_array_equal(k, [1 - 1j, -2j, 3.0])


def test_async_writer_keeps_order(tmp_path):
    """Rows queued out of order land at their index; close drains."""
    with ResultFile(tmp_path / "r.nc", num_rays=2) as f:
        f.create_variable("x")
        w = AsyncWriter(f)
        for i in (2, 0, 1, 4, 3):
            w.write_step(i, {"x": torch.full((2,), float(i))})
        w.close()
        got = [f.read_step(i, ["x"])["x"][0] for i in range(f.num_steps)]
    assert got == [0.0, 1.0, 2.0, 3.0, 4.0]


def test_async_writer_surfaces_errors(tmp_path):
    """A write that fails in the worker raises from close (and from the
    next write_step)."""
    with ResultFile(tmp_path / "r.nc", num_rays=2) as f:
        f.create_variable("x")
        w = AsyncWriter(f)
        w.write_step(0, {"nope": np.zeros(2)})
        with pytest.raises(KeyError):
            w.close()


def test_result_file_needs_num_rays(tmp_path):
    with pytest.raises(ValueError, match="num_rays"):
        ResultFile(tmp_path / "r.nc")


def test_postprocess_matches_jax(tmp_path):
    """postprocess.py against the JAX package's: the 3D power bins of two
    result files (a glob), fix_nan's scrub of NaNs and kamp spikes, and
    the bins file."""
    import shutil
    from graph_framework_tpu import postprocess as jax_post
    from graph_framework_tpu_torch import postprocess
    rng = np.random.default_rng(3)
    for k in range(2):
        with ResultFile(tmp_path / f"result{k}.nc", num_rays=50) as f:
            for name in ("x", "y", "z", "d_power"):
                f.create_variable(name)
            f.create_variable("kamp", complex_valued=True)
            for i in range(6):
                kamp = rng.standard_normal(50) + 1j * rng.standard_normal(50)
                kamp[i] = np.nan
                kamp[i + 1] += 10.0
                f.write_step(i, {"x": rng.uniform(-2, 2, 50),
                                 "y": rng.uniform(-2, 2, 50),
                                 "z": rng.uniform(-2, 2, 50),
                                 "d_power": rng.uniform(0, 1, 50),
                                 "kamp": kamp})
    pattern = str(tmp_path / "result*.nc")
    got, got_edges = postprocess.bin_power_3d(pattern, num=(8, 8, 4))
    want, want_edges = jax_post.bin_power_3d(pattern, num=(8, 8, 4))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0
    for a, b in zip(got_edges, want_edges):
        np.testing.assert_array_equal(a, b)
    shutil.copy(tmp_path / "result0.nc", tmp_path / "copy.nc")
    postprocess.fix_nan(tmp_path / "result0.nc")
    jax_post.fix_nan(tmp_path / "copy.nc")
    with h5py.File(tmp_path / "result0.nc") as a, \
            h5py.File(tmp_path / "copy.nc") as b:
        np.testing.assert_array_equal(a["kamp"][...], b["kamp"][...])
        assert not np.isnan(a["kamp"][...]).any()
    postprocess.save_bins(tmp_path / "bins.nc", got, got_edges)
    jax_post.save_bins(tmp_path / "jbins.nc", want, want_edges)
    assert layout(tmp_path / "bins.nc") == layout(tmp_path / "jbins.nc")


def test_checkpoint_round_trip(tmp_path):
    """io.checkpoint (the Orbax module's counterpart): a RayState saved at
    two steps comes back bit for bit, in its dtype, from the latest step;
    a checkpoint is not replaced without force, and a template of another
    shape or dtype is refused."""
    from graph_framework_tpu_torch.io import (
        latest_step, restore_ray_state, save_ray_state)

    rng = np.random.default_rng(7)
    state = RayState(*[torch.from_numpy(rng.standard_normal(5))
                       for _ in RayState._fields])
    assert latest_step(tmp_path) is None
    save_ray_state(tmp_path, state, step=3)
    later = state._replace(x=state.x + 1.0)
    save_ray_state(tmp_path, later, step=12)
    assert latest_step(tmp_path) == 12
    got = restore_ray_state(tmp_path, state, step=latest_step(tmp_path))
    assert all(torch.equal(a, b) for a, b in zip(got, later))
    got = restore_ray_state(tmp_path, step=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, state))
    assert got.x.dtype == torch.float64 and got.x.device.type == "cpu"
    with pytest.raises(FileExistsError):
        save_ray_state(tmp_path, state, step=3, force=False)
    save_ray_state(tmp_path / "plain", state)
    got = restore_ray_state(tmp_path / "plain", state)
    assert all(torch.equal(a, b) for a, b in zip(got, state))
    short = RayState(*[leaf[:4].float() for leaf in state])
    with pytest.raises(ValueError, match="template"):
        restore_ray_state(tmp_path, short, step=3)
