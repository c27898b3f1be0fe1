"""The port's EFIT equilibrium against the JAX package's, on one file.

Tolerances: the tables are loaded by the same numpy code in both packages,
so they must be bit-equal, and the frozen blocks and cell indices, which
are gathers from those tables at the same float64 points, identical.
Field and profile values differ only by the order in which two eager
frameworks round the same polynomial and rotation arithmetic: 1e-12
relative to each quantity's scale over the points leaves a wide margin
over the ~1e-15 this gives.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from graph_framework_tpu.models.efit import make_efit as jax_make_efit
from graph_framework_tpu.ops.tables import (
    table_index_1d as jax_table_index_1d)
from graph_framework_tpu.tools.make_splines import write_efit_file
from graph_framework_tpu_torch.convert import efit_from_numpy
from graph_framework_tpu_torch.models.efit import make_efit
from graph_framework_tpu_torch.ops.tables import table_index_1d
from graph_framework_tpu_torch.tools.make_splines import (
    write_efit_file as port_write_efit_file)
from test_torch_common import SOURCES, efit_path, load_both

TABLES = ("psi_coeffs", "ne_coeffs", "te_coeffs", "pres_coeffs",
          "fpol_coeffs", "profile_coeffs")
SCALARS = ("psimin", "dpsi", "rmin", "dr", "zmin", "dz", "ne_scale",
           "te_scale", "pres_scale", "cell_local")


@pytest.fixture(scope="module", params=SOURCES)
def eqs(request, tmp_path_factory):
    return load_both(request.param, tmp_path_factory)


def _points(eq, n=200, seed=3):
    """Random in-domain positions (3, n): R and Z inside the table's
    interior, a random toroidal angle."""
    rng = np.random.default_rng(seed)
    nr, nz = np.asarray(eq.psi_coeffs).shape[:2]
    r = eq.rmin + eq.dr * nr * rng.uniform(0.05, 0.95, n)
    z = eq.zmin + eq.dz * nz * rng.uniform(0.05, 0.95, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    return np.stack([r * np.cos(phi), r * np.sin(phi), z])


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _plasma_quantities_agree(jeq, peq, pts, tol=1e-12):
    jpq = jeq.plasma_quantities(jnp.asarray(pts))
    ppq = peq.plasma_quantities(torch.from_numpy(pts))
    assert _rel(ppq.b, jpq.b) < tol
    for name in ("ne", "te"):
        assert _rel(getattr(ppq, name), getattr(jpq, name)) < tol, name
    assert _rel(ppq.ni[0], jpq.ni[0]) < tol
    assert _rel(ppq.ti[0], jpq.ti[0]) < tol


def test_tables_bit_equal(eqs):
    jeq, peq = eqs
    for name in TABLES:
        np.testing.assert_array_equal(getattr(peq, name).numpy(),
                                      np.asarray(getattr(jeq, name)), name)
    for name in SCALARS:
        assert getattr(peq, name) == getattr(jeq, name), name


def test_plasma_quantities(eqs):
    jeq, peq = eqs
    _plasma_quantities_agree(jeq, peq, _points(jeq))


def test_psi_and_magnetic_field(eqs):
    jeq, peq = eqs
    pts = _points(jeq, seed=4)
    assert _rel(peq.psi(torch.from_numpy(pts)),
                jeq.psi(jnp.asarray(pts))) < 1e-12
    assert _rel(peq.magnetic_field(torch.from_numpy(pts)),
                jeq.magnetic_field(jnp.asarray(pts))) < 1e-12
    for got, want in zip(peq.profiles(peq.psi(torch.from_numpy(pts))),
                         jeq.profiles(jeq.psi(jnp.asarray(pts)))):
        assert _rel(got, want) < 1e-12


def test_freeze_cells_blocks_and_indices(eqs):
    jeq, peq = eqs
    pts = _points(jeq, seed=5)
    jf = jeq.freeze_cells(jnp.asarray(pts))
    pf = peq.freeze_cells(torch.from_numpy(pts))
    for name in ("psi_block", "prof_block", "iu", "jv", "pidx"):
        np.testing.assert_array_equal(getattr(pf, name).numpy(),
                                      np.asarray(getattr(jf, name)), name)
    # the frozen views serve the same quantities at nearby stage points
    stage = pts + 1e-3
    _plasma_quantities_agree(jf, pf, stage)


def test_efit_from_numpy_matches_loader(eqs):
    """convert.efit_from_numpy of the JAX equilibrium is the port's own
    load of the file."""
    jeq, peq = eqs
    conv = efit_from_numpy(jeq, device="cpu")
    for name in TABLES:
        assert torch.equal(getattr(conv, name), getattr(peq, name)), name
    for name in SCALARS:
        assert getattr(conv, name) == getattr(peq, name), name
    _plasma_quantities_agree(jeq, conv, _points(jeq, seed=6))


@pytest.mark.parametrize("source", SOURCES)
def test_loader_options(source, tmp_path_factory):
    """Without the ne <- te quirk, and without the cell-local rebase, the
    port loads the same tables as the JAX package; float32 tables are the
    float64 ones rounded once."""
    path = efit_path(source, tmp_path_factory)
    for kw in (dict(replicate_reference_quirks=False),
               dict(cell_local=False)):
        jeq, peq = (jax_make_efit(path, **kw),
                    make_efit(path, device="cpu", **kw))
        for name in TABLES:
            np.testing.assert_array_equal(
                getattr(peq, name).numpy(), np.asarray(getattr(jeq, name)),
                f"{name} {kw}")
    f64 = make_efit(path, device="cpu")
    f32 = make_efit(path, dtype=torch.float32, device="cpu")
    for name in TABLES:
        assert torch.equal(getattr(f32, name),
                           getattr(f64, name).to(torch.float32)), name


def test_table_index_matches_jax():
    """Clamp-then-truncate: the same cells as the JAX index for in-range,
    out-of-range and infinite coordinates; a NaN takes cell 0 (the cell
    the JAX gather and the CUDA kernel read for it)."""
    x = np.array([-5.0, -1e-12, 0.0, 0.49, 0.5, 3.999, 4.0, 4.5, 1e9,
                  np.inf, -np.inf])
    want = np.asarray(jax_table_index_1d(jnp.asarray(x), 0.5, 0.0, 8))
    got = table_index_1d(torch.from_numpy(x), 0.5, 0.0, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int64
    assert int(table_index_1d(torch.tensor([np.nan]), 0.5, 0.0, 8)) == 0


def test_port_writes_the_same_file(tmp_path_factory):
    """The port's write_efit_file writes the tables the JAX package's
    writes, from the same samples (both loaders read it bit-equal)."""
    path = tmp_path_factory.mktemp("port_efit") / "port_efit.nc"
    port_write_efit_file(path, **chip_smoke.synthetic_samples(grid=33))
    jax_path = tmp_path_factory.mktemp("jax_efit") / "jax_efit.nc"
    write_efit_file(jax_path, **chip_smoke.synthetic_samples(grid=33))
    got, want = jax_make_efit(path), jax_make_efit(jax_path)
    for name in TABLES:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)
    for name in SCALARS:
        assert getattr(got, name) == getattr(want, name), name
