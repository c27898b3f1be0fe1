"""The spline tables' row gather and its transpose (``ops/tables.py``
``gather_rows``, ``TableGather``, ``TableScatter``;
``kernels/table_scatter.py``; ``csrc/table_scatter.cu``).

* In float64 the gather gives what plain ``table[idx]`` gives: the values,
  the first gradients bit for bit (the plain version sums a cell's rows in
  row order, as the library's ``index_put_`` with accumulate does on the
  CPU) and the second gradients, for psi-, profile- and fpol-shaped tables
  and for config 5's clustered launch, uniform cells, one cell, one row and
  no rows; ``gradcheck`` and ``gradgradcheck`` pass.
* Routing: with no gradient needed, or a complex table, the call is plain
  indexing and no kernel launches.
* The kernel's own source, compiled with ``g++`` over the stand-in runtime
  of ``tools/count_ops.py`` (every thread a ``std::thread``, a warp's
  collectives exchanged through a barrier of its lanes), runs on CPU
  tensors against the plain version: exactly on integer-valued rows (every
  sum exact in float32, whatever its order), and within rounding on random
  ones, at ragged row counts, with vector and scalar loads, widths of more
  than one column chunk, and cells that overflow a block's shared table.
* The CUDA paths skip without a card.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch.kernels import build
from graph_framework_tpu_torch.kernels import table_scatter as ts
from graph_framework_tpu_torch.ops.tables import (
    TableGather, gather_rows, table_index_1d)
from graph_framework_tpu_torch.tools import count_ops

#: psi (the 129 x 129 map's cells cut to 33 x 33), profile (P = 4 cubics
#: of 4), fpol (one cubic of 4) tables: (cells, *row).
TABLES = {"psi": (33 * 33, 16), "profile": (64, 4, 4), "fpol": (64, 4)}


def _beam_cells(n, cells, seed):
    """Config 5's launch in miniature: the psi cells of n rays of the
    launch (x 1.7 m, spread 0.005 m) on a 33 x 33 map over r 1-3 m, z -1-1
    m, a handful of cells, folded into ``cells``."""
    arrays = chip_smoke.launch(n, torch.float64, "cpu", seed=seed,
                               **chip_smoke.CONFIG5_LAUNCH)
    i = table_index_1d(arrays.x, 2.0 / 32, 1.0, 33)
    j = table_index_1d(arrays.z, 2.0 / 32, -1.0, 33)
    return (i * 33 + j) % cells


def _index(kind, cells, n=3001, seed=7):
    """n cells (one, none, or (3, 7, 5) for "batched") of ``kind``."""
    rng = np.random.default_rng(seed)
    if kind == "beam":
        return _beam_cells(n, cells, seed).contiguous()
    if kind == "uniform":
        return torch.from_numpy(rng.integers(0, cells, n))
    if kind == "one_cell":
        return torch.full((n,), cells - 1, dtype=torch.int64)
    if kind == "batched":
        return torch.from_numpy(rng.integers(0, cells, (3, 7, 5)))
    if kind == "one_row":
        return torch.tensor([cells - 1])
    return torch.zeros(0, dtype=torch.int64)          # no rows


INDEX = ["beam", "uniform", "one_cell", "batched", "one_row", "none"]


def _table(name, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(TABLES[name], dtype=torch.float64, generator=g)


def _weights(shape, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, dtype=torch.float64, generator=g)


@pytest.mark.parametrize("kind", INDEX)
@pytest.mark.parametrize("name", sorted(TABLES))
def test_gather_matches_plain_indexing(name, kind):
    """Values, first gradients bit for bit, and second gradients (through
    a loss that is quadratic in the table) equal plain indexing's."""
    base = _table(name)
    idx = _index(kind, base.shape[0])
    got_t = base.clone().requires_grad_(True)
    want_t = base.clone().requires_grad_(True)
    got, want = gather_rows(got_t, idx), want_t[idx]
    assert got.grad_fn is not None and "TableGather" in got.grad_fn.name()
    assert torch.equal(got, want)
    w = _weights(got.shape)
    (g1,) = torch.autograd.grad((got * got * w).sum(), got_t,
                                create_graph=True)
    (w1,) = torch.autograd.grad((want * want * w).sum(), want_t,
                                create_graph=True)
    assert torch.equal(g1, w1)
    v = _weights(base.shape, seed=11)
    (g2,) = torch.autograd.grad((g1 * v).sum(), got_t)
    (w2,) = torch.autograd.grad((w1 * v).sum(), want_t)
    assert torch.equal(g2, w2)


@pytest.mark.parametrize("kind", ["beam", "uniform", "batched"])
def test_gradcheck_and_gradgradcheck(kind):
    table = torch.randn(40, 4, dtype=torch.float64, requires_grad=True)
    idx = _index(kind, 40)[:64]

    def f(t):
        return TableGather.apply(t, idx) ** 2

    assert torch.autograd.gradcheck(f, (table,))
    assert torch.autograd.gradgradcheck(f, (table,))


def test_routing_without_a_gradient_is_plain_indexing():
    """No grad mode, a table that needs no grad, or a complex table: plain
    indexing (the library's own backward where there is one), and the
    launch counter does not move."""
    idx = _index("beam", 64)
    before = ts.table_scatter_launches
    table = _table("fpol")
    assert gather_rows(table, idx).grad_fn is None
    with torch.no_grad():
        assert gather_rows(table.requires_grad_(True), idx).grad_fn is None
    out = gather_rows(table, idx)
    assert "TableGather" in out.grad_fn.name()
    cplx = torch.complex(_table("fpol"), _table("fpol", 4))
    out = gather_rows(cplx.requires_grad_(True), idx)
    assert "TableGather" not in out.grad_fn.name()
    assert torch.equal(out, cplx[idx])
    out.abs().sum().backward()
    assert ts.table_scatter_launches == before


def test_vmec_table_gradient_goes_through_the_gather(monkeypatch):
    """VMEC's spline gathers are this gather: the rmnc gradient of |B|^2
    (test_torch_vmec.py's ``test_gradient_wrt_rmnc_matches_jax``) takes one
    table scatter, of the rays' rmnc and zmns blocks over the full grid's
    cells, and equals plain indexing's gradient bit for bit."""
    import dataclasses

    from graph_framework_tpu_torch.models import vmec
    from graph_framework_tpu_torch.ops import tables
    from graph_framework_tpu_torch.tools.make_splines import vmec_tables

    eq = vmec.vmec_from_tables(
        vmec_tables(**chip_smoke.synthetic_vmec_samples(21)), device="cpu")
    rng = np.random.default_rng(3)
    pos = torch.from_numpy(np.stack([rng.uniform(0.05, 0.95, 64),
                                     rng.uniform(0.0, 2 * np.pi, 64),
                                     rng.uniform(0.0, 2 * np.pi, 64)]))

    def rmnc_gradient():
        rmnc = eq.rmnc_coeffs.clone().requires_grad_(True)
        b = dataclasses.replace(eq, rmnc_coeffs=rmnc).magnetic_field(pos)
        return torch.autograd.grad((b * b).sum(), [rmnc])[0]

    cells = []

    def record(grad, idx, n):
        cells.append(n)
        return ts.table_scatter(grad, idx, n)

    monkeypatch.setattr(tables, "table_scatter", record)
    got = rmnc_gradient()
    assert cells == [eq.rmnc_coeffs.shape[0]]
    monkeypatch.setattr(vmec, "gather_rows", lambda table, idx: table[idx])
    want = rmnc_gradient()
    assert len(cells) == 1
    assert bool(got.abs().max() > 0) and torch.equal(got, want)


def test_wrapper_refuses_what_it_does_not_take():
    grad, idx = torch.zeros(5, 4), torch.zeros(5, dtype=torch.int64)
    with pytest.raises(ValueError):
        ts.table_scatter(grad, idx[:4], 3)
    with pytest.raises(ValueError):
        ts.table_scatter(grad, idx.int(), 3)
    with pytest.raises(ValueError):
        ts.table_scatter(grad, idx, 0)


# -- the kernel's source on the host ----------------------------------------

CODES = {torch.float32: 0, torch.float64: 1}
#: The stand-in's multiprocessors: a grid of at most 2 blocks a column
#: chunk, so the blocks walk several tiles of rows.
HOST_SMS = 1


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host build needs g++")
    lib = ctypes.CDLL(str(count_ops.host_library(
        tmp_path_factory.mktemp("table_scatter_host"),
        {"table_scatter.cpp": '#include "table_scatter.cu"\n'},
        every_thread=True, flags=("-O1", "-ffp-contract=off"))))
    argtypes, restype = build.SIGNATURES["gft_table_scatter"]
    lib.gft_table_scatter.argtypes = argtypes
    lib.gft_table_scatter.restype = restype
    return lib


def _host_scatter(lib, grad, idx, cells, vec=None):
    n, width = grad.shape
    if vec is None:
        vec = int(width * grad.element_size() % 16 == 0
                  and grad.data_ptr() % 16 == 0)
    out = torch.zeros((cells, width), dtype=grad.dtype)
    rc = lib.gft_table_scatter(CODES[grad.dtype], n, width, cells,
                               grad.data_ptr(), idx.data_ptr(), vec, HOST_SMS,
                               out.data_ptr(), None)
    assert rc == 0
    return out


#: (index set, rows, cells, width): the beam and one cell sum hundreds of
#: rows a cell, uniform cells overflow the 64 slots of a block's table,
#: width 20 takes two column chunks, 6 a scalar load (24 B rows in f32).
HOST_CASES = [("beam", 2011, 33 * 33, 16), ("one_cell", 1500, 64, 4),
              ("uniform", 1800, 1000, 16), ("uniform", 777, 50, 20),
              ("beam", 999, 33 * 33, 6), ("one_row", 1, 10, 16)]


@pytest.mark.parametrize("case", HOST_CASES, ids=lambda c: f"{c[0]}-{c[1]}"
                         f"x{c[3]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kernel_source_matches_plain_version(host_lib, dtype, case):
    """Integer-valued rows (|value| <= 8, so every partial sum is exact in
    float32): the kernel's sums equal the plain version's exactly.  Random
    rows: within a few roundings of the float64 sums, relative to each
    cell's sum of magnitudes."""
    kind, n, cells, width = case
    idx = _index(kind, cells, n, seed=n)
    rng = np.random.default_rng(n + width)
    ints = torch.from_numpy(rng.integers(-8, 9, (n, width))).to(dtype)
    want = ts.table_scatter_plain(ints, idx, cells)
    assert torch.equal(_host_scatter(host_lib, ints, idx, cells), want)
    if width * ints.element_size() % 16 == 0:
        assert torch.equal(
            _host_scatter(host_lib, ints, idx, cells, vec=0), want)
    rows = torch.from_numpy(rng.standard_normal((n, width)))
    got = _host_scatter(host_lib, rows.to(dtype), idx, cells).double()
    exact = ts.table_scatter_plain(rows.to(dtype).double(), idx, cells)
    scale = ts.table_scatter_plain(rows.to(dtype).double().abs(), idx, cells)
    eps = torch.finfo(dtype).eps
    assert ((got - exact).abs() <= 64 * eps * scale).all()


def test_kernel_source_refuses_bad_arguments(host_lib):
    grad, idx = torch.zeros(4, 4), torch.zeros(4, dtype=torch.int64)
    out = torch.zeros(2, 4)
    call = host_lib.gft_table_scatter
    p = (grad.data_ptr(), idx.data_ptr())
    assert call(2, 4, 4, 2, *p, 1, 1, out.data_ptr(), None) == -1   # dtype
    assert call(0, -1, 4, 2, *p, 1, 1, out.data_ptr(), None) == -1  # n
    assert call(0, 4, 0, 2, *p, 1, 1, out.data_ptr(), None) == -1   # width
    assert call(0, 4, 4, 0, *p, 1, 1, out.data_ptr(), None) == -1   # cells
    assert call(0, 4, 4, 2, *p, 1, 0, out.data_ptr(), None) == -1   # sms
    assert call(0, 0, 4, 2, *p, 1, 1, out.data_ptr(), None) == 0    # no rows


# -- on a card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_card_gather_launches_the_kernel(dtype):
    """On the card, a table that takes a gradient: one launch a backward,
    the gradient within rounding of the plain version on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    idx = _index("beam", TABLES["psi"][0])
    table = _table("psi").to(dtype)
    w = _weights(idx.shape + (16,)).to(dtype)
    cuda = table.cuda().requires_grad_(True)
    before = ts.table_scatter_launches
    (got,) = torch.autograd.grad((gather_rows(cuda, idx.cuda())
                                  * w.cuda()).sum(), cuda)
    assert ts.table_scatter_launches == before + 1
    want = ts.table_scatter_plain(w.double(), idx, table.shape[0])
    scale = ts.table_scatter_plain(w.double().abs(), idx, table.shape[0])
    eps = torch.finfo(dtype).eps
    assert ((got.cpu().double() - want).abs() <= 64 * eps * scale).all()
