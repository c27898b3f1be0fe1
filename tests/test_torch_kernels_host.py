"""The slab push K5, the VMEC geometry jet K4 and the grid deposit K6, their
own CUDA source run on the host, against the plain versions.

``csrc/boris.cu``, ``csrc/vmec_geom.cu`` and ``csrc/deposit.cu`` are
compiled with ``g++`` over the stand-in runtime of ``tools/count_ops.py``,
whose launch runs every block of the grid, a block's threads together (one
``std::thread`` each, ``__syncthreads`` a barrier, shared memory shared):
the C functions ``gft_slab_push``, ``gft_vmec_geom`` and ``gft_deposit``
then run on CPU tensors as the card runs them, FMA
contraction aside (``-ffp-contract=off``), and with the f32 kernels' PTX
approximations (``rsqrt.approx``, ``rcp.approx``) replaced by rounded
double arithmetic.  The f64 kernels have no approximation: they are held
to ``slab_push_plain`` within 1e-12 (``chip_smoke.K5_TOL``) per leaf and
to ``reference_jet`` within 5e-14 (``chip_smoke.K4_TOL``) per sum, each
relative to its largest magnitude; f32 to the same module's f32 limits.
K5 runs a ragged particle count (not a multiple of its 256-thread block)
for one step and a launch of 100 in two slab fields; K4 a few hundred rays
with s over both clamps, over the 86-mode synthetic tables, a ragged mode
set (modes dropped, n with gaps) and the modes in reverse order.  K6 runs
a ragged particle count (not a multiple of its 1024-particle chunks) with
a mask that holds zeros, onto G = 1000, a ragged 1001, a grid that is
neither uniform nor sorted, and with particles beyond the grid's reach,
within ``chip_smoke.K6_TOL`` of ``deposit_plain``, twice with the same
bits; a NaN or infinite particle leaves n and e non-finite exactly where
the plain version's are.  Skipped where ``g++`` is missing.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch.kernels import boris, build, vmec_geom
from graph_framework_tpu_torch.kernels import deposit as k6
from graph_framework_tpu_torch.models.pic import WIDTH
from graph_framework_tpu_torch.tools import count_ops

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the host build needs g++")

DTYPES = [torch.float32, torch.float64]
DTYPE_IDS = ["f32", "f64"]
CODES = {torch.float32: 0, torch.float64: 1}
PARTICLES = 1037
RAYS = 301
#: K6's particles: six chunks of the counting sort, the last one ragged.
DEPOSIT_PARTICLES = 6007
#: A slab field whose quotients b_shear / b0 and b1 / b0 are not 0.1 and 1.
OTHER_SLAB = dict(dt=0.3, b0=2.0, b1=1.5, b_shear=0.3, larmor=0.7)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The host build of the two sources, typed as kernels/build.py types
    them."""
    units = {"boris.cpp": '#include "boris.cu"\n',
             "vmec_geom.cpp": '#include "vmec_geom.cu"\n',
             "deposit.cpp": '#include "deposit.cu"\n'}
    lib = ctypes.CDLL(str(count_ops.host_library(
        tmp_path_factory.mktemp("kernels_host"), units, every_thread=True,
        flags=("-O1", "-ffp-contract=off"))))
    for name in ("gft_slab_push", "gft_vmec_geom", "gft_deposit",
                 "gft_deposit_scratch_bytes"):
        argtypes, restype = build.SIGNATURES[name]
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    return lib


def _host_push(lib, leaves, steps, slab):
    """``gft_slab_push`` on CPU tensors: the six advanced leaves."""
    outs = [torch.empty_like(a) for a in leaves]
    p = boris._params(**slab)
    params = (ctypes.c_double * 6)(p["dt"], p["b0"], p["b1"], p["b_shear"],
                                   p["neg_half_dt"], p["larmor_dt"])
    rc = lib.gft_slab_push(CODES[leaves[0].dtype], leaves[0].shape[0], steps,
                           build.pointers(leaves), build.pointers(outs),
                           params, None)
    assert rc == 0
    return outs


@pytest.mark.parametrize("slab", [chip_smoke.SLAB, OTHER_SLAB],
                         ids=["bench", "other"])
@pytest.mark.parametrize("steps", [1, chip_smoke.SLAB_STEPS])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_slab_push_source_matches_plain_version(host_lib, dtype, steps,
                                                slab):
    """K5 against ``slab_push_plain``, per leaf relative to its largest
    magnitude; u_z comes out as it went in (the rotation is about z)."""
    leaves = chip_smoke.particle_ensemble(PARTICLES, dtype, "cpu",
                                          chip_smoke.SEED + 5)
    got = _host_push(host_lib, leaves, steps, slab)
    want = boris.slab_push_plain(*leaves, **slab, steps=steps)
    devs = chip_smoke.relative_deviations(got, want)
    assert max(devs) <= chip_smoke.K5_TOL[dtype], devs
    assert torch.equal(got[5], leaves[5])


def _host_jet(lib, coords, tables):
    """``gft_vmec_geom`` on CPU tensors: the (27, n) jet."""
    s, u, v = coords
    n = s.shape[0]
    out = torch.empty((len(vmec_geom.JET_NAMES), n), dtype=s.dtype)
    runs = tables.modes.runs
    params = (ctypes.c_double * 4)(tables.sminf, tables.sminh, tables.ds,
                                   tables.modes.nfp)
    rc = lib.gft_vmec_geom(
        CODES[s.dtype], n, s.data_ptr(), u.data_ptr(), v.data_ptr(),
        tables.rz_by_mode.data_ptr(), tables.lm_by_mode.data_ptr(),
        runs.data_ptr(),
        runs.shape[0], tables.rz.shape[0], tables.lm.shape[0],
        tables.lm.shape[-1], params, out.data_ptr(), None)
    assert rc == 0
    return out


def _select_modes(tables, keep):
    """The tables over the modes ``keep`` (an index array), in its order."""
    g = tables.lm.shape[-1]
    idx = torch.as_tensor(keep)
    rz = torch.cat([tables.rz[..., idx], tables.rz[..., g + idx]], dim=-1)
    return vmec_geom.make_jet_tables(
        rz.contiguous(), tables.lm[..., idx].contiguous(),
        tables.xm[idx].contiguous(), tables.xn[idx].contiguous(),
        tables.sminf, tables.sminh, tables.ds)


def _mode_sets(tables):
    """{name: tables}: the 86 modes; a ragged set (every third mode and
    the last one dropped: runs of other lengths, n with gaps); the 86 in
    reverse order (m falls from run to run, n descends: one run a mode)."""
    g = tables.lm.shape[-1]
    ragged = [j for j in range(g - 1) if j % 3 != 1]
    return {"86 modes": tables, "ragged": _select_modes(tables, ragged),
            "reversed": _select_modes(tables, list(range(g))[::-1])}


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_vmec_geom_source_matches_plain_version(host_lib, dtype):
    """K4 against ``reference_jet``, all 27 sums, each relative to its
    largest magnitude, over three mode sets; and the runs they make."""
    _, tables, coords = chip_smoke.k4_inputs(RAYS, dtype, "cpu",
                                             chip_smoke.SEED + 7)
    sets = _mode_sets(tables)
    assert [len(t.modes.layout) for t in sets.values()] == [10, 29, 86]
    assert {t.modes.nfp for t in sets.values()} == {chip_smoke.VMEC_NFP}
    for name, t in sets.items():
        devs = chip_smoke.relative_rows(_host_jet(host_lib, coords, t),
                                        vmec_geom.reference_jet(*coords, t))
        assert max(devs) <= chip_smoke.K4_TOL[dtype], (
            name, dict(zip(vmec_geom.JET_NAMES, devs)))


def test_mode_runs_of_the_reference_modes():
    """VMEC's order gives one run a value of m: (0, 0, 5), then (m, -4, 9)
    for m = 1..9, nfp 5."""
    xm, xn = (torch.from_numpy(a) for a in chip_smoke.vmec_mode_numbers())
    modes = vmec_geom.mode_runs(xm, xn)
    assert modes.nfp == chip_smoke.VMEC_NFP
    assert modes.layout == ((0, 0, 5),) + tuple((m, -4, 9)
                                                 for m in range(1, 10))
    assert modes.runs.dtype == torch.int32
    assert modes.runs.tolist() == [list(r) for r in modes.layout]


@pytest.mark.parametrize("case", ["xm half", "xn half", "xm negative"])
def test_mode_runs_refuse_non_integer_modes(case):
    """A mode set that is not integer m >= 0 and integer xn raises, as
    building the tables and so the wrapper does: no VMEC file makes one."""
    xm, xn = (torch.from_numpy(a) for a in chip_smoke.vmec_mode_numbers())
    xm, xn = {"xm half": (xm + 0.5, xn), "xn half": (xm, xn + 0.5),
              "xm negative": (xm - 1.0, xn)}[case]
    with pytest.raises(ValueError, match="integer mode numbers"):
        vmec_geom.mode_runs(xm, xn)
    _, tables, _ = chip_smoke.k4_inputs(64, torch.float64, "cpu", 0)
    with pytest.raises(ValueError, match="integer mode numbers"):
        vmec_geom.make_jet_tables(tables.rz, tables.lm, xm.double(),
                                  xn.double(), tables.sminf, tables.sminh,
                                  tables.ds)


def test_wrapper_refuses_runs_of_other_modes():
    """Tables whose runs or mode-major copies describe another mode count
    are refused before any launch (a table replaced without them)."""
    _, tables, coords = chip_smoke.k4_inputs(64, torch.float64, "cpu", 0)
    short = vmec_geom.mode_runs(tables.xm[:-1], tables.xn[:-1])
    with pytest.raises(ValueError, match="mode runs"):
        vmec_geom.geometry_jet(*coords, tables._replace(modes=short))
    with pytest.raises(ValueError, match="mode-major"):
        vmec_geom.geometry_jet(*coords, tables._replace(
            rz_by_mode=tables.rz_by_mode[:, :-1].contiguous()))
    np.testing.assert_array_equal(
        vmec_geom.geometry_jet(*coords, tables).numpy(),
        vmec_geom.reference_jet(*coords, tables).numpy())


def _host_deposit(lib, x, mask, grid):
    """``gft_deposit`` on CPU tensors: (n, e), as kernels.deposit._launch
    returns them on the card."""
    code = CODES[x.dtype]
    nbytes = lib.gft_deposit_scratch_bytes(code, x.shape[0], grid.shape[0])
    assert nbytes > 0
    scratch = torch.empty(nbytes + 256, dtype=torch.uint8)
    base = (-scratch.data_ptr()) % 256    # the card's allocator aligns so
    n, e = torch.empty_like(grid), torch.empty_like(grid)
    width = WIDTH
    params = (ctypes.c_double * 3)(*k6._params(width, 1.0, 1.0),
                                   k6.reach(width, x.dtype))
    rc = lib.gft_deposit(code, x.shape[0], grid.shape[0], x.data_ptr(),
                         mask.data_ptr(), grid.data_ptr(),
                         scratch.data_ptr() + base, n.data_ptr(),
                         e.data_ptr(), params, None)
    assert rc == 0
    return n, e


def _deposit_case(case, dtype):
    """(x, mask, grid) of one K6 case, from chip_smoke.deposit_inputs."""
    g = 1001 if case == "G=1001" else 1000
    x, mask, grid = chip_smoke.deposit_inputs(
        DEPOSIT_PARTICLES, g, dtype, "cpu", chip_smoke.SEED + 6)
    if case == "non-uniform grid":
        rng = np.random.default_rng(chip_smoke.SEED + 11)
        grid = torch.from_numpy(rng.uniform(-1.2, 1.2, 777)).to(dtype)
    if case == "beyond reach":
        far = torch.tensor([-50.0, -2.0, -1.2, 1.15, 1.5, 3.0, 1e6],
                           dtype=dtype)
        x = x.clone()
        x[::857][:far.numel()] = far
    return x, mask, grid


@pytest.mark.parametrize("case", ["G=1000", "G=1001", "non-uniform grid",
                                  "beyond reach"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_deposit_source_matches_plain_version(host_lib, dtype, case):
    """K6 against ``deposit_plain``: n and e, each relative to its largest
    magnitude, within K6_TOL; a second run gives the same bits."""
    x, mask, grid = _deposit_case(case, dtype)
    got = _host_deposit(host_lib, x, mask, grid)
    want = k6.deposit_plain(x, mask, grid)
    devs = chip_smoke.relative_deviations(got, want)
    assert max(devs) <= chip_smoke.K6_TOL[dtype], devs
    again = _host_deposit(host_lib, x, mask, grid)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("bad", ["nan", "inf"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_deposit_non_finite_particle(host_lib, dtype, bad):
    """One NaN particle makes every n and e NaN (exp(NaN) 0 is NaN, as in
    the plain version's sum, and so is its part of e); one infinite
    particle adds nothing to n and makes e non-finite: K6's outputs are
    finite exactly where the plain version's are, and agree there."""
    x, mask, grid = _deposit_case("G=1000", dtype)
    x = x.clone()
    x[1234] = float(bad)
    got = _host_deposit(host_lib, x, mask, grid)
    want = k6.deposit_plain(x, mask, grid)
    for a, b in zip(got, want):
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    finite = torch.isfinite(want[0])
    assert bool(finite.all()) == (bad == "inf")
    if finite.any():
        assert max(chip_smoke.relative_deviations(
            [got[0][finite]], [want[0][finite]])) <= chip_smoke.K6_TOL[dtype]
