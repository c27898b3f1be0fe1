"""K9, the weak damping of a real ray state over EFIT: its selection, its
plain version's place on the CPU, and its own CUDA source on the host.

``models.absorption.make_weak_damping_real`` takes K9
(``kernels/weak_damping.py``) for CUDA float32/float64 states over a
cell-local ``EfitEquilibrium`` with the default Z and no table but
``psi_coeffs`` requiring grad (``absorption.k9_takes``); everything else,
every CPU tensor included, takes the eager plain version
(``make_weak_damping_real_plain``), and K9 counts no launch there.
``csrc/weak_damping.cu`` itself runs on the host (``g++`` over the
stand-in runtime of ``tools/count_ops.py``, as
tests/test_torch_vmec_rhs.py runs K8) at config 5's launch after three
recorded steps, a ragged count of rays: kamp and the VJP's leaf and
psi-table cotangents against the plain version and autograd of it, each
relative to its largest magnitude, within ``chip_smoke.K9_TOL``; rays whose
cotangent is 0 (the rays ``nan_to_num`` scrubs) give exact zeros, also
where kamp itself is not finite.  The card holds the kernel to the same
limits (tests/test_torch_card.py).
"""

import ctypes
import dataclasses
import shutil
import types

import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch.kernels import build, table_scatter
from graph_framework_tpu_torch.kernels import weak_damping as k9
from graph_framework_tpu_torch.models import absorption
from graph_framework_tpu_torch.models.equilibrium import Slab
from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.ops import special
from graph_framework_tpu_torch.tools import count_ops

RAYS = 301           # two blocks of 128 threads and a ragged third
DTYPES = [torch.float64, torch.float32]
DTYPE_IDS = ["f64", "f32"]


@pytest.fixture(scope="module")
def states():
    return {dtype: chip_smoke.config5_state(RAYS, dtype, "cpu")
            for dtype in DTYPES}


def _cotangent(n, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    ct = torch.complex(torch.randn(n, generator=g, dtype=dtype),
                       torch.randn(n, generator=g, dtype=dtype))
    ct[::7] = 0
    return ct


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """``csrc/weak_damping.cu`` built on the host, typed as kernels/build.py
    types it."""
    if shutil.which("g++") is None:
        pytest.skip("the host build needs g++")
    lib = ctypes.CDLL(str(count_ops.host_library(
        tmp_path_factory.mktemp("weak_damping_host"),
        {"weak_damping.cpp": '#include "weak_damping.cu"\n'},
        every_thread=True, flags=("-O1", "-ffp-contract=off"))))
    for name in ("gft_weak_damping", "gft_weak_damping_vjp"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = build.SIGNATURES[name]
    return lib


def _host_kamp(lib, eq, st):
    leaves = [getattr(st, f) for f in k9.LEAVES]
    psi, prof, params = chip_smoke.k9_tables(eq)
    n = st.x.shape[0]
    out = torch.empty((n, 2), dtype=st.x.dtype)
    assert lib.gft_weak_damping(
        build.DTYPE_CODES[st.x.dtype], n, build.pointers(leaves),
        psi.data_ptr(), psi.shape[0], psi.shape[1], prof.data_ptr(),
        prof.shape[0], params, out.data_ptr(), None) == 0
    return torch.view_as_complex(out)


def _host_vjp(lib, eq, st, ct):
    """The host kernel's leaf cotangents (7, n) and psi table gradient."""
    leaves = [getattr(st, f) for f in k9.LEAVES]
    psi, prof, params = chip_smoke.k9_tables(eq)
    n = st.x.shape[0]
    dtype = st.x.dtype
    ctr = torch.view_as_real(ct).contiguous()
    dleaves = torch.empty((7, n), dtype=dtype)
    rows = torch.empty((n, 16), dtype=dtype)
    cells = torch.empty((n,), dtype=torch.int64)
    assert lib.gft_weak_damping_vjp(
        build.DTYPE_CODES[dtype], n, build.pointers(leaves), ctr.data_ptr(),
        psi.data_ptr(), psi.shape[0], psi.shape[1], prof.data_ptr(),
        prof.shape[0], params, dleaves.data_ptr(),
        rows.data_ptr(), cells.data_ptr(), None) == 0
    d_psi = table_scatter.table_scatter_plain(
        rows, cells, psi.shape[0] * psi.shape[1]).reshape(psi.shape)
    return dleaves, rows, d_psi


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_kernel_source_on_the_host_matches_plain_version(states, host_lib,
                                                         dtype):
    """kamp and the VJP of ``csrc/weak_damping.cu`` on CPU tensors against
    the plain version and autograd of it: kamp's parts, each leaf's
    cotangent and dL/dpsi_coeffs within K9_TOL of their largest
    magnitudes; the rays whose cotangent is 0 give exact zeros."""
    eq, st = states[dtype]
    ct = _cotangent(RAYS, dtype)
    want_kamp, want_leaves, want_psi = chip_smoke.weak_damping_vjp(
        eq, st, ct, plain=True)
    assert float(want_kamp.imag.abs().min()) > 0.0   # every ray damps
    kamp = _host_kamp(host_lib, eq, st)
    devs = chip_smoke.relative_deviations(
        [kamp.real, kamp.imag], [want_kamp.real, want_kamp.imag])
    assert max(devs) <= chip_smoke.K9_TOL[dtype], devs
    dleaves, rows, d_psi = _host_vjp(host_lib, eq, st, ct)
    devs = chip_smoke.relative_deviations(list(dleaves) + [d_psi],
                                          want_leaves + [want_psi])
    assert max(devs) <= chip_smoke.K9_TOL[dtype], dict(
        zip(k9.LEAVES + ("psi_coeffs",), devs))
    assert torch.count_nonzero(dleaves[:, ::7]) == 0
    assert torch.count_nonzero(rows[::7]) == 0


def test_zero_cotangent_rays_stay_zero_where_kamp_is_not_finite(
        states, host_lib):
    """Rays whose kamp is not finite (k = 0: khat is 0/0) take a zero
    cotangent through nan_to_num: the kernel writes exact zeros for them,
    no NaN, and the other rays' cotangents as with a finite kamp."""
    eq, st = states[torch.float64]
    bad = torch.zeros(RAYS, dtype=torch.bool)
    bad[5::11] = True
    st = st._replace(**{f: torch.where(bad, 0.0, getattr(st, f))
                        for f in ("kx", "ky", "kz")})
    kamp = _host_kamp(host_lib, eq, st)
    assert not torch.isfinite(kamp.imag[bad]).any()
    assert torch.isfinite(kamp[~bad]).all()
    ct = _cotangent(RAYS, torch.float64)
    ct[bad] = 0
    dleaves, rows, d_psi = _host_vjp(host_lib, eq, st, ct)
    assert torch.isfinite(dleaves).all() and torch.isfinite(d_psi).all()
    assert torch.count_nonzero(dleaves[:, bad]) == 0
    assert torch.count_nonzero(rows[bad]) == 0
    _, want_leaves, _ = chip_smoke.weak_damping_vjp(eq, st, ct, plain=True)
    good = ~bad
    devs = chip_smoke.relative_deviations(
        [a[good] for a in dleaves], [a[good] for a in want_leaves])
    assert max(devs) <= chip_smoke.K9_TOL[torch.float64], devs


def test_kernel_source_refuses_bad_arguments(states, host_lib):
    eq, st = states[torch.float64]
    leaves = [getattr(st, f) for f in k9.LEAVES]
    psi, prof, params = chip_smoke.k9_tables(eq)
    out = torch.empty((RAYS, 2), dtype=torch.float64)
    for dtype, n, nr in ((2, RAYS, psi.shape[0]), (1, 0, psi.shape[0]),
                         (1, RAYS, 0)):
        assert host_lib.gft_weak_damping(
            dtype, n, build.pointers(leaves), psi.data_ptr(), nr,
            psi.shape[1], prof.data_ptr(), prof.shape[0],
            params, out.data_ptr(), None) == -1
    # the psi rows and their cells come together or not at all
    assert host_lib.gft_weak_damping_vjp(
        1, RAYS, build.pointers(leaves), out.data_ptr(), psi.data_ptr(),
        psi.shape[0], psi.shape[1], prof.data_ptr(), prof.shape[0],
        params, out.data_ptr(), out.data_ptr(), None,
        None) == -1


@pytest.mark.parametrize("grad", [False, True], ids=["value", "grad"])
def test_cpu_tensors_take_the_plain_version(states, grad):
    """On CPU tensors make_weak_damping_real is its plain version bit for
    bit, value and gradients, and K9 counts no launch."""
    eq, st = states[torch.float32]
    ct = _cotangent(RAYS, torch.float32)
    chip_smoke.reset_launch_counts()
    if grad:
        got = chip_smoke.weak_damping_vjp(eq, st, ct)
        want = chip_smoke.weak_damping_vjp(eq, st, ct, plain=True)
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1] + [got[2]], want[1] + [want[2]]):
            assert torch.equal(a, b)
    else:
        got = absorption.make_weak_damping_real(eq)(st)
        assert torch.equal(
            got, absorption.make_weak_damping_real_plain(eq)(st))
    assert chip_smoke.weak_damping_launch_counts() == (0, 0)


def _on_the_card(dtype):
    """A stand-in for a state whose leaves lie on a CUDA device: what
    ``k9_takes`` reads of it (its x's device and dtype)."""
    return types.SimpleNamespace(x=types.SimpleNamespace(
        device=torch.device("cuda", 0), dtype=dtype))


def test_selection(states):
    """K9 takes a CUDA float32/float64 state over a cell-local
    EfitEquilibrium with the default Z whose only table requiring grad, if
    any, is psi_coeffs; nothing else, and no CPU state."""
    eq, st = states[torch.float32]
    takes = absorption.k9_takes
    card = _on_the_card(torch.float32)
    assert takes(eq, card)
    assert takes(eq, _on_the_card(torch.float64))
    assert takes(eq, card, special.z_plasma)
    assert not takes(eq, st)
    assert not takes(eq, _on_the_card(torch.float16))
    assert not takes(eq, _on_the_card(torch.complex64))
    assert not takes(eq, card, special.z_erfi)
    psi = eq.psi_coeffs.clone().requires_grad_(True)
    assert takes(dataclasses.replace(eq, psi_coeffs=psi), card)
    prof = eq.profile_coeffs.clone().requires_grad_(True)
    assert not takes(dataclasses.replace(eq, profile_coeffs=prof), card)
    assert not takes(dataclasses.replace(eq, cell_local=False), card)
    assert not takes(Slab(), card)


def test_wrapper_refuses(states):
    """The wrapper takes CUDA tensors only (the selection never sends it
    CPU ones) and refuses what the kernel does not read."""
    eq, st = states[torch.float32]
    psi, prof, params = chip_smoke.k9_tables(eq)

    def call(state):
        return k9.weak_damping(psi, prof,
                               [getattr(state, f) for f in k9.LEAVES], params)

    with pytest.raises(ValueError, match="CUDA tensors"):
        call(st)
    with pytest.raises(ValueError, match="one dtype and device"):
        call(st._replace(w=st.w.double()))
    with pytest.raises(TypeError, match="float32/float64"):
        call(RayState(*[a.half() for a in st]))
    with pytest.raises(ValueError, match="seven \\(n,\\) leaves"):
        call(st._replace(x=st.x[:-1].contiguous()))
    with pytest.raises(ValueError, match="psi"):
        k9.weak_damping(psi[0], prof, [getattr(st, f) for f in k9.LEAVES],
                        params)
