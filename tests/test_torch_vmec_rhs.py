"""K8, the VMEC ray right-hand side: its plain version, its routing and its
own CUDA source on the host.

The plain version (``kernels.vmec_rhs.ray_rhs_plain``: the chain rule by
hand over K4's jet, no autograd) is held to the eager RHS
(``models.rays.make_ray_rhs``: the geometry, D and ``autograd.grad``) on
the unfused synthetic stellarator, 97 rays over s in (0.05, 0.95) and all
u, v, with a nonzero (k_s, k_u, k_v) off the dispersion's root: per
derivative, relative to its largest magnitude, within 1e-12 in float64 and
1e-5 in float32.  Four faults planted in it each fail that check by a
wide margin: the flow through the basis left out of D_x (the
``reference_correction`` form), the profile's derivative left out, d2chi/ds2
left out, and the ion density taken as te (EFIT's quirk) in place of ne.
``make_ray_rhs`` takes K4 and K8 exactly on the value path of cold plasma
in a fused float32 equilibrium, and the eager path everywhere else.
``csrc/vmec_rhs.cu`` itself runs on the host (``g++`` over the stand-in
runtime of ``tools/count_ops.py``, as tests/test_torch_kernels_host.py runs
K4) against the plain version within ``chip_smoke.K8_TOL``; the card holds
the kernel to the same limits (tests/test_torch_card.py).
"""

import ctypes
import dataclasses
import shutil

import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch.kernels import build, vmec_geom, vmec_rhs
from graph_framework_tpu_torch.models.dispersion import (
    cold_plasma, ordinary_wave)
from graph_framework_tpu_torch.models.rays import make_ray_rhs
from graph_framework_tpu_torch.tools import count_ops

KNOTS = 21          # full-grid knots on s in [-1, 1] (ds = 0.1)
RAYS = 97
TOL = {torch.float64: 1.0e-12, torch.float32: 1.0e-5}
DTYPES = [torch.float64, torch.float32]
DTYPE_IDS = ["f64", "f32"]


def _state(n, dtype, seed=0):
    return chip_smoke.vmec_rhs_state(n, dtype, "cpu", seed)


def _leaves(st):
    return [st.w, st.x, st.y, st.z, st.kx, st.ky, st.kz]


def _plain(eq, st):
    """The plain version over the reference jet of ``eq``'s tables."""
    jet = vmec_geom.reference_jet(st.x, st.y, st.z, vmec_geom.jet_tables(eq))
    return vmec_rhs.ray_rhs(_leaves(st), jet, vmec_rhs.rhs_params(eq))


@pytest.fixture(scope="module")
def equilibria():
    return {dtype: chip_smoke.synthetic_vmec(dtype, "cpu", knots=KNOTS)
            for dtype in DTYPES}


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_plain_version_matches_eager_rhs(equilibria, dtype):
    eq = equilibria[dtype]
    st = _state(RAYS, dtype)
    got = _plain(eq, st)
    want = make_ray_rhs(cold_plasma, eq)(st)
    devs = chip_smoke.relative_deviations(got, want)
    assert max(devs) <= TOL[dtype], dict(zip(want._fields, devs))


def _without_tangents(dual):
    return vmec_rhs._Dual(dual.v, [torch.zeros_like(a) for a in dual.d])


def _basis_flow_left_out(original):
    def wave_vector(kcov, esup):
        return tuple(_without_tangents(a) for a in original(kcov, esup))
    return wave_vector


def _profile_derivative_left_out(original):
    def profile(s):
        return original(s)[0], torch.zeros_like(s)
    return profile


def _d2chi_left_out(original):
    def chi_jet(s, p):
        return _without_tangents(original(s, p))
    return chi_jet


def _ion_density_is_te(original):
    def densities(s):
        (ne, ne_s), _ = original(s)
        return (ne, ne_s), (1e-16 * ne, 1e-16 * ne_s)     # te = 1000 p
    return densities


FAULTS = {"basis_flow": ("_wave_vector", _basis_flow_left_out),
          "profile_derivative": ("_profile", _profile_derivative_left_out),
          "d2chi": ("_chi_jet", _d2chi_left_out),
          "ni_is_te": ("_densities", _ion_density_is_te)}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_planted_faults_fail_the_check(equilibria, monkeypatch, dtype,
                                       fault):
    """Each fault moves some derivative by 1e-4 or more of its scale (read
    1.2e-4 for d2chi, 1.9e-4 to 1.08 for the others), ten times the f32
    limit."""
    eq = equilibria[dtype]
    st = _state(RAYS, dtype)
    name, plant = FAULTS[fault]
    monkeypatch.setattr(vmec_rhs, name, plant(getattr(vmec_rhs, name)))
    devs = chip_smoke.relative_deviations(
        _plain(eq, st), make_ray_rhs(cold_plasma, eq)(st))
    assert max(devs) >= 10 * TOL[torch.float32], devs


def test_routing(equilibria, monkeypatch):
    """K4 and K8 serve exactly the value path of cold plasma in the
    canonical form over a VmecEquilibrium with fused_mode_sums, cell-local
    tables and the physical chi, at (rays,) float32 leaves; every other
    call keeps the eager path."""
    calls = []
    plain = vmec_rhs.ray_rhs_plain

    def counted(*args):
        calls.append(args[0][0].shape)
        return plain(*args)

    monkeypatch.setattr(vmec_rhs, "ray_rhs_plain", counted)
    eq32 = equilibria[torch.float32]
    eqf = dataclasses.replace(eq32, fused_mode_sums=True)
    eqf64 = dataclasses.replace(equilibria[torch.float64],
                                fused_mode_sums=True)
    st = _state(5, torch.float32)
    pos = torch.stack([st.x, st.y, st.z])
    grad_leaf = st._replace(w=st.w.clone().requires_grad_(True))
    grad_table = dataclasses.replace(
        eqf, rmnc_coeffs=eqf.rmnc_coeffs.clone().requires_grad_(True))

    def call(eq, state, dispersion=cold_plasma, grad=True, **options):
        calls.clear()
        with torch.set_grad_enabled(grad):
            out = make_ray_rhs(dispersion, eq, **options)(state)
        assert all(bool(torch.isfinite(a).all()) for a in out)
        return len(calls)

    # the value path of the fused f32 equilibrium: K8
    assert call(eqf, st) == 1
    assert call(eqf, grad_leaf, grad=False) == 1
    assert call(grad_table, st, grad=False) == 1
    # everything else: the eager path
    assert call(eqf, grad_leaf, keep_local_graph=False) == 0
    assert call(eqf64, _state(5, torch.float64)) == 0
    assert call(eq32, st) == 0
    assert call(dataclasses.replace(eqf, cell_local=False), st) == 0
    assert call(dataclasses.replace(eqf, quirky_chi=True), st) == 0
    assert call(eqf.freeze_cells(pos), st) == 0
    assert call(eqf, st, reference_correction=True) == 0
    assert call(eqf, st, dispersion=ordinary_wave) == 0
    assert call(eqf, st._replace(w=st.w.double())) == 0


def test_routed_rhs_matches_eager_rhs(equilibria):
    """The fused f32 equilibrium's RHS (K4's plain jet and K8's plain
    version on the CPU) against the eager RHS of the same tables unfused,
    as test_fused_rhs_matches_unfused holds it (tests/test_torch_vmec_geom.py)
    over this file's rays."""
    eq = equilibria[torch.float32]
    st = _state(RAYS, torch.float32, seed=1)
    got = make_ray_rhs(cold_plasma,
                       dataclasses.replace(eq, fused_mode_sums=True))(st)
    want = make_ray_rhs(cold_plasma, eq)(st)
    devs = chip_smoke.relative_deviations(got, want)
    assert max(devs) <= TOL[torch.float32], dict(zip(want._fields, devs))


def test_wrapper_refuses(equilibria):
    eq = equilibria[torch.float32]
    st = _state(3, torch.float32)
    leaves = _leaves(st)
    jet = vmec_geom.reference_jet(st.x, st.y, st.z, vmec_geom.jet_tables(eq))
    params = vmec_rhs.rhs_params(eq)
    with pytest.raises(ValueError, match="one dtype and device"):
        vmec_rhs.ray_rhs([leaves[0].double(), *leaves[1:]], jet, params)
    with pytest.raises(ValueError, match="one dtype and device"):
        vmec_rhs.ray_rhs(leaves, jet.t().contiguous().t(), params)
    with pytest.raises(ValueError, match="a \\(27, n\\) jet"):
        vmec_rhs.ray_rhs(leaves, jet[:10].contiguous(), params)
    with pytest.raises(TypeError, match="float32/float64"):
        vmec_rhs.ray_rhs([a.half() for a in leaves], jet.half(), params)
    before = vmec_rhs.vmec_rhs_launches
    assert len(vmec_rhs.ray_rhs(leaves, jet, params)) == 6
    assert vmec_rhs.vmec_rhs_launches == before


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """``csrc/vmec_rhs.cu`` built on the host, typed as kernels/build.py
    types it."""
    if shutil.which("g++") is None:
        pytest.skip("the host build needs g++")
    lib = ctypes.CDLL(str(count_ops.host_library(
        tmp_path_factory.mktemp("vmec_rhs_host"),
        {"vmec_rhs.cpp": '#include "vmec_rhs.cu"\n'}, every_thread=True,
        flags=("-O1", "-ffp-contract=off"))))
    argtypes, restype = build.SIGNATURES["gft_vmec_rhs"]
    lib.gft_vmec_rhs.argtypes = argtypes
    lib.gft_vmec_rhs.restype = restype
    return lib


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_kernel_source_on_the_host_matches_plain_version(equilibria,
                                                         host_lib, dtype):
    """``gft_vmec_rhs`` on CPU tensors, a ragged count of rays (two blocks
    of 128 threads and a part), against the plain version."""
    eq = equilibria[dtype]
    st = _state(301, dtype, seed=2)
    leaves = _leaves(st)
    jet = vmec_geom.reference_jet(st.x, st.y, st.z, vmec_geom.jet_tables(eq))
    params = vmec_rhs.rhs_params(eq)
    out = torch.empty((6, 301), dtype=dtype)
    rc = host_lib.gft_vmec_rhs(
        {torch.float32: 0, torch.float64: 1}[dtype], 301,
        build.pointers(leaves), jet.data_ptr(), params.chi.data_ptr(),
        params.chi.shape[0], params.array, out.data_ptr(), None)
    assert rc == 0
    devs = chip_smoke.relative_deviations(
        out.unbind(0), vmec_rhs.ray_rhs_plain(leaves, jet, params))
    assert max(devs) <= chip_smoke.K8_TOL[dtype], devs
    assert host_lib.gft_vmec_rhs(0, 0, build.pointers(leaves),
                                 jet.data_ptr(), params.chi.data_ptr(), 1,
                                 params.array, out.data_ptr(), None) == -1
