"""The forward window kernel K1, its own CUDA source run on the host,
against the plain version.

``csrc/efit_window*.cu`` (and the headers they include: the hand-written
reverse sweeps of D and the stepping templates in ``csrc/efit_adjoint.cuh``)
are compiled with ``g++`` over the stand-in runtime of
``tools/count_ops.py``, whose launch runs every (block, thread) of the
grid: the C function ``gft_efit_window`` then runs on CPU tensors as the
card runs it, FMA contraction aside (``-ffp-contract=off``).  Each of the
eight variants (f32/f64 x rk2/rk4 x plain/compensated) of each dispersion
the kernel implements (cold plasma, the O and the X mode) advances 131 rays
of chip_smoke's launch (two blocks, the second ragged; kx solved for that
dispersion) through one window of the main path's K = 10 substeps, from a
carry whose low words are not zero (one compensated window of the plain
version first), and is held to ``efit_step.frozen_window`` per leaf
relative to the scale of its group, to ``chip_smoke.TOL``: the limits
phase 3 holds the card to.  A wrong term in a sweep, a wrong stage weight
or a dropped low word fails here.  Skipped where ``g++`` is missing.
"""

import ctypes
import shutil

import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch.kernels import build, efit_step
from graph_framework_tpu_torch.models.dispersion import (
    cold_plasma, extra_ordinary_wave, ordinary_wave)
from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.ops.compensated import (
    CompCarry, init_comp_carry)
from graph_framework_tpu_torch.solver import init_k
from graph_framework_tpu_torch.tools import count_ops

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the host build needs g++")

N = 131
DISPERSIONS = [cold_plasma, ordinary_wave, extra_ordinary_wave]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The host build of K1's source, typed as kernels/build.py types it."""
    sources = ("efit_window.cu", "efit_window_omode.cu",
               "efit_window_xmode.cu")
    lib = ctypes.CDLL(str(count_ops.host_library(
        tmp_path_factory.mktemp("efit_window_host"),
        {f"{name[:-3]}.cpp": f'#include "{name}"\n' for name in sources},
        every_thread=True, flags=("-O1", "-ffp-contract=off"))))
    argtypes, restype = build.SIGNATURES["gft_efit_window"]
    lib.gft_efit_window.argtypes = argtypes
    lib.gft_efit_window.restype = restype
    return lib


@pytest.fixture(scope="module")
def inputs():
    """{(dtype, dispersion): (equilibrium, launch state)}: N rays of
    chip_smoke's launch, kx solved by init_k for the dispersion."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        eq = chip_smoke.synthetic_equilibrium(dtype, "cpu")
        for disp in DISPERSIONS:
            st = init_k(chip_smoke.launch(N, dtype, "cpu",
                                          seed=chip_smoke.SEED + 1),
                        disp, eq)
            out[dtype, disp] = (eq, RayState(*[leaf.detach().contiguous()
                                               for leaf in st]))
    return out


def _host_window(lib, eq, carry, method, compensated, disp=cold_plasma):
    """``gft_efit_window`` on CPU tensors: the advanced carry."""
    leaves = (list(carry.hi) + list(carry.lo) if compensated
              else list(carry))
    outs = [torch.empty_like(a) for a in leaves]
    params = (ctypes.c_double * 13)(*efit_step.kernel_params(
        eq, chip_smoke.DT))
    psi, prof = eq.psi_coeffs, eq.profile_coeffs
    rc = lib.gft_efit_window(
        {torch.float32: 0, torch.float64: 1}[leaves[0].dtype],
        efit_step.kernel_dispersion_code(disp),
        {"rk2": 2, "rk4": 4}[method], int(compensated),
        chip_smoke.FREEZE_EVERY, N, build.pointers(leaves),
        build.pointers(outs), psi.data_ptr(), psi.shape[0], psi.shape[1],
        prof.data_ptr(), prof.shape[0], params, None)
    assert rc == 0
    if compensated:
        return CompCarry(RayState(*outs[:8]), RayState(*outs[8:]))
    return RayState(*outs)


@pytest.mark.parametrize("disp", DISPERSIONS, ids=lambda d: d.__name__)
@pytest.mark.parametrize("compensated", [False, True],
                         ids=["plain", "comp"])
@pytest.mark.parametrize("method", ["rk2", "rk4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kernel_source_matches_plain_version(host_lib, inputs, dtype, method,
                                             compensated, disp):
    """K1 against frozen_window over one K = 10 window, within TOL."""
    eq, st = inputs[dtype, disp]
    kw = dict(method=method, dt=chip_smoke.DT,
              steps=chip_smoke.FREEZE_EVERY, compensated=compensated)
    carry = st
    if compensated:
        carry = efit_step.frozen_window(eq, disp, init_comp_carry(st), **kw)
        assert any(bool((leaf != 0).any()) for leaf in carry.lo)
    got = _host_window(host_lib, eq, carry, method, compensated, disp)
    want = efit_step.frozen_window(eq, disp, carry, **kw)
    errors = chip_smoke.leaf_errors(got, want)
    assert max(errors.values()) <= chip_smoke.TOL[dtype, compensated], errors
    moved = chip_smoke.leaf_errors(carry, want)
    assert moved["x"] > chip_smoke.SEPARATION * chip_smoke.TOL[
        dtype, compensated], moved


def test_kernel_refuses_bad_arguments(host_lib, inputs):
    """The C interface returns -1 for a dispersion, method, compensation
    flag or step count it does not take, and launches nothing."""
    eq, st = inputs[torch.float64, cold_plasma]
    leaves = list(st)
    params = (ctypes.c_double * 13)(*efit_step.kernel_params(
        eq, chip_smoke.DT))
    psi, prof = eq.psi_coeffs, eq.profile_coeffs
    for disp, method, comp, steps in ((0, 3, 0, 10), (0, 2, 2, 10),
                                      (0, 2, 0, 0), (3, 2, 0, 10),
                                      (-1, 2, 0, 10)):
        outs = [torch.full_like(a, 7.0) for a in leaves]
        rc = host_lib.gft_efit_window(
            1, disp, method, comp, steps, N, build.pointers(leaves),
            build.pointers(outs), psi.data_ptr(), psi.shape[0],
            psi.shape[1], prof.data_ptr(), prof.shape[0], params, None)
        assert rc == -1
        assert all(bool((o == 7.0).all()) for o in outs)
