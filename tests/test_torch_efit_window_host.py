"""The forward window kernel K1, its own CUDA source run on the host,
against the plain version.

``csrc/efit_window.cu`` (and the headers it includes: the hand-written
reverse sweep of D and the stepping templates in ``csrc/efit_adjoint.cuh``)
is compiled with ``g++`` over the stand-in runtime of
``tools/count_ops.py``, whose launch runs every (block, thread) of the
grid: the C function ``gft_efit_window`` then runs on CPU tensors as the
card runs it, FMA contraction aside (``-ffp-contract=off``).  Each of the
eight variants (f32/f64 x rk2/rk4 x plain/compensated) advances 131 rays of
chip_smoke's launch (two blocks, the second ragged) through one window of
the main path's K = 10 substeps, from a carry whose low words are not zero
(one compensated window of the plain version first), and is held to
``efit_step.frozen_window`` per leaf relative to the scale of its group, to
``chip_smoke.TOL``: the limits phase 3 holds the card to.  A wrong term in
the sweep, a wrong stage weight or a dropped low word fails here.  Skipped
where ``g++`` is missing.
"""

import ctypes
import shutil

import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch.kernels import build, efit_step
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.ops.compensated import (
    CompCarry, init_comp_carry)
from graph_framework_tpu_torch.solver import init_k
from graph_framework_tpu_torch.tools import count_ops

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the host build needs g++")

N = 131


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The host build of K1's source, typed as kernels/build.py types it."""
    lib = ctypes.CDLL(str(count_ops.host_library(
        tmp_path_factory.mktemp("efit_window_host"),
        {"efit_window.cpp": '#include "efit_window.cu"\n'},
        every_thread=True, flags=("-O1", "-ffp-contract=off"))))
    argtypes, restype = build.SIGNATURES["gft_efit_window"]
    lib.gft_efit_window.argtypes = argtypes
    lib.gft_efit_window.restype = restype
    return lib


@pytest.fixture(scope="module")
def inputs():
    """{dtype: (equilibrium, launch state)}: N rays of chip_smoke's launch,
    kx solved by init_k."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        eq = chip_smoke.synthetic_equilibrium(dtype, "cpu")
        st = init_k(chip_smoke.launch(N, dtype, "cpu",
                                      seed=chip_smoke.SEED + 1),
                    cold_plasma, eq)
        out[dtype] = (eq, RayState(*[leaf.detach().contiguous()
                                     for leaf in st]))
    return out


def _host_window(lib, eq, carry, method, compensated):
    """``gft_efit_window`` on CPU tensors: the advanced carry."""
    leaves = (list(carry.hi) + list(carry.lo) if compensated
              else list(carry))
    outs = [torch.empty_like(a) for a in leaves]
    params = (ctypes.c_double * 13)(*efit_step.kernel_params(
        eq, chip_smoke.DT))
    psi, prof = eq.psi_coeffs, eq.profile_coeffs
    rc = lib.gft_efit_window(
        {torch.float32: 0, torch.float64: 1}[leaves[0].dtype],
        {"rk2": 2, "rk4": 4}[method], int(compensated),
        chip_smoke.FREEZE_EVERY, N, build.pointers(leaves),
        build.pointers(outs), psi.data_ptr(), psi.shape[0], psi.shape[1],
        prof.data_ptr(), prof.shape[0], params, None)
    assert rc == 0
    if compensated:
        return CompCarry(RayState(*outs[:8]), RayState(*outs[8:]))
    return RayState(*outs)


@pytest.mark.parametrize("compensated", [False, True],
                         ids=["plain", "comp"])
@pytest.mark.parametrize("method", ["rk2", "rk4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kernel_source_matches_plain_version(host_lib, inputs, dtype, method,
                                             compensated):
    """K1 against frozen_window over one K = 10 window, within TOL."""
    eq, st = inputs[dtype]
    kw = dict(method=method, dt=chip_smoke.DT,
              steps=chip_smoke.FREEZE_EVERY, compensated=compensated)
    carry = st
    if compensated:
        carry = efit_step.frozen_window(eq, cold_plasma, init_comp_carry(st),
                                        **kw)
        assert any(bool((leaf != 0).any()) for leaf in carry.lo)
    got = _host_window(host_lib, eq, carry, method, compensated)
    want = efit_step.frozen_window(eq, cold_plasma, carry, **kw)
    errors = chip_smoke.leaf_errors(got, want)
    assert max(errors.values()) <= chip_smoke.TOL[dtype, compensated], errors
    moved = chip_smoke.leaf_errors(carry, want)
    assert moved["x"] > chip_smoke.SEPARATION * chip_smoke.TOL[
        dtype, compensated], moved


def test_kernel_refuses_bad_arguments(host_lib, inputs):
    """The C interface returns -1 for a method, compensation flag or step
    count it does not take, and launches nothing."""
    eq, st = inputs[torch.float64]
    leaves = list(st)
    params = (ctypes.c_double * 13)(*efit_step.kernel_params(
        eq, chip_smoke.DT))
    psi, prof = eq.psi_coeffs, eq.profile_coeffs
    for method, comp, steps in ((3, 0, 10), (2, 2, 10), (2, 0, 0)):
        outs = [torch.full_like(a, 7.0) for a in leaves]
        rc = host_lib.gft_efit_window(
            1, method, comp, steps, N, build.pointers(leaves),
            build.pointers(outs), psi.data_ptr(), psi.shape[0],
            psi.shape[1], prof.data_ptr(), prof.shape[0], params, None)
        assert rc == -1
        assert all(bool((o == 7.0).all()) for o in outs)
