"""The forward window kernel K1, its own CUDA source run on the host,
against the plain version.

``csrc/efit_window*.cu`` (and the headers they include: the hand-written
reverse sweeps of D and the stepping templates in ``csrc/efit_adjoint.cuh``)
are compiled with ``g++`` over the stand-in runtime of
``tools/count_ops.py``, whose launch runs every (block, thread) of the
grid: the C function ``gft_efit_window`` then runs on CPU tensors as the
card runs it, FMA contraction aside (``-ffp-contract=off``).  Each of the
eight variants (f32/f64 x rk2/rk4 x plain/compensated) of each of the
eleven dispersions the kernel implements advances 131 rays (two blocks,
the second ragged) through one window of the main path's K = 10
substeps, from a carry whose low words are not zero (one compensated
window of the plain version first), and is held to
``efit_step.frozen_window`` per leaf relative to the scale of its group,
to ``chip_smoke.TOL``: the limits phase 3 holds the card to.  Cold plasma
and the O and X modes start from chip_smoke's launch with kx solved for
each; the other eight from their own launches and steps
(``chip_smoke.TAIL_LAUNCH``).  Each window must move the rays
SEPARATION times the limit (a kernel that does nothing fails), and, in
f64, stiff's must lie as far from the same window whose stages keep t
(``chip_smoke.frozen_stage_t``).  A wrong term in a sweep, a wrong stage
weight, a stage that does not advance t or a dropped low word fails
here.  Skipped where ``g++`` is missing.
"""

import ctypes
import shutil

import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch.kernels import build, efit_step
from graph_framework_tpu_torch.models.dispersion import (
    cold_plasma, extra_ordinary_wave, ordinary_wave, stiff)
from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.ops.compensated import (
    CompCarry, init_comp_carry)
from graph_framework_tpu_torch.solver import init_k
from graph_framework_tpu_torch.tools import count_ops

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the host build needs g++")

N = 131
DISPERSIONS = ([cold_plasma, ordinary_wave, extra_ordinary_wave]
               + list(chip_smoke.TAILS.values()))
TAG = {disp: tag for tag, disp in chip_smoke.TAILS.items()}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The host build of K1's source, typed as kernels/build.py types it."""
    sources = [f"efit_window{'_' * bool(t.tag)}{t.tag}.cu"
               for t in efit_step.KERNEL_TAILS]
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
    """{(dtype, dispersion): (equilibrium, launch state, dt)}: N rays of
    chip_smoke's launch with kx solved by init_k for cold plasma and the
    two modes, and of each other tail's own launch."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        eq = chip_smoke.synthetic_equilibrium(dtype, "cpu")
        for disp in DISPERSIONS:
            if disp in TAG:
                st, dt = chip_smoke.tail_launch(TAG[disp], N, eq,
                                                seed=chip_smoke.SEED + 1)
            else:
                st, dt = init_k(chip_smoke.launch(
                    N, dtype, "cpu", seed=chip_smoke.SEED + 1), disp,
                    eq), chip_smoke.DT
            out[dtype, disp] = (eq, RayState(*[leaf.detach().contiguous()
                                               for leaf in st]), dt)
    return out


def _host_window(lib, eq, carry, method, compensated, disp=cold_plasma,
                 dt=chip_smoke.DT):
    """``gft_efit_window`` on CPU tensors: the advanced carry."""
    leaves = (list(carry.hi) + list(carry.lo) if compensated
              else list(carry))
    outs = [torch.empty_like(a) for a in leaves]
    params = efit_step.kernel_param_array(eq, dt)
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
    eq, st, dt = inputs[dtype, disp]
    kw = dict(method=method, dt=dt, steps=chip_smoke.FREEZE_EVERY,
              compensated=compensated)
    carry = st
    if compensated:
        carry = efit_step.frozen_window(eq, disp, init_comp_carry(st), **kw)
        assert any(bool((leaf != 0).any()) for leaf in carry.lo)
    got = _host_window(host_lib, eq, carry, method, compensated, disp, dt)
    want = efit_step.frozen_window(eq, disp, carry, **kw)
    errors = chip_smoke.leaf_errors(got, want)
    limit = chip_smoke.TOL[dtype, compensated]
    assert max(errors.values()) <= limit, errors
    moved = chip_smoke.leaf_errors(carry, want)
    # bohm_gross and acoustic_wave move along B, not in x
    leaf = max("xyz", key=moved.get) if disp in TAG else "x"
    assert moved[leaf] > chip_smoke.SEPARATION * limit, moved
    if disp is stiff and dtype == torch.float64:
        with chip_smoke.frozen_stage_t():
            held = efit_step.frozen_window(eq, disp, carry, **kw)
        wrong = chip_smoke.leaf_errors(held, want)
        assert wrong["x"] > chip_smoke.SEPARATION * limit, wrong


def test_kernel_refuses_bad_arguments(host_lib, inputs):
    """The C interface returns -1 for a dispersion, method, compensation
    flag or step count it does not take, and launches nothing."""
    eq, st, _ = inputs[torch.float64, cold_plasma]
    leaves = list(st)
    params = efit_step.kernel_param_array(eq, chip_smoke.DT)
    psi, prof = eq.psi_coeffs, eq.profile_coeffs
    for disp, method, comp, steps in ((0, 3, 0, 10), (0, 2, 2, 10),
                                      (0, 2, 0, 0), (11, 2, 0, 10),
                                      (-1, 2, 0, 10)):
        outs = [torch.full_like(a, 7.0) for a in leaves]
        rc = host_lib.gft_efit_window(
            1, disp, method, comp, steps, N, build.pointers(leaves),
            build.pointers(outs), psi.data_ptr(), psi.shape[0],
            psi.shape[1], prof.data_ptr(), prof.shape[0], params, None)
        assert rc == -1
        assert all(bool((o == 7.0).all()) for o in outs)
