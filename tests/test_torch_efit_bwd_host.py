"""The backward window kernels K2 and K3, their own CUDA source run on the
host, against the plain versions.

``csrc/efit_window_bwd*.cu`` (and the headers they include) are compiled
with ``g++`` over the stand-in runtime of ``tools/count_ops.py``, whose
launch walks every (block, thread) of the grid: the C function
``gft_efit_window_bwd`` then runs on CPU tensors exactly as the card runs
it, FMA contraction aside (``-ffp-contract=off``).  Each of the eight
variants (rk2/rk4 x f32/f64 x K2/K3) of each dispersion the kernels
implement (cold plasma, the O and the X mode) runs over 64 rays of
chip_smoke's launch (kx solved for that dispersion) for one substep, the
main path's window (K = 10) and a window longer than the kernel's stored
slots (which recomputes from a checkpoint), and is held to
``efit_step.frozen_window_vjp`` / ``frozen_window_vjp_blocks`` (autograd
of the plain window): per state leaf and per block tensor, relative to its
largest magnitude, f64 within 1e-12 and f32 within ``chip_smoke.BWD_TOL``;
the block cells equal.  A hand-written adjoint wrong by one term fails
here, before any card run.

Two more cases hold the hand-written gradients of D (``csrc/
efit_adjoint.cuh``) in f64: cold plasma's to ``ray_grad``'s forward-mode
gradient, and each dispersion's to autograd of its plain version over the
same frozen blocks.  Skipped where ``g++`` is missing.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch.kernels import build, efit_step
from graph_framework_tpu_torch.models.dispersion import (
    cold_plasma, extra_ordinary_wave, ordinary_wave)
from graph_framework_tpu_torch.models.rays import (
    RayState, dispersion_residual)
from graph_framework_tpu_torch.solver import init_k
from graph_framework_tpu_torch.tools import count_ops

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the host build needs g++")

N = 64
#: Substeps of one window: one, the main path's and one past the stored
#: slots (csrc/efit_window_bwd.cuh kSlots = 16).
STEPS = [1, chip_smoke.FREEZE_EVERY, 20]
F64_TOL = 1.0e-12
GRAD_TOL = 1.0e-13

DISPERSIONS = [cold_plasma, ordinary_wave, extra_ordinary_wave]

_SOURCES = [f"efit_window_bwd{mode}{part}.cu"
            for mode in ("", "_omode", "_xmode")
            for part in ("", "_f64", "_tab", "_tab_f64")]

# D's gradients at n states, each (n, 7) row-major: the hand-written
# adjoint of the dispersion `disp` (the one the kernels run) and, for cold
# plasma, forward mode (ray_grad).
_GRAD_HARNESS = r"""
#include "efit_adjoint.cuh"
extern "C" void gft_d_grads(int disp, long long n,
                            const double* const* state, const double* psi,
                            int nr, int nz, const double* prof, int npsi,
                            const double* params, double* g_adj,
                            double* g_fwd) {
  using namespace gft;
  const Params<double> p = make_params<double>(params, nr, nz, npsi);
  for (long long i = 0; i < n; ++i) {
    double s[8];
    for (int k = 0; k < 8; ++k) s[k] = state[k][i];
    const Frozen<double> f = freeze(s, psi, prof, p);
    if (disp == 0) AdjointGrad<ColdPlasma>::grad(s, f, p, g_adj + 7 * i);
    if (disp == 1) AdjointGrad<OrdinaryWave>::grad(s, f, p, g_adj + 7 * i);
    if (disp == 2)
      AdjointGrad<ExtraOrdinaryWave>::grad(s, f, p, g_adj + 7 * i);
    ray_grad(s, f, p, g_fwd + 7 * i);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The host build of the four backward sources and the gradient
    harness, with ``gft_efit_window_bwd`` typed as kernels/build.py types
    it."""
    units = {f"{name[:-3]}.cpp": f'#include "{name}"\n' for name in _SOURCES}
    units["d_grads.cpp"] = _GRAD_HARNESS
    lib = ctypes.CDLL(str(count_ops.host_library(
        tmp_path_factory.mktemp("efit_bwd_host"), units, every_thread=True,
        flags=("-O1", "-ffp-contract=off"))))
    argtypes, restype = build.SIGNATURES["gft_efit_window_bwd"]
    lib.gft_efit_window_bwd.argtypes = argtypes
    lib.gft_efit_window_bwd.restype = restype
    ptr = ctypes.c_void_p
    lib.gft_d_grads.argtypes = [
        ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ptr), ptr,
        ctypes.c_int,
        ctypes.c_int, ptr, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ptr, ptr]
    lib.gft_d_grads.restype = None
    return lib


@pytest.fixture(scope="module")
def inputs():
    """{(dtype, dispersion): (equilibrium, launch state, output
    cotangent)}: 64 rays of chip_smoke's launch, kx solved by init_k for
    the dispersion, seeded normal cotangents."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        eq = chip_smoke.synthetic_equilibrium(dtype, "cpu")
        for disp in DISPERSIONS:
            st = init_k(chip_smoke.launch(N, dtype, "cpu",
                                          seed=chip_smoke.SEED + 1),
                        disp, eq)
            st = RayState(*[leaf.detach().contiguous() for leaf in st])
            out[dtype, disp] = (eq, st, chip_smoke.random_cotangent(
                st, chip_smoke.SEED + 2))
    return out


def _host_vjp(lib, eq, state, ct, method, steps, tables, disp=cold_plasma):
    """``gft_efit_window_bwd`` on CPU tensors: a WindowVjp, as
    efit_step._launch_bwd returns it on the card."""
    x = state.x
    outs = [torch.empty_like(a) for a in state]
    blocks = torch.full((2, 16, N), float("nan"), dtype=x.dtype)
    cells = torch.full((2, N), -1, dtype=torch.int64)
    params = (ctypes.c_double * 13)(*efit_step.kernel_params(
        eq, chip_smoke.DT))
    psi, prof = eq.psi_coeffs, eq.profile_coeffs
    extra = ([blocks[0].data_ptr(), blocks[1].data_ptr(),
              cells[0].data_ptr(), cells[1].data_ptr()] if tables
             else [None] * 4)
    rc = lib.gft_efit_window_bwd(
        {torch.float32: 0, torch.float64: 1}[x.dtype],
        efit_step.kernel_dispersion_code(disp),
        {"rk2": 2, "rk4": 4}[method], steps, N, build.pointers(list(state)),
        build.pointers(list(ct)), build.pointers(outs), psi.data_ptr(),
        psi.shape[0], psi.shape[1], prof.data_ptr(), prof.shape[0], params,
        *extra, None)
    assert rc == 0
    if not tables:
        return efit_step.WindowVjp(RayState(*outs))
    return efit_step.WindowVjp(RayState(*outs), blocks[0].t(), blocks[1].t(),
                               cells[0], cells[1])


@pytest.mark.parametrize("disp", DISPERSIONS, ids=lambda d: d.__name__)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("method", ["rk2", "rk4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kernel_source_matches_plain_version(host_lib, inputs, dtype, method,
                                             steps, kernel, disp):
    """K2 (state cotangent) and K3 (and the block cotangents and cells)
    from their CUDA source against autograd of the plain window."""
    eq, st, ct = inputs[dtype, disp]
    tables = kernel == "K3"
    kw = dict(method=method, dt=chip_smoke.DT, steps=steps)
    got = _host_vjp(host_lib, eq, st, ct, method, steps, tables, disp)
    want = efit_step.frozen_window_vjp_blocks(eq, st, ct, dispersion=disp,
                                              **kw)
    tol = (chip_smoke.BWD_TOL[dtype] if dtype == torch.float32
           else {"state": F64_TOL, "tables": F64_TOL})
    state_dev = chip_smoke.relative_deviations(got.state, want.state)
    assert max(state_dev) <= tol["state"], dict(zip(RayState._fields,
                                                    state_dev))
    if tables:
        block_dev = chip_smoke.relative_deviations(
            [got.psi_block, got.prof_block],
            [want.psi_block, want.prof_block])
        assert max(block_dev) <= tol["tables"], block_dev
        assert torch.equal(got.psi_cell, want.psi_cell)
        assert torch.equal(got.prof_cell, want.prof_cell)


def _d_grads(lib, eq, state, disp):
    """(hand-written gradient of ``disp``'s D, cold plasma's forward-mode
    gradient) at ``state``, each (N, 7)."""
    params = (ctypes.c_double * 13)(*efit_step.kernel_params(
        eq, chip_smoke.DT))
    psi, prof = eq.psi_coeffs, eq.profile_coeffs
    leaves = [leaf.detach().contiguous() for leaf in state]
    g_adj = np.zeros((N, 7))
    g_fwd = np.zeros((N, 7))
    lib.gft_d_grads(efit_step.kernel_dispersion_code(disp), N,
                    build.pointers(leaves), psi.data_ptr(), psi.shape[0],
                    psi.shape[1], prof.data_ptr(), prof.shape[0], params,
                    g_adj.ctypes.data, g_fwd.ctypes.data)
    return g_adj, g_fwd


def test_adjoint_gradient_matches_forward_mode(host_lib, inputs):
    """The hand-written gradient of D, over (w, x, y, z, kx, ky, kz), is
    ray_grad's forward-mode gradient to 1e-13 of each partial's largest
    magnitude (f64, the launch and a state a window later)."""
    eq, st, _ = inputs[torch.float64, cold_plasma]
    later = efit_step.frozen_window(eq, cold_plasma, st, method="rk2",
                                    dt=chip_smoke.DT,
                                    steps=chip_smoke.FREEZE_EVERY,
                                    compensated=False)
    for state in (st, later):
        g_adj, g_fwd = _d_grads(host_lib, eq, state, cold_plasma)
        assert np.isfinite(g_fwd).all() and np.abs(g_fwd).max() > 0
        rel = np.abs(g_adj - g_fwd).max(axis=0) / np.abs(g_fwd).max(axis=0)
        assert rel.max() <= GRAD_TOL, rel


@pytest.mark.parametrize("disp", DISPERSIONS, ids=lambda d: d.__name__)
def test_adjoint_gradient_matches_autograd(host_lib, inputs, disp):
    """Each dispersion's hand-written gradient of D is autograd's gradient
    of its plain version over the same frozen blocks, to 1e-13 of each
    partial's largest magnitude (f64, the launch)."""
    eq, st, _ = inputs[torch.float64, disp]
    g_adj, _ = _d_grads(host_lib, eq, st, disp)
    feq = eq.freeze_cells(torch.stack([st.x, st.y, st.z]))
    leaves = [a.clone().requires_grad_(True) for a in st[1:]]
    d = dispersion_residual(disp, feq)(st.t, *leaves).sum()
    want = torch.stack(torch.autograd.grad(d, leaves), dim=1).numpy()
    assert np.isfinite(want).all()
    rel = np.abs(g_adj - want).max(axis=0) / np.abs(want).max(axis=0)
    assert rel.max() <= GRAD_TOL, rel
