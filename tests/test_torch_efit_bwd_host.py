"""The backward window kernels K2 and K3, their own CUDA source run on the
host, against the plain versions.

``csrc/efit_window_bwd*.cu`` (and the headers they include) are compiled
with ``g++`` over the stand-in runtime of ``tools/count_ops.py``, whose
launch walks every (block, thread) of the grid: the C function
``gft_efit_window_bwd`` then runs on CPU tensors exactly as the card runs
it, FMA contraction aside (``-ffp-contract=off``).  Each of the eight
variants (rk2/rk4 x f32/f64 x K2/K3) of each of the eleven dispersions the
kernels implement runs over 64 rays (cold plasma and the two modes from
chip_smoke's launch with kx solved for each, the other eight from their
own launches and steps, ``chip_smoke.TAIL_LAUNCH``) for one substep, the
main path's window (K = 10) and a window longer than the kernel's stored
slots (which recomputes from a checkpoint), and is held to
``efit_step.frozen_window_vjp`` / ``frozen_window_vjp_blocks`` (autograd
of the plain window): per state leaf and per block tensor, relative to its
largest magnitude, f64 within 1e-12 and f32 within ``chip_smoke.BWD_TOL``;
the block cells equal.  A dispersion that reads no table (simple,
gaussian_well, stiff) has no K3: the C interface refuses the table outputs
(-1), the wrapper raises, and the plain version's block cotangents are
zero.  In f64 each tail beside cold plasma and the two modes also lies
SEPARATION times its limit from a backward that passes the cotangent
through unchanged (in f32 the window's Jacobian differs from the identity
by less than the rounding for some: simple's by 2e-7 a substep), and
stiff's from the backward of the window whose stages keep t
(``chip_smoke.frozen_stage_t``).  A hand-written adjoint wrong by one
term, or a t cotangent that misses D's t partial, fails here, before any
card run.

Two more cases hold the hand-written gradients of D (``csrc/
efit_adjoint.cuh``) in f64: cold plasma's to ``ray_grad``'s forward-mode
gradient, and each dispersion's, its partial over t included, to autograd
of its plain version over the same frozen blocks.  Skipped where ``g++``
is missing.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch.kernels import build, efit_step
from graph_framework_tpu_torch.models.dispersion import (
    cold_plasma, extra_ordinary_wave, ordinary_wave, stiff)
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

DISPERSIONS = ([cold_plasma, ordinary_wave, extra_ordinary_wave]
               + list(chip_smoke.TAILS.values()))
TAG = {disp: tag for tag, disp in chip_smoke.TAILS.items()}

_SOURCES = [f"efit_window_bwd{'_' * bool(t.tag)}{t.tag}.cu"
            for t in efit_step.KERNEL_TAILS]

# D's gradients at n states, each (n, 8) row-major: the hand-written
# adjoint of the dispersion `disp` (the one the kernels run) over (w, x, y,
# z, kx, ky, kz) and t (zero where D does not read t) and, for cold
# plasma, forward mode (ray_grad, t's column zero).
_GRAD_HARNESS = r"""
#include "efit_adjoint.cuh"
namespace gft {
template <typename Disp>
void d_grad(const double s[8], const Frozen<double>& f,
            const Params<double>& p, double g[8]) {
  const double st[7] = {s[ST_W], s[ST_X], s[ST_Y], s[ST_Z],
                        s[ST_KX], s[ST_KY], s[ST_KZ]};
  double b[7], uvp[3];
  g[7] = 0.0;
  efit_adjoint<Disp>(st, s[ST_T], f, p, g, g + 7, b, uvp);
}
}  // namespace gft

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
    double* g = g_adj + 8 * i;
#define GFT_CASE(code, D) \
  case code:              \
    d_grad<D>(s, f, p, g); \
    break;
    switch (disp) { GFT_DISPERSIONS(GFT_CASE) }
#undef GFT_CASE
    ray_grad(s, f, p, g_fwd + 8 * i);
    g_fwd[8 * i + 7] = 0.0;
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The host build of the backward sources (one a dispersion) and the
    gradient harness, with ``gft_efit_window_bwd`` typed as
    kernels/build.py types it."""
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
    cotangent, dt)}: 64 rays of chip_smoke's launch with kx solved by
    init_k for cold plasma and the two modes, and of each other tail's own
    launch; seeded normal cotangents."""
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
            st = RayState(*[leaf.detach().contiguous() for leaf in st])
            out[dtype, disp] = (eq, st, chip_smoke.random_cotangent(
                st, chip_smoke.SEED + 2), dt)
    return out


def _host_vjp(lib, eq, state, ct, method, steps, tables, disp=cold_plasma,
              dt=chip_smoke.DT, rc_want=0):
    """``gft_efit_window_bwd`` on CPU tensors: a WindowVjp, as
    efit_step._launch_bwd returns it on the card (None where the call
    returns ``rc_want``, not 0)."""
    x = state.x
    outs = [torch.empty_like(a) for a in state]
    blocks = torch.full((2, 16, N), float("nan"), dtype=x.dtype)
    cells = torch.full((2, N), -1, dtype=torch.int64)
    params = efit_step.kernel_param_array(eq, dt)
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
    assert rc == rc_want
    if rc:
        return None
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
    eq, st, ct, dt = inputs[dtype, disp]
    tables = kernel == "K3"
    kw = dict(method=method, dt=dt, steps=steps)
    want = efit_step.frozen_window_vjp_blocks(eq, st, ct, dispersion=disp,
                                              **kw)
    if tables and not chip_smoke.reads_map(disp):
        # no K3: its tables take no gradient
        _host_vjp(host_lib, eq, st, ct, method, steps, True, disp, dt,
                  rc_want=-1)
        with pytest.raises(ValueError, match="reads no table"):
            efit_step.efit_window_vjp(eq, st, ct, tables=True,
                                      dispersion=disp, **kw)
        assert not (want.psi_block.any() or want.prof_block.any())
        return
    got = _host_vjp(host_lib, eq, st, ct, method, steps, tables, disp, dt)
    tol = (chip_smoke.BWD_TOL[dtype] if dtype == torch.float32
           else {"state": F64_TOL, "tables": F64_TOL})
    state_dev = chip_smoke.relative_deviations(got.state, want.state)
    assert max(state_dev) <= tol["state"], dict(zip(RayState._fields,
                                                    state_dev))
    if disp in TAG and dtype == torch.float64:
        passed = max(chip_smoke.relative_deviations(ct, want.state))
        assert passed > chip_smoke.SEPARATION * tol["state"], passed
    if disp is stiff and dtype == torch.float64:
        with chip_smoke.frozen_stage_t():
            held = efit_step.frozen_window_vjp(eq, st, ct, dispersion=disp,
                                               **kw)
        wrong = max(chip_smoke.relative_deviations(held, want.state))
        assert wrong > chip_smoke.SEPARATION * tol["state"], wrong
    if tables:
        block_dev = chip_smoke.relative_deviations(
            [got.psi_block, got.prof_block],
            [want.psi_block, want.prof_block])
        assert max(block_dev) <= tol["tables"], block_dev
        assert torch.equal(got.psi_cell, want.psi_cell)
        assert torch.equal(got.prof_cell, want.prof_cell)


def _d_grads(lib, eq, state, disp):
    """(hand-written gradient of ``disp``'s D, cold plasma's forward-mode
    gradient) at ``state``, each (N, 8): (w, x, y, z, kx, ky, kz, t)."""
    params = efit_step.kernel_param_array(eq, chip_smoke.DT)
    psi, prof = eq.psi_coeffs, eq.profile_coeffs
    leaves = [leaf.detach().contiguous() for leaf in state]
    g_adj = np.zeros((N, 8))
    g_fwd = np.zeros((N, 8))
    lib.gft_d_grads(efit_step.kernel_dispersion_code(disp), N,
                    build.pointers(leaves), psi.data_ptr(), psi.shape[0],
                    psi.shape[1], prof.data_ptr(), prof.shape[0], params,
                    g_adj.ctypes.data, g_fwd.ctypes.data)
    return g_adj, g_fwd


def test_adjoint_gradient_matches_forward_mode(host_lib, inputs):
    """The hand-written gradient of D, over (w, x, y, z, kx, ky, kz), is
    ray_grad's forward-mode gradient to 1e-13 of each partial's largest
    magnitude (f64, the launch and a state a window later)."""
    eq, st, _, _ = inputs[torch.float64, cold_plasma]
    later = efit_step.frozen_window(eq, cold_plasma, st, method="rk2",
                                    dt=chip_smoke.DT,
                                    steps=chip_smoke.FREEZE_EVERY,
                                    compensated=False)
    for state in (st, later):
        g_adj, g_fwd = _d_grads(host_lib, eq, state, cold_plasma)
        g_adj, g_fwd = g_adj[:, :7], g_fwd[:, :7]
        assert np.isfinite(g_fwd).all() and np.abs(g_fwd).max() > 0
        rel = np.abs(g_adj - g_fwd).max(axis=0) / np.abs(g_fwd).max(axis=0)
        assert rel.max() <= GRAD_TOL, rel


@pytest.mark.parametrize("disp", DISPERSIONS, ids=lambda d: d.__name__)
def test_adjoint_gradient_matches_autograd(host_lib, inputs, disp):
    """Each dispersion's hand-written gradient of D, over (w, x, y, z, kx,
    ky, kz) and t, is autograd's gradient of its plain version over the
    same frozen blocks, to 1e-13 of each partial's largest magnitude (f64,
    the launch; a partial that is zero everywhere must be zero)."""
    eq, st, _, _ = inputs[torch.float64, disp]
    g_adj, _ = _d_grads(host_lib, eq, st, disp)
    feq = eq.freeze_cells(torch.stack([st.x, st.y, st.z]))
    leaves = [a.clone().requires_grad_(True) for a in st]
    d = dispersion_residual(disp, feq)(*leaves).sum()
    grads = torch.autograd.grad(d, leaves, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(leaves, grads)]
    want = torch.stack(grads[1:] + grads[:1], dim=1).numpy()
    assert np.isfinite(want).all()
    scale = np.abs(want).max(axis=0)
    rel = np.abs(g_adj - want).max(axis=0) / np.where(scale > 0, scale, 1.0)
    assert rel.max() <= GRAD_TOL, rel
