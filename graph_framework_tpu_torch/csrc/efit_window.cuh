// One freeze window of the EFIT ray trace, written by hand for Hopper
// (sm_90a): the kernel template of K1 (the C interface and the cold-plasma
// instantiations are in efit_window.cu, those of every other dispersion in
// efit_window_<tail>.cu - omode, xmode, expansion, bohm, light, ioncyc,
// acoustic, simple, gwell, stiff - so that eleven nvcc processes compile
// them side by side).
//
// Replaces the TPU kernel graph_framework_tpu/pallas/efit_step.py::
// _window_kernel (launched by make_frozen_window_step._fwd_impl).  It
// computes what that kernel computes - K rk2/rk4 substeps of the ray
// equations dx/dt = -D_k/D_w, dk/dt = D_x/D_w against each ray's frozen
// bicubic psi block and profile block, plain or with compensated (TwoSum)
// accumulation - but not the way the TPU computes it:
//
//   * One thread per ray, its state in registers.  The state arrives as
//     structure-of-arrays: 8 arrays (t, w, x, y, z, kx, ky, kz), 16 with
//     the compensated low words.  A ragged last block is masked
//     (`if (i >= n) return;`), so the ray count needs no padding.
//   * The freeze gather runs inside the kernel: at the window base each
//     thread takes r = sqrt(x^2 + y^2), the clamped cell indices i, j
//     (ops/tables.py semantics), the 16 psi coefficients of cell (i, j)
//     from the cell-major (nr*nz, 16) table, psi at the base, the psi-cell
//     index and the 16 profile coefficients from the (npsi, 16) table.  It
//     then runs all K substeps against those registers.  A dispersion that
//     reads no table (simple, gaussian_well, stiff) skips the gather: its
//     rays may leave the grid, as the plain version's may.
//   * The right-hand side is D's gradient by a reverse sweep written by
//     hand (efit_adjoint<Disp>, efit_adjoint.cuh: the algebra of the
//     dispersion - each of the eleven real ones of models/dispersion.py -
//     over models/efit.py FrozenCellEfit, in the plain version's operation
//     order, then its sweep back from dD = 1), the same sweep the backward
//     kernels K2 and K3 run (efit_window_bwd.cuh), through the same
//     stepping templates.  The TPU kernel traced jax.grad of D instead;
//     CUDA has no autodiff, so each dispersion the kernel serves has a tail
//     of its own.  The stages advance t as the plain version's do, for the
//     one D that reads it (stiff).
//
// What bounds it on this card: arithmetic.  Per ray and window it moves
// 64 B of state in and out (128 B compensated) in f32 and gathers 128 B of
// coefficients, which stay in the 50 MB L2 (a 129 x 129 psi table is about
// 1 MB in f32).  Against that stand 8812 operations a ray and window for
// cold plasma (rk2, compensated, K = 10; tools/count_ops.py, which also
// counts every other tail: 1050 for stiff to 8332 for the expansion), all
// of which the function needs.  The design before this one evaluated
// cold_plasma_D on Dual<T, 7> numbers seeded on (w, x, y, z, kx, ky, kz):
// 44 892 operations a ray and window, five times as many, and the f64
// variants spilled.  The sweep
// divides by reciprocals (1/r, 1/w, 1/|B|, 1/den per species; 1/dr, 1/dz,
// 1/dpsi once), where the plain version divides.  wgmma and TMA have
// nothing to do here: there is no matrix product, and the loads are a few
// hundred bytes per thread.
//
// Numerics: no --use_fast_math (IEEE division and square root).  FMA
// contraction is left on and the sweep multiplies by reciprocals, so
// results differ from the plain PyTorch version in the last bits (chip_smoke.
// TOL); TwoSum uses additions only and stays exact.
// The freeze gather rounds as eager PyTorch does (efit_common.cuh).
// The kernel reads its inputs once and writes its outputs once; the
// wrapper allocates separate outputs, but in == out (in place) is safe.

#pragma once

#include "efit_adjoint.cuh"

namespace gft {

// ops/compensated.py _two_sum: a + b = s + e exactly
template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  s = a + b;
  const T bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <typename T, int METHOD, bool COMP, typename Disp>
__global__ void __launch_bounds__(kThreads)
efit_window_kernel(StatePtrs<T> in, StatePtrs<T> out,
                   const T* __restrict__ psi_tab,
                   const T* __restrict__ prof_tab, Params<T> p, int steps,
                   long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  T s[8], lo[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = in.p[k][i];
  if (COMP) {
#pragma unroll
    for (int k = 0; k < 8; ++k) lo[k] = in.p[8 + k][i];
  }

  const Frozen<T> f = freeze_for<Disp>(s, psi_tab, prof_tab, p);

  for (int step = 0; step < steps; ++step) {
    if (COMP) {
      T inc[6];
      increment<Disp, T, METHOD>(s, f, p, inc);
      // ops/compensated.py compensated_stepper: t's increment is dt,
      // w's is 0, then TwoSum(hi, delta + lo) on every leaf
      T delta[8];
      delta[ST_T] = p.dt;
      delta[ST_W] = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) delta[ST_X + j] = inc[j];
#pragma unroll
      for (int k = 0; k < 8; ++k) two_sum(s[k], delta[k] + lo[k], s[k], lo[k]);
    } else {
      substep<Disp, T, METHOD>(s, f, p);
    }
  }

#pragma unroll
  for (int k = 0; k < 8; ++k) out.p[k][i] = s[k];
  if (COMP) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out.p[8 + k][i] = lo[k];
  }
}

template <typename Disp, typename T>
int launch(int method, int compensated, int steps, long long n,
           void** state_in, void** state_out, const void* psi, int nr,
           int nz, const void* prof, int npsi, const double* params,
           cudaStream_t stream) {
  StatePtrs<T> pin, pout;
  const int ns = compensated ? 16 : 8;
  for (int k = 0; k < 16; ++k) {
    pin.p[k] = k < ns ? static_cast<T*>(state_in[k]) : nullptr;
    pout.p[k] = k < ns ? static_cast<T*>(state_out[k]) : nullptr;
  }
  const Params<T> p = make_params<T>(params, nr, nz, npsi);
  const T* psi_t = static_cast<const T*>(psi);
  const T* prof_t = static_cast<const T*>(prof);
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  if (method == 2 && !compensated)
    efit_window_kernel<T, 2, false, Disp><<<grid, kThreads, 0, stream>>>(
        pin, pout, psi_t, prof_t, p, steps, n);
  else if (method == 2)
    efit_window_kernel<T, 2, true, Disp><<<grid, kThreads, 0, stream>>>(
        pin, pout, psi_t, prof_t, p, steps, n);
  else if (!compensated)
    efit_window_kernel<T, 4, false, Disp><<<grid, kThreads, 0, stream>>>(
        pin, pout, psi_t, prof_t, p, steps, n);
  else
    efit_window_kernel<T, 4, true, Disp><<<grid, kThreads, 0, stream>>>(
        pin, pout, psi_t, prof_t, p, steps, n);
  return static_cast<int>(cudaGetLastError());
}

// The argument list of every launch<Disp, T> (gft_efit_window's).
#define GFT_WINDOW_LAUNCH_ARGS                                              \
  int method, int compensated, int steps, long long n, void **state_in,    \
      void **state_out, const void *psi, int nr, int nz, const void *prof, \
      int npsi, const double *params, cudaStream_t stream

// each dispersion's instantiations are compiled in a source of their own
#define GFT_EXTERN_WINDOW(code, D)                              \
  extern template int launch<D, float>(GFT_WINDOW_LAUNCH_ARGS); \
  extern template int launch<D, double>(GFT_WINDOW_LAUNCH_ARGS);
GFT_DISPERSIONS(GFT_EXTERN_WINDOW)
#undef GFT_EXTERN_WINDOW

}  // namespace gft

