// One freeze window of the EFIT cold-plasma ray trace, written by hand for
// Hopper (sm_90a).
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
//     then runs all K substeps against those registers.
//   * The right-hand side is forward-mode automatic differentiation: D is
//     written once, as the template cold_plasma_D<S> (the algebra of
//     models/dispersion.py cold_plasma over models/efit.py FrozenCellEfit,
//     in efit_common.cuh), and evaluated on Dual<T, 7> numbers whose seven
//     tangents are seeded on (w, x, y, z, kx, ky, kz).  The TPU kernel
//     traced jax.grad of D instead; CUDA has no autodiff.  The backward
//     kernels (efit_window_bwd.cu) evaluate the same template on nested
//     duals.
//
// What bounds it on this card: per ray and window it moves 64 B of state
// in and out (128 B compensated) in f32 and gathers 128 B of coefficients,
// which stay in the 50 MB L2 (a 129 x 129 psi table is about 1 MB in f32).
// Against that stand K x stages x (one D evaluation carrying 7 tangents)
// of arithmetic - thousands of FLOPs per ray and substep - so the kernel
// is compute-bound.  wgmma and TMA have nothing to do here: there is no
// matrix product, and the loads are a few hundred bytes per thread.
//
// Numerics: no --use_fast_math (IEEE division and square root).  FMA
// contraction is left on, so f32 results differ from the plain PyTorch
// version in the last bits; TwoSum uses additions only and stays exact.
// The freeze gather rounds as eager PyTorch does (efit_common.cuh).
// The kernel reads its inputs once and writes its outputs once; the
// wrapper allocates separate outputs, but in == out (in place) is safe.

#include "efit_common.cuh"

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

template <typename T, int METHOD, bool COMP>
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

  const Frozen<T> f = freeze(s, psi_tab, prof_tab, p);

  for (int step = 0; step < steps; ++step) {
    if (COMP) {
      T inc[6];
      increment<T, METHOD>(s, f, p, inc);
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
      substep<T, METHOD>(s, f, p);
    }
  }

#pragma unroll
  for (int k = 0; k < 8; ++k) out.p[k][i] = s[k];
  if (COMP) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out.p[8 + k][i] = lo[k];
  }
}

template <typename T>
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
    efit_window_kernel<T, 2, false><<<grid, kThreads, 0, stream>>>(
        pin, pout, psi_t, prof_t, p, steps, n);
  else if (method == 2)
    efit_window_kernel<T, 2, true><<<grid, kThreads, 0, stream>>>(
        pin, pout, psi_t, prof_t, p, steps, n);
  else if (!compensated)
    efit_window_kernel<T, 4, false><<<grid, kThreads, 0, stream>>>(
        pin, pout, psi_t, prof_t, p, steps, n);
  else
    efit_window_kernel<T, 4, true><<<grid, kThreads, 0, stream>>>(
        pin, pout, psi_t, prof_t, p, steps, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gft

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes by kernels/build.py)
// ---------------------------------------------------------------------------

// Advance n rays through one freeze window of `steps` substeps.
//   dtype: 0 = float, 1 = double;  method: 2 = rk2, 4 = rk4;
//   compensated: 0/1 (8 or 16 state arrays in state_in/state_out, in the
//     order t w x y z kx ky kz, then the 8 low words);
//   psi: (nr*nz, 16) cell-major bicubic table; prof: (npsi, 16) profiles;
//   params: rmin dr zmin dz psimin dpsi ne_scale te_scale kpe kce kpi kci dt.
// Launches on `stream` and returns at once: 0, a cudaError_t from the
// launch, or -1 for an argument the kernel does not take.
extern "C" int gft_efit_window(int dtype, int method, int compensated,
                               int steps, long long n, void** state_in,
                               void** state_out, const void* psi, int nr,
                               int nz, const void* prof, int npsi,
                               const double* params, void* stream) {
  if (gft::bad_window_args(steps, n, method, nr, nz, npsi) ||
      (compensated != 0 && compensated != 1))
    return gft::kInvalidArgument;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gft::launch<float>(method, compensated, steps, n, state_in,
                              state_out, psi, nr, nz, prof, npsi, params, st);
  if (dtype == 1)
    return gft::launch<double>(method, compensated, steps, n, state_in,
                               state_out, psi, nr, nz, prof, npsi, params, st);
  return gft::kInvalidArgument;
}

extern "C" const char* gft_error_string(int code) {
  if (code == gft::kInvalidArgument)
    return "invalid argument to a gft_efit_window kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
