// The PIC grid deposit (density and E-field) written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel graph_framework_tpu/pallas/deposit.py::_kernel
// (launched by deposit_pallas).  For every grid point g it computes, over
// all particles p with validity mask m_p,
//
//     n[g] = sum_p exp((x_p - g)^2 / -w) m_p
//     e[g] = sum_p (2 te / (q w)) (x_p - g) m_p
//
// with the per-pair algebra of the TPU kernel.  The TPU kernel carried the
// sums across the sequential particle axis of its grid in a resident output
// tile; on Hopper blocks run in parallel and in no order, so the sum is a
// deterministic two-pass reduction with no atomics:
//
//   * Pass 1 (deposit_partial_kernel): a 2D launch over (grid tiles of
//     kDepTile points, one point per thread) x (particle chunks).  Each
//     block stages its chunk's x and mask through shared memory, kDepStage
//     particles at a time; every thread then reads the same particle at
//     once (a broadcast, no bank conflicts) and accumulates its point's n
//     and e in registers, in the working type.  It writes one partial per
//     (chunk, quantity, point) to a scratch array the wrapper allocates.
//   * Pass 2 (deposit_reduce_kernel): one thread per (quantity, point)
//     sums the partials over the chunks in chunk order.
//
// The same inputs thus give the same bits on every run.  Any particle count
// and any grid size: both edges are masked here, so there is no padding to
// block or tile multiples and no (8, TILE) output.
//
// What bounds it on this card: 9 floating point operations a pair, one of
// them an exp (through the special-function unit) and one a division, over
// P x G pairs; the bytes (x and mask once, the grid once, 2 G outputs, the
// partials) are small beside them, so it is compute-bound.  The design
// keeps each pair's work in registers and the particle stream in shared
// memory; cutting the pairs themselves (exp underflows beyond |dx| ~ 0.1,
// and e is linear in x) is later work.

#include <cuda_runtime.h>

namespace gft {

namespace {

constexpr int kDepTile = 128;     // grid points per block (one per thread)
constexpr int kDepStage = 1024;   // particles staged in shared memory at once
constexpr int kReduceThreads = 256;
constexpr int kMaxChunks = 65535; // gridDim.y
constexpr int kInvalidArgument = -1;

__device__ __forceinline__ float dexp(float a) { return expf(a); }
__device__ __forceinline__ double dexp(double a) { return exp(a); }

template <typename T>
__global__ void __launch_bounds__(kDepTile)
deposit_partial_kernel(const T* __restrict__ x, const T* __restrict__ mask,
                       const T* __restrict__ grid, T* __restrict__ partial,
                       long long n, int num_grid, long long chunk,
                       T neg_width, T coef) {
  __shared__ T sx[kDepStage];
  __shared__ T sm[kDepStage];
  const int gi = blockIdx.x * kDepTile + threadIdx.x;
  const T gp = gi < num_grid ? grid[gi] : T(0);
  const long long p0 = static_cast<long long>(blockIdx.y) * chunk;
  const long long p1 = p0 + chunk < n ? p0 + chunk : n;
  T n_acc = T(0), e_acc = T(0);
  for (long long s = p0; s < p1; s += kDepStage) {
    const int len = static_cast<int>(
        p1 - s < kDepStage ? p1 - s : static_cast<long long>(kDepStage));
    for (int k = threadIdx.x; k < len; k += kDepTile) {
      sx[k] = x[s + k];
      sm[k] = mask[s + k];
    }
    __syncthreads();
    for (int k = 0; k < len; ++k) {
      const T dx = sx[k] - gp;
      const T m = sm[k];
      n_acc += dexp(dx * dx / neg_width) * m;
      e_acc += coef * dx * m;
    }
    __syncthreads();
  }
  if (gi < num_grid) {
    T* row = partial + static_cast<long long>(blockIdx.y) * 2 * num_grid;
    row[gi] = n_acc;
    row[num_grid + gi] = e_acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
deposit_reduce_kernel(const T* __restrict__ partial, T* __restrict__ n_out,
                      T* __restrict__ e_out, int chunks, int num_grid) {
  const int idx = blockIdx.x * kReduceThreads + threadIdx.x;
  if (idx >= 2 * num_grid) return;
  T acc = T(0);
  for (int c = 0; c < chunks; ++c)
    acc += partial[static_cast<long long>(c) * 2 * num_grid + idx];
  if (idx < num_grid)
    n_out[idx] = acc;
  else
    e_out[idx - num_grid] = acc;
}

template <typename T>
int launch_deposit(long long n, int num_grid, long long chunk,
                   const void* x, const void* mask, const void* grid,
                   void* partial, void* n_out, void* e_out,
                   const double* params, cudaStream_t stream) {
  const int chunks = static_cast<int>((n + chunk - 1) / chunk);
  const dim3 blocks((num_grid + kDepTile - 1) / kDepTile, chunks);
  deposit_partial_kernel<T><<<blocks, kDepTile, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mask),
      static_cast<const T*>(grid), static_cast<T*>(partial), n, num_grid,
      chunk, T(params[0]), T(params[1]));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  deposit_reduce_kernel<T>
      <<<(2 * num_grid + kReduceThreads - 1) / kReduceThreads,
         kReduceThreads, 0, stream>>>(
          static_cast<const T*>(partial), static_cast<T*>(n_out),
          static_cast<T*>(e_out), chunks, num_grid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace gft

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes by kernels/build.py)
// ---------------------------------------------------------------------------

// Deposit n particles onto num_grid points.
//   dtype: 0 = float, 1 = double;
//   x, mask: (n,) particle positions and validity weights, n >= 1;
//   grid: (num_grid,) point positions;
//   chunk: particles per pass-1 block, at least 1, with
//     ceil(n / chunk) <= 65535;
//   partial: scratch of (ceil(n / chunk), 2, num_grid) values;
//   n_out, e_out: (num_grid,) density and field;
//   params: (-w) (2 te / (q w)).
// Launches both passes on `stream` and returns at once: 0, a cudaError_t
// from a launch, or -1 for an argument the kernels do not take.
extern "C" int gft_deposit(int dtype, long long n, int num_grid,
                           long long chunk, const void* x, const void* mask,
                           const void* grid, void* partial, void* n_out,
                           void* e_out, const double* params, void* stream) {
  if (n < 1 || num_grid < 1 || num_grid > (1 << 29) || chunk < 1 ||
      (n + chunk - 1) / chunk > gft::kMaxChunks)
    return gft::kInvalidArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gft::launch_deposit<float>(n, num_grid, chunk, x, mask, grid,
                                      partial, n_out, e_out, params, st);
  if (dtype == 1)
    return gft::launch_deposit<double>(n, num_grid, chunk, x, mask, grid,
                                       partial, n_out, e_out, params, st);
  return gft::kInvalidArgument;
}
