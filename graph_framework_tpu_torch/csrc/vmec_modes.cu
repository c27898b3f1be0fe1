// The VMEC Fourier mode sums written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel graph_framework_tpu/pallas/vmec_modes.py::_kernel
// (launched by _pallas_forward, wrapped by make_mode_sums).  Per ray, from
// its angles (u, v) and its per-mode radial coefficients rm, zm, rm', zm'
// and lm (five (B, M) row-major blocks), it computes the ten sums of the
// VMEC geometry in the order of kernels/vmec_modes.py SUM_NAMES:
//
//   R, Z, dR/ds, dR/du, dR/dv, dZ/ds, dZ/du, dZ/dv, dl/du, dl/dv
//
// with ca, sa = cos, sin(xm u - xn v) per mode.
//
//   * One warp per ray: lane j takes the modes j, j + 32, ..., so each of
//     the five rows is read in coalesced 128-byte lines; each lane keeps
//     its ten partial sums in registers, a shuffle tree adds them across
//     the warp, and lane 0 writes the ray's ten sums to the
//     structure-of-arrays output (10, B).
//   * Any B and M: a warp past the last ray returns whole, so there is no
//     (B, 16) padded output and no padding of B to a block multiple.
//
// What bounds it on this card: the five coefficient rows, 5 M values a ray
// read once from device memory (1720 B a ray in f32 at M = 86), against
// one sincos and some 20 multiplies and adds a mode - bytes, by a few
// times at f32 (kernels/vmec_modes.py and tools/count_ops.py count both
// sides).  (One thread per ray, walking its own 344-byte rows, ran 21x
// over that bound: a warp's loads touched 32 rows at once.)
//
// The mode angle is rounded as eager PyTorch rounds it (mul_rn / sub_rn,
// no FMA); the sums may contract into FMAs.

#include <cuda_runtime.h>

namespace gft {

namespace {

constexpr int kModeThreads = 128;
constexpr int kWarp = 32;
constexpr int kRaysPerBlock = kModeThreads / kWarp;
constexpr int kInvalidArgument = -1;
constexpr int kSums = 10;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ void gsincos(float a, float* s, float* c) {
  sincosf(a, s, c);
}
__device__ __forceinline__ void gsincos(double a, double* s, double* c) {
  sincos(a, s, c);
}

template <typename T>
struct ModeBlocks {
  const T* __restrict__ p[5];    // rm, zm, rm', zm', lm: (B, M) each
};

template <typename T>
__global__ void __launch_bounds__(kModeThreads)
vmec_modes_kernel(const T* __restrict__ u_in, const T* __restrict__ v_in,
                  ModeBlocks<T> blocks, const T* __restrict__ xm,
                  const T* __restrict__ xn, T* __restrict__ out, long long n,
                  int m) {
  // every lane of a warp has the same ray, so a warp returns whole and the
  // shuffles below always see all 32 lanes
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = static_cast<int>(threadIdx.x % kWarp);
  if (i >= n) return;
  const T u = u_in[i], v = v_in[i];
  const long long row = i * m;
  const T* __restrict__ rm = blocks.p[0] + row;
  const T* __restrict__ zm = blocks.p[1] + row;
  const T* __restrict__ rms = blocks.p[2] + row;
  const T* __restrict__ zms = blocks.p[3] + row;
  const T* __restrict__ lm = blocks.p[4] + row;
  T acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = T(0);
  for (int j = lane; j < m; j += kWarp) {
    const T a = __ldg(xm + j), b = __ldg(xn + j);
    T sa, ca;
    gsincos(sub_rn(mul_rn(u, a), mul_rn(v, b)), &sa, &ca);
    const T r = __ldg(rm + j), z = __ldg(zm + j), l = __ldg(lm + j);
    const T rm_sa = r * sa, zm_ca = z * ca, lm_ca = l * ca;
    acc[0] += r * ca;
    acc[1] += z * sa;
    acc[2] += __ldg(rms + j) * ca;
    acc[3] -= a * rm_sa;
    acc[4] += b * rm_sa;
    acc[5] += __ldg(zms + j) * sa;
    acc[6] += a * zm_ca;
    acc[7] -= b * zm_ca;
    acc[8] += a * lm_ca;
    acc[9] -= b * lm_ca;
  }
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
#pragma unroll
    for (int k = 0; k < kSums; ++k)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], offset);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) out[k * n + i] = acc[k];
  }
}

template <typename T>
int launch_vmec_modes(long long n, int m, const void* u, const void* v,
                      void* const* blocks, const void* xm, const void* xn,
                      void* out, cudaStream_t stream) {
  ModeBlocks<T> b;
  for (int k = 0; k < 5; ++k) b.p[k] = static_cast<const T*>(blocks[k]);
  const long long grid = (n + kRaysPerBlock - 1) / kRaysPerBlock;
  vmec_modes_kernel<T><<<static_cast<unsigned>(grid), kModeThreads, 0,
                         stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v), b,
      static_cast<const T*>(xm), static_cast<const T*>(xn),
      static_cast<T*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace gft

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes by kernels/build.py)
// ---------------------------------------------------------------------------

// The ten mode sums of n rays over m modes.
//   dtype: 0 = float, 1 = double;
//   u, v: (n,) angles, n >= 1;
//   blocks: five pointers to (n, m) row-major blocks: rm, zm, rm', zm', lm;
//   xm, xn: (m,) mode numbers;
//   out: (10, n).
// Launches on `stream` and returns at once: 0, a cudaError_t from the
// launch, or -1 for an argument the kernel does not take.
extern "C" int gft_vmec_modes(int dtype, long long n, int m, const void* u,
                              const void* v, void* const* blocks,
                              const void* xm, const void* xn, void* out,
                              void* stream) {
  if (n < 1 || m < 1 ||
      (n + gft::kRaysPerBlock - 1) / gft::kRaysPerBlock >= (1LL << 31))
    return gft::kInvalidArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gft::launch_vmec_modes<float>(n, m, u, v, blocks, xm, xn, out, st);
  if (dtype == 1)
    return gft::launch_vmec_modes<double>(n, m, u, v, blocks, xm, xn, out,
                                          st);
  return gft::kInvalidArgument;
}
