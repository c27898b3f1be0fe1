// The relativistic Boris gyro push in the slab field, `steps` iterations
// per launch, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel graph_framework_tpu/pallas/boris.py::_kernel
// (launched by make_slab_push).  It computes what that kernel computes -
// `steps` u'/tau/sigma Boris pushes (xkorc.cpp:87-103) in the analytic slab
// B = z_hat (b1 + b_shear x) / b0, with gamma recovered each step from the
// Boris invariant gamma = sqrt(1 + u.u) - with the same algebra in the same
// order, divisions included.
//
//   * One thread per particle, its six state values in registers for all
//     `steps` iterations: the state is read once and written once per
//     launch, whatever `steps` is.
//   * Structure-of-arrays input and output (x, y, z, ux, uy, uz), any
//     particle count: the ragged last block is masked, so there is no
//     multiple-of-(block_rows * 128) rule and no padding.
//
// What bounds it on this card: per particle and step it does 58 floating
// point operations (3 square roots and 5 divisions among them; counted in
// kernels/boris.py SLAB_PUSH_OPS) and moves no bytes, so at 100 steps a
// launch it is compute-bound by some 6x over its 48 B (f32) of state
// traffic.  The design keeps that traffic at one read and one write per
// launch; the IEEE division and square root (no --use_fast_math) cost
// several instructions each and are what a faster version would attack.
//
// Numerics: FMA contraction is left on, as in the window kernel, so f32
// results differ from the plain PyTorch version in the last bits.

#include <cuda_runtime.h>

namespace gft {

namespace {

constexpr int kBorisThreads = 256;
constexpr int kInvalidArgument = -1;

__device__ __forceinline__ float bsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double bsqrt(double a) { return sqrt(a); }

template <typename T>
struct SlabParams {
  T dt, b0, b1, b_shear;
  T neg_half_dt;   // -0.5 * dt, folded in double as the JAX package folds it
  T larmor_dt;     // larmor * dt, likewise
};

template <typename T>
struct Particles {
  const T* __restrict__ in[6];
  T* __restrict__ out[6];
};

template <typename T>
__global__ void __launch_bounds__(kBorisThreads)
slab_push_kernel(Particles<T> p, SlabParams<T> c, int steps, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T x = p.in[0][i], y = p.in[1][i], z = p.in[2][i];
  T ux = p.in[3][i], uy = p.in[4][i], uz = p.in[5][i];

  for (int k = 0; k < steps; ++k) {
    const T bz = (c.b1 + c.b_shear * x) / c.b0;
    const T g = bsqrt(T(1) + ux * ux + uy * uy + uz * uz);
    const T h = c.dt / (T(2) * g);

    // u' = u - h (u x b), b = (0, 0, bz)
    const T upx = ux - h * (uy * bz);
    const T upy = uy + h * (ux * bz);
    const T upz = uz;

    const T tz = c.neg_half_dt * bz;
    const T tau_sq = tz * tz;
    const T speed_sq = upx * upx + upy * upy + upz * upz;
    const T sigma = T(1) + speed_sq - tau_sq;
    const T ustar = upz * tz;
    const T g2 = bsqrt(T(0.5) * (sigma + bsqrt(sigma * sigma +
                                              T(4) * (tau_sq + ustar * ustar))));
    const T tz2 = tz / g2;
    const T s = T(1) / (T(1) + tz2 * tz2);

    // u_next = s (u' + (u'.t) t + u' x t)
    const T udt = upz * tz2;
    const T unx = s * (upx + upy * tz2);
    const T uny = s * (upy - upx * tz2);
    const T unz = s * (upz + udt * tz2);

    const T inv_g = c.larmor_dt / g2;
    x = x + inv_g * unx;
    y = y + inv_g * uny;
    z = z + inv_g * unz;
    ux = unx;
    uy = uny;
    uz = unz;
  }
  p.out[0][i] = x;
  p.out[1][i] = y;
  p.out[2][i] = z;
  p.out[3][i] = ux;
  p.out[4][i] = uy;
  p.out[5][i] = uz;
}

template <typename T>
int launch_slab_push(long long n, int steps, void** in, void** out,
                     const double* params, cudaStream_t stream) {
  Particles<T> p;
  for (int k = 0; k < 6; ++k) {
    p.in[k] = static_cast<const T*>(in[k]);
    p.out[k] = static_cast<T*>(out[k]);
  }
  const SlabParams<T> c{T(params[0]), T(params[1]), T(params[2]),
                        T(params[3]), T(params[4]), T(params[5])};
  const dim3 grid(
      static_cast<unsigned>((n + kBorisThreads - 1) / kBorisThreads));
  slab_push_kernel<T><<<grid, kBorisThreads, 0, stream>>>(p, c, steps, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace gft

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes by kernels/build.py)
// ---------------------------------------------------------------------------

// Advance n particles by `steps` Boris pushes in the slab field.
//   dtype: 0 = float, 1 = double;
//   in, out: 6 arrays each, x y z ux uy uz;
//   params: dt b0 b1 b_shear (-0.5 dt) (larmor dt).
// Launches on `stream` and returns at once: 0, a cudaError_t from the
// launch, or -1 for an argument the kernel does not take.
extern "C" int gft_slab_push(int dtype, long long n, int steps, void** in,
                             void** out, const double* params,
                             void* stream) {
  if (n < 0 || steps < 0 ||
      (n + gft::kBorisThreads - 1) / gft::kBorisThreads > 0x7fffffffLL)
    return gft::kInvalidArgument;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gft::launch_slab_push<float>(n, steps, in, out, params, st);
  if (dtype == 1)
    return gft::launch_slab_push<double>(n, steps, in, out, params, st);
  return gft::kInvalidArgument;
}
