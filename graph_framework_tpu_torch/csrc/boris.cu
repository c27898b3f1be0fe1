// The relativistic Boris gyro push in the slab field, `steps` iterations
// per launch, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel graph_framework_tpu/pallas/boris.py::_kernel
// (launched by make_slab_push).  It computes what that kernel computes -
// `steps` u'/tau/sigma Boris pushes (xkorc.cpp:87-103) in the analytic slab
// B = z_hat (b1 + b_shear x) / b0, with gamma recovered each step from the
// Boris invariant gamma = sqrt(1 + u.u) - with the algebra rearranged for
// the card (below).
//
//   * One thread per particle, its six state values in registers for all
//     `steps` iterations: the state is read once and written once per
//     launch, whatever `steps` is.
//   * Structure-of-arrays input and output (x, y, z, ux, uy, uz), any
//     particle count: the ragged last block is masked, so there is no
//     multiple-of-(block_rows * 128) rule and no padding.
//
// What bounds it on this card: instruction issue, not bytes.  Its 48 B
// (f32) of state a particle go through once a launch, and 100 steps of
// arithmetic sit between the read and the write.  An IEEE division or
// square root compiles to a special-function (MUFU) instruction, fix-up
// FMAs and a branch to a slow path; the plain version's algebra takes 5
// and 3 a step (151 instructions a step).  This form needs 4 MUFU
// instructions a step and no slow path (f32), 37.5 instructions in all:
// on an H100 (700 W) a launch of 1e8 particles x 100 steps takes 13.6 ms,
// near the 11.2 ms that issuing them at 4 a clock an SM takes
// (tools/kernel_ab.py):
//
//   * bz = (b_shear / b0) x + b1 / b0, both quotients folded on the host
//     in double, as -0.5 dt and larmor dt are;
//   * gamma is used only as 1/gamma: h = (dt / 2) rsqrt(1 + u.u);
//   * the inner square root as sqrt(w) = w rsqrt(w), with
//     w = sigma^2 + 4 (tau^2 + u*^2) >= 1 for every state (see below),
//     so no guard for w = 0 is needed;
//   * one rsqrt of gamma'^2 = (sigma + sqrt(w)) / 2 serves both divisions
//     by gamma': t / gamma' and larmor dt / gamma';
//   * s = 1 / (1 + t'^2) from one reciprocal;
//   * uz is not recomputed: the rotation is about z, so
//     s (1 + t'^2) = 1 and u_next,z = u'_z = u_z exactly.
//
// Why w >= 1: with S = |u'|^2 and T = tau^2, sigma = 1 + S - T and
// w >= (1 + S - T)^2 + 4 T = (1 + S)^2 + T^2 + 2 T (1 - S).  For S <= 1
// that is at least (1 + S)^2 >= 1 (T >= 0); for S > 1 its least value
// over T, at T = S - 1, is (1 + S)^2 - (S - 1)^2 = 4 S > 4.  Likewise
// gamma'^2 >= 1 and 1 + u.u >= 1, so every MUFU input is at least about
// 1 and the flush-to-zero forms (rsqrt.approx.ftz, rcp.approx.ftz) lose
// nothing.
//
// Accuracy without Newton steps (f32): rsqrt.approx.f32 is within 2^-22.9
// relative error and rcp.approx.f32 within 1 ulp (PTX ISA), against the
// 0.5 ulp of the IEEE forms.  An error d in 1/gamma' turns each step's
// rotation angle (about 0.17 rad in phase 8's ensemble) by a relative d,
// so over 100 steps the gyro phase moves at most 100 x 0.17 x 1.4e-7 =
// 2.4e-6 rad, and the positions by the same relative amount: 200x below
// chip_smoke.K5_TOL's 5e-4.  No reciprocal is refined.
//
// f64 keeps IEEE sqrt and division (no approximate f64 intrinsics): the
// folded constants and the shared reciprocals leave it 3 square roots and
// 3 divisions a step, against 3 and 5.
//
// Operations (tools/count_ops.py, kernels/boris.py SLAB_PUSH_OPS): a
// square root, rsqrt or reciprocal counts one, the FMA two.

#include <cuda_runtime.h>

namespace gft {

namespace {

constexpr int kBorisThreads = 256;
constexpr int kInvalidArgument = -1;

#ifdef __CUDACC__
// One MUFU instruction each; every input here is at least about 1.
__device__ __forceinline__ float rsqrt_approx(float a) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ float rcp_approx(float a) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
#endif

// 1/sqrt(a), sqrt(a) and 1/a: approximate in f32, IEEE in f64.
__device__ __forceinline__ float brsqrt(float a) { return rsqrt_approx(a); }
__device__ __forceinline__ double brsqrt(double a) { return 1.0 / sqrt(a); }
__device__ __forceinline__ float bsqrt(float a) { return a * rsqrt_approx(a); }
__device__ __forceinline__ double bsqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float brcp(float a) { return rcp_approx(a); }
__device__ __forceinline__ double brcp(double a) { return 1.0 / a; }

template <typename T>
struct SlabParams {
  T half_dt;       // dt / 2
  T bs, b1s;       // b_shear / b0, b1 / b0
  T neg_half_dt;   // -0.5 * dt
  T larmor_dt;     // larmor * dt
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
  T ux = p.in[3][i], uy = p.in[4][i];
  const T uz = p.in[5][i];

  for (int k = 0; k < steps; ++k) {
    const T bz = c.bs * x + c.b1s;
    const T h = c.half_dt * brsqrt(T(1) + ux * ux + uy * uy + uz * uz);

    // u' = u - h (u x b), b = (0, 0, bz); u'_z = u_z
    const T upx = ux - h * (uy * bz);
    const T upy = uy + h * (ux * bz);

    const T tz = c.neg_half_dt * bz;
    const T tau_sq = tz * tz;
    const T speed_sq = upx * upx + upy * upy + uz * uz;
    const T sigma = T(1) + speed_sq - tau_sq;
    const T ustar = uz * tz;
    const T w = sigma * sigma + T(4) * (tau_sq + ustar * ustar);
    const T rg2 = brsqrt(T(0.5) * (sigma + bsqrt(w)));   // 1 / gamma'
    const T tz2 = tz * rg2;
    const T s = brcp(T(1) + tz2 * tz2);

    // u_next = s (u' + (u'.t) t + u' x t); its z part is u'_z
    ux = s * (upx + upy * tz2);
    uy = s * (upy - upx * tz2);

    const T inv_g = c.larmor_dt * rg2;
    x = x + inv_g * ux;
    y = y + inv_g * uy;
    z = z + inv_g * uz;
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
  // the quotients folded in double, as the -0.5 dt and larmor dt
  const SlabParams<T> c{T(0.5 * params[0]), T(params[3] / params[1]),
                        T(params[2] / params[1]), T(params[4]),
                        T(params[5])};
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
