// The fused VMEC geometry jet written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel graph_framework_tpu/pallas/vmec_geom.py::
// _jet_kernel (the sums of _jet_sums, launched by make_fused_geometry).
// Per ray (s, u, v) it computes what that kernel computes:
//
//   * the radial cell on the full grid and on the half grid: normalize,
//     clamp as a float to [0, ns - 1], truncate (piecewise.hpp:26-60), with
//     the cell-local coordinate keeping the unclamped offset;
//   * every mode's cubic by Horner - value, d/ds and d2/ds2 of rmnc and
//     zmns on the full grid, value and d/ds of lmns on the half grid;
//   * cos and sin of the mode angle xm u - xn v;
//   * the 27 sums of the second-order jet, in the order of
//     kernels/vmec_geom.py JET_NAMES: 10 first-order and 17 second-order.
//
//   * One thread per ray loops over the G modes (any G; kernels/
//     vmec_geom.py passes the equilibrium's per-mode tables, 86 modes for
//     the reference's shape, not the TPU's 90-slot mode grid with its four
//     empty slots) with its 27 sums in registers.  The tables are the
//     whole cell-major tables, rz (ns_f, 4, 2G) = [rmnc | zmns] per Horner
//     coefficient and lm (ns_h, 4, G), read through the read-only cache:
//     neighbouring rays lie in the same or the next cell, so a warp's
//     loads are mostly broadcasts of one cached line.
//   * Structure-of-arrays output (27, n), so every store is coalesced; any
//     ray count, the ragged last block masked.
//
// Not carried over from the TPU kernel: the one-hot matrix-unit fetch and
// the bf16 word split of the tables, the 128-cell radial cut (the clamps
// here are the reference's, over the whole table), the 128-mode padding,
// the (n, 48) duplicated output and the Cody-Waite reduction before the
// trig (sincos reduces its argument's range exactly; never build with
// --use_fast_math).
//
// What bounds it on this card: per ray and mode a sincos, 12 coefficient
// loads and some 100 multiplies and adds (kernels/vmec_geom.py and
// tools/count_ops.py count them); the bytes - s, u, v in and 27 sums out a
// ray, the tables once - are few beside that, so it is compute-bound.  The
// design keeps every intermediate in registers.  A few operations a mode
// depend on the tables alone (the products of the mode numbers, the
// doubled coefficients): the bound counts them once, the kernel redoes
// them per ray, where a multiply costs less than the load of a table that
// held them.  The trig of the unique mode numbers (2 (n_xm + n_xn)
// transcendentals instead of 2 G) is what a faster version would do first.
//
// The mode angle is rounded as eager PyTorch rounds it (mul_rn / add_rn,
// no FMA), so the kernel and its plain version take the trig of the same
// angle; the Horner polynomials and the sums may contract into FMAs.

#include <cuda_runtime.h>

namespace gft {

namespace {

constexpr int kGeomThreads = 128;
constexpr int kInvalidArgument = -1;
constexpr int kJet = 27;

__device__ __forceinline__ float gmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double gmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float gmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double gmin(double a, double b) { return fmin(a, b); }
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

// Clamped cell index and cell-local coordinate of s on a grid of ns cells
// starting at smin (kernels/vmec_geom.py reference_jet: table_index_1d).
template <typename T>
__device__ __forceinline__ int radial_cell(T s, T smin, T ds, int ns, T* local) {
  const T un = (s - smin) / ds;
  const int idx = static_cast<int>(gmin(gmax(un, T(0)), T(ns - 1)));
  *local = un - T(idx);
  return idx;
}

template <typename T>
__global__ void __launch_bounds__(kGeomThreads)
vmec_geom_kernel(const T* __restrict__ s_in, const T* __restrict__ u_in,
                 const T* __restrict__ v_in, const T* __restrict__ rz,
                 const T* __restrict__ lm, const T* __restrict__ xm,
                 const T* __restrict__ xn, T* __restrict__ out, long long n,
                 int ns_f, int ns_h, int g, T sminf, T sminh, T ds) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T s = s_in[i], u = u_in[i], v = v_in[i];
  T tf, th;
  const int kf = radial_cell(s, sminf, ds, ns_f, &tf);
  const int kh = radial_cell(s, sminh, ds, ns_h, &th);
  const T* __restrict__ blk = rz + static_cast<long long>(kf) * 8 * g;
  const T* __restrict__ lblk = lm + static_cast<long long>(kh) * 4 * g;

  // the radial derivatives' 1/ds and 1/ds^2 are applied to the sums once
  T acc[kJet];
#pragma unroll
  for (int k = 0; k < kJet; ++k) acc[k] = T(0);
  const T tf3 = T(3) * tf, tf6 = T(6) * tf, th3 = T(3) * th;
  for (int m = 0; m < g; ++m) {
    const T r0 = __ldg(blk + m), r1 = __ldg(blk + 2 * g + m);
    const T r2 = __ldg(blk + 4 * g + m), r3 = __ldg(blk + 6 * g + m);
    const T z0 = __ldg(blk + g + m), z1 = __ldg(blk + 3 * g + m);
    const T z2 = __ldg(blk + 5 * g + m), z3 = __ldg(blk + 7 * g + m);
    const T l0 = __ldg(lblk + m), l1 = __ldg(lblk + g + m);
    const T l2 = __ldg(lblk + 2 * g + m), l3 = __ldg(lblk + 3 * g + m);
    const T rm = r0 + tf * (r1 + tf * (r2 + tf * r3));
    const T rms = r1 + tf * (T(2) * r2 + tf3 * r3);
    const T rmss = T(2) * r2 + tf6 * r3;
    const T zm = z0 + tf * (z1 + tf * (z2 + tf * z3));
    const T zms = z1 + tf * (T(2) * z2 + tf3 * z3);
    const T zmss = T(2) * z2 + tf6 * z3;
    const T lv = l0 + th * (l1 + th * (l2 + th * l3));
    const T lms = l1 + th * (T(2) * l2 + th3 * l3);

    const T a = __ldg(xm + m), b = __ldg(xn + m);
    T sa, ca;
    gsincos(sub_rn(mul_rn(u, a), mul_rn(v, b)), &sa, &ca);
    const T rm_sa = rm * sa, rm_ca = rm * ca;
    const T zm_sa = zm * sa, zm_ca = zm * ca;
    const T lm_sa = lv * sa, lm_ca = lv * ca;
    const T rms_sa = rms * sa, zms_ca = zms * ca, lms_ca = lms * ca;
    const T aa = a * a, ab = a * b, bb = b * b;
    acc[0] += rm_ca;               // r
    acc[1] += zm_sa;               // z
    acc[2] += rms * ca;            // drs (/ ds)
    acc[3] -= a * rm_sa;           // dru
    acc[4] += b * rm_sa;           // drv
    acc[5] += zms * sa;            // dzs (/ ds)
    acc[6] += a * zm_ca;           // dzu
    acc[7] -= b * zm_ca;           // dzv
    acc[8] += a * lm_ca;           // dlu
    acc[9] -= b * lm_ca;           // dlv
    acc[10] += rmss * ca;          // drss (/ ds^2)
    acc[11] -= a * rms_sa;         // drsu (/ ds)
    acc[12] += b * rms_sa;         // drsv (/ ds)
    acc[13] -= aa * rm_ca;         // druu
    acc[14] += ab * rm_ca;         // druv
    acc[15] -= bb * rm_ca;         // drvv
    acc[16] += zmss * sa;          // dzss (/ ds^2)
    acc[17] += a * zms_ca;         // dzsu (/ ds)
    acc[18] -= b * zms_ca;         // dzsv (/ ds)
    acc[19] -= aa * zm_sa;         // dzuu
    acc[20] += ab * zm_sa;         // dzuv
    acc[21] -= bb * zm_sa;         // dzvv
    acc[22] += a * lms_ca;         // dlus (/ ds)
    acc[23] -= b * lms_ca;         // dlvs (/ ds)
    acc[24] -= aa * lm_sa;         // dluu
    acc[25] += ab * lm_sa;         // dluv
    acc[26] -= bb * lm_sa;         // dlvv
  }
  const T ds2 = ds * ds;
  acc[2] = acc[2] / ds;
  acc[5] = acc[5] / ds;
  acc[10] = acc[10] / ds2;
  acc[11] = acc[11] / ds;
  acc[12] = acc[12] / ds;
  acc[16] = acc[16] / ds2;
  acc[17] = acc[17] / ds;
  acc[18] = acc[18] / ds;
  acc[22] = acc[22] / ds;
  acc[23] = acc[23] / ds;
#pragma unroll
  for (int k = 0; k < kJet; ++k) out[k * n + i] = acc[k];
}

template <typename T>
int launch_vmec_geom(long long n, const void* s, const void* u,
                     const void* v, const void* rz, const void* lm,
                     const void* xm, const void* xn, int ns_f, int ns_h,
                     int g, const double* params, void* out,
                     cudaStream_t stream) {
  const long long blocks = (n + kGeomThreads - 1) / kGeomThreads;
  vmec_geom_kernel<T><<<static_cast<unsigned>(blocks), kGeomThreads, 0,
                        stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(u),
      static_cast<const T*>(v), static_cast<const T*>(rz),
      static_cast<const T*>(lm), static_cast<const T*>(xm),
      static_cast<const T*>(xn), static_cast<T*>(out), n, ns_f, ns_h, g,
      T(params[0]), T(params[1]), T(params[2]));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace gft

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes by kernels/build.py)
// ---------------------------------------------------------------------------

// The 27 jet sums of n rays.
//   dtype: 0 = float, 1 = double;
//   s, u, v: (n,) flux coordinates, n >= 1;
//   rz: (ns_f, 4, 2 g) cell-local tables, per cell and Horner coefficient
//     the g rmnc then the g zmns slots; lm: (ns_h, 4, g) the lmns slots;
//   xm, xn: (g,) mode numbers of the slots;
//   params: sminf, sminh, ds;
//   out: (27, n).
// Launches on `stream` and returns at once: 0, a cudaError_t from the
// launch, or -1 for an argument the kernel does not take.
extern "C" int gft_vmec_geom(int dtype, long long n, const void* s,
                             const void* u, const void* v, const void* rz,
                             const void* lm, const void* xm, const void* xn,
                             int ns_f, int ns_h, int g, const double* params,
                             void* out, void* stream) {
  if (n < 1 || ns_f < 1 || ns_h < 1 || g < 1 ||
      (n + gft::kGeomThreads - 1) / gft::kGeomThreads >= (1LL << 31))
    return gft::kInvalidArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gft::launch_vmec_geom<float>(n, s, u, v, rz, lm, xm, xn, ns_f,
                                        ns_h, g, params, out, st);
  if (dtype == 1)
    return gft::launch_vmec_geom<double>(n, s, u, v, rz, lm, xm, xn, ns_f,
                                         ns_h, g, params, out, st);
  return gft::kInvalidArgument;
}
