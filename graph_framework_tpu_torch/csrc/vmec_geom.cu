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
//     the reference's shape) with its 27 sums in registers.  The tables are
//     the whole tables, cell- then mode-major: rz (ns_f, G, 8) holds a
//     mode's four rmnc then four zmns Horner coefficients together, lm
//     (ns_h, G, 4) its four lmns ones, so a ray takes a mode's twelve
//     coefficients in three 16-byte loads through the read-only cache.
//     A warp's rays lie in a few neighbouring cells, and each load
//     instruction touches a cache line for each cell it meets, so the
//     loads a mode are kept few (a coefficient-major layout takes 12).
//   * Structure-of-arrays output (27, n), so every store is coalesced; any
//     ray count, the ragged last block masked.
//
// The modes as runs.  xm = m and xn = n nfp are integers times one period
// count nfp (kernels/vmec_geom.py mode_runs derives m, n and nfp, and
// refuses a mode set that is not so).  The wrapper hands the kernel the
// modes in their own order as runs (m, n0, len): len consecutive modes of
// one m with n = n0, n0 + 1, ...  VMEC's order is m-major with n
// ascending, so the reference's 86 modes are 10 runs, one for each m.
//
// The trig.  A ray takes two sincos, of u and of phi = nfp v, and reaches
// every mode by angle-addition rotations, never by the three-term
// recurrence: (cos, sin)(m u) by m rotations by u (carried from run to
// run while m does not fall), (cos, sin)(n0 phi) by |n0| rotations by phi
// (kept while the next run starts at the same n0), their product for the
// run's first mode, then one rotation by -phi a mode along the run.  The
// angle of a mode is reached in at most m + |n0| + len rotations, so its
// error grows about that many times the unit roundoff, where the sincos
// of the rounded angle xm u - xn v (the plain version's) errs by about
// |angle| x eps, with a range reduction for every mode.
// The registers carry the trig (no table of n in shared memory).
//
// The factors m.  A sum with a factor m or m^2 accumulates without it over
// the run and is scaled once at the run's end (12 run sums); the sums with
// xn or xn^2 take it per mode.  The kernel loads no mode numbers.
//
// Not carried over from the TPU kernel: the one-hot matrix-unit fetch and
// the bf16 word split of the tables, the 128-cell radial cut (the clamps
// here are the reference's, over the whole table), the 128-mode padding,
// the (n, 48) duplicated output and the Cody-Waite reduction before the
// trig.
//
// What bounds it on this card: per ray and mode 3 coefficient loads and
// some 90 multiplies and adds (kernels/vmec_geom.py and
// tools/count_ops.py count them); the bytes - s, u, v in and 27 sums out a
// ray, the tables once - are few beside that, so it is compute-bound.  A
// few operations depend on the mode numbers alone (xn, xn^2, m^2): the
// bound counts them once, the kernel redoes them per ray, where a multiply
// costs less than a load.  On an H100 (700 W) the mode loop compiles to
// 79 instructions, so the kernel is held by instruction issue and, where
// a warp's rays spread over several cells, by the gather: 100k rays at
// the VMEC launch take about 0.043 ms, and 0.035 ms with every ray in one
// cell (tools/kernel_ab.py).
//
// The Horner polynomials, the rotations and the sums may contract into
// FMAs (never build with --use_fast_math).

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
__device__ __forceinline__ void gsincos(float a, float* s, float* c) {
  sincosf(a, s, c);
}
__device__ __forceinline__ void gsincos(double a, double* s, double* c) {
  sincos(a, s, c);
}

// Four consecutive coefficients, 16-byte aligned: one vector load in f32,
// two in f64.
template <typename T>
__device__ __forceinline__ void load4(const T* p, T* a, T* b, T* c, T* d) {
  *a = p[0];
  *b = p[1];
  *c = p[2];
  *d = p[3];
}
__device__ __forceinline__ void load4(const float* p, float* a, float* b,
                                      float* c, float* d) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  *a = q.x;
  *b = q.y;
  *c = q.z;
  *d = q.w;
}
__device__ __forceinline__ void load4(const double* p, double* a, double* b,
                                      double* c, double* d) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  const double2 r = __ldg(reinterpret_cast<const double2*>(p) + 1);
  *a = q.x;
  *b = q.y;
  *c = r.x;
  *d = r.y;
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

// (c, s) <- (cos, sin)(a + b) from (c, s) = (cos, sin)(a), (cb, sb) of b.
template <typename T>
__device__ __forceinline__ void rotate(T* c, T* s, T cb, T sb) {
  const T cn = *c * cb - *s * sb;
  *s = *s * cb + *c * sb;
  *c = cn;
}

template <typename T>
__global__ void __launch_bounds__(kGeomThreads)
vmec_geom_kernel(const T* __restrict__ s_in, const T* __restrict__ u_in,
                 const T* __restrict__ v_in, const T* __restrict__ rz,
                 const T* __restrict__ lm, const int* __restrict__ runs,
                 int n_runs, T* __restrict__ out, long long n, int ns_f,
                 int ns_h, int g, T sminf, T sminh, T ds, T nfp) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T s = s_in[i], u = u_in[i], v = v_in[i];
  T tf, th;
  const int kf = radial_cell(s, sminf, ds, ns_f, &tf);
  const int kh = radial_cell(s, sminh, ds, ns_h, &th);
  // a mode's eight rmnc, zmns coefficients and four lmns ones lie together
  const T* __restrict__ blk = rz + static_cast<long long>(kf) * 8 * g;
  const T* __restrict__ lblk = lm + static_cast<long long>(kh) * 4 * g;

  // the radial derivatives' 1/ds and 1/ds^2 are applied to the sums once
  T acc[kJet];
#pragma unroll
  for (int k = 0; k < kJet; ++k) acc[k] = T(0);
  const T tf3 = T(3) * tf, tf6 = T(6) * tf, th3 = T(3) * th;

  T su, cu, sp, cp;
  gsincos(u, &su, &cu);
  gsincos(nfp * v, &sp, &cp);
  T cm = T(1), sm = T(0), cn0 = T(1), sn0 = T(0);   // (cos, sin)(m u, n0 phi)
  int m_at = 0, n0_at = 0;
  int j = 0;                                         // the run's first mode
  for (int r = 0; r < n_runs; ++r) {
    const int m = __ldg(runs + 3 * r), n0 = __ldg(runs + 3 * r + 1);
    const int len = __ldg(runs + 3 * r + 2);
    if (m < m_at) {
      cm = T(1);
      sm = T(0);
      m_at = 0;
    }
    for (; m_at < m; ++m_at) rotate(&cm, &sm, cu, su);
    if (n0 != n0_at) {
      const T step = n0 < 0 ? -sp : sp;
      cn0 = T(1);
      sn0 = T(0);
      for (int k = n0 < 0 ? -n0 : n0; k > 0; --k) rotate(&cn0, &sn0, cp, step);
      n0_at = n0;
    }
    // the first mode's angle m u - n0 phi; each next mode's is phi less
    T ca = cm * cn0 + sm * sn0, sa = sm * cn0 - cm * sn0;
    T b = T(n0) * nfp;                               // xn of the mode

    // run sums, the factor m applied at the run's end
    T r_ca = T(0), z_sa = T(0), r_sa = T(0), z_ca = T(0), l_ca = T(0);
    T rs_sa = T(0), br_ca = T(0), zs_ca = T(0), bz_sa = T(0), ls_ca = T(0);
    T l_sa = T(0), bl_sa = T(0);
    for (int e = j + len; j < e; ++j) {
      T r0, r1, r2, r3, z0, z1, z2, z3, l0, l1, l2, l3;
      load4(blk + 8 * j, &r0, &r1, &r2, &r3);
      load4(blk + 8 * j + 4, &z0, &z1, &z2, &z3);
      load4(lblk + 4 * j, &l0, &l1, &l2, &l3);
      const T rm = r0 + tf * (r1 + tf * (r2 + tf * r3));
      const T rms = r1 + tf * (T(2) * r2 + tf3 * r3);
      const T rmss = T(2) * r2 + tf6 * r3;
      const T zm = z0 + tf * (z1 + tf * (z2 + tf * z3));
      const T zms = z1 + tf * (T(2) * z2 + tf3 * z3);
      const T zmss = T(2) * z2 + tf6 * z3;
      const T lv = l0 + th * (l1 + th * (l2 + th * l3));
      const T lms = l1 + th * (T(2) * l2 + th3 * l3);

      const T rm_sa = rm * sa, rm_ca = rm * ca;
      const T zm_sa = zm * sa, zm_ca = zm * ca;
      const T lm_sa = lv * sa, lm_ca = lv * ca;
      const T rms_sa = rms * sa, zms_ca = zms * ca, lms_ca = lms * ca;
      const T bb = b * b;
      r_ca += rm_ca;                 // r, druu
      z_sa += zm_sa;                 // z, dzuu
      acc[2] += rms * ca;            // drs (/ ds)
      r_sa += rm_sa;                 // dru
      acc[4] += b * rm_sa;           // drv
      acc[5] += zms * sa;            // dzs (/ ds)
      z_ca += zm_ca;                 // dzu
      acc[7] -= b * zm_ca;           // dzv
      l_ca += lm_ca;                 // dlu
      acc[9] -= b * lm_ca;           // dlv
      acc[10] += rmss * ca;          // drss (/ ds^2)
      rs_sa += rms_sa;               // drsu
      acc[12] += b * rms_sa;         // drsv (/ ds)
      br_ca += b * rm_ca;            // druv
      acc[15] -= bb * rm_ca;         // drvv
      acc[16] += zmss * sa;          // dzss (/ ds^2)
      zs_ca += zms_ca;               // dzsu
      acc[18] -= b * zms_ca;         // dzsv (/ ds)
      bz_sa += b * zm_sa;            // dzuv
      acc[21] -= bb * zm_sa;         // dzvv
      ls_ca += lms_ca;               // dlus
      acc[23] -= b * lms_ca;         // dlvs (/ ds)
      l_sa += lm_sa;                 // dluu
      bl_sa += b * lm_sa;            // dluv
      acc[26] -= bb * lm_sa;         // dlvv
      rotate(&ca, &sa, cp, -sp);
      b += nfp;
    }
    const T a = T(m), aa = a * a;
    acc[0] += r_ca;
    acc[1] += z_sa;
    acc[3] -= a * r_sa;
    acc[6] += a * z_ca;
    acc[8] += a * l_ca;
    acc[11] -= a * rs_sa;            // (/ ds)
    acc[13] -= aa * r_ca;
    acc[14] += a * br_ca;
    acc[17] += a * zs_ca;            // (/ ds)
    acc[19] -= aa * z_sa;
    acc[20] += a * bz_sa;
    acc[22] += a * ls_ca;            // (/ ds)
    acc[24] -= aa * l_sa;
    acc[25] += a * bl_sa;
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
                     const int* runs, int n_runs, int ns_f, int ns_h, int g,
                     const double* params, void* out, cudaStream_t stream) {
  const long long blocks = (n + kGeomThreads - 1) / kGeomThreads;
  vmec_geom_kernel<T><<<static_cast<unsigned>(blocks), kGeomThreads, 0,
                        stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(u),
      static_cast<const T*>(v), static_cast<const T*>(rz),
      static_cast<const T*>(lm), runs, n_runs, static_cast<T*>(out), n,
      ns_f, ns_h, g, T(params[0]), T(params[1]), T(params[2]),
      T(params[3]));
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
//   rz: (ns_f, g, 8) cell-local tables, per cell and mode the four rmnc
//     then the four zmns Horner coefficients; lm: (ns_h, g, 4) the lmns
//     ones; both 16-byte aligned;
//   runs: (n_runs, 3) int32 on the device, the modes in table order as
//     runs (m, n0, len) of consecutive n (xm = m, xn = n nfp); the lens
//     sum to g (the caller checks);
//   params: sminf, sminh, ds, nfp;
//   out: (27, n).
// Launches on `stream` and returns at once: 0, a cudaError_t from the
// launch, or -1 for an argument the kernel does not take.
extern "C" int gft_vmec_geom(int dtype, long long n, const void* s,
                             const void* u, const void* v, const void* rz,
                             const void* lm, const void* runs, int n_runs,
                             int ns_f, int ns_h, int g, const double* params,
                             void* out, void* stream) {
  if (n < 1 || ns_f < 1 || ns_h < 1 || g < 1 || n_runs < 1 ||
      (n + gft::kGeomThreads - 1) / gft::kGeomThreads >= (1LL << 31))
    return gft::kInvalidArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(runs);
  if (dtype == 0)
    return gft::launch_vmec_geom<float>(n, s, u, v, rz, lm, r, n_runs, ns_f,
                                        ns_h, g, params, out, st);
  if (dtype == 1)
    return gft::launch_vmec_geom<double>(n, s, u, v, rz, lm, r, n_runs,
                                         ns_f, ns_h, g, params, out, st);
  return gft::kInvalidArgument;
}
