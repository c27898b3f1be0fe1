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
//     models/dispersion.py cold_plasma over models/efit.py FrozenCellEfit),
//     and evaluated on Dual<T> numbers whose seven tangents are seeded on
//     (w, x, y, z, kx, ky, kz).  The TPU kernel traced jax.grad of D
//     instead; CUDA has no autodiff.  A nested dual type will give the
//     per-substep VJP of the backward kernel later.
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
// The kernel reads its inputs once and writes its outputs once; the
// wrapper allocates separate outputs, but in == out (in place) is safe.

#include <cuda_runtime.h>

namespace gft {

constexpr int kThreads = 128;
constexpr int kTangents = 7;     // w, x, y, z, kx, ky, kz
constexpr int kInvalidArgument = -1;

// state leaf order (models/rays.py RayState)
enum { ST_T = 0, ST_W, ST_X, ST_Y, ST_Z, ST_KX, ST_KY, ST_KZ };

__device__ __forceinline__ float gsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double gsqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float gmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double gmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float gmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double gmin(double a, double b) { return fmin(a, b); }

// ---------------------------------------------------------------------------
// forward-mode dual numbers: value + kTangents directional derivatives
// ---------------------------------------------------------------------------

template <typename T>
struct Dual {
  T v;
  T d[kTangents];
};

template <typename T>
__device__ __forceinline__ Dual<T> dual_var(T v, int k) {
  Dual<T> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < kTangents; ++i) r.d[i] = (i == k) ? T(1) : T(0);
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a) {
  Dual<T> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < kTangents; ++i) r.d[i] = -a.d[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < kTangents; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a, T b) {
  Dual<T> r = a;
  r.v = a.v + b;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator+(T a, const Dual<T>& b) {
  Dual<T> r = b;
  r.v = a + b.v;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < kTangents; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a, T b) {
  Dual<T> r = a;
  r.v = a.v - b;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(T a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < kTangents; ++i) r.d[i] = -b.d[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < kTangents; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a, T b) {
  Dual<T> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < kTangents; ++i) r.d[i] = a.d[i] * b;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, const Dual<T>& b) {
  return b * a;
}

// quotient rule with one reciprocal: (a/b)' = (a' - (a/b) b') / b
template <typename T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v / b.v;
  const T inv = T(1) / b.v;
#pragma unroll
  for (int i = 0; i < kTangents; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a, T b) {
  Dual<T> r;
  r.v = a.v / b;
  const T inv = T(1) / b;
#pragma unroll
  for (int i = 0; i < kTangents; ++i) r.d[i] = a.d[i] * inv;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> gsqrt(const Dual<T>& a) {
  Dual<T> r;
  r.v = gsqrt(a.v);
  const T half_inv = T(0.5) / r.v;
#pragma unroll
  for (int i = 0; i < kTangents; ++i) r.d[i] = a.d[i] * half_inv;
  return r;
}

// ---------------------------------------------------------------------------
// the frozen equilibrium view and the launch parameters
// ---------------------------------------------------------------------------

// One ray's window-base gather (models/efit.py FrozenCellEfit).
template <typename T>
struct Frozen {
  T psi[16];       // bicubic block, [a * 4 + b]: u^a v^b
  T prof[16];      // profile block, [p * 4 + k]: p = ne, te, pressure, fpol
  T iu, jv, pidx;  // frozen cell indices (as floats)
};

template <typename T>
struct Params {
  T rmin, dr, zmin, dz, psimin, dpsi, ne_scale, te_scale;
  // q^2/(eps0 m c^2) and q/(m c) folded in double (constants.py), for the
  // electrons (charge -q) and the one ion species (deuterium, charge +q)
  T kpe, kce, kpi, kci;
  T dt, half, sixth;   // dt, dt/2, dt/6, each rounded once from double
  int nr, nz, npsi;
};

template <typename T>
struct StatePtrs {
  T* p[16];
};

// ops/tables.py table_index_1d: normalize, clamp as a float, truncate.
// fmax(NaN, 0) = 0, so a NaN coordinate takes cell 0.
template <typename T>
__device__ __forceinline__ int table_index(T x, T scale, T offset, int length) {
  T u = (x - offset) / scale;
  u = gmin(gmax(u, T(0)), T(length - 1));
  return static_cast<int>(u);
}

// ---------------------------------------------------------------------------
// D, once, for any scalar type S (T or Dual<T>)
// ---------------------------------------------------------------------------

// models/dispersion.py cold_plasma over models/efit.py
// FrozenCellEfit.plasma_quantities; the operation order follows the
// PyTorch (and JAX) expressions.  Pressure and the ion temperature do not
// enter cold-plasma D and are not evaluated.
template <typename S, typename T>
__device__ __forceinline__ S cold_plasma_D(const S& w, const S kvec[3],
                                           const S pos[3], const Frozen<T>& f,
                                           const Params<T>& p) {
  const S& x = pos[0];
  const S& y = pos[1];
  const S& z = pos[2];
  const S r = gsqrt(x * x + y * y);
  const S u = (r - p.rmin) / p.dr - f.iu;
  const S v = (z - p.zmin) / p.dz - f.jv;

  // bicubic jet (ops/spline.py eval_bicubic_jet_block): a cubic in v per
  // u power a, then Horner in u, streamed from a = 3 down so that only
  // one row is live at a time
  S val, dval_du, dval_dv;
#pragma unroll
  for (int a = 3; a >= 0; --a) {
    const T* c = f.psi + 4 * a;
    const S ca = c[0] + v * (c[1] + v * (c[2] + v * c[3]));
    const S cb = c[1] + v * (T(2) * c[2] + T(3) * v * c[3]);
    if (a == 3) {
      val = ca;
      dval_du = T(3) * u * ca;
      dval_dv = cb;
    } else {
      val = ca + u * val;
      if (a == 2) dval_du = T(2) * ca + dval_du;
      if (a == 1) dval_du = ca + u * dval_du;
      dval_dv = cb + u * dval_dv;
    }
  }
  const S psi_r = dval_du / p.dr;
  const S psi_z = dval_dv / p.dz;

  // profiles (ops/spline.py eval_cubic_multi_block) at the frozen cell
  const S up = (val - p.psimin) / p.dpsi - f.pidx;
  const T* q = f.prof;
  const S ne_v = q[0] + up * (q[1] + up * (q[2] + up * q[3]));
  const S te_v = q[4] + up * (q[5] + up * (q[6] + up * q[7]));
  const S fpol = q[12] + up * (q[13] + up * (q[14] + up * q[15]));
  const S ne = p.ne_scale * ne_v;
  const S te = p.te_scale * te_v;

  // B (models/efit.py _magnetic_field)
  const S br = psi_z / r;
  const S bp = fpol / r;
  const S bz = -psi_r / r;
  const S cphi = x / r;
  const S sphi = y / r;
  const S bx = br * cphi - bp * sphi;
  const S by = br * sphi + bp * cphi;

  // cold-plasma determinant; the ion density is the te profile (the
  // reference's ni = te quirk, equilibrium.hpp:1361)
  const S wpe2 = ne * p.kpe;
  const S b_len = gsqrt(bx * bx + by * by + bz * bz);
  const S ec = b_len * p.kce;
  const S w2 = w * w;
  const S denome = T(1) - ec * ec / w2;
  S e11 = T(1) - (wpe2 / w2) / denome;
  S e12 = ((ec / w) * (wpe2 / w2)) / denome;
  S e33 = wpe2;

  const S wpi2 = te * p.kpi;
  const S ic = b_len * p.kci;
  const S denomi = T(1) - ic * ic / w2;
  e11 = e11 - (wpi2 / w2) / denomi;
  e12 = e12 + ((ic / w) * (wpi2 / w2)) / denomi;
  e33 = e33 + wpi2;

  e12 = -e12;
  e33 = T(1) - e33 / w2;

  const S n0 = kvec[0] / w;
  const S n1 = kvec[1] / w;
  const S n2c = kvec[2] / w;
  const S bh0 = bx / b_len;
  const S bh1 = by / b_len;
  const S bh2 = bz / b_len;
  const S n2 = n0 * n0 + n1 * n1 + n2c * n2c;
  const S npara = bh0 * n0 + bh1 * n1 + bh2 * n2c;
  const S npara2 = npara * npara;
  const S nperp2 = n2 - npara2;

  const S m11 = e11 - npara2;
  const S m12 = e12;
  const S m13_sq = npara2 * nperp2;
  const S m22 = e11 - n2;
  const S m33 = e33 - nperp2;
  return (m11 * m22 - m12 * m12) * m33 - m22 * m13_sq;
}

// models/rays.py make_ray_rhs: (dx, dy, dz, dkx, dky, dkz)/dt from the
// seven derivatives of D, by forward mode.
template <typename T>
__device__ __forceinline__ void ray_rhs(const T s[8], const Frozen<T>& f,
                                        const Params<T>& p, T out[6]) {
  const Dual<T> w = dual_var(s[ST_W], 0);
  const Dual<T> pos[3] = {dual_var(s[ST_X], 1), dual_var(s[ST_Y], 2),
                          dual_var(s[ST_Z], 3)};
  const Dual<T> kvec[3] = {dual_var(s[ST_KX], 4), dual_var(s[ST_KY], 5),
                           dual_var(s[ST_KZ], 6)};
  const Dual<T> d = cold_plasma_D(w, kvec, pos, f, p);
  const T dw = d.d[0];
  out[0] = -d.d[4] / dw;
  out[1] = -d.d[5] / dw;
  out[2] = -d.d[6] / dw;
  out[3] = d.d[1] / dw;
  out[4] = d.d[2] / dw;
  out[5] = d.d[3] / dw;
}

// state + h * derivs on the six integrated leaves (ops/integrators.py
// _shift; t does not enter D)
template <typename T>
__device__ __forceinline__ void shift(const T s[8], const T d[6], T h, T o[8]) {
  o[ST_T] = s[ST_T];
  o[ST_W] = s[ST_W];
#pragma unroll
  for (int j = 0; j < 6; ++j) o[ST_X + j] = s[ST_X + j] + h * d[j];
}

// the unfolded rk2/rk4 increments of the six integrated leaves
// (ops/integrators.py _rk2_sum/_rk4_sum)
template <typename T, int METHOD>
__device__ __forceinline__ void increment(const T s[8], const Frozen<T>& f,
                                          const Params<T>& p, T inc[6]) {
  T d1[6], d2[6], st[8];
  ray_rhs(s, f, p, d1);
  if (METHOD == 2) {
    shift(s, d1, p.dt, st);
    ray_rhs(st, f, p, d2);
#pragma unroll
    for (int j = 0; j < 6; ++j) inc[j] = p.half * (d1[j] + d2[j]);
  } else {
    T d3[6];
    shift(s, d1, p.half, st);
    ray_rhs(st, f, p, d2);
    shift(s, d2, p.half, st);
    ray_rhs(st, f, p, d3);
#pragma unroll
    for (int j = 0; j < 6; ++j) d2[j] = d2[j] + d3[j];
    shift(s, d3, p.dt, st);
    ray_rhs(st, f, p, d3);   // d4
#pragma unroll
    for (int j = 0; j < 6; ++j)
      inc[j] = p.sixth * (d1[j] + T(2) * d2[j] + d3[j]);
  }
}

// ops/compensated.py _two_sum: a + b = s + e exactly
template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  s = a + b;
  const T bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// models/efit.py EfitEquilibrium.freeze_cells for one ray
template <typename T>
__device__ __forceinline__ Frozen<T> freeze(const T s[8],
                                            const T* __restrict__ psi_tab,
                                            const T* __restrict__ prof_tab,
                                            const Params<T>& p) {
  Frozen<T> f;
  const T x = s[ST_X], y = s[ST_Y], z = s[ST_Z];
  const T r = gsqrt(x * x + y * y);
  const int i = table_index(r, p.dr, p.rmin, p.nr);
  const int j = table_index(z, p.dz, p.zmin, p.nz);
  const T* blk = psi_tab + (static_cast<long long>(i) * p.nz + j) * 16;
#pragma unroll
  for (int k = 0; k < 16; ++k) f.psi[k] = __ldg(blk + k);
  f.iu = T(i);
  f.jv = T(j);
  const T u = (r - p.rmin) / p.dr - f.iu;
  const T v = (z - p.zmin) / p.dz - f.jv;
  T val = T(0);
#pragma unroll
  for (int a = 3; a >= 0; --a) {
    const T* c = f.psi + 4 * a;
    const T ca = c[0] + v * (c[1] + v * (c[2] + v * c[3]));
    val = (a == 3) ? ca : ca + u * val;
  }
  const int pi = table_index(val, p.dpsi, p.psimin, p.npsi);
  const T* pb = prof_tab + static_cast<long long>(pi) * 16;
#pragma unroll
  for (int k = 0; k < 16; ++k) f.prof[k] = __ldg(pb + k);
  f.pidx = T(pi);
  return f;
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
    T inc[6];
    increment<T, METHOD>(s, f, p, inc);
    if (COMP) {
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
      s[ST_T] = s[ST_T] + p.dt;
#pragma unroll
      for (int j = 0; j < 6; ++j) s[ST_X + j] = s[ST_X + j] + inc[j];
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
Params<T> make_params(const double* a, int nr, int nz, int npsi) {
  Params<T> p;
  p.rmin = T(a[0]);
  p.dr = T(a[1]);
  p.zmin = T(a[2]);
  p.dz = T(a[3]);
  p.psimin = T(a[4]);
  p.dpsi = T(a[5]);
  p.ne_scale = T(a[6]);
  p.te_scale = T(a[7]);
  p.kpe = T(a[8]);
  p.kce = T(a[9]);
  p.kpi = T(a[10]);
  p.kci = T(a[11]);
  p.dt = T(a[12]);
  p.half = T(a[12] / 2.0);
  p.sixth = T(a[12] / 6.0);
  p.nr = nr;
  p.nz = nz;
  p.npsi = npsi;
  return p;
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
  if (n < 0 || steps < 1 || (method != 2 && method != 4) ||
      (compensated != 0 && compensated != 1) || nr < 1 || nz < 1 ||
      npsi < 1 || (n + gft::kThreads - 1) / gft::kThreads > 0x7fffffffLL)
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
    return "invalid argument to gft_efit_window";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
