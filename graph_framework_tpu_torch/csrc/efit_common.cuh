// Device code shared by the EFIT window kernels (efit_window.cu: the
// forward window K1; efit_window_bwd.cu: its backward kernels K2 and K3).
//
// D, the cold-plasma dispersion over a ray's frozen EFIT blocks, is written
// once, as the template cold_plasma_D<S>, and evaluated on whatever scalar
// S the caller needs:
//
//   * T (float or double) for a plain value;
//   * Dual<T, 7> - forward-mode dual numbers whose seven tangents are seeded
//     on (w, x, y, z, kx, ky, kz) - for the gradient of D, which gives the
//     ray right-hand side (K1);
//   * Dual<Dual<T, NI>, 1> - forward over forward: the outer tangent is
//     seeded with a direction v, so the outer tangent of the inner gradient
//     is the Hessian-vector product H v of D (K2, K3).
//
// Dual is generic in its scalar and its tangent count and mixes with plain
// T coefficients (scalar_t<S>), so nesting needs no other code.  Only
// templates and inline functions live here: every .cu that includes it
// compiles on its own, and they link into one library.
//
// Numerics: no --use_fast_math (IEEE division and square root).  FMA
// contraction is left on in the arithmetic, so f32 results differ from the
// plain PyTorch version in the last bits.  The freeze gather alone rounds
// every product and sum on its own (mul_rn / add_rn), as eager PyTorch
// does, so kernel and plain version pick the same cells for every ray.

#pragma once

#include <cuda_runtime.h>

namespace gft {

constexpr int kThreads = 128;
constexpr int kTangents = 7;     // w, x, y, z, kx, ky, kz
constexpr int kInvalidArgument = -1;

// state leaf order (models/rays.py RayState)
enum { ST_T = 0, ST_W, ST_X, ST_Y, ST_Z, ST_KX, ST_KY, ST_KZ };

__device__ __forceinline__ float gsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double gsqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float recip(float a) { return 1.0f / a; }
__device__ __forceinline__ double recip(double a) { return 1.0 / a; }
__device__ __forceinline__ float gmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double gmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float gmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double gmin(double a, double b) { return fmin(a, b); }
// one rounding per operation, never contracted into an FMA
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// ---------------------------------------------------------------------------
// forward-mode dual numbers: value + N directional derivatives, over any
// scalar T (a float type or another Dual)
// ---------------------------------------------------------------------------

template <typename T, int N>
struct Dual {
  T v;
  T d[N];
};

// the plain float type under any nesting of Duals
template <typename T>
struct ScalarOf {
  using type = T;
};
template <typename T, int N>
struct ScalarOf<Dual<T, N>> {
  using type = typename ScalarOf<T>::type;
};
template <typename T>
using scalar_t = typename ScalarOf<T>::type;

// a constant of type S (all tangents zero)
template <typename S>
struct Lift {
  static __device__ __forceinline__ S of(S c) { return c; }
};
template <typename T, int N>
struct Lift<Dual<T, N>> {
  static __device__ __forceinline__ Dual<T, N> of(scalar_t<T> c) {
    Dual<T, N> r;
    r.v = Lift<T>::of(c);
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = Lift<T>::of(scalar_t<T>(0));
    return r;
  }
};

// a variable: value v, tangent k seeded with 1
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> dual_var(T v, int k) {
  Dual<T, N> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (i == k) ? T(1) : T(0);
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a,
                                                scalar_t<T> b) {
  Dual<T, N> r = a;
  r.v = a.v + b;
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(scalar_t<T> a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r = b;
  r.v = a + b.v;
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a,
                                                scalar_t<T> b) {
  Dual<T, N> r = a;
  r.v = a.v - b;
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(scalar_t<T> a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -b.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a,
                                                scalar_t<T> b) {
  Dual<T, N> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b;
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(scalar_t<T> a,
                                                const Dual<T, N>& b) {
  return b * a;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> recip(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = recip(a.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -(a.d[i] * r.v) * r.v;
  return r;
}

// quotient rule with one reciprocal: (a/b)' = (a' - (a/b) b') / b
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v / b.v;
  const T inv = recip(b.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(const Dual<T, N>& a,
                                                scalar_t<T> b) {
  Dual<T, N> r;
  r.v = a.v / b;
  const scalar_t<T> inv = scalar_t<T>(1) / b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * inv;
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> gsqrt(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = gsqrt(a.v);
  const T half_inv = recip(r.v) * scalar_t<T>(0.5);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * half_inv;
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
  long long cell;  // row of the psi block in the (nr*nz, 16) table
  long long pcell; // row of the profile block in the (npsi, 16) table
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
// D, once, for any scalar type S (T, Dual<T, N>, Dual<Dual<T, N>, 1>)
// ---------------------------------------------------------------------------

// Table-gradient hooks of cold_plasma_D (TAB = true): inj[6] is added to
// the six quantities through which D depends on the coefficient blocks -
// the bicubic value and its u and v derivatives, then the ne, te and fpol
// profile values - right after each is evaluated.  inj has value zero, so
// D is unchanged; its tangents give D's derivatives with respect to those
// quantities.  uvp[3] receives the cell-local coordinates (u, v, up) on
// which the coefficient weights u^a v^b and up^k depend.
template <typename S>
struct TableHooks {
  const S* inj;
  S* uvp;
};

// models/dispersion.py cold_plasma over models/efit.py
// FrozenCellEfit.plasma_quantities; the operation order follows the
// PyTorch (and JAX) expressions.  Pressure and the ion temperature do not
// enter cold-plasma D and are not evaluated.
template <typename S, typename T, bool TAB = false>
__device__ __forceinline__ S cold_plasma_D(const S& w, const S kvec[3],
                                           const S pos[3], const Frozen<T>& f,
                                           const Params<T>& p,
                                           TableHooks<S> hooks = {}) {
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
  if constexpr (TAB) {
    val = val + hooks.inj[0];
    dval_du = dval_du + hooks.inj[1];
    dval_dv = dval_dv + hooks.inj[2];
  }
  const S psi_r = dval_du / p.dr;
  const S psi_z = dval_dv / p.dz;

  // profiles (ops/spline.py eval_cubic_multi_block) at the frozen cell
  const S up = (val - p.psimin) / p.dpsi - f.pidx;
  const T* q = f.prof;
  S ne_v = q[0] + up * (q[1] + up * (q[2] + up * q[3]));
  S te_v = q[4] + up * (q[5] + up * (q[6] + up * q[7]));
  S fpol = q[12] + up * (q[13] + up * (q[14] + up * q[15]));
  if constexpr (TAB) {
    ne_v = ne_v + hooks.inj[3];
    te_v = te_v + hooks.inj[4];
    fpol = fpol + hooks.inj[5];
    hooks.uvp[0] = u;
    hooks.uvp[1] = v;
    hooks.uvp[2] = up;
  }
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

// The seven partials of D (w, x, y, z, kx, ky, kz) at the state s, by
// forward mode.
template <typename T>
__device__ __forceinline__ void ray_grad(const T s[8], const Frozen<T>& f,
                                         const Params<T>& p, T g[7]) {
  using D7 = Dual<T, kTangents>;
  const D7 w = dual_var<T, kTangents>(s[ST_W], 0);
  const D7 pos[3] = {dual_var<T, kTangents>(s[ST_X], 1),
                     dual_var<T, kTangents>(s[ST_Y], 2),
                     dual_var<T, kTangents>(s[ST_Z], 3)};
  const D7 kvec[3] = {dual_var<T, kTangents>(s[ST_KX], 4),
                      dual_var<T, kTangents>(s[ST_KY], 5),
                      dual_var<T, kTangents>(s[ST_KZ], 6)};
  const D7 d = cold_plasma_D(w, kvec, pos, f, p);
#pragma unroll
  for (int i = 0; i < kTangents; ++i) g[i] = d.d[i];
}

// models/rays.py make_ray_rhs: (dx, dy, dz, dkx, dky, dkz)/dt =
// (-D_k, D_x) / D_w from the seven partials.
template <typename T>
__device__ __forceinline__ void rhs_from_grad(const T g[7], T out[6]) {
  const T dw = g[0];
  out[0] = -g[4] / dw;
  out[1] = -g[5] / dw;
  out[2] = -g[6] / dw;
  out[3] = g[1] / dw;
  out[4] = g[2] / dw;
  out[5] = g[3] / dw;
}

template <typename T>
__device__ __forceinline__ void ray_rhs(const T s[8], const Frozen<T>& f,
                                        const Params<T>& p, T out[6]) {
  T g[7];
  ray_grad(s, f, p, g);
  rhs_from_grad(g, out);
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

// one plain substep in place (t advances by dt, w stays)
template <typename T, int METHOD>
__device__ __forceinline__ void substep(T s[8], const Frozen<T>& f,
                                        const Params<T>& p) {
  T inc[6];
  increment<T, METHOD>(s, f, p, inc);
  s[ST_T] = s[ST_T] + p.dt;
#pragma unroll
  for (int j = 0; j < 6; ++j) s[ST_X + j] = s[ST_X + j] + inc[j];
}

// models/efit.py EfitEquilibrium.freeze_cells for one ray, rounded as
// eager PyTorch rounds it (mul_rn / add_rn: no FMA), so the cells match
// the plain version's exactly
template <typename T>
__device__ __forceinline__ Frozen<T> freeze(const T s[8],
                                            const T* __restrict__ psi_tab,
                                            const T* __restrict__ prof_tab,
                                            const Params<T>& p) {
  Frozen<T> f;
  const T x = s[ST_X], y = s[ST_Y], z = s[ST_Z];
  const T r = gsqrt(add_rn(mul_rn(x, x), mul_rn(y, y)));
  const int i = table_index(r, p.dr, p.rmin, p.nr);
  const int j = table_index(z, p.dz, p.zmin, p.nz);
  f.cell = static_cast<long long>(i) * p.nz + j;
  const T* blk = psi_tab + f.cell * 16;
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
    const T ca = add_rn(c[0], mul_rn(v, add_rn(c[1], mul_rn(v, add_rn(
        c[2], mul_rn(v, c[3]))))));
    val = (a == 3) ? ca : add_rn(ca, mul_rn(u, val));
  }
  const int pi = table_index(val, p.dpsi, p.psimin, p.npsi);
  f.pcell = pi;
  const T* pb = prof_tab + static_cast<long long>(pi) * 16;
#pragma unroll
  for (int k = 0; k < 16; ++k) f.prof[k] = __ldg(pb + k);
  f.pidx = T(pi);
  return f;
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

// the arguments every window kernel refuses
inline bool bad_window_args(int steps, long long n, int method, int nr,
                            int nz, int npsi) {
  return n < 0 || steps < 1 || (method != 2 && method != 4) || nr < 1 ||
         nz < 1 || npsi < 1 || (n + kThreads - 1) / kThreads > 0x7fffffffLL;
}

}  // namespace gft
