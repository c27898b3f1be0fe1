// The weak-damping kamp of a real ray state over an EFIT equilibrium,
// written by hand for Hopper (sm_90a): K9, a forward kernel and its VJP.
//
// It replaces no TPU kernel: the JAX package leaves this function to XLA
// (make_weak_damping_split under jax.grad).  The port's eager path
// (models/absorption.py _weak_damping_kamp under rays.LocalGraph) dispatches
// some 700 device operations a call forward and 2000 in its backward, which
// evaluates kamp again with create_graph=True and pulls the cotangent
// through that second-order graph.  Per ray:
//
//   kamp = |k| - Dw / S,   S = khat . dDc/dk,
//
// with Dc the cold-plasma expansion (efit_adjoint.cuh ColdPlasmaExpansion,
// whose hand-written sweep gives dDc/dk) and Dw the hot-plasma expansion
// (models/dispersion.py make_hot_plasma_expansion), Dw = R (1/Z + zeta),
// R and zeta real for a real state and Z = i sqrt(pi) w(zeta) evaluated as
// the plain version evaluates it (ops/special.py wofz of a real argument:
// Weideman's 64-term rational series where zeta^2 < 36, the 12-level
// continued fraction past it, where w is i Im(w) alone).  EFIT's basis is
// the identity, so kvec = (kx, ky, kz).  ne, te and B come from the ray's
// own psi cell and profile cell of the cell-local tables
// (EfitEquilibrium.plasma_quantities): the freeze gather at the ray's
// position (efit_common.cuh freeze), then efit_adjoint.cuh's field front
// (field_adjoint) with this file's tail, KampTail.
//
//   * weak_damping_kernel: kamp as (re, im) pairs, (n, 2), the storage of a
//     complex tensor.  The tail's adjoints are zero there, and the front's
//     sweep back (some 60 operations a ray) is dead work.
//   * weak_damping_vjp_kernel: from kamp's cotangent, (re, im) pairs (the
//     real functional ct_re Re(kamp) + ct_im Im(kamp)), the cotangents of
//     w, x, y, z, kx, ky, kz, (7, n) (t's is zero: EFIT does not depend on
//     time), and where asked each ray's 16 psi-coefficient cotangents, (n,
//     16) rows for the table scatter (kernels/table_scatter.py), with the
//     row of its psi cell.  A ray whose cotangent is 0 writes zeros and
//     evaluates nothing, so a ray that nan_to_num scrubbed stays finite.
//     The second derivatives: S's gradient by forward over reverse, the
//     cold expansion's sweep on Dual<T, 1> with k's tangent khat (the
//     tangent of dDc/dq is then khat . d2Dc/dk dq, the Hessian being
//     symmetric), plus khat's own dependence on k; Dw's gradient by forward
//     mode on Dual<T, 6> over the six quantities it reads (w, ec, P, n2,
//     npara, vt), chained back to (w, kvec, ne, te, B) by hand (Refraction's
//     sweeps), and dZ/dzeta by w's evaluation on Dual<T, 1>.
//
// One thread a ray, any ray count, the ragged last block masked.  What
// bounds it on this card: operations (kernels/weak_damping.py
// WEAK_DAMPING_OPS, tools/count_ops.py), the Weideman series the largest
// part; a ray moves 36 B forward and 136 B in the VJP (f32).
//
// Divisions are IEEE (never build with --use_fast_math); FMA contraction is
// left on, so f32 results differ from the plain version in the last bits.

#include <cuda_runtime.h>

#include "efit_adjoint.cuh"

namespace gft {

namespace {

constexpr int kWdThreads = 128;
constexpr int kWdLeaves = 7;      // w, x, y, z, kx, ky, kz
constexpr int kWeideman = 64;     // ops/special.py _N_TERMS
constexpr int kFracLevels = 12;   // ops/special.py _LEVELS
constexpr double kSqrtPi = 1.7724538509055160273;
constexpr double kInvSqrtPi = 0.56418958354775628695;

// The window kernels' Params (kernels/efit_step.py kernel_params, dt
// unused), Weideman's L and his coefficients in Horner order
// (ops/special.py _weideman_table).  Read by constant index only, so they
// stay in the launch's parameter space.
template <typename T>
struct WdParams {
  Params<T> p;
  T ell;
  T a[kWeideman];
};

template <typename T>
struct WdLeaves {
  const T* in[kWdLeaves];
};

template <typename S>
struct Cx {
  S re, im;
};

template <typename S>
__device__ __forceinline__ Cx<S> cmul(const Cx<S>& a, const Cx<S>& b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// ops/special.py wofz of a real x (S = T, or Dual<T, 1> for w and dw/dx):
// the continued fraction _w_contfrac where x^2 >= 36, Weideman's
// _w_weideman below, each in the plain version's operation order with one
// reciprocal where it divides.
template <typename S, typename T>
__device__ __forceinline__ Cx<S> wofz_real(const S& x, const WdParams<T>& q) {
  const T xv = value_of(x);
  if (xv * xv >= T(36)) {
    S r = lift<S>(T(0));
#pragma unroll
    for (int n = kFracLevels; n >= 1; --n) r = (T(0.5) * T(n)) * recip(x - r);
    return {lift<S>(T(0)), T(kInvSqrtPi) * recip(x - r)};
  }
  // recip = 1 / (L - i x) = (L + i x) / (L^2 + x^2); bigz = (L + i x) recip
  const S den = recip(q.ell * q.ell + x * x);
  const Cx<S> rc = {q.ell * den, x * den};
  const Cx<S> bigz = {q.ell * rc.re - x * rc.im, q.ell * rc.im + x * rc.re};
  Cx<S> poly = {lift<S>(T(0)), lift<S>(T(0))};
#pragma unroll
  for (int k = 0; k < kWeideman; ++k) {
    poly = cmul(poly, bigz);
    poly.re = poly.re + q.a[k];
  }
  const Cx<S> rc2 = cmul(rc, rc);
  const Cx<S> t = cmul({rc2.re * T(2), rc2.im * T(2)}, poly);
  return {t.re + T(kInvSqrtPi) * rc.re, t.im + T(kInvSqrtPi) * rc.im};
}

// 1/Z(zeta) + zeta with Z = i sqrt(pi) w(zeta) (ops/special.py z_plasma),
// 1/Z by Smith's algorithm, as PyTorch's complex division takes it.
template <typename S, typename T>
__device__ __forceinline__ Cx<S> inverse_z_plus_zeta(const S& zeta,
                                                     const WdParams<T>& q) {
  const Cx<S> w = wofz_real(zeta, q);
  const S zr = -(T(kSqrtPi) * w.im);
  const S zi = T(kSqrtPi) * w.re;
  const T vr = value_of(zr), vi = value_of(zi);
  if (vr * vr >= vi * vi) {
    const S rat = zi / zr;
    const S scl = recip(zr + zi * rat);
    return {scl + zeta, -(rat * scl)};
  }
  const S rat = zr / zi;
  const S scl = recip(zi + zr * rat);
  return {rat * scl + zeta, -scl};
}

// models/dispersion.py make_hot_plasma_expansion's real factor R of
// Dw = R (1/Z + zeta), and zeta, from w, ec = |B| q/(me c), P = wpe2/w^2,
// n2 = |k/w|^2, npara = bhat . k/w and vt = ve/c, in the plain version's
// operation order (S = T, or Dual<T, 6> seeded on these six).
template <typename S>
__device__ __forceinline__ S hot_expansion(const S& w, const S& ec,
                                           const S& P, const S& n2,
                                           const S& npara, const S& vt,
                                           S& zeta) {
  using T = scalar_t<S>;
  const S q = P / (T(2) * (T(1) + ec / w));
  const S npara2 = npara * npara;
  const S nperp2 = n2 - npara2;
  zeta = (T(1) - ec / w) / (npara * vt);
  const S q_func = T(1) - T(2) * q;
  const S n_func = n2 + npara2;
  const S n2nperp2 = n2 * nperp2;
  const S p_func = T(1) - P;
  const S omq = T(1) - q;
  const S gamma5 = P * (n2 * npara2 - omq * n_func + q_func);
  const S gamma2 =
      P * w / ec * nperp2 * (n2 - q_func) +
      P * P * w * w / (T(4) * ec * ec) * (n_func - T(2) * q_func) * nperp2 /
          npara2;
  const S gamma1 = omq * n2nperp2 + p_func * (n2 * npara2 - omq * n_func) +
                   q_func * (p_func - nperp2);
  return -(T(1) + ec / w) * npara * vt *
         (gamma1 + gamma2 +
          nperp2 / (T(2) * npara) * (w * w / (ec * ec)) * vt * zeta * gamma5);
}

// The weak damping as a plasma tail of field_adjoint: from (w, kvec, ne,
// te, B) at the ray, kamp (kamp_re, kamp_im) and, with VJP, the adjoints of
// L = ct_re Re(kamp) + ct_im Im(kamp) over w, kvec, ne, te and B.  Without
// VJP the adjoints are zero.
template <typename T, bool VJP>
struct KampTail {
  static constexpr bool kReadsEq = true, kUsesTe = true, kUsesPres = false,
                        kUsesT = false;

  const WdParams<T>& q;
  T ct_re, ct_im;
  mutable T kamp_re, kamp_im;

  __device__ __forceinline__ void adjoint(const T& w, const T k[3],
                                          const T& ne, const T& te,
                                          const T& pres, const T bv[3],
                                          const Params<T>& p, T g[7], T& ne_b,
                                          T& te_b, T& pres_b,
                                          T bb[3]) const {
    using D1 = Dual<T, 1>;
    using D6 = Dual<T, 6>;
    const T klen = gsqrt(k[0] * k[0] + k[1] * k[1] + k[2] * k[2]);
    const T ik = recip(klen);
    const T kh[3] = {k[0] * ik, k[1] * ik, k[2] * ik};

    // S = khat . dDc/dk; with VJP its partials over (w, kvec, ne, B), the
    // cold expansion's sweep on Dual<T, 1> with k's tangent khat, whose
    // tangents are khat . d2Dc/dk d(w, kvec, ne, B), plus khat's own
    // dependence on k
    T S, s_w, s_k[3], s_ne, s_b[3];
    if constexpr (VJP) {
      D1 wd = lift<D1>(w), ned = lift<D1>(ne), nod = lift<D1>(T(0)), kd[3],
         bvd[3], gd[7], ne_bd, te_bd, pres_bd, bbd[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        kd[i].v = k[i];
        kd[i].d[0] = kh[i];
        bvd[i] = lift<D1>(bv[i]);
      }
      ColdPlasmaExpansion::adjoint(wd, kd, ned, nod, nod, bvd, p, gd, ne_bd,
                                   te_bd, pres_bd, bbd);
      S = kh[0] * gd[4].v + kh[1] * gd[5].v + kh[2] * gd[6].v;
      s_w = gd[0].d[0];
      s_ne = ne_bd.d[0];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        s_k[m] = gd[4 + m].d[0] + (gd[4 + m].v - kh[m] * S) * ik;
        s_b[m] = bbd[m].d[0];
      }
    } else {
      const T zero = T(0);
      T gc[7], ne_c, te_c, pres_c, bc[3];
      ColdPlasmaExpansion::adjoint(w, k, ne, zero, zero, bv, p, gc, ne_c,
                                   te_c, pres_c, bc);
      S = kh[0] * gc[4] + kh[1] * gc[5] + kh[2] * gc[6];
    }

    // Dw's six quantities
    const T b_len = gsqrt(bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2]);
    const T iw = recip(w);
    const Refraction<T> r(iw, k, bv, b_len);
    const T ec = b_len * (-p.kce);
    const T P = (ne * p.kpe) / (w * w);
    const T n2 = r.n[0] * r.n[0] + r.n[1] * r.n[1] + r.n[2] * r.n[2];
    const T vt = gsqrt(te * p.kvt);

    if constexpr (!VJP) {
      T zeta;
      const T R = hot_expansion(w, ec, P, n2, r.npara, vt, zeta);
      const Cx<T> y = inverse_z_plus_zeta(zeta, q);
      kamp_re = klen - (R * y.re) / S;
      kamp_im = -(R * y.im) / S;
      g[0] = g[4] = g[5] = g[6] = ne_b = te_b = pres_b = T(0);
      bb[0] = bb[1] = bb[2] = T(0);
      return;
    }

    // A = ct_re Re(Dw) + ct_im Im(Dw) and its partials over the six
    D6 zeta;
    const D6 R = hot_expansion(
        dual_var<T, 6>(w, 0), dual_var<T, 6>(ec, 1), dual_var<T, 6>(P, 2),
        dual_var<T, 6>(n2, 3), dual_var<T, 6>(r.npara, 4),
        dual_var<T, 6>(vt, 5), zeta);
    const Cx<D1> y = inverse_z_plus_zeta(dual_var<T, 1>(zeta.v, 0), q);
    const T a_r = ct_re * y.re.v + ct_im * y.im.v;
    const T A = R.v * a_r;
    const T a_z = R.v * (ct_re * y.re.d[0] + ct_im * y.im.d[0]);
    T a[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) a[j] = a_r * R.d[j] + a_z * zeta.d[j];

    // ... back to w, kvec, ne, te and B
    T n_b[3], ga[7], ba[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      n_b[i] = T(2) * a[3] * r.n[i] + a[4] * r.bh[i];
    const T w_a = r.k_back(n_b, iw, ga) + a[0] - T(2) * (a[2] * P) * iw;
    r.b_back(a[4], a[1] * (-p.kce), ba);
    const T ne_a = a[2] * p.kpe * (iw * iw);
    const T te_a = a[5] * (T(0.5) * p.kvt) / vt;

    // L = ct_re |k| - A / S
    const T c_a = -recip(S);
    const T c_s = A / (S * S);
    g[0] = c_a * w_a + c_s * s_w;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      g[4 + m] = ct_re * kh[m] + c_a * ga[4 + m] + c_s * s_k[m];
      bb[m] = c_a * ba[m] + c_s * s_b[m];
    }
    ne_b = c_a * ne_a + c_s * s_ne;
    te_b = c_a * te_a;
    pres_b = T(0);
  }
};

template <typename T>
__device__ __forceinline__ void load_state(const WdLeaves<T>& st,
                                           long long i, T s[8], T sv[7]) {
  s[ST_T] = T(0);   // freeze reads the position alone
#pragma unroll
  for (int k = 0; k < kWdLeaves; ++k) s[ST_W + k] = sv[k] = st.in[k][i];
}

template <typename T>
__global__ void __launch_bounds__(kWdThreads)
weak_damping_kernel(WdLeaves<T> st, const T* __restrict__ psi_tab,
                    const T* __restrict__ prof_tab, WdParams<T> q,
                    T* __restrict__ out, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T s[8], sv[7];
  load_state(st, i, s, sv);
  const Frozen<T> f = freeze(s, psi_tab, prof_tab, q.p);
  const KampTail<T, false> tail{q, T(0), T(0), T(0), T(0)};
  T g[7], b[7], uvp[3];
  field_adjoint<KampTail<T, false>>(sv, f, q.p, g, b, uvp, tail);
  out[2 * i] = tail.kamp_re;
  out[2 * i + 1] = tail.kamp_im;
}

// Coefficient (a, b) of the psi block weighs the bicubic value by u^a v^b,
// dval/du by a u^(a-1) v^b and dval/dv by b u^a v^(b-1): its cotangent from
// their adjoints b[0..2].
template <typename T>
__device__ __forceinline__ void psi_row(const T b[7], const T uvp[3],
                                        T* __restrict__ row) {
  const T u = uvp[0], v = uvp[1];
  const T U[4] = {T(1), u, u * u, u * u * u};
  const T V[4] = {T(1), v, v * v, v * v * v};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const T x = a == 0 ? b[0] : b[0] * U[a] + (T(a) * b[1]) * U[a - 1];
    const T y = b[2] * U[a];
    row[4 * a] = x;
#pragma unroll
    for (int c = 1; c < 4; ++c) row[4 * a + c] = x * V[c] + (T(c) * y) * V[c - 1];
  }
}

template <typename T>
__global__ void __launch_bounds__(kWdThreads)
weak_damping_vjp_kernel(WdLeaves<T> st, const T* __restrict__ ct,
                        const T* __restrict__ psi_tab,
                        const T* __restrict__ prof_tab, WdParams<T> q,
                        T* __restrict__ dleaves, T* __restrict__ dpsi,
                        long long* __restrict__ cell, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T ct_re = ct[2 * i], ct_im = ct[2 * i + 1];
  T g[7], b[7], uvp[3];
  long long row = 0;
  if (ct_re == T(0) && ct_im == T(0)) {
#pragma unroll
    for (int k = 0; k < 7; ++k) g[k] = b[k] = T(0);
    uvp[0] = uvp[1] = uvp[2] = T(0);
  } else {
    T s[8], sv[7];
    load_state(st, i, s, sv);
    const Frozen<T> f = freeze(s, psi_tab, prof_tab, q.p);
    row = f.cell;
    const KampTail<T, true> tail{q, ct_re, ct_im, T(0), T(0)};
    field_adjoint<KampTail<T, true>>(sv, f, q.p, g, b, uvp, tail);
  }
#pragma unroll
  for (int k = 0; k < kWdLeaves; ++k) dleaves[k * n + i] = g[k];
  if (dpsi != nullptr) {
    T r[16];
    psi_row(b, uvp, r);
#pragma unroll
    for (int k = 0; k < 16; ++k) dpsi[16 * i + k] = r[k];
    cell[i] = row;
  }
}

template <typename T>
WdParams<T> make_wd_params(const double* a, int nr, int nz, int npsi) {
  WdParams<T> q;
  q.p = make_params<T>(a, nr, nz, npsi);
  q.ell = T(a[17]);
#pragma unroll
  for (int k = 0; k < kWeideman; ++k) q.a[k] = T(a[18 + k]);
  return q;
}

template <typename T>
WdLeaves<T> wd_leaves(void* const* in) {
  WdLeaves<T> st;
#pragma unroll
  for (int k = 0; k < kWdLeaves; ++k) st.in[k] = static_cast<const T*>(in[k]);
  return st;
}

inline unsigned wd_blocks(long long n) {
  return static_cast<unsigned>((n + kWdThreads - 1) / kWdThreads);
}

template <typename T>
int launch_weak_damping(long long n, void* const* in, const void* psi,
                        int nr, int nz, const void* prof, int npsi,
                        const double* params, void* out,
                        cudaStream_t stream) {
  weak_damping_kernel<T><<<wd_blocks(n), kWdThreads, 0, stream>>>(
      wd_leaves<T>(in), static_cast<const T*>(psi),
      static_cast<const T*>(prof), make_wd_params<T>(params, nr, nz, npsi),
      static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_weak_damping_vjp(long long n, void* const* in, const void* ct,
                            const void* psi, int nr, int nz, const void* prof,
                            int npsi, const double* params, void* dleaves,
                            void* dpsi, void* cell, cudaStream_t stream) {
  weak_damping_vjp_kernel<T><<<wd_blocks(n), kWdThreads, 0, stream>>>(
      wd_leaves<T>(in), static_cast<const T*>(ct),
      static_cast<const T*>(psi), static_cast<const T*>(prof),
      make_wd_params<T>(params, nr, nz, npsi), static_cast<T*>(dleaves),
      static_cast<T*>(dpsi), static_cast<long long*>(cell), n);
  return static_cast<int>(cudaGetLastError());
}

inline bool bad_wd_args(long long n, int nr, int nz, int npsi) {
  return n < 1 || nr < 1 || nz < 1 || npsi < 1 ||
         (n + kWdThreads - 1) / kWdThreads >= (1LL << 31);
}

}  // namespace

}  // namespace gft

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes by kernels/build.py)
// ---------------------------------------------------------------------------

// kamp of n real rays over an EFIT equilibrium.
//   dtype: 0 = float, 1 = double;
//   in: 7 pointers to (n,) leaves w, x, y, z, kx, ky, kz, n >= 1;
//   psi: the (nr, nz, 4, 4) cell-local psi table; prof: the (npsi, 4, 4)
//     fused profile table (gft_efit_window's);
//   params: gft_efit_window's 17 (dt unused), Weideman's L, then his 64
//     coefficients in Horner order;
//   out: (n, 2), kamp's (re, im).
// Launches on `stream` and returns at once: 0, a cudaError_t from the
// launch, or -1 for an argument the kernel does not take.
extern "C" int gft_weak_damping(int dtype, long long n, void* const* in,
                                const void* psi, int nr, int nz,
                                const void* prof, int npsi,
                                const double* params, void* out,
                                void* stream) {
  if (gft::bad_wd_args(n, nr, nz, npsi)) return gft::kInvalidArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gft::launch_weak_damping<float>(n, in, psi, nr, nz, prof, npsi,
                                           params, out, st);
  if (dtype == 1)
    return gft::launch_weak_damping<double>(n, in, psi, nr, nz, prof, npsi,
                                            params, out, st);
  return gft::kInvalidArgument;
}

// The VJP of gft_weak_damping for kamp's cotangent ct, (n, 2) (re, im)
// pairs: dleaves, (7, n), receives the cotangents of w, x, y, z, kx, ky, kz;
// dpsi, (n, 16), each ray's psi-block cotangents, and cell, (n,) int64, the
// row of its block in the (nr * nz, 16) table: both null, or both given.
// The other arguments and the return code as gft_weak_damping's.
extern "C" int gft_weak_damping_vjp(int dtype, long long n, void* const* in,
                                    const void* ct, const void* psi, int nr,
                                    int nz, const void* prof, int npsi,
                                    const double* params, void* dleaves,
                                    void* dpsi, void* cell, void* stream) {
  if (gft::bad_wd_args(n, nr, nz, npsi) || (dpsi == nullptr) != (cell == nullptr))
    return gft::kInvalidArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gft::launch_weak_damping_vjp<float>(n, in, ct, psi, nr, nz, prof,
                                               npsi, params, dleaves, dpsi,
                                               cell, st);
  if (dtype == 1)
    return gft::launch_weak_damping_vjp<double>(n, in, ct, psi, nr, nz, prof,
                                                npsi, params, dleaves, dpsi,
                                                cell, st);
  return gft::kInvalidArgument;
}
