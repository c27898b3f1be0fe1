// The gradient of D by a reverse sweep written by hand, and the stepping
// templates built on it, for every window kernel: the forward window K1
// (efit_window.cuh) and the backward kernels K2 and K3 (efit_window_bwd.cuh).
//
// efit_adjoint<Disp, S> is one EFIT field front and one dispersion tail.
// The front runs, in the plain version's operation order, the bicubic jet
// (with its second derivatives d2/du2, d2/dudv, d2/dv2, which the sweep
// back needs), the profiles and B, and hands the tail w, kvec, ne, te and
// B.  The tail Disp (ColdPlasma, OrdinaryWave, ExtraOrdinaryWave below)
// runs D's own operations after those - from wpe2 = ne kpe and, for cold
// plasma, the ion term wpi2 = te kpi (the ion density is the te profile,
// the reference's ni = te quirk) - and its sweep back from dD = 1, giving
// D's partials over w and kvec and the adjoints of wpe2, wpi2 and B; the
// front then sweeps those back through B, the profiles and the jet.  In
// all it gives:
//   g[7]   the partials of D over (w, x, y, z, kx, ky, kz);
//   b[6]   the adjoints of the six quantities through which D depends on
//          the coefficient blocks: the bicubic value and its u and v
//          derivatives, then the ne, te and fpol profile values;
//   uvp[3] the cell-local coordinates (u, v, up) on which the blocks'
//          weights u^a v^b and up^k depend.
// A tail whose D does not read te (Disp::kUsesTe false: the O and X modes)
// leaves the te profile unevaluated and its adjoint b[4] zero.
//
// S is T for the gradient alone, or Dual<T, 1> for forward over reverse:
// with the inputs' tangents seeded with a direction v, the tangent of g is
// H v (H the Hessian of D) and that of b the derivative of b along v.  One
// tangent carries two values where nested duals carried 16 (28 with the
// table tangents).
//
// F is any view of the ray's frozen blocks with psi_coef / prof_coef and
// the cell indices iu, jv, pidx (Frozen<T>, efit_common.cuh, or the
// backward kernels' SharedBlocks<T>).  Pressure and the ion temperature do
// not enter any of the three D and are not evaluated; D itself is not
// formed (only its partials are needed).  Every division is a product with
// a reciprocal, where the plain version divides.

#pragma once

#include "efit_common.cuh"

namespace gft {

// One species' term of e11 and e12 (cold_plasma_D: (wp2/w2)/den and
// ((c/w)(wp2/w2))/den, den = 1 - c^2/w2) and its sweep back; iw and iw2
// are 1/w and 1/w2.
template <typename S>
struct Species {
  S a, q, cc_w2, iden, t11, t12;

  __device__ __forceinline__ Species(const S& wp2, const S& c, const S& iw,
                                     const S& iw2) {
    a = wp2 * iw2;
    q = c * iw;
    cc_w2 = c * c * iw2;
    iden = recip(scalar_t<S>(1) - cc_w2);
    t11 = a * iden;
    t12 = (q * a) * iden;
  }

  // From dD/dt11 and dD/dt12: adds to the adjoints of w and w2 and returns
  // that of c (through q and den) and, in wp2_b, that of wp2 (without the
  // e33 part).
  __device__ __forceinline__ S back(const S& c11, const S& c12, const S& c,
                                    const S& iw, const S& iw2, S& w_b,
                                    S& w2_b, S& wp2_b) const {
    const S den_b = -(c11 * t11 + c12 * t12) * iden;
    const S a_b = (c11 + c12 * q) * iden;
    const S q_b = c12 * a * iden;
    w_b = w_b - q_b * q * iw;
    w2_b = w2_b + (den_b * cc_w2 - a_b * a) * iw2;
    wp2_b = a_b * iw2;
    return q_b * iw - scalar_t<S>(2) * c * den_b * iw2;
  }
};

// ---------------------------------------------------------------------------
// the dispersion tails: from (w, kvec, ne, te, B) to D's partials over w and
// kvec (g[0], g[4..6]) and the adjoints of wpe2 = ne kpe, wpi2 = te kpi
// (the ion term) and B
// ---------------------------------------------------------------------------

// n = k / w, bh = B / |B| and npara = bh . n, and their sweeps back.
template <typename S>
struct Refraction {
  S ib, n[3], bh[3], npara;

  __device__ __forceinline__ Refraction(const S& iw, const S k[3],
                                        const S bv[3], const S& b_len) {
    ib = recip(b_len);
#pragma unroll
    for (int i = 0; i < 3; ++i) n[i] = k[i] * iw;
#pragma unroll
    for (int i = 0; i < 3; ++i) bh[i] = bv[i] * ib;
    npara = bh[0] * n[0] + bh[1] * n[1] + bh[2] * n[2];
  }

  // From n_b = dD/dn: D's partials over k (g[4..6]); returns the adjoint
  // of w through n.
  __device__ __forceinline__ S k_back(const S n_b[3], const S& iw,
                                      S g[7]) const {
#pragma unroll
    for (int i = 0; i < 3; ++i) g[4 + i] = n_b[i] * iw;
    return -((n_b[0] * n[0] + n_b[1] * n[1] + n_b[2] * n[2]) * iw);
  }

  // bb = dD/dB from dD/dnpara and blen_b, the adjoint of |B| from all but
  // bh (bh's own part is added here)
  __device__ __forceinline__ void b_back(const S& npara_b, const S& blen_b,
                                         S bb[3]) const {
    const S blen = blen_b - npara_b * npara * ib;
#pragma unroll
    for (int i = 0; i < 3; ++i) bb[i] = npara_b * n[i] * ib + blen * bh[i];
  }

  // the same where |B| enters D through bh alone
  __device__ __forceinline__ void b_back(const S& npara_b, S bb[3]) const {
    const S blen = -(npara_b * npara * ib);
#pragma unroll
    for (int i = 0; i < 3; ++i) bb[i] = npara_b * n[i] * ib + blen * bh[i];
  }
};

// The sweep of nperp2 = |n|^2 - npara^2 entering D with -1 (the O and X
// modes): dD/dn = 2 npara bh - 2 n.  Returns the adjoint of w through n and
// fills g[4..6] and bb; blen_b, where given, is the adjoint of |B| through
// the rest of D (the X mode's wce), as in Refraction::b_back.
template <typename S, typename... Blen>
__device__ __forceinline__ S minus_nperp2_back(const Refraction<S>& r,
                                               const S& iw, S g[7], S bb[3],
                                               const Blen&... blen_b) {
  const S npara_b = scalar_t<S>(2) * r.npara;
  S n_b[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    n_b[i] = npara_b * r.bh[i] - scalar_t<S>(2) * r.n[i];
  r.b_back(npara_b, blen_b..., bb);
  return r.k_back(n_b, iw, g);
}

// models/dispersion.py cold_plasma, electrons and the one ion species:
// D = (m11 m22 - m12^2) m33 - m22 m13_sq.  The operations keep the order of
// the cold-plasma sweep this tail was split from, so that the kernels
// compile as before: nvcc gave the same operations in another order 2-3
// more registers.
struct ColdPlasma {
  static constexpr bool kUsesTe = true;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S& w, const S k[3], const S& ne, const S& te, const S bv[3],
      const Params<T>& p, S g[7], S& wpe2_b, S& wpi2_b, S bb[3]) {
    // dielectric elements (electrons, then the ion species; ni = te)
    const S wpe2 = ne * p.kpe;
    const S b_len = gsqrt(bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2]);
    const S ib = recip(b_len);
    const S ec = b_len * p.kce;
    const S iw = recip(w);
    const S iw2 = iw * iw;
    const Species<S> el(wpe2, ec, iw, iw2);
    const S wpi2 = te * p.kpi;
    const S ic = b_len * p.kci;
    const Species<S> io(wpi2, ic, iw, iw2);
    const S e11 = (T(1) - el.t11) - io.t11;
    const S m12 = -(el.t12 + io.t12);
    const S e33w = (wpe2 + wpi2) * iw2;   // e33 = 1 - e33w

    const S n[3] = {k[0] * iw, k[1] * iw, k[2] * iw};
    const S bh[3] = {bv[0] * ib, bv[1] * ib, bv[2] * ib};
    const S n2 = n[0] * n[0] + n[1] * n[1] + n[2] * n[2];
    const S npara = bh[0] * n[0] + bh[1] * n[1] + bh[2] * n[2];
    const S npara2 = npara * npara;
    const S nperp2 = n2 - npara2;
    const S m11 = e11 - npara2;
    const S m13_sq = npara2 * nperp2;
    const S m22 = e11 - n2;
    const S m33 = (T(1) - e33w) - nperp2;

    // ---- the sweep back from dD = 1 ----
    const S m33_b = m11 * m22 - m12 * m12;
    const S m11_b = m22 * m33;
    const S m22_b = m11 * m33 - m13_sq;
    const S c12 = T(2) * m12 * m33;   // dD/dt12 = -dD/dm12
    const S m13_b = -m22;
    const S nperp2_b = m13_b * npara2 - m33_b;
    const S n2_b = nperp2_b - m22_b;
    const S npara_b = T(2) * npara * ((m13_b * nperp2 - m11_b) - nperp2_b);

    // n_i = k_i / w and bh_i = b_i / b_len
    S n_b[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      n_b[i] = npara_b * bh[i] + T(2) * n2_b * n[i];
      g[4 + i] = n_b[i] * iw;
    }
    S w_b = -((n_b[0] * n[0] + n_b[1] * n[1] + n_b[2] * n[2]) * iw);

    // e11 = 1 - t11e - t11i, e33 = 1 - (wpe2 + wpi2) / w2
    const S c11 = -(m11_b + m22_b);
    S w2_b = m33_b * e33w * iw2;
    const S e33_b = -m33_b * iw2;
    const S ec_b = el.back(c11, c12, ec, iw, iw2, w_b, w2_b, wpe2_b);
    const S ic_b = io.back(c11, c12, ic, iw, iw2, w_b, w2_b, wpi2_b);
    wpe2_b = wpe2_b + e33_b;
    wpi2_b = wpi2_b + e33_b;
    g[0] = w_b + T(2) * w * w2_b;

    // b_len: its own adjoint from the cyclotron frequencies and bh
    const S blen_b = ec_b * p.kce + ic_b * p.kci - npara_b * npara * ib;
#pragma unroll
    for (int i = 0; i < 3; ++i) bb[i] = npara_b * n[i] * ib + blen_b * bh[i];
  }
};

// models/dispersion.py ordinary_wave: D = 1 - wpe2 / w^2 - nperp2.
struct OrdinaryWave {
  static constexpr bool kUsesTe = false;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S& w, const S k[3], const S& ne, const S&, const S bv[3],
      const Params<T>& p, S g[7], S& wpe2_b, S&, S bb[3]) {
    const S wpe2 = ne * p.kpe;
    const S b_len = gsqrt(bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2]);
    const S iw = recip(w);
    const S iw2 = iw * iw;
    const Refraction<S> r(iw, k, bv, b_len);
    // -wpe2 / w^2: dD/dwpe2 = -1/w^2 and dD/dw = 2 wpe2 / w^3
    const S w_b = minus_nperp2_back(r, iw, g, bb);
    wpe2_b = -iw2;
    g[0] = w_b + T(2) * (wpe2 * iw2) * iw;
  }
};

// models/dispersion.py extra_ordinary_wave: D = 1 - X - nperp2 with
// X = (wpe2 / w^2) (w^2 - wpe2) / (w^2 - wh2), wh2 = wpe2 + wce^2.  The
// upper hybrid pole w^2 = wh2 is the caller's to keep clear of.
struct ExtraOrdinaryWave {
  static constexpr bool kUsesTe = false;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S& w, const S k[3], const S& ne, const S&, const S bv[3],
      const Params<T>& p, S g[7], S& wpe2_b, S&, S bb[3]) {
    const S wpe2 = ne * p.kpe;
    const S b_len = gsqrt(bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2]);
    const S wce = b_len * p.kce;
    const S iw = recip(w);
    const S iw2 = iw * iw;
    const S w2 = w * w;
    const S a = wpe2 * iw2;
    const S pm = w2 - wpe2;
    const S iq = recip(w2 - (wpe2 + wce * wce));
    const S x = (a * pm) * iq;
    const Refraction<S> r(iw, k, bv, b_len);

    // ---- the sweep back from dD = 1 (dD/dX = -1) ----
    const S a_b = -(pm * iq);
    const S pm_b = -(a * iq);
    const S q_b = x * iq;
    const S w2_b = (pm_b + q_b) - a_b * a * iw2;
    wpe2_b = (a_b * iw2 - pm_b) - q_b;
    const S wce_b = -(T(2) * q_b * wce);
    g[0] = minus_nperp2_back(r, iw, g, bb, wce_b * p.kce) +
           T(2) * w * w2_b;
  }
};

// The field front, the tail Disp and the front's sweep back (see the top of
// this file).
template <typename Disp, typename S, typename T, typename F>
__device__ __forceinline__ void efit_adjoint(const S st[7], const F& f,
                                             const Params<T>& p, S g[7],
                                             S b[6], S uvp[3]) {
  const S& w = st[0];
  const S& x = st[1];
  const S& y = st[2];
  const S& z = st[3];
  // every division is a product with one of these reciprocals
  const T idr = T(1) / p.dr, idz = T(1) / p.dz, idpsi = T(1) / p.dpsi;
  const S r = gsqrt(x * x + y * y);
  const S ir = recip(r);
  const S u = (r - p.rmin) * idr - f.iu;
  const S v = (z - p.zmin) * idz - f.jv;

  // bicubic jet, streamed from a = 3 down, with the second derivatives
  // duu, duv (= dvu) and dvv beside it
  S val, dval_du, dval_dv, duu, duv, dvv;
#pragma unroll
  for (int a = 3; a >= 0; --a) {
    T c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = psi_coef(f, 4 * a + j);
    const S ca = c[0] + v * (c[1] + v * (c[2] + v * c[3]));
    const S cb = c[1] + v * (T(2) * c[2] + T(3) * v * c[3]);
    const S cc = T(2) * c[2] + T(6) * v * c[3];
    if (a == 3) {
      val = ca;
      dval_du = T(3) * u * ca;
      dval_dv = cb;
      duu = T(6) * u * ca;
      duv = T(3) * u * cb;
      dvv = cc;
    } else {
      val = ca + u * val;
      if (a == 2) {
        dval_du = T(2) * ca + dval_du;
        duu = T(2) * ca + duu;
        duv = T(2) * cb + duv;
      }
      if (a == 1) {
        dval_du = ca + u * dval_du;
        duv = cb + u * duv;
      }
      dval_dv = cb + u * dval_dv;
      dvv = cc + u * dvv;
    }
  }
  const S psi_r = dval_du * idr;
  const S psi_z = dval_dv * idz;

  // profiles at the frozen cell, with their derivatives in up
  const S up = (val - p.psimin) * idpsi - f.pidx;
  T q[16];   // the ne, te and fpol rows (pressure does not enter D)
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < 4 || (Disp::kUsesTe && k < 8) || k >= 12) q[k] = prof_coef(f, k);
  const S ne_v = q[0] + up * (q[1] + up * (q[2] + up * q[3]));
  S te_v{}, dte{};   // zero, and never read, where D does not take te
  if constexpr (Disp::kUsesTe)
    te_v = q[4] + up * (q[5] + up * (q[6] + up * q[7]));
  const S fpol = q[12] + up * (q[13] + up * (q[14] + up * q[15]));
  const S dne = q[1] + up * (T(2) * q[2] + T(3) * up * q[3]);
  if constexpr (Disp::kUsesTe)
    dte = q[5] + up * (T(2) * q[6] + T(3) * up * q[7]);
  const S dfp = q[13] + up * (T(2) * q[14] + T(3) * up * q[15]);
  const S ne = p.ne_scale * ne_v;
  S te{};
  if constexpr (Disp::kUsesTe) te = p.te_scale * te_v;

  // B (models/efit.py _magnetic_field)
  const S br = psi_z * ir;
  const S bp = fpol * ir;
  const S bz = -psi_r * ir;
  const S cphi = x * ir;
  const S sphi = y * ir;
  const S bv[3] = {br * cphi - bp * sphi, br * sphi + bp * cphi, bz};

  S wpe2_b, wpi2_b, bb[3];
  Disp::adjoint(w, st + 4, ne, te, bv, p, g, wpe2_b, wpi2_b, bb);

  // B from psi_r, psi_z, fpol and the angle
  const S br_b = bb[0] * cphi + bb[1] * sphi;
  const S bp_b = bb[1] * cphi - bb[0] * sphi;
  const S cphi_b = bb[0] * br + bb[1] * bp;
  const S sphi_b = bb[1] * br - bb[0] * bp;
  b[1] = -bb[2] * ir * idr;   // dval_du (through psi_r)
  b[2] = br_b * ir * idz;      // dval_dv (through psi_z)
  b[5] = bp_b * ir;            // fpol
  b[3] = wpe2_b * p.kpe * p.ne_scale;
  if constexpr (Disp::kUsesTe) {
    b[4] = wpi2_b * p.kpi * p.te_scale;
    b[0] = (b[3] * dne + b[4] * dte + b[5] * dfp) * idpsi;   // val
  } else {
    b[4] = S{};
    b[0] = (b[3] * dne + b[5] * dfp) * idpsi;
  }

  // the bicubic's u and v, then r and the position
  const S u_b = b[0] * dval_du + b[1] * duu + b[2] * duv;
  const S v_b = b[0] * dval_dv + b[1] * duv + b[2] * dvv;
  const S r_b = u_b * idr - (br_b * br + bp_b * bp + bb[2] * bz +
                             cphi_b * cphi + sphi_b * sphi) * ir;
  g[1] = cphi_b * ir + r_b * cphi;
  g[2] = sphi_b * ir + r_b * sphi;
  g[3] = v_b * idz;
  uvp[0] = u;
  uvp[1] = v;
  uvp[2] = up;
}

// D's gradient for the stepping templates below, by the hand-written
// adjoint of the dispersion Disp: the seven partials of D at the state s,
// and the RHS (-D_k, D_x) / D_w from them with one division.
template <typename Disp>
struct AdjointGrad {
  template <typename T>
  static __device__ __forceinline__ void rhs(const T g[7], T out[6]) {
    const T iw = T(1) / g[0];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[j] = -g[4 + j] * iw;
      out[3 + j] = g[1 + j] * iw;
    }
  }

  template <typename T, typename F>
  static __device__ __forceinline__ void grad(const T s[8], const F& f,
                                              const Params<T>& p, T g[7]) {
    const T st[7] = {s[ST_W], s[ST_X], s[ST_Y], s[ST_Z],
                     s[ST_KX], s[ST_KY], s[ST_KZ]};
    T b[6], uvp[3];
    efit_adjoint<Disp>(st, f, p, g, b, uvp);
  }
};

// ---------------------------------------------------------------------------
// the stepping templates of every window kernel: K1's substeps
// (efit_window.cuh) and the forward sweeps of K2 and K3 (efit_window_bwd.cuh),
// for the dispersion Disp over any view F of the ray's frozen blocks
// ---------------------------------------------------------------------------

// models/rays.py make_ray_rhs: (dx, dy, dz, dkx, dky, dkz)/dt =
// (-D_k, D_x) / D_w at the state s
template <typename Disp, typename T, typename F>
__device__ __forceinline__ void ray_rhs(const T s[8], const F& f,
                                        const Params<T>& p, T out[6]) {
  T g[7];
  AdjointGrad<Disp>::grad(s, f, p, g);
  AdjointGrad<Disp>::rhs(g, out);
}

// the unfolded rk2/rk4 increments of the six integrated leaves
// (ops/integrators.py _rk2_sum/_rk4_sum)
template <typename Disp, typename T, int METHOD, typename F>
__device__ __forceinline__ void increment(const T s[8], const F& f,
                                          const Params<T>& p, T inc[6]) {
  T d1[6], d2[6], st[8];
  ray_rhs<Disp>(s, f, p, d1);
  if (METHOD == 2) {
    shift(s, d1, p.dt, st);
    ray_rhs<Disp>(st, f, p, d2);
#pragma unroll
    for (int j = 0; j < 6; ++j) inc[j] = p.half * (d1[j] + d2[j]);
  } else {
    T d3[6];
    shift(s, d1, p.half, st);
    ray_rhs<Disp>(st, f, p, d2);
    shift(s, d2, p.half, st);
    ray_rhs<Disp>(st, f, p, d3);
#pragma unroll
    for (int j = 0; j < 6; ++j) d2[j] = d2[j] + d3[j];
    shift(s, d3, p.dt, st);
    ray_rhs<Disp>(st, f, p, d3);   // d4
#pragma unroll
    for (int j = 0; j < 6; ++j)
      inc[j] = p.sixth * (d1[j] + T(2) * d2[j] + d3[j]);
  }
}

// one plain substep in place (t advances by dt, w stays)
template <typename Disp, typename T, int METHOD, typename F>
__device__ __forceinline__ void substep(T s[8], const F& f,
                                        const Params<T>& p) {
  T inc[6];
  increment<Disp, T, METHOD>(s, f, p, inc);
  s[ST_T] = s[ST_T] + p.dt;
#pragma unroll
  for (int j = 0; j < 6; ++j) s[ST_X + j] = s[ST_X + j] + inc[j];
}

}  // namespace gft
