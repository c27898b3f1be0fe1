// The gradient of D by a reverse sweep written by hand, and the stepping
// templates built on it, for every window kernel: the forward window K1
// (efit_window.cuh) and the backward kernels K2 and K3 (efit_window_bwd.cuh).
//
// efit_adjoint<Disp, S> is one EFIT field front and one dispersion tail.
// A tail is one of two shapes, by Disp::kReadsEq:
//
//   * a plasma tail (kReadsEq true: cold_plasma, ordinary_wave,
//     extra_ordinary_wave, cold_plasma_expansion, bohm_gross, light_wave,
//     ion_cyclotron, acoustic_wave) reads the equilibrium.  The front runs,
//     in the plain version's operation order, the bicubic jet (with its
//     second derivatives d2/du2, d2/dudv, d2/dv2, which the sweep back
//     needs), the profiles and B, and hands the tail w, kvec and the
//     plasma at the ray: ne, te, the pressure and B.  The tail runs D's
//     own operations after those and its sweep back from dD = 1, giving
//     D's partials over w and kvec and the adjoints of ne, te, the
//     pressure and B; the front then sweeps those back through B, the
//     profiles and the jet.  None of these D reads the position or t
//     other than through the plasma.
//   * an analytic tail (kReadsEq false: simple, gaussian_well, stiff)
//     reads no table: it maps (w, kvec, position, t) to all seven partials
//     itself and to D's partial over t.  The front, the freeze gather and
//     the block reads are skipped; b and uvp are not set, and there is no
//     K3 for such a tail (its tables take no gradient).
//
// In all it gives:
//   g[7]   the partials of D over (w, x, y, z, kx, ky, kz), and *g_t over t
//          (set by a tail whose D reads t, Disp::kUsesT: stiff, where the
//          caller asks for it);
//   b[7]   the adjoints of the seven quantities through which D depends on
//          the coefficient blocks: the bicubic value and its u and v
//          derivatives, then the ne, te, fpol and pressure profile values;
//   uvp[3] the cell-local coordinates (u, v, up) on which the blocks'
//          weights u^a v^b and up^k depend.
// The front evaluates the te profile only for a tail that reads te
// (Disp::kUsesTe) and the pressure only for one that reads it
// (Disp::kUsesPres: the ion temperature of acoustic_wave and
// ion_cyclotron, ti = (pres - ne te q) / (te q) with the reference's
// rounded q and its ni = te quirk); an adjoint it does not evaluate is zero.
//
// S is T for the gradient alone, or Dual<T, 1> for forward over reverse:
// with the inputs' tangents seeded with a direction v, the tangent of g is
// H v (H the Hessian of D) and that of b the derivative of b along v.  One
// tangent carries two values where nested duals carried 16 (28 with the
// table tangents).
//
// F is any view of the ray's frozen blocks with psi_coef / prof_coef and
// the cell indices iu, jv, pidx (Frozen<T>, efit_common.cuh, or the
// backward kernels' SharedBlocks<T>).  D itself is not formed (only its
// partials are needed).  Every division is a product with a reciprocal,
// where the plain version divides.

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
// the plasma tails: from (w, kvec, ne, te, pres, B) to D's partials over w
// and kvec (g[0], g[4..6]) and the adjoints of ne, te, pres and B
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
  static constexpr bool kReadsEq = true, kUsesTe = true, kUsesPres = false,
                        kUsesT = false;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S& w, const S k[3], const S& ne, const S& te, const S&,
      const S bv[3], const Params<T>& p, S g[7], S& ne_b, S& te_b, S&,
      S bb[3]) {
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
    S wpe2_b, wpi2_b;
    const S ec_b = el.back(c11, c12, ec, iw, iw2, w_b, w2_b, wpe2_b);
    const S ic_b = io.back(c11, c12, ic, iw, iw2, w_b, w2_b, wpi2_b);
    ne_b = (wpe2_b + e33_b) * p.kpe;
    te_b = (wpi2_b + e33_b) * p.kpi;
    g[0] = w_b + T(2) * w * w2_b;

    // b_len: its own adjoint from the cyclotron frequencies and bh
    const S blen_b = ec_b * p.kce + ic_b * p.kci - npara_b * npara * ib;
#pragma unroll
    for (int i = 0; i < 3; ++i) bb[i] = npara_b * n[i] * ib + blen_b * bh[i];
  }
};

// models/dispersion.py ordinary_wave: D = 1 - wpe2 / w^2 - nperp2.
struct OrdinaryWave {
  static constexpr bool kReadsEq = true, kUsesTe = false, kUsesPres = false,
                        kUsesT = false;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S& w, const S k[3], const S& ne, const S&, const S&,
      const S bv[3], const Params<T>& p, S g[7], S& ne_b, S&, S&,
      S bb[3]) {
    const S wpe2 = ne * p.kpe;
    const S b_len = gsqrt(bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2]);
    const S iw = recip(w);
    const S iw2 = iw * iw;
    const Refraction<S> r(iw, k, bv, b_len);
    // -wpe2 / w^2: dD/dwpe2 = -1/w^2 and dD/dw = 2 wpe2 / w^3
    const S w_b = minus_nperp2_back(r, iw, g, bb);
    ne_b = -iw2 * p.kpe;
    g[0] = w_b + T(2) * (wpe2 * iw2) * iw;
  }
};

// models/dispersion.py extra_ordinary_wave: D = 1 - X - nperp2 with
// X = (wpe2 / w^2) (w^2 - wpe2) / (w^2 - wh2), wh2 = wpe2 + wce^2.  The
// upper hybrid pole w^2 = wh2 is the caller's to keep clear of.
struct ExtraOrdinaryWave {
  static constexpr bool kReadsEq = true, kUsesTe = false, kUsesPres = false,
                        kUsesT = false;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S& w, const S k[3], const S& ne, const S&, const S&,
      const S bv[3], const Params<T>& p, S g[7], S& ne_b, S&, S&,
      S bb[3]) {
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
    ne_b = ((a_b * iw2 - pm_b) - q_b) * p.kpe;
    const S wce_b = -(T(2) * q_b * wce);
    g[0] = minus_nperp2_back(r, iw, g, bb, wce_b * p.kce) +
           T(2) * w * w2_b;
  }
};


// k_par^2 along B, or |k|^2 where B = 0 (models/dispersion.py _kpar2:
// bohm_gross, acoustic_wave), and its sweep back.  The select is taken on
// the value of |B|^2, and the sweep back follows the branch taken.
template <typename S>
struct ParallelK2 {
  S bk, ib2, kpar2;
  bool vacuum;

  __device__ __forceinline__ ParallelK2(const S k[3], const S bv[3]) {
    const S b2 = bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2];
    vacuum = value_of(b2) == scalar_t<S>(0);
    if (vacuum) {
      kpar2 = k[0] * k[0] + k[1] * k[1] + k[2] * k[2];
    } else {
      bk = bv[0] * k[0] + bv[1] * k[1] + bv[2] * k[2];
      ib2 = recip(b2);
      kpar2 = (bk * bk) * ib2;
    }
  }

  // From kpar2_b = dD/dkpar2: D's partials over k (g[4..6]) and bb.
  __device__ __forceinline__ void back(const S& kpar2_b, const S k[3],
                                       const S bv[3], S g[7],
                                       S bb[3]) const {
    if (vacuum) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        g[4 + i] = scalar_t<S>(2) * kpar2_b * k[i];
        bb[i] = S{};
      }
    } else {
      const S bk_b = scalar_t<S>(2) * (kpar2_b * bk) * ib2;
      const S b2_b = -(kpar2_b * kpar2) * ib2;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        g[4 + i] = bk_b * bv[i];
        bb[i] = bk_b * k[i] + scalar_t<S>(2) * b2_b * bv[i];
      }
    }
  }
};

// The reference's rounded elementary charge in the ion temperature
// (models/efit.py Q_ROUNDED, equilibrium.hpp:1358-1362).
constexpr double kQRounded = 1.60218e-19;

// vs^2 = te q/(mi c^2) + ti 3q/(mi c^2) of the one ion species
// (models/dispersion.py _sound_speed2), with models/efit.py's ion
// temperature ti = (pres - ne te q) / (ni q), ni = te (the reference's
// quirk), taken as (pres / q - ne te) / te as the plain version takes it,
// and its sweep back.
template <typename S>
struct SoundSpeed2 {
  S ite, ti, vs2;

  template <typename T>
  __device__ __forceinline__ SoundSpeed2(const S& ne, const S& te,
                                         const S& pres, const Params<T>& p) {
    ite = recip(te);
    ti = (pres * T(1.0 / kQRounded) - ne * te) * ite;
    vs2 = te * p.kvs + ti * p.kvs3;
  }

  // From vs2_b = dD/dvs2: the adjoints of ne, te and pres.
  template <typename T>
  __device__ __forceinline__ void back(const S& vs2_b, const S& ne,
                                       const S& te, const Params<T>& p,
                                       S& ne_b, S& te_b, S& pres_b) const {
    const S ti_b = vs2_b * p.kvs3;
    const S num_b = ti_b * ite;
    pres_b = num_b * T(1.0 / kQRounded);
    ne_b = -(num_b * te);
    te_b = vs2_b * p.kvs - (num_b * ne + (ti_b * ti) * ite);
  }
};

// models/dispersion.py cold_plasma_expansion: the electron cold-plasma
// expansion Dc = -P/2 (1 + ec/w) Gamma0 + (1 - ec^2/w^2) Gamma1 with
// P = wpe2 / w^2 and q = P / (2 (1 + ec/w)).  Its cyclotron frequency has
// the charge +q (ec = |B| q/(me c) = -|B| kce, exactly), where cold_plasma
// and the X mode take -q.
struct ColdPlasmaExpansion {
  static constexpr bool kReadsEq = true, kUsesTe = false, kUsesPres = false,
                        kUsesT = false;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S& w, const S k[3], const S& ne, const S&, const S&,
      const S bv[3], const Params<T>& p, S g[7], S& ne_b, S&, S&,
      S bb[3]) {
    const S b_len = gsqrt(bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2]);
    const S ec = b_len * (-p.kce);
    const S wpe2 = ne * p.kpe;
    const S iw = recip(w);
    const S iw2 = iw * iw;
    const S P = wpe2 * iw2;
    const S eo = ec * iw;                 // ec / w
    const S a1 = T(1) + eo;
    const S ia = recip(a1);
    const S q = (T(0.5) * P) * ia;
    const Refraction<S> r(iw, k, bv, b_len);
    const S n2 = r.n[0] * r.n[0] + r.n[1] * r.n[1] + r.n[2] * r.n[2];
    const S npara2 = r.npara * r.npara;
    const S nperp2 = n2 - npara2;
    const S omq = T(1) - q;
    const S q_func = T(1) - T(2) * q;
    const S n_func = n2 + npara2;
    const S p_func = T(1) - P;
    const S x1 = n2 * npara2 - omq * n_func;
    const S y1 = p_func - nperp2;
    const S gamma1 = omq * (n2 * nperp2) + p_func * x1 + q_func * y1;
    const S gamma0 = nperp2 * (n2 - T(2) * q_func) +
                     p_func * (T(2) * q_func - n_func);
    const S amp = -(T(0.5) * P) * a1;    // -P/2 (1 + ec/w)
    const S bc = T(1) - eo * eo;          // 1 - ec^2/w^2

    // ---- the sweep back from dD = 1: D = amp gamma0 + bc gamma1 ----
    const S omq_b = bc * (n2 * nperp2 - p_func * n_func);
    const S p_func_b = bc * (x1 + q_func) + amp * (T(2) * q_func - n_func);
    const S q_func_b = bc * y1 + amp * (T(2) * (p_func - nperp2));
    const S n_func_b = -((bc * omq + amp) * p_func);
    const S nperp2_b = bc * (omq * n2 - q_func) + amp * (n2 - T(2) * q_func);
    const S n2_b = (bc * (omq * nperp2 + p_func * npara2) + amp * nperp2) +
                   n_func_b + nperp2_b;
    const S npara2_b = (bc * (p_func * n2) + n_func_b) - nperp2_b;
    const S q_b = -(T(2) * q_func_b + omq_b);
    const S P_b = (T(0.5) * q_b) * ia - p_func_b - (T(0.5) * gamma0) * a1;
    const S a1_b = -(q_b * q) * ia - (T(0.5) * gamma0) * P;
    const S eo_b = a1_b - T(2) * gamma1 * eo;
    const S npara_b = T(2) * npara2_b * r.npara;
    S n_b[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      n_b[i] = npara_b * r.bh[i] + T(2) * n2_b * r.n[i];
    const S w_b = r.k_back(n_b, iw, g);
    r.b_back(npara_b, (eo_b * iw) * (-p.kce), bb);
    ne_b = (P_b * iw2) * p.kpe;
    g[0] = w_b - ((eo_b * eo) * iw + T(2) * (P_b * P) * iw);
  }
};

// models/dispersion.py bohm_gross: D = wpe2 + 3/2 kpar2 vth2 - w^2 with
// vth2 = te 2q/(me c^2) and kpar2 of ParallelK2.
struct BohmGross {
  static constexpr bool kReadsEq = true, kUsesTe = true, kUsesPres = false,
                        kUsesT = false;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S& w, const S k[3], const S&, const S& te, const S&,
      const S bv[3], const Params<T>& p, S g[7], S& ne_b, S& te_b, S&,
      S bb[3]) {
    const S vterm2 = te * p.kvt;
    const ParallelK2<S> kp(k, bv);
    kp.back(T(1.5) * vterm2, k, bv, g, bb);
    te_b = (T(1.5) * kp.kpar2) * p.kvt;
    ne_b = lift<S>(p.kpe);
    g[0] = -(T(2) * w);
  }
};

// models/dispersion.py light_wave: D = wpe2 + |k|^2 - w^2 (B does not
// enter: its adjoint is zero).
struct LightWave {
  static constexpr bool kReadsEq = true, kUsesTe = false, kUsesPres = false,
                        kUsesT = false;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S& w, const S k[3], const S&, const S&, const S&, const S[3],
      const Params<T>& p, S g[7], S& ne_b, S&, S&, S bb[3]) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[4 + i] = T(2) * k[i];
      bb[i] = S{};
    }
    ne_b = lift<S>(p.kpe);
    g[0] = -(T(2) * w);
  }
};

// models/dispersion.py ion_cyclotron: D = wce - kperp2 vs2 - w^2, as the
// reference writes it: wce to the first power, of the electron's charge -q
// (wce = |B| kce < 0), kperp2 = |k|^2 - (bh . k)^2 and vs2 of SoundSpeed2.
struct IonCyclotron {
  static constexpr bool kReadsEq = true, kUsesTe = true, kUsesPres = true,
                        kUsesT = false;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S& w, const S k[3], const S& ne, const S& te, const S& pres,
      const S bv[3], const Params<T>& p, S g[7], S& ne_b, S& te_b,
      S& pres_b, S bb[3]) {
    const SoundSpeed2<S> vs(ne, te, pres, p);
    const S b_len = gsqrt(bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2]);
    const S ib = recip(b_len);
    const S bh[3] = {bv[0] * ib, bv[1] * ib, bv[2] * ib};
    const S bk = bh[0] * k[0] + bh[1] * k[1] + bh[2] * k[2];
    const S kperp2 = (k[0] * k[0] + k[1] * k[1] + k[2] * k[2]) - bk * bk;

    // ---- the sweep back from dD = 1 ----
    const S kperp2_b = -vs.vs2;
    const S bk_b = -(T(2) * kperp2_b * bk);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      g[4 + i] = T(2) * kperp2_b * k[i] + bk_b * bh[i];
    // bh = B / |B|, and |B| through wce (dD/dwce = 1)
    const S blen = p.kce - bk_b * bk * ib;
#pragma unroll
    for (int i = 0; i < 3; ++i) bb[i] = bk_b * k[i] * ib + blen * bh[i];
    vs.back(-kperp2, ne, te, p, ne_b, te_b, pres_b);
    g[0] = -(T(2) * w);
  }
};

// models/dispersion.py acoustic_wave: D = kpar2 vs2 - w^2, kpar2 of
// ParallelK2 and vs2 of SoundSpeed2.  Near its root D is the difference of
// two nearly equal terms; its partials are not.
struct AcousticWave {
  static constexpr bool kReadsEq = true, kUsesTe = true, kUsesPres = true,
                        kUsesT = false;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S& w, const S k[3], const S& ne, const S& te, const S& pres,
      const S bv[3], const Params<T>& p, S g[7], S& ne_b, S& te_b,
      S& pres_b, S bb[3]) {
    const SoundSpeed2<S> vs(ne, te, pres, p);
    const ParallelK2<S> kp(k, bv);
    kp.back(vs.vs2, k, bv, g, bb);
    vs.back(kp.kpar2, ne, te, p, ne_b, te_b, pres_b);
    g[0] = -(T(2) * w);
  }
};

// ---------------------------------------------------------------------------
// the analytic tails: from (w, kvec, position, t) to all seven partials of
// D and its partial over t; they read no table
// ---------------------------------------------------------------------------

// |k|^2 / w^2's partials over w and kvec (simple, gaussian_well)
template <typename S>
__device__ __forceinline__ void vacuum_index_back(const S& w, const S k[3],
                                                  S g[7]) {
  const S iw = recip(w);
  const S iw2 = iw * iw;
  const S kk = k[0] * k[0] + k[1] * k[1] + k[2] * k[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) g[4 + i] = scalar_t<S>(2) * k[i] * iw2;
  g[0] = -(scalar_t<S>(2) * (kk * iw2) * iw);
}

// models/dispersion.py simple: D = |k|^2 / w^2 - 1.
struct Simple {
  static constexpr bool kReadsEq = false, kUsesTe = false, kUsesPres = false,
                        kUsesT = false;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S& w, const S k[3], const S[3], const S&, const Params<T>&,
      S g[7], S*) {
    vacuum_index_back(w, k, g);
    g[1] = g[2] = g[3] = S{};
  }
};

// models/dispersion.py gaussian_well: D = |k|^2 / w^2 - (1 - e / 2) with
// e = exp(-(x^2 + y^2) / 0.1), so dD/dx = -10 x e and dD/dy = -10 y e.
struct GaussianWell {
  static constexpr bool kReadsEq = false, kUsesTe = false, kUsesPres = false,
                        kUsesT = false;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S& w, const S k[3], const S pos[3], const S&, const Params<T>&,
      S g[7], S*) {
    vacuum_index_back(w, k, g);
    const S e = gexp(-((pos[0] * pos[0] + pos[1] * pos[1]) * T(10)));
    g[1] = -(T(10) * (pos[0] * e));
    g[2] = -(T(10) * (pos[1] * e));
    g[3] = S{};
  }
};

// models/dispersion.py stiff: D = (1e3 (x - e) - e) kx + w with e = exp(-t),
// the one D that reads t: dD/dt = kx (1e3 e + e).
struct Stiff {
  static constexpr bool kReadsEq = false, kUsesTe = false, kUsesPres = false,
                        kUsesT = true;

  template <typename S, typename T>
  static __device__ __forceinline__ void adjoint(
      const S&, const S k[3], const S pos[3], const S& t, const Params<T>&,
      S g[7], S* g_t) {
    const S e = gexp(-t);
    g[0] = lift<S>(T(1));
    g[1] = T(1e3) * k[0];
    g[2] = g[3] = S{};
    g[4] = T(1e3) * (pos[0] - e) - e;
    g[5] = g[6] = S{};
    if (g_t) *g_t = k[0] * (T(1e3) * e + e);
  }
};

// Every tail by the code the C interfaces take (gft_efit_window,
// gft_efit_window_bwd): X(code, tail) for each, in the order of
// kernels/efit_step.py KERNEL_TAILS.  The interfaces' switches, the
// instantiations' extern declarations and the host harnesses of
// tools/count_ops.py expand it.
#define GFT_DISPERSIONS(X)                                            \
  X(0, ColdPlasma) X(1, OrdinaryWave) X(2, ExtraOrdinaryWave)         \
  X(3, ColdPlasmaExpansion) X(4, BohmGross) X(5, LightWave)           \
  X(6, IonCyclotron) X(7, AcousticWave) X(8, Simple) X(9, GaussianWell) \
  X(10, Stiff)

// The field front, the plasma tail Disp and the front's sweep back (see
// the top of this file).
template <typename Disp, typename S, typename T, typename F>
__device__ __forceinline__ void field_adjoint(const S st[7], const F& f,
                                              const Params<T>& p, S g[7],
                                              S b[7], S uvp[3]) {
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
  T q[16];   // the ne, fpol and, where D reads them, te and pressure rows
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < 4 || (Disp::kUsesTe && k < 8) || (Disp::kUsesPres && k < 12) ||
        k >= 12)
      q[k] = prof_coef(f, k);
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
  S pres{}, dpres{};   // likewise where D does not take the pressure
  if constexpr (Disp::kUsesPres) {
    pres = p.pres_scale * (q[8] + up * (q[9] + up * (q[10] + up * q[11])));
    dpres = q[9] + up * (T(2) * q[10] + T(3) * up * q[11]);
  }

  // B (models/efit.py _magnetic_field)
  const S br = psi_z * ir;
  const S bp = fpol * ir;
  const S bz = -psi_r * ir;
  const S cphi = x * ir;
  const S sphi = y * ir;
  const S bv[3] = {br * cphi - bp * sphi, br * sphi + bp * cphi, bz};

  S ne_b, te_b, pres_b, bb[3];
  Disp::adjoint(w, st + 4, ne, te, pres, bv, p, g, ne_b, te_b, pres_b, bb);

  // B from psi_r, psi_z, fpol and the angle
  const S br_b = bb[0] * cphi + bb[1] * sphi;
  const S bp_b = bb[1] * cphi - bb[0] * sphi;
  const S cphi_b = bb[0] * br + bb[1] * bp;
  const S sphi_b = bb[1] * br - bb[0] * bp;
  b[1] = -bb[2] * ir * idr;   // dval_du (through psi_r)
  b[2] = br_b * ir * idz;      // dval_dv (through psi_z)
  b[5] = bp_b * ir;            // fpol
  b[3] = ne_b * p.ne_scale;
  if constexpr (Disp::kUsesPres) {
    b[4] = te_b * p.te_scale;
    b[6] = pres_b * p.pres_scale;
    b[0] = (b[3] * dne + b[4] * dte + b[6] * dpres + b[5] * dfp) * idpsi;
  } else if constexpr (Disp::kUsesTe) {
    b[4] = te_b * p.te_scale;
    b[6] = S{};
    b[0] = (b[3] * dne + b[4] * dte + b[5] * dfp) * idpsi;   // val
  } else {
    b[4] = b[6] = S{};
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

// D's partials at the point (w, x, y, z, kx, ky, kz) = st and time t, and
// the block adjoints: the field front and a plasma tail, or an analytic
// tail alone (see the top of this file).  *g_t is set where D reads t and
// g_t is not null.
template <typename Disp, typename S, typename T, typename F>
__device__ __forceinline__ void efit_adjoint(const S st[7], const S& t,
                                             const F& f, const Params<T>& p,
                                             S g[7], S* g_t, S b[7],
                                             S uvp[3]) {
  if constexpr (Disp::kReadsEq)
    field_adjoint<Disp>(st, f, p, g, b, uvp);
  else
    Disp::adjoint(st[0], st + 4, st + 1, t, p, g, g_t);
}

// D's gradient for the stepping templates below, by the hand-written
// adjoint of the dispersion Disp: the seven partials of D at the state s
// (D's partial over t is not needed here), and the RHS (-D_k, D_x) / D_w
// from them with one division.
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
    T b[7], uvp[3];
    efit_adjoint<Disp>(st, s[ST_T], f, p, g, static_cast<T*>(nullptr), b,
                       uvp);
  }
};

// The window-base freeze gather of a ray for the dispersion Disp: the
// blocks of its cells, or nothing where Disp reads no table.
template <typename Disp, typename T>
__device__ __forceinline__ Frozen<T> freeze_for(
    const T s[8], const T* __restrict__ psi_tab,
    const T* __restrict__ prof_tab, const Params<T>& p) {
  if constexpr (Disp::kReadsEq)
    return freeze(s, psi_tab, prof_tab, p);
  else
    return Frozen<T>{};
}

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
    shift<Disp::kUsesT>(s, d1, p.dt, st);
    ray_rhs<Disp>(st, f, p, d2);
#pragma unroll
    for (int j = 0; j < 6; ++j) inc[j] = p.half * (d1[j] + d2[j]);
  } else {
    T d3[6];
    shift<Disp::kUsesT>(s, d1, p.half, st);
    ray_rhs<Disp>(st, f, p, d2);
    shift<Disp::kUsesT>(s, d2, p.half, st);
    ray_rhs<Disp>(st, f, p, d3);
#pragma unroll
    for (int j = 0; j < 6; ++j) d2[j] = d2[j] + d3[j];
    shift<Disp::kUsesT>(s, d3, p.dt, st);
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
