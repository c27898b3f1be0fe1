// The backward of one freeze window of the EFIT ray trace, written by hand
// for Hopper (sm_90a): two kernels from one template, for each dispersion
// the window kernel K1 serves (the eleven real dispersions' tails of
// efit_adjoint.cuh).
//
// K2 replaces graph_framework_tpu/pallas/efit_step.py::_window_bwd_kernel
// (wired by the window8 custom_vjp): it pulls the cotangent of the
// window's output state back to its input state.  K3 replaces
// _window_bwd_tab_kernel (windowt): it also gives each ray's cotangents of
// its 16 psi and 16 profile coefficients, summed over the window's
// substeps and stages; the wrapper scatters them into the tables
// (kernels/efit_step.py scatter_block_cotangents, by the table scatter of
// csrc/table_scatter.cu).
//
// Launch shape as K1 (efit_window.cu): one thread per ray, 128 a block,
// structure-of-arrays state (8 inputs, 8 cotangents, 8 outputs), a masked
// ragged last block, the freeze gather at the window base inside the
// kernel.  The frozen blocks get no state cotangent, as in the JAX
// transpose: they depend on the base state only through integer cells.
//
// How a window is transposed (the structure of the TPU kernel):
//   1. forward sweep: re-advance the K substeps and keep each substep's
//      input (six integrated leaves; t and w stay) in local memory - up to
//      kSlots of them; a longer window keeps every stride-th and recomputes
//      the rest from the nearest one;
//   2. reverse sweep: the VJP of one substep at a time, from the last.
//      The rk2/rk4 stage algebra is transposed by hand; at each stage
//      point with cotangent c (6 values) on the RHS F = (-D_k, D_x)/D_w
//      and g = grad D over (w, x, y, z, kx, ky, kz):
//        v   = (dF/dg)^T c:  v_k = -c_x / D_w,  v_x = c_k / D_w,
//              v_w = -(c . F) / D_w;
//        the state cotangent is then H v, H the Hessian of D: forward over
//        reverse, the hand-written reverse sweep of D (efit_adjoint<Disp>,
//        efit_adjoint.cuh) run once on Dual<T, 1> with the inputs'
//        tangents seeded with v.
//        t's cotangent passes through unchanged, and where D reads t
//        (stiff, whose stages advance t) it also collects H v's t part,
//        the tangent of D's partial over t; w is not integrated but D
//        depends on it, so it collects H v's w part.
//   3. K3 also needs the seven quantities through which D depends on the
//      blocks (the bicubic value and its u, v derivatives; the ne, te, fpol
//      and pressure profile values, each zero where D does not read it):
//      the same sweep gives their adjoints B = dD/dq and, as their
//      tangents, A = the derivative of B along v.  Each quantity is linear
//      in its block with weights W = u^a v^b (and their u, v derivatives)
//      or up^k, so a coefficient's cotangent is A W + B (dW along v).  A
//      dispersion that reads no table (simple, gaussian_well, stiff) skips
//      the gather and the shared blocks, and has no K3: its tables take no
//      gradient (launch_bwd_of refuses its table outputs).
//
// What bounds it on this card: arithmetic.  Per ray and window it moves
// 128 B of state and cotangent in and 64 B out (plus 256 B of block
// cotangents for K3) in f32.  For cold plasma the function needs 22 892
// operations (K3 26 212) at K = 10, rk2, each once (tools/count_ops.py,
// which counts every other tail too); this source
// does 38 065 (K3 41 385), because it takes each stage's gradient of D
// three times: in the forward sweep, again in substep_vjp, and as the
// value part of the Dual<T, 1> sweep.  Storing them would cost registers
// or local memory.  The design before this one evaluated cold_plasma_D on
// nested duals, Dual<Dual<T, 7>, 1> (28 values a scalar in K3),
// recomputed each stage's gradient with 7 forward tangents and spilled
// 1.3-33 KB a thread: 225 677 operations (K3 349 677).  Now:
//   * the stage VJP is one scalar sweep of D for g (391 operations, 2.2
//     times D's 175) and one on Dual<T, 1> for H v (1109 in all; K3 1275
//     with its weights), against 2196 and 7062 (K3 13 262) before, and
//     the forward sweep advances with the same adjoint gradient, through
//     the stepping templates K1 runs too (827 operations a rk2 substep,
//     where forward mode took 4435);
//   * the sweep divides by five reciprocals (1/r, 1/w, 1/|B|, 1/den per
//     species) and the RHS by one: an IEEE division is a sequence of
//     instructions, and the sweep on Dual<T, 1> had about 140;
//   * the 32 coefficients of a ray's blocks sit in shared memory (16 KB a
//     block in f32), not in registers through both sweeps: f32 K2 takes
//     157 registers (rk2) with no spills, 3 blocks an SM.
// A __launch_bounds__ minimum of 3 or 4 blocks an SM spilled and ran
// slower on the card.
//
// Numerics: as K1 (efit_common.cuh): IEEE division and square root, FMA
// contraction on.  The states the sweeps recompute differ from K1's in
// rounding only (the adjoint gradient and reciprocals); the kernels are held
// to autograd of the plain window.  tests/test_torch_efit_bwd_host.py runs
// this source on the host, against the plain versions.
//
// Build: each dispersion's launch_bwd_of<Disp> - its K2 and, where it
// reads the map, its K3, f32 and f64 - is instantiated in a source of its
// own (efit_window_bwd.cu: cold plasma's, with the C interface;
// efit_window_bwd_<tag>.cu for the other ten), so that eleven nvcc
// processes compile them side by side, beside K1's eleven.  A source
// an instantiation (44) took the card's build from 22 s to 50 s: each nvcc
// costs 2-6 CPU seconds, and 59 of them finished together after 33-49 s,
// with 3.4 of the 8 cores busy.

#pragma once

#include "efit_adjoint.cuh"

namespace gft {

constexpr int kSlots = 16;   // stored substep inputs per thread

// A ray's two coefficient blocks in shared memory: column threadIdx.x of
// its thread block's [32][kThreads] array (psi rows 0-15, profile rows
// 16-31), so that the 32 values hold no registers through the sweeps and
// neighbouring threads read neighbouring words.  The loads are volatile:
// the compiler may not hoist them out of the loops into registers again.
template <typename T>
struct SharedBlocks {
  const volatile T* col;
  T iu, jv, pidx;   // frozen cell indices (as floats)
};
template <typename T>
__device__ __forceinline__ T psi_coef(const SharedBlocks<T>& f, int k) {
  return f.col[k * kThreads];
}
template <typename T>
__device__ __forceinline__ T prof_coef(const SharedBlocks<T>& f, int k) {
  return f.col[(16 + k) * kThreads];
}

// The VJP at one stage point s (8 leaves) with the partials g and the RHS
// F there, for the cotangent c on F: adds H v to acc[7] (w, x, y, z, kx,
// ky, kz) and, where D reads t, its t part to acc_t, and, with TAB, the
// block cotangents to dpsi[16] and dprof[16].
template <typename Disp, typename T, bool TAB>
__device__ __forceinline__ void stage_vjp(const T s[8], const T g[7],
                                          const T F[6], const T c[6],
                                          const SharedBlocks<T>& f,
                                          const Params<T>& p, T acc[7],
                                          T& acc_t, T dpsi[16],
                                          T dprof[16]) {
  using D1 = Dual<T, 1>;

  const T inv = T(1) / g[0];
  T dir[7];
  T cf = T(0);
#pragma unroll
  for (int j = 0; j < 6; ++j) cf += c[j] * F[j];
  dir[0] = -cf * inv;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dir[1 + i] = c[3 + i] * inv;
    dir[4 + i] = -c[i] * inv;
  }

  // forward over reverse: the adjoint sweep on one tangent seeded with dir
  // (t's tangent is 0: the RHS does not depend on D's partial over t)
  D1 st[7], gv[7], gt, bv[7], uvp[3];
  const int from[7] = {ST_W, ST_X, ST_Y, ST_Z, ST_KX, ST_KY, ST_KZ};
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    st[q].v = s[from[q]];
    st[q].d[0] = dir[q];
  }
  D1 tt;
  tt.v = s[ST_T];
  tt.d[0] = T(0);
  efit_adjoint<Disp>(st, tt, f, p, gv, &gt, bv, uvp);
#pragma unroll
  for (int q = 0; q < 7; ++q) acc[q] += gv[q].d[0];
  if constexpr (Disp::kUsesT) acc_t += gt.d[0];

  if constexpr (TAB) {
    // Coefficient (a, b) of the psi block weighs val by P = u^a v^b,
    // dval_du by P_u and dval_dv by P_v; its cotangent is
    //   A0 P + B0 P' + A1 P_u + B1 P_u' + A2 P_v + B2 P_v'
    // (' along dir: P' = P_u du + P_v dv).  With U = u^a, V = v^b and their
    // derivatives that is X_a V + Y_a V_v + Z_a V_vv, where
    //   X_a = A0 U + (B0 du + A1) U_u + B1 du U_uu,
    //   Y_a = (B0 dv + A2) U + (B1 dv + B2 du) U_u,   Z_a = B2 dv U.
    // Written out power by power, with no product by a constant 0 or 1.
    const T u = uvp[0].v, v = uvp[1].v, up = uvp[2].v;
    const T du = uvp[0].d[0], dv = uvp[1].d[0], dup = uvp[2].d[0];
    T A[7], B[7];
#pragma unroll
    for (int m = 0; m < 7; ++m) {
      A[m] = bv[m].d[0];
      B[m] = bv[m].v;
    }
    const T u2 = u * u, v2 = v * v;
    const T xs = B[0] * du + A[1], xt = B[1] * du;
    const T ys = B[0] * dv + A[2], yt = B[1] * dv + B[2] * du;
    const T zs = B[2] * dv;
    const T X[4] = {A[0], A[0] * u + xs,
                    A[0] * u2 + T(2) * (xs * u + xt),
                    A[0] * (u2 * u) + T(3) * (xs * u2) + T(6) * (xt * u)};
    const T Y[4] = {ys, ys * u + yt, ys * u2 + T(2) * (yt * u),
                    ys * (u2 * u) + T(3) * (yt * u2)};
    const T Z[4] = {zs, zs * u, zs * u2, zs * (u2 * u)};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      dpsi[a * 4] += X[a];
      dpsi[a * 4 + 1] += X[a] * v + Y[a];
      dpsi[a * 4 + 2] += X[a] * v2 + T(2) * (Y[a] * v + Z[a]);
      dpsi[a * 4 + 3] += X[a] * (v2 * v) + T(3) * (Y[a] * v2) +
                         T(6) * (Z[a] * v);
    }
    // profile rows ne, te, fpol and pressure (b[3..6]; te's and the
    // pressure's rows stay zero where D does not read them): weights up^k
    const T up2 = up * up;
    const int row[4] = {0, 1, 3, 2};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m == 1 && !Disp::kUsesTe) continue;
      if (m == 3 && !Disp::kUsesPres) continue;
      const T a = A[3 + m], bd = B[3 + m] * dup;
      T* d = dprof + row[m] * 4;
      d[0] += a;
      d[1] += a * up + bd;
      d[2] += a * up2 + T(2) * (bd * up);
      d[3] += a * (up2 * up) + T(3) * (bd * up2);
    }
  }
}

// Transpose of one plain substep (substep<Disp, T, METHOD>) at its
// input s: ct (8) holds the cotangent of the substep's output and becomes
// that of its input.
template <typename Disp, typename T, int METHOD, bool TAB>
__device__ __forceinline__ void substep_vjp(const T s[8],
                                            const SharedBlocks<T>& f,
                                            const Params<T>& p, T ct[8],
                                            T dpsi[16], T dprof[16]) {
  T acc[7], acc_t = T(0);
#pragma unroll
  for (int q = 0; q < 7; ++q) acc[q] = T(0);
  T g1[7], d1[6], s2[8], g2[7], d2[6], c[6];
  constexpr bool kT = Disp::kUsesT;
  AdjointGrad<Disp>::grad(s, f, p, g1);
  AdjointGrad<Disp>::rhs(g1, d1);
  if (METHOD == 2) {
    // inc = dt/2 (d1 + d2), d2 = F(s + dt d1)
    shift<kT>(s, d1, p.dt, s2);
    AdjointGrad<Disp>::grad(s2, f, p, g2);
    AdjointGrad<Disp>::rhs(g2, d2);
#pragma unroll
    for (int j = 0; j < 6; ++j) c[j] = p.half * ct[ST_X + j];
    stage_vjp<Disp, T, TAB>(s2, g2, d2, c, f, p, acc, acc_t, dpsi, dprof);
#pragma unroll
    for (int j = 0; j < 6; ++j) c[j] = p.half * ct[ST_X + j] + p.dt * acc[1 + j];
  } else {
    // inc = dt/6 (d1 + 2 (d2 + d3) + d4): d2 = F(s + dt/2 d1),
    // d3 = F(s + dt/2 d2), d4 = F(s + dt d3)
    T s3[8], g3[7], d3[6], s4[8], g4[7], d4[6], a[7];
    shift<kT>(s, d1, p.half, s2);
    AdjointGrad<Disp>::grad(s2, f, p, g2);
    AdjointGrad<Disp>::rhs(g2, d2);
    shift<kT>(s, d2, p.half, s3);
    AdjointGrad<Disp>::grad(s3, f, p, g3);
    AdjointGrad<Disp>::rhs(g3, d3);
    shift<kT>(s, d3, p.dt, s4);
    AdjointGrad<Disp>::grad(s4, f, p, g4);
    AdjointGrad<Disp>::rhs(g4, d4);
    const T third = T(2) * p.sixth;
#pragma unroll
    for (int q = 0; q < 7; ++q) a[q] = T(0);
#pragma unroll
    for (int j = 0; j < 6; ++j) c[j] = p.sixth * ct[ST_X + j];
    stage_vjp<Disp, T, TAB>(s4, g4, d4, c, f, p, a, acc_t, dpsi, dprof);
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      acc[q] += a[q];
      if (q > 0) c[q - 1] = third * ct[ST_X + q - 1] + p.dt * a[q];
      a[q] = T(0);
    }
    stage_vjp<Disp, T, TAB>(s3, g3, d3, c, f, p, a, acc_t, dpsi, dprof);
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      acc[q] += a[q];
      if (q > 0) c[q - 1] = third * ct[ST_X + q - 1] + p.half * a[q];
      a[q] = T(0);
    }
    stage_vjp<Disp, T, TAB>(s2, g2, d2, c, f, p, a, acc_t, dpsi, dprof);
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      acc[q] += a[q];
      if (q > 0) c[q - 1] = p.sixth * ct[ST_X + q - 1] + p.half * a[q];
    }
  }
  stage_vjp<Disp, T, TAB>(s, g1, d1, c, f, p, acc, acc_t, dpsi, dprof);
  // every stage's t is the input's plus a constant
  if constexpr (kT) ct[ST_T] += acc_t;
  ct[ST_W] += acc[0];
#pragma unroll
  for (int j = 0; j < 6; ++j) ct[ST_X + j] += acc[1 + j];
}

template <typename T, int METHOD, bool TAB, typename Disp>
__global__ void __launch_bounds__(kThreads)
efit_window_bwd_kernel(StatePtrs<T> in, StatePtrs<T> ct_in,
                       StatePtrs<T> out, const T* __restrict__ psi_tab,
                       const T* __restrict__ prof_tab, Params<T> p,
                       int steps, long long n, T* __restrict__ dpsi_out,
                       T* __restrict__ dprof_out,
                       long long* __restrict__ cell_out,
                       long long* __restrict__ pcell_out) {
  static_assert(Disp::kReadsEq || !TAB,
                "a dispersion that reads no table has no block cotangents");
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  T base[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) base[k] = in.p[k][i];
  Frozen<T> fz{};
  const volatile T* col = nullptr;
  if constexpr (Disp::kReadsEq) {
    __shared__ T blocks[32][kThreads];
    fz = freeze(base, psi_tab, prof_tab, p);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      blocks[k][threadIdx.x] = fz.psi[k];
      blocks[16 + k][threadIdx.x] = fz.prof[k];
    }
    col = &blocks[0][threadIdx.x];
  }
  const SharedBlocks<T> f{col, fz.iu, fz.jv, fz.pidx};

  // forward sweep: the input of every stride-th substep (and its t where
  // D reads t)
  const int stride = (steps + kSlots - 1) / kSlots;
  T slot[kSlots][6];
  T slot_t[Disp::kUsesT ? kSlots : 1];
  {
    T s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = base[k];
    for (int k = 0; k < steps; ++k) {
      if (k % stride == 0) {
#pragma unroll
        for (int j = 0; j < 6; ++j) slot[k / stride][j] = s[ST_X + j];
        if constexpr (Disp::kUsesT) slot_t[k / stride] = s[ST_T];
      }
      if (k + 1 < steps) substep<Disp, T, METHOD>(s, f, p);
    }
  }

  // reverse sweep
  T ct[8], dpsi[16], dprof[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) ct[k] = ct_in.p[k][i];
  if constexpr (TAB) {
#pragma unroll
    for (int k = 0; k < 16; ++k) dpsi[k] = dprof[k] = T(0);
  }
  for (int k = steps - 1; k >= 0; --k) {
    T s[8];
    if constexpr (Disp::kUsesT)
      s[ST_T] = slot_t[k / stride];
    else
      s[ST_T] = base[ST_T];
    s[ST_W] = base[ST_W];
#pragma unroll
    for (int j = 0; j < 6; ++j) s[ST_X + j] = slot[k / stride][j];
    for (int r = (k / stride) * stride; r < k; ++r)
      substep<Disp, T, METHOD>(s, f, p);
    substep_vjp<Disp, T, METHOD, TAB>(s, f, p, ct, dpsi, dprof);
  }

#pragma unroll
  for (int k = 0; k < 8; ++k) out.p[k][i] = ct[k];
  if constexpr (TAB) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      dpsi_out[k * n + i] = dpsi[k];
      dprof_out[k * n + i] = dprof[k];
    }
    cell_out[i] = fz.cell;
    pcell_out[i] = fz.pcell;
  }
}

// The arguments of gft_efit_window_bwd (efit_window_bwd.cu).
struct BwdArgs {
  int method, steps;
  long long n;
  void** state_in;
  void** ct_in;
  void** ct_out;
  const void* psi;
  int nr, nz;
  const void* prof;
  int npsi;
  const double* params;
  void* dpsi;
  void* dprof;
  void* cell;
  void* pcell;
  cudaStream_t stream;
};

template <typename Disp, typename T, bool TAB>
int launch_bwd(const BwdArgs& a) {
  StatePtrs<T> pin, pct, pout;
  for (int k = 0; k < 16; ++k) {
    pin.p[k] = k < 8 ? static_cast<T*>(a.state_in[k]) : nullptr;
    pct.p[k] = k < 8 ? static_cast<T*>(a.ct_in[k]) : nullptr;
    pout.p[k] = k < 8 ? static_cast<T*>(a.ct_out[k]) : nullptr;
  }
  const Params<T> p = make_params<T>(a.params, a.nr, a.nz, a.npsi);
  const T* psi_t = static_cast<const T*>(a.psi);
  const T* prof_t = static_cast<const T*>(a.prof);
  T* dpsi_t = static_cast<T*>(a.dpsi);
  T* dprof_t = static_cast<T*>(a.dprof);
  long long* cell_t = static_cast<long long*>(a.cell);
  long long* pcell_t = static_cast<long long*>(a.pcell);
  const long long n = a.n;
  const int steps = a.steps;
  cudaStream_t stream = a.stream;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  if (a.method == 2)
    efit_window_bwd_kernel<T, 2, TAB, Disp><<<grid, kThreads, 0, stream>>>(
        pin, pct, pout, psi_t, prof_t, p, steps, n, dpsi_t, dprof_t, cell_t,
        pcell_t);
  else
    efit_window_bwd_kernel<T, 4, TAB, Disp><<<grid, kThreads, 0, stream>>>(
        pin, pct, pout, psi_t, prof_t, p, steps, n, dpsi_t, dprof_t, cell_t,
        pcell_t);
  return static_cast<int>(cudaGetLastError());
}

// K2 (tab false) or K3 of the dispersion Disp, f32 (dtype 0) or f64: a
// dispersion that reads no table has no K3, and its table outputs are
// refused (kernels/efit_step.py keeps its tables out of autograd).
template <typename Disp>
int launch_bwd_of(int dtype, bool tab, const BwdArgs& a) {
  if (tab) {
    if constexpr (Disp::kReadsEq)
      return dtype == 0 ? launch_bwd<Disp, float, true>(a)
                        : launch_bwd<Disp, double, true>(a);
    else
      return kInvalidArgument;
  }
  return dtype == 0 ? launch_bwd<Disp, float, false>(a)
                    : launch_bwd<Disp, double, false>(a);
}

// each dispersion's is instantiated in a source of its own (see Build above)
#define GFT_EXTERN_BWD(code, D) \
  extern template int launch_bwd_of<D>(int, bool, const BwdArgs&);
GFT_DISPERSIONS(GFT_EXTERN_BWD)
#undef GFT_EXTERN_BWD

}  // namespace gft
