// The backward of one freeze window of the EFIT cold-plasma ray trace,
// written by hand for Hopper (sm_90a): two kernels from one template.
//
// K2 replaces graph_framework_tpu/pallas/efit_step.py::_window_bwd_kernel
// (wired by the window8 custom_vjp): it pulls the cotangent of the
// window's output state back to its input state.  K3 replaces
// _window_bwd_tab_kernel (windowt): it also gives each ray's cotangents of
// its 16 psi and 16 profile coefficients, summed over the window's
// substeps and stages; the wrapper scatters them into the tables
// (kernels/efit_step.py scatter_block_cotangents, index_add_).
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
//      point p with cotangent c (6 values) on the RHS F = (-D_k, D_x)/D_w
//      and g = grad D over (w, x, y, z, kx, ky, kz):
//        v   = (dF/dg)^T c:  v_k = -c_x / D_w,  v_x = c_k / D_w,
//              v_w = -(c . F) / D_w;
//        the state cotangent is then H v, H the Hessian of D, from ONE
//        evaluation of cold_plasma_D over Dual<Dual<T, 7>, 1> whose outer
//        tangent is seeded with v (forward over forward; the 7 x 7 Hessian
//        is never formed).  t's cotangent passes through unchanged; w is
//        not integrated but D depends on it, so it collects H v's w part.
//   3. K3 adds six inner tangents on the quantities through which D
//      depends on the blocks (cold_plasma_D's TableHooks: the bicubic
//      value and its u, v derivatives; the ne, te, fpol profile values).
//      Each is linear in its block with weights u^a v^b (and their u, v
//      derivatives) or up^k, so with A = the derivative along v of dD/dq
//      and B = dD/dq, a coefficient's cotangent is A W + B (dW along v).
//
// What bounds it on this card: arithmetic and registers.  Per ray and
// window it moves 128 B of state and cotangent in, 64 B out (plus 256 B of
// block cotangents for K3) in f32, against K x stages x (one 7-tangent RHS
// and one nested evaluation of about three times its cost).  A nested dual
// scalar holds 16 values (28 with the six table tangents), far past the
// registers a thread has, so the live set spills to local memory (L1); the
// ptxas summary in chip_smoke.py shows how much.  Simple and right first:
// no tangent sparsity, no shared-memory staging yet.
//
// Numerics: as K1 (efit_common.cuh).  The forward sweep runs K1's own
// substep code, so the recomputed states are K1's.
//
// Build: each of the four launch_bwd<T, TAB> is instantiated in a source
// of its own (efit_window_bwd.cu: K2 float, with the C interface;
// efit_window_bwd_f64.cu, efit_window_bwd_tab.cu,
// efit_window_bwd_tab_f64.cu), so four nvcc processes compile them side
// by side.

#pragma once

#include "efit_common.cuh"

namespace gft {

constexpr int kSlots = 16;   // stored substep inputs per thread

// The VJP at one stage point s (8 leaves) with the partials g and the RHS
// F there, for the cotangent c on F: adds H v to acc[7] (w, x, y, z, kx,
// ky, kz) and, with TAB, the block cotangents to dpsi[16] and dprof[16].
template <typename T, bool TAB>
__device__ __forceinline__ void stage_vjp(const T s[8], const T g[7],
                                          const T F[6], const T c[6],
                                          const Frozen<T>& f,
                                          const Params<T>& p, T acc[7],
                                          T dpsi[16], T dprof[16]) {
  constexpr int NI = TAB ? kTangents + 6 : kTangents;
  using In = Dual<T, NI>;
  using S = Dual<In, 1>;

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

  // leaf q: value s_q with inner tangent q; outer tangent dir_q
  S leaf[7];
  const int from[7] = {ST_W, ST_X, ST_Y, ST_Z, ST_KX, ST_KY, ST_KZ};
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    leaf[q].v = Lift<In>::of(s[from[q]]);
    leaf[q].v.d[q] = T(1);
    leaf[q].d[0] = Lift<In>::of(dir[q]);
  }
  const S pos[3] = {leaf[1], leaf[2], leaf[3]};
  const S kvec[3] = {leaf[4], leaf[5], leaf[6]};

  S inj[6], uvp[3];
  if constexpr (TAB) {
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      inj[m] = Lift<S>::of(T(0));
      inj[m].v.d[kTangents + m] = T(1);
    }
  }
  const S d = cold_plasma_D<S, T, TAB>(leaf[0], kvec, pos, f, p,
                                       TableHooks<S>{inj, uvp});
#pragma unroll
  for (int q = 0; q < 7; ++q) acc[q] += d.d[0].d[q];

  if constexpr (TAB) {
    using D1 = Dual<T, 1>;
    D1 pw[3][4];   // powers of u, v, up with their derivatives along dir
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      D1 x1;
      x1.v = uvp[k].v.v;
      x1.d[0] = uvp[k].d[0].v;
      pw[k][0] = Lift<D1>::of(T(1));
#pragma unroll
      for (int e = 1; e < 4; ++e) pw[k][e] = pw[k][e - 1] * x1;
    }
    T A[6], B[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      A[m] = d.d[0].d[kTangents + m];
      B[m] = d.v.d[kTangents + m];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const D1 wv = pw[0][a] * pw[1][b];
        T sum = A[0] * wv.v + B[0] * wv.d[0];
        if (a > 0) {
          const D1 wu = T(a) * (pw[0][a - 1] * pw[1][b]);
          sum += A[1] * wu.v + B[1] * wu.d[0];
        }
        if (b > 0) {
          const D1 wz = T(b) * (pw[0][a] * pw[1][b - 1]);
          sum += A[2] * wz.v + B[2] * wz.d[0];
        }
        dpsi[a * 4 + b] += sum;
      }
    }
    // profile rows ne, te, fpol (pressure does not enter D)
    const int row[3] = {0, 1, 3};
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dprof[row[m] * 4 + k] += A[3 + m] * pw[2][k].v +
                                 B[3 + m] * pw[2][k].d[0];
    }
  }
}

// Transpose of one plain substep (substep<T, METHOD>) at its input s:
// ct (8) holds the cotangent of the substep's output and becomes that of
// its input.
template <typename T, int METHOD, bool TAB>
__device__ __forceinline__ void substep_vjp(const T s[8], const Frozen<T>& f,
                                            const Params<T>& p, T ct[8],
                                            T dpsi[16], T dprof[16]) {
  T acc[7];
#pragma unroll
  for (int q = 0; q < 7; ++q) acc[q] = T(0);
  T g1[7], d1[6], s2[8], g2[7], d2[6], c[6];
  ray_grad(s, f, p, g1);
  rhs_from_grad(g1, d1);
  if (METHOD == 2) {
    // inc = dt/2 (d1 + d2), d2 = F(s + dt d1)
    shift(s, d1, p.dt, s2);
    ray_grad(s2, f, p, g2);
    rhs_from_grad(g2, d2);
#pragma unroll
    for (int j = 0; j < 6; ++j) c[j] = p.half * ct[ST_X + j];
    stage_vjp<T, TAB>(s2, g2, d2, c, f, p, acc, dpsi, dprof);
#pragma unroll
    for (int j = 0; j < 6; ++j) c[j] = p.half * ct[ST_X + j] + p.dt * acc[1 + j];
  } else {
    // inc = dt/6 (d1 + 2 (d2 + d3) + d4): d2 = F(s + dt/2 d1),
    // d3 = F(s + dt/2 d2), d4 = F(s + dt d3)
    T s3[8], g3[7], d3[6], s4[8], g4[7], d4[6], a[7];
    shift(s, d1, p.half, s2);
    ray_grad(s2, f, p, g2);
    rhs_from_grad(g2, d2);
    shift(s, d2, p.half, s3);
    ray_grad(s3, f, p, g3);
    rhs_from_grad(g3, d3);
    shift(s, d3, p.dt, s4);
    ray_grad(s4, f, p, g4);
    rhs_from_grad(g4, d4);
    const T third = T(2) * p.sixth;
#pragma unroll
    for (int q = 0; q < 7; ++q) a[q] = T(0);
#pragma unroll
    for (int j = 0; j < 6; ++j) c[j] = p.sixth * ct[ST_X + j];
    stage_vjp<T, TAB>(s4, g4, d4, c, f, p, a, dpsi, dprof);
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      acc[q] += a[q];
      if (q > 0) c[q - 1] = third * ct[ST_X + q - 1] + p.dt * a[q];
      a[q] = T(0);
    }
    stage_vjp<T, TAB>(s3, g3, d3, c, f, p, a, dpsi, dprof);
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      acc[q] += a[q];
      if (q > 0) c[q - 1] = third * ct[ST_X + q - 1] + p.half * a[q];
      a[q] = T(0);
    }
    stage_vjp<T, TAB>(s2, g2, d2, c, f, p, a, dpsi, dprof);
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      acc[q] += a[q];
      if (q > 0) c[q - 1] = p.sixth * ct[ST_X + q - 1] + p.half * a[q];
    }
  }
  stage_vjp<T, TAB>(s, g1, d1, c, f, p, acc, dpsi, dprof);
  ct[ST_W] += acc[0];
#pragma unroll
  for (int j = 0; j < 6; ++j) ct[ST_X + j] += acc[1 + j];
}

template <typename T, int METHOD, bool TAB>
__global__ void __launch_bounds__(kThreads)
efit_window_bwd_kernel(StatePtrs<T> in, StatePtrs<T> ct_in,
                       StatePtrs<T> out, const T* __restrict__ psi_tab,
                       const T* __restrict__ prof_tab, Params<T> p,
                       int steps, long long n, T* __restrict__ dpsi_out,
                       T* __restrict__ dprof_out,
                       long long* __restrict__ cell_out,
                       long long* __restrict__ pcell_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  T base[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) base[k] = in.p[k][i];
  const Frozen<T> f = freeze(base, psi_tab, prof_tab, p);

  // forward sweep: the input of every stride-th substep
  const int stride = (steps + kSlots - 1) / kSlots;
  T slot[kSlots][6];
  {
    T s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = base[k];
    for (int k = 0; k < steps; ++k) {
      if (k % stride == 0) {
#pragma unroll
        for (int j = 0; j < 6; ++j) slot[k / stride][j] = s[ST_X + j];
      }
      if (k + 1 < steps) substep<T, METHOD>(s, f, p);
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
    s[ST_T] = base[ST_T];
    s[ST_W] = base[ST_W];
#pragma unroll
    for (int j = 0; j < 6; ++j) s[ST_X + j] = slot[k / stride][j];
    for (int r = (k / stride) * stride; r < k; ++r) substep<T, METHOD>(s, f, p);
    substep_vjp<T, METHOD, TAB>(s, f, p, ct, dpsi, dprof);
  }

#pragma unroll
  for (int k = 0; k < 8; ++k) out.p[k][i] = ct[k];
  if constexpr (TAB) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      dpsi_out[k * n + i] = dpsi[k];
      dprof_out[k * n + i] = dprof[k];
    }
    cell_out[i] = f.cell;
    pcell_out[i] = f.pcell;
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

template <typename T, bool TAB>
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
    efit_window_bwd_kernel<T, 2, TAB><<<grid, kThreads, 0, stream>>>(
        pin, pct, pout, psi_t, prof_t, p, steps, n, dpsi_t, dprof_t, cell_t,
        pcell_t);
  else
    efit_window_bwd_kernel<T, 4, TAB><<<grid, kThreads, 0, stream>>>(
        pin, pct, pout, psi_t, prof_t, p, steps, n, dpsi_t, dprof_t, cell_t,
        pcell_t);
  return static_cast<int>(cudaGetLastError());
}

// each instantiation is compiled in its own source (see Build above)
extern template int launch_bwd<float, false>(const BwdArgs&);
extern template int launch_bwd<double, false>(const BwdArgs&);
extern template int launch_bwd<float, true>(const BwdArgs&);
extern template int launch_bwd<double, true>(const BwdArgs&);

}  // namespace gft
