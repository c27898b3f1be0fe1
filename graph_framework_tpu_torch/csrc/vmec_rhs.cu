// The VMEC ray right-hand side written by hand for Hopper (sm_90a): K8.
//
// It replaces no TPU kernel.  The JAX package gets the ray equations in
// flux coordinates from one jax.grad of D, which XLA fuses; the port's
// eager path (models/rays.py make_ray_rhs) dispatches the geometry's
// assembly, D and the autograd pass over them from Python, some 640 device
// operations a call.  This kernel maps a ray's state and the geometry jet
// of K4 (csrc/vmec_geom.cu: the 10 geometry sums and their 17 unique second
// partials, in kernels/vmec_geom.py JET_NAMES order) to the six ray
// derivatives, taking the chain rule by hand, as K1 does for EFIT:
//
//   * K4's sums as Dual<T, 3> over (s, u, v): each value with its three
//     partials read from the jet (kernels/vmec_geom.py JVP_IDX);
//   * models/vmec.py _assemble_geometry on those duals: rot(v) with its own
//     v-derivative, the covariant basis, the Jacobian and 1/jac, the
//     contravariant basis e^s, e^u, e^v, jbsupu and jbsupv with dchi/ds and
//     d2chi/ds2 from the ray's cell of the chi table (models/vmec.py
//     _chi_jet, cell-local), B, and kvec = k_s e^s + k_u e^u + k_v e^v;
//   * the analytic profiles ne = 1e19 p(s), p = (1 - |s|^1.5)^2, and their
//     s-derivative; VMEC's ion density is ne (models/vmec.py _VmecView);
//   * D's partials over w and kvec and the adjoints of ne, the ion density
//     and B by the hand-written cold-plasma sweep ColdPlasma::adjoint
//     (efit_adjoint.cuh), the ion density in the slot the EFIT front fills
//     with te; the total dD/d(s, u, v) is the contraction of those with the
//     duals' tangents, through the basis too (the canonical form, which
//     keeps rays on D = 0), and dD/dk_i = dD/dkvec . e^i;
//   * out: (-D_k / D_w, D_x / D_w), the six leaves of models/rays.py
//     RayDerivatives, as a (6, n) structure of arrays.
//
// One thread a ray, any ray count, the ragged last block masked.  The
// state comes as seven separate leaves (w, s, u, v, k_s, k_u, k_v), the jet
// as K4 writes it, (27, n); the chi table is (nchi, 4) cell-local.  Row 1
// of the jet (Z) is not read: the geometry takes only Z's derivatives.
//
// What bounds it on this card: bytes.  A ray reads 7 leaves and 26 jet
// rows and writes 6 values (156 B in f32); its arithmetic, 865 operations
// counted by tools/count_ops.py, takes about a quarter of that time at the
// card's f32 rate (kernels/vmec_rhs.py RHS_OPS).
//
// Divisions are IEEE (never build with --use_fast_math); FMA contraction is
// left on, so f32 results differ from the plain version in the last bits.

#include <cuda_runtime.h>

#include "efit_adjoint.cuh"

namespace gft {

namespace {

constexpr int kRhsThreads = 128;
constexpr int kRhsIn = 7;        // w, s, u, v, k_s, k_u, k_v

__device__ __forceinline__ void gsincos(float a, float* s, float* c) {
  sincosf(a, s, c);
}
__device__ __forceinline__ void gsincos(double a, double* s, double* c) {
  sincos(a, s, c);
}

template <typename T>
using J3 = Dual<T, 3>;

template <typename T>
struct RhsParams {
  Params<T> plasma;     // kpe, kce, kpi, kci: ColdPlasma::adjoint's factors
  T sminf, ds, phip;    // the chi table's grid; signj dphi
  int nchi;
};

template <typename T>
struct RhsLeaves {
  const T* in[kRhsIn];
};

// K4's sum o of ray i as a dual over (s, u, v): its partials are the jet
// rows ps, pu, pv (kernels/vmec_geom.py JVP_IDX[o])
template <typename T>
__device__ __forceinline__ J3<T> jet_dual(const T* __restrict__ jet,
                                          long long n, long long i, int o,
                                          int ps, int pu, int pv) {
  J3<T> r;
  r.v = __ldg(jet + o * n + i);
  r.d[0] = __ldg(jet + ps * n + i);
  r.d[1] = __ldg(jet + pu * n + i);
  r.d[2] = __ldg(jet + pv * n + i);
  return r;
}

template <typename S>
__device__ __forceinline__ void cross(const S a[3], const S b[3], S o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename S>
__device__ __forceinline__ S dot(const S a[3], const S b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
__global__ void __launch_bounds__(kRhsThreads)
vmec_rhs_kernel(RhsLeaves<T> st, const T* __restrict__ jet,
                const T* __restrict__ chi, RhsParams<T> q,
                T* __restrict__ out, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T w = st.in[0][i], s = st.in[1][i], v = st.in[3][i];
  const T kcov[3] = {st.in[4][i], st.in[5][i], st.in[6][i]};

  // the geometry sums (kernels/vmec_geom.py JET_NAMES, JVP_IDX)
  const J3<T> r = jet_dual(jet, n, i, 0, 2, 3, 4);
  const J3<T> drs = jet_dual(jet, n, i, 2, 10, 11, 12);
  const J3<T> dru = jet_dual(jet, n, i, 3, 11, 13, 14);
  const J3<T> drv = jet_dual(jet, n, i, 4, 12, 14, 15);
  const J3<T> dzs = jet_dual(jet, n, i, 5, 16, 17, 18);
  const J3<T> dzu = jet_dual(jet, n, i, 6, 17, 19, 20);
  const J3<T> dzv = jet_dual(jet, n, i, 7, 18, 20, 21);
  const J3<T> dlu = jet_dual(jet, n, i, 8, 22, 24, 25);
  const J3<T> dlv = jet_dual(jet, n, i, 9, 23, 25, 26);

  // rot(v), its own v-derivative the only tangent
  T sv, cv;
  gsincos(v, &sv, &cv);
  J3<T> c = lift<J3<T>>(cv), sn = lift<J3<T>>(sv);
  c.d[2] = -sv;
  sn.d[2] = cv;

  // models/vmec.py _assemble_geometry
  const J3<T> esub_s[3] = {drs * c, drs * sn, dzs};
  const J3<T> esub_u[3] = {dru * c, dru * sn, dzu};
  const J3<T> esub_v[3] = {drv * c - r * sn, drv * sn + r * c, dzv};
  J3<T> cuv[3], cvs[3], csu[3];
  cross(esub_u, esub_v, cuv);
  cross(esub_v, esub_s, cvs);
  cross(esub_s, esub_u, csu);
  const J3<T> inv_jac = recip(dot(esub_s, cuv));
  J3<T> esup[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    esup[0][k] = cuv[k] * inv_jac;
    esup[1][k] = cvs[k] * inv_jac;
    esup[2][k] = csu[k] * inv_jac;
  }

  // dchi/ds and d2chi/ds2 at the ray's cell (models/vmec.py _chi_jet)
  const int kc = table_index(s, q.ds, q.sminf, q.nchi);
  const T tc = (s - q.sminf) / q.ds - T(kc);
  const T* cb = chi + 4 * static_cast<long long>(kc);
  const T c1 = __ldg(cb + 1), c2 = __ldg(cb + 2), c3 = __ldg(cb + 3);
  J3<T> dchi = lift<J3<T>>((c1 + tc * (T(2) * c2 + T(3) * tc * c3)) / q.ds);
  dchi.d[0] = (T(2) * c2 + T(6) * tc * c3) / q.ds / q.ds;

  const J3<T> jbsupu = (dchi - q.phip * dlv) * inv_jac;
  const J3<T> jbsupv = q.phip * (T(1) + dlu) * inv_jac;
  J3<T> b[3], kvec[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b[k] = jbsupu * esub_u[k] + jbsupv * esub_v[k];
    kvec[k] = kcov[0] * esup[0][k] + kcov[1] * esup[1][k] +
              kcov[2] * esup[2][k];
  }

  // ne = 1e19 (1 - |s|^1.5)^2 and its s-derivative; the ion density is ne
  const T a = gsqrt(s * s), ra = gsqrt(a);
  const T pq = T(1) - a * ra;
  const T ne = T(1.0e19) * (pq * pq);
  const T ne_s = T(1.0e19) * (T(-3) * pq * (s / ra));

  // D's partials over w and kvec; the adjoints of ne, the ion density (the
  // te slot) and B
  T g[7], ne_b, ni_b, unused, bb[3];
  const T kv[3] = {kvec[0].v, kvec[1].v, kvec[2].v};
  const T bv[3] = {b[0].v, b[1].v, b[2].v};
  ColdPlasma::adjoint(w, kv, ne, ne, ne, bv, q.plasma, g, ne_b, ni_b,
                      unused, bb);

  // total dD/d(s, u, v) and dD/dk_i
  T dx[3], dk[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    dx[j] = g[4] * kvec[0].d[j] + g[5] * kvec[1].d[j] +
            g[6] * kvec[2].d[j] + bb[0] * b[0].d[j] + bb[1] * b[1].d[j] +
            bb[2] * b[2].d[j];
    dk[j] = g[4] * esup[j][0].v + g[5] * esup[j][1].v + g[6] * esup[j][2].v;
  }
  dx[0] = dx[0] + (ne_b + ni_b) * ne_s;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out[j * n + i] = -dk[j] / g[0];
    out[(3 + j) * n + i] = dx[j] / g[0];
  }
}

template <typename T>
int launch_vmec_rhs(long long n, void* const* in, const void* jet,
                    const void* chi, int nchi, const double* params,
                    void* out, cudaStream_t stream) {
  RhsLeaves<T> st;
#pragma unroll
  for (int k = 0; k < kRhsIn; ++k) st.in[k] = static_cast<const T*>(in[k]);
  RhsParams<T> q{};
  q.sminf = T(params[0]);
  q.ds = T(params[1]);
  q.phip = T(params[2]);
  q.plasma.kpe = T(params[3]);
  q.plasma.kce = T(params[4]);
  q.plasma.kpi = T(params[5]);
  q.plasma.kci = T(params[6]);
  q.nchi = nchi;
  const long long blocks = (n + kRhsThreads - 1) / kRhsThreads;
  vmec_rhs_kernel<T><<<static_cast<unsigned>(blocks), kRhsThreads, 0,
                       stream>>>(st, static_cast<const T*>(jet),
                                 static_cast<const T*>(chi), q,
                                 static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace gft

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes by kernels/build.py)
// ---------------------------------------------------------------------------

// The six ray derivatives of n rays in VMEC flux coordinates.
//   dtype: 0 = float, 1 = double;
//   in: 7 pointers to (n,) leaves w, s, u, v, k_s, k_u, k_v, n >= 1;
//   jet: (27, n), K4's output at (s, u, v);
//   chi: (nchi, 4) the cell-local chi table;
//   params: sminf, ds, signj dphi, then q^2/(eps0 me c^2), -q/(me c),
//     qi^2/(eps0 mi c^2), qi/(mi c) folded in double;
//   out: (6, n): ds/dt, du/dt, dv/dt, dk_s/dt, dk_u/dt, dk_v/dt.
// Launches on `stream` and returns at once: 0, a cudaError_t from the
// launch, or -1 for an argument the kernel does not take.
extern "C" int gft_vmec_rhs(int dtype, long long n, void* const* in,
                            const void* jet, const void* chi, int nchi,
                            const double* params, void* out, void* stream) {
  if (n < 1 || nchi < 1 ||
      (n + gft::kRhsThreads - 1) / gft::kRhsThreads >= (1LL << 31))
    return gft::kInvalidArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gft::launch_vmec_rhs<float>(n, in, jet, chi, nchi, params, out,
                                       st);
  if (dtype == 1)
    return gft::launch_vmec_rhs<double>(n, in, jet, chi, nchi, params, out,
                                        st);
  return gft::kInvalidArgument;
}
