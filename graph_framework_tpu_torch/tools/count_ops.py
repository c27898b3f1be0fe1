"""Count the floating point operations of the CUDA kernels, per work item.

    python -m graph_framework_tpu_torch.tools.count_ops

Each kernel of ``csrc/`` is compiled on the host with ``g++`` (no CUDA:
a stand-in ``cuda_runtime.h`` maps the CUDA keywords to C++, and each
``kernel<<<grid, block, 0, stream>>>(...)`` launch becomes a plain call)
and instantiated over ``Counted``, a scalar type whose every addition,
subtraction, multiplication, division, square root, exp, min and max adds
one to a global count, and a sincos two (negation adds none: the card
folds it into the next instruction).  Running one thread of a kernel over one work item then
counts exactly the operations the source asks for on that item - the
forward-mode dual numbers of the window kernels included - before the
compiler contracts any pair into an FMA.

Prints one JSON object: operations per ray and window of K substeps for
the window kernels K1 (rk2/rk4, plain/compensated), K2 and K3 (rk2/rk4;
no K3 for a dispersion that reads no table), for each dispersion they
implement (the eleven of DISPERSION_LABELS),
at K = 10 (the main path's freeze window) and per substep.  Each counts
what the function needs (``_k1_needed``, ``_window_needed``): K1's
source does just that, K2/K3's repeat the primal work, and the sources'
own counts stand beside as ``source_per_ray_window``.  Then per particle and step for the slab push
K5 (a square root, rsqrt or reciprocal counts one); for the deposit K6
per (particle, grid point) pair within reach, per particle (e's two sums
and the bin) and per grid point (e); per ray, as a fixed part and a part per
mode, for the VMEC geometry jet K4 (over the reference's 86 modes in 10
runs) and the mode sums K7 (a sincos counts two).  K4's
operations that depend on its tables alone (products of mode numbers,
doubled coefficients, ds^2) are counted apart, as ``table_fixed`` and
``table_per_mode``: the function needs them once, not once a ray.  K7's
shuffle tree counts the 31 adds a sum whose results reach lane 0.  Per
ray for the VMEC ray RHS K8 (a sincos counts two).
``chip_smoke.py`` takes the window kernels' counts for their
``bound_ms``; ``kernels.boris.SLAB_PUSH_OPS``,
``kernels.deposit.DEPOSIT_OPS``, ``kernels.vmec_geom.JET_OPS``,
``kernels.vmec_modes.MODE_SUM_OPS`` and ``kernels.vmec_rhs.RHS_OPS`` must
equal the counts here
(tests/test_torch_common.py checks all of them where g++ is present).

:func:`host_library` is the host build itself; with ``every_thread`` it
runs a launch over every block and thread, a warp's collectives exchanged
among its lanes, so a kernel's C interface runs on host memory
(tests/test_torch_efit_bwd_host.py runs K2 and K3 so,
tests/test_torch_table_gather.py the table scatter).
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

from graph_framework_tpu_torch.kernels import efit_step

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"

#: Substeps per window of the main path (chip_smoke.FREEZE_EVERY).
WINDOW = 10
#: Modes of the reference's VMEC file, K4's count's layout (10 runs).
REFERENCE_MODES = 86
#: The window kernels' dispersions in the order of their codes
#: (kernels/efit_step.py KERNEL_TAILS), as the keys name them: "K1 rk2
#: comp" is cold plasma's, "K1 omode rk2 comp" the O mode's.  A dispersion
#: that reads no table has no K3 and no K3 key.
DISPERSION_LABELS = tuple(f" {t.tag}" if t.tag else ""
                          for t in efit_step.KERNEL_TAILS)

_RUNTIME = r"""
#pragma once
#include <algorithm>
#include <cmath>
#ifdef GFT_EVERY_THREAD
#include <barrier>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#endif
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __restrict__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
typedef void* cudaStream_t;
inline thread_local dim3 blockIdx(0, 0, 0), threadIdx(0, 0, 0);
inline dim3 blockDim(1), gridDim(1);
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "host"; }
inline float sqrtf(float a) { return std::sqrt(a); }
inline float expf(float a) { return std::exp(a); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float fminf(float a, float b) { return std::fmin(a, b); }
using std::exp; using std::fmax; using std::fmin; using std::sqrt;
using std::isfinite; using std::isnan;
// shared-memory integer atomics (K6's histograms)
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
// floating point atomics, a 64-bit compare-and-swap and a bit count (the
// table scatter)
template <class T> T host_atomic_add(T* p, T v) {
  T old, sum;
  __atomic_load(p, &old, __ATOMIC_SEQ_CST);
  do {
    sum = old + v;
  } while (!__atomic_compare_exchange(p, &old, &sum, false, __ATOMIC_SEQ_CST,
                                      __ATOMIC_SEQ_CST));
  return old;
}
inline float atomicAdd(float* p, float v) { return host_atomic_add(p, v); }
inline double atomicAdd(double* p, double v) { return host_atomic_add(p, v); }
inline unsigned long long atomicCAS(unsigned long long* p,
                                    unsigned long long expected,
                                    unsigned long long desired) {
  __atomic_compare_exchange_n(p, &expected, desired, false, __ATOMIC_SEQ_CST,
                              __ATOMIC_SEQ_CST);
  return expected;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline void sincosf(float a, float* s, float* c) { *s = std::sin(a); *c = std::cos(a); }
// PTX wrappers of the kernels (the card's approximations; here rounded
// from double)
inline float rsqrt_approx(float a) { return static_cast<float>(1.0 / std::sqrt(static_cast<double>(a))); }
inline float rcp_approx(float a) { return static_cast<float>(1.0 / static_cast<double>(a)); }
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __shfl_down_sync(unsigned, T v, int) { return v; }
#ifdef GFT_EVERY_THREAD
// A launch runs the blocks of its grid one after another, each block's
// blockDim.x threads together, one std::thread each: __syncthreads waits at
// the block's barrier, a thread that returns leaves it (as on the card), and
// shared memory (static above) belongs to the block that runs.
inline std::barrier<>* g_block_barrier = nullptr;
inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }
// A warp's collectives (__shfl_sync, __match_any_sync, __reduce_max_sync):
// its lanes (32, fewer in a block's ragged last warp) meet at a barrier of
// their own and exchange through a slot each, so every lane of the warp must
// reach each collective, as the full mask asks on the card.
struct HostWarp {
  std::barrier<> meet;
  unsigned lanes;
  alignas(16) unsigned char slot[32][16];
  explicit HostWarp(unsigned n) : meet(n), lanes(n) {}
};
inline std::vector<std::unique_ptr<HostWarp>> g_warps;
template <class T> HostWarp& host_warp_gather(T v, T (&all)[32]) {
  static_assert(sizeof(T) <= 16, "a warp slot holds 16 bytes");
  HostWarp& w = *g_warps[threadIdx.x / 32];
  std::memcpy(w.slot[threadIdx.x % 32], &v, sizeof(T));
  w.meet.arrive_and_wait();
  for (unsigned i = 0; i < w.lanes; ++i) std::memcpy(&all[i], w.slot[i], sizeof(T));
  w.meet.arrive_and_wait();
  return w;
}
template <class T> T __shfl_sync(unsigned, T v, int lane) {
  T all[32];
  host_warp_gather(v, all);
  return all[lane];
}
template <class T> unsigned __match_any_sync(unsigned, T v) {
  T all[32];
  const HostWarp& w = host_warp_gather(v, all);
  unsigned same = 0;
  for (unsigned i = 0; i < w.lanes; ++i) same |= (all[i] == v ? 1u : 0u) << i;
  return same;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  unsigned all[32];
  const HostWarp& w = host_warp_gather(v, all);
  unsigned most = 0;
  for (unsigned i = 0; i < w.lanes; ++i) most = all[i] > most ? all[i] : most;
  return most;
}
template <class F> void host_launch(dim3 grid, dim3 block, F f) {
  gridDim = grid;
  blockDim = block;
  const unsigned nt = block.x;
  g_warps.clear();
  for (unsigned t = 0; t < nt; t += 32)
    g_warps.push_back(std::make_unique<HostWarp>(nt - t < 32 ? nt - t : 32));
  auto block_barrier = std::make_unique<std::barrier<>>(nt);
  g_block_barrier = block_barrier.get();
  auto next_block = [&]() noexcept {
    block_barrier = std::make_unique<std::barrier<>>(nt);
    g_block_barrier = block_barrier.get();
  };
  std::barrier<decltype(next_block)> between(nt, next_block);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < nt; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t, 0, 0);
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          blockIdx = dim3(bx, by, 0);
          f();
          g_block_barrier->arrive_and_drop();
          between.arrive_and_wait();
        }
    });
  for (auto& th : threads) th.join();
  blockDim = gridDim = dim3(1);
}
#else
// the counter's launch: one call, for the one work item it sets up
inline void __syncthreads() {}
template <class F> void host_launch(dim3, dim3, F f) { f(); }
#endif

// the counting scalar.  With g_split set, a value carries whether it
// depends on an input the harness tags (`tag`), and an operation none of
// whose operands does goes to g_untagged_ops instead.  K4's harness tags
// the ray's coordinates: an untagged operation depends on the tables
// alone, and a table could hold its result.  K2/K3's tags the cotangents:
// an untagged operation is primal work.
inline long long g_ops = 0, g_untagged_ops = 0;
inline bool g_split = false;
struct Counted {
  double v;
  bool tag;
  Counted() : v(0), tag(false) {}
  Counted(double a) : v(a), tag(false) {}
  Counted(double a, bool r) : v(a), tag(r) {}
  // a read through a volatile pointer (shared memory that stays there)
  Counted(const volatile Counted& a) : v(a.v), tag(a.tag) {}
  explicit operator int() const { return static_cast<int>(v); }
  // comparisons count nothing (they are not arithmetic)
  friend bool operator<(Counted a, Counted b) { return a.v < b.v; }
  friend bool operator>=(Counted a, Counted b) { return a.v >= b.v; }
  friend bool operator==(Counted a, Counted b) { return a.v == b.v; }
  static Counted op(double r, bool tag, int n = 1) {
    (g_split && !tag ? g_untagged_ops : g_ops) += n;
    return Counted(r, tag);
  }
  Counted& operator+=(Counted b) { return *this = op(v + b.v, tag || b.tag); }
  Counted& operator-=(Counted b) { return *this = op(v - b.v, tag || b.tag); }
  friend Counted operator+(Counted a, Counted b) { return op(a.v + b.v, a.tag || b.tag); }
  friend Counted operator-(Counted a, Counted b) { return op(a.v - b.v, a.tag || b.tag); }
  friend Counted operator*(Counted a, Counted b) { return op(a.v * b.v, a.tag || b.tag); }
  friend Counted operator/(Counted a, Counted b) { return op(a.v / b.v, a.tag || b.tag); }
  friend Counted operator-(Counted a) { return Counted(-a.v, a.tag); }
  friend Counted gsqrt(Counted a) { return op(std::sqrt(a.v), a.tag); }
  friend Counted bsqrt(Counted a) { return op(std::sqrt(a.v), a.tag); }
  friend Counted dexp(Counted a) { return op(std::exp(a.v), a.tag); }
  friend Counted gexp(Counted a) { return op(std::exp(a.v), a.tag); }
  friend Counted recip(Counted a) { return op(1.0 / a.v, a.tag); }
  // a reciprocal square root or a reciprocal counts one, as a root does
  friend Counted brsqrt(Counted a) { return op(1.0 / std::sqrt(a.v), a.tag); }
  friend Counted brcp(Counted a) { return op(1.0 / a.v, a.tag); }
  friend Counted gmax(Counted a, Counted b) { return op(std::fmax(a.v, b.v), a.tag || b.tag); }
  friend Counted gmin(Counted a, Counted b) { return op(std::fmin(a.v, b.v), a.tag || b.tag); }
  friend Counted mul_rn(Counted a, Counted b) { return op(a.v * b.v, a.tag || b.tag); }
  friend Counted add_rn(Counted a, Counted b) { return op(a.v + b.v, a.tag || b.tag); }
  friend Counted sub_rn(Counted a, Counted b) { return op(a.v - b.v, a.tag || b.tag); }
  // one sine and one cosine
  friend void gsincos(Counted a, Counted* s, Counted* c) {
    op(0.0, a.tag, 2);
    *s = Counted(std::sin(a.v), a.tag);
    *c = Counted(std::cos(a.v), a.tag);
  }
};

// A warp's shuffle tree: at offset o only the sums of lanes below o reach
// lane 0, so the add that takes a shuffled value on any other lane (the
// kernels write `acc += __shfl_down_sync(...)`) is taken back here.
inline Counted __shfl_down_sync(unsigned, Counted v, int offset) {
  if (threadIdx.x % 32 >= static_cast<unsigned>(offset)) --g_ops;
  return v;
}
"""

_WINDOW_HARNESS = r"""
namespace gft {
static Counted state[16], outs[16], cts[16], psi[64], prof[32], blocks[32];
static long long cells[2];

Params<Counted> params() {
  // a 2 x 2 psi grid and 2 profile cells; the values only need to be finite
  const double a[17] = {1.0, 1.0, -1.0, 1.0, 0.0, 1.0, 1e18, 1e3,
                        3.0e-3, -5.0e2, 1.0e-6, 0.3, 1e-4,
                        1.0, 3.9e-3, 5.3e-10, 1.6e-9};
  for (int k = 0; k < 64; ++k) psi[k] = 0.01 * (k % 7);
  for (int k = 0; k < 32; ++k) prof[k] = 0.1 * (k % 5) + 0.5;
  const double s[8] = {0.0, 500.0, 1.5, 0.1, 0.2, -400.0, 150.0, 10.0};
  for (int k = 0; k < 8; ++k) state[k] = state[8 + k] = cts[k] = s[k];
  return make_params<Counted>(a, 2, 2, 2);
}

StatePtrs<Counted> ptrs(Counted* base) {
  StatePtrs<Counted> p;
  for (int k = 0; k < 16; ++k) p.p[k] = base + k;
  return p;
}

// K2, or K3 where Disp reads the map (a dispersion that reads no table has
// no K3: nothing runs)
template <typename Disp>
void run_bwd(int method, int tab, int steps, const Params<Counted>& p) {
  if (method == 2 && !tab)
    efit_window_bwd_kernel<Counted, 2, false, Disp>(ptrs(state), ptrs(cts), ptrs(outs), psi, prof, p, steps, 1, blocks, blocks + 16, cells, cells + 1);
  if (method == 4 && !tab)
    efit_window_bwd_kernel<Counted, 4, false, Disp>(ptrs(state), ptrs(cts), ptrs(outs), psi, prof, p, steps, 1, blocks, blocks + 16, cells, cells + 1);
  if constexpr (Disp::kReadsEq) {
    if (method == 2 && tab)
      efit_window_bwd_kernel<Counted, 2, true, Disp>(ptrs(state), ptrs(cts), ptrs(outs), psi, prof, p, steps, 1, blocks, blocks + 16, cells, cells + 1);
    if (method == 4 && tab)
      efit_window_bwd_kernel<Counted, 4, true, Disp>(ptrs(state), ptrs(cts), ptrs(outs), psi, prof, p, steps, 1, blocks, blocks + 16, cells, cells + 1);
  }
}

template <typename Disp>
void run_fwd(int method, int flag, int steps, const Params<Counted>& p) {
  if (method == 2 && !flag)
    efit_window_kernel<Counted, 2, false, Disp>(ptrs(state), ptrs(outs), psi, prof, p, steps, 1);
  if (method == 2 && flag)
    efit_window_kernel<Counted, 2, true, Disp>(ptrs(state), ptrs(outs), psi, prof, p, steps, 1);
  if (method == 4 && !flag)
    efit_window_kernel<Counted, 4, false, Disp>(ptrs(state), ptrs(outs), psi, prof, p, steps, 1);
  if (method == 4 && flag)
    efit_window_kernel<Counted, 4, true, Disp>(ptrs(state), ptrs(outs), psi, prof, p, steps, 1);
}

template <typename Disp>
long long primal(int method, int steps, const Params<Counted>& p) {
  Counted s[8];
  for (int k = 0; k < 8; ++k) s[k] = state[k];
  g_ops = 0;
  const Frozen<Counted> f = freeze_for<Disp>(s, psi, prof, p);
  for (int k = 0; k < steps; ++k) {
    if (method == 2) substep<Disp, Counted, 2>(s, f, p);
    else substep<Disp, Counted, 4>(s, f, p);
  }
  return g_ops;
}

// `call` with Disp the tail of the code disp (GFT_DISPERSIONS)
#define GFT_DISP_IF(code, D) \
  if (gft_disp == (code)) gft_call(D{});
#define GFT_BY_DISP(disp, call)                    \
  do {                                             \
    const int gft_disp = (disp);                   \
    auto gft_call = [&](auto tail) {               \
      using Disp = decltype(tail);                 \
      call;                                        \
    };                                             \
    GFT_DISPERSIONS(GFT_DISP_IF)                   \
  } while (0)
}  // namespace gft

extern "C" long long count_window(int disp, int fwd, int method, int flag,
                                  int steps) {
  using namespace gft;
  const Params<Counted> p = params();
  g_ops = 0;
  if (fwd) GFT_BY_DISP(disp, run_fwd<Disp>(method, flag, steps, p));
  else GFT_BY_DISP(disp, run_bwd<Disp>(method, flag, steps, p));
  return g_ops;
}

// K2 (tab 0) or K3 with the cotangents tagged: *adjoint gets what depends
// on them, which the kernel does once; *primal the rest, which it repeats
// (see count_ops.py _window_needed).
extern "C" void count_window_bwd_split(int disp, int method, int tab,
                                       int steps, long long* adjoint,
                                       long long* primal) {
  using namespace gft;
  const Params<Counted> p = params();
  for (int k = 0; k < 16; ++k) cts[k].tag = true;
  g_ops = g_untagged_ops = 0;
  g_split = true;
  GFT_BY_DISP(disp, run_bwd<Disp>(method, tab, steps, p));
  g_split = false;
  for (int k = 0; k < 16; ++k) cts[k].tag = false;
  *adjoint = g_ops;
  *primal = g_untagged_ops;
}

// The freeze gather and `steps` substeps as the backward kernels' forward
// sweep takes them (substep<Disp, T, METHOD>, the stepping K1 runs).
extern "C" long long count_window_primal(int disp, int method, int steps) {
  using namespace gft;
  const Params<Counted> p = params();
  long long ops = 0;
  GFT_BY_DISP(disp, ops = primal<Disp>(method, steps, p));
  return ops;
}
"""

_SLAB_HARNESS = r"""
extern "C" long long count_slab(int steps) {
  using namespace gft;
  static Counted in[6] = {1.7, 0.0, 0.0, 0.0, 7.0, 0.7}, out[6];
  Particles<Counted> p;
  for (int k = 0; k < 6; ++k) { p.in[k] = in + k; p.out[k] = out + k; }
  const SlabParams<Counted> c{0.25, 0.1, 1.0, -0.25, 0.5};
  g_ops = 0;
  slab_push_kernel<Counted>(p, c, steps, 1);
  return g_ops;
}
"""

_VMEC_GEOM_HARNESS = r"""
// The reference's 86 modes as K4 takes them, 10 runs (m, n0, len): m = 0
// with n = 0..4, then m = 1..9 with n = -4..4; nfp 5.  `extra` more modes
// lengthen the last run.
extern "C" void count_vmec_geom(int extra, long long* ops,
                                long long* table_ops) {
  using namespace gft;
  // the ray's coordinates are its own; the tables and mode numbers are not
  static Counted s[1] = {{0.5, true}}, u[1] = {{0.3, true}},
      v[1] = {{0.2, true}}, out[27];
  static Counted rz[2 * 8 * 128], lm[2 * 4 * 128];
  static int runs[30];
  for (int k = 0; k < 2 * 8 * 128; ++k) rz[k] = 0.01 * (k % 7);
  for (int k = 0; k < 2 * 4 * 128; ++k) lm[k] = 0.01 * (k % 5);
  runs[0] = 0; runs[1] = 0; runs[2] = 5;
  for (int m = 1; m < 10; ++m) {
    runs[3 * m] = m; runs[3 * m + 1] = -4; runs[3 * m + 2] = 9;
  }
  runs[29] += extra;
  g_ops = g_untagged_ops = 0;
  g_split = true;
  vmec_geom_kernel<Counted>(s, u, v, rz, lm, runs, 10, out, 1, 2, 2,
                            86 + extra, -1.0, -0.99, 0.01, 5.0);
  g_split = false;
  *ops = g_ops;
  *table_ops = g_untagged_ops;
}
"""

_VMEC_RHS_HARNESS = r"""
// K8 for one ray: every operation depends on the ray (its state, its jet,
// its cell of the chi table)
extern "C" long long count_vmec_rhs() {
  using namespace gft;
  static Counted w[1] = {900.0}, s[1] = {0.5}, u[1] = {0.3}, v[1] = {0.2},
      ks[1] = {99.0}, ku[1] = {1.0}, kv[1] = {-1.0}, jet[27], chi[8], out[6];
  for (int k = 0; k < 27; ++k) jet[k] = 0.1 * (k % 5 + 1);
  for (int k = 0; k < 8; ++k) chi[k] = 0.01 * (k + 1);
  const RhsLeaves<Counted> st{{w, s, u, v, ks, ku, kv}};
  RhsParams<Counted> q{};
  q.sminf = -1.0;
  q.ds = 1.0;
  q.phip = -0.3;
  q.plasma.kpe = 3.0e-3;
  q.plasma.kce = -5.0e2;
  q.plasma.kpi = 1.0e-6;
  q.plasma.kci = 0.3;
  q.nchi = 2;
  g_ops = 0;
  vmec_rhs_kernel<Counted>(st, jet, chi, q, out, 1);
  return g_ops;
}
"""

_VMEC_MODES_HARNESS = r"""
extern "C" long long count_vmec_modes(int m) {
  using namespace gft;
  static Counted u[1] = {0.3}, v[1] = {0.2}, rows[5][128], xm[128], xn[128],
      out[10];
  ModeBlocks<Counted> b;
  for (int k = 0; k < 5; ++k) {
    for (int j = 0; j < m; ++j) rows[k][j] = 0.01 * (j + k);
    b.p[k] = rows[k];
  }
  for (int j = 0; j < m; ++j) { xm[j] = j % 10; xn[j] = 5.0 * (j % 9) - 20.0; }
  g_ops = 0;
  // the 32 lanes of the ray's warp, one after another
  blockDim.x = 32;
  for (unsigned lane = 0; lane < 32; ++lane) {
    threadIdx.x = lane;
    vmec_modes_kernel<Counted>(u, v, b, xm, xn, out, 1, m);
  }
  threadIdx.x = 0;
  blockDim.x = 1;
  return g_ops;
}
"""

_DEPOSIT_HARNESS = r"""
// K6's arithmetic, as its kernels call it: a pair within reach (the tile
// kernel's inner loop), a particle (its part of S0 and S1, and its bin),
// a grid point (e from the sums).
extern "C" void count_deposit(long long* per_pair, long long* per_particle,
                              long long* per_point) {
  using namespace gft;
  Counted acc(0.0), s0(0.0), s1(0.0);
  g_ops = 0;
  acc = deposit_pair<Counted>(acc, 0.01, 1.0, 0.0, -1e-4);
  *per_pair = g_ops;
  g_ops = 0;
  particle_sums<Counted>(s0, s1, 0.01, 1.0);
  bin_of<Counted>(0.01, -1.1, 100.0, 220);
  *per_particle = g_ops;
  g_ops = 0;
  field_at<Counted>(0.5, s0, s1, 2e4);
  *per_point = g_ops;
}
"""


def _host_source(src: str) -> str:
    """A CUDA source with each ``kernel<<<g, b, 0, s>>>(args);`` launch
    turned into a plain call, ``host_launch(g, b, [&] { kernel(args); })``."""
    src = re.sub(r">\s*\n\s*<<<", "><<<", src)
    out, i = [], 0
    for m in re.finditer(
            r"([A-Za-z_][\w:]*(?:<[^;{}()]*?>)?)\s*<<<(.*?)>>>\(", src,
            flags=re.S):
        if m.start() < i:
            continue
        depth, j = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[j], 0)
            j += 1
        grid, block = [a.strip() for a in m[2].split(",")[:2]]
        out.append(src[i:m.start()])
        out.append(f"host_launch(dim3({grid}), dim3({block}), [&] {{ "
                   f"{m[1]}({src[m.end():j - 1]}); }})")
        i = j
    out.append(src[i:])
    return "".join(out)


#: g++ processes a host build runs at once (one a unit).
HOST_JOBS = 4


def host_library(tmp: pathlib.Path, units: dict, *, every_thread=False,
                 flags=("-O0",)) -> pathlib.Path:
    """Compile ``units`` ({file name: C++ source}) with ``g++`` into one
    shared library in ``tmp``, over the stand-in ``cuda_runtime.h`` and
    every source of ``csrc/`` with its launches rewritten (a unit includes
    them by name): one ``g++ -c`` a unit, HOST_JOBS at a time, then one
    link.  With ``every_thread`` a launch runs the kernel once for each
    (block, thread), as the card would, so the C interfaces run on host
    memory; otherwise once, for the counter."""
    from concurrent.futures import ThreadPoolExecutor

    (tmp / "cuda_runtime.h").write_text(
        ("#define GFT_EVERY_THREAD\n" if every_thread else "") + _RUNTIME)
    for src in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")):
        (tmp / src.name).write_text(_host_source(src.read_text()))
    for name, text in units.items():
        (tmp / name).write_text(text)
    gxx = ["g++", "-std=c++20", *flags, "-pthread", "-fPIC", "-w", "-I",
           str(tmp)]

    def run(cmd):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{proc.stderr[-4000:]}")

    objs = [tmp / f"{name}.o" for name in units]
    with ThreadPoolExecutor(HOST_JOBS) as pool:
        list(pool.map(run, [[*gxx, "-c", "-o", str(o), str(tmp / n)]
                            for n, o in zip(units, objs)]))
    lib = tmp / "libhost.so"
    run([*gxx, "-shared", "-o", str(lib), *map(str, objs)])
    return lib


def _build(tmp: pathlib.Path) -> pathlib.Path:
    """Compile the counting programs into one shared library."""
    units = {
        "window.cpp": ('#include "cuda_runtime.h"\n'
                       'namespace gft { using ::Counted; using ::g_ops; }\n'
                       '#include "efit_window.cuh"\n'
                       '#include "efit_window_bwd.cuh"\n' + _WINDOW_HARNESS),
        "slab.cpp": ('#include "cuda_runtime.h"\n'
                     'namespace gft { using ::Counted; using ::g_ops; }\n'
                     '#include "boris.cu"\n' + _SLAB_HARNESS),
        "deposit.cpp": ('#include "cuda_runtime.h"\n'
                        'namespace gft { using ::Counted; using ::g_ops; }\n'
                        '#include "deposit.cu"\n' + _DEPOSIT_HARNESS),
        "vmec_geom.cpp": ('#include "cuda_runtime.h"\n'
                          'namespace gft { using ::Counted; using ::g_ops; }\n'
                          '#include "vmec_geom.cu"\n' + _VMEC_GEOM_HARNESS),
        "vmec_rhs.cpp": ('#include "cuda_runtime.h"\n'
                         'namespace gft { using ::Counted; using ::g_ops; }\n'
                         '#include "vmec_rhs.cu"\n' + _VMEC_RHS_HARNESS),
        "vmec_modes.cpp": ('#include "cuda_runtime.h"\n'
                           'namespace gft { using ::Counted; using ::g_ops; }'
                           '\n#include "vmec_modes.cu"\n'
                           + _VMEC_MODES_HARNESS),
    }
    return host_library(tmp, units)


def count() -> dict:
    """The operation counts (see the module docstring)."""
    import ctypes

    if shutil.which("g++") is None:
        raise RuntimeError("count_ops needs g++")
    with tempfile.TemporaryDirectory() as tmpdir:
        lib = ctypes.CDLL(str(_build(pathlib.Path(tmpdir))))
        for name in ("count_window", "count_window_primal", "count_slab",
                     "count_vmec_modes", "count_vmec_rhs"):
            getattr(lib, name).restype = ctypes.c_longlong
        out = {}
        for disp, (mode, tail) in enumerate(
                zip(DISPERSION_LABELS, efit_step.KERNEL_TAILS)):
            for method in (2, 4):
                for flag, name in enumerate(("plain", "comp")):
                    one, two, per_window = (
                        _k1_needed(lib, disp, method, flag, k)
                        for k in (1, 2, WINDOW))
                    out[f"K1{mode} rk{method} {name}"] = {
                        "per_ray_window": per_window,
                        "per_ray_substep": two - one,
                        "source_per_ray_window":
                            lib.count_window(disp, 1, method, flag, WINDOW)}
            for name, tab in (("K2", 0), ("K3", 1))[:1 + tail.reads_map]:
                for method in (2, 4):
                    one, two, per_window = (
                        _window_needed(lib, disp, method, tab, k)
                        for k in (1, 2, WINDOW))
                    out[f"{name}{mode} rk{method}"] = {
                        "per_ray_window": per_window,
                        "per_ray_substep": two - one,
                        "source_per_ray_window":
                            lib.count_window(disp, 0, method, tab, WINDOW)}
        out["K5"] = {"per_particle_step":
                     lib.count_slab(2) - lib.count_slab(1)}
        out["K6"] = _deposit(lib)
        one, two = lib.count_vmec_modes(1), lib.count_vmec_modes(2)
        out["K7"] = {"per_mode": two - one, "per_ray_fixed": 2 * one - two}
        (one, one_t), (two, two_t) = _vmec_geom(lib, 0), _vmec_geom(lib, 1)
        g = REFERENCE_MODES
        out["K4"] = {"per_mode": two - one,
                     "per_ray_fixed": one - g * (two - one),
                     "table_per_mode": two_t - one_t,
                     "table_fixed": one_t - g * (two_t - one_t)}
        out["K8"] = {"per_ray": lib.count_vmec_rhs()}
    return {"window": WINDOW, "ops": out}


def _k1_needed(lib, disp, method, compensated, steps):
    """The operations a ray over ``steps`` substeps that K1 computes,
    counted as the function needs them: the freeze gather and the stages
    with D's gradient by the hand-written reverse sweep
    (``count_window_primal``, as K2/K3's primal work is counted), plus the
    compensated sums' work, the difference of K1's own compensated and
    plain counts.  K1's source runs exactly these stages, so its own count
    (``source_per_ray_window``) is the same; the forward-mode source before
    it did some five times the operations."""
    extra = (lib.count_window(disp, 1, method, 1, steps)
             - lib.count_window(disp, 1, method, 0, steps)
             ) if compensated else 0
    return lib.count_window_primal(disp, method, steps) + extra


def _window_needed(lib, disp, method, tab, steps):
    """The operations a ray over ``steps`` substeps that K2 (tab 0) or K3
    (tab 1) computes, each counted once.  The kernel repeats primal work:
    its forward sweep takes each stage's gradient of D, ``substep_vjp``
    takes it again, and the ``Dual<T, 1>`` sweep of each stage VJP runs it
    a third time as its value part.  The function needs that work once:
    the freeze gather and the stages of every substep, as the forward sweep
    takes them (the last substep's update included, 19 operations in rk2,
    33 in rk4).  The adjoint work, what depends on the cotangents (the
    transposed stage algebra, each sweep's tangent part, K3's weights'
    tangents), the kernel does once.  K3 also needs the values of its
    blocks' weights u^a v^b and up^k, primal work that K2 does not do: the
    difference of the two kernels' primal counts."""
    import ctypes

    def split(t):
        adjoint, primal = ctypes.c_longlong(), ctypes.c_longlong()
        lib.count_window_bwd_split(disp, method, t, steps,
                                   ctypes.byref(adjoint),
                                   ctypes.byref(primal))
        return adjoint.value, primal.value

    adjoint, primal = split(tab)
    needed = lib.count_window_primal(disp, method, steps) + adjoint
    if tab:
        needed += primal - split(0)[1]
    return needed


def _deposit(lib):
    """K6's operations: a pair within reach, a particle, a grid point."""
    import ctypes

    counts = [ctypes.c_longlong() for _ in range(3)]
    lib.count_deposit(*[ctypes.byref(c) for c in counts])
    return dict(zip(("per_pair", "per_particle", "per_point"),
                    (c.value for c in counts)))


def _vmec_geom(lib, extra):
    """K4's operations for one ray over the reference's 86 modes and
    ``extra`` more on the last run: (those that depend on the ray, those
    that depend on the tables alone)."""
    import ctypes

    ops, table_ops = ctypes.c_longlong(), ctypes.c_longlong()
    lib.count_vmec_geom(extra, ctypes.byref(ops), ctypes.byref(table_ops))
    return ops.value, table_ops.value


if __name__ == "__main__":
    json.dump(count(), sys.stdout, indent=1)
    print()
