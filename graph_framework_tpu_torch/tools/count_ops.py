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
the window kernels K1 (rk2/rk4, plain/compensated), K2 and K3 (rk2/rk4),
at K = 10 (the main path's freeze window) and per substep; per particle
and step for the slab push K5; per (particle, grid point) pair for the
deposit K6; per ray, as a fixed part and a part per mode, for the VMEC
geometry jet K4 and the mode sums K7 (a sincos counts two).  K4's
operations that depend on its tables alone (products of mode numbers,
doubled coefficients, ds^2) are counted apart, as ``table_fixed`` and
``table_per_mode``: the function needs them once, not once a ray.  K7's
shuffle tree counts the 31 adds a sum whose results reach lane 0.
``chip_smoke.py`` takes the window kernels' counts for their
``bound_ms``; ``kernels.boris.SLAB_PUSH_OPS``,
``kernels.deposit.DEPOSIT_OPS_PER_PAIR``, ``kernels.vmec_geom.JET_OPS``
and ``kernels.vmec_modes.MODE_SUM_OPS`` must equal the counts here
(tests/test_torch_common.py checks all of them where g++ is present).
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"

#: Substeps per window of the main path (chip_smoke.FREEZE_EVERY).
WINDOW = 10

_RUNTIME = r"""
#pragma once
#include <algorithm>
#include <cmath>
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
inline dim3 blockIdx(0, 0, 0), threadIdx(0, 0, 0), blockDim(1), gridDim(1);
inline void __syncthreads() {}
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "host"; }
inline float sqrtf(float a) { return std::sqrt(a); }
inline float expf(float a) { return std::exp(a); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float fminf(float a, float b) { return std::fmin(a, b); }
using std::exp; using std::fmax; using std::fmin; using std::sqrt;
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline void sincosf(float a, float* s, float* c) { *s = std::sin(a); *c = std::cos(a); }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __shfl_down_sync(unsigned, T v, int) { return v; }
template <class F> void host_launch(dim3, dim3, F f) { f(); }

// the counting scalar.  With g_split set, a value carries whether it
// depends on the work item (`ray`, set by the harness on its inputs), and
// an operation none of whose operands does goes to g_table_ops instead:
// it depends on the tables alone, and a table could hold its result.
inline long long g_ops = 0, g_table_ops = 0;
inline bool g_split = false;
struct Counted {
  double v;
  bool ray;
  Counted() : v(0), ray(false) {}
  Counted(double a) : v(a), ray(false) {}
  Counted(double a, bool r) : v(a), ray(r) {}
  explicit operator int() const { return static_cast<int>(v); }
  static Counted op(double r, bool ray, int n = 1) {
    (g_split && !ray ? g_table_ops : g_ops) += n;
    return Counted(r, ray);
  }
  Counted& operator+=(Counted b) { return *this = op(v + b.v, ray || b.ray); }
  Counted& operator-=(Counted b) { return *this = op(v - b.v, ray || b.ray); }
  friend Counted operator+(Counted a, Counted b) { return op(a.v + b.v, a.ray || b.ray); }
  friend Counted operator-(Counted a, Counted b) { return op(a.v - b.v, a.ray || b.ray); }
  friend Counted operator*(Counted a, Counted b) { return op(a.v * b.v, a.ray || b.ray); }
  friend Counted operator/(Counted a, Counted b) { return op(a.v / b.v, a.ray || b.ray); }
  friend Counted operator-(Counted a) { return Counted(-a.v, a.ray); }
  friend Counted gsqrt(Counted a) { return op(std::sqrt(a.v), a.ray); }
  friend Counted bsqrt(Counted a) { return op(std::sqrt(a.v), a.ray); }
  friend Counted dexp(Counted a) { return op(std::exp(a.v), a.ray); }
  friend Counted recip(Counted a) { return op(1.0 / a.v, a.ray); }
  friend Counted gmax(Counted a, Counted b) { return op(std::fmax(a.v, b.v), a.ray || b.ray); }
  friend Counted gmin(Counted a, Counted b) { return op(std::fmin(a.v, b.v), a.ray || b.ray); }
  friend Counted mul_rn(Counted a, Counted b) { return op(a.v * b.v, a.ray || b.ray); }
  friend Counted add_rn(Counted a, Counted b) { return op(a.v + b.v, a.ray || b.ray); }
  friend Counted sub_rn(Counted a, Counted b) { return op(a.v - b.v, a.ray || b.ray); }
  // one sine and one cosine
  friend void gsincos(Counted a, Counted* s, Counted* c) {
    op(0.0, a.ray, 2);
    *s = Counted(std::sin(a.v), a.ray);
    *c = Counted(std::cos(a.v), a.ray);
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
  const double a[13] = {1.0, 1.0, -1.0, 1.0, 0.0, 1.0, 1e18, 1e3,
                        3.0e-3, -5.0e2, 1.0e-6, 0.3, 1e-4};
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
}  // namespace gft

extern "C" long long count_window(int fwd, int method, int flag, int steps) {
  using namespace gft;
  const Params<Counted> p = params();
  g_ops = 0;
  if (fwd) {
    if (method == 2 && !flag)
      efit_window_kernel<Counted, 2, false>(ptrs(state), ptrs(outs), psi, prof, p, steps, 1);
    if (method == 2 && flag)
      efit_window_kernel<Counted, 2, true>(ptrs(state), ptrs(outs), psi, prof, p, steps, 1);
    if (method == 4 && !flag)
      efit_window_kernel<Counted, 4, false>(ptrs(state), ptrs(outs), psi, prof, p, steps, 1);
    if (method == 4 && flag)
      efit_window_kernel<Counted, 4, true>(ptrs(state), ptrs(outs), psi, prof, p, steps, 1);
  } else {
    if (method == 2 && !flag)
      efit_window_bwd_kernel<Counted, 2, false>(ptrs(state), ptrs(cts), ptrs(outs), psi, prof, p, steps, 1, blocks, blocks + 16, cells, cells + 1);
    if (method == 2 && flag)
      efit_window_bwd_kernel<Counted, 2, true>(ptrs(state), ptrs(cts), ptrs(outs), psi, prof, p, steps, 1, blocks, blocks + 16, cells, cells + 1);
    if (method == 4 && !flag)
      efit_window_bwd_kernel<Counted, 4, false>(ptrs(state), ptrs(cts), ptrs(outs), psi, prof, p, steps, 1, blocks, blocks + 16, cells, cells + 1);
    if (method == 4 && flag)
      efit_window_bwd_kernel<Counted, 4, true>(ptrs(state), ptrs(cts), ptrs(outs), psi, prof, p, steps, 1, blocks, blocks + 16, cells, cells + 1);
  }
  return g_ops;
}
"""

_SLAB_HARNESS = r"""
extern "C" long long count_slab(int steps) {
  using namespace gft;
  static Counted in[6] = {1.7, 0.0, 0.0, 0.0, 7.0, 0.7}, out[6];
  Particles<Counted> p;
  for (int k = 0; k < 6; ++k) { p.in[k] = in + k; p.out[k] = out + k; }
  const SlabParams<Counted> c{0.5, 1.0, 1.0, 0.1, -0.25, 0.5};
  g_ops = 0;
  slab_push_kernel<Counted>(p, c, steps, 1);
  return g_ops;
}
"""

_VMEC_GEOM_HARNESS = r"""
extern "C" void count_vmec_geom(int g, long long* ops, long long* table_ops) {
  using namespace gft;
  // the ray's coordinates are its own; the tables and mode numbers are not
  static Counted s[1] = {{0.5, true}}, u[1] = {{0.3, true}},
      v[1] = {{0.2, true}}, out[27];
  static Counted rz[2 * 8 * 128], lm[2 * 4 * 128], xm[128], xn[128];
  for (int k = 0; k < 2 * 8 * 128; ++k) rz[k] = 0.01 * (k % 7);
  for (int k = 0; k < 2 * 4 * 128; ++k) lm[k] = 0.01 * (k % 5);
  for (int k = 0; k < g; ++k) { xm[k] = k % 10; xn[k] = 5.0 * (k % 9) - 20.0; }
  g_ops = g_table_ops = 0;
  g_split = true;
  vmec_geom_kernel<Counted>(s, u, v, rz, lm, xm, xn, out, 1, 2, 2, g,
                            -1.0, -0.99, 0.01);
  g_split = false;
  *ops = g_ops;
  *table_ops = g_table_ops;
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
extern "C" long long count_deposit(int particles) {
  using namespace gft;
  static Counted x[4096], mask[4096], grid[1] = {0.0}, partial[2];
  for (int k = 0; k < particles; ++k) { x[k] = 1e-3 * k; mask[k] = 1.0; }
  g_ops = 0;
  deposit_partial_kernel<Counted>(x, mask, grid, partial, particles, 1,
                                  particles, -1e-4, 2e4);
  return g_ops;
}
"""


def _host_source(src: str) -> str:
    """A CUDA source with each ``kernel<<<g, b, 0, s>>>(args);`` launch
    turned into a plain call, ``host_launch(g, b, [&] { kernel(args); })``."""
    src = re.sub(r">\s*\n\s*<<<", "><<<", src)
    out, i = [], 0
    for m in re.finditer(r"([A-Za-z_][\w:]*<[^;{}()]*?>)\s*<<<(.*?)>>>\(",
                         src, flags=re.S):
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


def _build(tmp: pathlib.Path) -> pathlib.Path:
    """Compile the host programs into one shared library."""
    (tmp / "cuda_runtime.h").write_text(_RUNTIME)
    for src in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")):
        (tmp / src.name).write_text(_host_source(src.read_text()))
    units = {
        "window.cpp": ('#include "cuda_runtime.h"\n'
                       'namespace gft { using ::Counted; using ::g_ops; }\n'
                       '#include "efit_window.cu"\n'
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
        "vmec_modes.cpp": ('#include "cuda_runtime.h"\n'
                           'namespace gft { using ::Counted; using ::g_ops; }'
                           '\n#include "vmec_modes.cu"\n'
                           + _VMEC_MODES_HARNESS),
    }
    for name, text in units.items():
        (tmp / name).write_text(text)
    lib = tmp / "libcount.so"
    cmd = ["g++", "-std=c++17", "-O0", "-fPIC", "-shared", "-w", "-I",
           str(tmp), "-o", str(lib), *[str(tmp / n) for n in units]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{proc.stderr[-4000:]}")
    return lib


def count() -> dict:
    """The operation counts (see the module docstring)."""
    import ctypes

    if shutil.which("g++") is None:
        raise RuntimeError("count_ops needs g++")
    with tempfile.TemporaryDirectory() as tmpdir:
        lib = ctypes.CDLL(str(_build(pathlib.Path(tmpdir))))
        for name in ("count_window", "count_slab", "count_deposit",
                     "count_vmec_modes"):
            getattr(lib, name).restype = ctypes.c_longlong
        out = {}
        for fwd, flag_name in ((1, ("plain", "comp")), (0, ("K2", "K3"))):
            for method in (2, 4):
                for flag in (0, 1):
                    key = (f"K1 rk{method} {flag_name[flag]}" if fwd
                           else f"{flag_name[flag]} rk{method}")
                    per_window = lib.count_window(fwd, method, flag, WINDOW)
                    one = lib.count_window(fwd, method, flag, 1)
                    two = lib.count_window(fwd, method, flag, 2)
                    out[key] = {"per_ray_window": per_window,
                                "per_ray_substep": two - one}
        out["K5"] = {"per_particle_step":
                     lib.count_slab(2) - lib.count_slab(1)}
        out["K6"] = {"per_pair": (lib.count_deposit(2048)
                                  - lib.count_deposit(1024)) // 1024}
        one, two = lib.count_vmec_modes(1), lib.count_vmec_modes(2)
        out["K7"] = {"per_mode": two - one, "per_ray_fixed": 2 * one - two}
        (one, one_t), (two, two_t) = _vmec_geom(lib, 1), _vmec_geom(lib, 2)
        out["K4"] = {"per_mode": two - one, "per_ray_fixed": 2 * one - two,
                     "table_per_mode": two_t - one_t,
                     "table_fixed": 2 * one_t - two_t}
    return {"window": WINDOW, "ops": out}


def _vmec_geom(lib, g):
    """K4's operations over g modes for one ray: (those that depend on the
    ray, those that depend on the tables alone)."""
    import ctypes

    ops, table_ops = ctypes.c_longlong(), ctypes.c_longlong()
    lib.count_vmec_geom(g, ctypes.byref(ops), ctypes.byref(table_ops))
    return ops.value, table_ops.value


if __name__ == "__main__":
    json.dump(count(), sys.stdout, indent=1)
    print()
