"""Count the floating point operations of the CUDA kernels, per work item.

    python -m graph_framework_tpu_torch.tools.count_ops

Each kernel of ``csrc/`` is compiled on the host with ``g++`` (no CUDA:
a stand-in ``cuda_runtime.h`` maps the CUDA keywords to C++, and each
``kernel<<<grid, block, 0, stream>>>(...)`` launch becomes a plain call)
and instantiated over ``Counted``, a scalar type whose every addition,
subtraction, multiplication, division, square root, exp, min and max adds
one to a global count (negation adds none: the card folds it into the next
instruction).  Running one thread of a kernel over one work item then
counts exactly the operations the source asks for on that item - the
forward-mode dual numbers of the window kernels included - before the
compiler contracts any pair into an FMA.

Prints one JSON object: operations per ray and window of K substeps for
the window kernels K1 (rk2/rk4, plain/compensated), K2 and K3 (rk2/rk4),
at K = 10 (the main path's freeze window) and per substep; per particle
and step for the slab push K5; per (particle, grid point) pair for the
deposit K6.  ``chip_smoke.py`` takes the window kernels' counts for their
``bound_ms``; ``kernels.boris.SLAB_PUSH_OPS`` and
``kernels.deposit.DEPOSIT_OPS_PER_PAIR`` must equal the counts here
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
template <class T> T __ldg(const T* p) { return *p; }
template <class F> void host_launch(dim3, dim3, F f) { f(); }

// the counting scalar
inline long long g_ops = 0;
struct Counted {
  double v;
  Counted() : v(0) {}
  Counted(double a) : v(a) {}
  explicit operator int() const { return static_cast<int>(v); }
  Counted& operator+=(Counted b) { ++g_ops; v += b.v; return *this; }
  friend Counted operator+(Counted a, Counted b) { ++g_ops; return a.v + b.v; }
  friend Counted operator-(Counted a, Counted b) { ++g_ops; return a.v - b.v; }
  friend Counted operator*(Counted a, Counted b) { ++g_ops; return a.v * b.v; }
  friend Counted operator/(Counted a, Counted b) { ++g_ops; return a.v / b.v; }
  friend Counted operator-(Counted a) { return -a.v; }
  friend Counted gsqrt(Counted a) { ++g_ops; return std::sqrt(a.v); }
  friend Counted bsqrt(Counted a) { ++g_ops; return std::sqrt(a.v); }
  friend Counted dexp(Counted a) { ++g_ops; return std::exp(a.v); }
  friend Counted recip(Counted a) { ++g_ops; return 1.0 / a.v; }
  friend Counted gmax(Counted a, Counted b) { ++g_ops; return std::fmax(a.v, b.v); }
  friend Counted gmin(Counted a, Counted b) { ++g_ops; return std::fmin(a.v, b.v); }
  friend Counted mul_rn(Counted a, Counted b) { ++g_ops; return a.v * b.v; }
  friend Counted add_rn(Counted a, Counted b) { ++g_ops; return a.v + b.v; }
};
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
    """Compile the three host programs into one shared library."""
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
        for name in ("count_window", "count_slab", "count_deposit"):
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
    return {"window": WINDOW, "ops": out}


if __name__ == "__main__":
    json.dump(count(), sys.stdout, indent=1)
    print()
