// The PIC grid deposit (density and E-field) written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel graph_framework_tpu/pallas/deposit.py::_kernel
// (launched by deposit_pallas).  For every grid point g it computes, over
// all particles p with validity mask m_p,
//
//     n[g] = sum_p exp((x_p - g)^2 / -w) m_p
//     e[g] = sum_p (2 te / (q w)) (x_p - g) m_p
//
// as the TPU kernel does, which evaluated all P x G pairs.  The function
// needs far fewer:
//
//   * e is linear in x: e[g] = coef (S1 - g S0) with S0 = sum m and
//     S1 = sum x m, two sums over the particles.
//   * exp(dx^2 / -w) is exactly +0 once dx^2 / w passes the point where the
//     working type's exp underflows: 103.98 in f32 (ln 2^-150 = -103.972),
//     745.14 in f64 (ln 2^-1075 = -745.133).  The wrapper's reach r =
//     sqrt(Z w) takes Z = 112 in f32 and 760 in f64 (kernels/deposit.py
//     REACH), so every pair beyond r adds +0 with a margin of 3.7% / 1.0%
//     in distance, far above the rounding of dx and of the bins below.
//     Every nonzero term is kept; only the order of the sums differs from
//     the plain version.
//
// Seven launches, all deterministic (fixed-order sums, integer counts, no
// float atomics), for any P and G with no padding:
//
//   1. deposit_setup_kernel (one block): the grid's finite range, and bins
//      of width at most r / kBinsPerCut over [min grid - r, max grid + r]
//      (at most kMaxBins; a wider grid gets wider bins, which is still
//      right, only slower).
//   2. deposit_count_kernel (a block a chunk of kChunk particles, or more
//      above kMaxChunks chunks): each chunk's S0, S1 and count of poisoning
//      particles (a NaN x or a non-finite m), summed in a fixed tree; its
//      integer bin histogram.
//   3. deposit_rows_kernel (a thread a bin) and deposit_bins_kernel (one
//      block): the exclusive scan of the histograms in (bin, chunk) order,
//      as each bin's scan over the chunks plus the scan of the bins'
//      totals (each bin's start); and the chunks' sums in a fixed order.
//   4. deposit_scatter_kernel (a block a chunk): a stable counting sort: the
//      chunk's particles to their bins, in particle order within a bin (a
//      particle's rank among the earlier ones of its bin in its tile of
//      kScatterThreads, then per-bin cursors).  Particles outside every bin
//      (beyond reach of the whole grid, or not finite) are left out of n.
//   5. deposit_tile_kernel (a block a tile of kTile grid points and one of
//      `splits` equal slices of the tile's reach, splits growing with P so
//      that a dense tile's slices stay short): the tile's range is read
//      from the grid itself (any grid, uniform or not, in any order); the
//      particles of the bins within [tile min - r, tile max + r], one bin
//      more each side for the rounding of the bins, are staged through
//      shared memory and every point sums today's per-pair algebra
//      (dx * dx / -w, exp, * m) over them, each of its warp's lanes a
//      point, the block's four warps each a fixed sub-stream.
//   6. deposit_finish_kernel: n[g] sums the slices in order; e[g] =
//      coef (S1 - g S0).  A poisoning particle makes every n[g] NaN, as
//      exp(NaN) 0 and 0 inf do in the plain version's sum; a NaN grid point
//      gets NaN n.
//
// What bounds it on this card: arithmetic on the pairs within reach, 6
// operations each (one exp, one division), about 1e8 pairs at the main
// path's 1M particles x 1000 points in f32 (10% of P x G); the bytes are
// x and the mask read, the binned copy written and read, the grid, n and e.
// The design before this one evaluated all P x G pairs (9 operations each,
// e's three included) in two passes.
//
// Numerics: no --use_fast_math (IEEE division, expf).  S0 of unit weights
// is exact in f32 up to 2^24 particles; S1 and g S0 each round once
// relative to max |e| (chip_smoke.K6_TOL).

#include <cuda_runtime.h>

namespace gft {

namespace {

constexpr int kChunk = 1024;          // particles a histogram, at least
constexpr int kMaxChunks = 4096;      // histograms at most (larger chunks)
constexpr int kCountThreads = 256;
constexpr int kRowThreads = 256;
constexpr int kScatterThreads = 128;
constexpr int kTile = 32;             // grid points a tile (a warp's lanes)
constexpr int kTileGroups = 4;        // warps a tile block, a sub-stream each
constexpr int kTileThreads = kTile * kTileGroups;
constexpr int kStage = 1024;          // particles staged in shared memory
constexpr int kMaxBins = 2048;
constexpr int kBinsPerCut = 32;       // bins of width at most r / 32
constexpr int kMaxSplits = 256;
constexpr int kSplitParticles = 4096;
constexpr int kOneBlockThreads = 1024;
constexpr int kFinishThreads = 256;
constexpr int kInvalidArgument = -1;

__device__ __forceinline__ float dexp(float a) { return expf(a); }
__device__ __forceinline__ double dexp(double a) { return exp(a); }
__device__ __forceinline__ float dmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double dmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float dmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double dmax(double a, double b) { return fmax(a, b); }
// a quiet NaN
__device__ __forceinline__ float dnan(float) { return sqrtf(-1.0f); }
__device__ __forceinline__ double dnan(double) { return sqrt(-1.0); }

// What the setup and the scan kernels leave for the others.
template <typename T>
struct Layout {
  T lo, inv_bw;   // bin of x: (x - lo) * inv_bw, truncated
  T s0, s1;       // sum m, sum x m
  int nbins;
  int bad;        // particles with a NaN x or a non-finite m
};

// The pieces of the wrapper's scratch buffer, each 256-byte aligned.
template <typename T>
struct Scratch {
  Layout<T>* layout;
  T* chunk_sums;     // (chunks, 2): S0, S1 of each chunk
  int* chunk_bad;    // (chunks,)
  int* hist;         // (chunks, kMaxBins): counts, then offsets in the bin
  int* bin_start;    // (kMaxBins + 1,): bin totals, then their scan
  T* bx;             // (n,) x, binned
  T* bm;             // (n,) the mask, binned
  T* partial;        // (splits, num_grid) slices of n
};

inline long long align256(long long a) { return (a + 255) / 256 * 256; }

// Particles a histogram: kChunk, or more where that would make more than
// kMaxChunks histograms.
inline long long chunk_size(long long n) {
  const long long c = (n + kMaxChunks - 1) / kMaxChunks;
  return c > kChunk ? c : kChunk;
}

// The offsets of the scratch's pieces from `base` (nullptr to size it);
// returns its size in bytes.
template <typename T>
long long scratch_layout(char* base, long long n, int num_grid, int splits,
                         Scratch<T>* out) {
  const long long chunks = (n + chunk_size(n) - 1) / chunk_size(n);
  long long at = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + at : nullptr;
    at = align256(at + bytes);
    return p;
  };
  out->layout = reinterpret_cast<Layout<T>*>(take(sizeof(Layout<T>)));
  out->chunk_sums = reinterpret_cast<T*>(take(2 * chunks * sizeof(T)));
  out->chunk_bad = reinterpret_cast<int*>(take(chunks * sizeof(int)));
  out->hist = reinterpret_cast<int*>(take(kMaxBins * chunks * sizeof(int)));
  out->bin_start = reinterpret_cast<int*>(take((kMaxBins + 1) * sizeof(int)));
  out->bx = reinterpret_cast<T*>(take(n * sizeof(T)));
  out->bm = reinterpret_cast<T*>(take(n * sizeof(T)));
  out->partial = reinterpret_cast<T*>(
      take(static_cast<long long>(splits) * num_grid * sizeof(T)));
  return at;
}

inline int split_count(long long n) {
  const long long s = (n + kSplitParticles - 1) / kSplitParticles;
  return static_cast<int>(s < 1 ? 1 : (s > kMaxSplits ? kMaxSplits : s));
}

// ---------------------------------------------------------------------------
// the arithmetic, once (tools/count_ops.py counts these functions)
// ---------------------------------------------------------------------------

// A particle's bin, or -1 outside every bin (NaN fails both comparisons).
template <typename T>
__device__ __forceinline__ int bin_of(T x, T lo, T inv_bw, int nbins) {
  const T u = (x - lo) * inv_bw;
  return (u >= T(0) && u < T(nbins)) ? static_cast<int>(u) : -1;
}

// One pair's density term added to acc: the plain version's algebra.
template <typename T>
__device__ __forceinline__ T deposit_pair(T acc, T x, T m, T gp,
                                          T neg_width) {
  const T dx = x - gp;
  return acc + dexp(dx * dx / neg_width) * m;
}

// One particle's part of S0 = sum m and S1 = sum x m.
template <typename T>
__device__ __forceinline__ void particle_sums(T& s0, T& s1, T x, T m) {
  s0 = s0 + m;
  s1 = s1 + x * m;
}

// e at the grid point gp from the two sums.
template <typename T>
__device__ __forceinline__ T field_at(T gp, T s0, T s1, T coef) {
  return coef * (s1 - gp * s0);
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// Each of the block's N threads' S0, S1 and poison count summed in a fixed
// tree; every thread gets the block's sums back.
template <int N, typename T>
__device__ __forceinline__ void block_sums(T& s0, T& s1, int& bad) {
  __shared__ T r0[N];
  __shared__ T r1[N];
  __shared__ int rb[N];
  const int t = threadIdx.x;
  r0[t] = s0;
  r1[t] = s1;
  rb[t] = bad;
  __syncthreads();
  for (int s = N / 2; s > 0; s >>= 1) {
    if (t < s) {
      r0[t] = r0[t] + r0[t + s];
      r1[t] = r1[t] + r1[t + s];
      rb[t] += rb[t + s];
    }
    __syncthreads();
  }
  s0 = r0[0];
  s1 = r1[0];
  bad = rb[0];
}

template <typename T>
__global__ void __launch_bounds__(kOneBlockThreads)
deposit_setup_kernel(const T* __restrict__ grid, int num_grid, T cut,
                     Layout<T>* __restrict__ layout) {
  __shared__ T smin[kOneBlockThreads];
  __shared__ T smax[kOneBlockThreads];
  __shared__ int sfound[kOneBlockThreads];
  const int t = threadIdx.x;
  T lo = T(0), hi = T(0);
  int found = 0;
  for (int g = t; g < num_grid; g += kOneBlockThreads) {
    const T v = grid[g];
    if (isfinite(v)) {
      lo = found ? dmin(lo, v) : v;
      hi = found ? dmax(hi, v) : v;
      found = 1;
    }
  }
  smin[t] = lo;
  smax[t] = hi;
  sfound[t] = found;
  __syncthreads();
  for (int s = kOneBlockThreads / 2; s > 0; s >>= 1) {
    if (t < s && sfound[t + s]) {
      smin[t] = sfound[t] ? dmin(smin[t], smin[t + s]) : smin[t + s];
      smax[t] = sfound[t] ? dmax(smax[t], smax[t + s]) : smax[t + s];
      sfound[t] = 1;
    }
    __syncthreads();
  }
  if (t == 0) {
    // no finite point: the range [-cut, cut]; its bins stay empty or not,
    // the tiles of such points read none of them
    const T a = smin[0] - cut, b = smax[0] + cut;
    const T want = (b - a) / (cut / T(kBinsPerCut));
    const int nbins = want < T(kMaxBins - 1) ? static_cast<int>(want) + 1
                                             : kMaxBins;
    layout->lo = a;
    layout->inv_bw = T(nbins) / (b - a);
    layout->nbins = nbins;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCountThreads)
deposit_count_kernel(const T* __restrict__ x, const T* __restrict__ mask,
                     long long n, long long chunk,
                     const Layout<T>* __restrict__ layout,
                     int chunks, int* __restrict__ hist,
                     T* __restrict__ chunk_sums, int* __restrict__ chunk_bad) {
  __shared__ int counts[kMaxBins];
  const int t = threadIdx.x, c = blockIdx.x;
  const T lo = layout->lo, inv_bw = layout->inv_bw;
  const int nbins = layout->nbins;
  for (int b = t; b < nbins; b += kCountThreads) counts[b] = 0;
  __syncthreads();
  const long long p0 = c * chunk;
  const long long p1 = p0 + chunk < n ? p0 + chunk : n;
  T s0 = T(0), s1 = T(0);
  int bad = 0;
  for (long long i = p0 + t; i < p1; i += kCountThreads) {
    const T xi = x[i], mi = mask[i];
    particle_sums(s0, s1, xi, mi);
    bad += (isnan(xi) || !isfinite(mi)) ? 1 : 0;
    const int b = bin_of(xi, lo, inv_bw, nbins);
    if (b >= 0) atomicAdd(&counts[b], 1);   // integers: any order, same sum
  }
  block_sums<kCountThreads>(s0, s1, bad);
  if (t == 0) {
    chunk_sums[2 * c] = s0;
    chunk_sums[2 * c + 1] = s1;
    chunk_bad[c] = bad;
  }
  for (int b = t; b < nbins; b += kCountThreads)
    hist[static_cast<long long>(c) * kMaxBins + b] = counts[b];
}

// A thread a bin: the exclusive scan of the bin's column of chunk counts,
// in chunk order, in place (the threads of a warp read neighbouring
// words); the column's total to bin_start[b].
__global__ void __launch_bounds__(kRowThreads)
deposit_rows_kernel(const int* __restrict__ nbins_of, int chunks,
                    int* __restrict__ hist, int* __restrict__ bin_start) {
  const int b = blockIdx.x * kRowThreads + threadIdx.x;
  if (b >= *nbins_of) return;
  int run = 0;
  for (int c = 0; c < chunks; ++c) {
    int* at = hist + static_cast<long long>(c) * kMaxBins + b;
    const int count = *at;
    *at = run;
    run += count;
  }
  bin_start[b] = run;
}

// One block: the exclusive scan of the bin totals (bin_start, in place,
// with the grand total at [nbins]), and the chunks' sums in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kOneBlockThreads)
deposit_bins_kernel(Layout<T>* __restrict__ layout, int chunks,
                    int* __restrict__ bin_start,
                    const T* __restrict__ chunk_sums,
                    const int* __restrict__ chunk_bad) {
  constexpr int kPer = kMaxBins / kOneBlockThreads;
  __shared__ int ssum[kOneBlockThreads];
  const int t = threadIdx.x;
  const int nbins = layout->nbins;
  int mine[kPer];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = t * kPer + j;
    mine[j] = b < nbins ? bin_start[b] : 0;
    sum += mine[j];
  }
  ssum[t] = sum;
  __syncthreads();
  for (int off = 1; off < kOneBlockThreads; off <<= 1) {
    const int v = t >= off ? ssum[t - off] : 0;
    __syncthreads();
    ssum[t] += v;
    __syncthreads();
  }
  int run = ssum[t] - sum;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = t * kPer + j;
    if (b < nbins) bin_start[b] = run;
    run += mine[j];
  }
  if (t == kOneBlockThreads - 1) bin_start[nbins] = ssum[t];

  // the chunks' sums, each thread's chunks in order, then the tree
  T s0 = T(0), s1 = T(0);
  int bad = 0;
  for (int c = t; c < chunks; c += kOneBlockThreads) {
    s0 = s0 + chunk_sums[2 * c];
    s1 = s1 + chunk_sums[2 * c + 1];
    bad += chunk_bad[c];
  }
  block_sums<kOneBlockThreads>(s0, s1, bad);
  if (t == 0) {
    layout->s0 = s0;
    layout->s1 = s1;
    layout->bad = bad;
  }
}

template <typename T>
__global__ void __launch_bounds__(kScatterThreads)
deposit_scatter_kernel(const T* __restrict__ x, const T* __restrict__ mask,
                       long long n, long long chunk,
                       const Layout<T>* __restrict__ layout,
                       int chunks, const int* __restrict__ offsets,
                       const int* __restrict__ bin_start,
                       T* __restrict__ bx, T* __restrict__ bm) {
  __shared__ int cursor[kMaxBins];
  __shared__ int tile_count[kMaxBins];
  __shared__ int tile_bin[kScatterThreads];
  const int t = threadIdx.x, c = blockIdx.x;
  const T lo = layout->lo, inv_bw = layout->inv_bw;
  const int nbins = layout->nbins;
  for (int b = t; b < nbins; b += kScatterThreads) {
    cursor[b] = bin_start[b] + offsets[static_cast<long long>(c) * kMaxBins + b];
    tile_count[b] = 0;
  }
  __syncthreads();
  const long long p0 = c * chunk;
  const long long p1 = p0 + chunk < n ? p0 + chunk : n;
  for (long long base = p0; base < p1; base += kScatterThreads) {
    const long long i = base + t;
    T xi = T(0), mi = T(0);
    int b = -1;
    if (i < p1) {
      xi = x[i];
      mi = mask[i];
      b = bin_of(xi, lo, inv_bw, nbins);
    }
    tile_bin[t] = b;
    __syncthreads();
    // the particle's rank among the earlier ones of its bin in this tile
    int rank = 0;
    if (b >= 0) {
      for (int k = 0; k < t; ++k) rank += tile_bin[k] == b ? 1 : 0;
      atomicAdd(&tile_count[b], 1);
    }
    __syncthreads();
    if (b >= 0) {
      const int pos = cursor[b] + rank;
      bx[pos] = xi;
      bm[pos] = mi;
    }
    __syncthreads();
    if (b >= 0 && rank == 0) {
      cursor[b] += tile_count[b];
      tile_count[b] = 0;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
deposit_tile_kernel(const T* __restrict__ grid, int num_grid,
                    const Layout<T>* __restrict__ layout,
                    const int* __restrict__ bin_start,
                    const T* __restrict__ bx, const T* __restrict__ bm,
                    T* __restrict__ partial, T neg_width, T cut, int splits) {
  __shared__ T sx[kStage];
  __shared__ T sm[kStage];
  __shared__ T red[kTileGroups][kTile];
  __shared__ T tile_grid[kTile];
  __shared__ int range[2];
  const int t = threadIdx.x, lane = t % kTile, group = t / kTile;
  const int g0 = blockIdx.x * kTile;
  const int g = g0 + lane;
  const T gp = g < num_grid ? grid[g] : T(0);
  if (group == 0) tile_grid[lane] = gp;
  __syncthreads();
  if (t == 0) {
    const int valid = num_grid - g0 < kTile ? num_grid - g0 : kTile;
    T tmin = T(0), tmax = T(0);
    bool found = false;
    for (int k = 0; k < valid; ++k) {
      const T v = tile_grid[k];
      if (isfinite(v)) {
        tmin = found ? dmin(tmin, v) : v;
        tmax = found ? dmax(tmax, v) : v;
        found = true;
      }
    }
    long long begin = 0, end = 0;
    if (found) {
      const T lo = layout->lo, inv_bw = layout->inv_bw;
      const T top = T(layout->nbins - 1);
      // the bins of [tmin - cut, tmax + cut], clamped, one more each side
      const T u0 = dmin(dmax((tmin - cut - lo) * inv_bw, T(0)), top);
      const T u1 = dmin(dmax((tmax + cut - lo) * inv_bw, T(0)), top);
      const int b0 = static_cast<int>(u0) > 0 ? static_cast<int>(u0) - 1 : 0;
      const int b1 = static_cast<int>(u1) < layout->nbins - 1
                         ? static_cast<int>(u1) + 1
                         : layout->nbins - 1;
      begin = bin_start[b0];
      end = bin_start[b1 + 1];
    }
    const long long len = end - begin;
    range[0] = static_cast<int>(begin + len * blockIdx.y / splits);
    range[1] = static_cast<int>(begin + len * (blockIdx.y + 1) / splits);
  }
  __syncthreads();
  const int a = range[0], e = range[1];
  T acc = T(0);
  for (int s = a; s < e; s += kStage) {
    const int len = e - s < kStage ? e - s : kStage;
    for (int k = t; k < len; k += kTileThreads) {
      sx[k] = bx[s + k];
      sm[k] = bm[s + k];
    }
    __syncthreads();
    // every lane of the warp reads the same particle: a broadcast
    for (int k = group; k < len; k += kTileGroups)
      acc = deposit_pair(acc, sx[k], sm[k], gp, neg_width);
    __syncthreads();
  }
  red[group][lane] = acc;
  __syncthreads();
  if (group == 0 && g < num_grid) {
    T v = red[0][lane];
#pragma unroll
    for (int q = 1; q < kTileGroups; ++q) v = v + red[q][lane];
    partial[static_cast<long long>(blockIdx.y) * num_grid + g] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
deposit_finish_kernel(const T* __restrict__ grid, int num_grid,
                      const Layout<T>* __restrict__ layout,
                      const T* __restrict__ partial, int splits, T coef,
                      T* __restrict__ n_out, T* __restrict__ e_out) {
  const int g = blockIdx.x * kFinishThreads + threadIdx.x;
  if (g >= num_grid) return;
  const T gp = grid[g];
  T acc = partial[g];
  for (int s = 1; s < splits; ++s)
    acc = acc + partial[static_cast<long long>(s) * num_grid + g];
  if (layout->bad != 0 || isnan(gp)) acc = dnan(acc);
  n_out[g] = acc;
  e_out[g] = field_at(gp, layout->s0, layout->s1, coef);
}

template <typename T>
int launch_deposit(long long n, int num_grid, const void* x_v,
                   const void* mask_v, const void* grid_v, void* scratch,
                   void* n_out, void* e_out, const double* params,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_v);
  const T* mask = static_cast<const T*>(mask_v);
  const T* grid = static_cast<const T*>(grid_v);
  const long long chunk = chunk_size(n);
  const int chunks = static_cast<int>((n + chunk - 1) / chunk);
  const int splits = split_count(n);
  const int tiles = (num_grid + kTile - 1) / kTile;
  const T neg_width = T(params[0]), coef = T(params[1]), cut = T(params[2]);
  Scratch<T> s;
  scratch_layout<T>(static_cast<char*>(scratch), n, num_grid, splits, &s);
  int err;
  deposit_setup_kernel<T><<<1, kOneBlockThreads, 0, stream>>>(
      grid, num_grid, cut, s.layout);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  deposit_count_kernel<T><<<chunks, kCountThreads, 0, stream>>>(
      x, mask, n, chunk, s.layout, chunks, s.hist, s.chunk_sums,
      s.chunk_bad);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  deposit_rows_kernel<<<kMaxBins / kRowThreads, kRowThreads, 0, stream>>>(
      &s.layout->nbins, chunks, s.hist, s.bin_start);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  deposit_bins_kernel<T><<<1, kOneBlockThreads, 0, stream>>>(
      s.layout, chunks, s.bin_start, s.chunk_sums, s.chunk_bad);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  deposit_scatter_kernel<T><<<chunks, kScatterThreads, 0, stream>>>(
      x, mask, n, chunk, s.layout, chunks, s.hist, s.bin_start, s.bx, s.bm);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const dim3 tile_grid(tiles, splits);
  deposit_tile_kernel<T><<<tile_grid, kTileThreads, 0, stream>>>(
      grid, num_grid, s.layout, s.bin_start, s.bx, s.bm, s.partial,
      neg_width, cut, splits);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  deposit_finish_kernel<T>
      <<<(num_grid + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0,
         stream>>>(grid, num_grid, s.layout, s.partial, splits, coef,
                   static_cast<T*>(n_out), static_cast<T*>(e_out));
  return static_cast<int>(cudaGetLastError());
}

bool bad_deposit_args(long long n, int num_grid) {
  return n < 1 || n > 0x7fffffffLL || num_grid < 1 || num_grid > (1 << 29);
}

}  // namespace

}  // namespace gft

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes by kernels/build.py)
// ---------------------------------------------------------------------------

// Bytes of scratch gft_deposit needs for n particles and num_grid points
// (dtype: 0 = float, 1 = double), or -1 for arguments it does not take.
extern "C" long long gft_deposit_scratch_bytes(int dtype, long long n,
                                               int num_grid) {
  if (gft::bad_deposit_args(n, num_grid) || (dtype != 0 && dtype != 1))
    return gft::kInvalidArgument;
  const int splits = gft::split_count(n);
  if (dtype == 0) {
    gft::Scratch<float> s;
    return gft::scratch_layout<float>(nullptr, n, num_grid, splits, &s);
  }
  gft::Scratch<double> s;
  return gft::scratch_layout<double>(nullptr, n, num_grid, splits, &s);
}

// Deposit n particles onto num_grid points.
//   dtype: 0 = float, 1 = double;
//   x, mask: (n,) particle positions and validity weights, 1 <= n < 2^31;
//   grid: (num_grid,) point positions, in any order;
//   scratch: gft_deposit_scratch_bytes(dtype, n, num_grid) bytes, 256-byte
//     aligned;
//   n_out, e_out: (num_grid,) density and field;
//   params: (-w) (2 te / (q w)) r, with w > 0 and r the reach (no pair
//     farther apart adds anything but +0), each finite.
// Launches its seven kernels on `stream` and returns at once: 0, a
// cudaError_t from a launch, or -1 for an argument the kernels do not take.
extern "C" int gft_deposit(int dtype, long long n, int num_grid,
                           const void* x, const void* mask, const void* grid,
                           void* scratch, void* n_out, void* e_out,
                           const double* params, void* stream) {
  if (gft::bad_deposit_args(n, num_grid) || !(params[0] < 0.0) ||
      !(params[2] > 0.0) || !(params[2] < 1e300))
    return gft::kInvalidArgument;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gft::launch_deposit<float>(n, num_grid, x, mask, grid, scratch,
                                      n_out, e_out, params, st);
  if (dtype == 1)
    return gft::launch_deposit<double>(n, num_grid, x, mask, grid, scratch,
                                       n_out, e_out, params, st);
  return gft::kInvalidArgument;
}
