// The transpose of the spline tables' row gather, written by hand for Hopper
// (sm_90a): out[idx[r], :] += grad[r, :] over the rows r of a (n, width)
// cotangent, into a zeroed (cells, width) table gradient.
//
// It replaces no TPU kernel: the JAX package leaves the VJP of its table
// gathers to XLA.  It was added because PyTorch's own transpose of the
// gather, index_put_ with accumulate, sorts the indices and then sums each
// run of equal indices serially, one column a thread.  Config 5's rays are
// one narrow beam: 125k rays fall in 4 to 6 of the psi table's 16 384 cells,
// so that sum is a chain of some 30 000 dependent loads a call.
//
// What bounds it on this card: bytes.  A call reads the cotangent (n width
// values) and the index (n int64) once, and the table gradient is zeroed and
// written once: 11.1 MB at config 5's batch (125k rows x 16 f32, 16 384
// cells), 3.3 us at 3.35 TB/s.  Per row it does `width` additions.
//
// The design reduces rows that share a cell before any global atomic:
//
//   * A warp takes 32 rows, a lane a row, and loads the row's columns of its
//     block's chunk (kChunk columns, blockIdx.y) as 16-byte vectors where
//     the rows are 16-byte aligned.  __match_any_sync on the cell groups the
//     lanes that share a cell; a shuffle tree over each group's ranks (as
//     long as the warp's largest group needs: none for 32 distinct cells,
//     five steps for one cell) sums the group into its lowest lane.
//   * Each group's leader adds its sums into the block's shared table of
//     kSlots cells (open addressing, a slot claimed by atomicCAS on its key,
//     kProbes slots tried).  A leader whose cell finds no slot adds straight
//     into the output with global atomics, so any distribution of cells is
//     right, rows spread over the whole table included.
//   * The block walks the rows grid-stride; at the end it flushes each
//     occupied slot with one global atomicAdd per (cell, column).
//
// The order of the sums (the tree, then atomics) differs from a serial sum
// and from run to run, so the last bits of a cell's sum may vary between
// runs; every term is added once, in the table's type.  An index outside
// [0, cells) adds nothing (the gather that produced the rows indexed the
// same table, so none occurs).  No --use_fast_math (kernels/build.py).

#include <cuda_runtime.h>

namespace gft {

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kChunk = 16;         // columns a block takes (blockIdx.y)
constexpr int kSlots = 64;         // cells a block's shared table holds
constexpr int kProbes = 8;         // slots a leader tries before global
constexpr int kBlocksPerSm = 2;
constexpr unsigned long long kEmpty = ~0ULL;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInvalidArgument = -1;
static_assert(kSlots == 64, "the slot hash takes the top 6 bits");

// The position of the n-th (from 0) set bit of m; -1 if m has fewer bits.
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  if (n >= __popc(m)) return -1;
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const unsigned low = m & ((1u << half) - 1u);
    const int c = __popc(low);
    if (n >= c) {
      n -= c;
      m >>= half;
      pos += half;
    } else {
      m = low;
    }
  }
  return pos;
}

template <typename T>
struct Vec16;  // the 16-byte vector of T
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int kCount = 4;
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int kCount = 2;
};

// The row's values in columns [c0, c0 + cw) into v[0, cw); zeros after.
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ grad,
                                         long long row, int width, int c0,
                                         int cw, bool vec, T (&v)[kChunk]) {
  const T* src = grad + row * width + c0;
  if (vec) {
    using V = typename Vec16<T>::type;
    constexpr int kPer = Vec16<T>::kCount;
    const V* s = reinterpret_cast<const V*>(src);
#pragma unroll
    for (int k = 0; k < kChunk; k += kPer) {
      if (k < cw) {
        const V x = s[k / kPer];
        const T* xs = reinterpret_cast<const T*>(&x);
#pragma unroll
        for (int e = 0; e < kPer; ++e) v[k + e] = xs[e];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (k < cw) v[k] = src[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    table_scatter_kernel(long long n, int width, long long cells, bool vec,
                         const T* __restrict__ grad,
                         const long long* __restrict__ idx,
                         T* __restrict__ out) {
  __shared__ unsigned long long keys[kSlots];
  __shared__ T sums[kSlots * kChunk];

  const int c0 = blockIdx.y * kChunk;
  const int cw = width - c0 < kChunk ? width - c0 : kChunk;
  for (int e = threadIdx.x; e < kSlots * kChunk; e += kThreads) {
    sums[e] = T(0);
    if (e < kSlots) keys[e] = kEmpty;
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1u;
  const long long tiles = (n + kWarp - 1) / kWarp;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  volatile unsigned long long* vkeys = keys;

  for (long long tile = static_cast<long long>(blockIdx.x) * kWarps +
                        threadIdx.x / kWarp;
       tile < tiles; tile += stride) {
    const long long row = tile * kWarp + lane;
    long long cell = -1;
    if (row < n) {
      cell = idx[row];
      if (cell < 0 || cell >= cells) cell = -1;
    }
    T v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) v[k] = T(0);
    if (cell >= 0) load_row(grad, row, width, c0, cw, vec, v);

    // sum each group of lanes that share a cell into its lowest lane
    const unsigned group = __match_any_sync(kFull, cell);
    const int rank = __popc(group & below);
    const int most = static_cast<int>(
        __reduce_max_sync(kFull, static_cast<unsigned>(__popc(group))));
    for (int s = 1; s < most; s <<= 1) {
      const int src = (rank % (2 * s) == 0) ? nth_set_bit(group, rank + s)
                                            : -1;
      const int from = src >= 0 ? src : lane;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < cw) {
          const T t = __shfl_sync(kFull, v[k], from);
          if (src >= 0) v[k] += t;
        }
      }
    }
    if (rank != 0 || cell < 0) continue;

    // the leader: into the block's table, or straight into the output
    int slot = -1;
    const unsigned home = (static_cast<unsigned>(cell) * 0x9E3779B1u) >> 26;
    for (int p = 0; p < kProbes; ++p) {
      const int s = (home + p) % kSlots;
      const unsigned long long key = vkeys[s];
      if (key == static_cast<unsigned long long>(cell)) {
        slot = s;
        break;
      }
      if (key == kEmpty) {
        const unsigned long long was = atomicCAS(
            &keys[s], kEmpty, static_cast<unsigned long long>(cell));
        if (was == kEmpty || was == static_cast<unsigned long long>(cell)) {
          slot = s;
          break;
        }
      }
    }
    if (slot >= 0) {
      T* to = sums + slot * kChunk;
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < cw) atomicAdd(to + k, v[k]);
    } else {
      T* to = out + cell * width + c0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < cw) atomicAdd(to + k, v[k]);
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kSlots * kChunk; e += kThreads) {
    const unsigned long long key = keys[e / kChunk];
    const int k = e % kChunk;
    if (key != kEmpty && k < cw)
      atomicAdd(out + static_cast<long long>(key) * width + c0 + k, sums[e]);
  }
}

template <typename T>
int launch_table_scatter(long long n, int width, long long cells, bool vec,
                         int sms, const void* grad, const void* idx,
                         void* out, cudaStream_t stream) {
  const long long want = (n + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(kBlocksPerSm) * sms;
  const dim3 grid(static_cast<unsigned>(want < most ? want : most),
                  static_cast<unsigned>((width + kChunk - 1) / kChunk));
  table_scatter_kernel<T><<<grid, kThreads, 0, stream>>>(
      n, width, cells, vec, static_cast<const T*>(grad),
      static_cast<const long long*>(idx), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace gft

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes by kernels/build.py)
// ---------------------------------------------------------------------------

// Add the n rows of grad (n, width), row-major, into the rows idx (n,
// int64) of out (cells, width), which the caller has zeroed.
//   dtype: 0 = float, 1 = double;  vec: 1 where grad's rows may be read as
//   16-byte vectors (width * sizeof(T) a multiple of 16, grad 16-byte
//   aligned), else 0;  sms: the device's multiprocessors (the grid is at
//   most kBlocksPerSm blocks of each).
// Launches on `stream` and returns at once: 0, a cudaError_t from the
// launch, or -1 for an argument the kernel does not take.
extern "C" int gft_table_scatter(int dtype, long long n, int width,
                                 long long cells, const void* grad,
                                 const void* idx, int vec, int sms,
                                 void* out, void* stream) {
  if (n < 0 || width < 1 || cells < 1 || sms < 1 || (vec != 0 && vec != 1) ||
      (dtype != 0 && dtype != 1) ||
      (width + gft::kChunk - 1) / gft::kChunk > 65535)
    return gft::kInvalidArgument;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gft::launch_table_scatter<float>(n, width, cells, vec != 0, sms,
                                            grad, idx, out, st);
  return gft::launch_table_scatter<double>(n, width, cells, vec != 0, sms,
                                           grad, idx, out, st);
}
