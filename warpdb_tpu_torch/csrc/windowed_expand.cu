// Join expansion with ownership (kernel K3).
//
// Replaces warpdb_tpu/ops/pallas_expand.py:windowed_expand.  Given the
// exclusive prefix sums `offsets` of each probe row's emission count, every
// output row r < total belongs to the last probe row whose offset is <= r
// (zero-count rows tie on offsets with their successor and never end up
// last).  The kernel writes that owner, dup = r - offsets[owner] (the
// duplicate's rank inside its owner's build range) and up to 16 4-byte
// columns gathered at the owner.  The TPU kernel finds owners by counting
// inside a 2048-row VMEM window and selects with a one-hot MXU product over
// bf16 byte planes, so it needs a host gate proving every block's owners
// fit the window, with a general scatter + gather as the other branch.
//
// Bound: device-memory bandwidth (8 bytes of offset per probe row, 4 per
// column of each emitting row, 8 of owner and dup plus 4 per column per
// output).  The design keeps every access coalesced and takes the searches
// off device memory: a load-balanced expansion by merge path, as CUB's
// run-length decode and moderngpu's load-balancing search do.
//
// * The merged sequence of probe rows and outputs (row i >= 1 sorts before
//   output r when offsets[i] <= r) is cut into tiles of kTile items.  A
//   small partition kernel finds each tile's split (outputs before it) by
//   one binary search over device memory per tile.
// * A tile's rows are contiguous, [b0, b1].  The block copies their
//   offsets and the words of up to kGroup columns at them into shared
//   memory with asynchronous copies (cp.async): one round trip to device
//   memory per tile, all loads in flight together, no registers held.
// * Each thread merges its kPerThread items serially in shared memory and
//   records each output's owner there.  Runs of zero-count rows cost one
//   merged item each, so a tile whose owners span many rows (the
//   unmatched probe rows of an inner join) is no larger than any other.
// * Every output is written by consecutive threads from shared memory:
//   coalesced stores, no gather from device memory.  More than kGroup
//   columns take one more round trip per group.
//
// Words move as unsigned ints, so the copy is bit-exact.  Launches on the
// caller's stream, allocates nothing (`part` is the caller's scratch of
// one int64 per tile and one more), returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxCols = 16;
// Columns staged in shared memory together (the first group with the
// tile's offsets, in one round trip).
constexpr int kGroup = 4;

struct Cols {
  const unsigned* src[kMaxCols];
};

// Outputs among the first d merged items: the merge path of outputs
// A[a] = a against row starts B[j] = off[1 + j], rows first on ties.
__global__ void __launch_bounds__(kThreads)
partition_kernel(const long long* __restrict__ off, long long n,
                 long long total, long long items, long long tiles,
                 long long* __restrict__ part) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t > tiles) return;
  const long long d = min(t * kTile, items);
  long long lo = max(0ll, d - (n - 1)), hi = min(d, total);
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (mid < __ldg(off + d - mid)) {  // off[1 + (d - 1 - mid)]
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  part[t] = lo;
}

// Asynchronous copies from device to shared memory (cp.async): a tile's
// loads are all in flight at once and hold no registers.
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(kBytes));
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows b0 .. b0 + nb of one array into shared memory.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long b0,
                                      int nb) {
  for (int j = threadIdx.x; j <= nb; j += kThreads) {
    copy_async<sizeof(T)>(dst + j, src + b0 + j);
  }
}

// Columns c0 .. c0 + kGroup - 1 (those below ncols) into their slots.
__device__ __forceinline__ void stage_group(unsigned* s_col, const Cols& cols,
                                            int c0, int ncols, long long b0,
                                            int nb) {
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    if (c0 + q < ncols) stage(s_col + q * (kTile + 1), cols.src[c0 + q], b0, nb);
  }
}

// Dynamic shared memory: offsets (kTile + 1 int64), owners (kTile int32),
// then min(ncols, kGroup) column slots of kTile + 1 words.
__global__ void __launch_bounds__(kThreads)
windowed_expand_kernel(const long long* __restrict__ off, long long items,
                       const long long* __restrict__ part, Cols cols,
                       int ncols, unsigned* __restrict__ out,
                       long long out_stride, int* __restrict__ owner_out,
                       int* __restrict__ dup_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_off = reinterpret_cast<long long*>(smem);
  int* s_own = reinterpret_cast<int*>(s_off + kTile + 1);
  unsigned* s_col = reinterpret_cast<unsigned*>(s_own + kTile);

  const long long d0 = (long long)blockIdx.x * kTile;
  const long long d1 = min(d0 + kTile, items);
  const long long a0 = __ldg(part + blockIdx.x);
  const long long b0 = d0 - a0;
  const int na = (int)(__ldg(part + blockIdx.x + 1) - a0);
  const int nb = (int)(d1 - d0) - na;
  const int tid = threadIdx.x;

  // The tile's rows b0 .. b0 + nb: their offsets and the first columns.
  stage(s_off, off, b0, nb);
  stage_group(s_col, cols, 0, ncols, b0, nb);
  wait_copies();
  __syncthreads();

  // Each thread merges items [dt, dt + kPerThread) of the tile: find its
  // split, then walk, taking row j + 1 while its offset is <= the next
  // output.  s_off[1 + j] is row b0 + 1 + j's offset.
  const int dt = min(tid * kPerThread, na + nb);
  int lo = max(0, dt - nb), hi = min(dt, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a0 + mid < s_off[dt - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int a = lo, b = dt - lo;
  const int end = min(dt + kPerThread, na + nb);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (a + b < end) {
      if (b < nb && (a >= na || s_off[b + 1] <= a0 + a)) {
        ++b;
      } else {
        s_own[a++] = b;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < na; i += kThreads) {
    const int o = s_own[i];
    const long long r = a0 + i;
    if (dup_out != nullptr) dup_out[r] = (int)(r - s_off[o]);
    if (owner_out != nullptr) owner_out[r] = (int)(b0 + o);
  }
#pragma unroll
  for (int c0 = 0; c0 < kMaxCols; c0 += kGroup) {
    if (c0 < ncols) {
      if (c0 > 0) {  // the next group, once the last one is written
        __syncthreads();
        stage_group(s_col, cols, c0, ncols, b0, nb);
        wait_copies();
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (c0 + q < ncols) {
          const unsigned* words = s_col + q * (kTile + 1);
          unsigned* dst = out + (c0 + q) * out_stride + a0;
          for (int i = tid; i < na; i += kThreads) dst[i] = words[s_own[i]];
        }
      }
    }
  }
}

}  // namespace

// offsets: int64[n], nondecreasing, offsets[0] == 0, every offset <= total;
// src: host array of ncols device pointers; out: ncols rows of out_stride
// words; owner and dup (int32[total]) may be null; part: scratch of
// part_len >= ceil((total + n - 1) / 1024) + 1 int64.
extern "C" int warpdb_windowed_expand(const void* offsets, long long n,
                                      long long total, const void* src,
                                      int ncols, void* out,
                                      long long out_stride, void* owner,
                                      void* dup, void* part,
                                      long long part_len, void* stream) {
  const long long items = total + n - 1;
  const long long tiles = (items + kTile - 1) / kTile;
  if (ncols < 1 || ncols > kMaxCols || n < 1 || total < 1 ||
      part_len < tiles + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Cols cols = {};
  const void* const* ptrs = static_cast<const void* const*>(src);
  for (int c = 0; c < ncols; ++c) {
    cols.src[c] = static_cast<const unsigned*>(ptrs[c]);
  }
  const long long* off = static_cast<const long long*>(offsets);
  long long* p = static_cast<long long*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  partition_kernel<<<(unsigned)((tiles + kThreads) / kThreads), kThreads, 0,
                     s>>>(off, n, total, items, tiles, p);
  const int group = ncols < kGroup ? ncols : kGroup;
  const size_t smem = (kTile + 1) * sizeof(long long) + kTile * sizeof(int) +
                      group * (kTile + 1) * sizeof(unsigned);
  windowed_expand_kernel<<<(unsigned)tiles, kThreads, smem, s>>>(
      off, items, p, cols, ncols, static_cast<unsigned*>(out), out_stride,
      static_cast<int*>(owner), static_cast<int*>(dup));
  return static_cast<int>(cudaGetLastError());
}
