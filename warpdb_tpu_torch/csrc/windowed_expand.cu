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
// Here each block of 1024 outputs finds the owners of its first and last
// row with a warp-wide 32-ary search over the whole offsets array, then
// each thread binary-searches its outputs' owners inside that range.  Any
// offsets work: there is no span gate and no fallback.
//
// Bound: device-memory bandwidth on the written rows (8 bytes of owner and
// dup plus 4 per column) and the gathered words.  Writes are coalesced;
// owners are nondecreasing in r, so the gathers of neighbouring threads hit
// the same or neighbouring words.  The searches read offsets that a dense
// expansion keeps in L1 (a block's owners span at most 1024 rows with
// nonzero counts).  Words move as unsigned ints, so the copy is bit-exact.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kBlock = kThreads * kPerThread;
constexpr int kMaxCols = 16;

struct Cols {
  const unsigned* src[kMaxCols];
};

// First index in [lo, hi) whose offset exceeds r (hi when none), found by
// all 32 lanes of a warp: each round probes 32 evenly spaced positions.
__device__ long long warp_upper_bound(const long long* __restrict__ off,
                                      long long lo, long long hi,
                                      long long r) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long pos = lo + (lane + 1) * step - 1;
    const bool le = pos < hi && __ldg(off + pos) <= r;
    const long long m = __popc(__ballot_sync(0xffffffffu, le));
    const long long nlo = min(lo + m * step, hi);
    hi = min(lo + (m + 1) * step - 1, hi);
    lo = nlo;
  }
  const long long pos = lo + lane;
  const bool le = pos < hi && __ldg(off + pos) <= r;
  return lo + __popc(__ballot_sync(0xffffffffu, le));
}

__global__ void __launch_bounds__(kThreads)
windowed_expand_kernel(const long long* __restrict__ off, long long n,
                       long long total, Cols cols, int ncols,
                       unsigned* __restrict__ out, long long out_stride,
                       int* __restrict__ owner_out,
                       int* __restrict__ dup_out) {
  __shared__ long long s_first, s_last;
  const long long base = (long long)blockIdx.x * kBlock;
  const long long last = min(base + kBlock, total) - 1;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long p = warp_upper_bound(off, 0, n, warp == 0 ? base : last) - 1;
    if ((threadIdx.x & 31) == 0) (warp == 0 ? s_first : s_last) = p;
  }
  __syncthreads();
  long long lo = s_first;
  const long long end = s_last + 1;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long r = base + threadIdx.x + (long long)j * kThreads;
    if (r > last) break;
    // off[lo] <= r, and the owner lies in [lo, end).
    long long a = lo + 1, b = end;
    while (a < b) {
      const long long mid = (a + b) >> 1;
      if (__ldg(off + mid) <= r) {
        a = mid + 1;
      } else {
        b = mid;
      }
    }
    const long long owner = a - 1;
    lo = owner;
    if (owner_out != nullptr) owner_out[r] = (int)owner;
    if (dup_out != nullptr) dup_out[r] = (int)(r - __ldg(off + owner));
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < ncols) out[c * out_stride + r] = __ldg(cols.src[c] + owner);
    }
  }
}

}  // namespace

// offsets: int64[n], nondecreasing, offsets[0] == 0, every offset <= total;
// src: host array of ncols device pointers; out: ncols rows of out_stride
// words; owner and dup (int32[total]) may be null.
extern "C" int warpdb_windowed_expand(const void* offsets, long long n,
                                      long long total, const void* src,
                                      int ncols, void* out,
                                      long long out_stride, void* owner,
                                      void* dup, void* stream) {
  if (ncols < 1 || ncols > kMaxCols || n < 1 || total < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Cols cols = {};
  const void* const* ptrs = static_cast<const void* const*>(src);
  for (int c = 0; c < ncols; ++c) {
    cols.src[c] = static_cast<const unsigned*>(ptrs[c]);
  }
  const long long grid = (total + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  windowed_expand_kernel<<<(unsigned)grid, kThreads, 0, s>>>(
      static_cast<const long long*>(offsets), n, total, cols, ncols,
      static_cast<unsigned*>(out), out_stride, static_cast<int*>(owner),
      static_cast<int*>(dup));
  return static_cast<int>(cudaGetLastError());
}
