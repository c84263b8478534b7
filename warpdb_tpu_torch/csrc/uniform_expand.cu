// Uniform fan-out expansion of 4-byte columns (kernel K4).
//
// Replaces warpdb_tpu/ops/pallas_expand.py:uniform_expand.  When every
// probe row of an inner join matches the same k >= 2 build rows, output
// row r belongs to probe row r / k.  The TPU kernel selects with a
// constant one-hot matrix on the MXU over bf16 byte planes, which ties k
// to a divisor of its 1024-lane block (k in {2, 4, 8}).  Here any k >= 1
// works, for up to 16 columns in one launch.  Words move as unsigned ints:
// the copy is bit-exact for f32 (NaN payloads, -0.0, +-inf) and int32
// alike.
//
// Bound: device-memory bandwidth (each source word read once, each output
// word written once).  A copy reaches the card's rate only with many bytes
// in flight and few instructions per byte, so:
// * each thread writes runs of 4 consecutive outputs per column as one
//   16-byte store (output rows are 16-byte aligned: the caller pads their
//   stride to a multiple of 4 words), kUnroll runs per thread, all loads
//   of a column issued before its stores;
// * a run needs at most 2 source words for k >= 2 (one division per run
//   finds the first and its rank, then a select per output) and 4
//   consecutive words for k = 1 (one 16-byte load where the source is
//   aligned);
// * a ragged total ends in one run written word by word.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kRunsPerBlock = kThreads * kUnroll;
constexpr int kMaxCols = 16;

struct Cols {
  const unsigned* src[kMaxCols];
};

// The 4 words of run r0 .. r0 + 3 of one column: source row s (rank rem
// inside it) and, for k >= 2, the next row.
template <typename Index>
__device__ __forceinline__ uint4 run_words(const unsigned* __restrict__ src,
                                           Index n, Index k, Index s,
                                           Index rem) {
  if (k == 1) {
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && s + 3 < n) {
      return __ldg(reinterpret_cast<const uint4*>(src + s));
    }
    const unsigned w0 = __ldg(src + s);
    const unsigned w1 = s + 1 < n ? __ldg(src + s + 1) : 0u;
    const unsigned w2 = s + 2 < n ? __ldg(src + s + 2) : 0u;
    const unsigned w3 = s + 3 < n ? __ldg(src + s + 3) : 0u;
    return make_uint4(w0, w1, w2, w3);
  }
  // k >= 2: outputs j with rem + j >= k take the next row (rem + 3 < 2k).
  const unsigned w0 = __ldg(src + s);
  const unsigned w1 = s + 1 < n ? __ldg(src + s + 1) : 0u;
  return make_uint4(w0, rem + 1 >= k ? w1 : w0, rem + 2 >= k ? w1 : w0,
                    rem + 3 >= k ? w1 : w0);
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
uniform_expand_kernel(Cols cols, int ncols, Index n, Index k, Index total,
                      unsigned* __restrict__ out, long long out_stride) {
  const Index runs = (total + 3) / 4;
  const Index first = (Index)blockIdx.x * kRunsPerBlock + threadIdx.x;
  Index s[kUnroll], rem[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const Index r0 = (first + (Index)u * kThreads) * 4;
    s[u] = r0 / k;
    rem[u] = r0 - s[u] * k;
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c >= ncols) break;
    const unsigned* src = cols.src[c];
    unsigned* dst = out + c * out_stride;
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (first + (Index)u * kThreads < runs) {
        w[u] = run_words<Index>(src, n, k, s[u], rem[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const Index run = first + (Index)u * kThreads;
      if (run >= runs) break;
      const Index r0 = run * 4;
      if (r0 + 4 <= total) {
        *reinterpret_cast<uint4*>(dst + r0) = w[u];
      } else {  // the ragged last run
        dst[r0] = w[u].x;
        if (r0 + 1 < total) dst[r0 + 1] = w[u].y;
        if (r0 + 2 < total) dst[r0 + 2] = w[u].z;
      }
    }
  }
}

}  // namespace

// src: host array of ncols device pointers to n words each; out: ncols
// rows of out_stride words, 16-byte aligned, out_stride a multiple of 4;
// total <= n * k.
extern "C" int warpdb_uniform_expand(const void* src, int ncols, long long n,
                                     long long k, long long total, void* out,
                                     long long out_stride, void* stream) {
  const long long blocks = ((total + 3) / 4 + kRunsPerBlock - 1) / kRunsPerBlock;
  if (ncols < 1 || ncols > kMaxCols || k < 1 || n < 1 || total < 1 ||
      total > n * k || out_stride % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Cols cols = {};
  const void* const* ptrs = static_cast<const void* const*>(src);
  for (int c = 0; c < ncols; ++c) {
    cols.src[c] = static_cast<const unsigned*>(ptrs[c]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* o = static_cast<unsigned*>(out);
  // 32-bit indices when every index the kernel forms fits.
  if (blocks * kRunsPerBlock * 4 + k < (1ll << 31) && n < (1ll << 31)) {
    uniform_expand_kernel<unsigned><<<(unsigned)blocks, kThreads, 0, s>>>(
        cols, ncols, (unsigned)n, (unsigned)k, (unsigned)total, o, out_stride);
  } else {
    uniform_expand_kernel<long long><<<(unsigned)blocks, kThreads, 0, s>>>(
        cols, ncols, n, k, total, o, out_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
