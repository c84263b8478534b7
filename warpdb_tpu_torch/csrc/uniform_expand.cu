// Uniform fan-out expansion of 4-byte columns (kernel K4).
//
// Replaces warpdb_tpu/ops/pallas_expand.py:uniform_expand.  When every
// probe row of an inner join matches the same k >= 2 build rows, output
// row r belongs to probe row r / k.  The TPU kernel selects with a
// constant one-hot matrix on the MXU over bf16 byte planes, which ties k
// to a divisor of its 1024-lane block (k in {2, 4, 8}).  Here each thread
// writes out_c[r] = col_c[r / k] directly, for up to 16 columns in one
// launch, so any k >= 1 works.  Words move as unsigned ints: the copy is
// bit-exact for f32 (NaN payloads, -0.0, +-inf) and int32 alike.
//
// Bound: device-memory bandwidth.  Each output word is written once,
// coalesced; each source word is read once from memory and k-1 more times
// from L1 by the neighbouring threads that share it.  The division runs in
// 32 bits when the output fits, where it is a multiply and a shift.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 16;

struct Cols {
  const unsigned* src[kMaxCols];
};

template <typename Index>
__global__ void __launch_bounds__(kThreads)
uniform_expand_kernel(Cols cols, int ncols, Index k, Index total,
                      unsigned* __restrict__ out, long long out_stride) {
  const Index stride = (Index)gridDim.x * kThreads;
  for (Index r = (Index)blockIdx.x * kThreads + threadIdx.x; r < total;
       r += stride) {
    const Index s = r / k;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < ncols) out[c * out_stride + r] = __ldg(cols.src[c] + s);
    }
  }
}

}  // namespace

// src: host array of ncols device pointers; out: ncols rows of out_stride
// words.
extern "C" int warpdb_uniform_expand(const void* src, int ncols, long long k,
                                     long long total, void* out,
                                     long long out_stride, int grid,
                                     void* stream) {
  if (ncols < 1 || ncols > kMaxCols || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Cols cols = {};
  const void* const* ptrs = static_cast<const void* const*>(src);
  for (int c = 0; c < ncols; ++c) {
    cols.src[c] = static_cast<const unsigned*>(ptrs[c]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* o = static_cast<unsigned*>(out);
  // The grid-stride index must not overflow past total either.
  if (total + (long long)grid * kThreads < (1ll << 31)) {
    uniform_expand_kernel<unsigned><<<grid, kThreads, 0, s>>>(
        cols, ncols, (unsigned)k, (unsigned)total, o, out_stride);
  } else {
    uniform_expand_kernel<long long><<<grid, kThreads, 0, s>>>(
        cols, ncols, k, total, o, out_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
