// Gather of 4-byte columns at a nondecreasing index (kernel K5).
//
// Replaces warpdb_tpu/ops/pallas_expand.py:windowed_sorted_take.  On the
// TPU a random gather pays per-row overhead, so that kernel DMAs a
// 2048-row source window per 1024-lane block and selects inside it with a
// one-hot MXU product over bf16 byte planes, which needs the index span of
// every block to stay under 1024 (a host gate, with a general gather as
// the other branch).  Hopper gathers per thread: out_c[r] = valid[r] ?
// col_c[idx[r]] : 0, one thread per output row, for up to 16 columns in one
// launch.  Rows are 32-bit words moved as unsigned ints, so NaN payloads,
// -0.0, +-inf and full-range int32 codes come out bit for bit.
//
// Bound: device-memory bandwidth.  Each row reads its 8-byte index, a
// validity byte when given, and one word per column, and writes one word
// per column.  Writes are coalesced (neighbouring threads, neighbouring
// rows).  The index is nondecreasing, so neighbouring threads read
// neighbouring or equal source words and the reads coalesce too, whatever
// the span of a block: there is no span contract and no fallback.
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

__global__ void __launch_bounds__(kThreads)
sorted_take_kernel(Cols cols, int ncols, const long long* __restrict__ idx,
                   const unsigned char* __restrict__ valid, long long n,
                   unsigned* __restrict__ out, long long out_stride) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < n;
       r += stride) {
    const bool ok = valid == nullptr || valid[r] != 0;
    const long long i = ok ? __ldg(idx + r) : 0;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < ncols) {
        out[c * out_stride + r] = ok ? __ldg(cols.src[c] + i) : 0u;
      }
    }
  }
}

}  // namespace

// src: host array of ncols device pointers; out: ncols rows of out_stride
// words; valid may be null (every row valid).
extern "C" int warpdb_sorted_take(const void* src, int ncols, const void* idx,
                                  const void* valid, long long n, void* out,
                                  long long out_stride, int grid,
                                  void* stream) {
  if (ncols < 1 || ncols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Cols cols = {};
  const void* const* ptrs = static_cast<const void* const*>(src);
  for (int c = 0; c < ncols; ++c) {
    cols.src[c] = static_cast<const unsigned*>(ptrs[c]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sorted_take_kernel<<<grid, kThreads, 0, s>>>(
      cols, ncols, static_cast<const long long*>(idx),
      static_cast<const unsigned char*>(valid), n,
      static_cast<unsigned*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}
