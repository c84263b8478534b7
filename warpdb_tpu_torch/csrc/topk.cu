// Top-k selection for ORDER BY ... LIMIT (kernel K1).
//
// Replaces warpdb_tpu/ops/pallas_topk.py:pallas_topk_candidates.  The TPU
// kernel walks a (rows, 1024) view in grid order and keeps a sorted top-k
// per lane in VMEM, and the caller finishes with a top-k of the table.
//
// Bound: bytes.  Each input byte is read once: 4n bytes, 0.0401 ms for
// 2^25 values at 3.35 TB/s.  The earlier kernel reached 24% of it: scalar
// 4-byte loads, four in flight a thread and 512 threads an SM (~8 KiB in
// flight, where the card needs ~32 KiB an SM), a sorted top-K per thread
// in registers (158 registers at K = 128), a block merge of K rounds, and
// a second launch (torch.topk over every block's K candidates).
//
// Hopper design, one launch:
//   1. Stream: one block of 1024 threads an SM, each lane with eight
//      16-byte loads in flight (128 KiB an SM; four measured slower); the
//      unaligned head and the ragged tail (at most 6 values) go one a
//      lane.
//   2. Select: each warp keeps its top-L (L = max(K, 32)) sorted in
//      shared memory behind a threshold: the largest K-th value of any
//      warp's list in the block (shared through an atomicMax).  A value
//      passes only if strictly above it (exact for the multiset: the warp
//      that set it holds enough copies of a value equal to it).  Lanes
//      whose value passes append it to the warp's queue of L slots at
//      positions from __ballot_sync; a full queue is sorted (bitonic) and
//      merged into the list (max of the list and the reversed queue, then
//      a bitonic clean), which raises the threshold.  A warp visits only
//      the value positions where some lane passes, and seeds its
//      threshold from its first values (WarpTopK::seed).  Registers stay
//      under 64 at every K (no spills).
//   3. Merge: the block's warp lists merge pairwise in log2(32) = 5 rounds
//      of one bitonic merge each (log2(2L) steps, not K rounds).  The
//      block writes its sorted top-K, and the last block to finish (a
//      fence plus an atomic ticket, which that block resets) merges the
//      blocks' lists the same way into one sorted row of K values: the
//      caller takes its first k, with no second launch.
//
// Measured (PERF.md, chip_smoke.py; H100 SXM at 700 W): about 60% of the
// bound at n = 2^25, k = 16 (device time); k = 128 and ascending input
// (every value passes) cost more in the queue's sorts.
//
// Contract: x is f32[n] in descending-priority space, invalid rows -inf,
// no NaN (the caller gates on finite order keys); any n.  out_final gets
// the K largest values sorted descending (-inf where n < K); out_blocks
// is scratch of grid * K floats; ticket is one zeroed u32 that no other
// launch uses at the same time (the wrapper keeps one a stream).
// Launches on the caller's stream, allocates nothing, returns the CUDA
// error code.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int U = 8;  // 16-byte loads a lane in flight (8 beat 4)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Bitonic sort of s[0, L) into descending order by one warp.
template <int L>
__device__ __forceinline__ void warp_sort_desc(float* s, int lane) {
#pragma unroll 1
  for (int size = 2; size <= L; size <<= 1) {
#pragma unroll 1
    for (int st = size >> 1; st > 0; st >>= 1) {
#pragma unroll
      for (int p = lane; p < L / 2; p += 32) {
        const int i = 2 * p - (p & (st - 1));
        const int j = i + st;
        const bool desc = (i & size) == 0;
        const float a = s[i], b = s[j];
        if ((a < b) == desc) {
          s[i] = b;
          s[j] = a;
        }
      }
      __syncwarp();
    }
  }
}

// a[0, L) <- the top L of a and b, both sorted descending, sorted
// descending: max(a[i], b[L-1-i]) is bitonic and holds the top L; a
// bitonic clean sorts it.
template <int L>
__device__ __forceinline__ void warp_merge(float* a, const float* b, int lane) {
#pragma unroll
  for (int i = lane; i < L; i += 32) a[i] = fmaxf(a[i], b[L - 1 - i]);
  __syncwarp();
#pragma unroll 1
  for (int st = L / 2; st > 0; st >>= 1) {
#pragma unroll
    for (int p = lane; p < L / 2; p += 32) {
      const int i = 2 * p - (p & (st - 1));
      const int j = i + st;
      const float x = a[i], y = a[j];
      if (x < y) {
        a[i] = y;
        a[j] = x;
      }
    }
    __syncwarp();
  }
}

// An int whose signed order is the float order (no NaN).
__device__ __forceinline__ int order_key(float f) {
  const int k = __float_as_int(f);
  return k >= 0 ? k : k ^ 0x7fffffff;
}

__device__ __forceinline__ float from_order_key(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

template <int K, int L>
struct WarpTopK {
  float* list;   // top L seen so far, sorted descending
  float* queue;  // L slots of values that passed
  int* block_key;  // order_key of the largest warp threshold of the block
  int q;         // values in the queue (warp-uniform)
  float thr;     // a value strictly above which a value may be in the top K
  int lane;

  // Each warp's K-th value bounds the block's (and the input's) K-th from
  // below, so every warp filters by the largest of them: still exact for
  // the multiset, since the warp that set the bound keeps enough copies of
  // a value equal to it.
  __device__ __forceinline__ void flush() {
    for (int i = q + lane; i < L; i += 32) queue[i] = neg_inf();
    __syncwarp();
    warp_sort_desc<L>(queue, lane);
    warp_merge<L>(list, queue, lane);
    thr = fmaxf(thr, list[K - 1]);
    if (lane == 0) atomicMax(block_key, order_key(thr));
    q = 0;
  }

  __device__ __forceinline__ void offer(float v) {
    const bool pass = v > thr;
    const unsigned m = __ballot_sync(kFull, pass);
    if (m == 0) return;
    if (q + __popc(m) > L) flush();
    if (pass) queue[q + __popc(m & ((1u << lane) - 1u))] = v;
    q += __popc(m);
  }

  // Before the warp's first sixteen values a lane: each lane's J-th
  // largest (J = max(1, K / 32)) bounds K values of the warp from below
  // at their minimum m, so every value of the top K is >= m, and a test
  // strictly above the float below m keeps all of them.  Without it the
  // first values all pass and flood the queue.
  __device__ __forceinline__ void seed(float4 a0, float4 a1, float4 a2,
                                       float4 a3) {
    constexpr int J = K / 32 > 1 ? K / 32 : 1;
    float t[J];
#pragma unroll
    for (int j = 0; j < J; ++j) t[j] = neg_inf();
    const float4 a[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float v = i % 4 == 0 ? a[i / 4].x : i % 4 == 1 ? a[i / 4].y
              : i % 4 == 2 ? a[i / 4].z : a[i / 4].w;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float hi = fmaxf(t[j], v);
        v = fminf(t[j], v);
        t[j] = hi;
      }
    }
    float m = t[J - 1];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fminf(m, __shfl_xor_sync(kFull, m, off));
    thr = fmaxf(thr, nextafterf(m, neg_inf()));
  }

  // Sixteen values a lane; the common case is one vote that none passes.
  // Otherwise only the positions where some lane passes are offered.
  __device__ __forceinline__ void consume(float4 a0, float4 a1, float4 a2,
                                          float4 a3) {
    thr = fmaxf(thr, from_order_key(*reinterpret_cast<volatile int*>(
                         block_key)));
    const float4 a[4] = {a0, a1, a2, a3};
    unsigned mine = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      mine |= ((a[t].x > thr ? 1u : 0u) | (a[t].y > thr ? 2u : 0u) |
               (a[t].z > thr ? 4u : 0u) | (a[t].w > thr ? 8u : 0u))
              << (4 * t);
    unsigned todo = __reduce_or_sync(kFull, mine);
    while (todo != 0) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const float4 w = j < 8 ? (j < 4 ? a0 : a1) : (j < 12 ? a2 : a3);
      const int c = j & 3;
      offer(c == 0 ? w.x : c == 1 ? w.y : c == 2 ? w.z : w.w);
    }
  }
};

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
topk_kernel(const float* __restrict__ x, long long n, int head,
            long long nvec, float* __restrict__ out_blocks,
            float* __restrict__ out_final, unsigned* __restrict__ ticket) {
  constexpr int L = K < 32 ? 32 : K;
  __shared__ float s_list[kWarps][L];
  __shared__ float s_queue[kWarps][L];
  __shared__ bool s_last;
  __shared__ int s_key;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float ninf = neg_inf();
  const float4 ninf4 = make_float4(ninf, ninf, ninf, ninf);

  for (int i = lane; i < L; i += 32) s_list[warp][i] = ninf;
  if (threadIdx.x == 0) s_key = order_key(ninf);
  __syncthreads();
  WarpTopK<K, L> w{s_list[warp], s_queue[warp], &s_key, 0, ninf, lane};

  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;

  // The unaligned head and the ragged tail, one value a lane.
  const long long tail0 = head + 4 * nvec;
  const long long extra = head + (n - tail0);
  if (tid - lane < extra) {
    float v = ninf;
    if (tid < extra) v = __ldg(x + (tid < head ? tid : tail0 + tid - head));
    w.consume(make_float4(v, ninf, ninf, ninf), ninf4, ninf4, ninf4);
  }

  // 16-byte units, U a lane in flight; the loop bounds are warp-uniform
  // so that every lane votes.
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  long long u = tid - lane;
  if (u + (U - 1) * stride + 31 < nvec)
    w.seed(__ldg(x4 + u + lane), __ldg(x4 + u + lane + stride),
           __ldg(x4 + u + lane + 2 * stride), __ldg(x4 + u + lane + 3 * stride));
  for (; u + (U - 1) * stride + 31 < nvec; u += U * stride) {
    float4 a[U];
#pragma unroll
    for (int j = 0; j < U; ++j) a[j] = __ldg(x4 + u + lane + j * stride);
#pragma unroll
    for (int j = 0; j < U; j += 4) w.consume(a[j], a[j + 1], a[j + 2], a[j + 3]);
  }
  for (; u < nvec; u += stride) {
    const float4 a0 = u + lane < nvec ? __ldg(x4 + u + lane) : ninf4;
    w.consume(a0, ninf4, ninf4, ninf4);
  }
  if (w.q > 0) w.flush();

  // The block's warps merge pairwise.
#pragma unroll 1
  for (int step = 1; step < kWarps; step <<= 1) {
    __syncthreads();
    if ((warp & (2 * step - 1)) == 0)
      warp_merge<L>(s_list[warp], s_list[warp + step], lane);
  }
  __syncthreads();
  if (threadIdx.x < K)
    out_blocks[(long long)blockIdx.x * K + threadIdx.x] = s_list[0][threadIdx.x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // The last block merges every block's sorted top-K.
  __threadfence();
  for (int i = lane; i < L; i += 32) s_list[warp][i] = ninf;
  __syncwarp();
#pragma unroll 1
  for (int b = warp; b < (int)gridDim.x; b += kWarps) {
    for (int i = lane; i < L; i += 32)
      s_queue[warp][i] = i < K ? __ldcg(out_blocks + (long long)b * K + i) : ninf;
    __syncwarp();
    warp_merge<L>(s_list[warp], s_queue[warp], lane);
  }
#pragma unroll 1
  for (int step = 1; step < kWarps; step <<= 1) {
    __syncthreads();
    if ((warp & (2 * step - 1)) == 0)
      warp_merge<L>(s_list[warp], s_list[warp + step], lane);
  }
  __syncthreads();
  if (threadIdx.x < K) out_final[threadIdx.x] = s_list[0][threadIdx.x];
  if (threadIdx.x == 0) *ticket = 0u;
}

}  // namespace

extern "C" int warpdb_topk(const void* x, long long n, int k,
                           void* out_blocks, void* out_final, void* ticket,
                           int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  // 16-byte units from the first aligned value on.
  const unsigned long long a = reinterpret_cast<unsigned long long>(x);
  if (a & 3) return static_cast<int>(cudaErrorInvalidValue);
  long long head = (long long)(((16 - (a & 15)) & 15) / 4);
  if (head > n) head = n;
  const long long nvec = (n - head) / 4;
  float* ob = static_cast<float*>(out_blocks);
  float* of = static_cast<float*>(out_final);
  unsigned* t = static_cast<unsigned*>(ticket);
  const int h = static_cast<int>(head);
  switch (k) {
    case 16:
      topk_kernel<16><<<grid, kThreads, 0, s>>>(xf, n, h, nvec, ob, of, t);
      break;
    case 32:
      topk_kernel<32><<<grid, kThreads, 0, s>>>(xf, n, h, nvec, ob, of, t);
      break;
    case 64:
      topk_kernel<64><<<grid, kThreads, 0, s>>>(xf, n, h, nvec, ob, of, t);
      break;
    case 128:
      topk_kernel<128><<<grid, kThreads, 0, s>>>(xf, n, h, nvec, ob, of, t);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
