// Dense group histogram: exact counts and f32 sums per slot (kernel K2).
//
// Replaces warpdb_tpu/ops/pallas_group.py:pallas_group_counts_sums.  The
// TPU builds one-hot tiles in VMEM and contracts them on the MXU, with a
// 3-term bf16 split of each value; the one-hot product is also why the TPU
// path needs finite values (0 * inf = NaN).  Here each row is added into
// its slot, so a non-finite value touches only its own slot.
//
// Bound: bytes.  The rows are read once (4 bytes of id plus 4 per value
// column) and the table written once: 8n + 8 * slots bytes at nv = 1,
// 0.0803 ms for 2^25 rows and 65536 slots at 3.35 TB/s.  The earlier
// kernel added every row with global atomics into a table in L2 and ran
// at the L2 atomic units' rate, 8.7% of the bound.
//
// Hopper design: the slot table lives in shared memory, cut into R slices
// of S = ceil(slots / R) slots, (count + nv) words a slot, of at most
// 200 KB each (R = 1 up to ~25,000 slots at nv = 1; 3 at 65536).  Blocks
// run in groups of R, block b owning slice b % R; every block of a group
// streams all of the group's rows with 16-byte loads and adds the ones it
// owns with shared-memory atomics on its own slice, so no add leaves the
// SM; the R - 1 extra reads of a row come from L2.  Where most lanes of a
// warp hit one slot (a skewed key) the warp sums them with shuffles and
// adds once.  Each group flushes its table to a partials buffer [groups,
// words, slots], which stays in L2, and a second small pass adds the
// partials (counts in i32, sums in f64, cast to f32: closer to float64
// than one f32 chain a slot).
//
// Measured on an H100 SXM at 700 W (PERF.md): ~57% of the bound at R = 1,
// held by the shared-memory atomics; each more slice costs one more read
// of the rows from L2 (65536 slots at nv = 1, R = 3: ~29%).  Two cluster
// designs were built and measured slower at every size: a thread-block
// cluster of R blocks fed by TMA multicast paid microseconds a tile in
// its mbarrier and cluster-barrier ring, and adds into the owner's slice
// through distributed shared memory (red.shared::cluster) ran below the
// global-atomic kernel this one replaced from R = 4 on.
//
// Sums of one slot add in a run-dependent order (and per group first), so
// they differ from a sequential sum in the last bits.  Ids outside
// [0, slots) contribute nothing.  counts may be null (a later batch of
// value columns).  Launches on the caller's stream, allocates nothing,
// returns the first CUDA error code.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCombineSlots = 32;
constexpr int kCombineRows = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Cols {
  const float* v[4];
};

// This block's slice of the table; rows of other slices are skipped.
struct Slice {
  unsigned* table;
  int S, num_slots;
  uint32_t magic, rank;

  __device__ __forceinline__ bool takes(int g) const {
    return (unsigned)g < (unsigned)num_slots &&
           __umulhi((uint32_t)g, magic) == rank;
  }
  template <bool HC, int NV>
  __device__ __forceinline__ void add(int g, unsigned count,
                                      const float* v) const {
    const uint32_t local = (uint32_t)g - rank * (uint32_t)S;
    if (HC) atomicAdd(table + local, count);
#pragma unroll
    for (int c = 0; c < NV; ++c)
      atomicAdd(reinterpret_cast<float*>(table) + (HC + c) * S + local, v[c]);
  }
};

// One row a lane, every lane of the warp calling (g outside [0, slots):
// no row); val(c) reads the row's value in column c.  The warp keeps a
// candidate hot slot: the lanes whose row hits it are summed with
// shuffles and added once, so one slot taking most rows (a skewed key)
// costs an add a warp, not a lane.  Otherwise each lane adds its row and
// the candidate moves to the first lane's slot.
template <bool HC, int NV, typename V>
__device__ __forceinline__ void add_row(const Slice& sink, int g, V&& val,
                                        int& hot) {
  const int lane = threadIdx.x & 31;
  const bool take = sink.takes(g);
  const unsigned hm = __ballot_sync(kFull, take && g == hot);
  float v[NV > 0 ? NV : 1];
  if (__popc(hm) >= 2) {
    const bool in = (hm >> lane) & 1u;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      v[c] = in ? val(c) : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[c] += __shfl_xor_sync(kFull, v[c], off);
    }
    if (lane == __ffs(hm) - 1) sink.template add<HC, NV>(hot, __popc(hm), v);
    if (in || !take) return;
  } else {
    const unsigned tm = __ballot_sync(kFull, take);
    if (tm != 0) hot = __shfl_sync(kFull, g, __ffs(tm) - 1);
    if (!take) return;
  }
#pragma unroll
  for (int c = 0; c < NV; ++c) v[c] = val(c);
  sink.template add<HC, NV>(g, 1u, v);
}

// Rows in [0, head) and [head + 4 * nvec, n) go one a lane, the rest as
// 16-byte units of four rows (all pointers then share their alignment).
// Block b is slice b % slices of group b / slices; a group's blocks each
// take units tid, tid + stride, ... of the group's threads.
template <bool HC, int NV>
__global__ void __launch_bounds__(1024)
group_hist_kernel(const int* __restrict__ gid, long long n, int head,
                  long long nvec, Cols cols, int num_slots, int S,
                  uint32_t magic, int slices,
                  unsigned* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned s_table[];
  constexpr int words = HC + NV;
  const int nthreads = blockDim.x;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < words * S; i += nthreads) s_table[i] = 0u;
  __syncthreads();
  const uint32_t rank = blockIdx.x % slices;
  const long long group = blockIdx.x / slices;
  const Slice sink{s_table, S, num_slots, magic, rank};
  const long long tid = group * nthreads + threadIdx.x;
  const long long stride = (long long)(gridDim.x / slices) * nthreads;
  int hot = -1;

  const long long tail0 = head + 4 * nvec;
  const long long nscalar = head + (n - tail0);
  for (long long i0 = tid - lane; i0 < nscalar; i0 += stride) {
    const long long i = i0 + lane;
    const long long r = i < head ? i : tail0 + (i - head);
    add_row<HC, NV>(sink, i < nscalar ? __ldg(gid + r) : -1,
                    [&](int c) { return __ldg(cols.v[c] + r); }, hot);
  }
  // 16-byte units, two a lane in flight.
  const int4* g4 = reinterpret_cast<const int4*>(gid + head);
  for (long long u0 = tid - lane; u0 < nvec; u0 += 2 * stride) {
    int4 gq[2];
    float4 vq[2][NV > 0 ? NV : 1];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long u = u0 + lane + j * stride;
      gq[j] = make_int4(-1, -1, -1, -1);
      if (u < nvec) {
        gq[j] = __ldg(g4 + u);
#pragma unroll
        for (int c = 0; c < NV; ++c)
          vq[j][c] =
              __ldg(reinterpret_cast<const float4*>(cols.v[c] + head) + u);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      add_row<HC, NV>(sink, gq[j].x, [&](int c) { return vq[j][c].x; }, hot);
      add_row<HC, NV>(sink, gq[j].y, [&](int c) { return vq[j][c].y; }, hot);
      add_row<HC, NV>(sink, gq[j].z, [&](int c) { return vq[j][c].z; }, hot);
      add_row<HC, NV>(sink, gq[j].w, [&](int c) { return vq[j][c].w; }, hot);
    }
  }
  __syncthreads();

  // The slice into partials[group, w, rank * S ...].
  const int first = rank * S;
  const int len = min(S, num_slots - first);
  unsigned* p = partials + group * words * (long long)num_slots + first;
  for (int w = 0; w < words; ++w)
    for (int l = threadIdx.x; l < len; l += nthreads)
      p[(long long)w * num_slots + l] = s_table[w * S + l];
}

// out[slot] = sum over groups of the partials: counts in i32, sums in f64
// then f32.  A block takes kCombineSlots slots; its kCombineRows rows of
// threads split the groups and meet in shared memory.
__global__ void __launch_bounds__(kCombineSlots * kCombineRows)
group_hist_combine_kernel(const unsigned* __restrict__ partials,
                          int groups, int words, int has_count,
                          int num_slots, int* __restrict__ counts,
                          float* __restrict__ sums) {
  __shared__ double s_sum[kCombineRows][kCombineSlots];
  const int slot = blockIdx.x * kCombineSlots + threadIdx.x;
  const long long plane = (long long)words * num_slots;
  for (int w = 0; w < words; ++w) {
    const bool is_count = has_count && w == 0;
    double acc = 0.0;
    if (slot < num_slots) {
      const unsigned* p = partials + (long long)w * num_slots + slot;
      unsigned c = 0;
      for (int k = threadIdx.y; k < groups; k += kCombineRows) {
        const unsigned x = __ldcg(p + k * plane);
        if (is_count)
          c += x;
        else
          acc += static_cast<double>(__uint_as_float(x));
      }
      if (is_count) acc = static_cast<double>(c);
    }
    s_sum[threadIdx.y][threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.y == 0 && slot < num_slots) {
      double t = 0.0;
      for (int r = 0; r < kCombineRows; ++r) t += s_sum[r][threadIdx.x];
      if (is_count)
        counts[slot] = static_cast<int>(static_cast<long long>(t));
      else
        sums[(long long)(w - has_count) * num_slots + slot] =
            static_cast<float>(t);
    }
    __syncthreads();
  }
}

template <bool HC, int NV>
cudaError_t run(const int* gid, long long n, int head, long long nvec,
                const Cols& cols, int num_slots, int S, uint32_t magic,
                int slices, int groups, int threads, int smem,
                unsigned* partials, cudaStream_t s, int* max_blocks) {
  auto* fn = group_hist_kernel<HC, NV>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (max_blocks != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(max_blocks, fn,
                                                         threads, smem);
  fn<<<groups * slices, threads, smem, s>>>(gid, n, head, nvec, cols,
                                            num_slots, S, magic, slices,
                                            partials);
  return cudaGetLastError();
}

template <typename... A>
cudaError_t dispatch(bool hc, int nv, A... a) {
  if (hc) {
    switch (nv) {
      case 0: return run<true, 0>(a...);
      case 1: return run<true, 1>(a...);
      case 2: return run<true, 2>(a...);
      case 3: return run<true, 3>(a...);
      case 4: return run<true, 4>(a...);
    }
  } else {
    switch (nv) {
      case 1: return run<false, 1>(a...);
      case 2: return run<false, 2>(a...);
      case 3: return run<false, 3>(a...);
      case 4: return run<false, 4>(a...);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// How many blocks of `threads` threads with `smem` bytes of dynamic
// shared memory each an SM holds at once.
extern "C" int warpdb_group_hist_blocks(int has_count, int nv, int threads,
                                        int smem, void* out) {
  int* o = static_cast<int*>(out);
  *o = 0;
  const cudaError_t e = dispatch(has_count != 0, nv, nullptr, 0LL, 0, 0LL,
                                 Cols{}, 0, 0, 0u, 1, 0, threads, smem,
                                 nullptr, cudaStream_t{}, o);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Counts (if counts != null) and sums of nv <= 4 value columns by gid.
// Plan (ops/group_kernel.py:slice_plan): the table in `slices` slices of
// S slots, one a block, slot g in slice umulhi(g, magic) (magic =
// ceil(2^32 / S), 0 for one slice); `groups` groups of `slices` blocks of
// `threads` threads and smem bytes; partials: groups * (has_count + nv) *
// num_slots words of scratch.
extern "C" int warpdb_group_hist(const void* gid, long long n, int num_slots,
                                 const void* v0, const void* v1,
                                 const void* v2, const void* v3, int nv,
                                 void* counts, void* sums, void* partials,
                                 int slices, int groups, int S,
                                 unsigned magic, int threads, int smem,
                                 void* stream) {
  if (nv < 0 || nv > 4 || slices < 1 || groups < 1 || S < 1 ||
      threads % 32 != 0 || threads < 32 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const Cols cols{{static_cast<const float*>(v0),
                   static_cast<const float*>(v1),
                   static_cast<const float*>(v2),
                   static_cast<const float*>(v3)}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hc = counts != nullptr;
  const int words = hc + nv;
  // 16-byte units need every pointer at the same offset from 16 bytes;
  // otherwise every row goes one at a time.
  const uintptr_t g = reinterpret_cast<uintptr_t>(gid);
  bool same = (g & 3) == 0;
  for (int c = 0; c < nv; ++c)
    same = same &&
           ((reinterpret_cast<uintptr_t>(cols.v[c]) ^ g) & 15) == 0;
  long long head = n, nvec = 0;
  if (same) {
    head = (long long)(((16 - (g & 15)) & 15) / 4);
    if (head > n) head = n;
    nvec = (n - head) / 4;
  }
  unsigned* part = static_cast<unsigned*>(partials);
  cudaError_t e = dispatch(hc != 0, nv, static_cast<const int*>(gid), n,
                           static_cast<int>(head), nvec, cols, num_slots, S,
                           static_cast<uint32_t>(magic), slices, groups,
                           threads, smem, part, s,
                           static_cast<int*>(nullptr));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (num_slots + kCombineSlots - 1) / kCombineSlots;
  group_hist_combine_kernel<<<blocks, dim3(kCombineSlots, kCombineRows), 0,
                              s>>>(part, groups, words, hc, num_slots,
                                   static_cast<int*>(counts),
                                   static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}
