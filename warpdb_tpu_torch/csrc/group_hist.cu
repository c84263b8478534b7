// Dense group histogram: exact counts and f32 sums per slot (kernel K2).
//
// Replaces warpdb_tpu/ops/pallas_group.py:pallas_group_counts_sums.  The
// TPU builds one-hot tiles in VMEM and contracts them on the MXU, with a
// 3-term bf16 split of each value; the one-hot product is also why the TPU
// path needs finite values (0 * inf = NaN).  Hopper has fast atomics in
// L2, so this kernel is one grid-stride pass that adds each row into its
// slot: an integer atomicAdd for the count (exact at any row count) and an
// f32 atomicAdd per value column.  A non-finite value touches only its own
// slot, so no finite-values gate is needed.
//
// Bound: the input is read once (4 bytes of id plus 4 per value column);
// the adds land in a slot table of at most 2^16 * (1 + nv) * 4 bytes,
// which stays in the 50 MB L2.  The kernel serves only the midrange tier
// (more than 4096 slots), so contention on one slot is low.  Privatising
// the table in shared memory does not fit 2^16 slots (256 KB of counts
// alone against 227 KB a block); that refinement is later work.
//
// Sums add in a run-dependent order, so they differ from a sequential sum
// in the last bits.  Ids outside [0, num_slots) contribute nothing.
// counts may be null (a later batch of value columns).  Launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
group_hist_kernel(const int* __restrict__ gid, long long n, int num_slots,
                  const float* __restrict__ v0, const float* __restrict__ v1,
                  const float* __restrict__ v2, const float* __restrict__ v3,
                  int nv, int* __restrict__ counts, float* __restrict__ sums) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int g = __ldg(gid + i);
    if (g < 0 || g >= num_slots) continue;
    if (counts != nullptr) atomicAdd(counts + g, 1);
    if (nv > 0) atomicAdd(sums + g, __ldg(v0 + i));
    if (nv > 1) atomicAdd(sums + num_slots + g, __ldg(v1 + i));
    if (nv > 2) atomicAdd(sums + 2 * num_slots + g, __ldg(v2 + i));
    if (nv > 3) atomicAdd(sums + 3 * num_slots + g, __ldg(v3 + i));
  }
}

}  // namespace

extern "C" int warpdb_group_hist(const void* gid, long long n, int num_slots,
                                 const void* v0, const void* v1,
                                 const void* v2, const void* v3, int nv,
                                 void* counts, void* sums, int grid,
                                 void* stream) {
  if (nv < 0 || nv > 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  group_hist_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int*>(gid), n, num_slots,
      static_cast<const float*>(v0), static_cast<const float*>(v1),
      static_cast<const float*>(v2), static_cast<const float*>(v3), nv,
      static_cast<int*>(counts), static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}
