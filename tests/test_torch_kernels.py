"""The port's kernels K1 (top-k candidates) and K2 (group histogram).

Here on the CPU the wrappers run their plain PyTorch versions, held
against the JAX package: K2 against the Pallas kernel in interpret mode,
K1 by its candidate contract and through ``top_k_values`` end to end
(the Pallas top-k kernel has no CPU interpret run, see
test_pallas_ops.py).  The CUDA kernels themselves are compared with
their plain versions on a card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdb_tpu_torch.errors import ExecutionError
from warpdb_tpu_torch.ops import group_kernel, topk_kernel
from warpdb_tpu_torch.ops.sort import top_k_values


def _topk_input(case: str, n: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if case == "random":
        return rng.uniform(-100, 100, n).astype(np.float32)
    if case == "ascending":
        return np.sort(rng.uniform(-100, 100, n).astype(np.float32))
    return rng.choice(np.float32([1.0, 2.0, 3.0, 99.5]), n)


def _group_input(num_slots: int, n: int, nv: int):
    rng = np.random.default_rng(33)
    gid = rng.integers(0, num_slots, n).astype(np.int32)
    glo = 128 if num_slots <= (1 << 14) else 256
    gid[::17] = -(-num_slots // glo) * glo  # invalid rows match no slot
    vals = [rng.uniform(0, 100, n).astype(np.float32) for _ in range(nv)]
    return gid, vals


# --- K2 ---------------------------------------------------------------------


@pytest.mark.parametrize("nv", [0, 1, 2])
@pytest.mark.parametrize("num_slots,n", [(6000, 4096), (40_000, 8192)])
def test_group_plain_matches_pallas_interpret(num_slots, n, nv):
    from warpdb_tpu.ops.pallas_group import pallas_group_counts_sums

    gid, vals = _group_input(num_slots, n, nv)
    want_c, want_s = pallas_group_counts_sums(
        jnp.asarray(gid), tuple(jnp.asarray(v) for v in vals), num_slots,
        interpret=jax.default_backend() == "cpu",
    )
    got_c, got_s = group_kernel.group_counts_sums(
        torch.from_numpy(gid), [torch.from_numpy(v) for v in vals], num_slots
    )
    assert got_c.dtype == torch.int32 and got_c.shape == (num_slots,)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert len(got_s) == nv
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-6,
                                   atol=1e-3)


def test_group_plain_out_of_range_and_inf():
    gid = torch.tensor([0, 1, 2, -1, 3, 7, 1], dtype=torch.int32)
    v = torch.tensor([1.0, float("inf"), 2.0, 5.0, 4.0, 9.0, 3.0])
    counts, (sums,) = group_kernel.group_counts_sums(gid, [v], 4)
    assert counts.tolist() == [1, 2, 1, 1]
    assert sums.tolist() == [1.0, float("inf"), 2.0, 4.0]


def _hot_slot_input():
    """2^21 rows, 90% of them on one slot of 5000, values in [0, 100)."""
    rng = np.random.default_rng(21)
    n = 1 << 21
    k = rng.integers(0, 5000, n)
    k[rng.random(n) < 0.9] = 17
    return k, rng.uniform(0, 100, n).astype(np.float32)


def test_group_plain_hot_slot_sums_in_f64():
    """One f32 add chain a slot drifts by ~5e-4 here; the plain version
    adds in f64 and rounds once."""
    k, v = _hot_slot_input()
    counts, (sums,) = group_kernel.group_counts_sums(
        torch.from_numpy(k.astype(np.int32)), [torch.from_numpy(v)], 5000
    )
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(k, minlength=5000))
    want = np.bincount(k, weights=v.astype(np.float64), minlength=5000)
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-6)


def test_group_hot_slot_sql_matches_reference():
    """The midrange SUM tier (K2's plain version) against the
    reference's chunked contraction, through SQL."""
    from warpdb_tpu import WarpDB as RefDB
    from warpdb_tpu.storage import HostTable as RefHostTable
    from warpdb_tpu_torch import WarpDB as PortDB
    from warpdb_tpu_torch.storage import HostTable

    k, v = _hot_slot_input()
    data = {"k": k.astype(np.float32), "v": v}
    q = "SELECT SUM(v) FROM t GROUP BY k"
    want = RefDB(RefHostTable.from_dict(data)).query_sql(q)
    got = PortDB(HostTable.from_dict(data), device="cpu").query_sql(q)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_group_wrapper_rejects_other_devices():
    gid = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ExecutionError, match="unsupported device"):
        group_kernel.group_counts_sums(gid, (), 4)


# --- K1 ---------------------------------------------------------------------


@pytest.mark.parametrize("k", [16, 33, 128])
@pytest.mark.parametrize("case", ["random", "ascending", "duplicates"])
def test_topk_plain_candidate_contract(case, k):
    x = _topk_input(case, 1 << 14)
    cand = topk_kernel.topk_candidates(torch.from_numpy(x), k)
    assert cand.shape == (1, k)
    # The row is sorted descending: its first k are the top-k.
    np.testing.assert_array_equal(cand.numpy()[0], np.sort(x)[::-1][:k])


def test_topk_plain_pads_short_inputs():
    cand = topk_kernel.topk_candidates(torch.tensor([3.0, 1.0]), 16)
    assert cand.shape == (1, 16)
    assert cand[0, :2].tolist() == [3.0, 1.0]
    assert torch.isinf(cand[0, 2:]).all()


def test_topk_kernel_widths():
    assert [topk_kernel.kernel_k(k) for k in (2, 16, 17, 33, 64, 65, 128)] == [
        16, 16, 32, 64, 64, 128, 128,
    ]
    for k in (0, 1, 129):
        with pytest.raises(ValueError):
            topk_kernel.kernel_k(k)
        with pytest.raises(ValueError):
            topk_kernel.topk_candidates(torch.zeros(8), k)
    with pytest.raises(ExecutionError, match="unsupported device"):
        topk_kernel.topk_candidates(torch.zeros(8, device="meta"), 16)
    with pytest.raises(ExecutionError, match="unsupported device"):
        topk_kernel.topk_candidates(torch.zeros(8, device="meta"), 128)


def test_topk_grid_size():
    # One block an SM, fewer where lanes would get under UNROLL units.
    per_block = topk_kernel.THREADS * topk_kernel.UNROLL * 4
    assert topk_kernel.grid_size(0, 132) == 1
    assert topk_kernel.grid_size(1000, 132) == 1
    assert topk_kernel.grid_size(per_block + 1, 132) == 2
    assert topk_kernel.grid_size(1 << 25, 132) == 132


# --- K1's CUDA design, modelled in NumPy ------------------------------------
#
# csrc/topk.cu step by step at a small geometry (``threads`` a block and
# ``grid`` blocks instead of 1024 and one an SM): each lane's 16-byte
# units, the warp's vote, its ballot queue, the block's shared threshold
# (the warps interleaved), the bitonic sort and merge networks with the
# kernel's own index arithmetic, the block's pairwise warp merges and the
# last block's merge of every block's list.


def _bitonic_sort_desc(s):
    L = s.shape[0]
    size = 2
    while size <= L:
        st = size >> 1
        while st > 0:
            p = np.arange(L // 2)
            i = 2 * p - (p & (st - 1))
            j = i + st
            desc = (i & size) == 0
            a, b = s[i].copy(), s[j].copy()
            swap = (a < b) == desc
            s[i] = np.where(swap, b, a)
            s[j] = np.where(swap, a, b)
            st >>= 1
        size <<= 1


def _bitonic_merge(a, b):
    """a <- top L of a and b (both sorted descending), sorted."""
    L = a.shape[0]
    a[:] = np.maximum(a, b[::-1])
    st = L // 2
    while st > 0:
        p = np.arange(L // 2)
        i = 2 * p - (p & (st - 1))
        j = i + st
        x, y = a[i].copy(), a[j].copy()
        a[i], a[j] = np.maximum(x, y), np.minimum(x, y)
        st >>= 1


class _Warp:
    def __init__(self, K, block=None):
        self.K, self.L = K, max(K, 32)
        self.list = np.full(self.L, -np.inf, np.float32)
        self.queue = np.full(self.L, -np.inf, np.float32)
        self.q, self.thr = 0, np.float32(-np.inf)
        # The block's shared threshold: the largest warp threshold.
        self.block = [np.float32(-np.inf)] if block is None else block
        self.flushes = 0

    def flush(self):
        self.queue[self.q:] = -np.inf
        _bitonic_sort_desc(self.queue)
        _bitonic_merge(self.list, self.queue)
        self.thr = max(self.thr, self.list[self.K - 1])
        self.block[0] = max(self.block[0], self.thr)
        self.q = 0
        self.flushes += 1

    def offer(self, v):  # v: one value a lane
        passed = v > self.thr
        cnt = int(passed.sum())
        if cnt == 0:
            return
        if self.q + cnt > self.L:
            self.flush()
        self.queue[self.q:self.q + cnt] = v[passed]  # lane order
        self.q += cnt

    def seed(self, units):  # the kernel's WarpTopK::seed
        J = max(1, self.K // 32)
        lanes = units.transpose(1, 0, 2).reshape(32, 16)
        m = np.sort(lanes, axis=1)[:, -J].min()
        below = np.nextafter(np.float32(m), np.float32(-np.inf))
        self.thr = max(self.thr, below)

    def consume(self, units):  # units: (4, 32, 4) values
        self.thr = max(self.thr, self.block[0])
        if not (units > self.thr).any():
            return
        for j in range(16):
            self.offer(units[j // 4, :, j % 4])


def model_topk(x, K, threads=64, grid=3, head=0):
    n = x.shape[0]
    head = min(head, n)
    nvec = (n - head) // 4
    x4 = x[head:head + 4 * nvec].reshape(nvec, 4)
    tail0 = head + 4 * nvec
    extras = np.concatenate([x[:head], x[tail0:]])
    stride = grid * threads
    ninf4 = np.full((32, 4), -np.inf, np.float32)

    def unit_rows(u0):  # the lanes' units at warp base u0, -inf beyond
        idx = u0 + np.arange(32)
        rows = ninf4.copy()
        ok = (idx >= 0) & (idx < nvec)
        rows[ok] = x4[idx[ok]]
        return rows

    def steps(t0):  # one warp's calls, in order: ("seed"|"consume", units)
        if t0 < extras.shape[0]:
            first = ninf4.copy()
            got = extras[t0:t0 + 32]
            first[: got.shape[0], 0] = got
            yield "consume", np.stack([first, ninf4, ninf4, ninf4])
        u = t0
        unroll = topk_kernel.UNROLL
        if u + (unroll - 1) * stride + 31 < nvec:
            yield "seed", np.stack([unit_rows(u + m * stride)
                                    for m in range(4)])
        while u + (unroll - 1) * stride + 31 < nvec:
            for m0 in range(0, unroll, 4):
                yield "consume", np.stack([unit_rows(u + m * stride)
                                           for m in range(m0, m0 + 4)])
            u += unroll * stride
        while u < nvec:
            yield "consume", np.stack([unit_rows(u), ninf4, ninf4, ninf4])
            u += stride

    block_lists = []
    for b in range(grid):
        # The block's warps run interleaved, one step each in turn.
        shared = [np.float32(-np.inf)]
        warps = [_Warp(K, shared) for _ in range(threads // 32)]
        runs = [list(steps(b * threads + wi * 32)) for wi in range(len(warps))]
        for i in range(max(map(len, runs))):
            for w, run in zip(warps, runs):
                if i < len(run):
                    step, units = run[i]
                    getattr(w, step)(units)
        for w in warps:
            if w.q > 0:
                w.flush()
        step = 1
        while step < len(warps):
            for wi in range(0, len(warps), 2 * step):
                _bitonic_merge(warps[wi].list, warps[wi + step].list)
            step *= 2
        block_lists.append(warps[0].list[:K].copy())
    # The last block: warp w merges block lists w, w + warps, ...
    nw = threads // 32
    final = [np.full(max(K, 32), -np.inf, np.float32) for _ in range(nw)]
    for b, lst in enumerate(block_lists):
        q = np.full(max(K, 32), -np.inf, np.float32)
        q[:K] = lst
        _bitonic_merge(final[b % nw], q)
    step = 1
    while step < nw:
        for wi in range(0, nw, 2 * step):
            _bitonic_merge(final[wi], final[wi + step])
        step *= 2
    return final[0][:K]


@pytest.mark.parametrize("L", [32, 64, 128])
def test_bitonic_networks_sort_and_merge(L):
    rng = np.random.default_rng(L)
    for _ in range(20):
        s = rng.choice(np.float32([-np.inf, 1, 2, 2, 3, 7.5]), L)
        s = np.where(rng.random(L) < 0.5, s, rng.normal(size=L)).astype(
            np.float32)
        got = s.copy()
        _bitonic_sort_desc(got)
        np.testing.assert_array_equal(got, np.sort(s)[::-1])
        a, b = np.sort(s)[::-1].copy(), np.sort(rng.normal(size=L))[::-1]
        want = np.sort(np.concatenate([a, b]))[::-1][:L]
        _bitonic_merge(a, b.astype(np.float32))
        np.testing.assert_array_equal(a, want.astype(np.float32))


@pytest.mark.parametrize("head", [0, 1, 2, 3])
@pytest.mark.parametrize("K", [16, 32, 64, 128])
@pytest.mark.parametrize("case", ["random", "ascending", "duplicates", "ties"])
def test_topk_model_matches_sort(case, K, head):
    n = 12_345
    if case == "ties":
        # Many values equal to the K-th largest: the strict test must
        # keep exactly enough of them.
        x = np.random.default_rng(3).uniform(0, 1, n).astype(np.float32)
        x[np.argsort(x)[-3 * K:]] = np.float32(5.0)
        x[:K // 2] = np.float32(6.0)
    else:
        x = _topk_input(case, n, seed=K)
    got = model_topk(x, K, threads=64, grid=3, head=head)
    np.testing.assert_array_equal(got, np.sort(x)[::-1][:K])


@pytest.mark.parametrize("n", [0, 3, 7, 200])
def test_topk_model_short_inputs(n):
    # n < K and n below one wave: the tail pads with -inf.
    x = np.random.default_rng(n).uniform(-1, 1, n).astype(np.float32)
    got = model_topk(x, 16, threads=64, grid=2, head=min(n, 2))
    want = np.concatenate([np.sort(x)[::-1], np.full(16, -np.inf)])[:16]
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_topk_model_random_input_rarely_flushes():
    # The warp threshold keeps the queue idle on random input: a warp
    # flushes a few times, not once per L values as on ascending input.
    n = 1 << 16
    x = _topk_input("random", n, seed=4)
    w = _Warp(16)
    for u0 in range(0, n, 32 * 16):
        w.consume(x[u0:u0 + 512].reshape(32, 4, 4).transpose(1, 0, 2))
    assert w.flushes < 20
    w.flush()
    np.testing.assert_array_equal(w.list[:16], np.sort(x)[::-1][:16])


@pytest.mark.parametrize("ascending", [False, True])
@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("case", ["random", "ascending", "duplicates"])
def test_top_k_values_matches_reference(case, k, ascending):
    from warpdb_tpu.ops.sort import top_k_values as ref_top_k_values

    n = 1 << 16
    x = _topk_input(case, n, seed=11)
    mask = np.random.default_rng(12).random(n) < 0.7
    want = np.asarray(
        jax.jit(lambda v, m: ref_top_k_values(v, m, k, ascending))(
            jnp.asarray(x), jnp.asarray(mask)
        )
    )
    got = top_k_values(torch.from_numpy(x), torch.from_numpy(mask), k,
                       ascending).numpy()
    np.testing.assert_array_equal(got, want)
