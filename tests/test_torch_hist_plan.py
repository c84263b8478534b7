"""A NumPy model of kernel K2's design (csrc/group_hist.cu).

The CUDA kernel runs only on a card; here its arithmetic is modelled
step by step from the wrapper's own plan (``slice_plan``): which slice
owns each slot (``umulhi(g, magic)``), the slice bounds at ragged slot
counts, the shared memory and threads of a block, which group of blocks
each row lands in (16-byte units grid-strided over the groups, the
unaligned head and the tail one a lane), the per-group f32 tables, the
partials buffer and the combine (counts in i32, sums in f64).  The model
is held against the plain version and a float64 ``np.bincount``.
"""

import numpy as np
import pytest
import torch

from warpdb_tpu_torch.errors import ExecutionError
from warpdb_tpu_torch.ops import group_kernel
from warpdb_tpu_torch.ops.group_kernel import (
    MAX_SLOTS, SLICE_BYTES, slice_plan,
)

RAGGED = [1, 2, 3, 4097, 6000, 16385, 40000, 65535, 65536]
WIDTHS = [(1, 0), (1, 1), (1, 4), (0, 1), (0, 4)]  # (has_count, nv)


def _owner(g: np.ndarray, magic: int) -> np.ndarray:
    """``__umulhi(g, magic)``."""
    return (g.astype(np.uint64) * np.uint64(magic)) >> np.uint64(32)


@pytest.mark.parametrize("hc,nv", WIDTHS)
@pytest.mark.parametrize("num_slots", RAGGED)
def test_slot_to_owner_is_a_bijection(num_slots, hc, nv):
    p = slice_plan(num_slots, hc, nv)
    words, S, R = hc + nv, p.S, p.slices
    # The fewest slices of at most SLICE_BYTES, each within a block.
    assert p.smem == S * words * 4 <= SLICE_BYTES
    if R > 1:
        assert -(-num_slots // (R - 1)) * words * 4 > SLICE_BYTES
    # Up to four blocks an SM, 1024 threads an SM in all.
    per_sm = min(4, 233_472 // (p.smem + 1024))
    assert p.threads == 1024 // per_sm // 32 * 32
    assert R * S >= num_slots and (R == 1 or S >= 2)
    g = np.arange(num_slots, dtype=np.int64)
    owner = _owner(g, p.magic).astype(np.int64)
    np.testing.assert_array_equal(owner, g // S)
    local = g - owner * S
    assert owner.max() < R and local.min() >= 0 and local.max() < S
    # The flush writes slice r's local l to slot r * S + l: every slot once.
    np.testing.assert_array_equal(owner * S + local, g)


def test_magic_is_exact_over_the_whole_id_range():
    g = np.arange(MAX_SLOTS, dtype=np.int64)
    for S in (2, 3, 5, 7, 513, 4097, 5000, 8192, 9363, 16385, 21846, 32768):
        magic = -(-(1 << 32) // S)
        np.testing.assert_array_equal(_owner(g, magic).astype(np.int64),
                                      g // S, err_msg=f"S={S}")


@pytest.mark.parametrize("num_slots", [0, -1, MAX_SLOTS + 1, 1 << 20])
def test_slot_limit_is_refused_on_both_devices(num_slots):
    gid = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ExecutionError, match=f"1..{MAX_SLOTS} slots"):
        group_kernel.group_counts_sums(gid, [torch.ones(8)], num_slots)
    with pytest.raises(ExecutionError, match=f"1..{MAX_SLOTS} slots"):
        group_kernel.group_counts_sums_plain(gid, [], num_slots)
    with pytest.raises(ExecutionError, match=f"1..{MAX_SLOTS} slots"):
        slice_plan(num_slots, 1, 1)


def model_group_hist(gid, vals, num_slots, groups, head=0):
    """The kernel's per-group tables, partials and combine, in NumPy."""
    n = gid.shape[0]
    hc, nv = 1, len(vals)
    words = hc + nv
    p = slice_plan(num_slots, hc, nv)
    R, S, magic, threads = p.slices, p.S, p.magic, p.threads
    head = min(head, n)
    nvec = (n - head) // 4
    tail0 = head + 4 * nvec
    # Which group of blocks adds each row: thread t of the group's
    # `stride` threads takes units (and scalar rows) t, t + stride, ...
    stride = groups * threads
    scalar = np.concatenate([np.arange(head), np.arange(tail0, n)])
    inner = np.arange(head, tail0)
    gi = np.empty(n, np.int64)
    gi[inner] = ((inner - head) // 4) % stride // threads
    gi[scalar] = np.arange(scalar.shape[0]) % stride // threads
    ok = (gid >= 0) & (gid < num_slots)
    g = np.where(ok, gid, 0).astype(np.int64)
    owner = _owner(g, magic).astype(np.int64)
    local = g - owner * S
    table = np.zeros((groups, R, words, S), np.float32)
    counts = np.zeros((groups, R, S), np.int64)
    np.add.at(counts, (gi[ok], owner[ok], local[ok]), 1)
    for c, v in enumerate(vals):
        np.add.at(table, (gi[ok], owner[ok], c + 1, local[ok]), v[ok])
    # Flush: slice r of group k goes to partials[k, w, r*S:].
    partial_c = np.zeros((groups, num_slots), np.int64)
    partial_s = np.zeros((groups, nv, num_slots), np.float32)
    for r in range(R):
        lo, hi = r * S, min((r + 1) * S, num_slots)
        if hi > lo:
            partial_c[:, lo:hi] = counts[:, r, : hi - lo]
            partial_s[:, :, lo:hi] = table[:, r, 1:, : hi - lo]
    out_c = partial_c.sum(axis=0).astype(np.int32)
    out_s = partial_s.astype(np.float64).sum(axis=0).astype(np.float32)
    return out_c, list(out_s)


def _ids(case: str, num_slots: int, n: int, rng) -> np.ndarray:
    if case == "uniform":
        gid = rng.integers(0, num_slots, n)
    elif case == "one_slot":
        gid = np.full(n, num_slots // 2)
    else:  # a Zipf-like mix over shuffled slot labels
        perm = rng.permutation(num_slots)
        gid = perm[(rng.zipf(1.3, n) - 1) % num_slots]
    gid = gid.astype(np.int32)
    gid[::17] = num_slots  # invalid rows, as callers pass them
    gid[5::29] = -3
    return gid


@pytest.mark.parametrize("head", [0, 3])
@pytest.mark.parametrize("case", ["uniform", "one_slot", "zipf"])
# Slices 1 (4097, 6000), 2 (40000), 3 (65536 at nv = 1) and 7 (65536 at
# nv = 4); group counts as the wrapper would pick for a small input.
@pytest.mark.parametrize("num_slots,nv,groups", [
    (4097, 1, 5), (6000, 2, 2), (40000, 1, 3), (65536, 1, 2), (65536, 4, 1),
])
def test_model_matches_plain_and_float64(num_slots, nv, groups, case, head):
    rng = np.random.default_rng(num_slots + nv)
    n = 50_003
    gid = _ids(case, num_slots, n, rng)
    vals = [rng.uniform(0, 100, n).astype(np.float32) for _ in range(nv)]
    got_c, got_s = model_group_hist(gid, vals, num_slots, groups, head)
    want_c, want_s = group_kernel.group_counts_sums_plain(
        torch.from_numpy(gid), [torch.from_numpy(v) for v in vals], num_slots)
    np.testing.assert_array_equal(got_c, want_c.numpy())
    ok = (gid >= 0) & (gid < num_slots)
    for a, b, v in zip(got_s, want_s, vals):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=1e-2)
        ref = np.bincount(gid[ok], weights=v[ok].astype(np.float64),
                          minlength=num_slots)
        np.testing.assert_allclose(a, ref, rtol=1e-4, atol=1e-2)
