"""The port's join phase 1 (``ops/join.py``) and the plain versions of
kernels K3, K4 and K5 (``ops/expand.py``), held against the JAX package
on the CPU: the Pallas kernels run in interpret mode and must agree bit
for bit (on int32 views, so NaN payloads, -0.0, ±inf and full-range
int32 codes count); phase 1 must give the reference's ``JoinPhase1``
fields exactly.  The CUDA kernels themselves are compared with these
plain versions on a card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdb_tpu_torch.errors import ExecutionError
from warpdb_tpu_torch.ops import expand
from warpdb_tpu_torch.ops.join import join_match_counts

INTERPRET = jax.default_backend() != "tpu"


def _special_columns(n: int, seed: int):
    """An f32 column with NaN (payloads included), ±inf, -0.0 and huge
    values, and a full-range int32 column."""
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 1e10, n).astype(np.float32)
    f[5], f[7], f[9], f[11] = np.nan, -np.inf, -0.0, np.inf
    bits = f.view(np.uint32)
    bits[13] = 0x7FC01234  # a NaN with a payload
    bits[15] = 0xFF800001  # a negative signalling NaN
    i = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int32)
    i[0], i[1] = -2**31, 2**31 - 1
    return f, i


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


# --- K3: windowed_expand ------------------------------------------------------


def _expand_counts():
    rng = np.random.default_rng(21)
    counts = rng.integers(1, 4, 4096).astype(np.int32)
    counts[100:103] = 0       # zero-count rows inside
    counts[-97:] = 0          # and a zero-count tail
    return counts


def test_windowed_expand_plain_matches_pallas_interpret():
    from warpdb_tpu.ops.pallas_expand import windowed_expand

    counts = _expand_counts()
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    total = int(counts.sum())
    capacity = -(-total // 1024) * 1024
    f, i = _special_columns(4096, 3)
    pidx, off_r, taken = windowed_expand(
        jnp.asarray(offsets), (jnp.asarray(f), jnp.asarray(i)), capacity,
        total=jnp.int32(total), interpret=INTERPRET,
    )
    owner, dup, got = expand.windowed_expand(
        torch.from_numpy(offsets.astype(np.int64)),
        [torch.from_numpy(f), torch.from_numpy(i)], total, owner=True,
    )
    assert owner.dtype == torch.int32 and dup.dtype == torch.int32
    assert owner.shape == dup.shape == (total,)
    np.testing.assert_array_equal(owner.numpy(), np.asarray(pidx)[:total])
    np.testing.assert_array_equal(
        dup.numpy(), np.arange(total) - np.asarray(off_r)[:total]
    )
    for g, w in zip(got, taken):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w)[:total])
    # And against NumPy's own expansion.
    want_owner = np.repeat(np.arange(4096), counts)
    np.testing.assert_array_equal(owner.numpy(), want_owner)
    np.testing.assert_array_equal(_bits(got[0].numpy()),
                                  _bits(f[want_owner]))


@pytest.mark.parametrize("case", ["empty", "sparse", "one_row"])
def test_windowed_expand_plain_edges(case):
    """Cases outside the TPU kernel's span contract: the port takes any
    offsets."""
    rng = np.random.default_rng(4)
    n = 5000
    if case == "empty":
        counts = np.zeros(n, np.int64)
    elif case == "sparse":
        counts = np.zeros(n, np.int64)
        counts[rng.choice(n, 7, replace=False)] = rng.integers(1, 5, 7)
    else:
        counts = np.zeros(n, np.int64)
        counts[-1] = 3000
    offsets = np.cumsum(counts) - counts
    total = int(counts.sum())
    col = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int32)
    owner, dup, (got,) = expand.windowed_expand(
        torch.from_numpy(offsets), [torch.from_numpy(col)], total, owner=True
    )
    want = np.repeat(np.arange(n), counts)
    np.testing.assert_array_equal(owner.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), col[want])
    want_dup = np.concatenate([np.arange(c) for c in counts if c] or [[]])
    np.testing.assert_array_equal(dup.numpy(), want_dup.astype(np.int32))


# --- K4: uniform_expand -------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4, 8])
def test_uniform_expand_plain_matches_pallas_interpret(k):
    from warpdb_tpu.ops.pallas_expand import uniform_expand

    n_src = 4096
    cap = n_src * k // 2
    f, i = _special_columns(n_src, 5)
    want = uniform_expand((jnp.asarray(f), jnp.asarray(i)), k=k,
                          capacity=cap, interpret=INTERPRET)
    total = cap - 5  # a ragged total inside the capacity
    got = expand.uniform_expand([torch.from_numpy(f), torch.from_numpy(i)],
                                k, total)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    for g, w in zip(got, want):
        assert g.shape == (total,)
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w)[:total])


def test_uniform_expand_plain_any_fanout():
    """k = 3 is outside the TPU kernel's {2, 4, 8}; the port takes it."""
    f, i = _special_columns(1000, 6)
    got = expand.uniform_expand([torch.from_numpy(f), torch.from_numpy(i)],
                                3, 2999)
    r = np.arange(2999) // 3
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(f[r]))
    np.testing.assert_array_equal(got[1].numpy(), i[r])


# --- K5: sorted_take ----------------------------------------------------------


def test_sorted_take_plain_matches_pallas_interpret():
    from warpdb_tpu.ops.pallas_expand import windowed_sorted_take

    n_src, n_idx = 4096, 8192
    idx = np.repeat(np.arange(n_src, dtype=np.int32), 2)
    f, i = _special_columns(n_src, 3)
    valid = np.ones(n_idx, bool)
    valid[-3:] = False
    want = windowed_sorted_take(
        (jnp.asarray(f), jnp.asarray(i)), jnp.asarray(idx),
        jnp.asarray(valid), interpret=INTERPRET,
    )
    got = expand.sorted_take([torch.from_numpy(f), torch.from_numpy(i)],
                             torch.from_numpy(idx.astype(np.int64)),
                             torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_sorted_take_plain_sparse_and_no_mask():
    """A sparse nondecreasing index (outside the TPU kernel's span
    contract), no validity mask."""
    rng = np.random.default_rng(8)
    f, i = _special_columns(50_000, 9)
    idx = np.sort(rng.choice(50_000, 3000, replace=False))
    got = expand.sorted_take([torch.from_numpy(f), torch.from_numpy(i)],
                             torch.from_numpy(idx))
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(f[idx]))
    np.testing.assert_array_equal(got[1].numpy(), i[idx])


@pytest.mark.parametrize("fn,args", [
    (expand.sorted_take, lambda t: ([t], torch.zeros(4, dtype=torch.int64,
                                                      device="meta"))),
    (expand.uniform_expand, lambda t: ([t], 2, 8)),
    (expand.windowed_expand, lambda t: (torch.zeros(4, dtype=torch.int64,
                                                    device="meta"), [t], 4)),
])
def test_wrappers_reject_other_devices(fn, args):
    t = torch.zeros(4, dtype=torch.float32, device="meta")
    with pytest.raises(ExecutionError, match="unsupported device"):
        fn(*args(t))


def test_wrappers_reject_wide_columns():
    with pytest.raises(ExecutionError, match="4-byte"):
        expand.sorted_take([torch.zeros(4, dtype=torch.float64)],
                           torch.arange(4))


# --- phase 1 ------------------------------------------------------------------


def _keys(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "float":
        k = rng.integers(0, 40, n).astype(np.float32) / 2
        k[::11] = np.nan
        k[3::13] = -0.0
        k[5::17] = 0.0
        k[7::19] = np.float32(np.inf)
        return k
    # int keys beyond 2^24, where f32 would merge neighbours
    return (2**24 + rng.integers(0, 30, n)).astype(np.int32)


def _ref_phase1(fn, *args):
    out = fn(*args)
    return {f: np.asarray(getattr(out, f)).astype(np.int64)
            for f in ("build_order", "build_sorted", "lo", "counts", "total")}


def _port_phase1(out):
    return {f: getattr(out, f).numpy().astype(np.int64)
            for f in ("build_order", "build_sorted", "lo", "counts", "total")}


def _assert_phase1_equal(got, want):
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["float", "int"])
def test_join_match_counts_matches_reference(kind, masked):
    from warpdb_tpu.ops.join import join_match_counts as ref

    p, b = _keys(kind, 3000, 1), _keys(kind, 700, 2)
    rng = np.random.default_rng(3)
    pm = rng.random(3000) < 0.9 if masked else np.ones(3000, bool)
    bm = rng.random(700) < 0.9 if masked else np.ones(700, bool)
    want = _ref_phase1(ref, jnp.asarray(p), jnp.asarray(pm), jnp.asarray(b),
                       jnp.asarray(bm))
    got = _port_phase1(join_match_counts(
        torch.from_numpy(p), torch.from_numpy(pm) if masked else None,
        torch.from_numpy(b), torch.from_numpy(bm) if masked else None,
    ))
    _assert_phase1_equal(got, want)


def test_join_match_counts_composite_matches_reference():
    from warpdb_tpu.ops.join import join_match_counts as ref

    p = (_keys("float", 2000, 4), _keys("int", 2000, 5))
    b = (_keys("float", 500, 6), _keys("int", 500, 7))
    pm = np.random.default_rng(8).random(2000) < 0.8
    bm = np.ones(500, bool)
    want = _ref_phase1(ref, tuple(jnp.asarray(x) for x in p), jnp.asarray(pm),
                       tuple(jnp.asarray(x) for x in b), jnp.asarray(bm))
    got = _port_phase1(join_match_counts(
        [torch.from_numpy(x) for x in p], torch.from_numpy(pm),
        [torch.from_numpy(x) for x in b], None,
    ))
    _assert_phase1_equal(got, want)


@pytest.mark.parametrize("n_build", [1, 7, 200])
def test_join_match_counts_dense_matches_reference(n_build):
    """Small build sides, with duplicate build keys and probe misses: the
    reference takes its dense (N, K) phase 1 there; the port's one
    searchsorted phase 1 gives the same fields."""
    from warpdb_tpu.ops.join import join_match_counts_dense as ref

    p, b = _keys("float", 3000, 11), _keys("float", n_build, 12)
    k_cap = max(1 << (n_build - 1).bit_length(), 8)
    pm = np.random.default_rng(13).random(3000) < 0.9
    want = _ref_phase1(ref, jnp.asarray(p), jnp.asarray(pm), jnp.asarray(b),
                       jnp.ones(n_build, bool), k_cap)
    got = _port_phase1(join_match_counts(
        torch.from_numpy(p), torch.from_numpy(pm), torch.from_numpy(b), None,
    ))
    _assert_phase1_equal(got, want)
    assert got["counts"].sum() > 0 and (got["counts"][pm] == 0).any()
