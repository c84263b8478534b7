"""warpdb_tpu_torch on a CUDA card: each kernel against its plain
version, and the slice on the card against the same slice on the CPU.

Every test here needs a card and skips without one.  This file imports
no JAX (the card's machine has none), so it runs there without the
repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import ctypes

import numpy as np
import pytest
import torch

from warpdb_tpu_torch import WarpDB
from warpdb_tpu_torch.ops import expand, group_kernel, topk_kernel
from warpdb_tpu_torch.storage import HostTable

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


def _topk_input(case: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    if case == "random":
        return rng.uniform(-100, 100, n).astype(np.float32)
    if case == "ascending":
        return np.sort(rng.uniform(-100, 100, n).astype(np.float32))
    return rng.choice(np.float32([1.0, 2.0, 3.0, 99.5]), n)


@pytest.mark.parametrize("k", [16, 32, 64, 128])
@pytest.mark.parametrize("case", ["random", "ascending", "duplicates"])
# 100_000 values are fewer than one wave of the kernel's threads.
@pytest.mark.parametrize("n", [1 << 22, (1 << 22) - 37, 1000, 100_000])
def test_topk_kernel_matches_plain(cuda, case, k, n):
    xd = torch.from_numpy(_topk_input(case, n)).to(cuda)
    before = topk_kernel.topk_candidates.launches
    cand = topk_kernel.topk_candidates(xd, k)
    got = torch.topk(cand.reshape(-1), k).values
    want = topk_kernel.topk_candidates_plain(xd, k).reshape(-1)
    torch.cuda.synchronize()
    assert topk_kernel.topk_candidates.launches == before + 1
    assert cand.shape == (1, k)
    assert torch.equal(got, want)
    assert torch.equal(cand[0], want)  # the row is sorted


@pytest.mark.parametrize("k", [16, 32, 64, 128])
@pytest.mark.parametrize("case", ["random", "ascending", "duplicates"])
@pytest.mark.parametrize("shift", [1, 2, 3])
def test_topk_kernel_unaligned_input(cuda, case, k, shift):
    # A view `shift` floats into the buffer: not 16-byte aligned.
    base = torch.from_numpy(_topk_input(case, (1 << 22) - 37)).to(cuda)
    xd = base[shift:]
    got = topk_kernel.topk_candidates(xd, k)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, topk_kernel.topk_candidates_plain(xd, k)[0])


@pytest.mark.parametrize("k", [2, 5, 17, 33, 100, 128])
@pytest.mark.parametrize("n", [3, 40, 5000])
def test_top_k_values_on_card(cuda, k, n):
    from warpdb_tpu_torch.ops.sort import top_k_values

    x = torch.from_numpy(_topk_input("random", n)).to(cuda)
    mask = torch.arange(n, device=cuda) % 3 != 0
    for asc in (False, True):
        got = top_k_values(x, mask, k, asc)
        want = top_k_values(x.cpu(), mask.cpu(), k, asc)
        assert torch.equal(got.cpu(), want)


def test_topk_kernel_on_two_streams(cuda):
    # Each stream has its own ticket; back-to-back launches reuse it.
    xs = [torch.from_numpy(_topk_input(c, 1 << 20)).to(cuda)
          for c in ("random", "ascending")]
    side = torch.cuda.Stream()
    outs = []
    for i in range(4):
        with torch.cuda.stream(side if i % 2 else torch.cuda.current_stream()):
            outs.append(topk_kernel.topk_candidates(xs[i % 2], 64))
    torch.cuda.synchronize()
    for i, o in enumerate(outs):
        assert torch.equal(o, topk_kernel.topk_candidates_plain(xs[i % 2], 64))


def _group_ids(case: str, num_slots: int, n: int, rng) -> np.ndarray:
    if case == "uniform":
        gid = rng.integers(0, num_slots, n)
    elif case == "one_slot":
        gid = np.full(n, num_slots // 3)
    else:  # Zipf-like over shuffled slot labels
        perm = rng.permutation(num_slots)
        gid = perm[(rng.zipf(1.3, n) - 1) % num_slots]
    gid = gid.astype(np.int32)
    gid[::17] = num_slots
    gid[5::29] = -3
    return gid


def _check_group(gid, vals, num_slots):
    gd = torch.from_numpy(gid).cuda()
    vd = [torch.from_numpy(v).cuda() for v in vals]
    before = group_kernel.group_counts_sums.launches
    c, s = group_kernel.group_counts_sums(gd, vd, num_slots)
    cp, sp = group_kernel.group_counts_sums_plain(gd, vd, num_slots)
    torch.cuda.synchronize()
    assert group_kernel.group_counts_sums.launches == before + max(
        1, -(-len(vals) // 4))
    assert torch.equal(c, cp)
    ok = (gid >= 0) & (gid < num_slots)
    for a, b, v in zip(s, sp, vals):
        # Sums add in a run-dependent order: rtol 1e-4 of the plain
        # version and of float64.
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
        ref = np.bincount(gid[ok], weights=v[ok].astype(np.float64),
                          minlength=num_slots)
        np.testing.assert_allclose(a.cpu().numpy(), ref, rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("nv", [0, 1, 4, 5])
@pytest.mark.parametrize("num_slots", [4097, 6000, 16385, 40000, 65536])
def test_group_kernel_matches_plain(cuda, num_slots, nv):
    rng = np.random.default_rng(33)
    n = 1 << 20
    gid = _group_ids("uniform", num_slots, n, rng)
    vals = [rng.uniform(0, 100, n).astype(np.float32) for _ in range(nv)]
    _check_group(gid, vals, num_slots)


@pytest.mark.parametrize("nv", [0, 1, 4])
@pytest.mark.parametrize("case", ["one_slot", "zipf"])
@pytest.mark.parametrize("num_slots", [4097, 65536])
def test_group_kernel_skewed_ids(cuda, num_slots, case, nv):
    # 2^20 rows: the plain version's single f32 chain a slot stays within
    # rtol 1e-4 of float64 there (at 2^22 rows on one slot it drifts 1e-3).
    rng = np.random.default_rng(34)
    n = (1 << 20) + 3
    gid = _group_ids(case, num_slots, n, rng)
    vals = [rng.uniform(0, 100, n).astype(np.float32) for _ in range(nv)]
    _check_group(gid, vals, num_slots)


@pytest.mark.parametrize("shifts", [(1, 1), (3, 3), (0, 1), (2, 0)])
def test_group_kernel_unaligned_columns(cuda, shifts):
    # Ids and values at the same offset from 16 bytes take the 16-byte
    # units after a scalar head; at different offsets every row is scalar.
    rng = np.random.default_rng(36)
    n = (1 << 20) + 5
    gid = _group_ids("uniform", 40000, n + 3, rng)
    v = rng.uniform(0, 100, n + 3).astype(np.float32)
    gs, vs = shifts
    gd = torch.from_numpy(gid).cuda()[gs:gs + n]
    vd = torch.from_numpy(v).cuda()[vs:vs + n]
    c, (s,) = group_kernel.group_counts_sums(gd, [vd], 40000)
    cp, (sp,) = group_kernel.group_counts_sums_plain(gd, [vd], 40000)
    torch.cuda.synchronize()
    assert torch.equal(c, cp)
    torch.testing.assert_close(s, sp, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("num_slots", [4097, 65536])
def test_group_kernel_non_finite_values(cuda, num_slots):
    # ±inf and NaN reach only their own slot, also in a hot warp.
    n = 1 << 16
    gid = torch.arange(n, dtype=torch.int32, device=cuda) % 64
    gid[1024:1152] = 7  # 128 rows on one slot: the warps' hot-slot path
    v = torch.ones(n, device=cuda)
    v[3], v[12], v[1030], v[200] = (float("inf"), float("-inf"),
                                    float("nan"), float("inf"))
    c, (s,) = group_kernel.group_counts_sums(gid, [v], num_slots)
    cp, (sp,) = group_kernel.group_counts_sums_plain(gid, [v], num_slots)
    torch.cuda.synchronize()
    assert torch.equal(c, cp)
    assert torch.equal(torch.isnan(s), torch.isnan(sp))
    assert torch.equal(torch.isinf(s), torch.isinf(sp))
    fin = torch.isfinite(sp)
    torch.testing.assert_close(s[fin], sp[fin])
    assert int(torch.isfinite(s).logical_not().sum()) == 4


def test_group_kernel_refuses_over_its_limit(cuda):
    from warpdb_tpu_torch.errors import ExecutionError

    gid = torch.zeros(64, dtype=torch.int32, device=cuda)
    for bad in (0, group_kernel.MAX_SLOTS + 1):
        with pytest.raises(ExecutionError, match="slots"):
            group_kernel.group_counts_sums(gid, [], bad)


def _host() -> HostTable:
    rng = np.random.default_rng(99)
    n = 50_000
    nv = rng.uniform(0, 10, n).astype(np.float32)
    nv[::53] = np.nan
    return HostTable.from_dict({
        "price": rng.uniform(0, 100, n).astype(np.float32),
        "quantity": rng.integers(0, 32, n).astype(np.float32),
        "k": rng.integers(0, 60_000, n).astype(np.float32),
        "ki": rng.integers(0, 5000, n).astype(np.int32),
        "fk": (rng.integers(0, 300, n) / 4).astype(np.float32),
        "nv": nv,
        "s": rng.choice(["apple", "banana", "cherry"], n),
        "wide": rng.choice(np.array([-(2**40), 7, 2**53 + 1], np.int64), n),
    })


@pytest.fixture(scope="module")
def dbs(cuda):
    host = _host()
    return WarpDB(host, device="cuda"), WarpDB(host, device="cpu")


QUERIES = [
    ("expr", "price * quantity"),
    ("expr", "price * 0.9 WHERE price > 20"),
    ("expr", "discount(price, 0.9)"),
    ("expr", "CASE WHEN price > 50 THEN 1 ELSE 0 END"),
    ("expr", "coalesce(nv, 0 - 1) + sqrt(price)"),
    ("expr", "price WHERE s = 'banana'"),
    ("sql", "SELECT SUM(price) FROM t GROUP BY quantity ORDER BY quantity ASC"),
    ("sql", "SELECT price FROM t ORDER BY price DESC LIMIT 5"),
    ("sql", "SELECT price FROM t ORDER BY price ASC LIMIT 200 OFFSET 3"),
    ("sql", "SELECT SUM(price) FROM t GROUP BY k"),
    ("sql", "SELECT COUNT(*) FROM t GROUP BY k"),
    ("sql", "SELECT MAX(price) FROM t GROUP BY k"),
    ("sql", "SELECT k FROM t GROUP BY k HAVING COUNT(*) > 1 "
            "ORDER BY SUM(price) DESC LIMIT 10"),
    ("sql", "SELECT SUM(quantity) FROM t GROUP BY fk"),
    ("sql", "SELECT fk FROM t GROUP BY fk ORDER BY MAX(nv) DESC LIMIT 6"),
    ("sql", "SELECT COUNT(*) FROM t GROUP BY quantity, s"),
    ("sql", "SELECT quantity, COUNT(*) FROM t GROUP BY quantity "
            "HAVING SUM(price) > 1000"),
    ("sql", "SELECT DISTINCT quantity FROM t"),
    ("sql", "SELECT DISTINCT ki FROM t ORDER BY ki DESC"),
    ("sql", "SELECT DISTINCT fk FROM t"),
    ("sql", "SELECT price FROM t WHERE price > 99.5"),
    ("sql", "SELECT price FROM t ORDER BY quantity DESC, price ASC LIMIT 20"),
    ("sql", "SELECT nv FROM t ORDER BY nv DESC LIMIT 5"),
    ("sql", "SELECT COUNT(nv) FROM t"),
    ("sql", "SELECT MEDIAN(price) FROM t GROUP BY s"),
    ("sql", "SELECT COUNT(DISTINCT quantity) FROM t"),
    ("sql", "SELECT AVG(price) FROM t WHERE quantity > 20"),
    ("sql", "SELECT s FROM t ORDER BY s DESC LIMIT 4"),
    ("sql", "SELECT UPPER(s) FROM t LIMIT 5"),
    ("sql", "SELECT wide FROM t WHERE wide > 7 ORDER BY wide ASC LIMIT 5"),
]


@pytest.mark.parametrize("kind,q", QUERIES)
def test_slice_on_card_matches_cpu(dbs, kind, q):
    gpu, cpu = dbs
    run = (lambda db: db.query(q)) if kind == "expr" else (
        lambda db: db.query_sql(q))
    got, want = run(gpu), run(cpu)
    assert len(got) == len(want), q
    if want and isinstance(want[0], str):
        assert got == want, q
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype.kind == w.dtype.kind, q
    # Sums add in another order on the card (atomics): rtol 1e-5.
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, equal_nan=True,
                               err_msg=q)


def test_slice_launches_both_kernels(dbs):
    gpu, _cpu = dbs
    k1 = topk_kernel.topk_candidates.launches
    k2 = group_kernel.group_counts_sums.launches
    gpu.query_sql("SELECT price FROM t ORDER BY price DESC LIMIT 5")
    gpu.query_sql("SELECT SUM(price) FROM t GROUP BY k")
    assert topk_kernel.topk_candidates.launches == k1 + 1
    assert group_kernel.group_counts_sums.launches == k2 + 1


# --- windows, QUALIFY and grouping sets on the card ------------------------

# Integral values (quantity) under the window expressions keep their
# averages exact in f32 on both devices.
WINDOW_QUERIES = [
    "SELECT SUM(price) OVER (PARTITION BY quantity) FROM t WHERE price > 99",
    "SELECT AVG(price) OVER (PARTITION BY k) FROM t",
    "SELECT MIN(nv) OVER (PARTITION BY s) FROM t",
    "SELECT ROW_NUMBER() OVER (PARTITION BY quantity ORDER BY price DESC) "
    "FROM t",
    "SELECT DENSE_RANK() OVER (PARTITION BY s ORDER BY fk) FROM t",
    "SELECT CUME_DIST() OVER (PARTITION BY quantity ORDER BY fk DESC) FROM t",
    "SELECT SUM(price) OVER (PARTITION BY quantity ORDER BY price ASC) FROM t",
    "SELECT MAX(nv) OVER (PARTITION BY quantity ORDER BY price) FROM t",
    "SELECT AVG(price) OVER (PARTITION BY quantity ORDER BY price ROWS "
    "BETWEEN 3 PRECEDING AND 3 FOLLOWING) FROM t",
    "SELECT MIN(price) OVER (PARTITION BY s ORDER BY ki ROWS BETWEEN 5 "
    "PRECEDING AND 2 FOLLOWING) FROM t",
    "SELECT COUNT(price) OVER (PARTITION BY k ORDER BY price RANGE BETWEEN "
    "0.5 PRECEDING AND 0.5 FOLLOWING) FROM t",
    "SELECT SUM(quantity) OVER (PARTITION BY s ORDER BY fk GROUPS BETWEEN 1 "
    "PRECEDING AND 1 FOLLOWING) FROM t",
    "SELECT LAG(price, 1) OVER (PARTITION BY k ORDER BY price) FROM t",
    "SELECT NTH_VALUE(price, 2) OVER (PARTITION BY quantity ORDER BY fk) "
    "FROM t",
    "SELECT NTILE(5) OVER (PARTITION BY quantity ORDER BY price) FROM t",
    "SELECT quantity - AVG(quantity) OVER (PARTITION BY k) AS dev FROM t "
    "WHERE price > 90 ORDER BY dev DESC, price ASC LIMIT 10",
    "SELECT s, quantity - AVG(quantity) OVER (PARTITION BY ki) AS d FROM t",
    "SELECT k, price FROM t QUALIFY ROW_NUMBER() OVER (PARTITION BY k "
    "ORDER BY price DESC) <= 3 ORDER BY k ASC, price DESC",
    "SELECT quantity, k, SUM(price) FROM t GROUP BY GROUPING SETS ((k), "
    "(quantity), ())",
    "SELECT s, quantity, COUNT(*) FROM t GROUP BY ROLLUP(s, quantity)",
]


@pytest.mark.parametrize("q", WINDOW_QUERIES)
def test_window_on_card_matches_cpu(dbs, q):
    gpu, cpu = dbs
    got, want = gpu.query_sql_table(q), cpu.query_sql_table(q)
    assert list(got) == list(want), q
    for name in want:
        w, g = want[name], got[name]
        assert len(g) == len(w), q
        if w and isinstance(w[0], str):
            assert g == w, q
            continue
        ga, wa = np.asarray(g), np.asarray(w)
        assert ga.dtype.kind == wa.dtype.kind, q
        # Sums add in another order on the card: rtol 1e-5.
        np.testing.assert_allclose(ga, wa, rtol=1e-5, atol=1e-6,
                                   equal_nan=True, err_msg=f"{q} [{name}]")


def test_window_values_on_the_card(dbs, monkeypatch):
    """Every window value tensor lives on the card, and the grouping set
    over ``k`` launches K2."""
    from warpdb_tpu_torch.engine import window_exec

    gpu, _cpu = dbs
    seen = []
    values = window_exec._window_values

    def spy(*a, **kw):
        out = values(*a, **kw)
        seen.append(out.device)
        return out

    monkeypatch.setattr(window_exec, "_window_values", spy)
    k2 = group_kernel.group_counts_sums.launches
    for q in WINDOW_QUERIES:
        gpu.query_sql_table(q)
    assert len(seen) >= len(WINDOW_QUERIES) - 2
    assert all(d.type == "cuda" for d in seen), seen
    assert group_kernel.group_counts_sums.launches > k2


# --- K3, K4, K5: bit for bit against their plain versions ----------------


def _words(n: int, seed: int):
    """An f32 column with NaN payloads, ±inf and -0.0, and a full-range
    int32 column."""
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 1e10, n).astype(np.float32)
    bits = f.view(np.uint32)
    bits[1:: 97] = 0x7FC01234
    bits[3:: 89] = 0xFF800001
    f[5::83], f[7::79], f[9::73] = -np.inf, np.inf, -0.0
    i = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int32)
    return f, i


def _equal_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("ncols", [1, 3, 17])
@pytest.mark.parametrize("case", ["dense", "sparse", "left"])
def test_windowed_expand_matches_plain(cuda, case, ncols):
    rng = np.random.default_rng(41)
    n = 300_001
    if case == "dense":
        counts = rng.integers(0, 4, n)
    elif case == "sparse":
        counts = np.where(rng.random(n) < 0.001, rng.integers(1, 9, n), 0)
    else:
        counts = np.maximum(rng.integers(0, 4, n), 1)
    offsets = torch.from_numpy(np.cumsum(counts) - counts).to(cuda)
    total = int(counts.sum())
    f, i = _words(n, 42)
    cols = [torch.from_numpy(f if c % 2 else i).to(cuda) for c in range(ncols)]
    before = expand.windowed_expand.launches
    own, dup, got = expand.windowed_expand(offsets, cols, total, owner=True)
    pown, pdup, want = expand.windowed_expand_plain(offsets, cols, total,
                                                    owner=True)
    torch.cuda.synchronize()
    assert expand.windowed_expand.launches == before + -(-ncols // 16)
    assert torch.equal(own, pown) and torch.equal(dup, pdup)
    _equal_bits(got, want)


@pytest.mark.parametrize("k", [2, 3, 8])
def test_uniform_expand_matches_plain(cuda, k):
    n = 250_003
    f, i = _words(n, 43)
    cols = [torch.from_numpy(f).to(cuda), torch.from_numpy(i).to(cuda)]
    total = n * k - 1
    before = expand.uniform_expand.launches
    got = expand.uniform_expand(cols, k, total)
    want = expand.uniform_expand_plain(cols, k, total)
    torch.cuda.synchronize()
    assert expand.uniform_expand.launches == before + 1
    _equal_bits(got, want)


def _edge_counts(case: str) -> np.ndarray:
    """Emission counts of K3's edge cases: long runs of zero-count rows
    (a tile whose owners span thousands of rows), one row owning every
    output, a single probe row, and a ragged total."""
    rng = np.random.default_rng(46)
    if case == "zero_runs":
        counts = np.zeros(300_000, np.int64)
        counts[::7919] = rng.integers(1, 4, counts[::7919].shape[0])
    elif case == "one_owner":
        counts = np.zeros(100_000, np.int64)
        counts[777] = 300_001
    elif case == "one_row":
        counts = np.array([5003])
    else:
        counts = rng.integers(0, 4, (1 << 20) + 3)
        counts[-1] = 3 - counts[:-1].sum() % 2  # an odd total
    return counts


@pytest.mark.parametrize("ncols", [1, 16])
@pytest.mark.parametrize("owner", [True, False])
@pytest.mark.parametrize("case", ["zero_runs", "one_owner", "one_row",
                                  "ragged"])
def test_windowed_expand_edges_match_plain(cuda, case, owner, ncols):
    counts = _edge_counts(case)
    n, total = counts.shape[0], int(counts.sum())
    offsets = torch.from_numpy(np.cumsum(counts) - counts).to(cuda)
    f, i = _words(n, 47)
    cols = [torch.from_numpy(f if c % 2 else i).to(cuda) for c in range(ncols)]
    before = expand.windowed_expand.launches
    own, dup, got = expand.windowed_expand(offsets, cols, total, owner=owner)
    pown, pdup, want = expand.windowed_expand_plain(offsets, cols, total,
                                                    owner=owner)
    torch.cuda.synchronize()
    assert expand.windowed_expand.launches == before + 1
    assert torch.equal(dup, pdup)
    assert (own is None) == (not owner)
    if owner:
        assert torch.equal(own, pown)
    _equal_bits(got, want)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("k", [1, 2, 3, 7])
def test_uniform_expand_edges_match_plain(cuda, k, shift):
    """Any k, a ragged total, and source columns at an odd word offset
    (not 16-byte aligned)."""
    n = 250_003
    f, i = _words(n + shift, 48)
    cols = [torch.from_numpy(f).to(cuda)[shift:],
            torch.from_numpy(i).to(cuda)[shift:]]
    assert (cols[0].data_ptr() % 16 != 0) == bool(shift)
    for total in (n * k - 3, n * k, 5):
        got = expand.uniform_expand(cols, k, total)
        want = expand.uniform_expand_plain(cols, k, total)
        torch.cuda.synchronize()
        _equal_bits(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_sorted_take_matches_plain(cuda, masked):
    rng = np.random.default_rng(44)
    n_src, n_idx = 400_000, 700_001
    idx = torch.from_numpy(np.sort(rng.integers(0, n_src, n_idx))).to(cuda)
    valid = (torch.from_numpy(rng.random(n_idx) < 0.8).to(cuda)
             if masked else None)
    f, i = _words(n_src, 45)
    cols = [torch.from_numpy(f).to(cuda), torch.from_numpy(i).to(cuda)]
    before = expand.sorted_take.launches
    got = expand.sorted_take(cols, idx, valid)
    want = expand.sorted_take_plain(cols, idx, valid)
    torch.cuda.synchronize()
    assert expand.sorted_take.launches == before + 1
    _equal_bits(got, want)


# --- joins on the card against the port on the CPU -------------------------


def _join_tables():
    rng = np.random.default_rng(46)
    n = 40_000
    reps = rng.integers(0, 4, 3000)
    return {
        "t": HostTable.from_dict({
            "k": rng.integers(0, 3000, n).astype(np.float32),
            "g": rng.integers(0, 16, n).astype(np.float32),
            "price": rng.uniform(0, 100, n).astype(np.float32),
            "s": rng.choice(["a", "b", "c", "d"], n),
        }),
        "dim": HostTable.from_dict({
            "dk": np.arange(1000, 3500).astype(np.float32),
            "w": rng.uniform(0, 1, 2500).astype(np.float32),
            "name": np.array([f"x{j}" for j in range(2500)]),
        }),
        "dup": HostTable.from_dict({
            "kd": np.tile(np.arange(3000), 2).astype(np.float32),
            "w2": rng.uniform(0, 1, 6000).astype(np.float32),
        }),
        "multi": HostTable.from_dict({
            "km": np.repeat(np.arange(3000), reps).astype(np.float32),
            "wm": rng.uniform(0, 1, int(reps.sum())).astype(np.float32),
        }),
    }


@pytest.fixture(scope="module")
def join_dbs(cuda):
    tables = _join_tables()
    out = []
    for dev in ("cuda", "cpu"):
        db = WarpDB(tables["t"], device=dev)
        for name in ("dim", "dup", "multi"):
            db.register_table(name, tables[name])
        out.append(db)
    return out


JOIN_QUERIES = [
    "SELECT price FROM t JOIN dim ON k = dim.dk",
    "SELECT dim.name FROM t JOIN dim ON k = dim.dk LIMIT 100",
    "SELECT dup.w2 FROM t JOIN dup ON k = dup.kd",
    "SELECT multi.wm FROM t JOIN multi ON k = multi.km",
    "SELECT multi.wm FROM t LEFT JOIN multi ON k = multi.km",
    "SELECT COUNT(multi.wm) FROM t LEFT JOIN multi ON k = multi.km",
    "SELECT price FROM t RIGHT JOIN dim ON k = dim.dk",
    "SELECT price FROM t JOIN dim ON k = dim.dk WHERE price > 80",
    "SELECT SUM(price * dup.w2) FROM t JOIN dup ON k = dup.kd GROUP BY g "
    "ORDER BY g ASC",
    "SELECT price FROM t JOIN dim ON k = dim.dk ORDER BY price DESC LIMIT 5",
]


@pytest.mark.parametrize("q", JOIN_QUERIES)
def test_join_on_card_matches_cpu(join_dbs, q):
    gpu, cpu = join_dbs
    got, want = gpu.query_sql(q), cpu.query_sql(q)
    assert len(got) == len(want), q
    if want and isinstance(want[0], str):
        assert got == want, q
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6, equal_nan=True, err_msg=q)


def test_join_launches_the_expansion_kernels(join_dbs):
    from warpdb_tpu_torch.config import get_config

    gpu, _cpu = join_dbs
    cfg = get_config()
    saved, cfg.join_cache_entries = cfg.join_cache_entries, 0
    try:
        counts = [expand.windowed_expand.launches,
                  expand.uniform_expand.launches, expand.sorted_take.launches]
        gpu.query_sql("SELECT multi.wm FROM t JOIN multi ON k = multi.km")
        gpu.query_sql("SELECT dup.w2 FROM t JOIN dup ON k = dup.kd")
        gpu.query_sql("SELECT price FROM t JOIN dim ON k = dim.dk")
    finally:
        cfg.join_cache_entries = saved
    assert expand.windowed_expand.launches > counts[0]
    assert expand.uniform_expand.launches > counts[1]
    assert expand.sorted_take.launches > counts[2]


# --- TPC-H queries (subqueries, CTEs, derived tables) on the card ----------


def _tpch():
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                           / "benchmarks"))
    import tpch

    return tpch


@pytest.fixture(scope="module")
def tpch_dbs(cuda):
    tpch = _tpch()
    tables = tpch.make_tables(12_000, seed=11)
    out = []
    for dev in ("cuda", "cpu"):
        db = WarpDB(HostTable.from_dict(tables["lineitem"]), device=dev)
        db.register_table("lineitem", db.table)
        for name in ("orders", "customer", "supplier", "nation", "region",
                     "part", "partsupp"):
            db.register_table(name, HostTable.from_dict(tables[name]))
        out.append(db)
    return tables, out[0], out[1]


@pytest.mark.parametrize("name", ["q1", "q3", "q4", "q11", "q13", "q15",
                                  "q16", "q17", "q20", "q21", "q22"])
def test_tpch_on_card_matches_cpu_and_oracle(tpch_dbs, name):
    tables, gpu, cpu = tpch_dbs
    tpch = _tpch()
    got = gpu.query_sql_table(tpch.QUERIES[name])
    want = cpu.query_sql_table(tpch.QUERIES[name])
    tpch.check_results(name, got, tpch.oracle(tables, name))
    assert list(got) == list(want)
    for col in want:
        if want[col] and isinstance(want[col][0], str):
            assert got[col] == want[col], (name, col)
        else:
            # Sums add in another order on the card.
            np.testing.assert_allclose(
                np.asarray(got[col], np.float64),
                np.asarray(want[col], np.float64), rtol=1e-4, atol=1e-6,
                err_msg=f"{name} {col}")


def test_materialised_tables_on_the_card(tpch_dbs):
    """The CTE, derived and decorrelation tables of q13, q17, q21 and q22
    live on the card."""
    _tables, gpu, _cpu = tpch_dbs
    tpch = _tpch()
    for name in ("q13", "q17", "q21", "q22"):
        gpu.query_sql_table(tpch.QUERIES[name])
    tables = [*gpu._cte_memo.values(),
              *(t for src in (gpu.table, *gpu._catalog.values())
                for t in getattr(src, "_subq_memo", {}).values())]
    assert len(tables) >= 5
    for t in tables:
        assert t.device.type == "cuda"
        assert all(c.device.type == "cuda" for c in t.columns.values())


# --- APPROX_COUNT_DISTINCT, STRING_AGG and the result surfaces -----------

def _surface_data(n: int = 1 << 20) -> dict:
    rng = np.random.default_rng(31)
    price = rng.uniform(0, 100, n).astype(np.float32)
    price[::1001] = np.nan
    price[5::997] = -0.0
    return {
        "price": price,
        "quantity": rng.integers(0, 32, n).astype(np.float32),
        "k": rng.integers(0, 1 << 16, n).astype(np.float32),
        "tag": np.array([f"t{i:03d}" for i in range(300)])[
            rng.integers(0, 300, n)],
    }


@pytest.fixture(scope="module")
def surface_dbs(cuda):
    data = _surface_data()
    return (WarpDB(HostTable.from_dict(data), device=cuda),
            WarpDB(HostTable.from_dict(data), device="cpu"))


def test_hll_registers_on_card_match_cpu(cuda):
    from warpdb_tpu_torch.ops.hll import hll_estimate, hll_grouped_registers
    from warpdb_tpu_torch.ops.sort import float_sort_key

    data = _surface_data()
    vals = torch.from_numpy(data["price"])
    seg = torch.from_numpy(data["quantity"].astype(np.int64))
    valid = torch.from_numpy(data["k"] < 50_000)
    args = (seg, float_sort_key(vals), valid, 32)
    got = hll_grouped_registers(*(a.to(cuda) if isinstance(a, torch.Tensor)
                                  else a for a in args))
    want = hll_grouped_registers(*args)
    assert torch.equal(got.cpu(), want)
    torch.testing.assert_close(hll_estimate(got).cpu(), hll_estimate(want),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("sql", [
    "SELECT APPROX_COUNT_DISTINCT(price) FROM t",
    "SELECT quantity, APPROX_COUNT_DISTINCT(k) FROM t GROUP BY quantity",
    "SELECT APPROX_COUNT_DISTINCT(price) FROM t GROUP BY k",
    "SELECT quantity, APPROX_COUNT_DISTINCT(k) FROM t WHERE price > 1000 "
    "GROUP BY quantity",
    "SELECT quantity, STRING_AGG(tag, ',') FROM t WHERE price > 99.9 "
    "GROUP BY quantity",
])
def test_surface_aggregates_on_card_match_cpu(surface_dbs, sql):
    gpu, cpu = surface_dbs
    got, want = gpu.query_sql_table(sql), cpu.query_sql_table(sql)
    assert list(got) == list(want)
    for col in want:
        if want[col] and isinstance(want[col][0], str):
            assert got[col] == want[col]
        else:
            np.testing.assert_allclose(got[col], want[col], rtol=1e-5)


def test_arrow_export_on_card_matches_cpu(surface_dbs):
    from warpdb_tpu_torch.api import _capsule_address
    from warpdb_tpu_torch.interchange.arrow_export import ArrowArrayStruct

    gpu, cpu = surface_dbs
    arrays = []
    for db in (gpu, cpu):
        arr_c, _schema_c = db.query_arrow("price * quantity WHERE k > 10")
        arr = ArrowArrayStruct.from_address(_capsule_address(arr_c))
        buf = (ctypes.c_float * arr.length).from_address(arr.buffers[1])
        arrays.append(np.ctypeslib.as_array(buf).copy())
        arr.release(ctypes.pointer(arr))
    # Equal values; a NaN's sign and payload may differ between the two.
    np.testing.assert_array_equal(arrays[0], arrays[1])


@pytest.mark.parametrize("sql,k2,k1", [
    ("SELECT k, SUM(price) FROM t GROUP BY k", True, False),
    ("SELECT k, MIN(price) FROM t GROUP BY k", False, False),
    ("SELECT quantity, SUM(price) FROM t GROUP BY quantity", True, False),
    ("SELECT k FROM t ORDER BY k DESC LIMIT 5", False, True),
])
def test_explain_names_the_kernels_that_launch(surface_dbs, sql, k2, k1):
    gpu, _cpu = surface_dbs
    before = (group_kernel.group_counts_sums.launches,
              topk_kernel.topk_candidates.launches)
    plan = gpu.explain(sql, analyze=True)
    torch.cuda.synchronize()
    ran = (group_kernel.group_counts_sums.launches > before[0],
           topk_kernel.topk_candidates.launches > before[1])
    assert ("K2 shared-memory" in plan, "K1 top-k kernel" in plan) == (k2, k1)
    assert ran == (k2, k1), plan


@pytest.mark.parametrize("sql", [
    "SELECT k, SUM(price) AS s, COUNT(*) AS n FROM t GROUP BY k",
    "SELECT price, k FROM t WHERE price > 99 ORDER BY price DESC, k ASC "
    "LIMIT 20",
])
def test_stream_on_card_matches_cpu(cuda, tmp_path, sql):
    """A grouped statement (K2 once a chunk) and a per-row top-k stream
    from a CSV on the card and on the CPU; the expression stream too."""
    rng = np.random.default_rng(8)
    n = 20_000
    price = rng.integers(0, 10_000, n) / 100
    k = rng.integers(0, 5000, n)
    path = tmp_path / "s.csv"
    path.write_text("price,k\n" + "".join(
        f"{p:.2f},{q}\n" for p, q in zip(price, k)))
    before = group_kernel.group_counts_sums.launches
    gpu = WarpDB.query_streaming_sql(str(path), sql, 3000, device="cuda")
    torch.cuda.synchronize()
    if "GROUP BY" in sql:
        assert group_kernel.group_counts_sums.launches == before + 7
    cpu = WarpDB.query_streaming_sql(str(path), sql, 3000, device="cpu")
    assert list(gpu) == list(cpu)
    for name in cpu:
        if name == "s":
            np.testing.assert_allclose(gpu[name], cpu[name], rtol=1e-5)
        else:
            assert gpu[name] == cpu[name], name
    expr = "price * k WHERE price > 50"
    assert (WarpDB.query_streaming_csv(str(path), expr, 3000, device="cuda")
            == WarpDB.query_streaming_csv(str(path), expr, 3000,
                                          device="cpu"))


# --- the mesh: four shards of the card against four CPU shards ------------


@pytest.fixture(scope="module")
def mesh_dbs(cuda):
    from warpdb_tpu_torch.parallel import data_mesh

    tables = _join_tables()
    out = []
    for dev in ("cuda:0", "cpu"):
        db = WarpDB(tables["t"], mesh=data_mesh(devices=[dev] * 4))
        for name in ("dim", "multi"):
            db.register_table(name, tables[name])
        out.append(db)
    return out


MESH_QUERIES = [
    "SELECT g, COUNT(*), SUM(price) FROM t GROUP BY g ORDER BY g",
    "SELECT k, SUM(price) FROM t GROUP BY k ORDER BY k",
    "SELECT price FROM t ORDER BY price DESC LIMIT 7",
    "SELECT g, SUM(price * multi.wm) FROM t JOIN multi ON k = multi.km "
    "GROUP BY g ORDER BY g",
    "SELECT COUNT(multi.wm) FROM t LEFT JOIN multi ON k = multi.km",
    "SELECT SUM(price) OVER (PARTITION BY g) FROM t WHERE price > 50",
    "SELECT RANK() OVER (PARTITION BY g ORDER BY price) FROM t",
]


@pytest.mark.parametrize("q", MESH_QUERIES)
def test_mesh_on_card_matches_the_cpu_mesh(mesh_dbs, q):
    """The distributed routes on four shards of the card (K1 once a
    shard of a top-k, K3 once a shard of a join) against the same routes
    on four CPU shards; the shards all live on the card."""
    gpu, cpu = mesh_dbs
    assert all(s.device.type == "cuda" for s in gpu.table.shards)
    before = (topk_kernel.topk_candidates.launches,
              expand.windowed_expand.launches)
    got, want = gpu.query_sql_table(q), cpu.query_sql_table(q)
    torch.cuda.synchronize()
    if "LIMIT" in q:
        assert topk_kernel.topk_candidates.launches == before[0] + 4
    if "JOIN" in q:
        assert expand.windowed_expand.launches == before[1] + 4
    assert list(got) == list(want)
    for c in got:
        np.testing.assert_allclose(np.asarray(got[c], np.float64),
                                   np.asarray(want[c], np.float64),
                                   rtol=1e-6, equal_nan=True, err_msg=q)
