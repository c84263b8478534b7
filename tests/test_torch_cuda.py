"""warpdb_tpu_torch on a CUDA card: each kernel against its plain
version, and the slice on the card against the same slice on the CPU.

Every test here needs a card and skips without one.  This file imports
no JAX (the card's machine has none), so it runs there without the
repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

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


@pytest.mark.parametrize("k", [16, 64, 128])
@pytest.mark.parametrize("case", ["random", "ascending", "duplicates"])
@pytest.mark.parametrize("n", [1 << 22, (1 << 22) - 37, 1000])
def test_topk_kernel_matches_plain(cuda, case, k, n):
    xd = torch.from_numpy(_topk_input(case, n)).to(cuda)
    before = topk_kernel.topk_candidates.launches
    got = torch.topk(topk_kernel.topk_candidates(xd, k).reshape(-1), k).values
    want = topk_kernel.topk_candidates_plain(xd, k).reshape(-1)
    torch.cuda.synchronize()
    assert topk_kernel.topk_candidates.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("nv", [0, 1, 5])
@pytest.mark.parametrize("num_slots", [6000, 65536])
def test_group_kernel_matches_plain(cuda, num_slots, nv):
    rng = np.random.default_rng(33)
    n = 1 << 20
    gid = rng.integers(0, num_slots, n).astype(np.int32)
    gid[::17] = num_slots
    gid[5::29] = -3
    gd = torch.from_numpy(gid).to(cuda)
    vd = [torch.from_numpy(rng.uniform(0, 100, n).astype(np.float32)).to(cuda)
          for _ in range(nv)]
    before = group_kernel.group_counts_sums.launches
    c, s = group_kernel.group_counts_sums(gd, vd, num_slots)
    cp, sp = group_kernel.group_counts_sums_plain(gd, vd, num_slots)
    torch.cuda.synchronize()
    assert group_kernel.group_counts_sums.launches > before
    assert torch.equal(c, cp)
    for a, b in zip(s, sp):
        # Atomic f32 adds in a run-dependent order.
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)


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
