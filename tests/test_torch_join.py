"""Differential harness of the join slice: one seeded probe table and a
handful of build tables go through ``warpdb_tpu.WarpDB`` and
``warpdb_tpu_torch.WarpDB(device="cpu")``, and every query must give the
same answer.  Integers, codes, strings, counts and row order match
exactly; float values match to rtol 1e-5 (the packages add sums in
different orders).  Where the reference is at fault, the port is held
against NumPy and the reference's divergence is recorded.

The build tables select the join's paths: ``dim`` (unique keys, at most
256 rows: the reference's dense phase 1, lookup and semicompact
joins), ``uniq`` (unique keys matching every probe row, sort-merge
phase 1: the lookup join), ``dup`` (every key twice: the uniform
expansion, K4), ``multi`` (0-3 rows per key: the general expansion,
K3), and string, wide-int64, beyond-2^24 and composite keys; ``dd`` is
a small build side with duplicate keys (the reference's dense phase 1
into an expansion)."""

import numpy as np
import pytest

from warpdb_tpu import WarpDB as RefDB
from warpdb_tpu.config import get_config as ref_config
from warpdb_tpu.storage import HostTable as RefHostTable
from warpdb_tpu_torch import WarpDB as PortDB
from warpdb_tpu_torch.config import get_config as port_config
from warpdb_tpu_torch.errors import UnsupportedError
from warpdb_tpu_torch.storage import HostTable

N = 6000
WIDE = 2**53 + 1


def _tables(host_table=HostTable) -> dict:
    """The tables as ``host_table``s (the port's, or the reference's)."""
    rng = np.random.default_rng(77)
    nv = rng.uniform(0, 10, N).astype(np.float32)
    nv[::41] = np.nan
    t = {
        "k": rng.integers(0, 300, N).astype(np.float32),
        "ki": rng.integers(0, 500, N).astype(np.int32),
        "big": (2**24 + rng.integers(0, 50, N)).astype(np.int32),
        "g": rng.integers(0, 8, N).astype(np.float32),
        "price": rng.uniform(0, 100, N).astype(np.float32),
        "nv": nv,
        "s": rng.choice(["apple", "banana", "cherry", "date", "elder"], N),
        "wide": rng.choice(
            np.array([-(2**40), 7, 2**35 + 1, WIDE, 2**62], np.int64), N
        ),
    }
    n_dim = 230
    dim = {
        "k2": np.arange(120, 120 + n_dim).astype(np.float32),  # 300.. miss
        "w": rng.uniform(0, 1, n_dim).astype(np.float32),
        "name": np.array([f"n{i:03d}" for i in rng.permutation(n_dim)]),
        "s": rng.choice(["q", "r", "p"], n_dim),
    }
    uniq = {
        "uk": rng.permutation(300).astype(np.float32),
        "uw": rng.uniform(0, 1, 300).astype(np.float32),
    }
    dup = {
        "kd": np.tile(np.arange(300), 2).astype(np.float32),
        "w2": rng.uniform(0, 1, 600).astype(np.float32),
    }
    reps = rng.integers(0, 4, 520)  # keys 500.. never match
    multi = {
        "ki3": np.repeat(np.arange(520), reps).astype(np.int32),
        "wm": rng.uniform(0, 1, int(reps.sum())).astype(np.float32),
        "sm": rng.choice(["u", "v", "w", "x"], int(reps.sum())),
    }
    fr = {
        "fruit": np.array(["banana", "cherry", "fig", "apple", "kiwi",
                           "banana"]),
        "label": np.array(["B1", "C", "F", "A", "K", "B2"]),
        "fp": np.float32([1, 2, 3, 4, 5, 6]),
    }
    wd = {  # wide int64 keys: coded on the build side too
        "wk": np.array([7, 2**35 + 1, WIDE, 99, -(2**40), 2**33], np.int64),
        "wv": np.float32([0.5, 1.5, 2.5, 3.5, 4.5, 5.5]),
    }
    wr = {  # narrow int64: a raw int32 build key
        "rk": np.array([7, 8, 9, 7], np.int64),
        "rv": np.float32([10, 20, 30, 40]),
    }
    bigd = {
        "bk": (2**24 + np.arange(0, 60, 2)).astype(np.int32),
        "bw": rng.uniform(0, 1, 30).astype(np.float32),
    }
    comp = {
        "ck": rng.integers(0, 300, 900).astype(np.float32),
        "cg": rng.integers(0, 8, 900).astype(np.float32),
        "cw": rng.uniform(0, 1, 900).astype(np.float32),
    }
    tiny = {"tv": np.float32([10.0, 55.5, 99.0])}
    dd = {  # a small build side with duplicate keys and a miss
        "dk": np.float32([5, 5, 7, 300, 9, 9, 9]),
        "dv": np.float32([1, 2, 3, 4, 5, 6, 7]),
    }
    wf = {  # a float key against the probe's int64 vocabulary
        "fv": np.float32([7.0, 2.0**53, 2.0**35, 3.0]),
        "fw2": np.float32([1, 2, 3, 4]),
    }
    return {name: host_table.from_dict(cols) for name, cols in [
        ("t", t), ("dim", dim), ("uniq", uniq), ("dup", dup),
        ("multi", multi), ("fr", fr), ("wd", wd), ("wr", wr),
        ("bigd", bigd), ("comp", comp), ("tiny", tiny), ("wf", wf),
        ("dd", dd),
    ]}


@pytest.fixture(scope="module")
def tables():
    return _tables()


@pytest.fixture(scope="module")
def dbs(tables):
    ref_tables = _tables(RefHostTable)
    ref = RefDB(ref_tables["t"])
    port = PortDB(tables["t"], device="cpu")
    for name, host in tables.items():
        if name != "t":
            ref.register_table(name, ref_tables[name])
            port.register_table(name, host)
    return ref, port


def _same(ref, got, q):
    ref, got = list(ref), list(got)
    assert len(got) == len(ref), q
    if ref and isinstance(ref[0], (str, type(None))) or (
        got and isinstance(got[0], str)
    ):
        assert got == ref, q
        return
    r, g = np.asarray(ref), np.asarray(got)
    if r.dtype.kind in "iu" or g.dtype.kind in "iu":
        assert g.dtype.kind in "iu" and r.dtype.kind in "iu", q
        np.testing.assert_array_equal(g, r, err_msg=q)
        return
    np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, equal_nan=True,
                               err_msg=q)


JOIN_QUERIES = [
    # INNER: semicompact (reference: dense phase 1), lookup, uniform (K4), general (K3)
    "SELECT price FROM t JOIN dim ON k = dim.k2",
    "SELECT dim.w FROM t JOIN dim ON k = dim.k2",
    "SELECT uw FROM t JOIN uniq ON k = uniq.uk",
    "SELECT price FROM t JOIN dup ON k = dup.kd",
    "SELECT dup.w2 FROM t JOIN dup ON k = dup.kd",
    "SELECT price FROM t JOIN multi ON ki = multi.ki3",
    "SELECT multi.wm FROM t JOIN multi ON ki = multi.ki3",
    "SELECT SUM(price) FROM t JOIN multi ON ki = multi.ki3",
    "SELECT COUNT(DISTINCT multi.wm) FROM t JOIN multi ON ki = multi.ki3",
    # the reference's dense phase 1 with duplicate keys and misses
    "SELECT dd.dv FROM t JOIN dd ON k = dd.dk",
    "SELECT dd.dv FROM t LEFT JOIN dd ON k = dd.dk LIMIT 60",
    # LEFT: lookup with misses, expansion (K3) with NaN / -1 fill
    "SELECT dim.w FROM t LEFT JOIN dim ON k = dim.k2",
    "SELECT dim.name FROM t LEFT JOIN dim ON k = dim.k2 LIMIT 50",
    "SELECT multi.wm FROM t LEFT JOIN multi ON ki = multi.ki3",
    "SELECT COUNT(multi.wm) FROM t LEFT JOIN multi ON ki = multi.ki3",
    "SELECT SUM(price) FROM t LEFT JOIN multi ON ki = multi.ki3 "
    "GROUP BY g ORDER BY g ASC",
    "SELECT multi.sm FROM t LEFT JOIN multi ON ki = multi.ki3 LIMIT 40",
    # RIGHT / FULL: build misses appended in build order
    "SELECT price FROM t RIGHT JOIN dim ON k = dim.k2",
    "SELECT dim.w FROM t FULL JOIN dim ON k = dim.k2",
    "SELECT COUNT(price) FROM t RIGHT JOIN multi ON ki = multi.ki3",
    "SELECT multi.ki3 FROM t FULL JOIN multi ON ki = multi.ki3",
    # CROSS
    "SELECT COUNT(price) FROM t CROSS JOIN tiny",
    "SELECT price FROM t CROSS JOIN tiny LIMIT 20",
    "SELECT tiny.tv FROM t CROSS JOIN tiny LIMIT 20",
    # composite keys
    "SELECT price FROM t JOIN comp ON k = comp.ck AND g = comp.cg",
    "SELECT SUM(comp.cw) FROM t JOIN comp ON k = comp.ck AND g = comp.cg "
    "GROUP BY g",
    # string keys across independent vocabularies
    "SELECT price FROM t JOIN fr ON s = fr.fruit",
    "SELECT fr.label FROM t JOIN fr ON s = fr.fruit LIMIT 30",
    "SELECT s FROM t JOIN fr ON s = fr.fruit GROUP BY s",
    "SELECT fr.fp FROM t LEFT JOIN fr ON s = fr.fruit LIMIT 30",
    # wide int64 keys: both coded, probe coded / build raw, probe raw /
    # build coded
    "SELECT price FROM t JOIN wd ON wide = wd.wk",
    "SELECT wd.wv FROM t JOIN wd ON wide = wd.wk",
    "SELECT wide FROM t JOIN wd ON wide = wd.wk LIMIT 10",
    "SELECT price FROM t JOIN wr ON wide = wr.rk",
    "SELECT wr.rv FROM t JOIN wr ON wide = wr.rk",
    "SELECT wd.wv FROM t JOIN wd ON ki = wd.wk",
    # integer keys beyond 2^24 (f32 would merge neighbours)
    "SELECT price FROM t JOIN bigd ON big = bigd.bk",
    "SELECT COUNT(price) FROM t JOIN bigd ON big = bigd.bk",
    # self-joins and aliases
    "SELECT COUNT(price) FROM t a JOIN t b ON a.ki = b.ki",
    "SELECT b.price FROM t a JOIN t b ON a.big = b.big LIMIT 30",
    "SELECT a.price FROM t AS a JOIN dim AS d ON a.k = d.k2 LIMIT 40",
    "SELECT d.name FROM t a JOIN dim d ON a.k = d.k2 LIMIT 10",
    # implicit comma joins
    "SELECT price FROM t, dim WHERE k = dim.k2 AND price > 50",
    "SELECT COUNT(price) FROM t, tiny",
    "SELECT dim.w FROM t, dim, uniq WHERE k = dim.k2 AND k = uniq.uk "
    "AND uniq.uw < 0.5",
    # theta residual and pure inequality
    "SELECT price FROM t JOIN dim ON k = dim.k2 AND price < dim.w * 100",
    "SELECT COUNT(*) FROM t JOIN tiny ON price < tiny.tv",
    # ORDER BY / LIMIT after a join (top-k over the joined rows)
    "SELECT price FROM t JOIN dim ON k = dim.k2 ORDER BY price DESC LIMIT 5",
    "SELECT dim.w FROM t JOIN dim ON k = dim.k2 ORDER BY price ASC LIMIT 7",
    "SELECT DISTINCT g FROM t JOIN multi ON ki = multi.ki3",
    # a chain of joins
    "SELECT SUM(price) FROM t JOIN dim ON k = dim.k2 JOIN multi "
    "ON ki = multi.ki3 GROUP BY g ORDER BY g ASC",
    "SELECT dim.w FROM t JOIN dim ON k = dim.k2 LEFT JOIN fr "
    "ON s = fr.fruit LIMIT 30",
    # SELECT * over a join
    "SELECT * FROM t JOIN dim ON k = dim.k2 LIMIT 5",
    "SELECT dim.* FROM t JOIN dim ON k = dim.k2 LIMIT 5",
]

# Queries whose plan the pushdown and eager-rewrite settings change.
PLAN_QUERIES = [
    # probe pushdown
    "SELECT price FROM t JOIN dim ON k = dim.k2 WHERE price > 90",
    "SELECT multi.wm FROM t LEFT JOIN multi ON ki = multi.ki3 "
    "WHERE price < 20",
    # build pushdown, and both
    "SELECT price FROM t JOIN dim ON k = dim.k2 WHERE dim.w > 0.5",
    "SELECT SUM(price) FROM t JOIN multi ON ki = multi.ki3 "
    "WHERE multi.wm < 0.3 AND price < 40 GROUP BY g ORDER BY g ASC",
    "SELECT price FROM t JOIN dim ON k = dim.k2 WHERE "
    "(dim.w < 0.1 AND price > 50) OR (dim.w > 0.9 AND price < 10)",
    "SELECT fr.label FROM t JOIN fr ON s = fr.fruit WHERE fr.fp > 3 "
    "AND s != 'apple'",
    # the eager rewrite: SUM/AVG/MIN/MAX/COUNT through the join
    "SELECT SUM(price * dup.w2) FROM t JOIN dup ON k = dup.kd "
    "GROUP BY g ORDER BY g ASC",
    "SELECT AVG(price) FROM t JOIN dup ON k = dup.kd GROUP BY g",
    "SELECT MIN(dup.w2) FROM t JOIN dup ON k = dup.kd GROUP BY g",
    "SELECT MAX(price) FROM t JOIN dup ON k = dup.kd GROUP BY g",
    "SELECT COUNT(*) FROM t JOIN multi ON ki = multi.ki3 GROUP BY g",
    "SELECT SUM(price * multi.wm) FROM t JOIN multi ON ki = multi.ki3 "
    "GROUP BY g ORDER BY g ASC",
    "SELECT g, SUM(price) AS total FROM t JOIN dup ON k = dup.kd "
    "GROUP BY g ORDER BY total DESC",
    "SELECT g FROM t JOIN dim ON k = dim.k2 GROUP BY g "
    "HAVING AVG(dim.w) > 0.49 ORDER BY g ASC",
    "SELECT MAX(dim.name) FROM t JOIN dim ON k = dim.k2 GROUP BY g",
    "SELECT SUM(price) FROM t JOIN fr ON s = fr.fruit GROUP BY g "
    "ORDER BY g ASC",
]

PLANS = {
    "default": {},
    "no_pushdown": {"join_filter_pushdown": False},
    "no_eager": {"eager_join_aggregation": False},
    "no_memo": {"join_cache_entries": 0},
}


@pytest.fixture(params=sorted(PLANS))
def plan(request):
    saved = []
    for cfg in (ref_config(), port_config()):
        for key, val in PLANS[request.param].items():
            saved.append((cfg, key, getattr(cfg, key)))
            setattr(cfg, key, val)
    yield request.param
    for cfg, key, val in saved:
        setattr(cfg, key, val)


@pytest.mark.parametrize("q", JOIN_QUERIES)
def test_join_query(dbs, q):
    ref, port = dbs
    _same(ref.query_sql(q), port.query_sql(q), q)


@pytest.mark.parametrize("q", PLAN_QUERIES)
def test_join_plan_variants(dbs, plan, q):
    ref, port = dbs
    _same(ref.query_sql(q), port.query_sql(q), f"{q} [{plan}]")


def test_join_memo_repeats(dbs):
    """A repeated join is a memo hit on the probe table and gives the
    same answer; with the memo off nothing is kept."""
    _ref, port = dbs
    q = "SELECT multi.wm FROM t LEFT JOIN multi ON ki = multi.ki3"
    first = port.query_sql(q)
    memo = port.table._join_memo
    entries = len(memo)
    assert entries >= 1
    assert port.query_sql(q) == first or np.allclose(
        first, port.query_sql(q), equal_nan=True)
    assert len(memo) == entries
    cfg = port_config()
    saved, cfg.join_cache_entries = cfg.join_cache_entries, 0
    try:
        port.query_sql("SELECT dup.w2 FROM t JOIN dup ON k = dup.kd")
        assert len(memo) == entries
    finally:
        cfg.join_cache_entries = saved


def _kernel_calls(monkeypatch, *names):
    from warpdb_tpu_torch.ops import expand

    calls = []
    for name in names:
        plain = getattr(expand, f"{name}_plain")
        monkeypatch.setattr(
            expand, f"{name}_plain",
            lambda *a, _p=plain, _n=name, **kw: calls.append(_n) or _p(*a, **kw),
        )
    return calls


@pytest.mark.parametrize("q,kernel", [
    ("SELECT dup.w2 FROM t JOIN dup ON k = dup.kd", "uniform_expand"),
    ("SELECT multi.wm FROM t JOIN multi ON ki = multi.ki3", "windowed_expand"),
    ("SELECT multi.wm FROM t LEFT JOIN multi ON ki = multi.ki3",
     "windowed_expand"),
    ("SELECT dim.w FROM t JOIN dim ON k = dim.k2", "sorted_take"),
    ("SELECT COUNT(*) FROM t JOIN uniq ON k = uniq.uk WHERE price < 10",
     "sorted_take"),
])
def test_join_paths_reach_their_kernels(dbs, monkeypatch, q, kernel):
    """Each expansion and gather of the join path goes through its
    kernel's wrapper (the plain version here, on the CPU)."""
    _ref, port = dbs
    cfg = port_config()
    monkeypatch.setattr(cfg, "join_cache_entries", 0)
    calls = _kernel_calls(monkeypatch, "uniform_expand", "windowed_expand",
                          "sorted_take")
    port.query_sql(q)
    assert kernel in calls, calls


# --- reference faults: the port is held against NumPy ---------------------


def test_unqualified_build_string_column_decodes(dbs, tables):
    """The reference returns raw codes for an unqualified build-side
    string column; the port decodes it through the build table's
    vocabulary."""
    ref, port = dbs
    q = "SELECT name FROM t JOIN dim ON k = dim.k2"
    t, dim = tables["t"], tables["dim"]
    k = t.get_column("k").data
    k2 = dim.get_column("k2").data
    names = dim.get_column("name").data
    pos = {float(v): i for i, v in enumerate(k2)}
    want = [str(names[pos[float(v)]]) for v in k if float(v) in pos]
    assert port.query_sql(q) == want
    got_ref = ref.query_sql(q)
    assert got_ref == want or not isinstance(got_ref[0], str)


def test_qualified_build_string_column_shadowed_by_probe(dbs, tables):
    """``dim.s`` where the probe also has a string column ``s``: the
    reference decodes the build codes through the probe's vocabulary;
    the port through the build table's."""
    ref, port = dbs
    q = "SELECT dim.s FROM t JOIN dim ON k = dim.k2 LIMIT 25"
    t, dim = tables["t"], tables["dim"]
    pos = {float(v): i for i, v in enumerate(dim.get_column("k2").data)}
    ds = dim.get_column("s").data
    want = [str(ds[pos[float(v)]]) for v in t.get_column("k").data
            if float(v) in pos][:25]
    assert port.query_sql(q) == want
    assert ref.query_sql(q) != want  # the recorded reference fault


def test_float_key_against_int64_vocabulary_is_exact(dbs, tables):
    """A float build key joined with a wide-int64 probe key: the
    reference compares in f64, where 2^53 equals 2^53 + 1, and
    fabricates matches (ADVICE.md, medium).  The port compares integral
    values as int64."""
    ref, port = dbs
    q = "SELECT wf.fw2 FROM t JOIN wf ON wide = wf.fv"
    wide = tables["t"].get_column("wide").data
    fv = tables["wf"].get_column("fv").data.astype(np.float64)
    fw2 = tables["wf"].get_column("fw2").data
    want = []
    for v in wide:
        for j, f in enumerate(fv):
            if f == np.floor(f) and int(f) == int(v):
                want.append(float(fw2[j]))
    got = port.query_sql(q)
    _same(want, got, q)
    assert len(got) == int(np.count_nonzero(wide == 7))
    # Recorded divergence: the reference also matches 2^53 + 1 with 2^53.
    assert len(ref.query_sql(q)) in (len(want), len(want)
                                     + int(np.count_nonzero(wide == WIDE)))


def _key_counts(a, b):
    """Matches per row of ``a`` against the values of ``b``."""
    vals, cnt = np.unique(b, return_counts=True)
    pos = np.clip(np.searchsorted(vals, a), 0, len(vals) - 1)
    return np.where(vals[pos] == a, cnt[pos], 0)


COUNT_STAR = [
    ("SELECT COUNT(*) FROM t RIGHT JOIN multi ON ki = multi.ki3",
     lambda t, b: _key_counts(t["ki"], b["multi"]["ki3"]).sum()
     + (_key_counts(b["multi"]["ki3"], t["ki"]) == 0).sum()),
    ("SELECT COUNT(*) FROM t CROSS JOIN tiny", lambda t, b: N * 3),
    ("SELECT COUNT(*) FROM t, tiny", lambda t, b: N * 3),
    ("SELECT COUNT(*) FROM t JOIN bigd ON big = bigd.bk",
     lambda t, b: _key_counts(t["big"], b["bigd"]["bk"]).sum()),
    ("SELECT COUNT(*) FROM t a JOIN t b ON a.ki = b.ki",
     lambda t, b: _key_counts(t["ki"], t["ki"]).sum()),
]


@pytest.mark.parametrize("q,oracle", COUNT_STAR)
def test_count_star_over_join_against_numpy(dbs, tables, q, oracle):
    """COUNT(*) over a join that gathers no column: the reference's
    global aggregate finds no column to size its row mask and raises
    StopIteration; the port counts the joined rows."""
    ref, port = dbs
    cols = {name: {c.name: c.data for c in host.columns}
            for name, host in tables.items()}
    want = float(oracle(cols["t"], cols))
    assert port.query_sql(q) == [want]
    try:
        assert ref.query_sql(q) == [want]
    except StopIteration:
        pass  # the recorded reference fault


def test_join_unsupported_forms_raise(dbs):
    _ref, port = dbs
    for q, feature in [
        ("SELECT price FROM t LEFT JOIN dim ON k < dim.k2", "JOIN"),
        ("SELECT price FROM t JOIN dim ON k = dim.k2 "
         "QUALIFY ROW_NUMBER() OVER (ORDER BY price) <= 3", "QUALIFY"),
        ("SELECT SUM(price) OVER (PARTITION BY dim.s) FROM t JOIN dim "
         "ON k = dim.k2", "Window functions"),
    ]:
        with pytest.raises(UnsupportedError, match=feature):
            port.query_sql(q)
