"""Differential harness of the single-table slice: one seeded dict of
numpy columns becomes a HostTable of each package and goes through
``warpdb_tpu.WarpDB`` and ``warpdb_tpu_torch.WarpDB(device="cpu")``, and
every query must give the same answer.  Integers, codes,
strings, counts and row order match exactly; float values match to
rtol 1e-5 (the two packages add sums in different orders)."""

import numpy as np
import pytest

from warpdb_tpu import WarpDB as RefDB
from warpdb_tpu.storage import HostTable as RefHostTable
from warpdb_tpu_torch import WarpDB as PortDB
from warpdb_tpu_torch.errors import UnsupportedError, ValidationError
from warpdb_tpu_torch.storage import HostTable

N = 6000
WIDE = 9007199254740993  # 2^53 + 1


def _data() -> dict:
    rng = np.random.default_rng(2024)
    nv = rng.uniform(0, 10, N).astype(np.float32)
    nv[::53] = np.nan
    wide = rng.choice(
        np.array([-(2**40), 7, 2**35 + 1, WIDE, 2**62], np.int64), N
    )
    return {
        # bench.py's columns (k cut to 6000 slots: the midrange tier)
        "price": rng.uniform(0, 100, N).astype(np.float32),
        "quantity": rng.integers(0, 32, N).astype(np.float32),
        "k": rng.integers(0, 6000, N).astype(np.float32),
        # integer keys: dense, midrange (int) and one beyond 2^24
        "ki": rng.integers(0, 5000, N).astype(np.int32),
        "big": (2**24 + rng.integers(0, 9, N)).astype(np.int32),
        # non-integral float key: the sorted tier
        "fk": (rng.integers(0, 300, N) / 4).astype(np.float32),
        "nv": nv,
        "s": rng.choice(["apple", "banana", "cherry", "date"], N),
        "wide": wide,
    }


@pytest.fixture(scope="module")
def dbs():
    data = _data()
    return (RefDB(RefHostTable.from_dict(data)),
            PortDB(HostTable.from_dict(data), device="cpu"))


def _same(ref, got, q):
    ref, got = list(ref), list(got)
    assert len(got) == len(ref), q
    if ref and isinstance(ref[0], str):
        assert got == ref, q
        return
    r, g = np.asarray(ref), np.asarray(got)
    if r.dtype.kind in "iu" or g.dtype.kind in "iu":
        assert g.dtype.kind in "iu" and r.dtype.kind in "iu", q
        np.testing.assert_array_equal(g, r, err_msg=q)
        return
    np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, equal_nan=True,
                               err_msg=q)


EXPR_QUERIES = [
    # bench.py's EXPR_QUERIES
    "price * quantity",
    "price WHERE price > 15",
    "price * 0.9 WHERE price > 20",
    "price * quantity * 1.08",
    "discount(price, 0.9)",
    # more expressions and filters
    "price % 7 WHERE quantity >= 10 AND price < 50",
    "CASE WHEN price > 50 THEN 1 ELSE 0 END",
    "coalesce(nv, 0 - 1)",
    "ki * 2 WHERE big == 16777217",
    "price WHERE s = 'banana'",
    "price WHERE s LIKE 'b%' OR s > 'c'",
    "price WHERE price > 1000",
    "sqrt(price) + ln(quantity + 1)",
]

SQL_QUERIES = [
    # bench.py's SQL_QUERIES and the chip smoke's slice extras
    "SELECT SUM(price) FROM t GROUP BY quantity ORDER BY quantity ASC",
    "SELECT price FROM t ORDER BY price DESC LIMIT 5",
    "SELECT SUM(price) FROM t GROUP BY k",
    "SELECT quantity, COUNT(*) FROM t GROUP BY quantity HAVING SUM(price) > 1000",
    "SELECT DISTINCT quantity FROM t",
    "SELECT price FROM t WHERE price > 99.5",
    # ORDER BY with and without LIMIT / OFFSET
    "SELECT price FROM t ORDER BY price ASC LIMIT 7",
    "SELECT price FROM t ORDER BY price DESC LIMIT 5 OFFSET 3",
    "SELECT price FROM t WHERE quantity < 3 ORDER BY price ASC",
    "SELECT price FROM t ORDER BY price DESC",
    "SELECT quantity FROM t ORDER BY price DESC LIMIT 10",
    "SELECT price FROM t ORDER BY quantity DESC, price ASC LIMIT 20",
    "SELECT ki FROM t ORDER BY ki DESC LIMIT 9",
    "SELECT big FROM t WHERE big > 16777220 ORDER BY big ASC LIMIT 12",
    "SELECT nv FROM t ORDER BY nv DESC LIMIT 5",
    "SELECT nv FROM t ORDER BY nv ASC",
    "SELECT price FROM t LIMIT 4 OFFSET 10",
    "SELECT price * 2 AS p2 FROM t ORDER BY p2 DESC LIMIT 3",
    # GROUP BY tiers: dense, midrange K2, midrange scatter, sorted
    "SELECT SUM(price) FROM t GROUP BY quantity",
    "SELECT AVG(price) FROM t GROUP BY k",
    "SELECT COUNT(*) FROM t GROUP BY k",
    "SELECT MAX(price) FROM t GROUP BY k",
    "SELECT MIN(price) FROM t GROUP BY ki",
    "SELECT ki FROM t GROUP BY ki",
    "SELECT SUM(quantity) FROM t GROUP BY fk",
    "SELECT fk FROM t GROUP BY fk",
    "SELECT MIN(price) FROM t GROUP BY fk",
    "SELECT big FROM t GROUP BY big",
    "SELECT SUM(price) FROM t GROUP BY price",
    "SELECT COUNT(*) FROM t GROUP BY wide",
    "SELECT wide FROM t GROUP BY wide",
    # multi-key GROUP BY
    "SELECT COUNT(*) FROM t GROUP BY quantity, s",
    "SELECT SUM(price) FROM t GROUP BY s, quantity ORDER BY SUM(price) DESC LIMIT 5",
    "SELECT quantity FROM t GROUP BY s, quantity",
    "SELECT COUNT(*) FROM t GROUP BY fk, quantity",
    # HAVING, ORDER BY over aggregates, the device finish
    "SELECT k FROM t GROUP BY k HAVING COUNT(*) > 1 ORDER BY SUM(price) DESC LIMIT 10",
    "SELECT fk FROM t GROUP BY fk ORDER BY COUNT(*) DESC LIMIT 5",
    "SELECT k FROM t GROUP BY k ORDER BY SUM(nv) DESC LIMIT 6",
    "SELECT fk FROM t GROUP BY fk ORDER BY MAX(nv) DESC LIMIT 6",
    "SELECT fk FROM t GROUP BY fk HAVING MIN(price) < 5 ORDER BY MIN(price) ASC LIMIT 4",
    "SELECT quantity FROM t GROUP BY quantity ORDER BY AVG(price) DESC LIMIT 4",
    "SELECT quantity, SUM(price) AS total FROM t GROUP BY quantity ORDER BY total ASC",
    "SELECT SUM(price) / COUNT(*) FROM t GROUP BY quantity HAVING MAX(price) > 99",
    "SELECT quantity FROM t GROUP BY quantity LIMIT 3",
    "SELECT k FROM t WHERE price > 50 GROUP BY k LIMIT 5 OFFSET 2",
    "SELECT COUNT(DISTINCT quantity) FROM t GROUP BY s",
    "SELECT MEDIAN(price) FROM t GROUP BY s",
    "SELECT PERCENTILE(price, 0.9) FROM t GROUP BY quantity",
    "SELECT COUNT(nv) FROM t GROUP BY quantity",
    "SELECT SUM(nv) FROM t GROUP BY quantity",
    "SELECT DISTINCT SUM(price) FROM t GROUP BY quantity",
    # DISTINCT
    "SELECT DISTINCT s FROM t",
    "SELECT DISTINCT fk FROM t ORDER BY fk DESC LIMIT 5",
    "SELECT DISTINCT quantity FROM t WHERE price < 10 ORDER BY quantity DESC",
    "SELECT DISTINCT wide FROM t",
    # global aggregates
    "SELECT SUM(price) FROM t",
    "SELECT AVG(price) FROM t WHERE quantity > 20",
    "SELECT MIN(price) FROM t",
    "SELECT MAX(ki) FROM t",
    "SELECT COUNT(*) FROM t WHERE s = 'cherry'",
    "SELECT COUNT(nv) FROM t",
    "SELECT COUNT(DISTINCT quantity) FROM t",
    "SELECT MEDIAN(price) FROM t",
    "SELECT SUM(price) / COUNT(*) FROM t",
    "SELECT MAX(s) FROM t",
    # strings and wide int64 as dictionary codes
    "SELECT s FROM t WHERE s = 'banana' LIMIT 6",
    "SELECT s FROM t ORDER BY s DESC LIMIT 4",
    "SELECT COUNT(*) FROM t WHERE s LIKE '%an%'",
    "SELECT UPPER(s) FROM t LIMIT 5",
    "SELECT wide FROM t WHERE wide > 7 ORDER BY wide ASC LIMIT 5",
    "SELECT COUNT(*) FROM t WHERE wide = 34359738369",
    "SELECT * FROM t LIMIT 3",
]


@pytest.mark.parametrize("q", EXPR_QUERIES)
def test_expression_query(dbs, q):
    ref, port = dbs
    _same(ref.query(q), port.query(q), q)


@pytest.mark.parametrize("q", SQL_QUERIES)
def test_sql_query(dbs, q):
    ref, port = dbs
    _same(ref.query_sql(q), port.query_sql(q), q)


# Queries of the verify recipe (data/test.csv).
CSV_QUERIES = [
    ("expr", "price * quantity WHERE price > 15"),
    ("expr", "price * quantity"),
    ("sql", "SELECT SUM(price) FROM test GROUP BY quantity"),
    ("sql", "SELECT quantity AS q, SUM(price) AS s FROM test GROUP BY quantity"),
    ("sql", "SELECT price FROM test ORDER BY price DESC LIMIT 2"),
    ("sql", "SELECT AVG(price) FROM test WHERE quantity > 2"),
]


@pytest.mark.parametrize("kind,q", CSV_QUERIES)
def test_csv_query(kind, q):
    ref, port = RefDB("data/test.csv"), PortDB("data/test.csv", device="cpu")
    run = (lambda db: db.query(q)) if kind == "expr" else (
        lambda db: db.query_sql(q))
    _same(run(ref), run(port), q)


def test_wide_int64_literal_is_exact(dbs):
    """The reference binds wide-int64 literals through an f64 fold that
    is lossy beyond 2^53 (ADVICE.md, high): ``wide = 2^53`` matches the
    stored 2^53 + 1 there.  The port binds the literal exactly."""
    ref, port = dbs
    q = "SELECT COUNT(*) FROM t WHERE wide = 9007199254740992"
    truth = 0.0
    assert port.query_sql(q) == [truth]
    stored = float(np.count_nonzero(_data()["wide"] == WIDE))
    # Recorded divergence: the reference answers with the count of 2^53+1.
    assert ref.query_sql(q)[0] in (truth, stored)
    q2 = f"SELECT COUNT(*) FROM t WHERE wide = {WIDE}"
    assert port.query_sql(q2) == [stored]


def _distinct_oracle(col, where=None, descending=False):
    t = _data()
    v = t[col]
    if where is not None:
        v = v[where(t)]
    out = np.unique(v)
    return out[::-1] if descending else out


# SELECT DISTINCT over a midrange key (4097..65536 slots) raises
# AttributeError in the reference (group_exec.py:914 reads
# query.group_by, which DISTINCT does not set).  The port answers; the
# oracle is NumPy, and the reference's fault is recorded.
MIDRANGE_DISTINCT = [
    ("SELECT DISTINCT k FROM t WHERE price < 10",
     lambda: _distinct_oracle(
         "k", lambda t: t["price"] < np.float32(10))),
    ("SELECT DISTINCT ki FROM t ORDER BY ki DESC",
     lambda: _distinct_oracle("ki", descending=True)),
]


@pytest.mark.parametrize("q,oracle", MIDRANGE_DISTINCT)
def test_midrange_distinct_against_numpy(dbs, q, oracle):
    ref, port = dbs
    got = port.query_sql(q)
    _same(oracle().tolist(), got, q)
    try:
        ref_out = ref.query_sql(q)
    except AttributeError:
        return  # the recorded reference fault
    _same(ref_out, got, q)


def test_midrange_inf_values_match_reference():
    """The reference routes ±inf values to its scatter engine (the TPU
    kernel's one-hot product would turn 0·inf into NaN); the port's K2
    needs no such gate and must give the same answer."""
    rng = np.random.default_rng(5)
    n = 20_000
    k = rng.integers(0, 30_000, n).astype(np.float32)
    v = rng.uniform(0, 10, n).astype(np.float32)
    v[7] = np.inf
    v[11] = -np.inf
    data = {"k": k, "v": v}
    q = "SELECT SUM(v) FROM t GROUP BY k"
    _same(RefDB(RefHostTable.from_dict(data)).query_sql(q),
          PortDB(HostTable.from_dict(data), device="cpu").query_sql(q), q)


# Windows, QUALIFY, grouping sets, STRING_AGG, APPROX_COUNT_DISTINCT and
# DDL answer now: their former refusals are differential cases in
# test_torch_window.py, test_torch_hll.py and test_torch_surfaces.py.
UNSUPPORTED = [
    ("SELECT a.price FROM t a LEFT JOIN t b ON a.ki < b.ki", "JOIN"),
]


@pytest.mark.parametrize("q,feature", UNSUPPORTED)
def test_outside_the_slice_raises(dbs, q, feature):
    _ref, port = dbs
    with pytest.raises(UnsupportedError, match=feature):
        port.query_sql(q)


def test_join_against_registered_table_raises():
    """An equi-join against a registered table answers; a join the port
    does not run (a non-equality outer ON) raises, as does an unknown
    table."""
    port = PortDB("data/test.csv", device="cpu")
    port.register_table("other", HostTable.from_dict(
        {"quantity": np.array([3, 4], np.float32)}
    ))
    assert port.query_sql("SELECT quantity FROM other") == [3.0, 4.0]
    assert port.query_sql(
        "SELECT price FROM test JOIN other ON test.quantity = other.quantity"
    ) == [10.5, 20.0]
    with pytest.raises(UnsupportedError, match="JOIN"):
        port.query_sql(
            "SELECT price FROM test LEFT JOIN other "
            "ON test.quantity < other.quantity"
        )
    with pytest.raises(ValidationError, match="Unknown table"):
        port.query_sql("SELECT price FROM nowhere")


def test_other_entry_points_raise():
    """The entry points that raised before the multi-device slice now run:
    ``query_sharded`` and the stream with a CPU mesh, each held against
    the reference's run on its 8-device mesh (nothing raises)."""
    from warpdb_tpu.parallel import data_mesh as ref_data_mesh
    from warpdb_tpu_torch.parallel import data_mesh

    mesh, ref_mesh = data_mesh(devices=["cpu"] * 8), ref_data_mesh()
    port = PortDB("data/test.csv", device="cpu")
    ref = RefDB("data/test.csv")
    assert port.query_sharded("price", mesh=mesh) == ref.query_sharded(
        "price", mesh=ref_mesh) == [10.5, 20.0, 15.25, 30.0]
    sql = "SELECT price FROM t"
    got = PortDB.query_streaming_sql("data/test.csv", sql, mesh=mesh,
                                     rows_per_chunk=3)
    assert got == RefDB.query_streaming_sql("data/test.csv", sql,
                                            mesh=ref_mesh, rows_per_chunk=3)


def test_kernels_reached_by_the_main_path(dbs):
    """ORDER BY … LIMIT reaches K1 and a SUM GROUP BY over 4097..65536
    slots reaches K2 (their plain versions here, on the CPU)."""
    from warpdb_tpu_torch.ops import group_kernel, topk_kernel

    _ref, port = dbs
    t0 = topk_kernel.topk_candidates_plain
    g0 = group_kernel.group_counts_sums_plain
    calls = []
    try:
        topk_kernel.topk_candidates_plain = lambda *a: calls.append("k1") or t0(*a)
        group_kernel.group_counts_sums_plain = (
            lambda *a: calls.append("k2") or g0(*a)
        )
        port.query_sql("SELECT price FROM t ORDER BY price DESC LIMIT 5")
        port.query_sql("SELECT SUM(price) FROM t GROUP BY k")
    finally:
        topk_kernel.topk_candidates_plain = t0
        group_kernel.group_counts_sums_plain = g0
    assert calls == ["k1", "k2"]
