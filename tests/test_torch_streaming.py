"""The out-of-core stream (``warpdb_tpu_torch.parallel.streaming``)
against the reference's.

Each file is written by the test from a seeded NumPy generator; the same
statement streams through ``warpdb_tpu.WarpDB.query_streaming_*`` (one
device: ``mesh=data_mesh(1)``, since the default mesh would shard each
chunk over the eight CPU devices) and through the port with
``device="cpu"``, with small ``rows_per_chunk`` so that every statement
merges many chunks.  Column names, values, counts, codes, decoded strings
and row order agree exactly; float sums and averages within rtol 1e-5,
atol 1e-6 (NaN equal to NaN), and a row's deviation from its partition's
average (``v - AVG(v) OVER …``) within that average's rtol times the
largest |v| (atol 1e-5 · 100); errors are of the reference's class.  The
cases mirror the reference's streaming tests (``tests/test_parallel.py``,
``tests/test_streaming_windows.py``, ``tests/test_engine.py``,
``tests/test_strings.py``, ``tests/test_int_exact.py``).  Where the
reference is at fault (wide int64 keys merged across chunks), the test
holds the port to the in-memory answer and records the reference's."""

import json

import numpy as np
import pytest

from warpdb_tpu import DataType as RefDataType
from warpdb_tpu import WarpDB as RefDB
from warpdb_tpu import errors as ref_errors
from warpdb_tpu.parallel import data_mesh
from warpdb_tpu.storage import HostTable as RefHostTable
from warpdb_tpu_torch import WarpDB as PortDB
from warpdb_tpu_torch import errors
from warpdb_tpu_torch.parallel import last_stream_stats
from warpdb_tpu_torch.storage import DataType, HostTable

RTOL, ATOL = 1e-5, 1e-6


def _write_csv(path, cols: dict, fmt: dict = None) -> str:
    names = list(cols)
    fmt = fmt or {}
    n = len(next(iter(cols.values())))
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for i in range(n):
            f.write(",".join(fmt.get(k, "{}").format(cols[k][i])
                             for k in names) + "\n")
    return str(path)


def _schemas(schema):
    if schema is None:
        return None, None
    return ([getattr(RefDataType, t) for t in schema],
            [getattr(DataType, t) for t in schema])


def _dims(dims):
    if dims is None:
        return None, None
    ref = {k: RefHostTable.from_dict(v, dtypes=_dtypes(v, RefDataType))
           for k, v in dims.items()}
    port = {k: HostTable.from_dict(v, dtypes=_dtypes(v, DataType))
            for k, v in dims.items()}
    return ref, port


def _dtypes(cols: dict, dtype_enum):
    return {k: dtype_enum.STRING for k, v in cols.items()
            if np.asarray(v).dtype.kind in "OU"} or None


def _is_approx(name: str, approx) -> bool:
    if approx is not None:
        return name in approx
    return "SUM" in name.upper() or "AVG" in name.upper()


def _same(got: dict, want: dict, approx=None, what="",
          atol: float = ATOL) -> None:
    assert list(got) == list(want), what
    for name in want:
        g, w = list(got[name]), list(want[name])
        assert len(g) == len(w), f"{what} [{name}]"
        if any(isinstance(x, str) for x in w + g):
            assert g == w, f"{what} [{name}]"
            continue
        ga = np.asarray(g, np.float64)
        wa = np.asarray(w, np.float64)
        if _is_approx(name, approx):
            np.testing.assert_allclose(ga, wa, rtol=RTOL, atol=atol,
                                       equal_nan=True,
                                       err_msg=f"{what} [{name}]")
        else:
            np.testing.assert_array_equal(ga, wa, err_msg=f"{what} [{name}]")


def _sql_both(path, sql, rows_per_chunk, schema=None, dims=None) -> tuple:
    ref_schema, port_schema = _schemas(schema)
    ref_dims, port_dims = _dims(dims)
    want = RefDB.query_streaming_sql(str(path), sql, rows_per_chunk,
                                     mesh=data_mesh(1), dims=ref_dims,
                                     schema=ref_schema)
    got = PortDB.query_streaming_sql(str(path), sql, rows_per_chunk,
                                     dims=port_dims, schema=port_schema,
                                     device="cpu")
    return got, want


def _check_sql(path, sql, rows_per_chunk, schema=None, dims=None,
               approx=None, atol: float = ATOL) -> dict:
    got, want = _sql_both(path, sql, rows_per_chunk, schema, dims)
    _same(got, want, approx, sql, atol)
    return got


def _check_raises(path, sql, rows_per_chunk, exc: str, match: str,
                  schema=None, dims=None, expr=False) -> None:
    ref_schema, port_schema = _schemas(schema)
    ref_dims, port_dims = _dims(dims)
    with pytest.raises(getattr(errors, exc), match=match) as got:
        if expr:
            PortDB.query_streaming_csv(str(path), sql, rows_per_chunk,
                                       device="cpu")
        else:
            PortDB.query_streaming_sql(str(path), sql, rows_per_chunk,
                                       dims=port_dims, schema=port_schema,
                                       device="cpu")
    with pytest.raises(getattr(ref_errors, exc), match=match) as want:
        if expr:
            RefDB.query_streaming_csv(str(path), sql, rows_per_chunk,
                                      mesh=data_mesh(1))
        else:
            RefDB.query_streaming_sql(str(path), sql, rows_per_chunk,
                                      mesh=data_mesh(1), dims=ref_dims,
                                      schema=ref_schema)
    assert str(got.value) == str(want.value)


def _check_expr(path, expr, rows_per_chunk) -> list:
    want = RefDB.query_streaming_csv(str(path), expr, rows_per_chunk,
                                     mesh=data_mesh(1))
    got = PortDB.query_streaming_csv(str(path), expr, rows_per_chunk,
                                     device="cpu")
    assert isinstance(got, list)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    return got


# --- expressions (test_parallel.py:86, :103; test_strings.py:362) --------


def test_streaming_csv_matches_reference(tmp_path):
    rows = 50_000
    i = np.arange(rows)
    path = _write_csv(tmp_path / "big.csv",
                      {"price": (i % 97) + 0.25, "quantity": i % 11})
    got = _check_expr(path, "price * quantity", 12_000)
    assert len(got) == rows
    want = ((i % 97) + 0.25).astype(np.float32) * (i % 11).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)
    _check_expr(path, "price * quantity WHERE price > 50.25", 12_000)
    assert last_stream_stats().chunks == 5


def test_streaming_preserves_row_order(tmp_path):
    n = 5000
    path = _write_csv(tmp_path / "ordered.csv", {"x": np.arange(n)})
    got = _check_expr(path, "x + 0", 777)
    np.testing.assert_array_equal(got, np.arange(n, dtype=np.float32))


def test_streaming_expression_rejects_strings(tmp_path):
    path = tmp_path / "s.ndjson"
    path.write_text('{"cat": "zebra", "v": 1.0}\n{"cat": "apple", "v": 2.0}\n')
    _check_raises(path, "cat", 1, "WarpDBError", "string columns", expr=True)


def test_streaming_expression_errors(tmp_path):
    path = _write_csv(tmp_path / "e.csv", {"a": [1, 2]})
    _check_raises(path, "", 1, "WarpDBError", "Empty", expr=True)
    _check_raises(path, "b * 2", 1, "ValidationError", "Unknown column",
                  expr=True)
    _check_raises(path, "a * (2", 1, "ParseError", "parse", expr=True)


# --- grouped and global aggregates ----------------------------------------


def test_streaming_sql_grouped(tmp_path):
    rng = np.random.default_rng(17)
    n = 50_000
    q = rng.integers(0, 12, n)
    price = rng.uniform(0, 100, n)
    path = _write_csv(tmp_path / "big.csv", {"price": price, "quantity": q},
                      {"price": "{:.4f}"})
    _check_sql(
        path,
        "SELECT quantity, SUM(price) AS s, COUNT(*) AS n, MIN(price) AS lo, "
        "MAX(price) AS hi, AVG(price) AS mean_p FROM t "
        "WHERE price > 10 GROUP BY quantity ORDER BY quantity ASC",
        7_000, approx={"s", "mean_p"},
    )
    assert last_stream_stats().chunks == 8


def test_streaming_sql_global_and_having(tmp_path):
    rng = np.random.default_rng(18)
    n = 20_000
    q = rng.integers(0, 6, n)
    price = rng.uniform(0, 10, n)
    path = _write_csv(tmp_path / "g.csv", {"price": price, "quantity": q},
                      {"price": "{:.3f}"})
    _check_sql(path, "SELECT COUNT(*) AS n, SUM(price) AS s FROM t", 3_000,
               approx={"s"})
    _check_sql(path, "SELECT quantity FROM t GROUP BY quantity "
               "HAVING COUNT(*) > 3500 ORDER BY quantity ASC", 3_000)
    # HAVING and ORDER BY … LIMIT decide on the merged totals only.
    _check_sql(path, "SELECT quantity, SUM(price) FROM t GROUP BY quantity "
               "HAVING SUM(price) > 16500 ORDER BY SUM(price) DESC LIMIT 2",
               3_000)


def test_streaming_sql_midrange_group_reaches_k2(tmp_path, monkeypatch):
    """GROUP BY over 4097..65536 slots takes K2 (its plain version here)
    once a chunk; the merge of its partials matches the reference."""
    from warpdb_tpu_torch.ops import group_kernel

    rng = np.random.default_rng(19)
    n = 6_000
    path = _write_csv(tmp_path / "k.csv",
                      {"k": rng.integers(0, 6000, n),
                       "v": rng.integers(0, 10_000, n) / 100},
                      {"v": "{:.2f}"})
    plain = group_kernel.group_counts_sums_plain
    calls = []
    monkeypatch.setattr(group_kernel, "group_counts_sums_plain",
                        lambda *a: calls.append(1) or plain(*a))
    _check_sql(path, "SELECT k, SUM(v) AS s, COUNT(*) AS n FROM t "
               "GROUP BY k", 997, approx={"s"})
    assert len(calls) == last_stream_stats().chunks == 7
    # ORDER BY an aggregate … LIMIT decides on the merged sums: a chunk
    # keeps all its groups (no device finish on a partial).
    _check_sql(path, "SELECT k, SUM(v) AS s FROM t GROUP BY k "
               "ORDER BY SUM(v) DESC LIMIT 3", 997, approx={"s"})


def test_streaming_sql_empty_global_matches_inmemory(tmp_path):
    path = tmp_path / "e.csv"
    path.write_text("price,quantity\n1,2\n3,4\n")
    got = _check_sql(path, "SELECT COUNT(*) AS n, SUM(price) AS s, "
                     "MIN(price) AS lo FROM t WHERE price > 99", 1)
    assert got["n"] == [0.0] and got["s"] == [0.0]
    assert got["lo"] == [float("inf")]


def test_streaming_sql_string_group(tmp_path):
    rng = np.random.default_rng(33)
    cats = ["zebra", "apple", "mango", "kiwi"]
    n = 4000
    path = _write_csv(tmp_path / "s.csv",
                      {"price": rng.uniform(0, 10, n),
                       "cat": rng.choice(cats, n)}, {"price": "{:.3f}"})
    got = _check_sql(
        path,
        "SELECT cat, SUM(price) AS s, COUNT(*) AS n FROM t "
        "WHERE cat != 'kiwi' GROUP BY cat ORDER BY cat ASC",
        700, schema=["FLOAT32", "STRING"], approx={"s"},
    )
    assert got["cat"] == ["apple", "mango", "zebra"]
    # Every chunk encodes against one vocabulary read in a pre-pass.
    assert last_stream_stats().prepass_chunks == 6


def test_streaming_sql_parquet(tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.default_rng(23)
    n = 20_000
    q = rng.integers(0, 8, n).astype(np.float32)
    price = rng.uniform(0, 10, n).astype(np.float32)
    path = tmp_path / "t.parquet"
    pq.write_table(pa.table({"price": price, "quantity": q}), path,
                   row_group_size=4096)
    _check_sql(path, "SELECT quantity, SUM(price) AS s FROM t "
               "GROUP BY quantity ORDER BY quantity ASC", 3_000,
               approx={"s"})


def test_streaming_sql_ndjson(tmp_path):
    rng = np.random.default_rng(24)
    n = 900
    recs = [{"g": int(a), "v": float(b), "s": str(c)} for a, b, c in zip(
        rng.integers(0, 5, n), rng.uniform(0, 9, n).round(2),
        rng.choice(["x", "y", "zz"], n))]
    path = tmp_path / "t.ndjson"
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    _check_sql(path, "SELECT g, s, SUM(v) AS t, COUNT(*) AS n FROM t "
               "GROUP BY g, s", 101, approx={"t"})
    _check_sql(path, "SELECT s, v FROM t WHERE v > 8.5 ORDER BY v DESC, "
               "s ASC LIMIT 9", 101)


def test_streaming_sql_count_distinct(tmp_path):
    rng = np.random.default_rng(21)
    n = 500
    path = _write_csv(tmp_path / "cd.csv",
                      {"k": rng.integers(0, 5, n),
                       "v": rng.integers(0, 9, n).astype(np.float32)})
    _check_sql(path, "SELECT k, COUNT(DISTINCT v) FROM t GROUP BY k", 37)
    _check_sql(path, "SELECT COUNT(DISTINCT v) FROM t", 41)


def test_streaming_sql_approx_count_distinct(tmp_path):
    rng = np.random.default_rng(23)
    n = 30_000
    k = rng.integers(0, 3, n)
    v = rng.integers(0, 6_000, n)
    path = _write_csv(tmp_path / "hll.csv", {"k": k, "v": v})
    sql = ("SELECT k, APPROX_COUNT_DISTINCT(v) AS a FROM t "
           "GROUP BY k ORDER BY k ASC")
    got = _check_sql(path, sql, 4_096, approx={"a"})
    # The merged registers are the whole file's: the estimate equals the
    # in-memory one.
    mem = PortDB(HostTable.from_dict(
        {"k": k.astype(np.float32), "v": v.astype(np.float32)}),
        device="cpu").query_sql_table(sql)
    np.testing.assert_allclose(got["a"], mem["a"], rtol=RTOL)
    _check_sql(path, "SELECT APPROX_COUNT_DISTINCT(v) FROM t", 4_096,
               approx={"APPROX_COUNT_DISTINCT(v[idx])"})


def test_streaming_approx_count_distinct_group_gate(tmp_path):
    n = 3000
    path = _write_csv(tmp_path / "many_groups.csv",
                      {"k": np.arange(n), "v": np.arange(n) % 7})
    _check_raises(path, "SELECT k, APPROX_COUNT_DISTINCT(v) FROM t "
                  "GROUP BY k", 3000, "UnsupportedError", "COUNT\\(DISTINCT")


def test_streaming_sql_distinct(tmp_path):
    rng = np.random.default_rng(22)
    path = _write_csv(tmp_path / "d.csv",
                      {"x": rng.integers(0, 12, 300).astype(np.float32)})
    _check_sql(path, "SELECT DISTINCT x FROM t", 23)
    _check_sql(path, "SELECT DISTINCT x FROM t ORDER BY x DESC LIMIT 4", 23)


def test_streaming_sql_distinct_multi_column(tmp_path):
    rng = np.random.default_rng(23)
    path = _write_csv(tmp_path / "d2.csv",
                      {"a": rng.integers(0, 9, 400).astype(np.float32),
                       "b": rng.integers(0, 6, 400).astype(np.float32)})
    _check_sql(path, "SELECT DISTINCT a, b FROM t", 37)


def test_streaming_sql_matches_inmemory_on_multichunk(tmp_path):
    rng = np.random.default_rng(23)
    n = 700
    k = rng.integers(0, 7, n)
    v = rng.uniform(0, 50, n).astype(np.float32)
    path = _write_csv(tmp_path / "m.csv", {"k": k, "v": v})
    sql = ("SELECT k, SUM(v), MIN(v), MAX(v), COUNT(DISTINCT v) FROM t "
           "GROUP BY k HAVING COUNT(v) > 10 ORDER BY k ASC")
    got = _check_sql(path, sql, 61)
    mem = PortDB(HostTable.from_dict({"k": k.astype(np.float32), "v": v}),
                 device="cpu").query_sql_table(sql)
    _same(got, mem, what=sql)


def test_streaming_group_by_exact_int_keys(tmp_path):
    keys = np.array([16777215, 16777216, 16777217, 16777218, -16777217,
                     -16777216, 2147483646, 2147483647, -2147483648, 0, 1],
                    np.int32)
    path = _write_csv(tmp_path / "wide.csv",
                      {"k": np.tile(keys, 9), "v": np.ones(99, np.float32)})
    got = _check_sql(path, "SELECT k, COUNT(*) AS n FROM t GROUP BY k", 13,
                     schema=["INT32", "FLOAT32"])
    np.testing.assert_array_equal(np.sort(np.asarray(got["k"], np.int64)),
                                  np.sort(keys.astype(np.int64)))
    assert got["n"] == [9.0] * len(keys)


def test_streaming_wide_int64_keys_merge_across_chunks(tmp_path):
    """Wide int64 keys encode against one int64 vocabulary for the whole
    stream: the port gives the in-memory answer.  The reference encodes
    each chunk against a vocabulary of its own and merges the codes: two
    groups, keys that are codes, 2^40+5 fused with 2^40+1 (ROADMAP queue
    3)."""
    a, b, c = 2**40 + 5, 2**40 + 9, 2**40 + 1
    path = tmp_path / "w.csv"
    path.write_text(f"k,v\n{a},1\n{b},2\n{a},3\n{b},40\n{c},16\n{c},4\n")
    sql = "SELECT k, SUM(v) FROM w GROUP BY k"
    got, want = _sql_both(path, sql, 3, schema=["INT64", "FLOAT32"])
    # The keys are wide in the first chunk: one pre-pass over the stream.
    st = last_stream_stats()
    assert (st.chunks, st.prepass_chunks) == (2, 2)
    mem = PortDB(str(path), schema=[DataType.INT64, DataType.FLOAT32],
                 device="cpu").query_sql_table(sql)
    assert got == mem == {"k": [c, a, b], "SUM(v[idx])": [20.0, 4.0, 42.0]}
    assert want == {"k": [0, 1], "SUM(v[idx])": [24.0, 42.0]}  # the fault
    ref_mem = RefDB(str(path), schema=[RefDataType.INT64,
                                       RefDataType.FLOAT32]).query_sql_table(sql)
    assert ref_mem == mem
    # Literals bind to the shared vocabulary, and the key decodes.
    assert PortDB.query_streaming_sql(
        str(path), f"SELECT k, COUNT(*) AS n FROM w WHERE k > {c} "
        "GROUP BY k", 3, schema=[DataType.INT64, DataType.FLOAT32],
        device="cpu") == {"k": [a, b], "n": [2.0, 2.0]}
    # A chunk whose values stay inside int32 encodes against the stream's
    # vocabulary too.
    path2 = tmp_path / "w2.csv"
    path2.write_text(f"k,v\n7,1\n7,2\n{a},3\n")
    assert PortDB.query_streaming_sql(
        str(path2), "SELECT k, SUM(v) AS s FROM t GROUP BY k", 2,
        schema=[DataType.INT64, DataType.FLOAT32], device="cpu",
    ) == {"k": [7, a], "s": [3.0, 3.0]}
    # The wide chunk comes second: the first pass stops there and the
    # stream runs again behind a pre-pass (the first chunk for the schema,
    # the two of the stopped pass and the two of the pre-pass).
    st = last_stream_stats()
    assert (st.chunks, st.prepass_chunks) == (2, 5)


def _wide_int64_file(tmp_path, base: int, spread: int, n: int = 1200,
                     seed: int = 41) -> tuple:
    rng = np.random.default_rng(seed)
    k = base + rng.integers(0, spread, n)
    v = rng.integers(0, 1000, n)
    path = _write_csv(tmp_path / f"w{base}.csv", {"k": k, "v": v})
    return path, k, v


# Keys 2^40 + [0, 4096) share one f32; keys 2^60 + [0, 40) share one f64.
WIDE_BASES = [(2**40, 4096), (2**60, 40)]


@pytest.mark.parametrize("base,spread", WIDE_BASES)
def test_streaming_wide_int64_order_by_limit(tmp_path, base, spread):
    """The running top-k ranks int64 keys by their values (f32 ranks would
    keep the first chunks' rows): the in-memory answer."""
    path, k, v = _wide_int64_file(tmp_path, base, spread)
    sch = [DataType.INT64, DataType.FLOAT32]
    mem = PortDB(path, schema=sch, device="cpu")
    for sql in ["SELECT k, v FROM t ORDER BY k DESC, v DESC LIMIT 9",
                "SELECT k FROM t ORDER BY k ASC LIMIT 5 OFFSET 3"]:
        got = PortDB.query_streaming_sql(path, sql, 97, schema=sch,
                                         device="cpu")
        assert got == mem.query_sql_table(sql), sql
    got = PortDB.query_streaming_sql(
        path, "SELECT k FROM t ORDER BY k DESC LIMIT 4", 97, schema=sch,
        device="cpu")
    assert got["k"] == [int(x) for x in np.sort(k)[::-1][:4]]


@pytest.mark.parametrize("base,spread", WIDE_BASES)
def test_streaming_wide_int64_window_partitions(tmp_path, base, spread):
    """PARTITION BY int64 keys beyond 2^53 keeps one partition a key (the
    two-pass lookup compares int64 values, not float64)."""
    path, k, v = _wide_int64_file(tmp_path, base, spread, seed=43)
    sch = [DataType.INT64, DataType.FLOAT32]
    sql = ("SELECT k, v, SUM(v) OVER (PARTITION BY k) AS s, "
           "COUNT(v) OVER (PARTITION BY k) AS c FROM t")
    got = PortDB.query_streaming_sql(path, sql, 131, schema=sch,
                                     device="cpu")
    assert got == PortDB(path, schema=sch, device="cpu").query_sql_table(sql)
    _, inv = np.unique(k, return_inverse=True)
    np.testing.assert_array_equal(got["s"], np.bincount(inv, weights=v)[inv])
    np.testing.assert_array_equal(got["c"], np.bincount(inv)[inv])


@pytest.mark.parametrize("fmt", ["csv", "parquet"])
def test_streaming_narrow_int64_reads_the_stream_once(tmp_path, fmt):
    """Int64 columns inside the int32 range need no shared vocabulary: the
    stream is read once (the first chunk fixes the schema), and the
    answer is the reference's."""
    rng = np.random.default_rng(47)
    n = 900
    k, v = rng.integers(-50, 50, n), rng.integers(0, 100, n)
    if fmt == "csv":
        path = _write_csv(tmp_path / "n.csv", {"k": k, "v": v})
        schema = ["INT64", "FLOAT32"]
    else:  # Parquet int64 columns load as INT64
        pa = pytest.importorskip("pyarrow")
        import pyarrow.parquet as pq

        path = tmp_path / "n.parquet"
        pq.write_table(pa.table({"k": k.astype(np.int64),
                                 "v": v.astype(np.float32)}), path,
                       row_group_size=128)
        schema = None
    _check_sql(path, "SELECT k, COUNT(*) AS n, SUM(v) AS s FROM t "
               "GROUP BY k", 101, schema=schema, approx={"s"})
    st = last_stream_stats()
    assert (st.chunks, st.prepass_chunks) == (9, 1)


# --- per-row statements ----------------------------------------------------


def test_streaming_sql_perrow(tmp_path):
    rng = np.random.default_rng(23)
    n = 9_000
    v = (rng.random(n) * 100).round(4)
    name = np.array(["ash", "birch", "cedar", "fir"])[rng.integers(0, 4, n)]
    path = _write_csv(tmp_path / "p.csv", {"v": v, "name": name})
    sch = ["FLOAT32", "STRING"]
    for sql in [
        "SELECT v FROM t ORDER BY v DESC LIMIT 6",
        "SELECT v * 2 FROM t WHERE v > 99",
        "SELECT v FROM t LIMIT 7",
        "SELECT v FROM t ORDER BY v ASC LIMIT 3 OFFSET 2",
        "SELECT name, v FROM t WHERE v > 99.3 ORDER BY name ASC, v DESC "
        "LIMIT 5",
        "SELECT * FROM t LIMIT 3",
        "SELECT v * 2 AS d FROM t ORDER BY d DESC LIMIT 2",
    ]:
        _check_sql(path, sql, 1111, schema=sch)
    # LIMIT without ORDER BY stops the stream early.
    _check_sql(path, "SELECT v FROM t LIMIT 1500", 1111, schema=sch)
    assert last_stream_stats().chunks == 2


def test_streaming_sql_perrow_dim_join(tmp_path):
    rng = np.random.default_rng(29)
    n = 3_000
    path = _write_csv(tmp_path / "f.csv",
                      {"k": rng.integers(0, 8, n),
                       "v": (rng.random(n) * 100).round(4)})
    dim = {"k2": np.arange(8, dtype=np.float32),
           "w": (np.arange(8, dtype=np.float32) + 1) * 10}
    _check_sql(path, "SELECT v * d.w FROM t JOIN d ON k = d.k2 WHERE v > 95 "
               "ORDER BY v * d.w DESC LIMIT 5", 500, dims={"d": dim})


def test_streaming_sql_rejects(tmp_path):
    path = tmp_path / "x.csv"
    path.write_text("a,b\n1,2\n")
    _check_raises(path, "SELECT a FROM t JOIN r ON a = b", None,
                  "UnsupportedError", "JOIN")
    _check_raises(path, "SELECT a FROM t ORDER BY a", None,
                  "UnsupportedError", "ORDER BY only together")
    _check_raises(path, "SELECT MEDIAN(a) FROM t", None, "UnsupportedError",
                  "MEDIAN")
    _check_raises(path, "SELECT a FROM t UNION SELECT b FROM t", None,
                  "UnsupportedError", "UNION")
    _check_raises(path, "SELECT a, SUM(b) FROM t GROUP BY ROLLUP(a)", None,
                  "UnsupportedError", "GROUPING SETS")
    _check_raises(path, "SELECT a, b + 1 FROM t GROUP BY a", None,
                  "UnsupportedError", "GROUP BY")
    _check_raises(path, "SELECT c FROM t", None, "ValidationError",
                  "Unknown column")
    dim = {"a": np.array([1.0], np.float32)}
    _check_raises(path, "SELECT b FROM t RIGHT JOIN r ON a = r.a", None,
                  "UnsupportedError", "INNER and LEFT", dims={"r": dim})


# --- joins against in-memory dimension tables -----------------------------


def test_streaming_sql_join_against_dims(tmp_path):
    rng = np.random.default_rng(61)
    n = 800
    path = _write_csv(tmp_path / "fact.csv",
                      {"k": rng.integers(0, 12, n),
                       "v": rng.uniform(0, 50, n).astype(np.float32)})
    dim = {"k": np.arange(12, dtype=np.float32),
           "w": rng.uniform(0.5, 2.0, 12).astype(np.float32)}
    _check_sql(path, "SELECT k, SUM(v * dim.w) FROM t JOIN dim ON k = dim.k "
               "GROUP BY k ORDER BY k ASC", 97, dims={"dim": dim})
    _check_raises(path, "SELECT SUM(v) FROM t JOIN nope ON k = nope.k", 97,
                  "UnsupportedError", "dims")


def test_streaming_sql_left_join_and_fanout(tmp_path):
    rng = np.random.default_rng(63)
    n = 1_000
    path = _write_csv(tmp_path / "fact.csv",
                      {"k": rng.integers(0, 40, n),
                       "v": rng.uniform(0, 50, n).round(2)})
    reps = rng.integers(0, 4, 32)
    dim = {"k": np.repeat(np.arange(32), reps).astype(np.float32),
           "w": rng.uniform(0, 1, int(reps.sum())).astype(np.float32)}
    _check_sql(path, "SELECT COUNT(dim.w) FROM t LEFT JOIN dim ON k = dim.k",
               77, dims={"dim": dim})
    _check_sql(path, "SELECT k, SUM(v * dim.w) AS s, COUNT(*) AS n FROM t "
               "JOIN dim ON k = dim.k GROUP BY k", 77, dims={"dim": dim},
               approx={"s"})


def test_streaming_sql_join_string_dim(tmp_path):
    rng = np.random.default_rng(62)
    n = 300
    cities = np.array(["ams", "ber", "cdg"])
    path = _write_csv(tmp_path / "fact2.csv",
                      {"city": cities[rng.integers(0, 3, n)],
                       "v": rng.uniform(0, 10, n).astype(np.float32)})
    dim = {"city": np.array(["ber", "ams", "cdg"], dtype=object),
           "w": np.array([2.0, 3.0, 4.0], np.float32)}
    _check_sql(path, "SELECT SUM(v * geo.w) FROM t JOIN geo ON city = "
               "geo.city GROUP BY city ORDER BY city ASC", 41,
               schema=["STRING", "FLOAT32"], dims={"geo": dim})


def test_cross_join_streaming(tmp_path):
    path = tmp_path / "facts.csv"
    path.write_text("a\n" + "\n".join(str(i) for i in range(17)) + "\n")
    got = _check_sql(path, "SELECT SUM(a * b) AS s FROM t CROSS JOIN u", 5,
                     dims={"u": {"b": np.array([1, 2, 4], np.float32)}})
    assert got["s"] == [sum(range(17)) * 7.0]


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_streaming_vs_reference(tmp_path, seed):
    rng = np.random.default_rng(555_000 + seed)
    n = int(rng.integers(30, 1200))
    nk = int(rng.integers(2, 40))
    g = rng.integers(0, 5, n).astype(np.float32)
    k = rng.integers(0, nk + 2, n).astype(np.float32)
    v = rng.uniform(0.0, 50.0, n).astype(np.float32).round(3)
    dim = {"k": np.arange(nk, dtype=np.float32),
           "w": rng.uniform(0.5, 2.0, nk).astype(np.float32).round(3)}
    agg = ["SUM", "AVG", "MIN", "MAX", "COUNT"][int(rng.integers(0, 5))]
    cond = f"WHERE v > {rng.uniform(0, 30):.2f}" if rng.uniform() < 0.6 else ""
    shapes = [
        f"SELECT g, {agg}(v) FROM t {cond} GROUP BY g ORDER BY g ASC",
        f"SELECT g, COUNT(DISTINCT k) FROM t {cond} GROUP BY g ORDER BY g ASC",
        f"SELECT g, {agg}(v * d.w) FROM t JOIN d ON k = d.k {cond} "
        "GROUP BY g ORDER BY g ASC",
        f"SELECT DISTINCT g FROM t {cond} ORDER BY g ASC",
    ]
    chunk = int(rng.integers(7, max(8, n // 2)))
    path = _write_csv(tmp_path / "fact.csv", {"g": g, "k": k, "v": v},
                      {"g": "{:.1f}", "k": "{:.1f}", "v": "{:.3f}"})
    for sql in shapes:
        _check_sql(path, sql, chunk, dims={"d": dim} if "JOIN" in sql
                   else None)


# --- partition-aggregate windows (tests/test_streaming_windows.py) --------


def _window_data(n=999, parts=7, seed=11):
    rng = np.random.default_rng(seed)
    return {"p": rng.integers(0, parts, n).astype(np.float32),
            "v": np.round(rng.uniform(0.0, 100.0, n), 2).astype(np.float32)}


# ``v - AVG(v) OVER …`` carries the average's rtol at |v| <= 100 through
# the subtraction: atol 1e-5 * 100 there.
DEV_ATOL = RTOL * 100

WINDOW_QUERIES = [
    ("SELECT v, SUM(v) OVER (PARTITION BY p) AS s FROM t", {"s"}),
    ("SELECT v - AVG(v) OVER (PARTITION BY p) AS d FROM t", {"d"}),
    ("SELECT MAX(v) OVER (PARTITION BY p) - MIN(v) OVER (PARTITION BY p)"
     " AS r FROM t", set()),
    ("SELECT v / COUNT(v) OVER (PARTITION BY p) AS w FROM t WHERE v > 30",
     set()),
    ("SELECT v, SUM(v) OVER () AS tot FROM t", {"tot"}),
]


@pytest.mark.parametrize("sql,approx", WINDOW_QUERIES)
def test_streaming_window_matches_reference(tmp_path, sql, approx):
    path = _write_csv(tmp_path / "t.csv", _window_data())
    _check_sql(path, sql, 64, approx=approx,
               atol=DEV_ATOL if "AS d" in sql else ATOL)


def test_streaming_window_orderby_limit(tmp_path):
    path = _write_csv(tmp_path / "t.csv", _window_data())
    _check_sql(path, "SELECT v - AVG(v) OVER (PARTITION BY p) AS d FROM t "
               "ORDER BY d DESC LIMIT 5", 64, approx={"d"}, atol=DEV_ATOL)
    # Two passes: the grouped stream, then the per-row stream.
    assert last_stream_stats().chunks == 2 * 16


def test_streaming_window_string_partition(tmp_path):
    n = 300
    rng = np.random.default_rng(3)
    path = _write_csv(tmp_path / "t.csv", {
        "s": np.array(["aa", "bb", "cc"])[rng.integers(0, 3, n)],
        "v": np.round(rng.uniform(0, 10, n), 2).astype(np.float32),
    })
    _check_sql(path, "SELECT v - AVG(v) OVER (PARTITION BY s) AS d FROM t",
               32, schema=["STRING", "FLOAT32"], approx={"d"},
               atol=RTOL * 10)


def test_streaming_ordered_window_still_refuses(tmp_path):
    path = _write_csv(tmp_path / "t.csv", _window_data(50))
    for sql in [
        "SELECT SUM(v) OVER (PARTITION BY p ORDER BY v ASC) FROM t",
        "SELECT RANK() OVER (PARTITION BY p ORDER BY v ASC) FROM t",
    ]:
        _check_raises(path, sql, 16, "UnsupportedError", "window")


# --- the port's own contract ------------------------------------------------


def test_streaming_with_a_mesh_raises():
    """A mesh no longer raises: each chunk shards over a 4-shard CPU mesh,
    and the three entry points equal the reference's on its 8-device
    mesh."""
    from warpdb_tpu_torch.parallel import data_mesh as port_mesh

    mesh, ref_mesh = port_mesh(devices=["cpu"] * 4), data_mesh()
    sql = "SELECT quantity, SUM(price) AS s FROM t GROUP BY quantity"
    for port_call, ref_call, args in (
        (PortDB.query_streaming_sql, RefDB.query_streaming_sql,
         ("data/test.csv", sql)),
        (PortDB.query_streaming_csv, RefDB.query_streaming_csv,
         ("data/test.csv", "price * quantity WHERE price > 15")),
        (PortDB.query_multi_gpu_csv, RefDB.query_multi_gpu_csv,
         ("data/test.csv", "price")),
    ):
        got = port_call(*args, rows_per_chunk=3, mesh=mesh)
        assert got == ref_call(*args, rows_per_chunk=3, mesh=ref_mesh)


def test_streaming_without_cuda_raises(monkeypatch):
    import torch

    from warpdb_tpu_torch.storage import table as table_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_upload(*a, **kw):
        raise AssertionError("a chunk was uploaded")

    monkeypatch.setattr(table_mod.DeviceTable, "from_host", no_upload)
    with pytest.raises(errors.ExecutionError, match="CUDA is not available"):
        PortDB.query_streaming_sql("data/test.csv",
                                   "SELECT SUM(price) FROM t")
    with pytest.raises(errors.ExecutionError, match="CUDA is not available"):
        PortDB.query_streaming_csv("data/test.csv", "price")


def test_streaming_default_chunk_size_and_alias(tmp_path):
    from warpdb_tpu_torch.config import get_config

    assert get_config().rows_per_chunk == 1_000_000
    assert PortDB.query_multi_gpu_csv("data/test.csv", "price * quantity",
                                      device="cpu") == [31.5, 80.0, 30.5,
                                                        150.0]
    assert last_stream_stats().chunks == 1
