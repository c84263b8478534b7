"""The result surfaces of the port against the reference: EXPLAIN (the
same headings and tier, and the tier the operator trace shows),
EXPLAIN ANALYZE and ``utils.metrics``, DDL, the DB-API module, the HTTP
server (the reference's ``tests/test_serve.py`` cases, two requests at
once and a threaded stress run) and the CLI (the reference's lines,
timings aside), all on ``device="cpu"``."""

import json
import re
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import warpdb_tpu.dbapi as ref_dbapi
from warpdb_tpu import WarpDB as RefDB
from warpdb_tpu import errors as ref_errors
from warpdb_tpu.storage import HostTable as RefHostTable
import warpdb_tpu_torch.dbapi as dbapi
from warpdb_tpu_torch import WarpDB, errors
from warpdb_tpu_torch.serve import QueryServer
from warpdb_tpu_torch.storage import HostTable
from warpdb_tpu_torch.utils import metrics

N = 20_000


def _data() -> dict:
    rng = np.random.default_rng(77)
    return {
        "price": rng.uniform(0, 100, N).astype(np.float32),
        "quantity": rng.integers(0, 32, N).astype(np.float32),
        "k": rng.integers(0, 8000, N).astype(np.float32),
        "big": rng.integers(0, 3_000_000, N).astype(np.float32),
        "tag": rng.choice(["x", "y", "z"], N),
    }


DIM = {"quantity": np.arange(32, dtype=np.float32),
       "w": np.linspace(0, 3, 32).astype(np.float32)}


@pytest.fixture(scope="module")
def dbs():
    data = _data()
    ref = RefDB(RefHostTable.from_dict(data))
    port = WarpDB(HostTable.from_dict(data), device="cpu")
    ref.register_table("dim", RefHostTable.from_dict(DIM))
    port.register_table("dim", HostTable.from_dict(DIM))
    return ref, port


# --- EXPLAIN ---------------------------------------------------------------

# The reference's tier thresholds under the port's names: the EXPLAIN
# tests below hold the port's tier naming to the reference's at the same
# thresholds (the port's defaults are the H100's, ``config.py``).
REFERENCE_TIERS = {
    "dense_group_max_slots": 4096,
    "midrange_group_base_slots": 1 << 20,
    "midrange_group_max_slots": 1 << 23,
    "group_hist_max_slots": 1 << 16,
    "distributed_small_keys": 4096,
}


@pytest.fixture
def reference_tiers():
    """The port's thresholds set to the reference's, restored after."""
    import dataclasses

    from warpdb_tpu_torch import config

    saved = config.get_config()
    config.set_config(dataclasses.replace(saved, **REFERENCE_TIERS))
    try:
        yield
    finally:
        config.set_config(saved)


# (statement, tier, operators the analysed run must show); K2 counts and
# sums SUM/COUNT-only groupings in the dense tier as in the midrange one.
EXPLAINED = [
    ("SELECT SUM(price) FROM t GROUP BY quantity", "DENSE",
     ["dense_group", "K2 group_hist (plain)"]),
    ("SELECT k, SUM(price), COUNT(*) FROM t GROUP BY k", "MIDRANGE",
     ["midrange_group", "K2 group_hist (plain)"]),
    ("SELECT k, MIN(price) FROM t GROUP BY k", "MIDRANGE",
     ["midrange_group"]),
    ("SELECT big, SUM(price) FROM t GROUP BY big", "SORTED", ["group_sort"]),
    ("SELECT k, SUM(price) AS s FROM t GROUP BY k ORDER BY s DESC LIMIT 3",
     "MIDRANGE", ["midrange_group", "K2 group_hist (plain)"]),
    ("SELECT quantity, COUNT(*) FROM t WHERE price > 50 GROUP BY quantity "
     "HAVING SUM(price) > 10 ORDER BY quantity", "DENSE",
     ["dense_group", "K2 group_hist (plain)"]),
    ("SELECT price FROM t ORDER BY price DESC LIMIT 5", None,
     ["project_topk", "K1 topk (plain)"]),
    ("SELECT price FROM t WHERE price > 99 ORDER BY price", None,
     ["project_sort"]),
    ("SELECT DISTINCT quantity FROM t", None,
     ["distinct", "dense_group", "K2 group_hist (plain)"]),
    ("SELECT SUM(price) OVER (PARTITION BY quantity) FROM t", None,
     ["window"]),
    ("SELECT COUNT(*) FROM t WHERE price > 10", None, ["global_agg"]),
    ("SELECT SUM(price * dim.w) FROM t JOIN dim ON quantity = dim.quantity "
     "WHERE dim.w > 1 GROUP BY quantity", "DENSE", []),
]


def _headings(plan: str) -> list:
    """Each line's heading, without its parenthesised detail."""
    return [re.split(r"[:(]", ln)[0].strip() for ln in plan.splitlines()
            if ":" in ln and not ln.startswith("Execution")]


def _tier(plan: str):
    m = re.search(r"strategy: (DENSE|MIDRANGE|SORTED)", plan)
    return m.group(1) if m else None


@pytest.mark.parametrize("q,tier,ops", EXPLAINED)
def test_explain_headings_and_tier_match_reference(dbs, reference_tiers, q,
                                                   tier, ops):
    ref, port = dbs
    want, got = ref.explain(q), port.explain(q)
    assert _headings(got) == _headings(want), (got, want)
    assert got.splitlines()[0] == want.splitlines()[0]
    assert _tier(got) == _tier(want) == tier


@pytest.mark.parametrize("q,tier,ops", EXPLAINED)
def test_explain_tier_is_the_tier_that_runs(dbs, reference_tiers, q, tier,
                                            ops):
    """The analysed run's operator trace shows the tier EXPLAIN names,
    and K2 exactly where EXPLAIN names it."""
    _ref, port = dbs
    plan = port.explain(q, analyze=True)
    trace = [ln for ln in plan.splitlines() if "operators:" in ln]
    names = trace[0].split("operators:")[1] if trace else ""
    for op in ops:
        assert op in names, plan
    assert ("K2 shared-memory" in plan) == ("K2 group_hist" in names), plan
    assert ("K1 top-k kernel" in plan) == ("K1 topk" in names), plan


def test_explain_non_integral_key_is_sorted(dbs):
    """A bounded float key that is not integral takes the sorted tier in
    the port's EXPLAIN and run alike."""
    _ref, port = dbs
    q = "SELECT price, COUNT(*) FROM t WHERE price < 1 GROUP BY price"
    plan = port.explain(q, analyze=True)
    assert _tier(plan) == "SORTED"
    assert "group_sort" in plan


def test_explain_expression_and_ctes(dbs):
    ref, port = dbs
    for q in ("price * 2 WHERE price > 50", "price + quantity",
              "WITH c AS (SELECT quantity FROM t WHERE price > 90) "
              "SELECT COUNT(*) FROM c",
              "SELECT quantity FROM t WHERE price > 99 UNION "
              "SELECT quantity FROM dim"):
        assert _headings(port.explain(q)) == _headings(ref.explain(q)), q


def test_explain_names_the_port_mechanisms(dbs):
    _ref, port = dbs
    plan = port.explain("SELECT k, SUM(price) FROM t GROUP BY k")
    assert "K2 shared-memory slot table (csrc/group_hist.cu)" in plan
    for word in ("MXU", "VPU", "lax.sort", "XLA"):
        assert word not in plan
    plan = port.explain("SELECT price FROM t ORDER BY price DESC LIMIT 5")
    assert "K1 top-k kernel (csrc/topk.cu), k=16" in plan


def test_explain_analyze_trailer(dbs):
    ref, port = dbs
    q = "SELECT SUM(price) FROM t GROUP BY quantity"
    got = port.explain(q, analyze=True).split("Execution (measured):")[1]
    want = ref.explain(q, analyze=True).split("Execution (measured):")[1]
    assert [ln.split(":")[0] for ln in got.strip().splitlines()] == [
        ln.split(":")[0] for ln in want.strip().splitlines()]
    assert f"rows: {N} scanned -> 32 returned" in got


def test_metrics_history_last_and_report(dbs):
    _ref, port = dbs
    q = "SELECT quantity, SUM(price) FROM t GROUP BY quantity"
    before = len(metrics.history())
    port.query_sql_table(q)
    m = metrics.last()
    assert (m.query, m.kind, m.rows, m.output_rows) == (q, "sql", N, 32)
    # price and quantity: two padded f32 columns.
    assert m.bytes_scanned == 2 * 4 * port.table.padded_rows
    assert m.wall_s > 0 and ("dense_group", True) in m.operators
    port.query_np("price * 2")
    assert metrics.last().kind == "expression"
    assert len(metrics.history()) >= min(before + 2, 256)
    report = metrics.report(2)
    assert "price * 2" in report and report.count("\n") == 2
    assert m.device == "cpu"
    assert metrics.peak_hbm_bytes_per_s("cpu") == 50e9
    assert metrics.roofline_fraction(m) == pytest.approx(
        m.gb_per_s * 1e9 / 50e9)


@pytest.mark.parametrize("card,peak", [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_roofline_peak_follows_the_query_device(monkeypatch, card, peak):
    """A card's query is held to its card's peak, a CPU query to the
    host's on any machine, and a card the table lacks gets no share."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: card)
    assert metrics.peak_hbm_bytes_per_s("cuda:0") == peak
    assert metrics.peak_hbm_bytes_per_s("cpu") == 50e9
    m = metrics.QueryMetrics(query="q", kind="sql", wall_s=1.0, rows=1,
                             bytes_scanned=10**9, output_rows=1,
                             device="cuda:0")
    want = None if peak is None else 1e9 / peak
    assert metrics.roofline_fraction(m) == want
    with metrics.timed_query("dev_q", "sql", 1, 10**9, "cuda:0"):
        pass
    row = metrics.report(1).splitlines()[1]
    assert row.startswith("dev_q")
    share = row.split()[-1]
    assert share == "-" if peak is None else float(share) > 0


def test_metrics_trace_is_per_thread():
    seen = []

    def run():
        with metrics.timed_query("q", "sql", 1, 0):
            metrics.note_operator("mine", True)
        seen.append(metrics.last())

    with metrics.timed_query("outer", "sql", 1, 0):
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=30)
        metrics.note_operator("outer_op", True)
    assert not t.is_alive()
    assert metrics.last().operators == (("outer_op", True),)


def test_profile_trace_writes_a_chrome_trace(tmp_path, dbs):
    _ref, port = dbs
    with metrics.profile_trace(str(tmp_path)):
        port.query_np("price * 2")
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]


# --- DDL -------------------------------------------------------------------

DDL_STEPS = [
    "CREATE TABLE agg AS SELECT quantity, SUM(price) AS s, COUNT(*) AS n "
    "FROM t GROUP BY quantity",
    "SELECT quantity, s FROM agg WHERE n > 600 ORDER BY s DESC",
    "CREATE VIEW tags AS SELECT tag, COUNT(*) AS c FROM t GROUP BY tag",
    "SELECT tag, c FROM tags ORDER BY tag",
    "SELECT agg.s, tags.c FROM agg JOIN tags ON agg.n = tags.c",
    "DROP VIEW tags",
    "DROP TABLE IF EXISTS nothing",
    "CREATE TABLE top AS WITH c AS (SELECT price FROM t WHERE price > 99) "
    "SELECT price FROM c ORDER BY price DESC LIMIT 3",
    "SELECT price FROM top",
    "DROP TABLE agg",
]


def test_ddl_matches_reference():
    data = _data()
    ref = RefDB(RefHostTable.from_dict(data))
    port = WarpDB(HostTable.from_dict(data), device="cpu")
    for q in DDL_STEPS:
        want, got = ref.query_sql_table(q), port.query_sql_table(q)
        assert list(got) == list(want), q
        for col in want:
            if want[col] and isinstance(want[col][0], str):
                assert got[col] == want[col], q
            else:
                np.testing.assert_allclose(got[col], want[col], rtol=1e-5,
                                           err_msg=q)
    assert port._catalog["top"].device.type == "cpu"
    assert port.query_sql("DROP TABLE top") == []


@pytest.mark.parametrize("q", [
    "DROP TABLE nothing",
    "CREATE TABLE table AS SELECT price FROM t",
    "SELECT s FROM gone",
])
def test_ddl_errors_match_reference(q):
    data = {"price": np.float32([1, 2])}
    ref = RefDB(RefHostTable.from_dict(data))
    port = WarpDB(HostTable.from_dict(data), device="cpu")
    for db in (ref, port):
        db.query_sql("CREATE TABLE gone AS SELECT price AS s FROM t")
        db.query_sql("DROP TABLE gone")
    with pytest.raises(ref_errors.WarpDBError) as want:
        ref.query_sql(q)
    with pytest.raises(errors.WarpDBError) as got:
        port.query_sql(q)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


# --- DB-API ----------------------------------------------------------------

@pytest.fixture(scope="module")
def conn():
    c = dbapi.connect("data/test.csv", device="cpu")
    yield c
    c.close()


def test_dbapi_module_globals():
    for name in ("apilevel", "threadsafety", "paramstyle"):
        assert getattr(dbapi, name) == getattr(ref_dbapi, name)
    assert issubclass(dbapi.ProgrammingError, dbapi.DatabaseError)
    assert issubclass(dbapi.DatabaseError, dbapi.Error)
    assert issubclass(dbapi.Error, errors.WarpDBError)


def test_dbapi_execute_fetch(conn):
    cur = conn.cursor()
    cur.execute("SELECT quantity, SUM(price) FROM test GROUP BY quantity "
                "ORDER BY quantity")
    assert cur.rowcount == 4
    assert cur.description[0][0] == "quantity"
    assert cur.description[0][1] == dbapi.NUMBER
    assert cur.fetchone() == (2.0, 15.25)
    assert cur.fetchmany(2) == [(3.0, 10.5), (4.0, 20.0)]
    assert cur.fetchall() == [(5.0, 30.0)]
    assert cur.fetchone() is None


@pytest.mark.parametrize("sql,params", [
    ("SELECT price FROM test WHERE price > %s AND quantity < %s", (15, 5)),
    ("SELECT quantity, COUNT(*) FROM test GROUP BY quantity", None),
    ("SELECT STRING_AGG(price, ';') FROM test WHERE quantity > %s", (2,)),
])
def test_dbapi_rows_match_reference(sql, params):
    rows = []
    for mod, kw in ((dbapi, {"device": "cpu"}), (ref_dbapi, {})):
        with mod.connect("data/test.csv", **kw) as c:
            cur = c.cursor().execute(sql, params)
            rows.append((cur.fetchall(), [d[:2] for d in cur.description]))
    assert rows[0][0] == rows[1][0]
    assert [d[0] for d in rows[0][1]] == [d[0] for d in rows[1][1]]
    assert [d[1].name for d in rows[0][1]] == [d[1].name for d in rows[1][1]]


def test_dbapi_string_parameter_quoting():
    c = dbapi.connect(HostTable.from_dict({
        "name": np.array(["a'b", "plain"], dtype=object),
        "v": np.array([1.0, 2.0], np.float32)}), device="cpu")
    cur = c.cursor()
    cur.execute("SELECT v FROM t WHERE name == %s", ("a'b",))
    assert cur.fetchall() == [(1.0,)]
    assert cur.description[0][1] == dbapi.NUMBER
    cur.execute("SELECT name FROM t ORDER BY name")
    assert cur.description[0][1] == dbapi.STRING
    assert [r[0] for r in cur] == ["a'b", "plain"]


def test_dbapi_iteration_and_context_managers():
    with dbapi.connect("data/test.csv", device="cpu") as c:
        with c.cursor() as cur:
            cur.execute("SELECT price FROM test ORDER BY price")
            assert [r[0] for r in cur] == [10.5, 15.25, 20.0, 30.0]
    with pytest.raises(dbapi.InterfaceError):
        c.cursor()


def test_dbapi_error_mapping(conn):
    cur = conn.cursor()
    with pytest.raises(dbapi.ProgrammingError):
        cur.execute("SELECT nosuchcol FROM test")
    with pytest.raises(dbapi.ProgrammingError):
        cur.execute("SELEKT price FROM test")
    with pytest.raises(dbapi.ProgrammingError):
        cur.fetchall()  # a failed execute leaves no result set
    with pytest.raises(dbapi.NotSupportedError):
        cur.execute("SELECT a.price FROM test a LEFT JOIN test b "
                    "ON a.price < b.price")


def test_dbapi_transactions_and_mesh(conn):
    """Commit succeeds, rollback is refused, and ``connect(mesh=…)`` runs
    sharded over a CPU mesh with the reference's rows (its connection on
    its 8-device mesh)."""
    from warpdb_tpu.parallel import data_mesh as ref_data_mesh
    from warpdb_tpu_torch.parallel import ShardedTable, data_mesh

    conn.commit()
    with pytest.raises(dbapi.NotSupportedError):
        conn.rollback()
    sql = ("SELECT quantity, SUM(price) FROM test GROUP BY quantity "
           "ORDER BY quantity")
    with dbapi.connect("data/test.csv",
                       mesh=data_mesh(devices=["cpu"] * 4)) as c:
        assert isinstance(c._db.table, ShardedTable)
        got = c.cursor().execute(sql).fetchall()
    with ref_dbapi.connect("data/test.csv", mesh=ref_data_mesh()) as rc:
        want = rc.cursor().execute(sql).fetchall()
    assert got == want == [(2.0, 15.25), (3.0, 10.5), (4.0, 20.0),
                           (5.0, 30.0)]


def test_dbapi_register_table_join_and_ddl():
    c = dbapi.connect("data/test.csv", device="cpu")
    c.register_table("rates", HostTable.from_dict({
        "quantity": np.arange(8, dtype=np.float32),
        "rate": (np.arange(8) * 0.1).astype(np.float32)}))
    cur = c.cursor()
    cur.execute("SELECT price, rate FROM test JOIN rates "
                "ON quantity = rates.quantity ORDER BY price LIMIT 2")
    rows = cur.fetchall()
    assert rows[0][0] == 10.5
    assert rows[0][1] == pytest.approx(0.3, rel=1e-6)
    cur.execute("CREATE TABLE cheap AS SELECT price FROM test "
                "WHERE price < 16")
    assert cur.rowcount == 0
    cur.execute("SELECT price FROM cheap")
    assert cur.fetchall() == [(10.5,), (15.25,)]


def test_dbapi_executemany_and_pandas(conn):
    cur = conn.cursor()
    cur.executemany("SELECT price FROM test WHERE quantity == %s",
                    [(3,), (5,)])
    assert cur.fetchall() == [(30.0,)]
    pd = pytest.importorskip("pandas")
    df = pd.read_sql("SELECT quantity, SUM(price) AS total FROM test "
                     "GROUP BY quantity ORDER BY quantity", conn)
    assert list(df.columns) == ["quantity", "total"]
    assert df["total"].tolist() == [15.25, 10.5, 20.0, 30.0]


# --- HTTP server -----------------------------------------------------------

@pytest.fixture(scope="module")
def server():
    db = WarpDB("data/test.csv", device="cpu")
    db.register_table("rates", HostTable.from_dict({
        "quantity": np.arange(8, dtype=np.float32),
        "rate": (np.arange(8) * 0.5).astype(np.float32)}))
    srv = QueryServer(db, port=0).start()
    yield srv
    srv.shutdown()


def _post(srv, path, payload):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(srv, path):
    with urllib.request.urlopen(f"http://{srv.host}:{srv.port}{path}",
                                timeout=60) as r:
        return r.status, json.loads(r.read())


def test_serve_healthz_and_schema(server):
    code, body = _get(server, "/healthz")
    assert code == 200 and body["ok"] and body["rows"] == 4
    code, body = _get(server, "/schema")
    assert code == 200
    assert body["columns"] == {"price": "FLOAT32", "quantity": "FLOAT32"}


def test_serve_query(server):
    code, body = _post(server, "/query", {
        "sql": "SELECT quantity, SUM(price) AS total FROM test "
               "GROUP BY quantity ORDER BY total DESC"})
    assert code == 200 and body["rows"] == 4
    assert body["columns"]["total"] == [30.0, 20.0, 15.25, 10.5]
    assert body["elapsed_ms"] > 0


def test_serve_join_and_null_serialisation(server):
    code, _body = _post(server, "/query", {
        "sql": "SELECT price, rate FROM test LEFT JOIN rates "
               "ON quantity = rates.quantity ORDER BY price"})
    assert code == 200
    code, body = _post(server, "/query",
                       {"sql": "SELECT NULLIF(price, 10.5) FROM test"})
    assert list(body["columns"].values())[0][0] is None


def test_serve_error_mapping(server):
    code, body = _post(server, "/query", {"sql": "SELECT nope FROM test"})
    assert code == 400 and body["error"] == "ValidationError"
    assert "Unknown column" in body["message"]
    assert _post(server, "/query", {"nope": 1})[0] == 400
    assert _post(server, "/nowhere", {"sql": "SELECT 1"})[0] == 404
    assert _get(server, "/healthz")[0] == 200


def test_serve_explain(server):
    code, body = _post(server, "/explain", {
        "sql": "SELECT SUM(price) FROM test GROUP BY quantity"})
    assert code == 200 and body["plan"].startswith("Plan for:")


def test_serve_two_requests_at_once(server):
    """Two requests in flight together on one facade, each answered
    right."""
    qs = {"SELECT SUM(price) FROM test GROUP BY quantity":
          [15.25, 10.5, 20.0, 30.0],
          "SELECT price FROM test ORDER BY price DESC LIMIT 2": [30.0, 20.0]}
    results = {}
    barrier = threading.Barrier(2)

    def hit(sql):
        barrier.wait(timeout=30)
        results[sql] = _post(server, "/query", {"sql": sql})

    threads = [threading.Thread(target=hit, args=(s,)) for s in qs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for sql, want in qs.items():
        code, body = results[sql]
        assert code == 200 and list(body["columns"].values())[0] == want


def test_serve_threaded_stress_keeps_the_memos_consistent():
    """Many threads with a short switch interval through queries that
    fill and evict the join, eager, pushdown, subquery and CTE memos of
    one facade (the lock-guarded LRUs): every answer is right."""
    from warpdb_tpu_torch.config import get_config

    data = _data()
    db = WarpDB(HostTable.from_dict(data), device="cpu")
    db.register_table("dim", HostTable.from_dict(DIM))
    qs = [
        "SELECT quantity, SUM(price * dim.w) FROM t JOIN dim ON "
        f"quantity = dim.quantity WHERE dim.w > {w} GROUP BY quantity"
        for w in (0.5, 1.0, 1.5, 2.0, 2.5)
    ] + [
        f"WITH c AS (SELECT price FROM t WHERE price > {p}) "
        "SELECT COUNT(*) FROM c" for p in (10, 30, 50, 70, 90)
    ] + [
        "SELECT COUNT(*) FROM t WHERE quantity IN (SELECT quantity FROM dim "
        f"WHERE w > {w})" for w in (0.5, 2.5)
    ]
    want = {q: db.query_sql_table(q) for q in qs}
    srv = QueryServer(db, port=0).start()
    cfg = get_config()
    entries, cfg.join_cache_entries = cfg.join_cache_entries, 2
    bad: list = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(j):
            for i in range(6):
                q = qs[(i * 5 + j) % len(qs)]
                code, body = _post(srv, "/query", {"sql": q})
                exp = {c: [float(x) for x in v] for c, v in want[q].items()}
                if code != 200 or body["columns"] != exp:
                    bad.append((q, code, body))

        threads = [threading.Thread(target=worker, args=(j,))
                   for j in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        cfg.join_cache_entries = entries
        srv.shutdown()
    assert bad == []


# --- CLI -------------------------------------------------------------------

def _cli_lines(main, argv, capsys) -> list:
    assert main(argv) == 0
    out = capsys.readouterr().out
    # Timings aside.
    out = re.sub(r"in [0-9.]+ ms", "in T ms", out)
    out = re.sub(r"\([0-9,]+ rows/s", "(R rows/s", out)
    out = re.sub(r"wall: .*", "wall: W", out)
    return out.splitlines()


@pytest.mark.parametrize("argv", [
    ["price * quantity", "data/test.csv", "--limit-print", "4"],
    ["price * quantity WHERE price > 15", "data/test.csv"],
    ["SELECT SUM(price) FROM test GROUP BY quantity", "data/test.csv"],
    ["SELECT quantity, STRING_AGG(price, ',') FROM test GROUP BY quantity",
     "data/test.csv", "--limit-print", "2"],
    ["SELECT APPROX_COUNT_DISTINCT(price) FROM test", "data/test.csv"],
])
def test_cli_matches_reference(argv, capsys):
    from warpdb_tpu.__main__ import main as ref_main
    from warpdb_tpu_torch.__main__ import main

    got = _cli_lines(main, argv + ["--device", "cpu"], capsys)
    want = _cli_lines(ref_main, argv, capsys)
    assert got == want
    assert any(ln.startswith("Result[0] = ") for ln in got)


def test_cli_explain_analyze_headings(capsys):
    from warpdb_tpu.__main__ import main as ref_main
    from warpdb_tpu_torch.__main__ import main

    argv = ["SELECT SUM(price) FROM test GROUP BY quantity", "data/test.csv",
            "--explain", "--analyze"]
    got = "\n".join(_cli_lines(main, argv + ["--device", "cpu"], capsys))
    want = "\n".join(_cli_lines(ref_main, argv, capsys))
    assert _headings(got) == _headings(want)
    assert "Execution (measured):" in got and "operators: dense_group" in got


def test_cli_demo_and_profile(tmp_path, capsys):
    from warpdb_tpu_torch.__main__ import main

    assert main(["price", "data/test.csv", "--device", "cpu", "--demo",
                 "--profile", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "Filtered rows (price > 25.0): 1" in out
    assert "Revenue[3] = 150.0  Adjusted[3] = 135.0" in out
    assert "Sharded result rows: 4" in out
    assert "Streamed result rows: 4" in out
    assert "Result[3] = 30.0" in out
    assert (tmp_path / "trace.json").exists()


def test_cli_serve_takes_the_positional_as_the_data_file(monkeypatch):
    import warpdb_tpu_torch.serve as serve_mod
    from warpdb_tpu_torch.__main__ import main

    served = []
    monkeypatch.setattr(serve_mod, "serve",
                        lambda db, port: served.append((db.table_name, port)))
    assert main(["--serve", "8123", "data/extended.csv", "--device",
                 "cpu"]) == 0
    assert served == [("extended", 8123)]


def test_cli_sharded_raises(capsys):
    """``--sharded`` no longer raises: it prints its rows, as the
    reference's CLI does (over every device of the facade's type: one CPU
    shard here)."""
    from warpdb_tpu.__main__ import main as ref_main
    from warpdb_tpu_torch.__main__ import main

    argv = ["price * quantity", "data/test.csv", "--sharded"]
    got = _cli_lines(main, argv + ["--device", "cpu"], capsys)
    assert got == _cli_lines(ref_main, argv, capsys)
    assert "Result[3] = 150.0" in got
