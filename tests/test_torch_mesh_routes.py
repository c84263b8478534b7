"""The mesh's shard routes against the reference mesh and one device.

Filtered projections, full sorts, global aggregates, DISTINCT,
COUNT(DISTINCT), APPROX_COUNT_DISTINCT and MEDIAN run on every shard of
the port's 8-shard CPU mesh (``parallel/project.py``), and the gather
route moves only the columns an operator reads.  The same seeded NumPy
data goes through the reference on its 8-way CPU mesh, the port on
``DataMesh(["cpu"] * 8)`` and the port on one device.

Tolerances are ``test_torch_parallel``'s (its module docstring): keys,
counts, values, row order, MIN, MAX, DISTINCT values, distinct counts
and the HyperLogLog registers exactly; float sums within rtol 1e-4 of
the reference, within 1e-6 of float64, and within that plus the
single-device result's own distance from float64 of the single-device
sum (the mesh adds each shard in float64).  Each test also asserts the
operator the run records and its collective bytes.

MIN / MAX over NaN hold the port's mesh to the reference on ONE device
(``ref_one``): the reference's mesh returns +inf / -inf there, its one
device NaN.  The DISTINCT of a 4097..65536-slot item is held to NumPy
instead of the reference, which raises in ``_try_dense_group`` on one
device and on its mesh alike.
"""

import numpy as np
import pytest

from test_torch_parallel import (  # noqa: F401  (ref_mesh is a fixture)
    MESH,
    N_SHARDS,
    _dbs,
    _exact,
    _f64,
    _ops,
    _sums,
    ref_mesh,
)
from warpdb_tpu import WarpDB as RefDB
from warpdb_tpu.storage import HostTable as RefHost
from warpdb_tpu_torch import WarpDB as PortDB
from warpdb_tpu_torch.storage import HostTable
from warpdb_tpu_torch.utils.metrics import last

N = 4000
SHARD = N // N_SHARDS


def _table(nan: bool = False) -> dict:
    """Shard 0's rows have ``u`` < 0, so ``WHERE u > 0`` empties it."""
    rng = np.random.default_rng(61)
    u = rng.uniform(0, 1, N).astype(np.float32)
    u[:SHARD] = rng.uniform(-10, -1, SHARD).astype(np.float32)
    v = rng.uniform(0, 10, N).astype(np.float32)
    if nan:
        v[rng.choice(N, 40, replace=False)] = np.nan
    return {"a": rng.integers(0, 6, N).astype(np.float32),
            "w": rng.integers(0, 3, N).astype(np.float32),
            "b": rng.integers(0, 900, N).astype(np.int32),
            "k": rng.integers(0, 40_000, N).astype(np.float32),
            "u": u, "v": v}


class _Run:
    """One statement on the mesh, on one device and on the reference
    mesh: the result columns of each, and the mesh run's operators and
    collectives."""

    def __init__(self, ref, port, single, sql, ref_one=None):
        if ref_one is not None:
            ref = RefDB(RefHost.from_dict(ref_one))
        got = port.query_sql_table(sql)
        self.ops = _ops()
        self.collectives = last().collectives
        self.nbytes = sum(b for _op, b in self.collectives)
        s = single.query_sql_table(sql)
        r = s if ref is None else ref.query_sql_table(sql)
        assert list(got) == list(s) == list(r)
        self.got, self.s, self.r = (list(x.values()) for x in (got, s, r))

    def columns(self):
        return zip(self.got, self.s, self.r)


# --- "partials": global aggregates ----------------------------------------

# (statement, the table has NaN, the float64 truth of each SUM / AVG
# column by index, from the table's columns).
GLOBAL_CASES = [
    ("SELECT COUNT(*), SUM(u), AVG(u), MIN(u), MAX(u) FROM t", False,
     lambda t, m: {1: t["u"][m].astype(np.float64).sum(),
                   2: t["u"][m].astype(np.float64).mean()}),
    ("SELECT COUNT(*), SUM(v), AVG(v), MIN(u), MAX(u) FROM t WHERE v > 5",
     False, lambda t, m: {1: t["v"][m].astype(np.float64).sum(),
                          2: t["v"][m].astype(np.float64).mean()}),
    # Shard 0 keeps no row: it must not move MIN, MAX or AVG.
    ("SELECT COUNT(*), SUM(u), AVG(u), MIN(u), MAX(u) FROM t WHERE u > 0",
     False, lambda t, m: {1: t["u"][m].astype(np.float64).sum(),
                          2: t["u"][m].astype(np.float64).mean()}),
    # No row at all: COUNT 0, SUM 0, AVG 0, MIN +inf, MAX -inf.
    ("SELECT COUNT(*), SUM(u), AVG(u), MIN(u), MAX(u) FROM t "
     "WHERE u > 1000", False, lambda t, m: {1: 0.0, 2: 0.0}),
    # NaN propagates through MIN and MAX as on one device; COUNT(v)
    # skips the NULLs (the NaNs).
    ("SELECT COUNT(*), COUNT(v), MIN(v), MAX(v) FROM t", True,
     lambda t, m: {}),
    ("SELECT SUM(u) / COUNT(*), MAX(v) - MIN(v) FROM t WHERE a > 1", False,
     lambda t, m: {0: t["u"][m].astype(np.float64).sum() / m.sum()}),
]


def _mask(t: dict, sql: str) -> np.ndarray:
    if "WHERE" not in sql:
        return np.ones(N, bool)
    col, _gt, thr = sql.split("WHERE ")[1].split()[:3]
    return t[col] > np.float32(thr)


@pytest.mark.parametrize("sql,nan,truth", GLOBAL_CASES)
def test_global_aggregates_take_the_partials_route(ref_mesh, sql, nan,
                                                   truth):
    t = _table(nan)
    run = _Run(*_dbs(t, ref_mesh), sql, ref_one=t if nan else None)
    assert set(run.ops) == {"sharded_global_agg"}
    # A few partials a shard cross the mesh, no column.
    assert run.nbytes < 1024
    sums = truth(t, _mask(t, sql))
    for i, (g, si, ri) in enumerate(run.columns()):
        if i in sums:
            _sums(g, si, ri, [sums[i]])
        else:
            _exact(g, si, ri)


# --- "shard": filtered projections and full sorts -------------------------


# (statement, bytes a matching row moves).
PROJECT_CASES = [
    ("SELECT u * a FROM t WHERE u > 0.9", 4),
    ("SELECT u, a, b FROM t WHERE v > 9", 12),
    ("SELECT b FROM t WHERE u > 0.5", 4),
]


@pytest.mark.parametrize("sql,row_bytes", PROJECT_CASES)
def test_filtered_projections_take_the_shard_route(ref_mesh, sql, row_bytes):
    t = _table()
    run = _Run(*_dbs(t, ref_mesh), sql)
    assert run.ops == ["sharded_project"]
    for g, si, ri in run.columns():
        _exact(g, si, ri)
    # Only the evaluated items of the matching rows move.
    assert run.nbytes == row_bytes * int(_mask(t, sql).sum())
    assert len(run.got[0]) == int(_mask(t, sql).sum())


SORT_CASES = [
    "SELECT w, u FROM t ORDER BY w",
    "SELECT w, u FROM t ORDER BY w DESC LIMIT 10 OFFSET 5",
    "SELECT u FROM t WHERE u > 0 ORDER BY w, a DESC LIMIT 20",
    "SELECT a, b FROM t WHERE v > 2 ORDER BY a DESC, w LIMIT 300 OFFSET 7",
    "SELECT v FROM t ORDER BY v DESC",
]


@pytest.mark.parametrize("sql", SORT_CASES)
def test_full_sorts_keep_row_order_on_ties(ref_mesh, sql):
    """Ties (``w`` holds three values) keep row order: each shard's rows
    gather in shard-major order and one stable sort finishes; under a
    LIMIT each shard ships at most LIMIT + OFFSET rows."""
    t = _table(nan="ORDER BY v" in sql)
    run = _Run(*_dbs(t, ref_mesh), sql)
    assert run.ops == ["sharded_project"]
    for g, si, ri in run.columns():
        _exact(g, si, ri)
    if "LIMIT" in sql:
        words = sql.split()
        keep = int(words[words.index("LIMIT") + 1])
        if "OFFSET" in words:
            keep += int(words[words.index("OFFSET") + 1])
        assert len(run.got[0]) <= keep
        # The items and the ORDER BY operands outside the select list.
        assert run.nbytes <= N_SHARDS * keep * 4 * 4


# --- "dedupe": DISTINCT and COUNT(DISTINCT) -------------------------------


# (statement, K2 launches: once a shard for a stats-bounded integral
# item of up to 65536 slots, dense or midrange).
DISTINCT_CASES = [
    ("SELECT DISTINCT a FROM t", N_SHARDS),
    ("SELECT DISTINCT a FROM t WHERE u > 0 ORDER BY a DESC", N_SHARDS),
    ("SELECT DISTINCT k FROM t", N_SHARDS),
    ("SELECT DISTINCT k FROM t WHERE v > 3 ORDER BY k DESC", N_SHARDS),
    ("SELECT DISTINCT b FROM t ORDER BY b DESC", N_SHARDS),
    ("SELECT DISTINCT v FROM t", 0),
]


@pytest.mark.parametrize("sql,k2", DISTINCT_CASES)
def test_distinct_dedupes_on_every_shard(ref_mesh, sql, k2):
    t = _table(nan=True)
    ref, port, single = _dbs(t, ref_mesh)
    # The reference raises on a DISTINCT of 4097..65536 slots (ROADMAP
    # queue 3): NumPy stands in for it on ``k``.
    midrange = sql.split()[2] == "k"
    run = _Run(None if midrange else ref, port, single, sql)
    assert "sharded_distinct" in run.ops and "mesh_gather" not in run.ops
    assert run.ops.count("K2 group_hist (plain)") == k2
    _exact(run.got[0], run.s[0], run.r[0])
    if midrange:
        want = np.unique(t["k"][_mask(t, sql)])
        _exact(run.got[0], want[::-1] if "DESC" in sql else want, want[::-1]
               if "DESC" in sql else want)
    # Each shard ships at most its distinct values, 4 bytes each.
    assert run.nbytes <= 4 * N_SHARDS * len(run.got[0])


COUNT_DISTINCT_CASES = [
    "SELECT COUNT(DISTINCT b) FROM t",
    "SELECT COUNT(DISTINCT v) FROM t WHERE u > 0",
    "SELECT a, COUNT(DISTINCT b) FROM t GROUP BY a ORDER BY a",
    "SELECT a, w, COUNT(DISTINCT k) FROM t WHERE u > 0.3 GROUP BY a, w "
    "ORDER BY a, w",
]


@pytest.mark.parametrize("sql", COUNT_DISTINCT_CASES)
def test_count_distinct_dedupes_on_every_shard(ref_mesh, sql):
    t = _table(nan=True)
    run = _Run(*_dbs(t, ref_mesh), sql)
    grouped = "GROUP BY" in sql
    assert ("sharded_count_distinct" if grouped
            else "sharded_global_agg") in run.ops
    assert "mesh_gather" not in run.ops
    for g, si, ri in run.columns():
        _exact(g, si, ri)


def test_count_distinct_shuffles_the_pairs_to_owner_shards(ref_mesh):
    """No device gathers every shard's pairs: each unique (group, value)
    pair crosses the mesh once, to the shard its hash names, and only
    the per-group counts are summed."""
    t = _table()
    sql = "SELECT a, COUNT(DISTINCT b) FROM t GROUP BY a ORDER BY a"
    run = _Run(*_dbs(t, ref_mesh), sql)
    for g, si, ri in run.columns():
        _exact(g, si, ri)
    shard_pairs = sum(
        np.unique(t["a"][i:i + SHARD] * 1000 + t["b"][i:i + SHARD]).size
        for i in range(0, N, SHARD))
    # LocalComm counts an all_to_all's bytes over every shard, divided by
    # the shard count (a device's share).
    assert ("all_to_all", 8 * shard_pairs // N_SHARDS) in run.collectives
    assert ("psum", 8 * 6) in run.collectives


def test_distinct_statistics_read_a_shard_in_slices(ref_mesh, monkeypatch):
    """The distinct statistics read a shard a slice of rows at a time:
    with slices of 37 rows every result, and the merged registers, stay
    the single device's."""
    from warpdb_tpu_torch.parallel import project

    monkeypatch.setattr(project, "_SLICE_ROWS", 37)
    t = _table(nan=True)
    ref, port, single = _dbs(t, ref_mesh)
    for sql in ("SELECT a, COUNT(DISTINCT b), APPROX_COUNT_DISTINCT(k) "
                "FROM t WHERE u > 0.1 GROUP BY a ORDER BY a",
                "SELECT COUNT(DISTINCT v), APPROX_COUNT_DISTINCT(b) FROM t "
                "WHERE u > 0"):
        run = _Run(ref, port, single, sql)
        for g, si in zip(run.got, run.s):
            np.testing.assert_array_equal(g, si)
    sql = "SELECT a, APPROX_COUNT_DISTINCT(k) FROM t GROUP BY a"
    np.testing.assert_array_equal(_registers(port, sql),
                                  _registers(single, sql))


# --- "registers": APPROX_COUNT_DISTINCT -----------------------------------


def _registers(db, sql):
    """The u8 registers the grouped path merges for ``sql`` (its partial
    with ``final=False``, the form a stream merges)."""
    from warpdb_tpu_torch.engine import group_exec
    from warpdb_tpu_torch.engine.executor import _bind_query_strings
    from warpdb_tpu_torch.frontend import parse_query_text
    from warpdb_tpu_torch.frontend.ast import unalias

    q = _bind_query_strings(parse_query_text(sql), db.table)
    items = [unalias(s) for s in q.select_list]
    plan = group_exec._grouped_plan(q, items, table=db.table)
    res = group_exec._grouped_partials(q, db.table, plan, final=False)
    (spec,) = plan["cd_specs"]
    return res.dcounts[spec.key]


HLL_CASES = [
    ("SELECT APPROX_COUNT_DISTINCT(k) FROM t WHERE u > 0", None),
    ("SELECT a, APPROX_COUNT_DISTINCT(k) FROM t GROUP BY a ORDER BY a", 6),
    ("SELECT a, w, APPROX_COUNT_DISTINCT(v) FROM t WHERE u > 0.2 "
     "GROUP BY a, w ORDER BY a, w", 18),
]


@pytest.mark.parametrize("sql,groups", HLL_CASES)
def test_approx_count_distinct_merges_registers(ref_mesh, sql, groups):
    t = _table(nan=True)
    ref, port, single = _dbs(t, ref_mesh)
    run = _Run(ref, port, single, sql)
    assert "mesh_gather" not in run.ops
    regs_bytes = N_SHARDS * (groups or 1) * 4096
    assert ("all_gather", regs_bytes) in run.collectives
    if groups is None:
        assert run.ops == ["sharded_global_agg"]
    else:
        assert "sharded_hll" in run.ops
        # A max is order-free: the merged registers are the single
        # device's bit for bit.
        np.testing.assert_array_equal(_registers(port, sql),
                                      _registers(single, sql))
    for g, si, ri in zip(run.got[:-1], run.s[:-1], run.r[:-1]):
        _exact(g, si, ri)
    np.testing.assert_array_equal(run.got[-1], run.s[-1])
    # The reference rounds the estimate's last bit its own way.
    np.testing.assert_allclose(run.got[-1], run.r[-1], rtol=1e-6)


# --- the gather route: MEDIAN, ordered windows ----------------------------


MEDIAN_CASES = [
    "SELECT MEDIAN(u) FROM t",
    "SELECT MEDIAN(v) FROM t WHERE u > 0",
    "SELECT PERCENTILE(u, 0.9) FROM t WHERE a > 2",
    # No matching row: the single-device value, read from the first row.
    "SELECT MEDIAN(u) FROM t WHERE v > 11",
    "SELECT a, MEDIAN(v) FROM t WHERE u > 0 GROUP BY a ORDER BY a",
]


@pytest.mark.parametrize("sql", MEDIAN_CASES)
def test_median_gathers_one_compacted_column(ref_mesh, sql):
    t = _table()
    run = _Run(*_dbs(t, ref_mesh), sql)
    for g, si in zip(run.got, run.s):
        np.testing.assert_array_equal(_f64(g), _f64(si))
    if "v > 11" not in sql:
        for g, ri in zip(run.got, run.r):
            np.testing.assert_allclose(_f64(g), _f64(ri), rtol=1e-6)
    keep = _mask(t, sql).sum()
    if "GROUP BY" in sql:
        # The key and the value column of the rows WHERE keeps.
        assert "mesh_gather" in run.ops
        assert ("all_gather", 8 * keep) in run.collectives
    else:
        assert run.ops == ["sharded_global_agg"]
        assert ("all_gather", 4 * keep) in run.collectives


def test_an_ordered_window_gathers_only_what_it_reads(ref_mesh):
    """An ordered window on a table with unread columns (``b``, ``k``,
    ``w``) gathers its partition and order columns, of the rows WHERE
    keeps; the WHERE's own column stays on the shards."""
    t = _table()
    sql = "SELECT RANK() OVER (PARTITION BY a ORDER BY u) FROM t WHERE v > 4"
    run = _Run(*_dbs(t, ref_mesh), sql)
    assert run.ops == ["mesh_gather", "window"]
    keep = int((t["v"] > np.float32(4)).sum())
    assert run.collectives == (("all_gather", 2 * 4 * keep),)
    _exact(run.got[0], run.s[0], run.r[0])


def test_a_cross_join_gathers_the_columns_it_reads(ref_mesh):
    """CROSS keeps the gather route: each side moves only the columns
    the statement reads, then the joined rows take the shard route."""
    t = _table()
    dim = {"x": np.arange(3, dtype=np.float32),
           "y": np.array([10.0, 20.0, 30.0], np.float32)}
    sql = "SELECT a, d.y FROM t CROSS JOIN d WHERE u > 0.95"
    ref, port, single = _dbs(t, ref_mesh, {"d": dim})
    run = _Run(ref, port, single, sql)
    for g, si, ri in run.columns():
        _exact(g, si, ri)
    gathers = [b for op, b in run.collectives if op == "all_gather"]
    rows = N * 3
    keep = int((t["u"] > np.float32(0.95)).sum()) * 3
    # a and u of the probe, y of the build; then a and y of the kept
    # joined rows.
    assert gathers == [2 * 4 * N, 4 * 3, 2 * 4 * keep], (gathers, rows)


def test_the_multi_device_paths_of_one_facade_agree(ref_mesh):
    """Every new route on one facade, once more through
    ``query_sql`` (the first column) against one device."""
    t = _table()
    port = PortDB(HostTable.from_dict(t), mesh=MESH)
    single = PortDB(HostTable.from_dict(t), device="cpu")
    for sql in ("SELECT SUM(u) FROM t WHERE u > 0",
                "SELECT DISTINCT w FROM t",
                "SELECT u FROM t WHERE u > 0.99",
                "SELECT COUNT(DISTINCT a) FROM t"):
        np.testing.assert_allclose(port.query_sql(sql),
                                   single.query_sql(sql), rtol=1e-6)
