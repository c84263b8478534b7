"""The port's multi-device execution against the reference's.

Every mesh test of the reference (``tests/test_parallel.py``) has a
differential counterpart here: the same seeded NumPy data goes through
the reference on its 8-way virtual CPU mesh (``tests/conftest.py``),
through the port on an 8-shard CPU mesh
(``DataMesh(["cpu"] * 8)``) and through the port on one device.

Tolerances: keys, counts, codes and row order exactly; float sums
within rtol 1e-4 of the reference (which merges partials in f32).
Against the port's single-device result, a mesh sum must lie within
rtol 1e-6 of the float64 NumPy sum (the shards add in float64, or
through K2's plain version, which adds in float64 too, and the partials
merge in float64), and within that bound plus the single-device result's own
distance from float64 of the single-device value: the single-device
path adds a small group's rows in one f32 chain, which at 2000 rows a
group strays up to 1.6e-6 from float64 (measured on this data).
Everything else (MIN, MAX, COUNT, top-k values, window values over f64
slot tables) equals the single-device result exactly.
"""

import numpy as np
import pytest
import torch

from warpdb_tpu import WarpDB as RefDB
from warpdb_tpu.frontend import parse_expression_text as ref_expr
from warpdb_tpu.storage import HostTable as RefHost
from warpdb_tpu_torch import WarpDB as PortDB
from warpdb_tpu_torch import errors
from warpdb_tpu_torch.frontend import parse_expression, tokenize
from warpdb_tpu_torch.parallel import DataMesh, ShardedTable
from warpdb_tpu_torch.storage import HostTable
from warpdb_tpu_torch.utils.metrics import last

N_SHARDS = 8
MESH = DataMesh(["cpu"] * N_SHARDS)


@pytest.fixture(autouse=True)
def reference_routes(monkeypatch):
    """The reference's mesh GROUP BY thresholds (the merge up to 4096 key
    tuples, the combine up to 16384 a shard; the H100's defaults lie
    above these tables' key spaces), so that the routes here are the
    reference's."""
    from warpdb_tpu_torch.config import get_config
    from warpdb_tpu_torch.parallel import shuffle

    monkeypatch.setattr(get_config(), "distributed_small_keys", 4096)
    monkeypatch.setattr(shuffle, "COMBINE_CAP", 16384)


@pytest.fixture(scope="module")
def ref_mesh():
    import jax

    from warpdb_tpu.parallel import data_mesh

    assert len(jax.devices()) == N_SHARDS
    return data_mesh()


def expr(text):
    return parse_expression(tokenize(text))


def _f64(x):
    return np.asarray(x, np.float64)


def _sums(mesh, single, ref, truth):
    """Sum columns: the reference within 1e-4; float64 NumPy within 1e-6
    and the single-device result within that plus its own distance from
    float64 (module docstring)."""
    mesh, single, ref = _f64(mesh), _f64(single), _f64(ref)
    assert mesh.shape == single.shape == ref.shape
    np.testing.assert_allclose(mesh, ref, rtol=1e-4)
    truth = _f64(truth)
    np.testing.assert_allclose(mesh, truth, rtol=1e-6)
    bound = 1e-6 * np.abs(truth) + np.abs(single - truth)
    assert np.all(np.abs(mesh - single) <= bound)


def _exact(mesh, single, ref):
    np.testing.assert_array_equal(_f64(mesh), _f64(single))
    np.testing.assert_array_equal(_f64(mesh), _f64(ref))


def _dbs(cols: dict, ref_mesh, dims: dict = None, distribute=False):
    """(reference on its mesh, port on MESH, port on one device)."""
    if distribute:
        ref = RefDB(RefHost.from_dict(cols)).distribute(ref_mesh)
        port = PortDB(HostTable.from_dict(cols), device="cpu").distribute(
            MESH)
    else:
        ref = RefDB(RefHost.from_dict(cols), mesh=ref_mesh)
        port = PortDB(HostTable.from_dict(cols), mesh=MESH)
    single = PortDB(HostTable.from_dict(cols), device="cpu")
    for name, d in (dims or {}).items():
        ref.register_table(name, RefHost.from_dict(d))
        port.register_table(name, HostTable.from_dict(d))
        single.register_table(name, HostTable.from_dict(d))
    return ref, port, single


def _ops() -> list:
    return [name for name, _hit in last().operators]


@pytest.fixture(scope="module")
def big_table():
    rng = np.random.default_rng(7)
    n = 100_000
    return {
        "price": rng.uniform(0, 100, n).astype(np.float32),
        "quantity": rng.integers(0, 50, n).astype(np.float32),
    }


def _group_truth(keys, vals, mask=None):
    keys = np.asarray(keys)
    vals = np.asarray(vals, np.float64)
    if mask is not None:
        keys, vals = keys[mask], vals[mask]
    uniq = np.unique(keys)
    return uniq, np.array([vals[keys == u].sum() for u in uniq])


# --- reference: test_sharded_scan_* / test_query_sharded_api ---------------


def test_sharded_scan_matches_oracle(ref_mesh, big_table):
    from warpdb_tpu.parallel import run_expression_sharded as ref_run
    from warpdb_tpu.parallel import shard_table as ref_shard
    from warpdb_tpu_torch.engine.executor import run_expression
    from warpdb_tpu_torch.parallel import run_expression_sharded, shard_table
    from warpdb_tpu_torch.storage import DeviceTable

    got = run_expression_sharded(shard_table(HostTable.from_dict(big_table),
                                             MESH),
                                 expr("price * quantity"), expr("price > 50"),
                                 mesh=MESH)
    ref = ref_run(ref_shard(RefHost.from_dict(big_table), ref_mesh),
                  ref_expr("price * quantity"), ref_expr("price > 50"),
                  mesh=ref_mesh)
    single = run_expression(DeviceTable.from_host(
        HostTable.from_dict(big_table), device="cpu"),
        expr("price * quantity"), expr("price > 50"))
    _exact(got, single, ref)
    p, q = big_table["price"], big_table["quantity"]
    np.testing.assert_array_equal(got, np.where(p > np.float32(50), p * q, 0))


def test_sharded_scan_is_actually_sharded(big_table):
    from warpdb_tpu_torch.parallel import shard_table

    dt = shard_table(HostTable.from_dict(big_table), MESH)
    assert isinstance(dt, ShardedTable) and len(dt.shards) == N_SHARDS
    assert dt.shard_rows == [len(big_table["price"]) // N_SHARDS] * N_SHARDS
    # Shard-major order is row order; each shard owns its storage.
    joined = torch.cat([s.row_columns()["price"] for s in dt.shards])
    np.testing.assert_array_equal(joined.numpy(), big_table["price"])
    ptrs = {s.columns["price"].data_ptr() for s in dt.shards}
    assert len(ptrs) == N_SHARDS
    with pytest.raises(errors.ExecutionError, match="shards"):
        dt.columns["price"]


def test_query_sharded_api(ref_mesh, big_table):
    port = PortDB(HostTable.from_dict(big_table), device="cpu")
    ref = RefDB(RefHost.from_dict(big_table))
    got = port.query_sharded("price + quantity", mesh=MESH)
    _exact(got, port.query("price + quantity"),
           ref.query_sharded("price + quantity", mesh=ref_mesh))
    # query_multi_gpu is the reference's name; a one-shard CPU mesh (the
    # default of a CPU facade) runs the single-device path.
    _exact(port.query_multi_gpu("price + quantity"),
           port.query("price + quantity"),
           ref.query_sharded("price + quantity", mesh=ref_mesh))


# --- reference: test_distributed_group_by ---------------------------------


def test_distributed_group_by(ref_mesh, big_table):
    from warpdb_tpu.parallel.sharded import run_grouped_sharded as ref_group
    from warpdb_tpu.parallel import shard_table as ref_shard
    from warpdb_tpu_torch.parallel import run_grouped_sharded, shard_table

    gp = run_grouped_sharded([expr("quantity")], [expr("price")], None,
                             shard_table(HostTable.from_dict(big_table),
                                         MESH))
    rk, rc, rv, rng_ = ref_group([ref_expr("quantity")], [ref_expr("price")],
                                 None, ref_shard(RefHost.from_dict(big_table),
                                                 ref_mesh),
                                 capacity=128, mesh=ref_mesh)
    ng = int(rng_)
    assert gp.num_groups == ng
    np.testing.assert_array_equal(gp.keys[0].numpy(), np.asarray(rk[0])[:ng])
    np.testing.assert_array_equal(gp.counts.numpy(), np.asarray(rc)[:ng])
    single = PortDB(HostTable.from_dict(big_table), device="cpu")
    s = single.query_sql_table("SELECT quantity, COUNT(*) AS c, SUM(price) "
                               "AS s FROM t GROUP BY quantity")
    np.testing.assert_array_equal(gp.counts.numpy(), s["c"])
    uniq, truth = _group_truth(big_table["quantity"], big_table["price"])
    np.testing.assert_array_equal(gp.keys[0].numpy(), uniq)
    _sums(gp.sums[0].numpy(), s["s"], np.asarray(rv[0][0])[:ng],
          truth)


# --- reference: test_streaming_csv_multi_device / _preserves_row_order ----


def _write(path, header, rows):
    with open(path, "w") as f:
        f.write(header + "\n")
        f.writelines(rows)
    return str(path)


def test_streaming_csv_multi_device(ref_mesh, tmp_path):
    rows = 50_000
    path = _write(tmp_path / "big.csv", "price,quantity",
                  (f"{i % 97}.25,{i % 11}\n" for i in range(rows)))
    got = PortDB.query_streaming_csv(path, "price * quantity",
                                     rows_per_chunk=12_000, mesh=MESH)
    ref = RefDB.query_streaming_csv(path, "price * quantity",
                                    rows_per_chunk=12_000, mesh=ref_mesh)
    single = PortDB.query_streaming_csv(path, "price * quantity",
                                        rows_per_chunk=12_000, device="cpu")
    _exact(got, single, ref)
    assert len(got) == rows


def test_streaming_preserves_row_order(ref_mesh, tmp_path):
    n = 5000
    path = _write(tmp_path / "ordered.csv", "x",
                  (f"{i}\n" for i in range(n)))
    got = PortDB.query_streaming_csv(path, "x + 0", rows_per_chunk=777,
                                     mesh=MESH)
    ref = RefDB.query_streaming_csv(path, "x + 0", rows_per_chunk=777,
                                    mesh=ref_mesh)
    _exact(got, np.arange(n, dtype=np.float32), ref)


def test_streaming_sql_with_a_mesh(ref_mesh, tmp_path):
    rng = np.random.default_rng(3)
    n = 3000
    q = rng.integers(0, 7, n)
    p = np.round(rng.uniform(0, 100, n), 2)
    path = _write(tmp_path / "s.csv", "q,p",
                  (f"{a},{b:.2f}\n" for a, b in zip(q, p)))
    sql = "SELECT q, COUNT(*) AS c, SUM(p) AS s, MAX(p) AS m FROM t GROUP BY q"
    got = PortDB.query_streaming_sql(path, sql, rows_per_chunk=500,
                                     mesh=MESH)
    ref = RefDB.query_streaming_sql(path, sql, rows_per_chunk=500,
                                    mesh=ref_mesh)
    single = PortDB.query_streaming_sql(path, sql, rows_per_chunk=500,
                                        device="cpu")
    assert list(got) == list(ref) == list(single)
    for c in ("q", "c", "m"):
        _exact(got[c], single[c], ref[c])
    _sums(got["s"], single["s"], ref["s"],
          _group_truth(q, p.astype(np.float32))[1])


# --- reference: test_query_sql_distributed_* / test_shuffle_group_having --


def test_query_sql_distributed_small_keys(ref_mesh, big_table):
    ref, port, single = _dbs(big_table, ref_mesh)
    sql = "SELECT SUM(price) FROM t GROUP BY quantity ORDER BY quantity ASC"
    got = port.query_sql(sql)
    # Each shard's dense partial table: K2 (SUM only).
    assert _ops() == ["sharded_group"] + ["K2 group_hist (plain)"] * N_SHARDS
    assert [c[0] for c in last().collectives] == ["all_gather"]
    _sums(got, single.query_sql(sql), ref.query_sql(sql),
          _group_truth(big_table["quantity"], big_table["price"])[1])


def test_query_sql_distributed_shuffle(ref_mesh):
    rng = np.random.default_rng(11)
    n = 60_000
    table = {"price": rng.uniform(0, 10, n).astype(np.float32),
             "k": rng.integers(0, 20_000, n).astype(np.float32)}
    ref, port, single = _dbs(table, ref_mesh)
    sql = "SELECT k, SUM(price) AS s FROM t GROUP BY k ORDER BY k ASC"
    got = port.query_sql_table(sql)
    assert "combine_shuffle_group" in _ops()
    s, r = single.query_sql_table(sql), ref.query_sql_table(sql)
    _exact(got["k"], s["k"], r["k"])
    _sums(got["s"], s["s"], r["s"],
          _group_truth(table["k"], table["price"])[1])


def test_shuffle_group_having(ref_mesh):
    rng = np.random.default_rng(13)
    n = 30_000
    table = {"price": rng.uniform(0, 10, n).astype(np.float32),
             "k": rng.integers(0, 8_000, n).astype(np.float32)}
    ref, port, single = _dbs(table, ref_mesh)
    sql = ("SELECT COUNT(price) FROM t GROUP BY k HAVING COUNT(price) > 6 "
           "ORDER BY k ASC")
    _exact(port.query_sql(sql), single.query_sql(sql), ref.query_sql(sql))


def test_distribute_method(ref_mesh, big_table):
    ref, port, single = _dbs(big_table, ref_mesh, distribute=True)
    assert isinstance(port.table, ShardedTable)
    assert port.mesh is MESH and port.table.mesh == MESH
    sql = "SELECT MAX(price) FROM t"
    got = port.query_sql(sql)
    # The partials route: a max a shard crosses the mesh, no column.
    assert _ops() == ["sharded_global_agg"]
    assert last().collectives == (("all_gather", 4 * N_SHARDS),)
    _exact(got, single.query_sql(sql), ref.query_sql(sql))


# --- reference: test_distributed_join[_duplicates] ------------------------


def _pairs(cols: dict) -> list:
    return sorted(zip(*(np.asarray(v, np.float64).tolist()
                        for v in cols.values())))


def test_distributed_join(ref_mesh):
    from warpdb_tpu.parallel.dist_join import distributed_join as ref_join
    from warpdb_tpu.parallel.sharded import shard_table as ref_shard
    from warpdb_tpu_torch.parallel import distributed_join, shard_table

    rng = np.random.default_rng(21)
    nl = 40_000
    lk = rng.integers(0, 5000, nl).astype(np.float32)
    lv = rng.uniform(0, 10, nl).astype(np.float32)
    rk = np.arange(5000, dtype=np.float32)
    rv = rng.uniform(0, 1, 5000).astype(np.float32)
    left, right = {"k": lk, "v": lv}, {"k": rk, "w": rv}
    got = distributed_join(shard_table(HostTable.from_dict(left), MESH),
                           shard_table(HostTable.from_dict(right), MESH),
                           "k", "k", ["k", "v"], ["w"])
    ref = ref_join(ref_shard(RefHost.from_dict(left), ref_mesh),
                   ref_shard(RefHost.from_dict(right), ref_mesh),
                   "k", "k", ["k", "v"], ["w"], mesh=ref_mesh)
    assert list(got) == list(ref) == ["k", "v", "right.w"]
    assert _pairs(got) == _pairs(ref)
    assert len(got["k"]) == nl
    np.testing.assert_array_equal(got["right.w"], rv[got["k"].astype(int)])


def test_distributed_join_duplicates(ref_mesh):
    from warpdb_tpu.parallel.dist_join import distributed_join as ref_join
    from warpdb_tpu.parallel.sharded import shard_table as ref_shard
    from warpdb_tpu_torch.parallel import distributed_join, shard_table

    left = {"k": np.array([1.0, 2.0, 2.0, 3.0] * 100, np.float32),
            "v": np.arange(400, dtype=np.float32)}
    right = {"k": np.array([2.0, 2.0, 3.0], np.float32),
             "w": np.array([10.0, 20.0, 30.0], np.float32)}
    got = distributed_join(shard_table(HostTable.from_dict(left), MESH),
                           shard_table(HostTable.from_dict(right), MESH),
                           "k", "k", ["k"], ["w"])
    ref = ref_join(ref_shard(RefHost.from_dict(left), ref_mesh),
                   ref_shard(RefHost.from_dict(right), ref_mesh),
                   "k", "k", ["k"], ["w"], mesh=ref_mesh)
    assert len(got["k"]) == 500
    assert _pairs(got) == _pairs(ref)


# --- reference: test_combine_shuffle_* ------------------------------------


def test_combine_shuffle_skew_proof(ref_mesh):
    from warpdb_tpu.parallel.shuffle import combine_shuffle_grouped as ref_cs
    from warpdb_tpu.parallel.sharded import shard_table as ref_shard
    from warpdb_tpu_torch.parallel import combine_shuffle_grouped, shard_table

    rng = np.random.default_rng(5)
    n = 40_000
    k = np.where(rng.uniform(size=n) < 0.9, 7.0,
                 rng.integers(0, 5000, n)).astype(np.float32)
    table = {"price": rng.uniform(0, 10, n).astype(np.float32), "k": k}
    res = combine_shuffle_grouped(expr("k"), [expr("price")], None,
                                  shard_table(HostTable.from_dict(table),
                                              MESH))
    ref = ref_cs(ref_expr("k"), [ref_expr("price")], None,
                 ref_shard(RefHost.from_dict(table), ref_mesh),
                 mesh=ref_mesh)
    assert res is not None and ref is not None
    np.testing.assert_array_equal(res.keys[0].numpy(), ref.keys[0])
    np.testing.assert_array_equal(res.counts.numpy(), ref.counts)
    uniq, truth = _group_truth(k, table["price"])
    single = PortDB(HostTable.from_dict(table), device="cpu")
    np.testing.assert_array_equal(res.keys[0].numpy(), uniq)
    _sums(res.sums[0].numpy(),
          single.query_sql("SELECT SUM(price) FROM t GROUP BY k"),
          ref.sums[0], truth)


def test_combine_shuffle_fallback_high_cardinality(ref_mesh):
    from warpdb_tpu.parallel.shuffle import combine_shuffle_grouped as ref_cs
    from warpdb_tpu.parallel.sharded import shard_table as ref_shard
    from warpdb_tpu_torch.parallel import combine_shuffle_grouped, shard_table

    rng = np.random.default_rng(6)
    n = 20_000
    table = {"price": rng.uniform(0, 10, n).astype(np.float32),
             "k": np.arange(n, dtype=np.float32)}
    assert combine_shuffle_grouped(
        expr("k"), [expr("price")], None,
        shard_table(HostTable.from_dict(table), MESH), local_cap=512) is None
    assert ref_cs(ref_expr("k"), [ref_expr("price")], None,
                  ref_shard(RefHost.from_dict(table), ref_mesh),
                  mesh=ref_mesh, local_cap=512, group_cap=512) is None
    # Through SQL, with more distinct keys a shard than the combine's
    # 16384, the row shuffle takes over, every key and count exact.
    n = N_SHARDS * 17_000
    table = {"price": rng.uniform(0, 10, n).astype(np.float32),
             "k": rng.permutation(n).astype(np.float32)}
    ref, port, single = _dbs(table, ref_mesh)
    sql = "SELECT k, COUNT(*), MIN(price) FROM t GROUP BY k"
    got = port.query_sql_table(sql)
    assert "shuffle_group" in _ops()
    s, r = single.query_sql_table(sql), ref.query_sql_table(sql)
    for c in got:
        _exact(got[c], s[c], r[c])


def test_row_shuffle_matches_the_reference_shuffle_variants(ref_mesh):
    """Counterpart of test_shuffle_overlap_variant_matches: the port has
    no overlap variant (an exchange is one blocking call); its row
    shuffle and its combine shuffle both equal the reference's plain and
    overlapped shuffles."""
    import dataclasses

    from warpdb_tpu.config import EngineConfig, get_config, set_config
    from warpdb_tpu.parallel.shuffle import shuffle_grouped as ref_shuffle
    from warpdb_tpu.parallel.sharded import shard_table as ref_shard
    from warpdb_tpu_torch.parallel import (
        combine_shuffle_grouped,
        shard_table,
        shuffle_grouped,
    )

    rng = np.random.default_rng(51)
    n = 40_000
    k = rng.integers(0, 3000, n).astype(np.float32)
    v = rng.uniform(0, 10, n).astype(np.float32)
    table = {"k": k, "v": v}
    rt = ref_shard(RefHost.from_dict(table), ref_mesh)
    base = get_config()
    try:
        plain = ref_shuffle([ref_expr("k")], [ref_expr("v")],
                            ref_expr("v > 2"), rt, mesh=ref_mesh)
        cfg = EngineConfig(**{f.name: getattr(base, f.name)
                              for f in dataclasses.fields(EngineConfig)})
        cfg.shuffle_overlap = True
        set_config(cfg)
        ovl = ref_shuffle([ref_expr("k")], [ref_expr("v")],
                          ref_expr("v > 2"), rt, mesh=ref_mesh)
    finally:
        set_config(base)
    pt = shard_table(HostTable.from_dict(table), MESH)
    rows = shuffle_grouped([expr("k")], [expr("v")], expr("v > 2"), pt)
    comb = combine_shuffle_grouped([expr("k")], [expr("v")], expr("v > 2"),
                                   pt)
    uniq, truth = _group_truth(k, v, v > np.float32(2))
    for got in (rows, comb):
        for ref in (plain, ovl):
            np.testing.assert_array_equal(got.keys[0].numpy(), ref.keys[0])
            np.testing.assert_array_equal(got.counts.numpy(), ref.counts)
            np.testing.assert_array_equal(got.mins[0].numpy(), ref.mins[0])
            np.testing.assert_array_equal(got.maxs[0].numpy(), ref.maxs[0])
            np.testing.assert_allclose(got.sums[0].numpy(), ref.sums[0],
                                       rtol=1e-4)
        np.testing.assert_allclose(got.sums[0].numpy(), truth, rtol=1e-6)
    np.testing.assert_array_equal(rows.keys[0].numpy(), uniq)


@pytest.mark.parametrize("route", ["combine", "row shuffle"])
def test_mesh_group_shards_take_the_single_device_slot_tier(monkeypatch,
                                                             route):
    """A mesh GROUP BY over a midrange key (4097..65536 slots, sums only)
    aggregates each shard's rows, or each shard's rows after the row
    shuffle, through the single-device slot tier: kernel K2 (its plain
    version on the CPU) once a shard, with keys, counts and sums equal
    to the single-device result within the module's bounds."""
    from warpdb_tpu_torch.ops import aggregate
    from warpdb_tpu_torch.parallel import shard_table, shuffle_grouped

    calls = []
    k2 = aggregate.group_counts_sums

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return k2(*a, **kw)

    monkeypatch.setattr(aggregate, "group_counts_sums", counted)
    rng = np.random.default_rng(71)
    n = 60_000
    table = {"price": rng.uniform(0, 10, n).astype(np.float32),
             "k": rng.integers(0, 20_000, n).astype(np.int32)}
    uniq, truth = _group_truth(table["k"], table["price"])
    single = PortDB(HostTable.from_dict(table), device="cpu")
    want = single.query_sql_table(
        "SELECT k, COUNT(*) AS c, SUM(price) AS s FROM t GROUP BY k")
    calls.clear()
    if route == "combine":
        port = PortDB(HostTable.from_dict(table), mesh=MESH)
        got = port.query_sql_table(
            "SELECT k, COUNT(*) AS c, SUM(price) AS s FROM t GROUP BY k")
        assert "combine_shuffle_group" in _ops()
        keys, counts, sums = got["k"], got["c"], got["s"]
    else:
        gp = shuffle_grouped([expr("k")], [expr("price")], None,
                             shard_table(HostTable.from_dict(table), MESH),
                             need=("sum",))
        keys, counts, sums = (gp.keys[0].numpy(), gp.counts.numpy(),
                              gp.sums[0].numpy())
    assert len(calls) == N_SHARDS
    assert sum(calls) == n
    np.testing.assert_array_equal(keys, uniq)
    np.testing.assert_array_equal(keys, want["k"])
    np.testing.assert_array_equal(counts, want["c"])
    np.testing.assert_allclose(_f64(sums), truth, rtol=1e-6)
    bound = 1e-6 * np.abs(truth) + np.abs(_f64(want["s"]) - truth)
    assert np.all(np.abs(_f64(sums) - _f64(want["s"])) <= bound)


def test_query_sql_distributed_combine_min_max(ref_mesh):
    rng = np.random.default_rng(14)
    n = 25_000
    table = {"price": rng.uniform(-5, 10, n).astype(np.float32),
             "k": rng.integers(0, 6_000, n).astype(np.float32)}
    ref, port, single = _dbs(table, ref_mesh)
    for sql in ("SELECT MIN(price) FROM t GROUP BY k ORDER BY k ASC",
                "SELECT MAX(price) FROM t GROUP BY k ORDER BY k ASC"):
        _exact(port.query_sql(sql), single.query_sql(sql), ref.query_sql(sql))


# --- reference: test_distributed_topk -------------------------------------


def test_distributed_topk(ref_mesh):
    rng = np.random.default_rng(31)
    n = 40_000
    table = {"price": rng.uniform(0, 1000, n).astype(np.float32),
             "q": rng.integers(0, 9, n).astype(np.float32)}
    ref, port, single = _dbs(table, ref_mesh)
    for sql in ("SELECT price FROM t WHERE q > 3 ORDER BY price DESC LIMIT 12",
                "SELECT price FROM t ORDER BY price ASC LIMIT 7 OFFSET 2"):
        got = port.query_sql(sql)
        ops = _ops()
        assert "sharded_topk" in ops
        # K1 (its plain version here) once a shard, not for the finish.
        assert ops.count("K1 topk (plain)") == N_SHARDS
        _exact(got, single.query_sql(sql), ref.query_sql(sql))


def test_distributed_topk_counts_matches_not_finite_values():
    """Validity comes from the per-shard match counts: real infinities
    survive and a shard with fewer matches than k adds no sentinel."""
    from warpdb_tpu_torch.parallel import run_topk_sharded, shard_table

    price = np.arange(64, dtype=np.float32)
    price[5] = np.inf
    table = shard_table(HostTable.from_dict({"price": price}), MESH)
    top, total = run_topk_sharded(expr("price"), expr("price > 60"), table,
                                  16, False)
    assert total == 4
    np.testing.assert_array_equal(top[:4], [np.inf, 63, 62, 61])
    assert np.all(top[4:] == -np.inf)


# --- reference: test_mesh_multi_key_group[_by_distributes] ----------------


def test_mesh_multi_key_group(ref_mesh):
    rng = np.random.default_rng(41)
    n = 20_000
    table = {"a": rng.integers(0, 4, n).astype(np.float32),
             "b": rng.integers(0, 3, n).astype(np.float32),
             "v": rng.uniform(0, 10, n).astype(np.float32)}
    ref, port, single = _dbs(table, ref_mesh)
    sql = ("SELECT a, b, SUM(v) AS s FROM t GROUP BY a, b "
           "ORDER BY a ASC, b ASC")
    got = port.query_sql_table(sql)
    assert _ops() == ["sharded_group"]
    s, r = single.query_sql_table(sql), ref.query_sql_table(sql)
    _exact(got["a"], s["a"], r["a"])
    _exact(got["b"], s["b"], r["b"])
    pair = table["a"] * 3 + table["b"]
    _sums(got["s"], s["s"], r["s"], _group_truth(pair, table["v"])[1])


def test_mesh_multi_key_group_by_distributes(ref_mesh):
    rng = np.random.default_rng(41)
    n = 30_000
    table = {"a": (rng.integers(0, 100_000, n) + 0.5).astype(np.float32),
             "b": rng.integers(0, 4, n).astype(np.float32),
             "v": rng.uniform(0, 10, n).astype(np.float32)}
    ref, port, single = _dbs(table, ref_mesh, distribute=True)
    port.query_sql("SELECT SUM(v) FROM t GROUP BY a, b ORDER BY a ASC")
    assert any("shuffle" in o for o in _ops())
    sql = ("SELECT a, b, SUM(v), COUNT(v) FROM t GROUP BY a, b "
           "ORDER BY a ASC, b ASC")
    got = list(port.query_sql_table(sql).values())
    s = list(single.query_sql_table(sql).values())
    r = list(ref.query_sql_table(sql).values())
    for i in (0, 1, 3):
        _exact(got[i], s[i], r[i])
    pairs = np.unique(np.stack([table["a"], table["b"]], 1), axis=0)
    v64 = table["v"].astype(np.float64)
    truth = [v64[(table["a"] == x) & (table["b"] == y)].sum()
             for x, y in pairs]
    _sums(got[2], s[2], r[2], truth)


# --- reference: test_mesh_join_groupby / test_mesh_sql_join_* -------------


def test_mesh_join_groupby(ref_mesh):
    rng = np.random.default_rng(47)
    n = 16_000
    table = {"k": rng.integers(0, 16, n).astype(np.float32),
             "v": rng.uniform(0, 10, n).astype(np.float32)}
    rates = {"k": np.arange(16, dtype=np.float32),
             "w": rng.uniform(1, 2, 16).astype(np.float32)}
    ref, port, single = _dbs(table, ref_mesh, {"r": rates})
    sql = ("SELECT k, SUM(v) AS s FROM t JOIN r ON k = r.k "
           "WHERE r.w > 1.5 GROUP BY k ORDER BY k ASC")
    got = port.query_sql_table(sql)
    assert "dist_join" in _ops()
    s, r = single.query_sql_table(sql), ref.query_sql_table(sql)
    _exact(got["k"], s["k"], r["k"])
    keep = rates["w"][table["k"].astype(int)] > np.float32(1.5)
    _sums(got["s"], s["s"], r["s"],
          _group_truth(table["k"], table["v"], keep)[1])


def test_mesh_sql_join_routes_distributed(ref_mesh):
    rng = np.random.default_rng(31)
    n = 20_000
    a = rng.integers(0, 40, n).astype(np.float32)
    b = rng.integers(0, 3, n).astype(np.float32)
    p = rng.uniform(0, 10, n).astype(np.float32)
    rw = rng.uniform(0, 1, 120).astype(np.float32)
    dim = {"a": np.repeat(np.arange(40, dtype=np.float32), 3),
           "b": np.tile(np.arange(3, dtype=np.float32), 40), "w": rw}
    ref, port, single = _dbs({"a": a, "b": b, "price": p}, ref_mesh,
                             {"dim": dim}, distribute=True)
    sql = ("SELECT SUM(price * dim.w) FROM t JOIN dim ON a = dim.a AND "
           "b = dim.b GROUP BY a ORDER BY a ASC")
    got = port.query_sql(sql)
    ops = _ops()
    assert "dist_join" in ops and "K3 windowed_expand (plain)" in ops
    w = np.zeros((40, 3), np.float32)
    w[dim["a"].astype(int), dim["b"].astype(int)] = rw
    contrib = p * w[a.astype(int), b.astype(int)]
    _sums(got, single.query_sql(sql), ref.query_sql(sql),
          _group_truth(a, contrib)[1])


def test_mesh_sql_join_string_keys(ref_mesh):
    rng = np.random.default_rng(32)
    n = 5000
    cities = np.array(["ams", "ber", "cdg", "lhr"], dtype=object)
    c = cities[rng.integers(0, 4, n)]
    p = rng.uniform(0, 10, n).astype(np.float32)
    geo = {"city": np.array(["lhr", "zzz", "ams", "ber", "cdg"], dtype=object),
           "lat": np.array([51.5, 0.0, 52.4, 52.5, 49.0], np.float32)}
    ref, port, single = _dbs({"city": c, "price": p}, ref_mesh,
                             {"geo": geo}, distribute=True)
    sql = ("SELECT city, SUM(geo.lat) AS s FROM t JOIN geo ON city = "
           "geo.city GROUP BY city ORDER BY city ASC")
    got = port.query_sql_table(sql)
    s, r = single.query_sql_table(sql), ref.query_sql_table(sql)
    assert got["city"] == s["city"] == r["city"] == ["ams", "ber", "cdg",
                                                     "lhr"]
    lat = dict(zip(geo["city"], geo["lat"].astype(np.float64)))
    _sums(got["s"], s["s"], r["s"],
          [lat[k] * (c == k).sum() for k in sorted(set(c))])


def _row_multiset(t: dict) -> list:
    a = np.stack([np.asarray(v, np.float64) for v in t.values()])
    a = np.where(np.isnan(a), 1e30, a)
    return sorted(map(tuple, a.T))


def test_mesh_sql_outer_joins_match_single_device(ref_mesh):
    rng = np.random.default_rng(33)
    n = 8192
    table = {"k": rng.integers(0, 30, n).astype(np.float32),
             "p": rng.uniform(0, 10, n).astype(np.float32)}
    d = {"k": np.arange(20, 50, dtype=np.float32),
         "w": rng.uniform(0, 1, 30).astype(np.float32)}
    ref, port, single = _dbs(table, ref_mesh, {"d": d}, distribute=True)
    for kind in ("RIGHT", "FULL", "LEFT", "INNER"):
        sql = f"SELECT p, d.k, d.w FROM t {kind} JOIN d ON k = d.k"
        got = _row_multiset(port.query_sql_table(sql))
        assert got == _row_multiset(single.query_sql_table(sql)), kind
        assert got == _row_multiset(ref.query_sql_table(sql)), kind
    assert isinstance(port._catalog["d"], ShardedTable)


def test_mesh_left_join_distributed(ref_mesh):
    rng = np.random.default_rng(81)
    n = 10_000
    k = rng.integers(0, 40, n).astype(np.float32)
    p = rng.uniform(1, 10, n).astype(np.float32)
    dim = {"k": np.arange(20, dtype=np.float32),
           "w": rng.uniform(1, 2, 20).astype(np.float32)}
    ref, port, single = _dbs({"k": k, "price": p}, ref_mesh, {"dim": dim},
                             distribute=True)
    sql = "SELECT COUNT(price) FROM t LEFT JOIN dim ON k = dim.k"
    got = port.query_sql(sql)
    assert "dist_join_left" in _ops()
    _exact(got, single.query_sql(sql), ref.query_sql(sql))
    assert got[0] == n
    sql = ("SELECT SUM(price) FROM t LEFT JOIN dim ON k = dim.k "
           "WHERE dim.w > 0")
    _sums(port.query_sql(sql), single.query_sql(sql), ref.query_sql(sql),
          [p[k < 20].astype(np.float64).sum()])


# --- reference: test_mesh_approx_count_distinct_matches_single_device -----


def test_mesh_approx_count_distinct_matches_single_device(ref_mesh):
    rng = np.random.default_rng(24)
    n = 20_000
    table = {"g": rng.integers(0, 4, n).astype(np.float32),
             "x": rng.integers(0, 3_000, n).astype(np.float32)}
    ref, port, single = _dbs(table, ref_mesh)
    sql = ("SELECT g, APPROX_COUNT_DISTINCT(x) AS a FROM t "
           "GROUP BY g ORDER BY g ASC")
    got = port.query_sql_table(sql)
    ops = _ops()
    # The registers route: each shard's (4, 4096) u8 registers, merged
    # by max, after the GROUP BY's merge; no column is gathered.
    assert "sharded_group" in ops and "sharded_hll" in ops
    assert "mesh_gather" not in ops
    assert ("all_gather", N_SHARDS * 4 * 4096) in last().collectives
    s, r = single.query_sql_table(sql), ref.query_sql_table(sql)
    _exact(got["g"], s["g"], r["g"])
    # The estimate is the single-device one; the reference's rounds its
    # last bit differently.
    np.testing.assert_array_equal(got["a"], s["a"])
    np.testing.assert_allclose(got["a"], r["a"], rtol=1e-6)


# --- reference: test_mesh_window_matches_single_device --------------------


@pytest.mark.parametrize("seed", range(5))
def test_mesh_window_matches_single_device(ref_mesh, seed):
    rng = np.random.default_rng(888_000 + seed)
    n = int(rng.integers(500, 6000))
    table = {"g": rng.integers(0, 17, n).astype(np.float32),
             "v": rng.uniform(-5.0, 50.0, n).astype(np.float32)}
    agg = ["SUM", "AVG", "MIN", "MAX", "COUNT"][seed % 5]
    cond = "WHERE v > 10" if seed % 2 else ""
    sql = f"SELECT {agg}(v) OVER (PARTITION BY g) FROM t {cond}"
    ref, port, single = _dbs(table, ref_mesh)
    got = port.query_sql(sql)
    assert _ops() == ["dist_window"]
    assert {c[0] for c in last().collectives} == {
        "pmin" if agg == "MIN" else "pmax" if agg == "MAX" else "psum",
        "all_gather"}
    s, r = single.query_sql(sql), ref.query_sql(sql)
    np.testing.assert_array_equal(got, s)
    np.testing.assert_allclose(_f64(got), _f64(r), rtol=2e-4, atol=1e-3)


# --- reference: test_fuzz_mesh_vs_single_device ---------------------------


def _fuzz_truth(shape: int, agg: str, t: dict, dim: dict, thr):
    """NumPy float64 answers of the fuzz statements (shape 3's per-group
    sums; None where the answer is exact in f32 anyway)."""
    if shape != 2 or agg not in ("SUM", "AVG"):
        return None
    keep = np.ones(len(t["v"]), bool) if thr is None else \
        t["v"] > np.float32(thr)
    k = t["k"][keep].astype(np.int64)
    ok = k < len(dim["w"])
    w = dim["w"][k[ok]].astype(np.float64)
    vals = t["v"][keep][ok].astype(np.float64) * w
    g = t["g"][keep][ok]
    uniq = np.unique(g)
    sums = np.array([vals[g == u].sum() for u in uniq])
    if agg == "AVG":
        sums = sums / np.array([(g == u).sum() for u in uniq])
    return sums


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_mesh_vs_single_device(ref_mesh, seed):
    rng = np.random.default_rng(777_000 + seed)
    n = int(rng.integers(64, 5000))
    nk = int(rng.integers(2, 200))
    t = {"g": rng.integers(0, 6, n).astype(np.float32),
         "k": rng.integers(0, nk + 3, n).astype(np.float32),
         "v": rng.uniform(0.0, 50.0, n).astype(np.float32)}
    dim = {"k": np.arange(nk, dtype=np.float32),
           "w": rng.uniform(0.5, 2.0, nk).astype(np.float32)}
    agg = ["SUM", "AVG", "MIN", "MAX", "COUNT"][int(rng.integers(0, 5))]
    thr = float(f"{rng.uniform(0, 30):.2f}") if rng.uniform() < 0.6 else None
    cond = f"WHERE v > {thr:.2f}" if thr is not None else ""
    shapes = [
        f"SELECT g, {agg}(v) FROM t {cond} GROUP BY g ORDER BY g ASC",
        f"SELECT k, {agg}(v) FROM t {cond} GROUP BY k ORDER BY k ASC LIMIT 8",
        f"SELECT g, {agg}(v * d.w) FROM t JOIN d ON k = d.k {cond} "
        "GROUP BY g ORDER BY g ASC",
        f"SELECT v FROM t {cond} ORDER BY v DESC LIMIT 7",
    ]
    shape = int(rng.integers(0, len(shapes)))
    sql = shapes[shape]
    ref, port, single = _dbs(t, ref_mesh, {"d": dim})
    got = list(port.query_sql_table(sql).values())
    s = list(single.query_sql_table(sql).values())
    r = list(ref.query_sql_table(sql).values())
    assert len(got) == len(s) == len(r)
    for i, (a, b, c) in enumerate(zip(got, s, r)):
        if i == 1 and agg in ("SUM", "AVG") and shape != 3:
            truth = _fuzz_truth(shape, agg, t, dim, thr)
            if truth is None:
                keep = np.ones(n, bool) if thr is None else \
                    t["v"] > np.float32(thr)
                key = t["g"] if shape == 0 else t["k"]
                uniq, truth = _group_truth(key, t["v"], keep)
                if agg == "AVG":
                    truth = truth / np.array([(key[keep] == u).sum()
                                              for u in uniq])
                truth = truth[:len(a)]
            _sums(a, b, c, truth)
        else:
            _exact(a, b, c)


# --- reference: test_mesh_grouping_sets_match_single_device ---------------


def test_mesh_grouping_sets_match_single_device(ref_mesh):
    rng = np.random.default_rng(44)
    n = 8192
    table = {"a": rng.integers(0, 8, n).astype(np.float32),
             "b": rng.integers(0, 4, n).astype(np.float32),
             "v": rng.uniform(0, 10, n).astype(np.float32)}
    ref, port, single = _dbs(table, ref_mesh, distribute=True)
    sql = "SELECT a, b, SUM(v) FROM t GROUP BY ROLLUP(a, b) ORDER BY a, b"
    got = list(port.query_sql_table(sql).values())
    assert "sharded_group" in _ops()
    s = list(single.query_sql_table(sql).values())
    r = list(ref.query_sql_table(sql).values())
    assert len(got[0]) == 32 + 8 + 1
    for i in (0, 1):
        np.testing.assert_array_equal(_f64(got[i]), _f64(s[i]))
        np.testing.assert_array_equal(_f64(got[i]), _f64(r[i]))
    v64 = table["v"].astype(np.float64)
    truth = []
    for x, y in zip(_f64(got[0]), _f64(got[1])):
        m = np.ones(n, bool)
        if not np.isnan(x):
            m &= table["a"] == x
        if not np.isnan(y):
            m &= table["b"] == y
        truth.append(v64[m].sum())
    _sums(got[2], s[2], r[2], truth)


# --- one route decision for execution and EXPLAIN ------------------------


def _win_truth(t):
    q = t["q"].astype(np.int64)
    return np.bincount(q, weights=t["price"].astype(np.float64))[q]


# (statement, what EXPLAIN names, the operator the run records, the
# float64 sums of the last result column, or None where the mesh result
# equals the single-device one exactly).
ROUTE_CASES = [
    ("SELECT price FROM t ORDER BY price DESC LIMIT 5", "DISTRIBUTED: K1",
     "sharded_topk", None),
    ("SELECT price FROM t ORDER BY price DESC", "DISTRIBUTED shard route",
     "sharded_project", None),
    ("SELECT price * 2, q FROM t WHERE price > 9", "DISTRIBUTED shard route",
     "sharded_project", None),
    ("SELECT SUM(price) FROM t WHERE q > 3", "DISTRIBUTED partials",
     "sharded_global_agg",
     lambda t: [t["price"][t["q"] > 3].astype(np.float64).sum()]),
    ("SELECT MAX(price) - MIN(price) FROM t", "DISTRIBUTED partials",
     "sharded_global_agg", None),
    ("SELECT DISTINCT q FROM t ORDER BY q DESC", "DISTRIBUTED dedupe",
     "sharded_distinct", None),
    ("SELECT COUNT(DISTINCT k) FROM t", "DISTRIBUTED dedupe",
     "sharded_global_agg", None),
    ("SELECT q, COUNT(DISTINCT k) FROM t GROUP BY q", "DISTRIBUTED dedupe",
     "sharded_count_distinct", None),
    ("SELECT APPROX_COUNT_DISTINCT(k) FROM t", "DISTRIBUTED registers",
     "sharded_global_agg", None),
    ("SELECT q, APPROX_COUNT_DISTINCT(k) FROM t GROUP BY q",
     "DISTRIBUTED registers", "sharded_hll", None),
    ("SELECT MEDIAN(price) FROM t WHERE q > 3", "gather route",
     "sharded_global_agg", None),
    ("SELECT q, MEDIAN(price) FROM t GROUP BY q", "gather route",
     "mesh_gather", None),
    ("SELECT q, SUM(price) FROM t GROUP BY q", "all_gather merge",
     "sharded_group", lambda t: _group_truth(t["q"], t["price"])[1]),
    ("SELECT k, SUM(price) FROM t GROUP BY k", "map-side combine",
     "combine_shuffle_group", lambda t: _group_truth(t["k"], t["price"])[1]),
    ("SELECT SUM(price) OVER (PARTITION BY q) FROM t",
     "DISTRIBUTED dense partition", "dist_window", _win_truth),
    ("SELECT SUM(price) OVER (PARTITION BY q ORDER BY price) FROM t",
     "gather route", "mesh_gather", None),
]


@pytest.mark.parametrize("sql,plan,op,truth", ROUTE_CASES)
def test_explain_names_the_route_execution_takes(sql, plan, op, truth):
    """``parallel.routes.mesh_route`` decides a sharded table's route for
    the executor and for EXPLAIN alike: the plan names the route whose
    operator the run records, and the result equals the single-device
    one (sums within the module's bounds)."""
    rng = np.random.default_rng(73)
    n = 40_000
    table = {"price": rng.uniform(0, 10, n).astype(np.float32),
             "q": rng.integers(0, 32, n).astype(np.int32),
             "k": rng.integers(0, 20_000, n).astype(np.int32)}
    port = PortDB(HostTable.from_dict(table), mesh=MESH)
    single = PortDB(HostTable.from_dict(table), device="cpu")
    assert plan in port.explain(sql)
    got = list(port.query_sql_table(sql).values())
    assert op in _ops()
    want = list(single.query_sql_table(sql).values())
    exact = got if truth is None else got[:-1]
    for g, w in zip(exact, want):
        np.testing.assert_array_equal(_f64(g), _f64(w))
    if truth is not None:
        t = truth(table)
        np.testing.assert_allclose(_f64(got[-1]), t, rtol=1e-6)
        bound = 1e-6 * np.abs(t) + np.abs(_f64(want[-1]) - t)
        assert np.all(np.abs(_f64(got[-1]) - _f64(want[-1])) <= bound)


# --- the gather route: each GSPMD-only operator of the reference ----------


GATHER_STATEMENTS = [
    "SELECT a, SUM(v) AS s FROM (SELECT a, v FROM t WHERE v > 5) AS x "
    "GROUP BY a ORDER BY a",
    "WITH c AS (SELECT a, MAX(v) AS m FROM t GROUP BY a) "
    "SELECT a, m FROM c ORDER BY m DESC LIMIT 3",
    "SELECT v FROM t WHERE a IN (SELECT a FROM t WHERE v > 9.9) "
    "ORDER BY v LIMIT 5",
    "SELECT a FROM t WHERE v > 9 UNION SELECT b FROM t WHERE v < 1",
    "SELECT a, v FROM t QUALIFY ROW_NUMBER() OVER (PARTITION BY a ORDER BY "
    "v DESC) <= 2 ORDER BY a, v",
    "SELECT DISTINCT b FROM t",
    "SELECT DISTINCT a, b FROM t ORDER BY a, b",
    "SELECT RANK() OVER (PARTITION BY a ORDER BY v) FROM t",
    "SELECT SUM(v) OVER (PARTITION BY a ORDER BY v ROWS BETWEEN 1 "
    "PRECEDING AND CURRENT ROW) FROM t",
    "SELECT v - AVG(v) OVER (PARTITION BY a) AS dev FROM t ORDER BY dev "
    "DESC LIMIT 4",
    "SELECT a, COUNT(DISTINCT b), MEDIAN(v) FROM t GROUP BY a ORDER BY a",
    "SELECT COUNT(*), MIN(v), APPROX_COUNT_DISTINCT(b) FROM t",
    "SELECT a, v FROM t WHERE v > 9.5 ORDER BY a ASC, v DESC",
]


@pytest.mark.parametrize("sql", GATHER_STATEMENTS)
def test_gather_routes_match_the_reference_mesh(ref_mesh, sql):
    rng = np.random.default_rng(45)
    n = 4000
    table = {"a": rng.integers(0, 6, n).astype(np.float32),
             "b": rng.integers(0, 4, n).astype(np.float32),
             "v": rng.uniform(0, 10, n).astype(np.float32)}
    ref, port, single = _dbs(table, ref_mesh)
    got = port.query_sql_table(sql)
    s, r = single.query_sql_table(sql), ref.query_sql_table(sql)
    assert list(got) == list(s) == list(r)
    for c in got:
        a, b, ref_c = _f64(got[c]), _f64(s[c]), _f64(r[c])
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5, err_msg=c)
        np.testing.assert_allclose(a, ref_c, rtol=1e-4, atol=1e-4, err_msg=c)


def test_the_gather_route_is_counted_and_explained():
    rng = np.random.default_rng(46)
    table = {"a": rng.integers(0, 6, 1000).astype(np.float32),
             "v": rng.uniform(0, 10, 1000).astype(np.float32)}
    port = PortDB(HostTable.from_dict(table), mesh=MESH)
    sql = "SELECT RANK() OVER (PARTITION BY a ORDER BY v) FROM t"
    plan = port.explain(sql, analyze=True)
    assert "gather route: the 8 shards all_gather onto cpu first" in plan
    assert "mesh_gather" in plan
    assert last().collectives == (("all_gather", 2 * 4 * 1000),)
    plan = port.explain("SELECT a, SUM(v) FROM t GROUP BY a")
    assert "DISTRIBUTED per-shard partial aggregation + all_gather merge " \
           "(8 shards; 6 key tuples" in plan
    assert "row-sharded over 8 shards (125, 125" in plan


# --- hash_dest, the dry run, meshes, memo keys ----------------------------


def test_hash_dest_equals_the_reference_bit_for_bit():
    import jax.numpy as jnp

    from warpdb_tpu.parallel.shuffle import hash_dest as ref_hash
    from warpdb_tpu_torch.parallel.shuffle import hash_dest

    rng = np.random.default_rng(9)
    f = rng.normal(0, 1e6, 4096).astype(np.float32)
    f[:6] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
    i = rng.integers(-(2**31), 2**31 - 1, 4096).astype(np.int32)
    i[:3] = [0, -1, 2**31 - 1]
    for n in (2, 3, 8, 13):
        for keys in ((f,), (i,), (f, i), (i, f, f)):
            got = hash_dest(tuple(torch.from_numpy(k) for k in keys), n)
            want = ref_hash(tuple(jnp.asarray(k) for k in keys), n)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = hash_dest((torch.from_numpy(f[:4]),), 8).numpy()
    assert got[0] == got[1] and got[2] == got[3]


def test_dryrun_on_eight_cpu_shards():
    from warpdb_tpu_torch.parallel.dryrun import dryrun_multichip

    res = dryrun_multichip(N_SHARDS, "cpu")
    assert res["shards"] == N_SHARDS and res["groups"] == 16
    assert res["window_rows"] == res["matching_rows"]


def test_data_mesh_needs_cuda_or_named_devices(monkeypatch):
    from warpdb_tpu_torch.parallel import data_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(errors.ExecutionError, match="CUDA is not available"):
        data_mesh()
    mesh = data_mesh(n_devices=3, devices=["cpu"] * 8)
    assert mesh.size == 3 and mesh == DataMesh(["cpu"] * 3)
    # A one-shard mesh runs the single-device path.
    db = PortDB("data/test.csv", mesh=data_mesh(devices=["cpu"]))
    assert not isinstance(db.table, ShardedTable)
    assert db.query_sql("SELECT SUM(price) FROM t") == [75.75]


def test_memo_keys_carry_the_mesh_width(ref_mesh):
    """One WarpDB materialises the same CTE and derived table for a
    single-device query, then (after ``distribute``) for a mesh query:
    neither is served the other's entry."""
    from warpdb_tpu_torch.engine.subquery import query_dep_key
    from warpdb_tpu_torch.frontend import parse_query

    rng = np.random.default_rng(47)
    table = {"a": rng.integers(0, 5, 2000).astype(np.float32),
             "v": rng.uniform(0, 10, 2000).astype(np.float32)}
    db = PortDB(HostTable.from_dict(table), device="cpu")
    cte = ("WITH c AS (SELECT a, SUM(v) AS s FROM t GROUP BY a) "
           "SELECT a, s FROM c ORDER BY a")
    derived = ("SELECT a, s FROM (SELECT a, SUM(v) AS s FROM t GROUP BY a) "
               "AS x ORDER BY a")
    single = [db.query_sql_table(q) for q in (cte, derived)]
    assert len(db._cte_memo) == 1
    assert not isinstance(next(iter(db._cte_memo.values())), ShardedTable)
    db.distribute(MESH)
    meshed = [db.query_sql_table(q) for q in (cte, derived)]
    assert len(db._cte_memo) == 2
    kinds = sorted(isinstance(v, ShardedTable)
                   for v in db._cte_memo.values())
    assert kinds == [False, True]
    (derived_tab,) = db.table._subq_memo.values()
    assert isinstance(derived_tab, ShardedTable)
    for a, b in zip(single, meshed):
        assert a["a"] == b["a"]
        np.testing.assert_allclose(a["s"], b["s"], rtol=1e-5)
    # The width itself is in the key: the same relation keyed alone and
    # as a mesh relation differ only there.
    q = parse_query(tokenize("SELECT a FROM t"))
    one = db.table.gather()
    key_mesh = query_dep_key(q, db.table, {})
    key_one = query_dep_key(q, one, {})
    assert key_mesh[-1] == N_SHARDS and key_one[-1] is None
    ref = RefDB(RefHost.from_dict(table), mesh=ref_mesh)
    np.testing.assert_allclose(meshed[0]["s"], ref.query_sql_table(cte)["s"],
                               rtol=1e-4)


def test_register_table_and_ddl_on_a_mesh_shard_the_relation():
    db = PortDB("data/test.csv", mesh=MESH)
    db.register_table("r", HostTable.from_dict(
        {"quantity": np.arange(6, dtype=np.float32),
         "w": np.arange(6, dtype=np.float32)}))
    assert isinstance(db._catalog["r"], ShardedTable)
    db.query_sql("CREATE TABLE agg AS SELECT quantity, SUM(price) AS s "
                 "FROM test GROUP BY quantity")
    assert isinstance(db._catalog["agg"], ShardedTable)
    got = db.query_sql_table("SELECT quantity, s * r.w FROM agg JOIN r ON "
                             "quantity = r.quantity ORDER BY quantity")
    assert got["quantity"] == [2.0, 3.0, 4.0, 5.0]
    np.testing.assert_allclose(list(got.values())[1],
                               [30.5, 31.5, 80.0, 150.0])
