"""Two-process execution of the port over ``torch.distributed`` (gloo on
the CPU, loopback): each rank ingests its ``host_shard_range`` slice,
assembles the job-wide table and runs the distributed GROUP BY, top-k,
string-key SQL, the combine shuffle, a star join and an
APPROX_COUNT_DISTINCT; every rank must return the single-process
result, and the reference's two-process expectations (its worker's
NumPy oracle, ``tests/multihost_worker.py``) must hold.  A global
aggregate, a DISTINCT and a grouped APPROX_COUNT_DISTINCT take the shard
routes (partials, dedupe, registers) on every rank, with the
single-process operators and collective bytes, and no gather.

The ranks run ``_rank_main`` below in subprocesses, each under its own
timeout.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

TOTAL = 6000
WORLD = 2
TIMEOUT_S = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _data() -> dict:
    """The worker's data, from one seed (every rank derives the same)."""
    rng = np.random.default_rng(0)
    price = rng.uniform(0, 100, TOTAL).astype(np.float32)
    k = rng.integers(0, 16, TOTAL).astype(np.float32)
    cities = np.array(["ams", "ber", "cdg", "lhr"], dtype=object)
    city = cities[rng.integers(0, 4, TOTAL)]
    hk = rng.integers(0, 20_000, TOTAL).astype(np.float32)
    qty = rng.integers(0, 16, TOTAL).astype(np.float32)
    return {"price": price, "k": k, "city": city, "hk": hk, "qty": qty}


STATEMENTS = {
    "string_group": "SELECT SUM(price) FROM t WHERE city != 'zzz' "
                    "GROUP BY city ORDER BY city ASC",
    "shuffle_count": "SELECT COUNT(price) FROM t GROUP BY hk "
                     "ORDER BY hk ASC",
    "join_rates": "SELECT SUM(price * rates.rate) FROM t JOIN rates ON "
                  "qty = rates.q GROUP BY qty ORDER BY qty ASC",
    "hll": "SELECT APPROX_COUNT_DISTINCT(hk) FROM t GROUP BY hk "
           "ORDER BY hk ASC LIMIT 3",
}


# Statements of the shard routes, run with ``query_sql_table`` (every
# column), and the operator each must record.
ROUTE_STATEMENTS = {
    "global_agg": ("SELECT COUNT(*), SUM(price), AVG(price), MIN(price), "
                   "MAX(price) FROM t WHERE price > 20",
                   "sharded_global_agg"),
    "distinct": ("SELECT DISTINCT hk FROM t WHERE price > 90 "
                 "ORDER BY hk DESC", "sharded_distinct"),
    "grouped_hll": ("SELECT k, APPROX_COUNT_DISTINCT(hk) FROM t GROUP BY k "
                    "ORDER BY k", "sharded_hll"),
}


def _rates() -> dict:
    return {"q": np.arange(16, dtype=np.float32),
            "rate": (np.arange(16, dtype=np.float32) + 1.0) / 16.0}


def _run(db_of, mesh=None) -> dict:
    """The statements and the direct operators over tables from
    ``db_of(columns)``; returns plain lists."""
    from warpdb_tpu_torch.frontend import parse_expression, tokenize
    from warpdb_tpu_torch.parallel.sharded import (
        run_grouped_sharded,
        run_topk_sharded,
    )
    from warpdb_tpu_torch.storage import HostTable

    def expr(t):
        return parse_expression(tokenize(t))

    out = {}
    db = db_of(["price", "k"])
    gp = run_grouped_sharded([expr("k")], [expr("price")], expr("price > 50"),
                             db.table, mesh=mesh)
    out["group_keys"] = gp.keys[0].cpu().numpy().tolist()
    out["group_counts"] = gp.counts.cpu().numpy().tolist()
    out["group_sums"] = gp.sums[0].cpu().numpy().tolist()
    top, n_match = run_topk_sharded(expr("price"), expr("price > 50"),
                                    db.table, 16, False, mesh=mesh)
    out["topk"] = top[:8].tolist()
    out["topk_matches"] = n_match
    for name, cols in (("string_group", ["price", "city"]),
                       ("shuffle_count", ["price", "hk"]),
                       ("join_rates", ["price", "qty"]),
                       ("hll", ["price", "hk"])):
        db = db_of(cols)
        if name == "join_rates":
            db.register_table("rates", HostTable.from_dict(_rates()))
        out[name] = np.asarray(db.query_sql(STATEMENTS[name]),
                               np.float64).tolist()
    from warpdb_tpu_torch.utils.metrics import last

    db = db_of(["price", "k", "hk"])
    for name, (sql, _op) in ROUTE_STATEMENTS.items():
        got = db.query_sql_table(sql)
        out[name] = [np.asarray(c, np.float64).tolist()
                     for c in got.values()]
        out[name + "_ops"] = [o for o, _h in last().operators]
        out[name + "_collectives"] = [list(c) for c in last().collectives]
    return out


def _rank_main(rank: int, world: int, port: int, out_path: str) -> None:
    """One rank: join the gloo group, ingest this rank's slice of every
    table, run ``_run`` SPMD and write its results as JSON."""
    import torch.distributed as dist

    from warpdb_tpu_torch import WarpDB
    from warpdb_tpu_torch.parallel import multihost
    from warpdb_tpu_torch.storage import HostTable

    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu",
                         timeout_s=60)
    assert multihost.is_multiprocess()
    mesh = multihost.global_mesh()
    start, end = multihost.host_shard_range(TOTAL)
    d = _data()

    def db_of(cols):
        local = HostTable.from_dict({c: d[c][start:end] for c in cols})
        table = multihost.make_global_table(local, TOTAL, mesh)
        return WarpDB.from_device_table(table, mesh=mesh, name="t")

    out = _run(db_of, mesh)
    out["rows"] = [start, end]
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _single_process() -> dict:
    from warpdb_tpu_torch import WarpDB
    from warpdb_tpu_torch.parallel.mesh import data_mesh
    from warpdb_tpu_torch.storage import HostTable

    d = _data()
    mesh = data_mesh(devices=["cpu"] * WORLD)
    return _run(lambda cols: WarpDB(HostTable.from_dict(
        {c: d[c] for c in cols}), mesh=mesh), mesh)


@pytest.fixture(scope="module")
def single_process() -> dict:
    return _single_process()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    port = _free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + here + os.pathsep + env.get(
        "PYTHONPATH", "")
    # Two ranks beside the other test workers: a few threads each.
    env["OMP_NUM_THREADS"] = "2"
    outs = [str(tmp / f"rank{r}.json") for r in range(WORLD)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c",
             "import test_torch_multihost as m; "
             f"m._rank_main({r}, {WORLD}, {port}, {outs[r]!r})"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=root)
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def test_ranks_ingest_their_slices(ranks):
    assert [r["rows"] for r in ranks] == [[0, TOTAL // 2],
                                          [TOTAL // 2, TOTAL]]


def test_ranks_agree_with_each_other_and_one_process(ranks):
    single = _single_process()
    for r in ranks:
        for key in ("group_keys", "group_counts", "topk_matches",
                    "shuffle_count"):
            assert r[key] == single[key] == ranks[0][key], key
        for key in ("group_sums", "string_group", "join_rates", "hll",
                    "topk"):
            np.testing.assert_allclose(r[key], single[key], rtol=1e-6,
                                       err_msg=key)
            np.testing.assert_array_equal(r[key], ranks[0][key])


def test_two_process_results_match_the_reference_expectations(ranks):
    """The reference worker's oracle (tests/multihost_worker.py), and
    its single-process results on the same data."""
    d = _data()
    price, k, city, hk, qty = (d[c] for c in ("price", "k", "city", "hk",
                                             "qty"))
    mask = price > 50
    uniq = np.sort(np.unique(k[mask]))
    rate = _rates()["rate"]
    for r in ranks:
        np.testing.assert_array_equal(r["group_keys"], uniq)
        np.testing.assert_array_equal(
            r["group_counts"], [(k[mask] == u).sum() for u in uniq])
        np.testing.assert_allclose(
            r["group_sums"],
            [price[mask][k[mask] == u].astype(np.float64).sum()
             for u in uniq], rtol=1e-6)
        np.testing.assert_allclose(
            r["topk"], np.sort(price[mask])[::-1][:8], rtol=1e-6)
        assert r["topk_matches"] == int(mask.sum())
        np.testing.assert_allclose(
            r["string_group"],
            [price[city == c].sum() for c in sorted(set(city))], rtol=1e-4)
        uniq3, want3 = np.unique(hk, return_counts=True)
        np.testing.assert_array_equal(r["shuffle_count"], want3)
        np.testing.assert_allclose(
            r["join_rates"],
            [(price[qty == u] * rate[int(u)]).sum()
             for u in np.sort(np.unique(qty))], rtol=1e-4)
        np.testing.assert_allclose(r["hll"], np.ones(3), rtol=0.05)

    from warpdb_tpu import WarpDB as RefDB
    from warpdb_tpu.storage import HostTable as RefHost

    for name, cols in (("string_group", ["price", "city"]),
                       ("shuffle_count", ["price", "hk"]),
                       ("hll", ["price", "hk"])):
        ref = np.asarray(RefDB(RefHost.from_dict(
            {c: d[c] for c in cols})).query_sql(STATEMENTS[name]),
            np.float64)
        for r in ranks:
            np.testing.assert_allclose(r[name], ref, rtol=1e-4,
                                       err_msg=name)


def test_initialize_without_a_coordinator_is_a_no_op(monkeypatch):
    from warpdb_tpu_torch.parallel import multihost

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize()
    assert not multihost.is_multiprocess()
    assert multihost.plan_global_layout(5000) == (5000, 5000)
    assert multihost.host_shard_range(5000) == (0, 5000)


def test_host_shard_helpers_in_one_process():
    """Without a group: the whole CSV is this process's slice, and
    ``make_global_table`` / ``gather_to_host`` over a CPU mesh hold every
    row (the reference's ``load_csv_host_shard`` on data/test.csv)."""
    import torch

    from warpdb_tpu.parallel import multihost as ref_multihost
    from warpdb_tpu_torch.parallel import DataMesh, multihost

    local, total = multihost.load_csv_host_shard("data/test.csv")
    ref_local, ref_total = ref_multihost.load_csv_host_shard("data/test.csv")
    assert total == ref_total == local.num_rows == 4
    assert local.to_dict().keys() == ref_local.to_dict().keys()
    for name, col in local.to_dict().items():
        np.testing.assert_array_equal(col, ref_local.to_dict()[name])
    table = multihost.make_global_table(local, total, DataMesh(["cpu"] * 2))
    assert table.shard_rows == [2, 2]
    assert multihost.gather_to_host(torch.arange(3)).tolist() == [0, 1, 2]


def test_initialize_with_no_peer_raises():
    """A group whose other rank never comes fails within its timeout
    instead of hanging."""
    port = _free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(here) + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c",
         "from warpdb_tpu_torch.parallel import multihost; "
         f"multihost.initialize('127.0.0.1:{port}', 2, 0, device='cpu', "
         "timeout_s=3)"],
        capture_output=True, text=True, env=env, timeout=TIMEOUT_S)
    assert proc.returncode != 0


@pytest.mark.parametrize("name", sorted(ROUTE_STATEMENTS))
def test_ranks_take_the_shard_routes(ranks, single_process, name):
    """Each rank runs the statement on its own shard and exchanges only
    partials, unique values or registers: the single-process operators
    and collective bytes (both count a collective's bytes over every
    shard), no gather, and the single-process result."""
    sql, op = ROUTE_STATEMENTS[name]
    single = single_process
    d = _data()
    for r in ranks:
        assert op in r[name + "_ops"]
        assert "mesh_gather" not in r[name + "_ops"]
        # A rank launches its own shard's kernels, one process every
        # shard's: the same operators, counted apart.
        assert (list(dict.fromkeys(r[name + "_ops"]))
                == list(dict.fromkeys(single[name + "_ops"])))
        assert r[name + "_collectives"] == single[name + "_collectives"]
        for got, want, first in zip(r[name], single[name], ranks[0][name]):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
            np.testing.assert_array_equal(got, first)
    price, hk = d["price"], d["hk"]
    got = ranks[0][name]
    if name == "global_agg":
        keep = price[price > np.float32(20)].astype(np.float64)
        assert single[name + "_collectives"] and all(
            b < 1024 for _op, b in single[name + "_collectives"])
        np.testing.assert_array_equal(got[0], [keep.size])
        np.testing.assert_allclose(got[1], [keep.sum()], rtol=1e-6)
        np.testing.assert_allclose(got[2], [keep.mean()], rtol=1e-6)
        np.testing.assert_array_equal(got[3:], [[keep.min()], [keep.max()]])
    elif name == "distinct":
        np.testing.assert_array_equal(
            got[0], np.unique(hk[price > np.float32(90)])[::-1])
    else:
        from warpdb_tpu import WarpDB as RefDB
        from warpdb_tpu.storage import HostTable as RefHost

        ref = RefDB(RefHost.from_dict(
            {c: d[c] for c in ("price", "k", "hk")})).query_sql_table(sql)
        np.testing.assert_array_equal(got[0], ref["k"])
        np.testing.assert_allclose(got[1], list(ref.values())[1],
                                   rtol=1e-6)
