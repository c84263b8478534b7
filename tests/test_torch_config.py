"""The port's configuration against the reference's
(``warpdb_tpu/config.py``), on the CPU: the ``WARPDB_*`` environment
read by both ``from_env``s, ``grouped_device_finish``,
``distributed_small_keys``, each slot tier forced through
``set_config``, and the H100 defaults' tier on each side of each
crossover ``chip_smoke.py --tiers`` measured.

Tolerances: keys, counts and row order exactly; sums within rtol 1e-4
of the reference (which adds in f32) and 1e-6 of float64 NumPy on the
mesh (partials merge in float64)."""

import dataclasses

import numpy as np
import pytest

import warpdb_tpu.config as ref_config
import warpdb_tpu_torch.config as config
from warpdb_tpu import WarpDB as RefDB
from warpdb_tpu.storage import HostTable as RefHost
from warpdb_tpu_torch import WarpDB
from warpdb_tpu_torch.engine import join_exec
from warpdb_tpu_torch.parallel import DataMesh, shuffle
from warpdb_tpu_torch.storage import HostTable
from warpdb_tpu_torch.utils.metrics import last

REF_FIELDS = {f.name: f.type for f in dataclasses.fields(
    ref_config.EngineConfig)}
PORT_FIELDS = {f.name: f.type for f in dataclasses.fields(
    config.EngineConfig)}
SHARED = sorted(set(REF_FIELDS) & set(PORT_FIELDS))
# Spellings of each annotation ``from_env`` dispatches on.
SPELLINGS = {"int": ["0", "7", "65536"],
             "bool": ["1", "true", "YES", "0", "no", "False"],
             "str": ["downcast", "my_udfs.py"]}
# The reference's tier thresholds, under the port's names.
REFERENCE_TIERS = {
    "dense_group_max_slots": 4096,
    "midrange_group_base_slots": 1 << 20,
    "midrange_group_max_slots": 1 << 23,
    "group_hist_max_slots": 1 << 16,
    "distributed_small_keys": 4096,
}
N = 20_000


def _ops() -> list:
    return [name for name, _hit in last().operators]


@pytest.fixture
def port_config():
    """The port's configuration, restored after the test; the test sets
    fields on the yielded copy."""
    saved = config.get_config()
    cfg = dataclasses.replace(saved)
    config.set_config(cfg)
    try:
        yield cfg
    finally:
        config.set_config(saved)


@pytest.fixture
def ref_cfg():
    saved = ref_config.get_config()
    cfg = dataclasses.replace(saved)
    ref_config.set_config(cfg)
    try:
        yield cfg
    finally:
        ref_config.set_config(saved)


@pytest.fixture(scope="module")
def data() -> dict:
    rng = np.random.default_rng(5)
    return {
        "price": rng.uniform(0, 100, N).astype(np.float32),
        "quantity": rng.integers(0, 32, N).astype(np.float32),
        "k": rng.integers(0, 8000, N).astype(np.float32),
    }


@pytest.fixture(scope="module")
def dbs(data):
    return (RefDB(RefHost.from_dict(data)),
            WarpDB(HostTable.from_dict(data), device="cpu"))


# --- the environment -------------------------------------------------------


def test_fields_are_the_references():
    """No field beyond the reference's: ``group_hist_max_slots`` is its
    ``mxu_group_max_slots``, and the three TPU-side fields are left
    out."""
    assert set(PORT_FIELDS) - set(REF_FIELDS) == {"group_hist_max_slots"}
    assert set(REF_FIELDS) - set(PORT_FIELDS) == {
        "mxu_group_max_slots", "join_dense_build_max", "shuffle_overlap",
        "compilation_cache_dir"}
    for name in SHARED:
        assert PORT_FIELDS[name] == REF_FIELDS[name], name


@pytest.mark.parametrize("name,value", [
    (name, value) for name in SHARED
    for value in SPELLINGS[PORT_FIELDS[name]]])
def test_from_env_matches_reference(monkeypatch, name, value):
    monkeypatch.setenv(f"WARPDB_{name.upper()}", value)
    want = getattr(ref_config.EngineConfig.from_env(), name)
    got = getattr(config.EngineConfig.from_env(), name)
    assert got == want and type(got) is type(want)


def test_renamed_field_reads_its_own_variable(monkeypatch):
    monkeypatch.setenv("WARPDB_GROUP_HIST_MAX_SLOTS", "4097")
    monkeypatch.setenv("WARPDB_MXU_GROUP_MAX_SLOTS", "9")
    assert config.EngineConfig.from_env().group_hist_max_slots == 4097


def test_get_config_reads_the_environment_once(monkeypatch):
    monkeypatch.setattr(config, "_config", None)
    monkeypatch.setenv("WARPDB_DISTRIBUTED_SMALL_KEYS", "123")
    monkeypatch.setenv("WARPDB_GROUPED_DEVICE_FINISH", "no")
    cfg = config.get_config()
    assert (cfg.distributed_small_keys, cfg.grouped_device_finish) == (
        123, False)
    monkeypatch.setenv("WARPDB_DISTRIBUTED_SMALL_KEYS", "7")
    assert config.get_config() is cfg
    assert cfg.distributed_small_keys == 123


def test_defaults_without_the_environment(monkeypatch):
    for name in PORT_FIELDS:
        monkeypatch.delenv(f"WARPDB_{name.upper()}", raising=False)
    assert config.EngineConfig.from_env() == config.EngineConfig()


# --- grouped_device_finish -------------------------------------------------

FINISH_QUERIES = [
    "SELECT k, SUM(price) AS s FROM t GROUP BY k ORDER BY s DESC LIMIT 5",
    "SELECT k, MAX(price) AS m FROM t GROUP BY k HAVING COUNT(*) > 2 "
    "ORDER BY m ASC LIMIT 7 OFFSET 2",
    "SELECT k, COUNT(*) AS c FROM t WHERE price > 30 GROUP BY k "
    "ORDER BY c DESC LIMIT 4",
]


@pytest.mark.parametrize("sql", FINISH_QUERIES)
def test_device_finish_off_returns_the_same_rows(dbs, port_config, ref_cfg,
                                                 sql):
    """The midrange tier's device finish on and off: the same rows, the
    reference's under the same setting, and EXPLAIN's ``finish:`` line
    where the reference prints it."""
    ref, port = dbs
    for key, value in REFERENCE_TIERS.items():
        setattr(port_config, key, value)
    out = {}
    for flag in (True, False):
        port_config.grouped_device_finish = flag
        ref_cfg.grouped_device_finish = flag
        got = port.query_sql_table(sql)
        assert "midrange_group" in _ops()
        want = ref.query_sql_table(sql)
        assert list(got) == list(want)
        for g, w in zip(got.values(), want.values()):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), rtol=1e-4)
        out[flag] = got
        has = "finish:" in port.explain(sql)
        assert has == ("finish:" in ref.explain(sql)) == flag
    for a, b in zip(out[True].values(), out[False].values()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- distributed_small_keys ------------------------------------------------

MESH4 = DataMesh(["cpu"] * 4)


@pytest.fixture(scope="module")
def ref_mesh():
    from warpdb_tpu.parallel import data_mesh

    return data_mesh()


@pytest.mark.parametrize("small,route", [
    (31, "combine_shuffle_group"), (32, "sharded_group"),
    (4096, "sharded_group")])
def test_distributed_small_keys_moves_the_mesh_group_by(
        data, port_config, ref_cfg, ref_mesh, small, route):
    """32 key tuples: the all_gather merge up to ``distributed_small_keys``
    and the shuffle above it, as in the reference, with equal results."""
    port_config.distributed_small_keys = small
    ref_cfg.distributed_small_keys = small
    sql = ("SELECT quantity, COUNT(*), SUM(price) FROM t WHERE price > 10 "
           "GROUP BY quantity")
    port = WarpDB(HostTable.from_dict(data), mesh=MESH4)
    ref = RefDB(RefHost.from_dict(data), mesh=ref_mesh)
    got = port.query_sql_table(sql)
    assert route in _ops()
    merge = "all_gather merge" in port.explain(sql)
    assert merge == ("all_gather merge" in ref.explain(sql))
    assert merge == (route == "sharded_group")
    want = ref.query_sql_table(sql)
    keys, counts, sums = (np.asarray(c, np.float64) for c in got.values())
    wkeys, wcounts, wsums = (np.asarray(c, np.float64)
                             for c in want.values())
    np.testing.assert_array_equal(keys, wkeys)
    np.testing.assert_array_equal(counts, wcounts)
    np.testing.assert_allclose(sums, wsums, rtol=1e-4)
    hot = data["price"] > 10
    truth = np.bincount(data["quantity"][hot].astype(np.int64),
                        weights=data["price"][hot].astype(np.float64))
    np.testing.assert_allclose(sums, truth, rtol=1e-6)


# --- each slot tier forced -------------------------------------------------

_MID = {"dense_group_max_slots": 0, "midrange_group_base_slots": 1 << 30,
        "midrange_group_max_slots": 1 << 30}
# tier: (config fields, the operator it runs, K2 launched).
FORCED = {
    "dense scatter": ({"dense_group_max_slots": 1 << 30,
                       "group_hist_max_slots": 0}, "dense_group", False),
    "dense K2": ({"dense_group_max_slots": 1 << 30,
                  "group_hist_max_slots": 1 << 16}, "dense_group", True),
    "midrange scatter": ({**_MID, "group_hist_max_slots": 0},
                         "midrange_group", False),
    "midrange K2": ({**_MID, "group_hist_max_slots": 1 << 16},
                    "midrange_group", True),
    "sorted": ({"dense_group_max_slots": 0, "midrange_group_max_slots": 0},
               "group_sort", False),
}
FORCED_QUERIES = [
    "SELECT k, COUNT(*), SUM(price) FROM t GROUP BY k",
    "SELECT quantity, SUM(price * 2), COUNT(*) FROM t WHERE price > 40 "
    "GROUP BY quantity",
]


@pytest.mark.parametrize("tier", sorted(FORCED))
@pytest.mark.parametrize("sql", FORCED_QUERIES)
def test_each_forced_tier_returns_the_reference_result(dbs, port_config,
                                                       tier, sql):
    ref, port = dbs
    fields, op, k2 = FORCED[tier]
    for key, value in fields.items():
        setattr(port_config, key, value)
    got = port.query_sql_table(sql)
    ops = _ops()
    assert op in ops and ("K2 group_hist (plain)" in ops) == k2, ops
    want = ref.query_sql_table(sql)
    assert list(got) == list(want)
    cols = [(np.asarray(g, np.float64), np.asarray(w, np.float64))
            for g, w in zip(got.values(), want.values())]
    for i, (g, w) in enumerate(cols):
        if "SUM" in list(got)[i]:
            np.testing.assert_allclose(g, w, rtol=1e-4)
        else:
            np.testing.assert_array_equal(g, w)


# --- the H100 defaults -----------------------------------------------------

# The defaults ``chip_smoke.py --tiers`` measured (PERF.md §6).
H100_DEFAULTS = {
    "dense_group_max_slots": 4096,
    "midrange_group_base_slots": 1 << 21,
    "midrange_group_max_slots": 1 << 23,
    "group_hist_max_slots": 1 << 16,
    "distributed_small_keys": 1 << 19,
}


def test_defaults_are_the_measured_crossovers():
    cfg = config.EngineConfig()
    for key, value in H100_DEFAULTS.items():
        assert getattr(cfg, key) == value, key
    assert shuffle.COMBINE_CAP == 1 << 23
    assert (join_exec.PUSHDOWN_MAX_SHARE, join_exec.PUSHDOWN_MIN_ROWS) == (
        0.5, 1 << 24)


def _spanning(slots: int, n: int = 4000) -> dict:
    """``n`` rows whose integral key spans exactly ``slots`` slots."""
    rng = np.random.default_rng(slots % 997)
    key = rng.integers(0, slots, n).astype(np.int32)
    key[:2] = (0, slots - 1)
    return {"key": key, "price": rng.uniform(0, 100, n).astype(np.float32)}


# (key slots, aggregates, the operator the default tier runs, K2).
DEFAULT_TIERS = [
    (32, "COUNT(*), SUM(price)", "dense_group", True),
    (4096, "COUNT(*), SUM(price)", "dense_group", True),
    (4096, "MIN(price), SUM(price)", "dense_group", False),
    (4097, "COUNT(*), SUM(price)", "midrange_group", True),
    (1 << 16, "SUM(price)", "midrange_group", True),
    ((1 << 16) + 1, "SUM(price)", "midrange_group", False),
    (1 << 21, "COUNT(*), SUM(price)", "midrange_group", False),
    ((1 << 21) + 1, "COUNT(*), SUM(price)", "group_sort", False),
]


@pytest.mark.parametrize("slots,aggs,op,k2", DEFAULT_TIERS)
def test_h100_defaults_choose_the_measured_tier(port_config, slots, aggs, op,
                                                k2):
    """On each side of each measured crossover the default configuration
    takes its tier (over 4000 rows, fewer than the slots from 4097 on:
    the midrange table up to ``midrange_group_base_slots``, 2^21, the
    sort above), with NumPy's result."""
    for key, value in H100_DEFAULTS.items():
        assert getattr(port_config, key) == value
    data = _spanning(slots)
    port = WarpDB(HostTable.from_dict(data), device="cpu")
    got = port.query_sql_table(f"SELECT key, {aggs} FROM t GROUP BY key")
    ops = _ops()
    assert op in ops and ("K2 group_hist (plain)" in ops) == k2, ops
    keys = np.asarray(list(got.values())[0])
    np.testing.assert_array_equal(keys, np.unique(data["key"]))
    sums = np.asarray(list(got.values())[-1], np.float64)
    want = np.bincount(data["key"], weights=data["price"].astype(np.float64))
    np.testing.assert_allclose(sums, want[keys], rtol=1e-5)


def test_h100_defaults_route_the_mesh_and_the_pushdown(data, port_config,
                                                       monkeypatch):
    """The mesh GROUP BY merges up to 2^19 key tuples and shuffles above;
    a probe under 2^24 rows is not compacted before its join."""
    port = WarpDB(HostTable.from_dict(data), mesh=MESH4)
    port.query_sql_table("SELECT k, SUM(price) FROM t GROUP BY k")
    assert "sharded_group" in _ops()
    wide = _spanning((1 << 19) + 1)
    port = WarpDB(HostTable.from_dict(wide), mesh=MESH4)
    got = port.query_sql_table("SELECT key, COUNT(*) FROM t GROUP BY key")
    assert "combine_shuffle_group" in _ops()
    np.testing.assert_array_equal(np.asarray(got["key"]),
                                  np.unique(wide["key"]))
    single = WarpDB(HostTable.from_dict(data), device="cpu")
    single.register_table("r", HostTable.from_dict(
        {"quantity": np.arange(32, dtype=np.float32),
         "rate": np.linspace(0, 1, 32).astype(np.float32)}))
    sql = ("SELECT SUM(price * rate) FROM t JOIN r ON quantity = r.quantity "
           "WHERE price > 90 GROUP BY quantity")
    want = single.query_sql_table(sql)
    assert not getattr(single.table, "_prefilter_memo", None)
    monkeypatch.setattr(join_exec, "PUSHDOWN_MIN_ROWS", 4096)
    got = single.query_sql_table(sql)
    assert getattr(single.table, "_prefilter_memo", None)
    np.testing.assert_allclose(np.asarray(list(got.values())[0]),
                               np.asarray(list(want.values())[0]), rtol=1e-6)
