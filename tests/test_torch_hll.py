"""APPROX_COUNT_DISTINCT (HyperLogLog) and STRING_AGG / GROUP_CONCAT
against the reference.

``ops/hll.py``'s hash, (rho, bucket) split and grouped registers equal
``warpdb_tpu.ops.hll``'s bit for bit on seeded random words and the
edges (0, 0xFFFFFFFF and the sort keys of ±0.0, every NaN and ±inf); its
estimates agree within rtol 1e-5 (torch adds the 4096 terms in another
order than XLA).  Then the reference's APPROX_COUNT_DISTINCT and
STRING_AGG statements (``tests/test_engine.py``, ``tests/test_strings.py``)
and more go through both packages on the CPU: global, grouped on each
tier (dense, the K2 midrange slot table, sorted), WHERE, HAVING, over a
join, above 2048 groups (the exact route), and errors of the same class
and message.  Estimates to rtol 1e-5, counts and strings exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from warpdb_tpu import WarpDB as RefDB
from warpdb_tpu import errors as ref_errors
from warpdb_tpu.ops import hll as ref_hll
from warpdb_tpu.ops.sort import float_sort_key as ref_fsk
from warpdb_tpu.storage import HostTable as RefHostTable
from warpdb_tpu_torch import WarpDB as PortDB
from warpdb_tpu_torch import errors
from warpdb_tpu_torch.ops import hll
from warpdb_tpu_torch.ops.sort import float_sort_key
from warpdb_tpu_torch.storage import HostTable

# No denormals: XLA on the CPU flushes them to zero (ROADMAP queue 3).
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -1.5,
                    np.float32(3.4e38), -np.float32(1.2e-38)], np.float32)


def _special_floats() -> np.ndarray:
    """±0.0, ±inf, NaNs with other payloads and signs, and normals."""
    bits = SPECIAL.view(np.uint32).copy()
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF,
                     0x7FC01234], np.uint32)
    return np.concatenate([bits, nans]).view(np.float32)


def _words() -> np.ndarray:
    rng = np.random.default_rng(70)
    u = rng.integers(0, 2**32, 50_000, dtype=np.uint64).astype(np.uint32)
    edges = np.array([0, 0xFFFFFFFF, 1, 0x80000000, 0x7FFFFFFF, 4095, 4096],
                     np.uint32)
    keys = np.asarray(ref_fsk(jnp.asarray(_special_floats())))
    return np.concatenate([edges, keys, u])


def test_sort_keys_of_special_floats_match_reference():
    x = _special_floats()
    want = np.asarray(ref_fsk(jnp.asarray(x))).astype(np.int64)
    got = float_sort_key(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_hash_matches_reference_bit_for_bit():
    u = _words()
    want = np.asarray(ref_hll.hll_hash(jnp.asarray(u))).astype(np.int64)
    got = hll.hll_hash(torch.from_numpy(u.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 2**32


def test_rho_bucket_match_reference():
    u = _words()
    h = np.asarray(ref_hll.hll_hash(jnp.asarray(u)))
    rr, rb = ref_hll.hll_rho_bucket(jnp.asarray(h))
    pr, pb = hll.hll_rho_bucket(torch.from_numpy(h.astype(np.int64)))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(rr))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))
    # The saturation (w = 0) and the top bit: rho 21 and 1.
    edge, _ = hll.hll_rho_bucket(torch.tensor([0, 4095, 4096, 2**32 - 1]))
    assert edge.tolist() == [21, 21, 20, 1]


@pytest.mark.parametrize("capacity", [1, 5, 16])
def test_grouped_registers_match_reference(capacity):
    rng = np.random.default_rng(capacity)
    u = _words()
    seg = rng.integers(0, capacity, u.shape[0]).astype(np.int32)
    valid = rng.random(u.shape[0]) > 0.25
    want = np.asarray(ref_hll.hll_grouped_registers(
        jnp.asarray(seg), jnp.asarray(u), jnp.asarray(valid), capacity))
    got = hll.hll_grouped_registers(
        torch.from_numpy(seg), torch.from_numpy(u.astype(np.int64)),
        torch.from_numpy(valid), capacity).numpy()
    assert got.dtype == np.int32 and got.shape == (capacity, hll.HLL_M)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        hll.hll_estimate(torch.from_numpy(got)).numpy(),
        np.asarray(ref_hll.hll_estimate(jnp.asarray(want))), rtol=1e-5)
    np.testing.assert_array_equal(hll.hll_estimate_np(got),
                                  ref_hll.hll_estimate_np(want))


@pytest.mark.parametrize("n", [0, 3, 300, 3_000, 30_000, 300_000])
def test_estimate_across_cardinalities(n):
    """Empty registers, the linear-counting range and the raw range."""
    rng = np.random.default_rng(n)
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    regs = np.array(ref_hll.hll_grouped_registers(
        jnp.zeros(n, jnp.int32), jnp.asarray(u), jnp.ones(n, bool), 1))
    got = hll.hll_estimate(torch.from_numpy(regs)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref_hll.hll_estimate(jnp.asarray(regs))), rtol=1e-5)
    assert abs(float(got[0]) - n) <= 5 * 0.0164 * n + 2


# --- statements through both packages -----------------------------------

N = 6000


def _data() -> dict:
    rng = np.random.default_rng(29)
    x = rng.integers(0, 3000, N).astype(np.float32)
    x[::53] = np.nan
    x[7::61] = -0.0
    x[9::61] = 0.0
    return {
        "g": rng.integers(0, 4, N).astype(np.float32),        # dense
        "gi": rng.integers(0, 40, N).astype(np.int32),        # raw int key
        "km": rng.integers(0, 6000, N).astype(np.float32),    # K2 midrange
        "kf": (rng.integers(0, 50, N) + 0.5).astype(np.float32),  # sorted
        "x": x,
        "v": rng.normal(0, 10, N).astype(np.float32),
        "tag": np.array([f"u{i:03d}" for i in range(300)])[
            rng.integers(0, 300, N)],
        "cat": rng.choice(["a", "b", "c"], N),
    }


@pytest.fixture(scope="module")
def dbs():
    data = _data()
    dim = {"g": np.arange(4, dtype=np.float32),
           "w": np.float32([0.5, 1.5, 2.5, 3.5]),
           "lbl": np.array(["zero", "one", "two", "three"])}
    ref = RefDB(RefHostTable.from_dict(data))
    port = PortDB(HostTable.from_dict(data), device="cpu")
    ref.register_table("dim", RefHostTable.from_dict(dim))
    port.register_table("dim", HostTable.from_dict(dim))
    return ref, port


def _same(ref, got, q):
    ref, got = list(ref), list(got)
    assert len(got) == len(ref), q
    if ref and any(isinstance(x, str) for x in ref):
        assert got == ref, q
        return
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=1e-5,
                               atol=1e-6, equal_nan=True, err_msg=q)


APPROX = [
    # test_engine.py::test_approx_count_distinct's forms
    "SELECT APPROX_COUNT_DISTINCT(x) AS a, COUNT(DISTINCT x) AS e FROM t",
    "SELECT g, APPROX_COUNT_DISTINCT(x) AS a, COUNT(DISTINCT x) AS e FROM t "
    "WHERE x > 100 GROUP BY g ORDER BY g ASC",
    "SELECT APPROX_COUNT_DISTINCT(tag) AS a, COUNT(DISTINCT tag) AS e FROM t",
    "SELECT g FROM t GROUP BY g HAVING APPROX_COUNT_DISTINCT(x) > 1 "
    "ORDER BY g ASC",
    # each tier: dense (float and raw int keys), K2 midrange, sorted
    "SELECT g, COUNT(*), APPROX_COUNT_DISTINCT(v) FROM t GROUP BY g",
    "SELECT gi, APPROX_COUNT_DISTINCT(x) FROM t GROUP BY gi",
    "SELECT km, SUM(v), APPROX_COUNT_DISTINCT(tag) FROM t GROUP BY km "
    "HAVING COUNT(*) > 1",
    "SELECT kf, APPROX_COUNT_DISTINCT(x), MIN(v) FROM t GROUP BY kf",
    "SELECT g, cat, APPROX_COUNT_DISTINCT(x) FROM t GROUP BY g, cat",
    # above 2048 groups: the exact COUNT(DISTINCT)
    "SELECT km, APPROX_COUNT_DISTINCT(x) AS a, COUNT(DISTINCT x) AS e "
    "FROM t GROUP BY km",
    # expressions, WHERE, ORDER BY over the estimate, a join
    "SELECT APPROX_COUNT_DISTINCT(x * 2) + 1 FROM t WHERE v > 0",
    "SELECT g, APPROX_COUNT_DISTINCT(x) AS a FROM t GROUP BY g "
    "ORDER BY a DESC LIMIT 2",
    "SELECT dim.lbl, APPROX_COUNT_DISTINCT(x) FROM t JOIN dim ON "
    "t.g = dim.g GROUP BY dim.lbl",
    "SELECT APPROX_COUNT_DISTINCT(v) FROM t WHERE v > 1000",
]

STRING_AGG = [
    # test_strings.py's forms
    "SELECT cat, STRING_AGG(tag, ', ') FROM t GROUP BY cat ORDER BY cat",
    "SELECT cat, GROUP_CONCAT(g) FROM t WHERE x < 40 GROUP BY cat "
    "ORDER BY cat",
    "SELECT cat, STRING_AGG(tag, '|') FROM t WHERE v > 25 GROUP BY cat "
    "ORDER BY cat",
    "SELECT STRING_AGG(tag, '|'), SUM(v) FROM t WHERE x < 30",
    "SELECT STRING_AGG(tag, '') FROM t WHERE v > 30",
    # numbers: %g of the f32 values, ascending, NaN last, -0.0 as 0
    "SELECT g, STRING_AGG(x, ';') FROM t WHERE x < 3 OR x > 2995 "
    "OR x != x GROUP BY g",
    # each tier, and composite keys
    "SELECT gi, COUNT(*), STRING_AGG(cat, ',') FROM t WHERE v > 20 "
    "GROUP BY gi",
    "SELECT km, SUM(v), STRING_AGG(tag, ',') FROM t GROUP BY km",
    "SELECT kf, STRING_AGG(cat, '-'), MAX(v) FROM t WHERE v > 15 "
    "GROUP BY kf",
    "SELECT g, cat, STRING_AGG(tag, ',') FROM t WHERE v > 22 "
    "GROUP BY g, cat",
    # HAVING and ORDER BY over other aggregates, LIMIT, a join
    "SELECT cat, STRING_AGG(tag, ',') FROM t WHERE v > 20 GROUP BY cat "
    "HAVING COUNT(*) > 3 ORDER BY COUNT(*) DESC LIMIT 2",
    "SELECT dim.lbl, STRING_AGG(cat, ',') FROM t JOIN dim ON t.g = dim.g "
    "WHERE v > 24 GROUP BY dim.lbl",
    "SELECT STRING_AGG(UPPER(cat), ',') FROM t WHERE v > 26",
]


@pytest.mark.parametrize("q", APPROX + STRING_AGG)
def test_statement_matches_reference(dbs, q):
    ref, port = dbs
    want, got = ref.query_sql_table(q), port.query_sql_table(q)
    assert list(got) == list(want), q
    for col in want:
        _same(want[col], got[col], f"{q} [{col}]")


@pytest.mark.parametrize("q", APPROX + [q for q in STRING_AGG
                                        if "GROUP BY" in q])
def test_first_column_matches_reference(dbs, q):
    ref, port = dbs
    _same(ref.query_sql(q), port.query_sql(q), q)


def test_global_string_agg_first_column_is_the_string(dbs):
    """The reference's ``query_sql`` runs a global STRING_AGG through its
    float-typed scalar path and returns a number (``[4.0]`` for three
    names); its ``query_sql_table`` gives the string.  The port routes
    both through the constant-key group and returns the string."""
    ref, port = dbs
    q = "SELECT STRING_AGG(tag, '|') FROM t WHERE v > 28"
    want = ref.query_sql_table(q)
    assert port.query_sql(q) == list(want.values())[0]
    assert not isinstance(ref.query_sql(q)[0], str)


def test_string_agg_values_sorted_and_empty_groups():
    data = {"k": np.float32([1, 1, 1, 2, 2]),
            "v": np.float32([2.5, -0.0, np.nan, 1e10, 0.0])}
    port = PortDB(HostTable.from_dict(data), device="cpu")
    ref = RefDB(RefHostTable.from_dict(data))
    q = "SELECT k, STRING_AGG(v, ',') FROM t GROUP BY k"
    got = port.query_sql_table(q)
    assert got == ref.query_sql_table(q)
    # -0.0 sorts as 0 and keeps its sign in %g, as in the reference.
    assert list(got.values())[1] == ["-0,2.5,nan", "0,1e+10"]


def test_hll_registers_are_the_streaming_partial():
    """``final=False`` hands out the u8 registers (the mergeable form),
    equal to the reference's; above 2048 groups it refuses."""
    from warpdb_tpu.engine import group_exec as ref_ge
    from warpdb_tpu.frontend import parse_query_text as ref_parse
    from warpdb_tpu_torch.engine import group_exec
    from warpdb_tpu_torch.frontend import parse_query_text

    data = _data()
    ref = RefDB(RefHostTable.from_dict(data))
    port = PortDB(HostTable.from_dict(data), device="cpu")
    q = "SELECT g, APPROX_COUNT_DISTINCT(x) FROM t GROUP BY g"
    outs = []
    for mod, parse, db in ((group_exec, parse_query_text, port),
                           (ref_ge, ref_parse, ref)):
        ast = parse(q)
        items = [ast.select_list[0], ast.select_list[1]]
        plan = mod._grouped_plan(ast, items, table=db.table)
        res = mod._grouped_partials(ast, db.table, plan, final=False)
        outs.append(np.asarray(res.dcounts[plan["cd_specs"][0].key]))
    assert outs[0].dtype == np.uint8 and outs[0].shape == (4, hll.HLL_M)
    np.testing.assert_array_equal(outs[0], outs[1])
    ast = parse_query_text("SELECT km, APPROX_COUNT_DISTINCT(x) FROM t "
                           "GROUP BY km")
    plan = group_exec._grouped_plan(ast, list(ast.select_list),
                                    table=port.table)
    with pytest.raises(errors.UnsupportedError, match="2048 groups"):
        group_exec._grouped_partials(ast, port.table, plan, final=False)


BAD = [
    "SELECT STRING_AGG(x) FROM t",
    "SELECT STRING_AGG(x, ',') FILTER (WHERE x > 1) FROM t",
    "SELECT STRING_AGG(wide, ',') FROM t",
    "SELECT APPROX_COUNT_DISTINCT(x, 2) FROM t",
    "SELECT APPROX_COUNT_DISTINCT(nope) FROM t",
    "SELECT g, STRING_AGG(tag, ',') FROM t GROUP BY nope",
]


@pytest.mark.parametrize("q", BAD)
def test_errors_match_reference(q):
    rng = np.random.default_rng(3)
    data = _data()
    data["wide"] = rng.integers(2**40, 2**41, N).astype(np.int64)
    ref = RefDB(RefHostTable.from_dict(data))
    port = PortDB(HostTable.from_dict(data), device="cpu")
    with pytest.raises(ref_errors.WarpDBError) as want:
        ref.query_sql_table(q)
    with pytest.raises(errors.WarpDBError) as got:
        port.query_sql_table(q)
    assert type(got.value).__name__ == type(want.value).__name__, q
    assert str(got.value) == str(want.value), q
