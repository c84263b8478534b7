"""Differential harness of subqueries, CTEs, derived tables, set
operations and ``query_sql_table``: the same seeded tables go through
``warpdb_tpu.WarpDB`` and ``warpdb_tpu_torch.WarpDB(device="cpu")``, and
every statement must give the same answer.  Integers, strings, counts and
row order match exactly; float values match to rtol 1e-5.  The cases
follow the reference's own tests (``tests/test_engine.py``: set
operations, CTEs, correlated forms and their fuzz, scalar and IN, ANY /
ALL, derived tables, EXISTS, aliases in a CTE body).  Where the reference
is at fault, the port is held against NumPy and the divergence is
recorded."""

import numpy as np
import pytest
import torch

from warpdb_tpu import WarpDB as RefWarpDB
from warpdb_tpu import errors as ref_errors
from warpdb_tpu.storage import DataType as RefDataType
from warpdb_tpu.storage import HostTable as RefHostTable
from warpdb_tpu_torch import WarpDB as PortDB
from warpdb_tpu_torch.errors import (
    ExecutionError,
    ParseError,
    UnsupportedError,
    ValidationError,
)
from warpdb_tpu_torch.storage import DataType, DeviceTable, HostTable


def _ref_table(source):
    """The reference's HostTable of the same numpy columns and dtypes,
    built by the reference's own package (a CSV path passes through)."""
    if isinstance(source, str):
        return source
    return RefHostTable.from_dict(
        {c.name: c.data for c in source.columns},
        dtypes={c.name: RefDataType(c.dtype.value) for c in source.columns},
    )


def _ref_db(source):
    return RefWarpDB(_ref_table(source))


def _ref_exc(exc):
    """The reference's error class of the same name as the port's."""
    return getattr(ref_errors, exc.__name__)


def _f(*v):
    return np.array(v, np.float32)


def _strings(**cols) -> HostTable:
    """A HostTable whose object-array columns are STRING."""
    return HostTable.from_dict(
        cols, dtypes={k: DataType.STRING if v.dtype == object
                      else DataType.FLOAT32 for k, v in cols.items()},
    )


def _seeded() -> tuple:
    """A fact table and a dimension of the harness's own (strings, an
    int column, NaNs, duplicate and missing keys)."""
    rng = np.random.default_rng(31)
    n = 3000
    nv = rng.uniform(0, 10, n).astype(np.float32)
    nv[::37] = np.nan
    fact = HostTable.from_dict({
        "k": rng.integers(0, 40, n).astype(np.float32),
        "ki": rng.integers(0, 500, n).astype(np.int32),
        "price": rng.uniform(0, 100, n).astype(np.float32),
        "nv": nv,
        "s": rng.choice(["apple", "banana", "cherry", "date"], n),
    })
    dim = HostTable.from_dict({
        "dk": np.arange(5, 45).astype(np.float32),
        "w": rng.uniform(0, 1, 40).astype(np.float32),
        "name": np.array([f"n{i:02d}" for i in rng.permutation(40)]),
    })
    return fact, {"dim": dim, "fact": fact}


def _setups() -> dict:
    """name → (primary table or CSV path, {registered name: table})."""
    rng = np.random.default_rng(95)
    q = rng.integers(0, 10, 4000).astype(np.float32)
    derived = HostTable.from_dict(
        {"quantity": q, "price": rng.uniform(0, 100, 4000).astype(np.float32)}
    )
    rng6 = np.random.default_rng(6)
    emp = _strings(
        name=np.array(["a", "b", "c", "d"], object),
        dept=np.array(["x", "y", "x", "y"], object),
        sal=_f(10, 20, 30, 15),
    )
    li = HostTable.from_dict({"okey": _f(0, 0, 1, 2, 2, 3),
                              "skey": _f(1, 2, 1, 1, 1, 2)})
    return {
        "csv": ("data/test.csv", {}),
        "seeded": _seeded(),
        "union": (HostTable.from_dict({"p": _f(1, 2, 2)}),
                  {"u": HostTable.from_dict({"q": _f(2, 9)})}),
        "union_pv": (HostTable.from_dict({"p": _f(5, 1), "v": _f(50, 10)}),
                     {"u": HostTable.from_dict({"p": _f(3), "v": _f(30)})}),
        "setop": (HostTable.from_dict({"p": _f(1, 2, 2, 3, 3, 3)}),
                  {"u": HostTable.from_dict({"q": _f(2, 3, 3, 9)})}),
        "strs": (_strings(c=np.array(["b", "a"], object)),
                 {"u": _strings(c=np.array(["a", "z"], object))}),
        "strs3": (_strings(c=np.array(["a", "b", "c"], object)),
                  {"u": _strings(c=np.array(["b", "z"], object))}),
        "p3": (HostTable.from_dict({"p": _f(1, 2, 3)}), {}),
        "p4": (HostTable.from_dict({"p": _f(1, 2, 3, 4)}), {}),
        "p6": (HostTable.from_dict({"p": _f(1, 2, 3, 4, 5, 6)}),
               {"lim": HostTable.from_dict({"cut": _f(4.5)})}),
        "kv": (HostTable.from_dict({"k": _f(1, 2, 1, 2),
                                    "v": _f(10, 20, 30, 40)}), {}),
        "cv": (_strings(c=np.array(["b", "a", "b"], object), v=_f(1, 2, 4)),
               {}),
        "reg": (HostTable.from_dict({"p": _f(1)}),
                {"u": _strings(c=np.array(["x", "y", "x"], object),
                               v=_f(1, 2, 4))}),
        "corr": (HostTable.from_dict({"cid": _f(1, 2, 3, 4),
                                      "region": _f(10, 20, 10, 30)}),
                 {"orders": HostTable.from_dict({
                     "ocid": _f(1, 1, 2, 2, 2, 4),
                     "amt": _f(5, 7, 3, 9, 2, 8)})}),
        "corr_in": (HostTable.from_dict({"k": _f(1, 2, 3), "v": _f(7, 8, 9)}),
                    {"u": HostTable.from_dict({"uk": _f(1, 1, 3),
                                               "uv": _f(7, 5, 2)})}),
        "emp": (emp, {"emp": emp}),
        "li": (li, {"lineitem": li, "ext": HostTable.from_dict({
            "eokey": _f(0, 0, 1, 2), "eskey": _f(9, 2, 7, 1),
            "late": _f(1, 0, 1, 1)})}),
        "good": (HostTable.from_dict({"k": _f(1, 2, 3, 4, 5),
                                      "v": _f(10, 20, 30, 40, 50)}),
                 {"good": HostTable.from_dict({"k": _f(2, 4, 9),
                                               "flag": _f(1, 1, 0)})}),
        "city": (_strings(city=np.array(["ams", "ber", "cdg", "lhr"], object),
                          price=_f(1, 2, 3, 4)),
                 {"eu": _strings(city=np.array(["ams", "cdg", "muc"],
                                               object))}),
        "names": (_strings(name=np.array(["ant", "bee", "cow", "dog"], object),
                           v=_f(1, 2, 3, 4)), {}),
        "exists": (HostTable.from_dict({"price": _f(10.5, 20, 15.25, 30),
                                        "quantity": _f(3, 4, 2, 5)}),
                   {"other": HostTable.from_dict({"x": _f(1, 2)})}),
        "derived": (derived, {}),
        "nested": (_strings(cat=np.array(["b", "a", "b", "c", "a"], object),
                            v=_f(1, 2, 3, 4, 5)), {}),
        "alias_cte": (HostTable.from_dict({
            "k": rng6.integers(0, 4, 30).astype(np.float32),
            "v": rng6.uniform(0, 10, 30).astype(np.float32)}), {}),
        "wide": (HostTable.from_dict({
            "wide": np.array([7, 2**40, 2**53 + 1, 2**40, 9], np.int64),
            "x": _f(1, 2, 3, 4, 5)}), {}),
    }


@pytest.fixture(scope="module")
def dbs():
    setups = _setups()
    made: dict = {}

    def get(name):
        if name not in made:
            primary, registered = setups[name]
            pair = _ref_db(primary), PortDB(primary, device="cpu")
            for tname, host in registered.items():
                pair[0].register_table(tname, _ref_table(host))
                pair[1].register_table(tname, host)
            made[name] = pair
        return made[name]

    return get


def _same(ref, got, q):
    ref, got = list(ref), list(got)
    assert len(got) == len(ref), q
    if ref and any(isinstance(x, str) for x in ref):
        assert got == ref, q
        return
    r, g = np.asarray(ref), np.asarray(got)
    if r.dtype.kind in "iu" or g.dtype.kind in "iu":
        np.testing.assert_array_equal(g, r, err_msg=q)
        return
    np.testing.assert_allclose(g.astype(np.float64), r.astype(np.float64),
                               rtol=1e-5, atol=1e-6, equal_nan=True,
                               err_msg=q)


def _same_table(ref: dict, got: dict, q):
    assert list(got) == list(ref), q
    for name in ref:
        _same(ref[name], got[name], f"{q} [{name}]")


# (setup, SQL): every statement runs through query_sql_table on both
# packages, and through query_sql where it is listed in FIRST_COLUMN.
CASES = [
    # set operations (test_engine.py:2964-3144)
    ("union", "SELECT p FROM t UNION ALL SELECT q FROM u"),
    ("union", "SELECT p FROM t UNION SELECT q FROM u"),
    ("union", "SELECT p FROM t UNION SELECT q FROM u UNION ALL SELECT q FROM u"),
    ("union_pv", "SELECT p, v FROM t UNION ALL SELECT p, v FROM u "
                 "ORDER BY p DESC LIMIT 2"),
    ("strs", "SELECT c FROM t UNION SELECT c FROM u"),
    ("p3", "SELECT MIN(p) FROM t UNION ALL SELECT MAX(p) FROM t"),
    ("setop", "SELECT p FROM t EXCEPT SELECT q FROM u"),
    ("setop", "SELECT p FROM t EXCEPT ALL SELECT q FROM u"),
    ("setop", "SELECT p FROM t INTERSECT SELECT q FROM u"),
    ("setop", "SELECT p FROM t INTERSECT ALL SELECT q FROM u"),
    ("setop", "SELECT p FROM t WHERE p < 2 UNION SELECT p FROM t "
              "INTERSECT SELECT q FROM u"),
    ("setop", "SELECT p FROM t EXCEPT SELECT q FROM u WHERE q > 5 "
              "EXCEPT SELECT q FROM u WHERE q < 3"),
    ("setop", "SELECT p FROM t INTERSECT SELECT q FROM u ORDER BY p DESC"),
    ("setop", "SELECT p FROM t UNION ALL SELECT q FROM u ORDER BY p ASC "
              "LIMIT 3 OFFSET 2"),
    ("strs3", "SELECT c FROM t EXCEPT SELECT c FROM u"),
    ("strs3", "SELECT c FROM t INTERSECT SELECT c FROM u"),
    ("seeded", "SELECT s, k FROM fact WHERE k < 3 UNION SELECT name, dk "
               "FROM dim WHERE dk < 8"),
    ("seeded", "SELECT k FROM fact JOIN dim ON k = dim.dk WHERE w > 0.5 "
               "EXCEPT SELECT dk FROM dim WHERE dk > 20"),
    # FROM routing over registered tables, derived tables
    # (test_engine.py:3149-3186, 4234-4307)
    ("reg", "SELECT c, SUM(v) FROM u GROUP BY c ORDER BY c ASC"),
    ("reg", "SELECT s FROM (SELECT SUM(v) AS s FROM u GROUP BY c) AS d "
            "ORDER BY s ASC"),
    ("derived", "SELECT s FROM (SELECT quantity AS k, SUM(price) AS s "
                "FROM t GROUP BY quantity) AS agg WHERE s > 15000 "
                "ORDER BY s DESC"),
    ("derived", "SELECT MAX(s) FROM (SELECT SUM(price) AS s FROM t "
                "GROUP BY quantity) AS agg"),
    ("derived", "SELECT k, s FROM (SELECT quantity AS k, SUM(price) AS s "
                "FROM t GROUP BY quantity) AS agg ORDER BY k ASC"),
    ("nested", "SELECT cat, total FROM (SELECT cat, SUM(v) AS total FROM t "
               "GROUP BY cat) AS agg WHERE cat != 'c' ORDER BY cat ASC"),
    ("nested", "SELECT MAX(total) FROM (SELECT cat, total FROM (SELECT cat, "
               "SUM(v) AS total FROM t GROUP BY cat) AS inner1) AS outer1"),
    ("seeded", "SELECT s, n FROM (SELECT s, COUNT(*) AS n FROM fact "
               "WHERE price > 50 GROUP BY s) AS d ORDER BY n DESC"),
    # CTEs (test_engine.py:3192-3264, 4881)
    ("p4", "WITH big AS (SELECT p FROM t WHERE p > 2) SELECT SUM(p) FROM big"),
    ("kv", "WITH sums AS (SELECT k, SUM(v) AS s FROM t GROUP BY k), "
           "top AS (SELECT k, s FROM sums WHERE s > 45) "
           "SELECT t.v, top.s FROM t JOIN top ON t.k = top.k"),
    ("cv", "WITH f AS (SELECT c, v FROM t WHERE v > 1) "
           "SELECT c FROM f ORDER BY c ASC"),
    ("cv", "WITH f AS (SELECT c, v FROM t) SELECT SUM(v) FROM f WHERE c = 'b'"),
    ("p3", "WITH u AS (SELECT p FROM t WHERE p < 2 UNION ALL SELECT p FROM t "
           "WHERE p > 2) SELECT SUM(p) FROM u"),
    ("p3", "WITH c AS (SELECT p + 1 AS q FROM t) SELECT SUM(q) FROM c"),
    ("p3", "WITH a AS (WITH b AS (SELECT p FROM t WHERE p > 1) "
           "SELECT p FROM b) SELECT p FROM a ORDER BY p DESC"),
    ("alias_cte", "WITH big AS (SELECT k, v FROM t WHERE v > 5) "
                  "SELECT a.v FROM big a JOIN big b ON a.k = b.k LIMIT 3"),
    ("seeded", "WITH hot AS (SELECT k, s, price FROM fact WHERE price > 90) "
               "SELECT hot.s, dim.name FROM hot JOIN dim ON hot.k = dim.dk "
               "ORDER BY price DESC LIMIT 7"),
    # correlated subqueries (test_engine.py:3294-3501)
    ("corr", "SELECT cid FROM t WHERE EXISTS "
             "(SELECT 1 FROM orders WHERE ocid = cid)"),
    ("corr", "SELECT cid FROM t WHERE NOT EXISTS "
             "(SELECT 1 FROM orders WHERE ocid = cid)"),
    ("corr", "SELECT cid FROM t WHERE EXISTS "
             "(SELECT 1 FROM orders WHERE ocid = cid AND amt > 7)"),
    ("corr", "SELECT cid, (SELECT SUM(amt) FROM orders WHERE ocid = cid) "
             "AS s FROM t"),
    ("corr", "SELECT cid, (SELECT COUNT(amt) FROM orders WHERE ocid = cid) "
             "AS c FROM t"),
    ("corr", "SELECT cid FROM t WHERE "
             "(SELECT MAX(amt) FROM orders WHERE ocid = cid) > 7"),
    ("corr", "SELECT cid FROM t WHERE region IN "
             "(SELECT amt FROM orders WHERE ocid = cid)"),
    ("corr", "SELECT cid, (SELECT 2 * SUM(amt) + COUNT(amt) FROM orders "
             "WHERE ocid = cid) AS s FROM t"),
    ("corr", "SELECT cid FROM t WHERE cid < "
             "(SELECT 0.5 * AVG(amt) FROM orders WHERE ocid = cid)"),
    ("corr_in", "SELECT k FROM t WHERE v IN (SELECT uv FROM u WHERE uk = k)"),
    ("corr_in", "SELECT k FROM t WHERE v NOT IN "
                "(SELECT uv FROM u WHERE uk = k)"),
    ("emp", "SELECT name FROM emp e WHERE sal > "
            "(SELECT AVG(sal) FROM emp i WHERE i.dept = e.dept)"),
    ("emp", "SELECT name, (SELECT MAX(sal) FROM emp i WHERE i.dept = e.dept) "
            "AS mx FROM emp e"),
    ("emp", "SELECT dept, COUNT(name) AS n FROM emp e WHERE EXISTS "
            "(SELECT 1 FROM emp i WHERE i.dept = e.dept AND i.sal > 25) "
            "GROUP BY dept"),
    ("emp", "SELECT * FROM emp e WHERE EXISTS "
            "(SELECT 1 FROM emp i WHERE i.dept = e.dept AND i.sal > 25)"),
    ("li", "SELECT okey, skey FROM lineitem l1 WHERE EXISTS "
           "(SELECT * FROM lineitem l2 WHERE l2.okey = l1.okey "
           "AND l2.skey != l1.skey) ORDER BY okey ASC, skey ASC"),
    ("li", "SELECT okey FROM lineitem l1 WHERE NOT EXISTS "
           "(SELECT * FROM lineitem l2 WHERE l2.okey = l1.okey "
           "AND l2.skey != l1.skey) ORDER BY okey ASC"),
    ("li", "SELECT okey FROM lineitem l1 WHERE EXISTS (SELECT * FROM ext "
           "WHERE eokey = l1.okey AND eskey != l1.skey AND late > 0) "
           "ORDER BY okey ASC"),
    ("seeded", "SELECT k, price FROM fact WHERE price > (SELECT AVG(w) * 100 "
               "FROM dim WHERE dim.dk = fact.k) ORDER BY price DESC LIMIT 9"),
    ("seeded", "SELECT s, COUNT(*) AS n FROM fact WHERE NOT EXISTS (SELECT 1 "
               "FROM dim WHERE dk = k AND w > 0.3) GROUP BY s ORDER BY s ASC"),
    # uncorrelated scalar and IN (test_engine.py:3567-3661)
    ("p6", "SELECT p FROM t WHERE p > (SELECT AVG(p) FROM t)"),
    ("p6", "SELECT p FROM t WHERE p > (SELECT cut FROM lim)"),
    ("p6", "SELECT p - (SELECT MIN(p) FROM t) FROM t ORDER BY p ASC"),
    ("p6", "SELECT p + (SELECT cut FROM lim WHERE cut > 100) FROM t"),
    ("good", "SELECT v FROM t WHERE k IN (SELECT k FROM good WHERE flag > 0)"),
    ("good", "SELECT v FROM t WHERE k NOT IN (SELECT k FROM good)"),
    ("good", "SELECT v FROM t WHERE k IN (SELECT k FROM good WHERE flag > 5)"),
    ("city", "SELECT price FROM t WHERE city IN (SELECT city FROM eu)"),
    ("csv", "SELECT price FROM test WHERE quantity IN (3, 5)"),
    ("wide", "SELECT x FROM t WHERE wide = (SELECT MAX(wide) FROM t)"),
    ("wide", "SELECT x FROM t WHERE wide IN (SELECT wide FROM t WHERE x > 3)"),
    ("seeded", "SELECT name FROM dim WHERE dk IN (SELECT k FROM fact "
               "WHERE price > 99) ORDER BY name ASC"),
    ("seeded", "SELECT ki, s FROM fact WHERE s IN (SELECT s FROM fact "
               "WHERE price < 0.1) AND price > (SELECT MAX(w) * 99 FROM dim) "
               "ORDER BY ki ASC LIMIT 10"),
    # quantified comparisons (test_engine.py:3807-3872)
    ("csv", "SELECT price FROM test WHERE price > ALL "
            "(SELECT quantity FROM test)"),
    ("csv", "SELECT price FROM test WHERE price < ANY "
            "(SELECT quantity FROM test)"),
    ("csv", "SELECT price FROM test WHERE quantity = ANY "
            "(SELECT quantity FROM test WHERE price > 19)"),
    ("csv", "SELECT price FROM test WHERE quantity != ALL "
            "(SELECT quantity FROM test WHERE price > 19)"),
    ("csv", "SELECT price FROM test WHERE price > SOME "
            "(SELECT price FROM test WHERE price > 100)"),
    ("csv", "SELECT price FROM test WHERE price > ALL "
            "(SELECT price FROM test WHERE price > 100)"),
    ("csv", "SELECT price FROM test WHERE quantity = ALL "
            "(SELECT quantity FROM test WHERE quantity == 4)"),
    ("csv", "SELECT price FROM test WHERE quantity = ALL "
            "(SELECT quantity FROM test)"),
    ("csv", "SELECT price FROM test WHERE quantity != ANY "
            "(SELECT quantity FROM test)"),
    ("names", "SELECT v FROM t WHERE name > ALL "
              "(SELECT name FROM t WHERE v < 3)"),
    ("names", "SELECT v FROM t WHERE name = ANY "
              "(SELECT name FROM t WHERE v > 3)"),
    # EXISTS (test_engine.py:4695-4726)
    ("exists", "SELECT price FROM t WHERE EXISTS "
               "(SELECT x FROM other WHERE x > 1)"),
    ("exists", "SELECT price FROM t WHERE EXISTS "
               "(SELECT x FROM other WHERE x > 5)"),
    ("exists", "SELECT price FROM t WHERE NOT EXISTS "
               "(SELECT x FROM other WHERE x > 5)"),
    ("exists", "SELECT price FROM t WHERE EXISTS (SELECT x FROM other) "
               "AND price > 16"),
    ("exists", "SELECT CASE WHEN EXISTS (SELECT x FROM other WHERE x > 5) "
               "THEN 1 ELSE 2 END FROM t LIMIT 1"),
    ("exists", "SELECT price FROM t WHERE EXISTS (SELECT SUM(x) FROM other "
               "GROUP BY x HAVING SUM(x) > 1)"),
    # query_sql_table over single tables and joins
    ("seeded", "SELECT price, ki, s FROM fact WHERE price > 50 "
               "ORDER BY ki DESC, price ASC LIMIT 12"),
    ("seeded", "SELECT k, price * 2 AS p2, nv FROM fact WHERE s = 'date' "
               "LIMIT 20 OFFSET 5"),
    ("seeded", "SELECT DISTINCT s, k FROM fact WHERE k < 4"),
    ("seeded", "SELECT s, COUNT(*) AS n, SUM(price) AS total, MAX(ki) "
               "FROM fact GROUP BY s ORDER BY total DESC"),
    ("seeded", "SELECT DISTINCT COUNT(*) FROM fact GROUP BY k "
               "ORDER BY COUNT(*) DESC"),
    ("seeded", "SELECT MIN(price), MAX(price), COUNT(nv) FROM fact"),
    ("seeded", "SELECT k, dim.name, w FROM fact JOIN dim ON k = dim.dk "
               "ORDER BY price DESC LIMIT 5"),
    ("seeded", "SELECT dim.name, SUM(price) AS total FROM fact JOIN dim "
               "ON k = dim.dk GROUP BY dim.name ORDER BY total DESC LIMIT 4"),
    ("seeded", "SELECT * FROM dim WHERE w > 0.8"),
]

FIRST_COLUMN = {i for i, (setup, q) in enumerate(CASES)
                if setup in ("union", "setop", "strs", "strs3", "corr", "p6",
                             "good", "exists", "csv", "reg")}
# The reference's query_sql_table raises "Unknown table" on these (see
# test_derived_table_alias_resolves); they compare through query_sql.
SQL_ONLY = {
    "SELECT s FROM (SELECT SUM(v) AS s FROM u GROUP BY c) AS d "
    "ORDER BY s ASC",
}


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{s}-{i}" for i, (s, _q) in enumerate(CASES)])
def test_matches_reference(dbs, i):
    setup, q = CASES[i]
    ref, port = dbs(setup)
    if q not in SQL_ONLY:
        _same_table(ref.query_sql_table(q), port.query_sql_table(q), q)
    if i in FIRST_COLUMN:
        _same(ref.query_sql(q), port.query_sql(q), q)


# (setup, SQL, error class, message): both packages raise, with the same
# message.
ERRORS = [
    ("union_pv", "SELECT p, v FROM t UNION SELECT p FROM t", ValidationError,
     "same number"),
    ("union_pv", "SELECT p FROM t ORDER BY p ASC UNION SELECT p FROM u",
     ParseError, "final"),
    ("setop", "SELECT p FROM t UNION SELECT q FROM u ORDER BY q + 1",
     UnsupportedError, "output column"),
    ("p3", "WITH c AS (SELECT nope FROM t) SELECT p FROM t", ValidationError,
     "Unknown column"),
    ("p3", "WITH c (SELECT p FROM t) SELECT p FROM t", ParseError, "AS"),
    ("nested", "SELECT nope FROM (SELECT SUM(v) AS total FROM t) AS agg",
     ValidationError, "Unknown column"),
    ("p3", "SELECT p FROM t WHERE p > (SELECT p FROM t)", ExecutionError,
     "3 rows"),
    ("p3", "SELECT p FROM t WHERE p IN (SELECT p, p FROM t)",
     ValidationError, "exactly one column"),
    ("corr", "SELECT cid FROM t WHERE EXISTS "
             "(SELECT 1 FROM orders WHERE amt > cid)", UnsupportedError,
     "column equalities"),
    ("corr", "SELECT cid FROM t WHERE EXISTS (SELECT SUM(amt) FROM orders "
             "WHERE ocid = cid GROUP BY amt)", UnsupportedError, "GROUP BY"),
    ("corr", "SELECT cid, (SELECT amt FROM orders WHERE ocid = cid) FROM t",
     UnsupportedError, "single aggregate"),
    ("corr", "SELECT cid FROM t WHERE cid < "
             "(SELECT amt + SUM(amt) FROM orders WHERE ocid = cid)",
     UnsupportedError, "inside aggregates"),
    ("corr", "SELECT cid FROM t WHERE EXISTS "
             "(SELECT amt FROM orders WHERE ocid = cid ORDER BY cid)",
     UnsupportedError, "only in WHERE"),
    ("corr", "SELECT cid FROM t WHERE cid + 1 IN "
             "(SELECT amt FROM orders WHERE ocid = cid)", UnsupportedError,
     "bare column on the left"),
    ("li", "SELECT okey FROM lineitem l1 WHERE EXISTS (SELECT * FROM ext "
           "WHERE eokey != l1.okey AND eskey != l1.skey)", UnsupportedError,
     "at most one"),
    ("li", "SELECT okey FROM lineitem l1 WHERE EXISTS "
           "(SELECT * FROM ext WHERE eskey != l1.skey)", UnsupportedError,
     "equality correlation"),
    ("li", "SELECT okey FROM lineitem l1 WHERE 1 < "
           "(SELECT COUNT(*) FROM ext WHERE eskey != l1.skey)",
     UnsupportedError, "only in EXISTS"),
    ("reg", "SELECT p FROM t WHERE p IN (SELECT q FROM nowhere)",
     ValidationError, "Unknown table"),
]


@pytest.mark.parametrize("setup,q,exc,match", ERRORS)
def test_raises_as_reference(dbs, setup, q, exc, match):
    ref, port = dbs(setup)
    with pytest.raises(exc, match=match) as got:
        port.query_sql_table(q)
    with pytest.raises(_ref_exc(exc)) as want:
        ref.query_sql_table(q)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["strings", "values"])
def test_in_subquery_limits(kind):
    """IN (SELECT …) holds at most 1024 distinct strings or 65536
    distinct values; beyond, both packages raise the same error."""
    n = 1025 if kind == "strings" else 65537
    col = (np.array([f"s{i:05d}" for i in range(n)]) if kind == "strings"
           else np.arange(n, dtype=np.float32))
    host = HostTable.from_dict({"c": col})
    q = "SELECT c FROM t WHERE c IN (SELECT c FROM t)"
    with pytest.raises(UnsupportedError, match="use a JOIN") as got:
        PortDB(host, device="cpu").query_sql(q)
    with pytest.raises(ref_errors.UnsupportedError) as want:
        _ref_db(host).query_sql(q)
    assert str(got.value) == str(want.value)


def test_facade_only_features_raise_in_the_executor(dbs):
    """Set operations and CTEs reaching run_query / run_query_table
    raise as the reference's do."""
    from warpdb_tpu import frontend as ref_frontend
    from warpdb_tpu.engine import executor as ref_ex
    from warpdb_tpu_torch.engine import executor as port_ex
    from warpdb_tpu_torch.frontend import parse_query, tokenize

    ref, port = dbs("setop")
    for q in ("SELECT p FROM t UNION SELECT q FROM u",
              "WITH c AS (SELECT p FROM t) SELECT p FROM c"):
        for fn in ("run_query", "run_query_table"):
            with pytest.raises(UnsupportedError, match="facade") as got:
                getattr(port_ex, fn)(parse_query(tokenize(q)), port.table,
                                     port._catalog)
            with pytest.raises(ref_errors.UnsupportedError) as want:
                getattr(ref_ex, fn)(
                    ref_frontend.parse_query(ref_frontend.tokenize(q)),
                    ref.table, ref._catalog)
            assert str(got.value) == str(want.value)


@pytest.mark.parametrize("trial", range(5))
def test_fuzz_correlated_against_oracle(trial):
    """Correlated EXISTS and scalar SUM against a nested-loop NumPy
    oracle (duplicate keys, misses, residual predicates) and against the
    reference (test_engine.py:3530)."""
    rng = np.random.default_rng(41 + 100 * trial)
    n, m = int(rng.integers(20, 60)), int(rng.integers(10, 50))
    k = rng.integers(0, 12, n).astype(np.float32)
    val = rng.normal(0, 10, n).round(1).astype(np.float32)
    uk = rng.integers(0, 12, m).astype(np.float32)
    uv = rng.normal(0, 10, m).round(1).astype(np.float32)
    host = HostTable.from_dict({"k": k, "val": val})
    u = HostTable.from_dict({"uk": uk, "uv": uv})
    port, ref = PortDB(host, device="cpu"), _ref_db(host)
    port.register_table("u", u)
    ref.register_table("u", _ref_table(u))
    q1 = ("SELECT val FROM t WHERE EXISTS "
          "(SELECT 1 FROM u WHERE uk = k AND uv > 0)")
    got = port.query_sql(q1)
    want = val[np.array([np.any((uk == kk) & (uv > 0)) for kk in k])]
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)
    _same(ref.query_sql(q1), got, q1)
    q2 = "SELECT (SELECT SUM(uv) FROM u WHERE uk = k) AS s FROM t"
    got2 = port.query_sql_table(q2)
    want2 = np.array([uv[uk == kk].sum() if np.any(uk == kk) else np.nan
                      for kk in k], np.float32)
    np.testing.assert_allclose(np.asarray(got2["s"], np.float32), want2,
                               rtol=1e-4, equal_nan=True)
    _same_table(ref.query_sql_table(q2), got2, q2)


@pytest.mark.parametrize("trial", range(5))
def test_fuzz_correlated_exists_neq_against_oracle(trial):
    """EXISTS with one <> correlation against a NumPy nested-loop oracle
    and the reference (test_engine.py:3504)."""
    rng = np.random.default_rng(43 + 100 * trial)
    n, m = int(rng.integers(20, 60)), int(rng.integers(10, 50))
    k = rng.integers(0, 8, n).astype(np.float32)
    s = rng.integers(0, 4, n).astype(np.float32)
    uk = rng.integers(0, 8, m).astype(np.float32)
    us = rng.integers(0, 4, m).astype(np.float32)
    uf = rng.integers(0, 2, m).astype(np.float32)
    host = HostTable.from_dict({"k": k, "s": s})
    u = HostTable.from_dict({"uk": uk, "us": us, "uf": uf})
    port, ref = PortDB(host, device="cpu"), _ref_db(host)
    port.register_table("u", u)
    ref.register_table("u", _ref_table(u))
    q = ("SELECT k FROM t WHERE EXISTS "
         "(SELECT * FROM u WHERE uk = k AND us != s AND uf > 0)")
    got = port.query_sql(q)
    want = k[np.array([bool(np.any((uk == kk) & (us != ss) & (uf > 0)))
                       for kk, ss in zip(k, s)])]
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)
    _same(ref.query_sql(q), got, q)


def test_cte_memo_reuses_the_materialisation(dbs):
    _ref, port = dbs("p3")
    sql = "WITH c AS (SELECT p + 1 AS q FROM t) SELECT SUM(q) FROM c"
    assert port.query_sql(sql) == [9.0]
    first = {k: v for k, v in port._cte_memo.items() if k[0] == "c"}
    assert len(first) == 1
    assert port.query_sql(sql) == [9.0]
    for key, table in first.items():
        assert port._cte_memo[key] is table  # the same DeviceTable


def test_materialised_tables_land_on_the_base_device(monkeypatch):
    """Every derived, CTE, set-op and decorrelation table is built on the
    facade's device, named explicitly (the loader's default is the card,
    which a CPU facade must not reach), and so are all its columns."""
    fact, registered = _seeded()
    port = PortDB(fact, device="cpu")
    for name, host in registered.items():
        port.register_table(name, host)
    devices = []
    real = DeviceTable.from_host.__func__

    def spy(cls, host, device=None, **kw):
        devices.append(device)
        return real(cls, host, device=device or "cpu", **kw)

    monkeypatch.setattr(DeviceTable, "from_host", classmethod(spy))
    port.query_sql_table(
        "WITH hot AS (SELECT k, price FROM fact WHERE price > 90 "
        "UNION ALL SELECT dk, w FROM dim) "
        "SELECT d.k, d.n FROM (SELECT k, COUNT(*) AS n FROM hot GROUP BY k) "
        "AS d WHERE EXISTS (SELECT 1 FROM dim WHERE dk = d.k)")
    port.query_sql("SELECT k FROM fact WHERE price > "
                   "(SELECT AVG(w) * 100 FROM dim WHERE dim.dk = fact.k)")
    assert len(devices) >= 4
    assert all(d is not None and torch.device(d) == port.device
               for d in devices)
    tables = [*port._cte_memo.values(),
              *(t for src in (port.table, *port._catalog.values())
                for t in getattr(src, "_subq_memo", {}).values())]
    assert len(tables) >= 4
    for t in tables:
        assert t.device == port.device
        assert all(c.device == port.device for c in t.columns.values())


# --- reference faults the port does not copy --------------------------------


def test_in_subquery_wide_ints_compare_as_ints():
    """IN (SELECT wide) against an f32 column keeps only set values f32
    holds exactly.  The reference checks that in f64 (executor.py:785),
    where 2^53 + 1 passes and then matches a stored 2^53; the port
    compares Python ints."""
    host = HostTable.from_dict({"x": _f(2.0**53, 7.0, 2.0**40)})
    wide = HostTable.from_dict(
        {"w": np.array([2**53 + 1, 7, 2**40], np.int64)})
    port, ref = PortDB(host, device="cpu"), _ref_db(host)
    port.register_table("wide", wide)
    ref.register_table("wide", _ref_table(wide))
    q = "SELECT x FROM t WHERE x IN (SELECT w FROM wide)"
    assert port.query_sql(q) == [7.0, 2.0**40]
    assert ref.query_sql(q) in ([7.0, 2.0**40], [2.0**53, 7.0, 2.0**40])


@pytest.mark.parametrize("q,want", [
    ("SELECT v FROM t WHERE s ILIKE 'ap%' AND v > (SELECT MIN(v) FROM t)",
     [2.0, 4.0]),
    ("SELECT v FROM t WHERE s REGEXP '^a' AND v > (SELECT MIN(v) FROM t)",
     [2.0]),
])
def test_subquery_keeps_ilike_and_regexp(q, want):
    """The reference rebuilds LIKE nodes without their ILIKE / REGEXP
    flags once a statement holds a subquery (executor.py:895-903), so it
    matches case-sensitively or as a LIKE pattern; the port keeps
    them."""
    host = HostTable.from_dict({
        "s": np.array(["Apple", "apple", "banana", "APRICOT"]),
        "v": _f(1, 2, 3, 4)})
    assert PortDB(host, device="cpu").query_sql(q) == want
    got = _ref_db(host).query_sql(q)
    assert got in (want, [2.0], [])  # the recorded reference fault


@pytest.mark.parametrize("q", [
    "SELECT tot FROM (SELECT s, SUM(price) AS tot FROM fact GROUP BY s) AS d",
    "SELECT d.tot, dim.w FROM (SELECT k, SUM(price) AS tot FROM fact "
    "GROUP BY k) AS d JOIN dim ON d.k = dim.dk",
])
def test_derived_table_alias_resolves(dbs, q):
    """Once a table is registered, the reference's query_sql_table looks
    the derived table's alias up in the catalog on its second pass (each
    select item's, or the join's) and raises "Unknown table"; the port
    answers, checked against NumPy."""
    ref, port = dbs("seeded")
    fact, registered = _seeded()
    f = {c.name: c.data for c in fact.columns}
    got = port.query_sql_table(q)
    keys = np.unique(f["s"] if "GROUP BY s" in q else f["k"])
    sums = [f["price"][(f["s"] if "GROUP BY s" in q else f["k"]) == key]
            .astype(np.float64).sum() for key in keys]
    if "JOIN" not in q:
        np.testing.assert_allclose(got["tot"], sums, rtol=1e-5)
    else:
        dim = {c.name: c.data for c in registered["dim"].columns}
        want = [(s, dim["w"][dim["dk"] == key][0])
                for key, s in zip(keys, sums) if key in dim["dk"]]
        np.testing.assert_allclose(got["d.tot"], [a for a, _ in want],
                                   rtol=1e-5)
        np.testing.assert_array_equal(got["dim.w"], [b for _, b in want])
    with pytest.raises(ref_errors.ValidationError, match="Unknown table: d"):
        ref.query_sql_table(q)


def _nan_keys():
    t = HostTable.from_dict({"k": _f(1, np.nan, 3, 4)})
    u = HostTable.from_dict({"uk": _f(np.nan, 1, 4), "uv": _f(1, 2, 3)})
    port, ref = PortDB(t, device="cpu"), _ref_db(t)
    port.register_table("u", u)
    ref.register_table("u", _ref_table(u))
    return port, ref


@pytest.mark.parametrize("q,want", [
    ("SELECT k FROM t WHERE EXISTS (SELECT 1 FROM u WHERE uk = k)",
     {"k": [1.0, 4.0]}),
    ("SELECT k FROM t WHERE NOT EXISTS (SELECT 1 FROM u WHERE uk = k)",
     {"k": [np.nan, 3.0]}),
    ("SELECT (SELECT COUNT(*) FROM u WHERE uk = k) AS n FROM t",
     {"n": [1.0, 0.0, 0.0, 1.0]}),
])
def test_correlated_nan_keys_never_match(q, want):
    """A NaN correlation key matches nothing.  The reference's decorrelated
    join matches a NaN key with a NaN key (its equi-join does)."""
    port, ref = _nan_keys()
    _same_table(want, port.query_sql_table(q), q)
    got = ref.query_sql_table(q)
    assert list(got) == list(want)  # the values are the recorded fault


def test_decorrelation_memo_keys_on_output_names():
    """An EXISTS and a scalar COUNT(*) over the same correlation share
    one canonical derived query; the reference's memo key omits the
    output names, hands the second the first's table and raises
    "Unknown column: __corr0.__v0".  The port keys on the names."""
    t = HostTable.from_dict({"k": _f(1, 2, 3, 4)})
    u = HostTable.from_dict({"uk": _f(2, 1, 4, 4)})
    port, ref = PortDB(t, device="cpu"), _ref_db(t)
    port.register_table("u", u)
    ref.register_table("u", _ref_table(u))
    first = "SELECT k FROM t WHERE EXISTS (SELECT 1 FROM u WHERE uk = k)"
    second = "SELECT (SELECT COUNT(*) FROM u WHERE uk = k) AS n FROM t"
    _same_table(ref.query_sql_table(first), port.query_sql_table(first),
                first)
    assert port.query_sql_table(second) == {"n": [1.0, 1.0, 0.0, 2.0]}
    with pytest.raises(ref_errors.ValidationError, match="__corr0.__v0"):
        ref.query_sql_table(second)
