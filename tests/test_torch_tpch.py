"""The 22 TPC-H-derived queries of ``benchmarks/tpch.py`` through the
port on the CPU, at the suite's test scale (``tests/test_tpch.py``):
each result is held against the suite's NumPy oracle with its own gate
(``check_results``, rtol 2e-3) and against the reference's
``query_sql_table``: row for row where the ORDER BY is total, as a
sorted multiset of rows where it can tie (ORDER BY a measure with a
LIMIT) or is absent."""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "benchmarks"))

import tpch  # noqa: E402

from warpdb_tpu_torch import WarpDB  # noqa: E402
from warpdb_tpu_torch.storage import HostTable  # noqa: E402

# ORDER BY a measure that can tie, or no ORDER BY at all.
UNORDERED = {"q2", "q3", "q10", "q11", "q15", "q18"}


def build_port_db(tables: dict, device="cpu") -> WarpDB:
    """The port's counterpart of ``tpch.build_db``: the same
    registrations, the fact table under "lineitem" too."""
    db = WarpDB(HostTable.from_dict(tables["lineitem"]), device=device)
    db.register_table("lineitem", db.table)
    for name in ("orders", "customer", "supplier", "nation", "region",
                 "part", "partsupp"):
        db.register_table(name, HostTable.from_dict(tables[name]))
    return db


@pytest.fixture(scope="module")
def setup():
    tables = tpch.make_tables(12_000, seed=11)
    return tables, build_port_db(tables), tpch.build_db(tables)


def _rows(out: dict) -> list:
    """The result's rows, sorted (NaNs last)."""
    return sorted(zip(*out.values()), key=lambda row: tuple(
        (1, 0.0) if isinstance(x, float) and x != x else (0, x) for x in row
    ))


@pytest.mark.parametrize("name", list(tpch.QUERIES))
def test_tpch_query_matches_oracle_and_reference(setup, name):
    tables, port, ref = setup
    sql = tpch.QUERIES[name]
    got = port.query_sql_table(sql)
    tpch.check_results(name, got, tpch.oracle(tables, name))
    want = ref.query_sql_table(sql)
    assert list(got) == list(want)
    if name in UNORDERED:
        g, w = _rows(got), _rows(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert [x for x in a if isinstance(x, str)] == \
                [x for x in b if isinstance(x, str)]
            np.testing.assert_allclose(
                [x for x in a if not isinstance(x, str)],
                [x for x in b if not isinstance(x, str)], rtol=1e-5)
        return
    for col in want:
        if want[col] and isinstance(want[col][0], str):
            assert got[col] == want[col], (name, col)
        else:
            np.testing.assert_allclose(
                np.asarray(got[col], np.float64),
                np.asarray(want[col], np.float64), rtol=1e-5, atol=1e-6,
                err_msg=f"{name} {col}")


@pytest.mark.parametrize("name", list(tpch.QUERIES))
def test_tpch_first_column_is_query_sql(setup, name):
    """``query_sql`` answers the first column of ``query_sql_table``."""
    _tables, port, _ref = setup
    sql = tpch.QUERIES[name]
    first = next(iter(port.query_sql_table(sql).values()))
    got = port.query_sql(sql)
    if first and isinstance(first[0], str):
        assert got == first
    else:
        np.testing.assert_array_equal(np.asarray(got, np.float64),
                                      np.asarray(first, np.float64))
