"""The port's own copies of the reference's host modules (``errors``,
``frontend``, the host half of ``storage``) give the reference's results:
the same error classes and messages, tokens, canonical strings, host
tables, stats and dictionaries, each side built by its own package from
the same input."""

import dataclasses

import numpy as np
import pytest

from warpdb_tpu import errors as ref_errors
from warpdb_tpu import frontend as ref_frontend
from warpdb_tpu import storage as ref_storage
from warpdb_tpu.storage import strings as ref_strings
from warpdb_tpu_torch import errors, frontend, storage
from warpdb_tpu_torch.storage import strings

ERROR_CLASSES = ["WarpDBError", "TokenizeError", "ParseError",
                 "ValidationError", "ExecutionError", "UnsupportedError"]


@pytest.mark.parametrize("name", ERROR_CLASSES)
def test_error_classes_match_reference(name):
    port, ref = getattr(errors, name), getattr(ref_errors, name)
    assert port is not ref
    assert [c.__name__ for c in port.__mro__] == [
        c.__name__ for c in ref.__mro__]


STATEMENTS = [
    "price * quantity WHERE price > 15",
    "SELECT SUM(price) FROM test GROUP BY quantity HAVING COUNT(*) > 1",
    "SELECT a.x, b.y FROM t a LEFT JOIN u b ON a.k = b.k "
    "WHERE a.s LIKE 'ab%' ORDER BY a.x DESC LIMIT 5 OFFSET 2",
    "WITH c AS (SELECT k FROM t UNION SELECT k FROM u) SELECT COUNT(*) "
    "FROM c WHERE k IN (SELECT k FROM u) AND NOT EXISTS "
    "(SELECT 1 FROM u WHERE u.k = c.k)",
    "SELECT CASE WHEN price > 5 THEN 'hi' ELSE 'lo' END AS band, "
    "SUM(price) OVER (PARTITION BY k ORDER BY price) FROM t",
    "SELECT k FROM t WHERE x BETWEEN 1 AND 2 AND y IS NOT NULL",
]


@pytest.mark.parametrize("text", STATEMENTS)
def test_tokens_and_canonical_strings_match_reference(text):
    assert repr(frontend.tokenize(text)) == repr(ref_frontend.tokenize(text))
    if text.startswith(("SELECT", "WITH")):
        port = frontend.parse_query_text(text)
        ref = ref_frontend.parse_query_text(text)
    else:
        port = frontend.parse_expression_text(text.split(" WHERE ")[0])
        ref = ref_frontend.parse_expression_text(text.split(" WHERE ")[0])
    assert port.canonical() == ref.canonical()
    assert type(port).__module__.startswith("warpdb_tpu_torch.")


BAD_STATEMENTS = [
    ("price $ 2", "parse_expression_text", "TokenizeError"),
    ("price * (quantity", "parse_expression_text", "ParseError"),
    ("SELECT price FROM", "parse_query_text", "ParseError"),
    ("SELECT SUM( FROM t", "parse_query_text", "ParseError"),
    ("SELECT price FROM t GROUP quantity", "parse_query_text", "ParseError"),
    ("SELECT price FROM t WHERE", "parse_query_text", "ParseError"),
    ("SELECT price FROM t ORDER price", "parse_query_text", "ParseError"),
    ("WITH c (SELECT p FROM t) SELECT p FROM t", "parse_query_text",
     "ParseError"),
]


@pytest.mark.parametrize("text,fn,exc", BAD_STATEMENTS)
def test_parse_errors_match_reference(text, fn, exc):
    with pytest.raises(getattr(errors, exc)) as got:
        getattr(frontend, fn)(text)
    with pytest.raises(getattr(ref_errors, exc)) as want:
        getattr(ref_frontend, fn)(text)
    assert str(got.value) == str(want.value)


def test_validation_errors_match_reference():
    text = "SELECT nope FROM t WHERE price > 1"
    with pytest.raises(errors.ValidationError) as got:
        frontend.validate_query(frontend.parse_query_text(text),
                                ["price", "quantity"])
    with pytest.raises(ref_errors.ValidationError) as want:
        ref_frontend.validate_query(ref_frontend.parse_query_text(text),
                                    ["price", "quantity"])
    assert str(got.value) == str(want.value)
    assert "Unknown column: nope" in str(got.value)


def _data() -> dict:
    rng = np.random.default_rng(12)
    n = 500
    nv = rng.uniform(0, 10, n).astype(np.float32)
    nv[::9] = np.nan
    return {
        "price": rng.uniform(0, 100, n).astype(np.float32),
        "qty": rng.integers(-5, 40, n).astype(np.int32),
        "wide": rng.integers(-(2**62), 2**62, n).astype(np.int64),
        "f64": rng.integers(0, 100, n).astype(np.float64) / 4,
        "nv": nv,
        "s": rng.choice(["fig", "apple", "kiwi", ""], n),
        "floats": [float(x) for x in rng.uniform(0, 1, n)],
    }


def _same_host(port, ref):
    assert port.num_rows == ref.num_rows
    assert port.column_names == ref.column_names
    for pc, rc in zip(port.columns, ref.columns):
        assert pc.dtype.value == rc.dtype.value, pc.name
        assert pc.data.dtype == rc.data.dtype, pc.name
        np.testing.assert_array_equal(pc.data, rc.data, err_msg=pc.name)
        assert dataclasses.astuple(pc.stats) == dataclasses.astuple(rc.stats)


@pytest.mark.parametrize("source", ["dict", "data/test.csv",
                                    "data/extended.csv", "data/test.json"])
def test_host_tables_match_reference(source):
    if source == "dict":
        port = storage.HostTable.from_dict(_data())
        ref = ref_storage.HostTable.from_dict(_data())
    else:
        port, ref = storage.load_table(source), ref_storage.load_table(source)
    assert isinstance(port, storage.HostTable)
    _same_host(port, ref)
    assert repr(port) == repr(ref)


def test_dictionaries_match_reference():
    d = _data()
    cols = {"s": d["s"], "t": np.array(["zebra", "fig"] * 250)}
    (port_codes, port_vocab) = strings.encode_string_columns(cols)
    (ref_codes, ref_vocab) = ref_strings.encode_string_columns(cols)
    np.testing.assert_array_equal(port_vocab, ref_vocab)
    for name in cols:
        np.testing.assert_array_equal(port_codes[name], ref_codes[name])
    wide = {"wide": d["wide"]}
    (pw, pv), (rw, rv) = (strings.encode_int64_columns(wide),
                          ref_strings.encode_int64_columns(wide))
    np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(pw["wide"], rw["wide"])
    for text in ("fig", "banana", "", "zz"):
        assert strings.literal_code(port_vocab, text) == (
            ref_strings.literal_code(ref_vocab, text))
    codes = port_codes["t"][:20]
    assert strings.decode_codes(codes, port_vocab) == (
        ref_strings.decode_codes(codes, ref_vocab))
