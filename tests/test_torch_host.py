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


def test_arrow_struct_layouts_match_reference():
    import ctypes

    from warpdb_tpu.interchange import arrow_export as ref_ax
    from warpdb_tpu_torch.interchange import arrow_export as ax

    for name in ("ArrowSchemaStruct", "ArrowArrayStruct"):
        port, ref = getattr(ax, name), getattr(ref_ax, name)
        assert port is not ref
        assert ctypes.sizeof(port) == ctypes.sizeof(ref)
        assert [(f, getattr(port, f).offset) for f, _t in port._fields_] == [
            (f, getattr(ref, f).offset) for f, _t in ref._fields_]
    assert ax.SHM_PREFIX == ref_ax.SHM_NAME


def _exported(mod, export, *args) -> list:
    """Every field of an exported struct array and its children, and the
    bytes of each buffer, read back through ``mod``'s layouts."""
    import ctypes

    from warpdb_tpu_torch.api import _capsule_address

    arr_c, schema_c = export(*args)
    arr = mod.ArrowArrayStruct.from_address(_capsule_address(arr_c))
    schema = mod.ArrowSchemaStruct.from_address(_capsule_address(schema_c))

    def read(a, s, lengths):
        out = [s.format, s.name, s.flags, a.length, a.null_count, a.offset,
               a.n_buffers, a.n_children]
        for i, nbytes in enumerate(lengths):
            ptr = a.buffers[i + 1]
            out.append(ctypes.string_at(ptr, nbytes) if nbytes else b"")
        return out

    if schema.n_children == 0:
        got = read(arr, schema, [4 * arr.length])
    else:
        got = [schema.format, arr.length]
        for i in range(schema.n_children):
            ca, cs = arr.children[i].contents, schema.children[i].contents
            if cs.format == b"u":
                offs = ctypes.string_at(ca.buffers[1], 4 * (ca.length + 1))
                end = int(np.frombuffer(offs, np.int32)[-1])
                got += read(ca, cs, [4 * (ca.length + 1), end])
            else:
                got += read(ca, cs, [4 * ca.length])
    arr.release(ctypes.pointer(arr))
    return got


@pytest.mark.parametrize("shm", [False, True])
def test_arrow_export_matches_reference(shm, monkeypatch):
    import os

    from warpdb_tpu.interchange import arrow_export as ref_ax
    from warpdb_tpu_torch.interchange import arrow_export as ax

    # The reference's one fixed segment name is shared by every process;
    # give its export here a name of this process's own.
    monkeypatch.setattr(ref_ax, "SHM_NAME",
                        f"/warpdb_result_reference_{os.getpid()}")
    values = np.random.default_rng(4).normal(0, 1, 1001).astype(np.float32)
    values[::7] = np.nan
    got = _exported(ax, ax.export_to_arrow_capsules, values, shm)
    want = _exported(ref_ax, ref_ax.export_to_arrow_capsules, values, shm)
    assert got == want


def test_arrow_table_export_matches_reference():
    from warpdb_tpu.interchange import arrow_export as ref_ax
    from warpdb_tpu_torch.interchange import arrow_export as ax

    cols = {"f": np.float32([1.5, -0.0, np.inf]),
            "s": ["ä", "", "long string"],
            "empty_f": np.zeros(3, np.float32)}
    assert _exported(ax, ax.export_table_to_arrow_capsules, cols) == (
        _exported(ref_ax, ref_ax.export_table_to_arrow_capsules, cols))
    empty = {"s": [], "f": np.zeros(0, np.float32)}
    assert _exported(ax, ax.export_table_to_arrow_capsules, empty) == (
        _exported(ref_ax, ref_ax.export_table_to_arrow_capsules, empty))


# --- storage/chunks.py and DeviceTable.from_host(dicts_override=…) --------


def _chunk_files(tmp_path) -> dict:
    """One file per format the stream reads, written from a seed (the
    tests of ``tests/test_storage.py:46,58,150,171`` and
    ``tests/test_native.py:88,104,125``)."""
    rng = np.random.default_rng(12)
    files = {}
    p = tmp_path / "chunked.csv"
    p.write_text("a,b\n" + "".join(f"{i},{i * 2}\n" for i in range(10)))
    files["csv"] = (p, 3)
    vals = rng.uniform(0, 100, (5000, 2))
    p = tmp_path / "s2.csv"
    p.write_text("x,y\n" + "".join(f"{a:.4f},{b:.4f}\n" for a, b in vals))
    files["csv_5000"] = (p, 1024)
    p = tmp_path / "blank.csv"
    p.write_text("x,y\n1,2\n\n3,4\r\n5,6")
    files["csv_blank_lines"] = (p, 2)
    p = tmp_path / "t.ndjson"
    p.write_text("\n".join(
        f'{{"price": {i}.5, "quantity": {i % 3}, "s": "v{i % 4}"}}'
        for i in range(10)) + "\nnot json\n")
    files["ndjson"] = (p, 4)
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:
        return files
    t = pa.table({"price": np.arange(5000, dtype=np.float32),
                  "quantity": (np.arange(5000) % 7).astype(np.int32),
                  "s": [f"k{i % 5}" for i in range(5000)]})
    p = tmp_path / "t.parquet"
    pq.write_table(t, p, row_group_size=1200)
    files["parquet"] = (p, 800)
    p = tmp_path / "t.arrow"
    with pa.OSFile(str(p), "wb") as sink:
        with pa.ipc.new_file(sink, t.schema) as writer:
            for b in t.to_batches(max_chunksize=1500):
                writer.write_batch(b)
    files["arrow"] = (p, 1000)
    import pyarrow.orc as orc

    p = tmp_path / "t.orc"
    orc.write_table(t, str(p))
    files["orc"] = (p, 2048)
    return files


FORMATS = ["csv", "csv_5000", "csv_blank_lines", "ndjson", "parquet",
           "arrow", "orc"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_table_chunks_match_reference(tmp_path, fmt):
    from warpdb_tpu.storage import chunks as ref_chunks
    from warpdb_tpu_torch.storage import chunks

    files = _chunk_files(tmp_path)
    if fmt not in files:
        pytest.skip("pyarrow is not installed")
    path, rows = files[fmt]
    assert chunks.table_column_names(str(path)) == (
        ref_chunks.table_column_names(str(path)))
    got = list(chunks.iter_table_chunks(str(path), rows))
    want = list(ref_chunks.iter_table_chunks(str(path), rows))
    assert [c.num_rows for c in got] == [c.num_rows for c in want]
    assert max(c.num_rows for c in got) <= rows
    for g, w in zip(got, want):
        assert isinstance(g, storage.HostTable)
        _same_host(g, w)


def test_table_chunks_schema_and_errors_match_reference(tmp_path):
    from warpdb_tpu.storage import chunks as ref_chunks
    from warpdb_tpu_torch.storage import chunks

    p = tmp_path / "k.csv"
    p.write_text("k,v,s\n" + "".join(f"{2**40 + i},{i}.5,c{i % 3}\n"
                                     for i in range(7)))
    got = list(chunks.iter_table_chunks(
        str(p), 3, [storage.DataType.INT64, storage.DataType.FLOAT32,
                    storage.DataType.STRING]))
    want = list(ref_chunks.iter_table_chunks(
        str(p), 3, [ref_storage.DataType.INT64,
                    ref_storage.DataType.FLOAT32,
                    ref_storage.DataType.STRING]))
    for g, w in zip(got, want):
        _same_host(g, w)
    bad = tmp_path / "bad.csv"
    bad.write_text("a,b\n1,2\nxx,4\n")
    cases = [(str(bad), 10), (str(tmp_path / "none.csv"), 10),
             (str(p), 0), (str(tmp_path / "t.xlsx"), 10)]
    (tmp_path / "t.xlsx").write_text("")
    for path, rows in cases:
        with pytest.raises(Exception) as g:
            list(chunks.iter_table_chunks(path, rows))
        with pytest.raises(Exception) as w:
            list(ref_chunks.iter_table_chunks(path, rows))
        assert type(g.value).__name__ == type(w.value).__name__
        assert str(g.value) == str(w.value)
    for path in (str(tmp_path / "none.csv"), str(tmp_path / "t.xlsx")):
        with pytest.raises(Exception) as g:
            chunks.table_column_names(path)
        with pytest.raises(Exception) as w:
            ref_chunks.table_column_names(path)
        assert type(g.value).__name__ == type(w.value).__name__
        assert str(g.value) == str(w.value)


def test_dicts_override_errors_match_reference():
    from warpdb_tpu.storage.table import DeviceTable as RefDeviceTable
    from warpdb_tpu_torch.storage.table import DeviceTable

    cols = {"s": np.array(["fig", "kiwi", "fig"], dtype=object),
            "v": np.float32([1, 2, 3])}
    dtypes = {"s": "STRING"}
    port = storage.HostTable.from_dict(
        cols, {k: getattr(storage.DataType, t) for k, t in dtypes.items()})
    ref = ref_storage.HostTable.from_dict(
        cols, {k: getattr(ref_storage.DataType, t)
               for k, t in dtypes.items()})
    vocab = np.array(["apple", "fig", "kiwi"])
    dt = DeviceTable.from_host(port, device="cpu",
                               dicts_override={"s": vocab})
    rdt = RefDeviceTable.from_host(ref, dicts_override={"s": vocab})
    assert dt.columns["s"][:3].tolist() == np.asarray(
        rdt.columns["s"])[:3].tolist() == [1, 2, 1]
    assert dt.dicts["s"] is vocab
    assert dataclasses.astuple(dt.stats["s"]) == dataclasses.astuple(
        rdt.stats["s"])
    short = np.array(["apple", "fig"])
    with pytest.raises(errors.ValidationError) as got:
        DeviceTable.from_host(port, device="cpu",
                              dicts_override={"s": short})
    with pytest.raises(ref_errors.ValidationError) as want:
        RefDeviceTable.from_host(ref, dicts_override={"s": short})
    assert str(got.value) == str(want.value)

    # A wide int64 column without a vocabulary of its own in the
    # override is refused, as the reference refuses every wide column
    # with an override.
    wide = {"k": np.array([2**40, 5], np.int64), "s": np.array(["a", "b"])}
    port = storage.HostTable.from_dict(wide)
    ref = ref_storage.HostTable.from_dict(wide)
    strs = {"s": np.array(["a", "b"])}
    with pytest.raises(errors.ValidationError) as got:
        DeviceTable.from_host(port, device="cpu", dicts_override=strs)
    with pytest.raises(ref_errors.ValidationError) as want:
        RefDeviceTable.from_host(ref, dicts_override=strs)
    assert str(got.value) == str(want.value)
    # With one, it encodes against it, narrow values included; a value
    # missing from it is refused.
    kv = np.array([5, 7, 2**40], np.int64)
    dt = DeviceTable.from_host(port, device="cpu",
                               dicts_override={**strs, "k": kv})
    assert dt.columns["k"][:2].tolist() == [2, 0]
    assert dt.dicts["k"] is kv
    with pytest.raises(errors.ValidationError, match="int64 column 'k'"):
        DeviceTable.from_host(port, device="cpu",
                              dicts_override={**strs, "k": kv[1:]})
