"""Arrow C Data Interface export of the port against the reference's
``tests/test_interchange.py`` cases: capsules that pyarrow imports, the
POSIX shared-memory buffer, struct arrays with utf8 and float32 children
(an empty string column stays utf8), and the same bytes as the
reference's export of the same statement."""

import ctypes
import os

import numpy as np
import pytest

from warpdb_tpu import WarpDB as RefDB
from warpdb_tpu.storage import HostTable as RefHostTable
from warpdb_tpu_torch import DataType, WarpDB
from warpdb_tpu_torch.api import _capsule_address
from warpdb_tpu_torch.interchange.arrow_export import (
    ArrowArrayStruct,
    ArrowSchemaStruct,
    shared_memory_path,
)
from warpdb_tpu_torch.storage import HostTable


@pytest.fixture(scope="module")
def db():
    return WarpDB("data/test.csv", device="cpu")


def test_query_arrow_capsules(db):
    pa = pytest.importorskip("pyarrow")
    arr = db.query_arrow_array("price * quantity")
    assert arr.type == pa.float32()
    np.testing.assert_allclose(arr.to_numpy(zero_copy_only=False),
                               [31.5, 80.0, 30.5, 150.0])


def test_query_arrow_schema_format(db):
    arr_c, schema_c = db.query_arrow("price + 1")
    schema = ArrowSchemaStruct.from_address(_capsule_address(schema_c))
    assert schema.format == b"f"
    assert schema.name == b"result"
    arr = ArrowArrayStruct.from_address(_capsule_address(arr_c))
    assert (arr.length, arr.n_buffers, arr.null_count) == (4, 2, 0)


def test_query_arrow_same_bytes_as_reference():
    data = {"price": np.random.default_rng(5).uniform(0, 9, 5000)
            .astype(np.float32), "quantity": np.arange(5000, dtype=np.float32)}
    got = []
    for db in (WarpDB(HostTable.from_dict(data), device="cpu"),
               RefDB(RefHostTable.from_dict(data))):
        arr_c, _s = db.query_arrow("price * quantity WHERE quantity > 7")
        arr = ArrowArrayStruct.from_address(_capsule_address(arr_c))
        buf = (ctypes.c_float * arr.length).from_address(arr.buffers[1])
        got.append(bytes(buf))
        arr.release(ctypes.pointer(arr))
    assert got[0] == got[1]


def test_query_arrow_shared_memory(db):
    pa = pytest.importorskip("pyarrow")
    arr_c, schema_c = db.query_arrow("price + 1", shared_memory=True)
    path = shared_memory_path(arr_c)
    assert path.startswith(f"/dev/shm/warpdb_result_{os.getpid()}_")
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(16), dtype=np.float32)
    np.testing.assert_allclose(raw, [11.5, 21.0, 16.25, 31.0])
    a = pa.Array._import_from_c(_capsule_address(arr_c),
                                _capsule_address(schema_c))
    np.testing.assert_allclose(a.to_numpy(zero_copy_only=False),
                               [11.5, 21.0, 16.25, 31.0])
    del a  # the release callback unlinks the shm
    assert not os.path.exists(path)


def test_shared_memory_release_unlinks(db):
    arr_c, _schema_c = db.query_arrow("price * 2", shared_memory=True)
    path = shared_memory_path(arr_c)
    arr = ArrowArrayStruct.from_address(_capsule_address(arr_c))
    buf = (ctypes.c_float * arr.length).from_address(arr.buffers[1])
    assert list(buf) == [21.0, 40.0, 30.5, 60.0]
    arr.release(ctypes.pointer(arr))
    assert not os.path.exists(path)
    assert shared_memory_path(arr_c) is None


def test_shared_memory_exports_do_not_share_a_segment(db):
    """Two live shared-memory exports hold two segments: releasing one
    leaves the other's file and bytes in place."""
    first, _s1 = db.query_arrow("price * 2", shared_memory=True)
    second, _s2 = db.query_arrow("price + 1", shared_memory=True)
    paths = [shared_memory_path(c) for c in (first, second)]
    assert paths[0] != paths[1]
    arr = ArrowArrayStruct.from_address(_capsule_address(first))
    arr.release(ctypes.pointer(arr))
    assert not os.path.exists(paths[0])
    with open(paths[1], "rb") as f:
        raw = np.frombuffer(f.read(16), dtype=np.float32)
    np.testing.assert_allclose(raw, [11.5, 21.0, 16.25, 31.0])
    arr = ArrowArrayStruct.from_address(_capsule_address(second))
    arr.release(ctypes.pointer(arr))
    assert not os.path.exists(paths[1])
    assert shared_memory_path(db.query_arrow("price")[0]) is None


def test_struct_array_export(data_dir):
    pytest.importorskip("pyarrow")
    db = WarpDB(str(data_dir / "test.csv"), device="cpu")
    rb = db.query_record_batch(
        "SELECT quantity AS q, SUM(price) AS total, COUNT(*) AS n "
        "FROM test GROUP BY quantity ORDER BY quantity ASC")
    assert rb.num_rows == 4
    assert rb.schema.names == ["q", "total", "n"]
    assert rb.column("q").to_pylist() == [2.0, 3.0, 4.0, 5.0]
    assert rb.column("total").to_pylist() == pytest.approx(
        [15.25, 10.5, 20.0, 30.0])


def _string_dbs(tmp_path):
    p = tmp_path / "s.csv"
    p.write_text("price,category\n10.5,toys\n20.0,books\n15.25,toys\n")
    schema = [DataType.FLOAT32, DataType.STRING]
    from warpdb_tpu.storage import DataType as RefDataType

    ref_schema = [RefDataType.FLOAT32, RefDataType.STRING]
    return (WarpDB(str(p), schema, device="cpu"),
            RefDB(str(p), ref_schema))


def test_struct_array_export_strings(tmp_path):
    pa = pytest.importorskip("pyarrow")
    db, ref = _string_dbs(tmp_path)
    sql = ("SELECT category AS cat, SUM(price) AS total FROM s "
           "GROUP BY category ORDER BY category ASC")
    rb = db.query_record_batch(sql)
    assert rb.column("cat").to_pylist() == ["books", "toys"]
    assert rb.column("total").to_pylist() == pytest.approx([20.0, 25.75])
    assert pa.types.is_string(rb.schema.field("cat").type)
    assert rb.equals(ref.query_record_batch(sql))


@pytest.mark.parametrize("sql", [
    "SELECT category FROM s WHERE price > 1000",
    "SELECT category, SUM(price) FROM s WHERE price > 1000 GROUP BY category",
    "SELECT MAX(category) AS m, COUNT(*) AS n FROM s WHERE price > 1000 "
    "GROUP BY category",
    "SELECT UPPER(category) AS u FROM s WHERE price > 1000",
    "SELECT STRING_AGG(category, ',') AS a, price FROM s WHERE price > 1000 "
    "GROUP BY price",
])
def test_empty_string_column_exports_as_utf8(tmp_path, sql):
    pa = pytest.importorskip("pyarrow")
    db, _ref = _string_dbs(tmp_path)
    rb = db.query_record_batch(sql)
    assert rb.num_rows == 0
    assert pa.types.is_string(rb.schema.field(0).type)


def test_string_column_of_a_registered_table(tmp_path):
    """A string column of a relation other than the primary table exports
    as utf8.  The reference types columns by the primary table's
    dictionaries only and fails converting the strings to float."""
    pa = pytest.importorskip("pyarrow")
    data = {"k": np.float32([1, 2, 2]), "tag": np.array(["x", "y", "y"])}
    db = WarpDB("data/test.csv", device="cpu")
    db.register_table("other", HostTable.from_dict(data))
    ref = RefDB("data/test.csv")
    ref.register_table("other", RefHostTable.from_dict(data))
    sql = "SELECT tag, COUNT(*) AS n FROM other GROUP BY tag"
    rb = db.query_record_batch(sql)
    assert rb.column("tag").to_pylist() == ["x", "y"]
    assert pa.types.is_string(rb.schema.field("tag").type)
    with pytest.raises(ValueError):
        ref.query_record_batch(sql)


def test_string_agg_exports_as_utf8():
    pytest.importorskip("pyarrow")
    data = {"g": np.float32([1, 1, 2]), "t": np.array(["b", "a", "c"])}
    db = WarpDB(HostTable.from_dict(data), device="cpu")
    rb = db.query_record_batch(
        "SELECT g, STRING_AGG(t, '+') AS s FROM t GROUP BY g")
    assert rb.column("s").to_pylist() == ["a+b", "c"]


def test_no_pyarrow_import_at_import_time():
    import subprocess
    import sys

    code = ("import sys; sys.modules['pyarrow'] = None\n"
            "import numpy as np\n"
            "from warpdb_tpu_torch import WarpDB\n"
            "import warpdb_tpu_torch.interchange.arrow_export\n"
            "import warpdb_tpu_torch.dbapi, warpdb_tpu_torch.serve\n"
            "db = WarpDB('data/test.csv', device='cpu')\n"
            "db.query_arrow('price'); db.query_arrow_table("
            "'SELECT price FROM test')\n"
            "print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
