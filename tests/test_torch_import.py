"""warpdb_tpu_torch imports neither JAX nor warpdb_tpu and states its
device explicitly."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from warpdb_tpu_torch.errors import ExecutionError

REPO = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED = """
import sys
for name in BLOCKED:
    sys.modules[name] = None       # any import of it now raises
import numpy as np
from warpdb_tpu_torch import WarpDB
db = WarpDB("data/test.csv", device="cpu")
out = db.query_sql("SELECT SUM(price) FROM test GROUP BY quantity")
assert np.allclose(out, [15.25, 10.5, 20.0, 30.0]), out
assert db.query("price * quantity WHERE price > 15") == [0.0, 80.0, 30.5, 150.0]
top = db.query_sql("SELECT price FROM test ORDER BY price DESC LIMIT 2")
assert top == [30.0, 20.0], top
from warpdb_tpu_torch.storage import HostTable
db.register_table("other", HostTable.from_dict(
    {"quantity": np.array([3, 4, 4], np.float32),
     "tag": np.array(["x", "y", "z"])}))
joined = db.query_sql(
    "SELECT other.tag FROM test JOIN other ON test.quantity = other.quantity")
assert joined == ["x", "y", "z"], joined
left = db.query_sql(
    "SELECT price FROM test LEFT JOIN other ON test.quantity = other.quantity")
assert left == [10.5, 20.0, 20.0, 15.25, 30.0], left
import warpdb_tpu_torch.engine.subquery  # noqa: F401
table = db.query_sql_table(
    "WITH q AS (SELECT quantity FROM other UNION SELECT 5 FROM other) "
    "SELECT price, quantity FROM test WHERE quantity IN (SELECT quantity "
    "FROM q) AND price > (SELECT MIN(price) FROM (SELECT price FROM test) "
    "AS d) AND EXISTS (SELECT 1 FROM other WHERE other.quantity = "
    "test.quantity) ORDER BY price DESC")
assert table == {"price": [20.0], "quantity": [4.0]}, table
assert db.query_sql("SELECT COUNT(*) FROM test GROUP BY quantity") == [1.0] * 4
streamed = WarpDB.query_streaming_sql(
    "data/test.csv", "SELECT quantity, SUM(price) AS s FROM t GROUP BY "
    "quantity", rows_per_chunk=3, device="cpu")
assert streamed == {"quantity": [2.0, 3.0, 4.0, 5.0],
                    "s": [15.25, 10.5, 20.0, 30.0]}, streamed
for name in BLOCKED:
    assert sys.modules[name] is None
print("ok")
"""


def _run_blocked(*modules: str) -> None:
    """The slice (a GROUP BY, top-k, joins, subqueries, a CTE, a set
    operation and a streamed GROUP BY) on the CPU in a fresh interpreter
    with ``modules`` blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", f"BLOCKED = {modules!r}\n" + _BLOCKED],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


_SURFACES = """
import sys
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
from warpdb_tpu_torch import WarpDB
from warpdb_tpu_torch.__main__ import main
import warpdb_tpu_torch.dbapi as dbapi
from warpdb_tpu_torch.serve import QueryServer
from warpdb_tpu_torch.utils import metrics
db = WarpDB("data/test.csv", device="cpu")
assert db.query_sql("SELECT APPROX_COUNT_DISTINCT(price) FROM test")[0] > 3.9
assert db.query_sql("SELECT STRING_AGG(price, ',') FROM test "
                    "GROUP BY quantity") == ["15.25", "10.5", "20", "30"]
assert "Execution (measured):" in db.explain(
    "SELECT SUM(price) FROM test GROUP BY quantity", analyze=True)
assert metrics.last().output_rows == 4
db.query_arrow("price * quantity")
db.query_arrow_table("SELECT quantity, SUM(price) FROM test GROUP BY quantity")
db.query_sql("CREATE TABLE c AS SELECT price FROM test WHERE price > 16")
assert db.query_sql("SELECT price FROM c") == [20.0, 30.0]
db.query_sql("DROP TABLE c")
with dbapi.connect("data/test.csv", device="cpu") as conn:
    assert len(conn.cursor().execute("SELECT price FROM test").fetchall()) == 4
srv = QueryServer(db, port=0).start()
srv.shutdown()
assert main(["price", "data/test.csv", "--device", "cpu"]) == 0
for name in BLOCKED:
    assert sys.modules[name] is None
print("ok")
"""


@pytest.mark.parametrize("blocked", [("jax", "warpdb_tpu"),
                                     ("jax", "warpdb_tpu", "pyarrow")])
def test_surfaces_run_with_jax_and_warpdb_tpu_blocked(blocked):
    """APPROX_COUNT_DISTINCT, STRING_AGG, EXPLAIN ANALYZE, metrics, the
    Arrow export, DDL, DB-API, the HTTP server and the CLI in a fresh
    interpreter with JAX, ``warpdb_tpu`` (and pyarrow: the card's machine
    has none) blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", f"BLOCKED = {blocked!r}\n" + _SURFACES],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


_MESH = """
import sys
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
import warpdb_tpu_torch.parallel.comm
import warpdb_tpu_torch.parallel.dist_join
import warpdb_tpu_torch.parallel.mesh
import warpdb_tpu_torch.parallel.multihost
import warpdb_tpu_torch.parallel.sharded
import warpdb_tpu_torch.parallel.shuffle
import warpdb_tpu_torch.parallel.window
from warpdb_tpu_torch import WarpDB
from warpdb_tpu_torch.parallel import data_mesh
from warpdb_tpu_torch.parallel.dryrun import dryrun_multichip
mesh = data_mesh(devices=["cpu"] * 4)
db = WarpDB("data/test.csv", mesh=mesh)
assert db.query_sql("SELECT SUM(price) FROM test GROUP BY quantity") == [
    15.25, 10.5, 20.0, 30.0]
assert db.query_sharded("price * quantity") == [31.5, 80.0, 30.5, 150.0]
assert dryrun_multichip(4, "cpu")["shards"] == 4
for name in BLOCKED:
    assert sys.modules[name] is None
print("ok")
"""


def test_mesh_modules_run_with_jax_and_warpdb_tpu_blocked():
    """Every multi-device module (mesh, comm, sharded, shuffle,
    dist_join, window, multihost, dryrun), a mesh query and the dry run
    in a fresh interpreter with JAX and ``warpdb_tpu`` blocked."""
    blocked = ("jax", "warpdb_tpu")
    proc = subprocess.run(
        [sys.executable, "-c", f"BLOCKED = {blocked!r}\n" + _MESH],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_port_runs_with_jax_blocked():
    _run_blocked("jax")


def test_port_runs_with_jax_and_warpdb_tpu_blocked():
    _run_blocked("jax", "warpdb_tpu")


def test_no_jax_import_in_package():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    files = sorted((REPO / "warpdb_tpu_torch").rglob("*.py"))
    assert files
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_no_warpdb_tpu_import_in_package():
    """The port keeps its own copies of the reference's host modules."""
    pattern = re.compile(r"^\s*(from|import)\s+warpdb_tpu(\.|\s|$)",
                         re.MULTILINE)
    files = sorted((REPO / "warpdb_tpu_torch").rglob("*.py"))
    assert len(files) > 20
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_chip_smoke_imports_no_jax():
    text = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|warpdb_tpu)\b", text,
                         re.MULTILINE)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from warpdb_tpu_torch import WarpDB

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ExecutionError, match="CUDA is not available"):
        WarpDB("data/test.csv")
    with pytest.raises(ExecutionError, match="CUDA is not available"):
        WarpDB("data/test.csv", device="cuda")


def test_explicit_cpu_device():
    from warpdb_tpu_torch import WarpDB

    db = WarpDB("data/test.csv", device="cpu")
    assert db.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in db.table.columns.values())
    assert db.num_rows == 4 and db.column_names == ["price", "quantity"]
