"""warpdb_tpu_torch imports no JAX and states its device explicitly."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from warpdb_tpu.errors import ExecutionError

REPO = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED_JAX = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises
import numpy as np
from warpdb_tpu_torch import WarpDB
db = WarpDB("data/test.csv", device="cpu")
out = db.query_sql("SELECT SUM(price) FROM test GROUP BY quantity")
assert np.allclose(out, [15.25, 10.5, 20.0, 30.0]), out
assert db.query("price * quantity WHERE price > 15") == [0.0, 80.0, 30.5, 150.0]
top = db.query_sql("SELECT price FROM test ORDER BY price DESC LIMIT 2")
assert top == [30.0, 20.0], top
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("ok")
"""


def test_port_runs_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_JAX], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_no_jax_import_in_package():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    files = sorted((REPO / "warpdb_tpu_torch").rglob("*.py"))
    assert files
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
