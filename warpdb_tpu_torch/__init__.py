"""warpdb_tpu_torch — the PyTorch and CUDA port of warpdb_tpu.

The same ``WarpDB`` facade, SQL and results as ``warpdb_tpu``, on torch
tensors, with the TPU's Pallas kernels rewritten as CUDA kernels for
Hopper (``csrc/``).  The port keeps its own copies of the reference's
host modules (errors, frontend, host storage) and imports neither JAX
nor ``warpdb_tpu``.

    from warpdb_tpu_torch import WarpDB
    db = WarpDB("data/test.csv", device="cuda")   # device=None means cuda
    db.query("price * quantity WHERE price > 10")
    db.query_sql("SELECT SUM(price) FROM test GROUP BY quantity")

``device="cpu"`` runs the kernels' plain PyTorch versions, for tests.
"""

from .errors import (
    ExecutionError,
    ParseError,
    TokenizeError,
    UnsupportedError,
    ValidationError,
    WarpDBError,
)
from .storage.table import DataType

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy: ``import warpdb_tpu_torch`` loads the engine only when the
    # facade is first used.
    if name == "WarpDB":
        from .api import WarpDB

        return WarpDB
    if name == "register_udf":
        from .engine.udf import register_udf

        return register_udf
    raise AttributeError(f"module 'warpdb_tpu_torch' has no attribute {name!r}")


__all__ = [
    "WarpDB",
    "DataType",
    "register_udf",
    "WarpDBError",
    "TokenizeError",
    "ParseError",
    "ValidationError",
    "ExecutionError",
    "UnsupportedError",
    "__version__",
]
