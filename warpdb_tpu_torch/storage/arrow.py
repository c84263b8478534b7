"""Columnar-format ingest via Apache Arrow: Parquet, Arrow IPC/Feather, ORC.

The reference gates these behind ``USE_ARROW`` with throwing stubs when
Arrow is absent (arrow_loader.hpp:26-37); here the gate is a pyarrow
import.  Unlike the reference's ``table_from_arrow`` — which silently
extracted only the ``price``/``quantity`` columns (arrow_loader.cpp:72-97)
— all numeric columns are loaded.
"""

from __future__ import annotations

import os

import numpy as np

from ..errors import UnsupportedError, WarpDBError
from .table import DataType, HostColumn, HostTable

__all__ = [
    "load_parquet_to_host",
    "load_arrow_to_host",
    "load_orc_to_host",
    "host_table_from_arrow",
    "host_table_to_arrow",
]


def _require_pyarrow():
    try:
        import pyarrow  # noqa: F401

        return pyarrow
    except ImportError:
        raise UnsupportedError(
            "Arrow support is not available in this build of warpdb_tpu"
        ) from None


def host_table_from_arrow(table) -> HostTable:
    """Convert a pyarrow.Table to a HostTable.

    float64 is narrowed to Float32 to match the engine's float pipeline
    (the reference narrows double→f32 at arrow_loader.cpp:84-88)."""
    import pyarrow as pa

    cols = []
    for name, col in zip(table.column_names, table.columns):
        t = col.type
        if pa.types.is_float64(t) or pa.types.is_float32(t):
            data = col.to_numpy(zero_copy_only=False).astype(np.float32)
            cols.append(HostColumn.build(name, DataType.FLOAT32, data))
        elif pa.types.is_int64(t):
            data = col.to_numpy(zero_copy_only=False).astype(np.int64)
            cols.append(HostColumn.build(name, DataType.INT64, data))
        elif pa.types.is_integer(t) or pa.types.is_boolean(t):
            data = col.to_numpy(zero_copy_only=False).astype(np.int32)
            cols.append(HostColumn.build(name, DataType.INT32, data))
        elif pa.types.is_string(t) or pa.types.is_large_string(t):
            cols.append(
                HostColumn.build(
                    name, DataType.STRING, np.asarray(col.to_pylist(), dtype=object)
                )
            )
        # other types (timestamps, nested) are skipped for now
    return HostTable(cols)


def host_table_to_arrow(table: HostTable):
    """Convert a HostTable to a pyarrow.Table (zero-copy for numerics)."""
    pa = _require_pyarrow()
    arrays = []
    names = []
    for col in table.columns:
        names.append(col.name)
        if col.dtype is DataType.STRING:
            arrays.append(pa.array(list(col.data), type=pa.string()))
        else:
            arrays.append(pa.array(col.data))
    return pa.table(dict(zip(names, arrays)))


def _check_exists(filepath: str) -> None:
    if not os.path.exists(filepath):
        raise WarpDBError("Unable to open file")


def load_parquet_to_host(filepath: str) -> HostTable:
    _require_pyarrow()
    _check_exists(filepath)
    import pyarrow.parquet as pq

    return host_table_from_arrow(pq.read_table(filepath))


def load_arrow_to_host(filepath: str) -> HostTable:
    """Arrow IPC / Feather files."""
    _require_pyarrow()
    _check_exists(filepath)
    import pyarrow.feather as feather

    return host_table_from_arrow(feather.read_table(filepath))


def load_orc_to_host(filepath: str) -> HostTable:
    _require_pyarrow()
    _check_exists(filepath)
    try:
        import pyarrow.orc as orc
    except ImportError:
        raise UnsupportedError("ORC support is not available") from None

    return host_table_from_arrow(orc.read_table(filepath))
