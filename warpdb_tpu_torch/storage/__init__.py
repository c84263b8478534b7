"""Columnar storage & ingest: host tables and the CSV/JSON/Arrow loaders
(the port's copy of ``warpdb_tpu/storage``), and torch device tables."""

from .table import (
    PAD_MULTIPLE,
    ColumnStats,
    DataType,
    DeviceTable,
    HostColumn,
    HostTable,
    padded_length,
)

__all__ = [
    "PAD_MULTIPLE",
    "ColumnStats",
    "DataType",
    "DeviceTable",
    "HostColumn",
    "HostTable",
    "padded_length",
    "load_table",
]


def load_table(filepath: str, schema=None) -> HostTable:
    """Extension-dispatch loader mirroring the reference ctor
    (warpdb.cpp:160-189): csv / json / parquet / arrow / feather / orc."""
    from ..errors import WarpDBError

    ext = filepath.rsplit(".", 1)[-1].lower() if "." in filepath else ""
    if ext == "csv":
        from .csv import load_csv_to_host

        return load_csv_to_host(filepath, schema)
    if ext == "json":
        from .json import load_json_to_host

        return load_json_to_host(filepath)
    if ext == "parquet":
        from .arrow import load_parquet_to_host

        return load_parquet_to_host(filepath)
    if ext in ("arrow", "feather"):
        from .arrow import load_arrow_to_host

        return load_arrow_to_host(filepath)
    if ext == "orc":
        from .arrow import load_orc_to_host

        return load_orc_to_host(filepath)
    raise WarpDBError(f"Unsupported file format: {filepath}")
