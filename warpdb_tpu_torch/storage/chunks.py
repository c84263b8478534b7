"""Format-generic chunked ingest for out-of-core streaming.

The port's own copy of ``warpdb_tpu/storage/chunks.py``, unchanged: the
same chunks from the same files.  It dispatches on the file extension
like the facade loader does (warpdb.cpp:160-189):

* ``.csv`` — native prefetching C++ stream (falls back to Python);
* ``.parquet`` — ``ParquetFile.iter_batches`` (row-group streaming,
  never materialises the whole file);
* ``.arrow`` / ``.feather`` / ``.ipc`` — IPC record batches;
* ``.orc`` — stripe-at-a-time reads;
* ``.json`` / ``.ndjson`` / ``.jsonl`` — newline-delimited JSON in line
  chunks.

pyarrow is imported only by the branches that read its formats; CSV and
NDJSON stream without it.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Sequence

from ..errors import UnsupportedError, WarpDBError
from .csv import iter_csv_chunks, read_header
from .table import DataType, HostColumn, HostTable

__all__ = ["iter_table_chunks", "table_column_names"]

_ARROW_EXTS = ("arrow", "feather", "ipc")
_JSON_EXTS = ("json", "ndjson", "jsonl")


def _ext(path: str) -> str:
    return str(path).rsplit(".", 1)[-1].lower()


def table_column_names(path: str) -> list[str]:
    """Column names without reading the data (header / schema only)."""
    if not os.path.exists(path):
        raise WarpDBError("Unable to open file")
    ext = _ext(path)
    if ext == "csv":
        return read_header(path)
    if ext == "parquet":
        import pyarrow.parquet as pq

        return list(pq.ParquetFile(path).schema_arrow.names)
    if ext in _ARROW_EXTS:
        import pyarrow as pa

        with pa.memory_map(path) as src:
            return list(pa.ipc.open_file(src).schema.names)
    if ext == "orc":
        import pyarrow.orc as orc

        return list(orc.ORCFile(path).schema.names)
    if ext in _JSON_EXTS:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue  # the loaders skip malformed lines too
                if isinstance(obj, dict):
                    return list(obj.keys())
        return []
    raise UnsupportedError(f"Unsupported file format: .{ext}")


def _iter_arrow_batches(batches, max_rows: int) -> Iterator[HostTable]:
    import pyarrow as pa

    from .arrow import host_table_from_arrow

    for batch in batches:
        table = (
            pa.Table.from_batches([batch])
            if isinstance(batch, pa.RecordBatch)
            else batch
        )
        for start in range(0, table.num_rows, max_rows):
            yield host_table_from_arrow(table.slice(start, max_rows))


def _iter_json_chunks(path: str, max_rows: int) -> Iterator[HostTable]:
    """NDJSON in line chunks; schema from the first record, records
    missing keys skipped (matching storage.json semantics)."""
    keys: Optional[list] = None
    dtypes: dict = {}

    def build(records: list) -> HostTable:
        nonlocal keys, dtypes
        if keys is None and records:
            keys = list(records[0].keys())
            for k in keys:
                v = records[0][k]
                if isinstance(v, bool) or isinstance(v, int):
                    dtypes[k] = DataType.INT32
                elif isinstance(v, float):
                    dtypes[k] = DataType.FLOAT32
                else:
                    dtypes[k] = DataType.STRING
        cols: dict = {k: [] for k in (keys or [])}
        for rec in records:
            if any(k not in rec for k in keys):
                continue
            for k in keys:
                cols[k].append(rec[k])
        return HostTable(
            [HostColumn.build(k, dtypes[k], cols[k]) for k in (keys or [])]
        )

    records: list = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict):
                records.append(obj)
            if len(records) >= max_rows:
                yield build(records)
                records = []
    if records:
        yield build(records)


def iter_table_chunks(
    path: str,
    max_rows: int,
    schema: Optional[Sequence[DataType]] = None,
) -> Iterator[HostTable]:
    """Stream any supported file format as HostTable chunks of at most
    ``max_rows`` rows."""
    if max_rows <= 0:
        raise WarpDBError("rows_per_chunk must be positive")
    if not os.path.exists(path):
        raise WarpDBError("Unable to open file")
    ext = _ext(path)
    if ext == "csv":
        yield from iter_csv_chunks(path, max_rows, schema)
        return
    if ext == "parquet":
        import pyarrow.parquet as pq

        pf = pq.ParquetFile(path)
        yield from _iter_arrow_batches(
            pf.iter_batches(batch_size=max_rows), max_rows
        )
        return
    if ext in _ARROW_EXTS:
        import pyarrow as pa

        with pa.memory_map(path) as src:
            reader = pa.ipc.open_file(src)
            yield from _iter_arrow_batches(
                (reader.get_batch(i) for i in range(reader.num_record_batches)),
                max_rows,
            )
        return
    if ext == "orc":
        import pyarrow.orc as orc

        f = orc.ORCFile(path)
        yield from _iter_arrow_batches(
            (f.read_stripe(i) for i in range(f.nstripes)), max_rows
        )
        return
    if ext in _JSON_EXTS:
        yield from _iter_json_chunks(path, max_rows)
        return
    raise UnsupportedError(f"Unsupported file format: .{ext}")
