"""CSV ingest.

Behavioral parity with the reference loader (csv_loader.cpp:49-223):

* header row supplies column names;
* an explicit schema must match the header's column count
  (``Schema size does not match column count``, csv_loader.cpp:66-67);
* with no schema, **every column defaults to Float32**
  (csv_loader.cpp:68) — the reference's signature quirk, kept because the
  whole float pipeline and its tests depend on it;
* missing file → ``Unable to open file``; empty file → ``Empty CSV file``;
* chunked streaming (``iter_csv_chunks``) replaces ``load_csv_chunk``
  (csv_loader.cpp:186-223) **without** its header-re-read-per-chunk bug
  (the reference consumed the first data row of every chunk after the
  first as a header).

Parse backends, fastest first: the native C++ parser
(native/warpdb_native.cpp) when built, else pyarrow's multithreaded CSV
reader, else NumPy.  All three produce identical HostTables.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence

import numpy as np

from ..errors import WarpDBError
from .table import DataType, HostColumn, HostTable

__all__ = ["load_csv_to_host", "iter_csv_chunks", "read_header"]


def read_header(path_or_stream) -> list[str]:
    if isinstance(path_or_stream, (str, os.PathLike)):
        with open(path_or_stream, "r") as f:
            line = f.readline()
    else:
        line = path_or_stream.readline()
    if not line:
        raise WarpDBError("Empty CSV file")
    return [c.strip() for c in line.rstrip("\r\n").split(",")]


def _resolve_schema(
    names: list[str], schema: Optional[Sequence[DataType]]
) -> list[DataType]:
    if schema:
        if len(schema) != len(names):
            raise WarpDBError("Schema size does not match column count")
        return list(schema)
    return [DataType.FLOAT32] * len(names)


def _columns_from_arrays(
    names: list[str], types: list[DataType], arrays: list[np.ndarray]
) -> HostTable:
    cols = [
        HostColumn.build(name, dtype, arr)
        for name, dtype, arr in zip(names, types, arrays)
    ]
    return HostTable(cols)


def _parse_text_numpy(
    text: str, names: list[str], types: list[DataType]
) -> HostTable:
    """Pure-NumPy fallback parser for body text (no header)."""
    ncols = len(names)
    rows = [ln for ln in text.split("\n") if ln.strip()]
    arrays: list[list] = [[] for _ in range(ncols)]
    for ln in rows:
        parts = ln.split(",")
        for i in range(ncols):
            val = parts[i].strip() if i < len(parts) else ""
            arrays[i].append(val)
    out = []
    for i, dtype in enumerate(types):
        if dtype is DataType.STRING:
            out.append(np.asarray(arrays[i], dtype=object))
        else:
            out.append(np.asarray(arrays[i], dtype=dtype.np_dtype))
    return _columns_from_arrays(names, types, out)


def _parse_native(path: str, names: list[str], types: list[DataType]):
    """Attempt the native C++ parser; returns None when unavailable or the
    schema contains non-f32 columns (the native fast path is f32-only,
    matching the reference's all-f32 default)."""
    if any(t is not DataType.FLOAT32 for t in types):
        return None
    from ..interchange import native as native_mod

    lib = native_mod.load_native()
    if lib is None:
        return None
    arrays = native_mod.csv_parse_f32(path, len(names))
    if arrays is None:
        return None
    return _columns_from_arrays(names, types, arrays)


def _parse_pyarrow(path: str, names: list[str], types: list[DataType]):
    try:
        import pyarrow as pa
        import pyarrow.csv as pacsv
    except ImportError:
        return None
    type_map = {
        DataType.INT32: pa.int32(),
        DataType.INT64: pa.int64(),
        DataType.FLOAT32: pa.float32(),
        DataType.FLOAT64: pa.float64(),
        DataType.STRING: pa.string(),
    }
    convert = pacsv.ConvertOptions(
        column_types={n: type_map[t] for n, t in zip(names, types)}
    )
    table = pacsv.read_csv(path, convert_options=convert)
    arrays = []
    for name, dtype in zip(names, types):
        col = table.column(name)
        if dtype is DataType.STRING:
            arrays.append(np.asarray(col.to_pylist(), dtype=object))
        else:
            arrays.append(col.to_numpy(zero_copy_only=False).astype(dtype.np_dtype))
    return _columns_from_arrays(names, types, arrays)


def load_csv_to_host(
    filepath: str, schema: Optional[Sequence[DataType]] = None
) -> HostTable:
    """Load a CSV file into a HostTable (reference load_csv_to_host,
    csv_loader.cpp:49-124)."""
    if not os.path.exists(filepath):
        raise WarpDBError("Unable to open file")
    names = read_header(filepath)
    types = _resolve_schema(names, schema)

    table = _parse_native(filepath, names, types)
    if table is None:
        table = _parse_pyarrow(filepath, names, types)
    if table is None:
        with open(filepath, "r") as f:
            f.readline()  # header
            table = _parse_text_numpy(f.read(), names, types)
    return table


def iter_csv_chunks(
    path_or_stream,
    max_rows: int,
    schema: Optional[Sequence[DataType]] = None,
) -> Iterator[HostTable]:
    """Stream a CSV in chunks of at most ``max_rows`` rows.

    Replaces the reference's ``load_csv_chunk`` (csv_loader.cpp:186-223);
    the header is consumed exactly once, fixing the reference bug where the
    first data row of every chunk after the first was eaten as a header.
    Default column type is Float32, like the reference chunk loader.
    """
    if max_rows <= 0:
        raise WarpDBError("rows_per_chunk must be positive")
    own = isinstance(path_or_stream, (str, os.PathLike))

    # Native prefetching stream (all-f32 schemas, real files): the next
    # chunk parses on a C++ worker thread while this one is consumed.
    if own and os.path.exists(path_or_stream):
        names = read_header(path_or_stream)
        types = _resolve_schema(names, schema)
        if all(t is DataType.FLOAT32 for t in types):
            from ..interchange import native as native_mod

            if native_mod.has_native_stream():
                try:
                    for chunk in native_mod.iter_csv_chunks_native(
                        str(path_or_stream), len(names), max_rows
                    ):
                        yield _columns_from_arrays(
                            names, types, [chunk[i] for i in range(len(names))]
                        )
                    return
                except ValueError as e:
                    raise WarpDBError(str(e)) from None

    stream = open(path_or_stream, "r") if own else path_or_stream
    try:
        header_line = stream.readline()
        if not header_line:
            raise WarpDBError("Empty CSV file")
        names = [c.strip() for c in header_line.rstrip("\r\n").split(",")]
        types = _resolve_schema(names, schema)
        while True:
            lines: list[str] = []
            while len(lines) < max_rows:
                line = stream.readline()
                if not line:
                    break
                if line.strip():
                    lines.append(line)
            if not lines:
                break
            yield _parse_text_numpy("".join(lines), names, types)
            if len(lines) < max_rows:
                break
    finally:
        if own:
            stream.close()
