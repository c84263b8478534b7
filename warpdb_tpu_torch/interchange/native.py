"""ctypes bridge to the native C++ runtime library (libwarpdb_native.so).

The native library provides the host-side pieces that are C++ in the
reference too: a multithreaded CSV→float32 columnar parser (replacing
csv_loader.cpp's per-cell std::stof loop) and the Arrow C Data Interface
exporter with POSIX shared-memory support (arrow_utils.cpp:37-94).

Everything degrades gracefully: when the shared library has not been
built, callers fall back to pure-Python paths.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_checked = False

_LIB_NAMES = ("libwarpdb_native.so",)


def _candidate_paths():
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(here))
    for name in _LIB_NAMES:
        yield os.path.join(root, "native", name)
        yield os.path.join(here, name)
        yield name  # LD_LIBRARY_PATH


def load_native() -> Optional[ctypes.CDLL]:
    """Load the native library once; returns None if unavailable."""
    global _lib, _lib_checked
    with _lock:
        if _lib_checked:
            return _lib
        _lib_checked = True
        for path in _candidate_paths():
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            _configure(lib)
            _lib = lib
            break
        return _lib


def _configure(lib: ctypes.CDLL) -> None:
    lib.wdb_csv_count_rows.restype = ctypes.c_longlong
    lib.wdb_csv_count_rows.argtypes = [ctypes.c_char_p]
    lib.wdb_csv_parse_f32.restype = ctypes.c_longlong
    lib.wdb_csv_parse_f32.argtypes = [
        ctypes.c_char_p,                   # path
        ctypes.c_int,                      # num_columns
        ctypes.c_longlong,                 # max_rows (capacity)
        ctypes.POINTER(ctypes.c_float),    # column-major output [col][row]
        ctypes.c_int,                      # num_threads
    ]
    lib.wdb_csv_stream_open.restype = ctypes.c_void_p
    lib.wdb_csv_stream_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong,
    ]
    lib.wdb_csv_stream_next.restype = ctypes.c_longlong
    lib.wdb_csv_stream_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
    ]
    lib.wdb_csv_stream_close.restype = None
    lib.wdb_csv_stream_close.argtypes = [ctypes.c_void_p]
    lib.wdb_export_arrow.restype = ctypes.c_int
    lib.wdb_export_arrow.argtypes = [
        ctypes.POINTER(ctypes.c_float),    # data
        ctypes.c_longlong,                 # length
        ctypes.c_int,                      # use_shared_memory
        ctypes.c_void_p,                   # ArrowArray*
        ctypes.c_void_p,                   # ArrowSchema*
    ]


def csv_parse_f32(path: str, num_columns: int, num_threads: int = 0):
    """Parse a CSV body into float32 column arrays via the native parser.

    Returns a list of ``num_columns`` float32 arrays, or None if the
    native library is unavailable or parsing failed.
    """
    lib = load_native()
    if lib is None:
        return None
    encoded = os.fsencode(path)
    rows = lib.wdb_csv_count_rows(encoded)
    if rows < 0:
        return None
    buf = np.empty((num_columns, rows), dtype=np.float32)
    parsed = lib.wdb_csv_parse_f32(
        encoded,
        num_columns,
        rows,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads,
    )
    if parsed < 0:
        return None
    return [np.ascontiguousarray(buf[i, :parsed]) for i in range(num_columns)]


def iter_csv_chunks_native(path: str, num_columns: int, rows_per_chunk: int):
    """Generator over (num_columns, chunk_rows) float32 chunk arrays via
    the native prefetching stream (chunk k+1 parses on a worker thread
    while the caller consumes chunk k).  Yields nothing (and callers
    fall back) when the library is missing; raises on malformed cells.
    """
    lib = load_native()
    if lib is None:
        return
    handle = lib.wdb_csv_stream_open(
        os.fsencode(path), num_columns, rows_per_chunk
    )
    if not handle:
        raise OSError(f"Unable to open file: {path}")
    try:
        while True:
            buf = np.empty((num_columns, rows_per_chunk), dtype=np.float32)
            rows = lib.wdb_csv_stream_next(
                handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            )
            if rows == 0:
                return
            if rows < 0:
                raise ValueError(f"Malformed CSV cell in {path}")
            yield buf[:, : int(rows)]
    finally:
        lib.wdb_csv_stream_close(handle)


def has_native_stream() -> bool:
    return load_native() is not None
