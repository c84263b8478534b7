"""Arrow C Data Interface result export.

The port's own copy of ``warpdb_tpu/interchange/arrow_export.py`` (host
code on NumPy and ctypes; nothing here imports pyarrow).  It mirrors the
reference's ``export_to_arrow`` (arrow_utils.cpp:37-94 + vendored
arrow_c_abi.h): query results become an ``ArrowArray`` /
``ArrowSchema`` pair — float32, two buffers, no validity bitmap — whose
data lives either in process memory or in POSIX shared memory for
zero-copy cross-process sharing.  Returned as PyCapsules consumable by
``pyarrow.Array._import_from_c`` (the contract of pywarpdb.cpp:18-37).

Each shared-memory export gets a segment of its own,
``/warpdb_result_<pid>_<random>``, created exclusively; another process
finds it through :func:`shared_memory_path`.  (The reference names every
segment ``/warpdb_result``, so two processes, or two live exports, can
truncate, overwrite and unlink each other's buffer.)

Two backends:

* the native C++ exporter (native/warpdb_native.cpp) when built, for
  in-process buffers — release callbacks are real C function pointers.
  Shared memory never goes through it: it names its segment
  ``/warpdb_result``, the reference's one fixed name;
* a pure-ctypes fallback that lays out the C-ABI structs from Python,
  with ``CFUNCTYPE`` release callbacks kept alive in a module registry.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import secrets
import threading
from typing import Optional

import numpy as np

__all__ = [
    "export_to_arrow_capsules",
    "export_table_to_arrow_capsules",
    "capsule_address",
    "shared_memory_path",
    "SHM_PREFIX",
]

SHM_PREFIX = "/warpdb_result"

ARROW_FLAG_NULLABLE = 2


# -- C ABI struct layouts (Arrow C Data Interface spec, stable ABI) ---------


class ArrowSchemaStruct(ctypes.Structure):
    pass


ArrowSchemaStruct._fields_ = [
    ("format", ctypes.c_char_p),
    ("name", ctypes.c_char_p),
    ("metadata", ctypes.c_char_p),
    ("flags", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("children", ctypes.POINTER(ctypes.POINTER(ArrowSchemaStruct))),
    ("dictionary", ctypes.POINTER(ArrowSchemaStruct)),
    ("release", ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowSchemaStruct))),
    ("private_data", ctypes.c_void_p),
]


class ArrowArrayStruct(ctypes.Structure):
    pass


ArrowArrayStruct._fields_ = [
    ("length", ctypes.c_int64),
    ("null_count", ctypes.c_int64),
    ("offset", ctypes.c_int64),
    ("n_buffers", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("buffers", ctypes.POINTER(ctypes.c_void_p)),
    ("children", ctypes.POINTER(ctypes.POINTER(ArrowArrayStruct))),
    ("dictionary", ctypes.POINTER(ArrowArrayStruct)),
    ("release", ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowArrayStruct))),
    ("private_data", ctypes.c_void_p),
]


_SCHEMA_RELEASE_T = ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowSchemaStruct))
_ARRAY_RELEASE_T = ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowArrayStruct))

# Keep every exported allocation alive until its release callback runs.
_live_lock = threading.Lock()
_live: dict[int, dict] = {}
_counter = 0


def _track(payload: dict) -> int:
    global _counter
    with _live_lock:
        _counter += 1
        _live[_counter] = payload
        return _counter


def _release_entry(token: int) -> Optional[dict]:
    with _live_lock:
        return _live.pop(token, None)


def _make_shm_buffer(nbytes: int):
    """A new POSIX shared-memory segment of ``nbytes`` (arrow_utils.cpp:
    44-62), named for this process and this export and created with
    O_EXCL, so no other export can share, shrink or unlink it."""
    name = f"{SHM_PREFIX.lstrip('/')}_{os.getpid()}_{secrets.token_hex(8)}"
    path = f"/dev/shm/{name}"
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    try:
        os.ftruncate(fd, nbytes)
        mm = mmap.mmap(fd, nbytes)
    except BaseException:
        os.unlink(path)
        raise
    finally:
        os.close(fd)
    return mm, path


def export_to_arrow_capsules(values: np.ndarray, use_shared_memory: bool = False):
    """Export a float32 vector as (array_capsule, schema_capsule).

    In process memory, prefers the native C++ exporter (real C release
    callbacks); else, and always for shared memory, the pure-ctypes
    implementation below, whose in-process buffer is the contiguous f32
    array itself (no copy; the export keeps it alive, and the caller must
    not write to it).  The shared-memory segment is unlinked when the
    array is released; :func:`shared_memory_path` names it until then."""
    values = np.ascontiguousarray(values, dtype=np.float32)
    if not use_shared_memory:
        native_result = _export_native(values)
        if native_result is not None:
            return native_result
    n = len(values)
    nbytes = 4 * n

    if use_shared_memory:
        mm, shm_path = _make_shm_buffer(max(nbytes, 1))
        # One copy into the mapping (the view is dropped at once).
        np.frombuffer(mm, dtype=np.float32, count=n)[:] = values
        buf_addr = ctypes.addressof(ctypes.c_char.from_buffer(mm))
        payload = {"mm": mm, "shm_path": shm_path}
    elif nbytes:
        # No copy: the buffer is the array's own memory, kept alive with
        # the export (the reference copies it twice).
        buf_addr = values.ctypes.data
        payload = {"data": values}
    else:
        data = ctypes.create_string_buffer(1)
        buf_addr = ctypes.addressof(data)
        payload = {"data": data}

    # --- ArrowArray -------------------------------------------------------
    arr = ArrowArrayStruct()
    arr.length = n
    arr.null_count = 0
    arr.offset = 0
    arr.n_buffers = 2
    arr.n_children = 0
    buffers = (ctypes.c_void_p * 2)(None, buf_addr)
    arr.buffers = buffers
    arr.children = None
    arr.dictionary = None

    token = 0

    def _release_array(ptr):
        entry = _release_entry(token)
        if entry is not None:
            mm_obj = entry["payload"].get("mm")
            shm_path = entry["payload"].get("shm_path")
            if mm_obj is not None:
                try:
                    mm_obj.close()
                except BufferError:
                    pass
            if shm_path is not None:
                try:
                    os.unlink(shm_path)
                except OSError:
                    pass
        if ptr:
            ptr.contents.release = _ARRAY_RELEASE_T()

    release_cb = _ARRAY_RELEASE_T(_release_array)
    arr.release = release_cb
    arr.private_data = None

    # --- ArrowSchema --------------------------------------------------------
    schema = ArrowSchemaStruct()
    fmt = ctypes.c_char_p(b"f")  # float32
    name_str = ctypes.c_char_p(b"result")
    schema.format = fmt
    schema.name = name_str
    schema.metadata = None
    schema.flags = ARROW_FLAG_NULLABLE
    schema.n_children = 0
    schema.children = None
    schema.dictionary = None

    def _release_schema(ptr):
        if ptr:
            ptr.contents.release = _SCHEMA_RELEASE_T()

    schema_release_cb = _SCHEMA_RELEASE_T(_release_schema)
    schema.release = schema_release_cb

    token = _track(
        {
            "payload": payload,
            "array_struct": arr,
            "schema_struct": schema,
            "buffers": buffers,
            "callbacks": (release_cb, schema_release_cb),
            "strings": (fmt, name_str),
            "values_ref": values,
        }
    )

    return (
        _make_capsule(ctypes.addressof(arr), b"arrow_array"),
        _make_capsule(ctypes.addressof(schema), b"arrow_schema"),
    )


def _noop_array_release(payload_parts: list):
    """A real (non-NULL) release callback for child arrays — the C ABI
    marks released structs with a NULL release pointer, so children need
    live callbacks even though the parent's release owns all memory."""

    def _rel(ptr):
        if ptr:
            ptr.contents.release = _ARRAY_RELEASE_T()

    cb = _ARRAY_RELEASE_T(_rel)
    payload_parts.append(cb)
    return cb


def _noop_schema_release(payload_parts: list):
    def _rel(ptr):
        if ptr:
            ptr.contents.release = _SCHEMA_RELEASE_T()

    cb = _SCHEMA_RELEASE_T(_rel)
    payload_parts.append(cb)
    return cb


def _child_float(values: np.ndarray, payload_parts: list):
    """Build a float32 child ArrowArray struct (memory owned by the
    parent's payload; the child's release is a kept-alive no-op)."""
    values = np.ascontiguousarray(values, dtype=np.float32)
    payload_parts.append(values)
    child = ArrowArrayStruct()
    child.length = len(values)
    child.null_count = 0
    child.offset = 0
    child.n_buffers = 2
    child.n_children = 0
    buffers = (ctypes.c_void_p * 2)(None, values.ctypes.data)
    payload_parts.append(buffers)
    child.buffers = buffers
    child.children = None
    child.dictionary = None
    child.release = _noop_array_release(payload_parts)
    return child


def _child_utf8(strings: list, payload_parts: list):
    """Build a utf8 child ArrowArray (int32 offsets + data buffer)."""
    raw = [("" if s is None else str(s)).encode("utf-8") for s in strings]
    offsets = np.zeros(len(raw) + 1, dtype=np.int32)
    np.cumsum([len(b) for b in raw], out=offsets[1:])
    data = b"".join(raw) or b"\x00"
    data_buf = ctypes.create_string_buffer(data, len(data))
    payload_parts.extend((offsets, data_buf))
    child = ArrowArrayStruct()
    child.length = len(raw)
    child.null_count = 0
    child.offset = 0
    child.n_buffers = 3
    child.n_children = 0
    buffers = (ctypes.c_void_p * 3)(
        None, offsets.ctypes.data, ctypes.addressof(data_buf)
    )
    payload_parts.append(buffers)
    child.buffers = buffers
    child.children = None
    child.dictionary = None
    child.release = _noop_array_release(payload_parts)
    return child


def _child_schema(name: bytes, fmt: bytes, payload_parts: list):
    s = ArrowSchemaStruct()
    fmt_p = ctypes.c_char_p(fmt)
    name_p = ctypes.c_char_p(name)
    payload_parts.extend((fmt_p, name_p))
    s.format = fmt_p
    s.name = name_p
    s.metadata = None
    s.flags = ARROW_FLAG_NULLABLE
    s.n_children = 0
    s.children = None
    s.dictionary = None
    s.release = _noop_schema_release(payload_parts)
    return s


def export_table_to_arrow_capsules(columns: dict):
    """Export named result columns as one Arrow **struct array**
    (record-batch compatible: ``pa.RecordBatch.from_struct_array``).

    float columns export as ``f``; lists of Python strings as ``u``
    (utf8).  Exceeds the reference, whose export was a single f32 vector
    (arrow_utils.cpp:37-94)."""
    parts: list = []
    child_arrays = []
    child_schemas = []
    n_rows = None
    for name, values in columns.items():
        if isinstance(values, np.ndarray) and values.dtype.kind == "f":
            child_arrays.append(_child_float(values, parts))
            child_schemas.append(
                _child_schema(name.encode(), b"f", parts)
            )
        elif isinstance(values, (list, tuple)) and (
            not values or isinstance(values[0], str)
        ):
            # Lists are the string-column representation (possibly empty:
            # the schema type must not flip to float on empty results).
            child_arrays.append(_child_utf8(list(values), parts))
            child_schemas.append(_child_schema(name.encode(), b"u", parts))
        else:
            child_arrays.append(
                _child_float(np.asarray(values, dtype=np.float32), parts)
            )
            child_schemas.append(_child_schema(name.encode(), b"f", parts))
        length = child_arrays[-1].length
        if n_rows is None:
            n_rows = length
        elif n_rows != length:
            raise ValueError("ragged result columns")

    nc = len(child_arrays)
    arr_ptrs = (ctypes.POINTER(ArrowArrayStruct) * nc)(
        *[ctypes.pointer(a) for a in child_arrays]
    )
    schema_ptrs = (ctypes.POINTER(ArrowSchemaStruct) * nc)(
        *[ctypes.pointer(s) for s in child_schemas]
    )
    parts.extend((child_arrays, child_schemas, arr_ptrs, schema_ptrs))

    parent = ArrowArrayStruct()
    parent.length = n_rows or 0
    parent.null_count = 0
    parent.offset = 0
    parent.n_buffers = 1
    parent.n_children = nc
    pbuffers = (ctypes.c_void_p * 1)(None)
    parts.append(pbuffers)
    parent.buffers = pbuffers
    parent.children = arr_ptrs
    parent.dictionary = None

    token = 0

    def _release_array(ptr):
        _release_entry(token)
        if ptr:
            ptr.contents.release = _ARRAY_RELEASE_T()

    release_cb = _ARRAY_RELEASE_T(_release_array)
    parent.release = release_cb
    parent.private_data = None

    pschema = ArrowSchemaStruct()
    fmt = ctypes.c_char_p(b"+s")
    name_p = ctypes.c_char_p(b"result")
    pschema.format = fmt
    pschema.name = name_p
    pschema.metadata = None
    pschema.flags = 0
    pschema.n_children = nc
    pschema.children = schema_ptrs
    pschema.dictionary = None

    def _release_schema(ptr):
        if ptr:
            ptr.contents.release = _SCHEMA_RELEASE_T()

    schema_cb = _SCHEMA_RELEASE_T(_release_schema)
    pschema.release = schema_cb

    token = _track(
        {
            "payload": {"parts": parts},
            "array_struct": parent,
            "schema_struct": pschema,
            "callbacks": (release_cb, schema_cb),
            "strings": (fmt, name_p),
        }
    )
    return (
        _make_capsule(ctypes.addressof(parent), b"arrow_array"),
        _make_capsule(ctypes.addressof(pschema), b"arrow_schema"),
    )


def _export_native(values: np.ndarray):
    """Export through libwarpdb_native's wdb_export_arrow, in process
    memory.

    The struct shells are ctypes-owned and kept alive in a module
    registry (the reference bindings similarly leak the ``new
    ArrowArray()`` shells, pywarpdb.cpp:20-21); the data buffers are
    C-owned and freed by the C release callbacks."""
    from . import native as native_mod

    lib = native_mod.load_native()
    if lib is None:
        return None
    arr = ArrowArrayStruct()
    schema = ArrowSchemaStruct()
    rc = lib.wdb_export_arrow(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(values),
        0,
        ctypes.byref(arr),
        ctypes.byref(schema),
    )
    if rc != 0:
        return None
    _track({"payload": {}, "array_struct": arr, "schema_struct": schema})
    return (
        _make_capsule(ctypes.addressof(arr), b"arrow_array"),
        _make_capsule(ctypes.addressof(schema), b"arrow_schema"),
    )


def capsule_address(capsule) -> int:
    """The pointer a PyCapsule holds."""
    api = ctypes.pythonapi
    api.PyCapsule_GetName.restype = ctypes.c_char_p
    api.PyCapsule_GetName.argtypes = [ctypes.py_object]
    api.PyCapsule_GetPointer.restype = ctypes.c_void_p
    api.PyCapsule_GetPointer.argtypes = [ctypes.py_object, ctypes.c_char_p]
    return api.PyCapsule_GetPointer(capsule, api.PyCapsule_GetName(capsule))


def shared_memory_path(array_capsule) -> Optional[str]:
    """The ``/dev/shm`` file that holds a live shared-memory export's
    buffer, or None for an in-process or released export."""
    address = capsule_address(array_capsule)
    with _live_lock:
        for entry in _live.values():
            arr = entry.get("array_struct")
            if arr is not None and ctypes.addressof(arr) == address:
                return entry["payload"].get("shm_path")
    return None


def _make_capsule(address: int, name: bytes):
    ctypes.pythonapi.PyCapsule_New.restype = ctypes.py_object
    ctypes.pythonapi.PyCapsule_New.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_void_p,
    ]
    return ctypes.pythonapi.PyCapsule_New(address, name, None)
