"""Columnar data model: host tables (NumPy) and device tables (torch).

The host half (``DataType``, ``ColumnStats``, ``HostColumn``,
``HostTable``, ``padded_length``) is the port's own copy of
``warpdb_tpu/storage/table.py:1-219``, unchanged: the same numpy-backed
tables, stats and dtype rules.  ``DeviceTable`` is the counterpart of the
reference's and keeps its rules:

* every numeric column is one padded tensor (zeros past ``num_rows``);
* string columns share ONE sorted vocabulary and ride as int32 codes;
* int64 columns beyond the int32 range ride as int32 codes into one
  shared sorted int64 vocabulary (order-isomorphic, so keys, order and
  comparisons against literals stay exact);
* float64 columns must round-trip through f32 unless
  ``config.f64_policy == "downcast"``;
* narrow int64 columns become int32 on the device (the reference's
  x64-disabled upload does the same);
* ``stats`` are the host stats, replaced by code stats for coded columns;
* a stream's chunks encode against vocabularies shared by the whole
  stream (``dicts_override``), string and wide int64 alike.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..errors import ValidationError
from .strings import encode_int64_columns, encode_string_columns

__all__ = [
    "DataType",
    "ColumnStats",
    "HostColumn",
    "HostTable",
    "DeviceTable",
    "PAD_MULTIPLE",
    "padded_length",
]

# One float32 VPU tile is (8, 128); padding 1-D columns to a multiple of
# 1024 keeps every reshape/tile XLA attempts aligned.
PAD_MULTIPLE = 1024


class DataType(enum.Enum):
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    STRING = "string"

    # Aliases matching the reference enum spelling (csv_loader.hpp:13).
    Int32 = INT32
    Int64 = INT64
    Float32 = FLOAT32
    Float64 = FLOAT64
    String = STRING

    @property
    def np_dtype(self) -> Optional[np.dtype]:
        return {
            DataType.INT32: np.dtype(np.int32),
            DataType.INT64: np.dtype(np.int64),
            DataType.FLOAT32: np.dtype(np.float32),
            DataType.FLOAT64: np.dtype(np.float64),
            DataType.STRING: None,
        }[self]

    @property
    def is_numeric(self) -> bool:
        return self is not DataType.STRING

    @classmethod
    def from_np(cls, dtype: np.dtype) -> "DataType":
        mapping = {
            np.dtype(np.int32): cls.INT32,
            np.dtype(np.int64): cls.INT64,
            np.dtype(np.float32): cls.FLOAT32,
            np.dtype(np.float64): cls.FLOAT64,
        }
        if dtype in mapping:
            return mapping[dtype]
        if dtype.kind in ("U", "S", "O"):
            return cls.STRING
        if dtype.kind == "f":
            return cls.FLOAT32
        if dtype.kind in ("i", "u", "b"):
            return cls.INT32
        raise ValidationError(f"Unsupported dtype: {dtype}")


@dataclass(frozen=True)
class ColumnStats:
    """min/max/null-count — the reference's declared-but-never-written
    ColumnStats (csv_loader.hpp:22-37), actually computed here."""

    min: Optional[float] = None
    max: Optional[float] = None
    null_count: int = 0

    @classmethod
    def compute(cls, values: np.ndarray) -> "ColumnStats":
        if values.size == 0:
            return cls()
        if values.dtype.kind == "f":
            nulls = int(np.count_nonzero(np.isnan(values)))
            if nulls == values.size:
                return cls(null_count=nulls)
            return cls(
                min=float(np.nanmin(values)),
                max=float(np.nanmax(values)),
                null_count=nulls,
            )
        if values.dtype.kind in ("i", "u"):
            return cls(min=float(values.min()), max=float(values.max()))
        return cls()


@dataclass
class HostColumn:
    name: str
    dtype: DataType
    data: np.ndarray  # object array for strings
    stats: ColumnStats = field(default_factory=ColumnStats)

    @classmethod
    def build(cls, name: str, dtype: DataType, data) -> "HostColumn":
        if dtype is DataType.STRING:
            arr = np.asarray(data, dtype=object)
        else:
            arr = np.asarray(data, dtype=dtype.np_dtype)
        stats = ColumnStats.compute(arr) if dtype.is_numeric else ColumnStats()
        return cls(name, dtype, arr, stats)

    def __len__(self) -> int:
        return len(self.data)


class HostTable:
    """Host-resident columnar table."""

    def __init__(self, columns: Sequence[HostColumn] = ()):
        self.columns: list[HostColumn] = list(columns)
        lengths = {len(c) for c in self.columns}
        if len(lengths) > 1:
            raise ValidationError(f"Ragged columns: lengths {sorted(lengths)}")

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    def get_column(self, name: str) -> Optional[HostColumn]:
        for c in self.columns:
            if c.name == name:
                return c
        return None

    def require_column(self, name: str) -> HostColumn:
        col = self.get_column(name)
        if col is None:
            raise ValidationError(f"Unknown column: {name}")
        return col

    def slice(self, start: int, end: int) -> "HostTable":
        return HostTable(
            [
                HostColumn(c.name, c.dtype, c.data[start:end], c.stats)
                for c in self.columns
            ]
        )

    @staticmethod
    def concat(tables: Iterable["HostTable"]) -> "HostTable":
        tables = [t for t in tables if t.columns]
        if not tables:
            return HostTable()
        first = tables[0]
        cols = []
        for i, col in enumerate(first.columns):
            data = np.concatenate([t.columns[i].data for t in tables])
            cols.append(HostColumn.build(col.name, col.dtype, data))
        return HostTable(cols)

    @classmethod
    def from_dict(cls, data: dict, dtypes: Optional[dict] = None) -> "HostTable":
        cols = []
        for name, values in data.items():
            arr = np.asarray(values)
            dtype = (dtypes or {}).get(name)
            if dtype is None:
                dtype = DataType.from_np(arr.dtype)
                # NumPy infers float64 for plain Python float lists, but
                # the caller's intent there is "floats", not a 64-bit
                # precision demand — infer FLOAT32 so casual data skips
                # the strict FLOAT64 round-trip policy (DeviceTable
                # .from_host).  Explicit np.float64 arrays and declared
                # FLOAT64 dtypes keep their precision contract.
                if dtype is DataType.FLOAT64 and not isinstance(
                    values, np.ndarray
                ):
                    dtype = DataType.FLOAT32
            cols.append(HostColumn.build(name, dtype, values))
        return cls(cols)

    def to_dict(self) -> dict:
        return {c.name: c.data for c in self.columns}

    def __repr__(self) -> str:
        cols = ", ".join(f"{c.name}:{c.dtype.value}" for c in self.columns)
        return f"HostTable({self.num_rows} rows; {cols})"


def padded_length(n: int, multiple: int = PAD_MULTIPLE) -> int:
    """Round ``n`` up to a lane-aligned static buffer length (≥ multiple)."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple



class DeviceTable:
    """Device-resident columnar table: one padded tensor per column on
    ``device``.  ``num_rows`` is the true row count."""

    def __init__(self, columns: dict, dtypes: dict, num_rows: int,
                 padded_rows: int, stats: Optional[dict] = None,
                 host: Optional[HostTable] = None,
                 dicts: Optional[dict] = None,
                 device: Optional[torch.device] = None):
        self.columns = columns          # name -> tensor (padded_rows,)
        self.dtypes = dtypes            # name -> DataType
        self.num_rows = num_rows
        self.padded_rows = padded_rows
        self.stats = stats or {}        # name -> ColumnStats
        self.host = host
        self.dicts = dicts or {}        # name -> sorted vocabulary
        self.device = torch.device(device) if device is not None else (
            next(iter(columns.values())).device if columns
            else torch.device("cpu")
        )
        self._row_views = None

    @property
    def column_names(self) -> list[str]:
        return list(self.dtypes.keys())

    def row_columns(self) -> dict:
        """``{name: column[:num_rows]}`` — views without the padding,
        which every operator of the port evaluates over."""
        if self._row_views is None:
            n = self.num_rows
            self._row_views = {k: v[:n] for k, v in self.columns.items()}
        return self._row_views

    @classmethod
    def from_host(cls, host: HostTable, device=None,
                  pad_multiple: Optional[int] = None,
                  keep_host: bool = True,
                  dicts_override: Optional[dict] = None) -> "DeviceTable":
        """Upload ``host`` to ``device``: None means the card, and raises
        where there is none; pass ``"cpu"`` for the plain versions.

        ``dicts_override`` (``{column: sorted vocabulary}``, a stream's
        vocabularies shared by all its chunks) encodes each string column
        against its supplied vocabulary, and each int64 column it names
        against its int64 one, whatever the chunk's own range; a wide
        int64 column it does not name is refused, as the reference
        refuses it.  On a card each column stages in page-locked host
        memory and copies without waiting."""
        from ..api import resolve_device

        if pad_multiple is None:
            from ..config import get_config

            pad_multiple = get_config().pad_multiple
        device = resolve_device(device)
        n = host.num_rows
        padded = padded_length(n, pad_multiple)
        columns, dtypes, stats, dicts = {}, {}, {}, {}
        override = dicts_override or {}

        str_cols = {
            c.name: c.data[:n] for c in host.columns if not c.dtype.is_numeric
        }
        i64_cols, i64_fixed = {}, {}
        for c in host.columns:
            if not (c.dtype.is_numeric and c.data.dtype == np.int64):
                continue
            if c.name in override:
                i64_fixed[c.name] = _encode_against(
                    c.name, c.data[:n], override[c.name], "int64")
            elif n:
                lo, hi = int(c.data[:n].min()), int(c.data[:n].max())
                if lo < -(2**31) or hi > 2**31 - 1:
                    i64_cols[c.name] = c.data[:n]
        if i64_cols and dicts_override is not None:
            raise ValidationError(
                "int64 columns beyond the int32 range are not "
                "supported with an external vocabulary (streaming "
                f"chunks): {sorted(i64_cols)}; load in-memory or "
                "pre-encode the keys"
            )
        i64_codes, i64_vocab = (
            encode_int64_columns(i64_cols) if i64_cols else ({}, None)
        )
        i64_codes.update(i64_fixed)
        if dicts_override is None:
            encoded, vocab = (
                encode_string_columns(str_cols) if str_cols else ({}, None)
            )
        else:
            encoded = {name: _encode_against(name, vals, override[name],
                                             "string")
                       for name, vals in str_cols.items()}

        for c in host.columns:
            dtypes[c.name] = c.dtype
            stats[c.name] = c.stats
            if not c.dtype.is_numeric:
                data = encoded[c.name]
                dicts[c.name] = (vocab if dicts_override is None
                                 else override[c.name])
                stats[c.name] = _code_stats(data, n)
            elif c.name in i64_codes:
                data = i64_codes[c.name]
                dicts[c.name] = override.get(c.name, i64_vocab)
                stats[c.name] = _code_stats(data, n)
            else:
                data = c.data
                if data.dtype == np.float64:
                    data = _f64_to_f32(c.name, data[:n])
                elif data.dtype == np.int64:
                    data = data.astype(np.int32)
            columns[c.name] = _upload(data, n, padded, device)
        return cls(columns, dtypes, n, padded, stats,
                   host if keep_host else None, dicts, device)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{t.value}" for n, t in self.dtypes.items())
        return (
            f"DeviceTable({self.num_rows} rows, padded {self.padded_rows}, "
            f"{self.device}; {cols})"
        )


def _upload(data: np.ndarray, n: int, padded: int, device) -> torch.Tensor:
    """``data[:n]`` zero-padded to ``padded`` on ``device``.  On a card it
    stages in page-locked memory and copies without waiting (no slower
    than a pageable copy at any size, faster for large columns: PERF.md
    §6, PR 8); the caching host allocator keeps the stage until the copy
    is done."""
    if device.type == "cuda":
        stage = torch.empty(padded, dtype=torch.from_numpy(data[:0]).dtype,
                            pin_memory=True)
        view = stage.numpy()
        view[:n] = data[:n]
        view[n:] = 0
        return stage.to(device, non_blocking=True)
    buf = np.zeros(padded, dtype=data.dtype)
    buf[:n] = data[:n]
    return torch.from_numpy(buf).to(device)


def _encode_against(name: str, values: np.ndarray, vocab: np.ndarray,
                    kind: str) -> np.ndarray:
    """int32 codes of ``values`` under a supplied sorted vocabulary;
    every value must be in it (reference storage/table.py:316-331)."""
    if kind == "string":
        values = np.asarray([("" if x is None else str(x)) for x in values])
    codes = np.searchsorted(vocab, values)
    codes = np.clip(codes, 0, max(len(vocab) - 1, 0))
    if len(vocab) and not np.all(vocab[codes] == values):
        raise ValidationError(
            f"{kind} column '{name}' contains values absent "
            "from the supplied vocabulary"
        )
    return codes.astype(np.int32)


def _code_stats(codes: np.ndarray, n: int) -> ColumnStats:
    return ColumnStats(
        min=float(codes.min()) if n else 0.0,
        max=float(codes.max()) if n else 0.0,
        null_count=0,
    )


def _f64_to_f32(name: str, v: np.ndarray) -> np.ndarray:
    """The f64 round-trip policy (reference storage/table.py:358-388)."""
    with np.errstate(over="ignore"):  # ±inf IS the answer
        as32 = v.astype(np.float32)
    exact = (as32.astype(np.float64) == v) | np.isnan(v)
    if len(v) and not exact.all():
        from ..config import get_config

        if get_config().f64_policy != "downcast":
            i = int(np.argmin(exact))
            raise ValidationError(
                f"float64 column '{name}' has values that do not round-trip "
                f"through the f32 device path (first: {v[i]!r} at row {i}, "
                f"would load as {float(as32[i])!r}).  Either cast the "
                "column to float32 yourself to accept the precision, or "
                "set config.f64_policy='downcast' to accept a documented "
                "<=2^-24 relative rounding on all float64 columns"
            )
    return as32
