"""Device tables on torch tensors.

The host side (``HostTable``, ``ColumnStats``, ``DataType``, the loaders
and the dictionary encoders) is imported from ``warpdb_tpu.storage``: the
same numpy-backed ``HostTable`` feeds both packages.  This module is the
counterpart of ``warpdb_tpu/storage/table.py:DeviceTable`` and keeps its
rules:

* every numeric column is one padded tensor (zeros past ``num_rows``);
* string columns share ONE sorted vocabulary and ride as int32 codes;
* int64 columns beyond the int32 range ride as int32 codes into one
  shared sorted int64 vocabulary (order-isomorphic, so keys, order and
  comparisons against literals stay exact);
* float64 columns must round-trip through f32 unless
  ``config.f64_policy == "downcast"``;
* narrow int64 columns become int32 on the device (the reference's
  x64-disabled upload does the same);
* ``stats`` are the host stats, replaced by code stats for coded columns.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from warpdb_tpu.errors import ValidationError
from warpdb_tpu.storage.strings import (
    encode_int64_columns,
    encode_string_columns,
)
from warpdb_tpu.storage.table import (
    ColumnStats,
    DataType,
    HostTable,
    padded_length,
)

__all__ = ["DeviceTable", "DataType", "HostTable", "ColumnStats"]


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
    def from_host(cls, host: HostTable, device="cpu",
                  pad_multiple: Optional[int] = None,
                  keep_host: bool = True) -> "DeviceTable":
        if pad_multiple is None:
            from ..config import get_config

            pad_multiple = get_config().pad_multiple
        device = torch.device(device)
        n = host.num_rows
        padded = padded_length(n, pad_multiple)
        columns, dtypes, stats, dicts = {}, {}, {}, {}

        str_cols = {
            c.name: c.data[:n] for c in host.columns if not c.dtype.is_numeric
        }
        i64_cols = {}
        for c in host.columns:
            if c.dtype.is_numeric and c.data.dtype == np.int64 and n:
                lo, hi = int(c.data[:n].min()), int(c.data[:n].max())
                if lo < -(2**31) or hi > 2**31 - 1:
                    i64_cols[c.name] = c.data[:n]
        i64_encoded, i64_vocab = (
            encode_int64_columns(i64_cols) if i64_cols else ({}, None)
        )
        encoded, vocab = (
            encode_string_columns(str_cols) if str_cols else ({}, None)
        )

        for c in host.columns:
            dtypes[c.name] = c.dtype
            stats[c.name] = c.stats
            if not c.dtype.is_numeric:
                data = encoded[c.name]
                dicts[c.name] = vocab
                stats[c.name] = _code_stats(data, n)
            elif c.name in i64_encoded:
                data = i64_encoded[c.name]
                dicts[c.name] = i64_vocab
                stats[c.name] = _code_stats(data, n)
            else:
                data = c.data
                if data.dtype == np.float64:
                    data = _f64_to_f32(c.name, data[:n])
                elif data.dtype == np.int64:
                    data = data.astype(np.int32)
            buf = np.zeros(padded, dtype=data.dtype)
            buf[:n] = data[:n]
            columns[c.name] = torch.from_numpy(buf).to(device)
        return cls(columns, dtypes, n, padded, stats,
                   host if keep_host else None, dicts, device)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{t.value}" for n, t in self.dtypes.items())
        return (
            f"DeviceTable({self.num_rows} rows, padded {self.padded_rows}, "
            f"{self.device}; {cols})"
        )


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
