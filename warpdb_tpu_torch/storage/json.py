"""Newline-delimited JSON ingest.

The reference JSON loader (json_loader.cpp:16-53) substring-scans each
line for only ``"price"`` and ``"quantity"`` and hardcodes the schema
``{price: f32, quantity: i32}``.  This loader parses real JSON and infers
the schema from the records (floats → Float32, ints → Int32, strings →
String), which reduces to the reference's schema on its own test data
(data/test.json).  Lines missing any inferred key are skipped, mirroring
the reference's skip-on-missing-key behavior (json_loader.cpp:34-35).
"""

from __future__ import annotations

import json
import os

from ..errors import WarpDBError
from .table import DataType, HostColumn, HostTable

__all__ = ["load_json_to_host"]


def load_json_to_host(filepath: str) -> HostTable:
    if not os.path.exists(filepath):
        raise WarpDBError("Unable to open file")

    records = []
    with open(filepath, "r") as f:
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

    if not records:
        return HostTable()

    # Schema from the first record; later records missing a key are skipped.
    keys = list(records[0].keys())
    dtypes: dict[str, DataType] = {}
    for k in keys:
        v = records[0][k]
        if isinstance(v, bool):
            dtypes[k] = DataType.INT32
        elif isinstance(v, int):
            dtypes[k] = DataType.INT32
        elif isinstance(v, float):
            dtypes[k] = DataType.FLOAT32
        else:
            dtypes[k] = DataType.STRING

    columns: dict[str, list] = {k: [] for k in keys}
    for rec in records:
        if any(k not in rec for k in keys):
            continue
        for k in keys:
            columns[k].append(rec[k])

    return HostTable(
        [HostColumn.build(k, dtypes[k], columns[k]) for k in keys]
    )
