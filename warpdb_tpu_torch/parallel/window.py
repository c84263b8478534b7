"""Distributed window functions over the mesh.

Counterpart of ``warpdb_tpu/parallel/window.py``.  The partition
aggregate family, ``AGG(e) OVER (PARTITION BY k)`` for SUM / AVG /
COUNT / MIN / MAX with a stats-bounded integral key, distributes without
moving a row: each shard builds its local dense slot table, the tables
merge with one ``psum`` / ``pmin`` / ``pmax`` (num_slots values, not
rows), each shard gathers its rows' slots back from the merged table,
and the WHERE-compacted shard outputs gather to the root in global row
order (shard-major order is row order).  Sums add in float64, as the
single-device ``dense_window_aggregate`` does.

Ordered windows (ranking, frames, LAG / LEAD, edge values) need a global
order per partition; they take the gather route (the reference leaves
them to GSPMD).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.aggregate import _scatter_sum, _scatter_table
from ..utils.metrics import note_operator
from .comm import fetch_global
from .sharded import _ensure_sharded

__all__ = ["run_window_partition_agg_sharded"]

_F32 = torch.float32
_F64 = torch.float64
_INF = float("inf")


def run_window_partition_agg_sharded(select, where, table, base: int,
                                     num_slots: int, part_fn,
                                     mesh) -> np.ndarray:
    """Distributed ``AGG(e) OVER (PARTITION BY k)`` (the dense tier):
    the window column of the rows WHERE keeps, in row order (f32).
    ``part_fn`` evaluates the partition key (raw ints or integral f32,
    the dense GROUP BY key's contract); ``part_fn`` None means one
    partition (an empty PARTITION BY)."""
    from ..engine.compiler import _as_f32, broadcast, build_evaluator
    from ..engine.group_exec import _row_mask

    note_operator("dist_window", True)
    table = _ensure_sharded(table, mesh)
    agg = select.agg.value
    val_fn = build_evaluator(select.expr)
    sums, counts, folds, rows = [], [], [], []
    for s in table.shards:
        cols = s.row_columns()
        n = s.num_rows
        valid = _row_mask(where, s, cols)
        vals = broadcast(_as_f32(val_fn(cols)), n)
        pk = (broadcast(part_fn(cols), n) if part_fn is not None
              else torch.zeros(n, dtype=torch.int32, device=vals.device))
        gid = pk.to(torch.int32) - base
        ok = valid & (gid >= 0) & (gid < num_slots)
        seg = gid[ok].to(torch.int64)
        v = vals[ok]
        counts.append(torch.bincount(seg, minlength=num_slots).to(_F64))
        if agg in ("sum", "avg"):
            sums.append(_scatter_sum(seg, num_slots, v.to(_F64)))
        elif agg in ("min", "max"):
            folds.append(_scatter_table(seg, num_slots, v, "a" + agg,
                                        _INF if agg == "min" else -_INF))
        rows.append((gid, ok, valid))
    comm = mesh.comm
    if agg in ("min", "max"):
        merged = comm.reduce(folds, agg)
    elif agg == "count":
        merged = comm.reduce(counts, "sum")
    else:
        merged = comm.reduce(sums, "sum")
        if agg == "avg":
            merged = merged / torch.clamp(comm.reduce(counts, "sum"), min=1)
    merged = merged.to(_F32)
    parts = []
    for s, (gid, ok, valid) in zip(table.shards, rows):
        slot_vals = merged.to(s.device)
        out = torch.zeros(gid.shape[0], dtype=_F32, device=s.device)
        out[ok] = slot_vals[gid[ok].to(torch.int64)]
        parts.append(out[valid])
    return fetch_global(parts, mesh)
