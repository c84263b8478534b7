"""Distributed equi-join: hash-partitioned all-to-all shuffle join.

Counterpart of ``warpdb_tpu/parallel/dist_join.py``.  Both relations
send each row to the shard its join-key tuple hashes to
(``shuffle.hash_dest``, composite keys as tuples), so every occurrence
of a key lands on one shard with its payload columns; each shard then
joins the rows it owns with the port's own phase 1
(``ops/join.join_match_counts``) and expansion, kernel K3
(``ops/expand.windowed_expand``) — the function the reference computes
with ``join_gather_indices``.  INNER and LEFT apply per shard: every
probe row lands on exactly one shard, so an unmatched one emits once,
its build columns filled (NaN, or -1 for codes).

String keys compare through the probe side's vocabulary: the build
side's codes are translated before the exchange (``join_exec``'s
``_translated_right_key``), so equal strings hash and match equal.

Joined rows come out in hash-partition order, shard by shard (a parallel
hash join is unordered; an ORDER BY downstream restores any order), as a
:class:`ShardedTable` ready for the rest of the distributed pipeline.
The reference's static send buckets, output capacity, overflow retries
and ``ragged_all_to_all`` repack are XLA's static-shape protocol and are
not ported: exchanges send exact sizes and the joined shards stay where
they were built.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.expand import windowed_expand
from ..ops.join import join_match_counts
from ..utils.metrics import note_operator
from .mesh import DataMesh
from .sharded import ShardedTable, _ensure_sharded, bucketize
from .shuffle import hash_dest

__all__ = ["distributed_join", "distributed_join_table"]

_I32 = torch.int32
_I64 = torch.int64


def _partition_exchange(mesh: DataMesh, keys: list, payloads: list) -> list:
    """``keys[i]`` / ``payloads[i]``: local shard i's key and payload
    columns.  Each row goes to the shard its key tuple hashes to; returns
    per local shard ``(keys, payloads)`` of the rows it now owns."""
    n = mesh.size
    send = [bucketize(tuple(k) + tuple(p), hash_dest(tuple(k), n), n)
            for k, p in zip(keys, payloads)]
    nk = len(keys[0])
    out = []
    for row in mesh.comm.all_to_all(send):
        cols = [torch.cat(c) for c in zip(*row)]
        out.append((cols[:nk], cols[nk:]))
    return out


def _shard_join(lkeys, lpay, rkeys, rpay, kind: str):
    """Join one shard's owned rows: phase 1, then K3 expands every probe
    row into its matches (LEFT: at least one row each).  Returns the
    probe payload at each output row, the build payload (filled where
    unmatched), and the probe rows without a match."""
    from ..engine.join_exec import _build_columns

    p1 = join_match_counts(lkeys, None, rkeys, None)
    counts = p1.counts
    n_right = rkeys[0].shape[0]
    emit = counts.clamp(min=1) if kind == "left" else counts
    offsets = torch.cumsum(emit, 0) - emit
    total = int(emit.sum()) if emit.numel() else 0
    lo32 = p1.lo.clamp(0, max(n_right - 1, 0)).to(_I32)
    gather = list(lpay) + [lo32]
    if kind == "left":
        gather.append(counts.to(_I32))
    _owner, dup, taken = windowed_expand(offsets, gather, total)
    nl = len(lpay)
    slot = taken[nl].to(_I64) + dup
    matched = dup < taken[nl + 1] if kind == "left" else None
    rtaken = _build_columns(rpay, p1.build_order, slot, matched)
    n_miss = int((counts == 0).sum()) if kind == "left" else 0
    return list(taken[:nl]), rtaken, total, n_miss


def _run_dist_join(left: ShardedTable, right: ShardedTable, lkeys: list,
                   rkeys: list, lnames: Sequence[str], rnames: Sequence[str],
                   kind: str) -> list:
    """The shuffle join over per-shard key columns: per local shard
    ``(probe columns, build columns by name, rows, unmatched probe
    rows)``."""
    mesh = left.mesh
    lrecv = _partition_exchange(
        mesh, lkeys,
        [[s.row_columns()[c] for c in lnames] for s in left.shards])
    rrecv = _partition_exchange(
        mesh, rkeys,
        [[s.row_columns()[c] for c in rnames] for s in right.shards])
    out = []
    for (lk, lp), (rk, rp) in zip(lrecv, rrecv):
        lcols, rtaken, total, n_miss = _shard_join(
            lk, lp, rk, dict(zip(rnames, rp)), kind)
        out.append((dict(zip(lnames, lcols)), rtaken, total, n_miss))
    return out


def distributed_join_table(left, right, right_name: str, pairs,
                           needed: Optional[set], mesh: DataMesh,
                           kind: str = "inner") -> ShardedTable:
    """SQL route: shuffle-join two tables over ``mesh`` (each re-laid
    there first) and return the joined rows as a ShardedTable, columns
    named as the single-device join names them (build columns qualified,
    and bare where the name is free).  ``needed`` restricts the payload
    columns (projection pushdown)."""
    from ..engine.join_exec import _join_keys, _joined_table

    note_operator(f"dist_join_{kind}", True)
    note_operator("dist_join", True)
    left = _ensure_sharded(left, mesh)
    right = _ensure_sharded(right, mesh)
    keys = [_join_keys(ls, rs, right_name, pairs)
            for ls, rs in zip(left.shards, right.shards)]
    lnames = [n for n in left.shards[0].columns
              if needed is None or n in needed]

    def wanted(name: str) -> bool:
        return (needed is None or name in needed
                or f"{right_name}.{name}" in needed)

    rnames = [n for n in right.shards[0].columns if wanted(n)]
    joined = _run_dist_join(left, right, [k[0] for k in keys],
                            [k[1] for k in keys], lnames, rnames, kind)
    n_miss = sum(mesh.comm.gather_ints([j[3] for j in joined]))
    shards = [
        _joined_table(ls, rs, right_name, lcols, rtaken, total, total,
                      n_miss)
        for (lcols, rtaken, total, _m), ls, rs in zip(joined, left.shards,
                                                       right.shards)
    ]
    rows = mesh.comm.gather_ints([j[2] for j in joined])
    first = shards[0]
    return ShardedTable(shards, mesh, rows, dict(first.dtypes),
                        dict(first.stats), dict(first.dicts))


def distributed_join(left, right, left_key_col, right_key_col,
                     left_payload: Sequence[str],
                     right_payload: Sequence[str],
                     mesh: Optional[DataMesh] = None) -> dict:
    """Inner equi-join of two tables over ``mesh`` (default: the left
    table's).  ``left_key_col`` / ``right_key_col`` are column names or
    equal-length sequences (composite keys).  Returns ``{name: ndarray}``
    of the payload columns (right ones prefixed ``right.``), matched
    pairs in hash-partition order."""
    from ..engine.join_exec import _join_key_pair

    lk = [left_key_col] if isinstance(left_key_col, str) else list(
        left_key_col)
    rk = [right_key_col] if isinstance(right_key_col, str) else list(
        right_key_col)
    if mesh is None:
        mesh = left.mesh
    left = _ensure_sharded(left, mesh)
    right = _ensure_sharded(right, mesh)
    lkeys, rkeys = [], []
    for ls, rs in zip(left.shards, right.shards):
        pairs = [_join_key_pair(ls.row_columns()[a], rs.row_columns()[b])
                 for a, b in zip(lk, rk)]
        lkeys.append([p[0] for p in pairs])
        rkeys.append([p[1] for p in pairs])
    joined = _run_dist_join(left, right, lkeys, rkeys, list(left_payload),
                            list(right_payload), "inner")
    names = list(left_payload) + [f"right.{c}" for c in right_payload]
    parts = [tuple(lc[c] for c in left_payload)
             + tuple(rt[c] for c in right_payload)
             for lc, rt, _t, _m in joined]
    got = mesh.comm.all_gather(parts)
    return {name: np.concatenate([g[i].cpu().numpy() for g in got])
            for i, name in enumerate(names)}
