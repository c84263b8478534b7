"""Projections, global aggregates, DISTINCT and the per-group distinct
statistics over a row-sharded table.

The reference runs these under one jitted program over the sharded
columns, which XLA partitions (``warpdb_tpu/engine/executor.py``
``_run_projection``).  Here each runs its local phase on every shard,
on the shard's device, and only its partial state or its filtered rows
cross the mesh (``mesh.comm``), under the route names of ``routes.py``:

* ``"shard"`` (:func:`project_sharded`): a filtered projection of one
  item or several.  Each shard evaluates the items and the ORDER BY
  operands, compacts the rows its WHERE keeps and, under a LIMIT,
  keeps its first LIMIT + OFFSET rows in the statement's stable order.
  The pieces gather in shard-major order, which is row order, and an
  ORDER BY finishes with one stable sort on the root, so ties keep row
  order as on one device;
* ``"partials"`` (:func:`global_aggregates_sharded`): a count (int64),
  a float64 sum, a min and a max (f32; NaN propagates, as ``amin`` /
  ``amax`` on one device) a shard and an aggregate, all in one
  ``all_gather``; AVG and expressions finish on the merged partials;
* ``"dedupe"``: DISTINCT (:func:`distinct_sharded`: each shard's
  occupied slots through the single-device slot tier, kernel K2 on a
  midrange item, or its sort-unique values, gathered and deduped once
  more on the root) and COUNT(DISTINCT), global or grouped
  (:func:`grouped_count_distinct_sharded`): each shard's unique (group,
  value) pairs go to the shard their hash names (``all_to_all``), each
  shard counts the pairs it owns per group, and one psum adds the
  counts, so no device holds more than its share of the pairs;
* ``"registers"``: APPROX_COUNT_DISTINCT, global or grouped
  (:func:`grouped_hll_sharded`): each shard's u8 HyperLogLog registers,
  merged by elementwise max, which is order-free, so the registers
  equal the single-device ones bit for bit;
* the gather route for MEDIAN and PERCENTILE: the one compacted value
  column.

Grouped statistics index the merged group table: each shard maps its
rows' keys to their rank among the merged keys (ascending, as the
single-device segments).  The distinct statistics read a shard
``_SLICE_ROWS`` rows at a time, so that their int64 keys of every row
stay a few tens of MB beside a shard of any size.  Every step after an
exchange reads exchanged values only, so the ranks of a job issue the
same collectives.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frontend.ast import AggregationType
from ..ops.aggregate import slot_group_aggregate
from ..ops.hll import HLL_M, hll_estimate, hll_grouped_registers
from ..ops.sort import (
    distinct_values,
    float_sort_key,
    int_sort_key,
    lexsort,
    order_key,
)
from ..utils.metrics import note_operator
from ..storage.table import DeviceTable
from .routes import agg_route
from .sharded import bucketize, slot_plan
from .shuffle import hash_dest

__all__ = [
    "project_sharded",
    "global_aggregates_sharded",
    "distinct_sharded",
    "merged_key_sort_keys",
    "grouped_hll_sharded",
    "grouped_count_distinct_sharded",
]

_F32 = torch.float32
_F64 = torch.float64
_I64 = torch.int64
_INF = float("inf")
_M32 = 0xFFFFFFFF
# Rows of a shard a distinct statistic reads at a time: its int64 keys
# take ~40 B a row at the peak (~84 MB), each slice's pairs merge into
# the shard's unique set before the next.
_SLICE_ROWS = 1 << 21


def _gather_cat(table, parts: list) -> list:
    """``all_gather`` one tuple of columns a local shard; the columns
    concatenated in shard order, on the root device."""
    got = table.mesh.comm.all_gather(parts)
    return [torch.cat([g[i] for g in got]) for i in range(len(parts[0]))]


def _valid(query, shard) -> torch.Tensor:
    from ..engine.group_exec import _row_mask

    return _row_mask(query.where, shard, shard.row_columns())


def _f32_values(expr, shard) -> torch.Tensor:
    from ..engine.compiler import _as_f32, broadcast, build_evaluator

    vals = _as_f32(build_evaluator(expr)(shard.row_columns()))
    return broadcast(vals.to(shard.device), shard.num_rows)


def _row_slices(shard):
    """Views of ``shard``'s rows, ``_SLICE_ROWS`` at a time, as tables
    (one empty slice of an empty shard)."""
    rows = shard.row_columns()
    n = shard.num_rows
    for a in range(0, max(n, 1), _SLICE_ROWS):
        b = min(a + _SLICE_ROWS, n)
        yield DeviceTable({k: v[a:b] for k, v in rows.items()},
                          shard.dtypes, b - a, b - a, stats=shard.stats,
                          dicts=shard.dicts, device=shard.device)


def _order_perm(keys: list, terms) -> torch.Tensor:
    return lexsort([order_key(k, None, t.ascending)
                    for k, t in zip(keys, terms)])


# ---------------------------------------------------------------------------
# "shard": filtered projections
# ---------------------------------------------------------------------------


def project_sharded(query, table, items: list) -> list:
    """The non-grouped projection ``items`` of ``query`` (WHERE, ORDER
    BY, LIMIT + OFFSET as the single-device path reads them): one NumPy
    column an item, f32 or a bare INT column's raw dtype; the caller
    slices OFFSET / LIMIT."""
    from ..engine.compiler import raw_int_item
    from ..engine.executor import _order_operand, _row_values, _where_mask

    note_operator("sharded_project", True)
    raw = [raw_int_item(it, table.shards[0]) for it in items]
    terms = query.order_by.terms if query.order_by is not None else ()
    canon = [it.canonical() for it in items]
    # An ORDER BY term that is a select item rides that item's column.
    key_at, extra = [], []
    for t in terms:
        c = t.expr.canonical()
        if c in canon:
            key_at.append(canon.index(c))
        else:
            key_at.append(len(items) + len(extra))
            extra.append(t)
    limit = (None if query.limit is None
             else query.limit + (query.offset or 0))
    parts = []
    for s in table.shards:
        cols = [_row_values(it, s, r) for it, r in zip(items, raw)]
        cols += [_order_operand(t, s) for t in extra]
        valid = _where_mask(query, s)
        if valid is not None:
            cols = [c[valid] for c in cols]
        if limit is not None:
            if terms:
                perm = _order_perm([cols[i] for i in key_at], terms)[:limit]
                cols = [c[perm] for c in cols]
            else:
                cols = [c[:limit] for c in cols]
        parts.append(tuple(cols))
    cols = _gather_cat(table, parts)
    outs = cols[:len(items)]
    if terms:
        perm = _order_perm([cols[i] for i in key_at], terms)
        if limit is not None:
            perm = perm[:limit]
        outs = [o[perm] for o in outs]
    return [o.cpu().numpy().astype(np.float32 if r is None else r[1])
            for o, r in zip(outs, raw)]


# ---------------------------------------------------------------------------
# Global aggregates: "partials", "dedupe", "registers", the gather route
# ---------------------------------------------------------------------------


def _partial_columns(agg, vals: torch.Tensor, valid: torch.Tensor) -> list:
    """One shard's partials of ``agg``: ``[(merge op, 1-element
    tensor), ...]``."""
    cnt = valid.sum().to(_I64).reshape(1)
    if agg is AggregationType.COUNT:
        return [("sum", cnt)]
    if agg == "count_nullsub":
        nulls = torch.where(valid, vals, 0.0).to(_I64).sum()
        return [("sum", cnt - nulls)]
    if agg in (AggregationType.SUM, AggregationType.AVG):
        total = torch.where(valid, vals, 0.0).sum(dtype=_F64).reshape(1)
        return ([("sum", total)] if agg is AggregationType.SUM
                else [("sum", cnt), ("sum", total)])
    lo = agg is AggregationType.MIN
    fill = _INF if lo else -_INF
    v = torch.where(valid, vals, fill)
    ext = (v.amin() if lo else v.amax()) if v.numel() else \
        torch.tensor(fill, dtype=_F32, device=vals.device)
    return [("min" if lo else "max", ext.reshape(1))]


def _finish_partial(agg, merged: list) -> float:
    if agg is AggregationType.AVG:
        cnt, total = merged
        return float(np.float32(float(total) / max(int(cnt), 1)))
    return float(np.float32(float(merged[0])))


def _merge(op: str, col: torch.Tensor) -> torch.Tensor:
    return col.sum() if op == "sum" else (col.amin() if op == "min"
                                          else col.amax())


def _u32_as_i32(k: torch.Tensor) -> torch.Tensor:
    """A [0, 2^32) sort key as int32 (order kept), which ``hash_dest``
    hashes as the key itself."""
    return (k - (1 << 31)).to(torch.int32)


def _global_dedupe(table, query, expr) -> float:
    """COUNT(DISTINCT expr): ``_count_pairs`` of each shard's unique
    value keys (-0.0 equal to +0.0, every NaN one value), one group."""
    pairs = [_shard_pairs(query, s, expr, None) for s in table.shards]
    return float(_count_pairs(table, pairs, 1)[0])


def _global_registers(table, query, expr) -> float:
    """APPROX_COUNT_DISTINCT(expr): each shard's (1, 4096) u8 registers,
    merged by max; the single-device registers bit for bit."""
    parts = []
    for s in table.shards:
        regs = torch.zeros((1, HLL_M), dtype=torch.int32, device=s.device)
        for part in _row_slices(s):
            vals = _f32_values(expr, part)
            regs = torch.maximum(regs, hll_grouped_registers(
                torch.zeros(vals.shape, dtype=_I64, device=vals.device),
                float_sort_key(vals), _valid(query, part), 1))
        parts.append((regs.to(torch.uint8),))
    (regs,) = _gather_cat(table, parts)
    merged = regs.amax(0, keepdim=True).to(torch.int32)
    return float(hll_estimate(merged)[0])


def _global_order_stat(table, query, agg, param, expr) -> float:
    """MEDIAN / PERCENTILE: the compacted value column, gathered, and the
    single-device interpolation over it.  With no matching row (but
    rows) the single-device path reads its first row's value: so does
    this, from one more gather of a value a shard."""
    from ..engine.executor import _global_agg_value

    parts = [(_f32_values(expr, s)[_valid(query, s)],)
             for s in table.shards]
    (vals,) = _gather_cat(table, parts)
    if vals.numel() == 0 and table.num_rows > 0:
        (firsts,) = _gather_cat(table, [(_f32_values(expr, s)[:1],)
                                        for s in table.shards])
        return float(_global_agg_value(
            agg, param, firsts[:1],
            torch.zeros(1, dtype=torch.bool, device=firsts.device)))
    return float(_global_agg_value(
        agg, param, vals, torch.ones(vals.shape, dtype=torch.bool,
                                     device=vals.device)))


def global_aggregates_sharded(query, table, specs: list) -> dict:
    """Every aggregate of ``specs`` (``group_exec._AggSpec``) over the
    rows WHERE keeps, by spec key, as f32 Python floats: the partials of
    all "partials" aggregates in one ``all_gather``; each other
    aggregate by its own route."""
    from ..engine.executor import _count_rewrite

    note_operator("sharded_global_agg", True)
    rewritten = [(s, *_count_rewrite(s.agg, s.expr, table)) for s in specs]
    partial = [r for r in rewritten if agg_route(r[1]) == "partials"]
    out = {}
    if partial:
        ops, parts = None, []
        for s in table.shards:
            valid = _valid(query, s)
            cols = [c for _spec, agg, expr in partial
                    for c in _partial_columns(agg, _f32_values(expr, s),
                                              valid)]
            ops = [op for op, _c in cols]
            parts.append(tuple(c for _op, c in cols))
        merged = [_merge(op, c) for op, c in zip(ops,
                                                 _gather_cat(table, parts))]
        at = 0
        for spec, agg, _expr in partial:
            width = 2 if agg is AggregationType.AVG else 1
            out[spec.key] = _finish_partial(agg, merged[at:at + width])
            at += width
    for spec, agg, expr in rewritten:
        route = agg_route(agg)
        if route == "dedupe":
            out[spec.key] = _global_dedupe(table, query, expr)
        elif route == "registers":
            out[spec.key] = _global_registers(table, query, expr)
        elif route != "partials":
            out[spec.key] = _global_order_stat(table, query, agg,
                                               spec.param, expr)
    return out


# ---------------------------------------------------------------------------
# "dedupe": DISTINCT of one item
# ---------------------------------------------------------------------------


def distinct_sharded(query, table, select) -> np.ndarray:
    """SELECT DISTINCT of one item, ascending: each shard's distinct
    values (its occupied slots under the single-device slot tier,
    decided once on the whole table, with K2 on a midrange item; else
    its sort-unique values), gathered in shard order and deduped once
    more, so each value is its first occurrence in row order."""
    from ..engine.compiler import broadcast, raw_int_item
    from ..engine.executor import _row_values

    note_operator("sharded_distinct", True)
    raw = raw_int_item(select, table.shards[0])
    tier = slot_plan(table, [select], ())
    parts = []
    for s in table.shards:
        valid = _valid(query, s)
        if tier is not None:
            kp, _name, use_k2 = tier
            keys = broadcast(kp["key_fn"](s.row_columns()), s.num_rows)
            ones = torch.ones((), dtype=_F32,
                              device=keys.device).expand(s.num_rows)
            res = slot_group_aggregate(keys, (ones,), valid, kp["base"],
                                       kp["num_slots"], (), use_k2)
            x = res.keys[0][res.counts > 0]
        else:
            x = distinct_values(_row_values(select, s, raw)[valid])
        parts.append((x,))
    (x,) = _gather_cat(table, parts)
    return distinct_values(x).cpu().numpy().astype(
        np.float32 if raw is None else raw[1])


# ---------------------------------------------------------------------------
# Per-group statistics against the merged group table
# ---------------------------------------------------------------------------


def merged_key_sort_keys(keys: tuple, raw_int_key: bool) -> tuple:
    """The merged group table's keys (ascending) in the sort-key space of
    ``group_exec._order_stat_keys``: raw int for one integer key, the
    f32 total order otherwise."""
    if raw_int_key and len(keys) == 1:
        return (int_sort_key(keys[0]),)
    return tuple(float_sort_key(k.to(_F32)) for k in keys)


def _group_ids(gkeys: tuple, rkeys: list) -> torch.Tensor:
    """Each row's index among the merged (ascending, distinct) key tuples
    ``gkeys``; every row's tuple is one of them."""
    gkeys = tuple(g.to(rkeys[0].device) for g in gkeys)
    if len(rkeys) == 1:
        return torch.searchsorted(gkeys[0], rkeys[0])
    ng, n = gkeys[0].shape[0], rkeys[0].shape[0]
    dev = rkeys[0].device
    flag = torch.cat([torch.zeros(ng, dtype=_I64, device=dev),
                      torch.ones(n, dtype=_I64, device=dev)])
    perm = lexsort([*(torch.cat([g, r]) for g, r in zip(gkeys, rkeys)),
                    flag])
    is_row = perm >= ng
    rank = torch.cumsum((~is_row).to(_I64), 0) - 1
    gid = torch.empty(n, dtype=_I64, device=dev)
    gid[perm[is_row] - ng] = rank[is_row]
    return gid


def _shard_groups(query, shard, group_keys, expr, gkeys,
                  raw_int_key: bool) -> tuple:
    """``(group ids, value sort keys)`` of the rows WHERE keeps of one
    shard (or slice of one)."""
    from ..engine.group_exec import _order_stat_keys

    valid = _valid(query, shard)
    rkeys = [k[valid] for k in _order_stat_keys(
        query, shard, group_keys, raw_int_key, shard.row_columns())]
    vals = _f32_values(expr, shard)[valid]
    return _group_ids(gkeys, rkeys), float_sort_key(vals)


def _shard_pairs(query, shard, expr, groups) -> torch.Tensor:
    """A shard's unique (group id, value sort key) pairs, packed in one
    int64 each, ascending, deduped slice by slice; ``groups``: the
    ``(group_keys, merged sort keys, raw_int_key)`` of a grouped
    statistic, None for one group."""
    acc = None
    for part in _row_slices(shard):
        if groups is None:
            valid = _valid(query, part)
            pairs = float_sort_key(_f32_values(expr, part)[valid])
        else:
            gid, skey = _shard_groups(query, part, groups[0], expr,
                                      groups[1], groups[2])
            pairs = (gid << 32) | skey
        u = torch.unique(pairs)
        acc = u if acc is None else torch.unique(torch.cat([acc, u]))
    return acc


def _count_pairs(table, pairs: list, ng: int) -> torch.Tensor:
    """Distinct pairs a group (int64, on the root) from each local
    shard's unique ``pairs``: every pair goes to the shard its hash
    names, each shard dedupes the pairs it owns and counts them a group,
    and one psum adds the counts."""
    n = table.mesh.size
    send = [bucketize((u,), hash_dest(((u >> 32).to(torch.int32),
                                       _u32_as_i32(u & _M32)), n), n)
            for u in pairs]
    counts = []
    for row in table.mesh.comm.all_to_all(send):
        owned = torch.unique(torch.cat([c[0] for c in row]))
        counts.append(torch.bincount(owned >> 32, minlength=ng)[:ng])
    return table.mesh.comm.reduce(counts, "sum")


def grouped_hll_sharded(query, table, group_keys, spec, gkeys,
                        raw_int_key: bool, want_registers: bool = False):
    """Per-group APPROX_COUNT_DISTINCT: each shard's (groups, 4096) u8
    registers, merged by elementwise max; the estimates (f32 NumPy), or
    with ``want_registers`` the merged u8 registers."""
    note_operator("sharded_hll", True)
    ng = int(gkeys[0].shape[0])
    if ng == 0:
        regs = torch.zeros((0, HLL_M), dtype=torch.uint8)
        return (regs.numpy() if want_registers
                else hll_estimate(regs.to(torch.int32)).numpy())
    parts = []
    for s in table.shards:
        regs = torch.zeros((ng, HLL_M), dtype=torch.int32, device=s.device)
        for part in _row_slices(s):
            gid, skey = _shard_groups(query, part, group_keys, spec.expr,
                                      gkeys, raw_int_key)
            regs = torch.maximum(regs, hll_grouped_registers(gid, skey,
                                                             None, ng))
        parts.append((regs.to(torch.uint8),))
    (regs,) = _gather_cat(table, parts)
    merged = regs.reshape(-1, ng, HLL_M).amax(0)
    if want_registers:
        return merged.cpu().numpy()
    return hll_estimate(merged.to(torch.int32)).cpu().numpy().astype(
        np.float32)


def grouped_count_distinct_sharded(query, table, group_keys, spec, gkeys,
                                   raw_int_key: bool) -> np.ndarray:
    """Per-group COUNT(DISTINCT): ``_count_pairs`` of each shard's unique
    (group, value key) pairs; the counts per group (f32 NumPy)."""
    note_operator("sharded_count_distinct", True)
    ng = int(gkeys[0].shape[0])
    if ng == 0:
        return np.zeros(0, np.float32)
    groups = (group_keys, gkeys, raw_int_key)
    pairs = [_shard_pairs(query, s, spec.expr, groups) for s in table.shards]
    return _count_pairs(table, pairs, ng).to(_F32).cpu().numpy()
