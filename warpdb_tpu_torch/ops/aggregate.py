"""Grouped aggregation operators (GROUP BY, DISTINCT).

Counterpart of ``warpdb_tpu/ops/aggregate.py:52-504``.  Three tiers:

* sorted: one stable sort by the key tuple, segment ids from boundary
  flags, scatter-reductions per segment (``group_sort_stage`` /
  ``group_scatter_stage``);
* dense and midrange (stats-bounded integral keys): slot = key - base,
  one slot table (``slot_group_aggregate``).  The reference's dense tier
  reduces a virtual (N, G) matrix that XLA never materialises; eager
  torch would materialise it, so the port scatters into the slot table
  instead (``bincount`` / ``index_add_`` / ``scatter_reduce_``).
  SUM/COUNT-only midrange queries take kernel K2 (:mod:`.group_kernel`).

Groups emerge ascending by key; every result is a :class:`GroupResult`
whose tables have ``capacity`` (or ``num_slots``) rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .group_kernel import group_counts_sums
from .sort import U32_MAX, lexsort, sort_key_any

__all__ = [
    "ValueAggregates",
    "GroupResult",
    "sorted_first_flags",
    "group_sort_stage",
    "group_scatter_stage",
    "group_aggregate",
    "count_distinct",
    "slot_group_aggregate",
    "is_integral",
]

_F32 = torch.float32
_INF = float("inf")
_I32_MAX = 2**31 - 1


class ValueAggregates(NamedTuple):
    """Per-group aggregates of one value column."""

    sums: torch.Tensor  # f32[capacity]
    mins: torch.Tensor  # f32[capacity]
    maxs: torch.Tensor  # f32[capacity]


class GroupResult(NamedTuple):
    """Aggregate table; rows past ``num_groups`` (or with count 0) are
    empty.  Groups are ordered ascending by key."""

    keys: tuple              # key columns
    counts: torch.Tensor     # i32 rows per group
    values: tuple            # tuple[ValueAggregates, ...]
    num_groups: torch.Tensor  # 0-d int


def _as_key_tuple(keys) -> tuple:
    if isinstance(keys, (tuple, list)):
        return tuple(keys)
    return (keys,)


def sorted_first_flags(skeys_s: tuple) -> torch.Tensor:
    """Row-starts-a-new-key-run flags over lexicographically sorted key
    columns (position 0 is always a start)."""
    first = torch.zeros(skeys_s[0].shape, dtype=torch.bool,
                        device=skeys_s[0].device)
    if first.numel():
        first[0] = True
    for sk in skeys_s:
        first[1:] |= sk[1:] != sk[:-1]
    return first


def _scatter_table(seg, capacity, v, reduce, init):
    """``reduce`` of ``v`` per segment into a capacity-sized table;
    segments equal to ``capacity`` (invalid rows) are dropped."""
    out = torch.full((capacity + 1,), init, dtype=v.dtype, device=v.device)
    if reduce == "sum":
        out.index_add_(0, seg, v)
    else:
        out.scatter_reduce_(0, seg, v, reduce, include_self=True)
    return out[:capacity]


def _value_tables(seg, capacity, values_list, need) -> tuple:
    out = []
    for v in values_list:
        dev = v.device
        sums = (_scatter_table(seg, capacity, v, "sum", 0.0) if "sum" in need
                else torch.zeros(capacity, dtype=_F32, device=dev))
        mins = (_scatter_table(seg, capacity, v, "amin", _INF)
                if "min" in need
                else torch.full((capacity,), _INF, dtype=_F32, device=dev))
        maxs = (_scatter_table(seg, capacity, v, "amax", -_INF)
                if "max" in need
                else torch.full((capacity,), -_INF, dtype=_F32, device=dev))
        out.append(ValueAggregates(sums, mins, maxs))
    return tuple(out)


def group_sort_stage(keys, values_list, mask, skeys=None):
    """ONE stable sort by the key tuple carrying every value column, plus
    segment ids and the distinct-group count.  ``skeys`` overrides the
    sort keys (raw int keys); invalid rows get the sentinel."""
    keys = _as_key_tuple(keys)
    values_list = tuple(values_list)
    if skeys is None:
        skeys = tuple(sort_key_any(k) for k in keys)
    skeys = tuple(torch.where(mask, sk, U32_MAX) for sk in _as_key_tuple(skeys))
    perm = lexsort(skeys)
    skeys_s = tuple(sk[perm] for sk in skeys)
    keys_s = tuple(k[perm] for k in keys)
    valid_s = mask[perm]
    vals_s = tuple(v[perm] for v in values_list)
    first = sorted_first_flags(skeys_s) & valid_s
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    num_groups = first.sum()
    return keys_s, vals_s, valid_s, seg, num_groups


def group_scatter_stage(keys_s, vals_s, valid_s, seg, num_groups,
                        capacity: int, need=("sum", "min", "max")):
    """Scatter the pre-sorted segments into capacity-sized tables."""
    seg = torch.where(valid_s, seg, capacity)
    counts = torch.bincount(seg, minlength=capacity + 1)[:capacity]
    keys_out = tuple(
        _scatter_table(seg, capacity, k, "amin", _I32_MAX)
        if not k.dtype.is_floating_point
        else _scatter_table(seg, capacity, k, "amin", _INF)
        for k in keys_s
    )
    return GroupResult(keys_out, counts.to(torch.int32),
                       _value_tables(seg, capacity, vals_s, need), num_groups)


def group_aggregate(keys, values_list, mask, capacity: int) -> GroupResult:
    """Aggregate each value column per distinct key tuple."""
    stage = group_sort_stage(keys, values_list, mask)
    return group_scatter_stage(*stage, capacity)


def count_distinct(keys, mask) -> torch.Tensor:
    """Number of distinct valid key tuples."""
    keys = _as_key_tuple(keys)
    skeys = tuple(sort_key_any(k)[mask] for k in keys)
    if skeys[0].numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=mask.device)
    perm = lexsort(skeys)
    return sorted_first_flags(tuple(sk[perm] for sk in skeys)).sum()


def _slot_keys(keys, base: int, num_slots: int, device) -> tuple:
    # Integer key inputs reconstruct exactly in int32; float keys in f32.
    slots = torch.arange(num_slots, dtype=torch.int32, device=device)
    if not keys.dtype.is_floating_point:
        return (slots + base,)
    return (slots.to(_F32) + float(base),)


def slot_group_aggregate(keys, values_list, mask, base: int, num_slots: int,
                         need=("sum", "min", "max"),
                         use_hist: bool = False) -> GroupResult:
    """Slot-table GROUP BY for stats-bounded integral keys: slot = key -
    base; empty slots have count 0 and the caller compacts them away.
    One function serves the reference's ``dense_group_aggregate`` and
    ``midrange_group_aggregate``, which differ only in how the TPU
    reduces.  ``use_hist`` (SUM/COUNT-only) runs kernel K2; otherwise
    the scatter engine."""
    values_list = tuple(values_list)
    gid = keys.to(torch.int32) - base
    valid = mask & (gid >= 0) & (gid < num_slots)
    dev = keys.device
    if use_hist:
        g = torch.where(valid, gid, num_slots).to(torch.int32)
        want_sums = "sum" in need and len(values_list) > 0
        counts, sums = group_counts_sums(
            g, values_list if want_sums else (), num_slots
        )
        inf = torch.full((num_slots,), _INF, dtype=_F32, device=dev)
        zeros = torch.zeros(num_slots, dtype=_F32, device=dev)
        per_value = tuple(
            ValueAggregates(sums[i] if sums else zeros, inf, -inf)
            for i in range(len(values_list))
        )
    else:
        seg = torch.where(valid, gid, num_slots).to(torch.int64)
        counts = torch.bincount(seg, minlength=num_slots + 1)[:num_slots]
        counts = counts.to(torch.int32)
        per_value = _value_tables(seg, num_slots, values_list, need)
    return GroupResult(_slot_keys(keys, base, num_slots, dev), counts,
                       per_value, (counts > 0).sum())


def is_integral(values, mask) -> bool:
    """Every valid value is integral."""
    ok = ~mask | (values == torch.floor(values))
    return bool(ok.all())
