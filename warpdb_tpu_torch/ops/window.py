"""Window operators: ``AGG(v) OVER (PARTITION BY … ORDER BY … [frame])``.

Counterpart of ``warpdb_tpu/ops/aggregate.py:507-1489``.  Every function
takes the reference's arguments (partition key column(s), order key,
values, row mask) and returns f32[n] in row order, 0.0 where the mask is
false; the device is that of the inputs.

The reference shapes each operator for the TPU: invalid rows ride along
behind a sentinel key, neighbours are static shifts, segment heads and
tails travel by log2(n) doubling scans, because a per-row gather costs a
fifth of a second there.  Here the rows a mask keeps are compacted with
a boolean index first (which keeps row order), one stable sort orders
them by (partition keys, order key), and each row reaches its
partition's first and last sorted positions, its neighbours and its
frame ends by index arithmetic and gathers.  Ties keep row order, as
the reference's stable sorts do; ``DESC`` inverts the u32 order key
(``U32_MAX - k``) so NaN keeps its place as the largest value.

Sums are taken in float64 and returned as f32: a frame or running sum
is a difference of per-partition f64 prefix sums (an f32 prefix of a
2^20-row partition reaches ~5e7, whose rounding exceeds a short frame's
value; a prefix running across partitions would carry the earlier
partitions' totals into a small running sum), with NaN and ±inf counted
apart so that a non-finite value reaches only the ranges that hold it.
MIN/MAX over frames read a sparse table of the sorted values, built only
to the levels the longest frame needs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .aggregate import _scatter_sum, _scatter_table, sorted_first_flags
from .sort import U32_MAX, float_sort_key, lexsort, sort_key_any

__all__ = [
    "dense_window_aggregate",
    "window_aggregate",
    "window_rank",
    "window_shift",
    "window_edge_value",
    "window_ntile",
    "window_relative_rank",
    "window_nth_value",
    "window_running",
    "window_frame",
    "window_range_frame",
    "segmented_inclusive_scan",
]

_F32, _F64, _I64 = torch.float32, torch.float64, torch.int64
_SIGN = 0x80000000
_NAN = float("nan")
_INF = float("inf")


def _as_key_tuple(keys) -> tuple:
    if isinstance(keys, (tuple, list)):
        return tuple(keys)
    return (keys,)


# ---------------------------------------------------------------------------
# Sorted view and segment helpers
# ---------------------------------------------------------------------------


def _sort_perm(keys) -> torch.Tensor:
    """Stable permutation sorting by u32-valued int64 keys, most
    significant first.  Adjacent keys pack into one int64,
    ``(hi - 2^31) * 2^32 + lo``, which orders as the pair, so a
    partition key and an order key cost one sort."""
    packed = [((keys[i] - _SIGN) << 32) | keys[i + 1]
              for i in range(0, len(keys) - 1, 2)]
    if len(keys) % 2:
        packed.append(keys[-1])
    return lexsort(packed)


def _segments(first: torch.Tensor) -> tuple:
    """``(start, end)``: each row's segment's first and last position
    (``first[0]`` is set): segment ids by ``cumsum``, heads by
    ``nonzero``, one gather each."""
    seg = torch.cumsum(first.to(_I64), 0) - 1
    heads = torch.nonzero(first).reshape(-1)
    tails = torch.cat([heads[1:] - 1, heads.new_tensor([first.shape[0] - 1])])
    return heads[seg], tails[seg]


def _segment_offsets(first: torch.Tensor) -> torch.Tensor:
    """0-based distance of each row from its segment start."""
    pos = torch.arange(first.shape[0], device=first.device)
    return pos - _segments(first)[0]


class _Sorted(NamedTuple):
    """The valid rows in (partition keys, order key) order."""

    rows: torch.Tensor            # original row of each sorted position
    first: torch.Tensor           # starts a partition
    start: torch.Tensor           # partition's first sorted position
    end: torch.Tensor             # partition's last sorted position
    okey: Optional[torch.Tensor]  # order key, sorted


def _order_key(order_keys, ascending: bool) -> torch.Tensor:
    k = sort_key_any(order_keys)
    return k if ascending else U32_MAX - k


def _sorted_view(part_keys, mask, okey=None) -> _Sorted:
    """Compact the rows ``mask`` keeps and sort them stably by the
    partition keys, then ``okey`` (a u32-valued int64 key)."""
    rows = torch.nonzero(mask).reshape(-1)
    pks = [sort_key_any(k)[rows] for k in _as_key_tuple(part_keys)]
    keys = pks if okey is None else [*pks, okey[rows]]
    perm = _sort_perm(keys)
    first = sorted_first_flags(tuple(k[perm] for k in pks))
    return _Sorted(rows[perm], first, *_segments(first),
                   None if okey is None else keys[-1][perm])


def _scatter_back(view: _Sorted, out_s: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=_F32, device=out_s.device)
    out[view.rows] = out_s.to(_F32)
    return out


def _excl_prefix(x: torch.Tensor, dtype) -> torch.Tensor:
    """``p[i] = sum(x[:i])``, length ``len(x) + 1``."""
    p = torch.zeros(x.shape[0] + 1, dtype=dtype, device=x.device)
    torch.cumsum(x, 0, dtype=dtype, out=p[1:])
    return p


def _segment_scan(x: torch.Tensor, off: torch.Tensor, op) -> torch.Tensor:
    """Inclusive ``op``-scan (add, minimum, maximum) of ``x`` restarting
    at each segment (``off``: each row's distance into its segment), by
    doubling: one elementwise pass per bit of the longest segment, each
    combining only within a segment, so no sum carries another segment's
    total."""
    shift, top = 1, int(off.max())
    while shift <= top:
        prev = torch.zeros_like(x)
        prev[shift:] = x[:-shift]
        x = torch.where(off >= shift, op(x, prev), x)
        shift *= 2
    return x


def _range_sum(v: torch.Tensor, start: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor):
    """f64 sum of ``v[lo..hi]`` (inclusive, inside the segment that
    starts at ``start``) per row: a difference of per-segment f64 prefix
    sums of the finite values, with NaN, +inf and -inf counted exactly
    so each reaches only the ranges that hold it."""
    fin = torch.isfinite(v)
    off = torch.arange(v.shape[0], device=v.device) - start
    p = _segment_scan(torch.where(fin, v, 0.0).to(_F64), off, torch.add)
    s = p[hi] - torch.where(lo > start, p[torch.clamp(lo - 1, min=0)], 0.0)
    if bool(fin.all()):
        return s

    def count(ind):
        c = _excl_prefix(ind, _I64)
        return c[hi + 1] - c[lo]

    nan, pos, neg = count(torch.isnan(v)), count(v == _INF), count(v == -_INF)
    s = torch.where(neg > 0, -_INF, s)
    s = torch.where(pos > 0, _INF, s)
    return torch.where((nan > 0) | ((pos > 0) & (neg > 0)), _NAN, s)


def segmented_inclusive_scan(v: torch.Tensor, first: torch.Tensor,
                             op: str) -> torch.Tensor:
    """Running MIN (``op="min"``) or MAX (``"max"``) of ``v`` restarting
    where ``first`` is set; NaN propagates, as ``jnp.minimum`` /
    ``jnp.maximum`` do.  (Running sums are ``_range_sum`` from each
    segment's start.)"""
    if op not in ("min", "max"):
        raise ValueError(f"Unknown segmented scan: {op}")
    return _segment_scan(v, _segment_offsets(first),
                         torch.minimum if op == "min" else torch.maximum)


def _range_minmax(v: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  agg: str) -> torch.Tensor:
    """MIN/MAX of ``v[lo..hi]`` (inclusive) per row from a sparse table:
    level e holds the op over ``[i, i + 2^e)``, a range is two
    overlapping power-of-two windows.  Only the levels the longest range
    needs are built (at most ``log2(len(v))`` levels of ``len(v)``
    floats, freed on return)."""
    op = torch.minimum if agg == "min" else torch.maximum
    m = v.shape[0]
    length = hi - lo + 1
    levels = [v]
    width = 1
    while 2 * width <= int(length.max()):
        prev = levels[-1]
        levels.append(torch.cat([op(prev[:-width], prev[width:]),
                                 prev[m - width:]]))
        width *= 2
    e = torch.floor(torch.log2(length.to(_F64))).to(_I64)
    e = e - ((1 << e) > length).to(_I64) + ((2 << e) <= length).to(_I64)
    flat = torch.stack(levels).reshape(-1)
    return op(flat[e * m + lo], flat[e * m + hi - (1 << e) + 1])


def _frame_agg(val_s, start, lo, hi, agg: str) -> torch.Tensor:
    """``agg`` of ``val_s[lo..hi]`` per sorted row (inside the partition
    that starts at ``start``)."""
    if agg in ("min", "max"):
        return _range_minmax(val_s, lo, hi, agg)
    cnt = (hi - lo + 1).to(_F64)
    if agg == "count":
        return cnt
    s = _range_sum(val_s, start, lo, hi)
    return s if agg == "sum" else s / cnt


# ---------------------------------------------------------------------------
# Partition aggregates
# ---------------------------------------------------------------------------


def dense_window_aggregate(part_key, values, mask, agg: str, base: int,
                           num_slots: int) -> torch.Tensor:
    """``AGG(values) OVER (PARTITION BY key)`` for a stats-bounded
    integral key: slot = key - base, one slot table (``bincount`` and
    the dense GROUP BY's block-partial ``_scatter_sum``, here in f64:
    each row reads its partition's sum back, so an f32 table's rounding
    would reach every row), then each row gathers its slot.  No sort;
    rows keep their order."""
    gid = part_key.to(torch.int32) - base
    valid = mask & (gid >= 0) & (gid < num_slots)
    # Only the kept rows reach the table: rows a WHERE drops would all
    # land on one dropped slot and serialise its atomics.
    seg = gid[valid].to(_I64)
    v = values.to(_F32)[valid]
    if agg in ("sum", "avg", "count"):
        counts = torch.bincount(seg, minlength=num_slots)
        if agg == "count":
            table = counts.to(_F32)
        else:
            table = _scatter_sum(seg, num_slots, v.to(_F64))
            if agg == "avg":
                table = table / torch.clamp(counts, min=1)
    elif agg in ("min", "max"):
        table = _scatter_table(seg, num_slots, v, "a" + agg,
                               _INF if agg == "min" else -_INF)
    else:
        raise ValueError(f"Unknown window aggregate: {agg}")
    out = torch.zeros(values.shape[0], dtype=_F32, device=values.device)
    out[valid] = table.to(_F32)[seg]
    return out


def window_aggregate(part_keys, values, mask, agg: str) -> torch.Tensor:
    """Per-row ``AGG(values) OVER (PARTITION BY keys)``, sort-based:
    each row's partition aggregate over its [start, end] range."""
    if agg not in ("sum", "avg", "count", "min", "max"):
        raise ValueError(f"Unknown window aggregate: {agg}")
    n = values.shape[0]
    view = _sorted_view(part_keys, mask)
    if view.rows.numel() == 0:
        return torch.zeros(n, dtype=_F32, device=values.device)
    val_s = values.to(_F32)[view.rows]
    if agg in ("min", "max"):
        out_s = segmented_inclusive_scan(val_s, view.first, agg)[view.end]
    else:
        out_s = _frame_agg(val_s, view.start, view.start, view.end, agg)
    return _scatter_back(view, out_s, n)


# ---------------------------------------------------------------------------
# Ranking, neighbours and partition-edge values
# ---------------------------------------------------------------------------


def _ordered_view(part_keys, order_keys, mask, ascending):
    return _sorted_view(part_keys, mask, _order_key(order_keys, ascending))


def _peer_first(view: _Sorted) -> torch.Tensor:
    """Row starts a run of equal order keys within its partition."""
    f = view.first.clone()
    f[1:] |= view.okey[1:] != view.okey[:-1]
    return f


def window_rank(part_keys, order_keys, mask, kind: str,
                ascending: bool = True) -> torch.Tensor:
    """``ROW_NUMBER()`` / ``RANK()`` / ``DENSE_RANK()``
    OVER (PARTITION BY … ORDER BY …): a row's number is its offset from
    its partition's first sorted position plus one; RANK takes the
    number of the first row of its tied run; DENSE_RANK counts the
    distinct order keys up to the row within its partition."""
    if kind not in ("row_number", "rank", "dense_rank"):
        raise ValueError(f"Unknown ranking window function: {kind}")
    n = order_keys.shape[0]
    view = _ordered_view(part_keys, order_keys, mask, ascending)
    if view.rows.numel() == 0:
        return torch.zeros(n, dtype=_F32, device=order_keys.device)
    if kind == "row_number":
        out_s = _segment_offsets(view.first) + 1
    elif kind == "rank":
        out_s = _segments(_peer_first(view))[0] - view.start + 1
    else:
        runs = torch.cumsum(_peer_first(view).to(_I64), 0)
        out_s = runs - runs[view.start] + 1
    return _scatter_back(view, out_s, n)


def window_shift(part_keys, order_keys, values, mask, offset: int,
                 ascending: bool = True) -> torch.Tensor:
    """``LAG(expr, k)`` (offset=+k) / ``LEAD(expr, k)`` (offset=-k): the
    value k sorted rows back / ahead within the partition, NaN where no
    such row exists."""
    n = values.shape[0]
    view = _ordered_view(part_keys, order_keys, mask, ascending)
    if view.rows.numel() == 0:
        return torch.zeros(n, dtype=_F32, device=values.device)
    m = view.rows.shape[0]
    j = torch.arange(m, device=values.device) - int(offset)
    ok = (j >= view.start) & (j <= view.end)
    val_s = values.to(_F32)[view.rows]
    out_s = torch.where(ok, val_s[torch.clamp(j, 0, m - 1)], _NAN)
    return _scatter_back(view, out_s, n)


def window_edge_value(part_keys, order_keys, values, mask, last: bool = False,
                      ascending: bool = True) -> torch.Tensor:
    """``FIRST_VALUE(expr)`` / ``LAST_VALUE(expr)``: the value at the
    partition's first (last) sorted row, broadcast to the partition
    (LAST_VALUE uses the whole-partition frame, as the reference)."""
    n = values.shape[0]
    view = _ordered_view(part_keys, order_keys, mask, ascending)
    if view.rows.numel() == 0:
        return torch.zeros(n, dtype=_F32, device=values.device)
    val_s = values.to(_F32)[view.rows]
    return _scatter_back(view, val_s[view.end if last else view.start], n)


def window_ntile(part_keys, order_keys, mask, n_buckets: int,
                 ascending: bool = True) -> torch.Tensor:
    """``NTILE(n)``: bucket 1..n per partition row, sizes as even as
    possible, earlier buckets taking the remainder (standard SQL)."""
    n = order_keys.shape[0]
    view = _ordered_view(part_keys, order_keys, mask, ascending)
    if view.rows.numel() == 0:
        return torch.zeros(n, dtype=_F32, device=order_keys.device)
    r0 = _segment_offsets(view.first)
    cnt = view.end - view.start + 1
    small = torch.div(cnt, n_buckets, rounding_mode="floor")
    rem = cnt - small * n_buckets
    big = small + 1
    cut = rem * big  # rows 0..cut-1 live in the (small+1)-sized buckets
    bucket = torch.where(
        r0 < cut,
        torch.div(r0, torch.clamp(big, min=1), rounding_mode="floor"),
        rem + torch.div(r0 - cut, torch.clamp(small, min=1),
                        rounding_mode="floor"),
    ) + 1
    return _scatter_back(view, bucket, n)


def window_relative_rank(part_keys, order_keys, mask, kind: str,
                         ascending: bool = True) -> torch.Tensor:
    """``PERCENT_RANK()`` = (rank - 1) / (partition count - 1), 0 for a
    one-row partition; ``CUME_DIST()`` = rows with order key ≤ the
    current one, peers included, over the partition count."""
    if kind not in ("percent_rank", "cume_dist"):
        raise ValueError(f"Unknown relative-rank window function: {kind}")
    n = order_keys.shape[0]
    view = _ordered_view(part_keys, order_keys, mask, ascending)
    if view.rows.numel() == 0:
        return torch.zeros(n, dtype=_F32, device=order_keys.device)
    cnt = (view.end - view.start + 1).to(_F32)
    peer = _peer_first(view)
    if kind == "percent_rank":
        rank = _segments(peer)[0] - view.start + 1
        out_s = (rank - 1).to(_F32) / torch.clamp(cnt - 1, min=1)
    else:
        out_s = (_segments(peer)[1] - view.start + 1).to(_F32) / cnt
    return _scatter_back(view, out_s, n)


def window_nth_value(part_keys, order_keys, values, mask, nth: int,
                     ascending: bool = True) -> torch.Tensor:
    """``NTH_VALUE(expr, n)``: the value at the partition's n-th sorted
    row, broadcast to the partition; NaN where it has fewer rows."""
    n = values.shape[0]
    view = _ordered_view(part_keys, order_keys, mask, ascending)
    if view.rows.numel() == 0:
        return torch.zeros(n, dtype=_F32, device=values.device)
    target = view.start + (int(nth) - 1)
    val_s = values.to(_F32)[view.rows]
    present = target <= view.end
    m = view.rows.shape[0]
    out_s = torch.where(present, val_s[torch.clamp(target, max=m - 1)], _NAN)
    return _scatter_back(view, out_s, n)


# ---------------------------------------------------------------------------
# Running and framed aggregates
# ---------------------------------------------------------------------------


def window_running(part_keys, order_keys, values, mask, agg: str,
                   ascending: bool = True) -> torch.Tensor:
    """Running ``AGG(values) OVER (PARTITION BY … ORDER BY …)``: each row
    sees its partition's rows up to and including itself in sorted order
    (ROWS semantics: ties are not merged).  SUM/COUNT/AVG/MIN/MAX."""
    if agg not in ("sum", "count", "avg", "min", "max"):
        raise ValueError(f"Running window aggregate '{agg}' not supported")
    n = values.shape[0]
    view = _ordered_view(part_keys, order_keys, mask, ascending)
    if view.rows.numel() == 0:
        return torch.zeros(n, dtype=_F32, device=values.device)
    val_s = values.to(_F32)[view.rows]
    if agg in ("min", "max"):
        out_s = segmented_inclusive_scan(val_s, view.first, agg)
    else:
        pos = torch.arange(val_s.shape[0], device=val_s.device)
        out_s = _frame_agg(val_s, view.start, view.start, pos, agg)
    return _scatter_back(view, out_s, n)


def window_frame(part_keys, order_keys, values, mask, agg: str, preceding,
                 following, ascending: bool = True) -> torch.Tensor:
    """``AGG(v) OVER (PARTITION BY p ORDER BY o ROWS BETWEEN <preceding>
    PRECEDING AND <following> FOLLOWING)``; the bounds are row counts
    (``None`` = UNBOUNDED).  Row i's frame is the sorted positions
    ``[max(start, i - preceding), min(end, i + following)]``."""
    if agg not in ("sum", "count", "avg", "min", "max"):
        raise ValueError(f"Framed window aggregate '{agg}' not supported")
    n = values.shape[0]
    view = _ordered_view(part_keys, order_keys, mask, ascending)
    if view.rows.numel() == 0:
        return torch.zeros(n, dtype=_F32, device=values.device)
    pos = torch.arange(view.rows.shape[0], device=values.device)
    lo = (view.start if preceding is None
          else torch.maximum(view.start, pos - int(preceding)))
    hi = (view.end if following is None
          else torch.minimum(view.end, pos + int(following)))
    val_s = values.to(_F32)[view.rows]
    return _scatter_back(view, _frame_agg(val_s, view.start, lo, hi, agg), n)


def window_range_frame(part_keys, order_keys, values, mask, agg: str,
                       preceding, following,
                       ascending: bool = True) -> torch.Tensor:
    """``AGG(v) OVER (PARTITION BY p ORDER BY o RANGE BETWEEN
    <preceding> PRECEDING AND <following> FOLLOWING)``: the bounds are
    order-key offsets (``None`` = UNBOUNDED), and row i's frame holds
    every partition row j with ``o_j`` in ``[o_i - preceding,
    o_i + following]`` (f32 arithmetic; peers are always in).

    The rows sort ascending by value whatever the direction (DESC only
    swaps which offset extends toward smaller values); the frame ends
    are ``searchsorted`` positions of the bound keys in the sorted
    ``partition << 32 | float_sort_key(o)`` sequence, a lower bound
    before equal keys and an upper bound after them.  NaN order keys
    form one peer group at the partition's end (NaN ± offset is NaN)."""
    if agg not in ("sum", "count", "avg", "min", "max"):
        raise ValueError(f"Framed window aggregate '{agg}' not supported")
    n = values.shape[0]
    o = order_keys.to(_F32)
    view = _sorted_view(part_keys, mask, float_sort_key(o))
    if view.rows.numel() == 0:
        return torch.zeros(n, dtype=_F32, device=values.device)
    below = preceding if ascending else following
    above = following if ascending else preceding
    seg = (torch.cumsum(view.first.to(_I64), 0) - 1) << 32
    o_s = o[view.rows]

    def bound(x, sign):  # o ± x in f32, as the reference
        return float_sort_key(o_s + sign * torch.tensor(
            float(x), dtype=_F32, device=o.device))

    lo_key = (torch.zeros_like(view.okey) if below is None
              else bound(below, -1))
    hi_key = (torch.full_like(view.okey, U32_MAX) if above is None
              else bound(above, 1))
    keys = seg | view.okey
    lo = torch.searchsorted(keys, seg | lo_key)
    hi = torch.searchsorted(keys, seg | hi_key, right=True) - 1
    val_s = values.to(_F32)[view.rows]
    return _scatter_back(view, _frame_agg(val_s, view.start, lo, hi, agg), n)
