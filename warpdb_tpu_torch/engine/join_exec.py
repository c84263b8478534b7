"""JOIN execution: materialisation and the join rewrites.

Counterpart of ``warpdb_tpu/engine/join_exec.py``: equi-joins (INNER,
LEFT, RIGHT, FULL, CROSS, composite keys), the join memo, probe- and
build-side WHERE pushdown, implicit comma joins, theta residuals and the
eager-aggregation rewrite.  Results, row order included, are the
reference's:

* expansion output runs in probe-row order, then through each probe
  row's matches in stable sorted-build order;
* lookup and semicompact outputs keep probe order;
* RIGHT/FULL build misses follow in build order.

The TPU's capacity buckets are gone: joined tables hold exactly their
rows, and ``num_rows``, ``stats`` and ``dicts`` are set as the
reference sets them.  Kernels on this path: K3 (``windowed_expand``) for
every non-uniform expansion and LEFT expansion, K4 (``uniform_expand``)
for uniform fan-out inner joins, K5 (``sorted_take``) for the
semicompact probe gather and the probe-pushdown compaction.  The mesh
route of the reference is not ported.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..errors import UnsupportedError, ValidationError
from ..frontend.ast import (
    Aggregation,
    AggregationType,
    Alias,
    BinaryOp,
    CaseWhen,
    Constant,
    column_refs,
    FunctionCall,
    GroupBy,
    Join,
    Node,
    OrderBy,
    Query,
    Star,
    Variable,
    unalias,
    walk,
)
from ..storage.table import ColumnStats, HostTable
from ..config import get_config
from ..ops.expand import sorted_take, uniform_expand, windowed_expand
from ..ops.join import join_match_counts
from ..parallel.mesh import mesh_width
from ..parallel.routes import mesh_route
from ..parallel.sharded import is_sharded, local_table
from ..storage.table import DeviceTable
from ..utils.metrics import note_operator
from . import udf as udf_mod
from .compiler import (
    _as_bool,
    _as_f32,
    broadcast,
    build_evaluator,
    memo_get,
    memo_put,
)

_I32 = torch.int32
_I64 = torch.int64


def _and_conjuncts(node) -> list:
    """Flatten a top-level AND chain into its conjuncts."""
    if isinstance(node, BinaryOp) and node.op == "&&":
        return _and_conjuncts(node.left) + _and_conjuncts(node.right)
    return [node]


def _and_chain(nodes: list):
    out = None
    for n in nodes:
        out = n if out is None else BinaryOp("&&", out, n)
    return out


def _cached_count(table, key, compute) -> int:
    """A counted cardinality memoised per immutable table instance."""
    memo = getattr(table, "_count_memo", None)
    if memo is None:
        memo = table._count_memo = {}
    if key not in memo:
        memo[key] = int(compute())
    return memo[key]


def _fill_value(dtype) -> float:
    """The missing-value marker: -1 for int32 columns and codes, NaN
    for float columns."""
    return -1 if dtype == _I32 else float("nan")


# ---------------------------------------------------------------------------
# Key resolution
# ---------------------------------------------------------------------------


def _equality_pairs(cond: Node) -> list:
    """Flatten ``a = b [AND c = d …]`` into column-equality pairs."""
    if isinstance(cond, BinaryOp) and cond.op == "&&":
        return _equality_pairs(cond.left) + _equality_pairs(cond.right)
    if (
        isinstance(cond, BinaryOp)
        and cond.op in ("=", "==")
        and isinstance(cond.left, Variable)
        and isinstance(cond.right, Variable)
    ):
        return [(cond.left, cond.right)]
    raise UnsupportedError(
        "JOIN conditions must be column equalities joined with AND "
        "(a.x = b.y [AND ...])"
    )


def _resolve_column(cols: dict, var: Variable) -> torch.Tensor:
    arr = cols.get(var.name)
    if arr is None:
        arr = cols.get(var.unqualified)
    if arr is None:
        raise ValidationError(f"Unknown column: {var.name}")
    return arr


def _resolve_join_sides(left, right, right_name, pairs):
    """Assign each pair's variables to the probe (left) / build (right)
    side: a qualifier naming the right relation binds right; otherwise
    left wins, then right.  Returns [(left_var, right_var)]."""

    def side_of(var: Variable):
        if var.qualifier == right_name and (
            var.unqualified in right.columns or var.name in right.columns
        ):
            return "right"
        if var.name in left.columns or var.unqualified in left.columns:
            return "left"
        if var.name in right.columns or var.unqualified in right.columns:
            return "right"
        raise ValidationError(f"Unknown column: {var.name}")

    out = []
    for a, b in pairs:
        sa, sb = side_of(a), side_of(b)
        if {sa, sb} != {"left", "right"}:
            # Same-side equality (a self-join on one column name): the
            # left occurrence probes, the right one builds.
            out.append((a, b))
        else:
            out.append((a if sa == "left" else b, b if sb == "right" else a))
    return out


def _dict_of(table, var: Variable):
    if not table.dicts:
        return None
    v = table.dicts.get(var.name)
    return v if v is not None else table.dicts.get(var.unqualified)


def _int64_vocab_codes(vocab: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Codes of ``values`` under the int64 vocabulary ``vocab``; values
    absent from it get -1 (match nothing).  Float values compare as
    int64, and only integral values inside the int64 range can hit: the
    reference compares them in f64, where 2^53 equals 2^53 + 1."""
    if values.dtype.kind == "f":
        v = values.astype(np.float64)
        with np.errstate(invalid="ignore"):
            ok = (np.isfinite(v) & (v == np.floor(v))
                  & (v >= -(2.0**63)) & (v < 2.0**63))
        ints = np.where(ok, v, 0.0).astype(np.int64)
    else:
        ok = np.ones(values.shape, bool)
        ints = values.astype(np.int64)
    if not len(vocab):
        return np.full(values.shape, -1, np.int32)
    pos = np.clip(np.searchsorted(vocab, ints), 0, len(vocab) - 1)
    hit = ok & (vocab[pos] == ints)
    return np.where(hit, pos, -1).astype(np.int32)


def _translated_right_key(left, right, left_var, right_var):
    """One pair's key tensors (reference ``_translated_right_key``): a
    dictionary-coded build key is re-expressed under the probe side's
    vocabulary (absent values → -1, matching nothing); a wide-int64
    coded key joined with a raw numeric key maps through the values.
    Host-side arrays land on the build table's device."""
    lkey = _resolve_column(left.row_columns(), left_var)
    rkey = _resolve_column(right.row_columns(), right_var)
    lvocab, rvocab = _dict_of(left, left_var), _dict_of(right, right_var)
    dev = right.device
    if (lvocab is None) != (rvocab is None):
        v = lvocab if lvocab is not None else rvocab
        if getattr(v, "dtype", None) is None or v.dtype.kind not in "iu":
            raise ValidationError(
                "JOIN condition compares a string column with a numeric "
                "column"
            )
        if lvocab is not None:
            # Probe coded, build raw: encode build values under the
            # probe vocabulary, exactly.
            codes = _int64_vocab_codes(lvocab, rkey.cpu().numpy())
            return lkey, torch.as_tensor(codes, device=dev)
        # Probe raw, build coded: decode the build codes to values;
        # values outside int32 can never match an int32 probe, so they
        # map to a sentinel provably outside the probe's stats range.
        rcodes = rkey.cpu().numpy().astype(np.int64)
        idx = np.clip(rcodes, 0, max(len(rvocab) - 1, 0))
        vals = rvocab[idx] if len(rvocab) else np.zeros_like(idx)
        miss = (rcodes < 0) | (vals < -(2**31)) | (vals > 2**31 - 1)
        st = left.stats.get(left_var.name) or left.stats.get(
            left_var.unqualified
        )
        if lkey.dtype.is_floating_point:
            # The join compares in f32: the sentinel must be an exact
            # f32 value strictly outside the probe's range.
            if st is not None and st.max is not None and np.isfinite(st.max):
                sent = float(np.nextafter(np.float32(st.max),
                                          np.float32(np.inf)))
            elif st is not None and st.min is not None and np.isfinite(st.min):
                sent = float(np.nextafter(np.float32(st.min),
                                          np.float32(-np.inf)))
            else:
                raise ValidationError(
                    "JOIN between a wide-int64 key and an unbounded float "
                    "key is not supported; load both sides as int64"
                )
            keys = np.where(miss, sent, vals).astype(np.float32)
            return lkey, torch.as_tensor(keys, device=dev)
        if st is not None and st.max is not None and st.max < 2**31 - 1:
            sent = int(st.max) + 1
        elif st is not None and st.min is not None and st.min > -(2**31):
            sent = int(st.min) - 1
        else:
            raise ValidationError(
                "JOIN between a wide-int64 key and a full-range numeric key "
                "is not supported; load both sides as int64"
            )
        keys = np.where(miss, sent, vals).astype(np.int32)
        return lkey, torch.as_tensor(keys, device=dev)
    if lvocab is not None:
        from ..storage.strings import vocab_mapping

        mapping = vocab_mapping(rvocab, lvocab)
        if not len(mapping):
            return lkey, torch.full(rkey.shape, -1, dtype=_I32, device=dev)
        m = torch.as_tensor(mapping, device=dev)
        rkey = m[rkey.to(_I64).clamp(0, len(mapping) - 1)]
    return lkey, rkey


def _join_key_pair(lkey, rkey):
    """Both sides integer → raw int32 keys (exact beyond 2^24);
    anything else compares in f32."""
    if not lkey.dtype.is_floating_point and not rkey.dtype.is_floating_point:
        return lkey.to(_I32), rkey.to(_I32)
    return _as_f32(lkey), _as_f32(rkey)


def _join_keys(left, right, right_name, pairs):
    lkeys, rkeys = [], []
    for left_var, right_var in _resolve_join_sides(left, right, right_name,
                                                   pairs):
        lk, rk = _join_key_pair(
            *_translated_right_key(left, right, left_var, right_var)
        )
        lkeys.append(lk)
        rkeys.append(rk)
    return lkeys, rkeys


# ---------------------------------------------------------------------------
# Materialisation
# ---------------------------------------------------------------------------

_TABLE_UID = [0]


def _table_uid(table) -> int:
    """Stable identity of a table instance (``id`` can be reused after
    garbage collection; this cannot)."""
    uid = getattr(table, "_uid", None)
    if uid is None:
        _TABLE_UID[0] += 1
        uid = table._uid = _TABLE_UID[0]
    return uid


def _materialize_join(left, right, right_name: str, cond: Optional[Node],
                      needed: Optional[set] = None,
                      kind: str = "inner") -> DeviceTable:
    """One join, memoised per probe-table instance (LRU of
    ``join_cache_entries``; tables are immutable, so an entry never goes
    stale).  ``needed`` restricts the gathered columns (projection
    pushdown).  RIGHT = INNER plus build misses, FULL = LEFT plus build
    misses; CROSS is an equi-join on a constant key."""
    pairs = [] if kind == "cross" else _equality_pairs(cond)
    cache_cap = get_config().join_cache_entries
    mesh = (left.mesh if is_sharded(left)
            else right.mesh if is_sharded(right) else None)
    mkey = (
        _table_uid(right), right_name,
        "<cross>" if cond is None else cond.canonical(), kind,
        None if needed is None else frozenset(needed),
        None if mesh is None else mesh.size,
    )
    if cache_cap > 0:
        hit = memo_get(left, "_join_memo", mkey)
        if hit is not None:
            return hit[0]  # hit[1] keeps the build table (and its uid) alive

    cond_names = set() if cond is None else {
        nm for v in column_refs(cond) for nm in (v.name, v.unqualified)}
    if kind in ("right", "full"):
        base = _materialize_join(left, right, right_name, cond, needed,
                                 "inner" if kind == "right" else "left")
        # The tail reads the probe's keys and the build columns the
        # joined table carries.
        out = _append_build_misses(
            local_table(base), _one_device(left, cond_names),
            _one_device(right, cond_names | set(base.columns), right_name),
            right_name, pairs, left_names=set(left.columns))
    elif (mesh is not None
          and mesh_route("join", left, join=(kind, cond)) == "shuffle"):
        from ..parallel.dist_join import distributed_join_table

        out = distributed_join_table(left, right, right_name, pairs, needed,
                                     mesh, kind)
    else:
        # CROSS stays on one device: hashing a constant key would land
        # every row on one shard anyway.
        want = None if needed is None else set(needed) | cond_names
        out = _materialize_join_local(
            _one_device(left, want), _one_device(right, want, right_name),
            right_name, pairs, needed, kind)
    if mesh is not None and not is_sharded(out):
        from ..parallel.sharded import _ensure_sharded

        out = _ensure_sharded(out, mesh)
    if cache_cap > 0:
        memo_put(left, "_join_memo", mkey, (out, right), cache_cap)
    return out


def _left_fill_stats(st, is_dict: bool, n_miss: int):
    """Stats of a build-side column under LEFT-join fill: numeric
    columns gain a NULL; dictionary columns extend their code range to
    the miss code -1."""
    if n_miss <= 0:
        return st
    if is_dict:
        return ColumnStats(min=-1.0, max=st.max, null_count=st.null_count)
    return ColumnStats(min=st.min, max=st.max, null_count=st.null_count + 1)


def _build_columns(rcols: dict, order, slot, matched) -> dict:
    """Build columns at sorted-build ``slot``s (one gather each through
    the sort permutation); rows where ``matched`` is False take the
    missing-value marker."""
    n = slot.shape[0]
    out = {}
    if order.numel() == 0:
        for name, c in rcols.items():
            out[name] = torch.full((n,), _fill_value(c.dtype), dtype=c.dtype,
                                   device=slot.device)
        return out
    bidx = order[slot.clamp(0, order.shape[0] - 1)]
    for name, c in rcols.items():
        v = c[bidx]
        if matched is not None:
            v = torch.where(matched, v, _fill_value(c.dtype))
        out[name] = v
    return out


def _joined_table(left, right, right_name, cols, rcols, num_rows,
                  padded_rows, n_miss=0) -> DeviceTable:
    """Output table: probe columns as given, build columns qualified
    (and unqualified where the name is free); dtypes and dicts as the
    reference sets them.  Stats carry through, since every joined value
    comes from its source column; LEFT fill adjusts the build side's."""
    new_cols = dict(cols)
    for name, arr in rcols.items():
        new_cols[f"{right_name}.{name}"] = arr
    for name in rcols:
        new_cols.setdefault(name, new_cols[f"{right_name}.{name}"])
    dtypes, dicts, stats = dict(left.dtypes), dict(left.dicts), dict(left.stats)
    for name, dt in right.dtypes.items():
        dtypes[f"{right_name}.{name}"] = dt
        dtypes.setdefault(name, dt)
    for name, vocab in right.dicts.items():
        dicts[f"{right_name}.{name}"] = vocab
        dicts.setdefault(name, vocab)
    for name, st in right.stats.items():
        st2 = _left_fill_stats(st, name in right.dicts, n_miss)
        stats[f"{right_name}.{name}"] = st2
        stats.setdefault(name, st2)
    return DeviceTable(new_cols, dtypes, num_rows, padded_rows, stats=stats,
                       dicts=dicts, device=left.device)


def _materialize_join_local(left, right, right_name: str, pairs,
                            needed: Optional[set],
                            kind: str = "inner") -> DeviceTable:
    """Single-program equi-join.  ``kind="left"`` keeps unmatched probe
    rows: they emit once, with the build columns filled NaN / -1."""
    note_operator(f"join_{kind}", True)
    lkeys, rkeys = _join_keys(left, right, right_name, pairs)
    n_left, n_right = left.num_rows, right.num_rows
    dev = left.device
    if not pairs:
        # CROSS JOIN: one all-zero key, every probe row matches every
        # build row.
        lkeys = [torch.zeros(n_left, dtype=torch.float32, device=dev)]
        rkeys = [torch.zeros(n_right, dtype=torch.float32, device=dev)]

    p1 = join_match_counts(lkeys, None, rkeys, None)
    counts = p1.counts
    # One host sync for every phase-1 scalar.
    if n_left:
        total, kmax, kmin, n_zero = torch.stack([
            p1.total, counts.max(), counts.min(), (counts == 0).sum(),
        ]).tolist()
    else:
        total, kmax, kmin, n_zero = 0, 0, 2**31 - 1, 0
    one2one = kmax <= 1
    n_miss = n_zero if kind == "left" else 0

    rcols_all = right.row_columns()
    lrows = left.row_columns()

    def _wanted(name: str) -> bool:
        return (needed is None or name in needed
                or f"{right_name}.{name}" in needed)

    rcols_in = {n: c for n, c in rcols_all.items() if _wanted(n)}

    if one2one and (kind == "left" or total == n_left):
        # Probe-preserving lookup: every probe row keeps its place and
        # its columns by reference; each build column is one gather.
        matched = counts > 0 if kind == "left" else None
        rtaken = _build_columns(rcols_in, p1.build_order, p1.lo, matched)
        return _joined_table(left, right, right_name, left.columns, rtaken,
                             n_left, left.padded_rows, n_miss)

    lnames = [n for n in left.columns if needed is None or n in needed]
    lo32 = p1.lo.clamp(0, max(n_right - 1, 0)).to(_I32)

    if one2one and kind == "inner":
        # Semicompact: unique build keys, some probe rows unmatched.  The
        # matched probe positions are nondecreasing, so K5 gathers every
        # needed probe column plus the build slot in one launch.
        pos = torch.nonzero(counts > 0).reshape(-1)
        taken = sorted_take([lrows[n] for n in lnames] + [lo32], pos)
        rtaken = _build_columns(rcols_in, p1.build_order, taken[-1].to(_I64),
                                None)
        return _joined_table(left, right, right_name,
                             dict(zip(lnames, taken[:-1])), rtaken, total,
                             total)

    total_emit = total + n_miss
    gather = [lrows[n] for n in lnames] + [lo32]
    matched = None
    if kind == "inner" and kmin == kmax and kmax >= 2:
        # Uniform fan-out k: output row r belongs to probe row r // k.
        k = int(kmax)
        taken = uniform_expand(gather, k, total)
        r = torch.arange(total, dtype=_I64, device=dev)
        slot = taken[len(lnames)].to(_I64) + r % k
    else:
        emit = counts.clamp(min=1) if kind == "left" else counts
        offsets = torch.cumsum(emit, 0) - emit
        if kind == "left":
            gather.append(counts.to(_I32))  # the true match counts
        _owner, dup, taken = windowed_expand(offsets, gather, total_emit)
        slot = taken[len(lnames)].to(_I64) + dup
        if kind == "left":
            matched = dup < taken[len(lnames) + 1]
    rtaken = _build_columns(rcols_in, p1.build_order, slot, matched)
    return _joined_table(left, right, right_name,
                         dict(zip(lnames, taken[:len(lnames)])), rtaken,
                         total_emit, total_emit, n_miss)


def _one_device(table, names: Optional[set], right_name: str = ""):
    """``table`` on one device: a sharded table takes the gather route
    for the columns ``names`` holds (bare, or qualified by the build
    side's ``right_name``), every column for None."""
    if not is_sharded(table):
        return table
    if names is None:
        return table.gather()
    return table.gather([c for c in table.columns
                         if c in names or f"{right_name}.{c}" in names])


def _append_build_misses(base, left, right, right_name: str,
                         pairs, left_names=None) -> DeviceTable:
    """RIGHT/FULL tail: build rows whose key matches no probe row (a
    swapped phase 1), appended after ``base`` in build order; probe-side
    columns take the missing-value marker.  ``left_names``: the probe's
    column names where ``left`` holds only its key columns."""
    if left_names is None:
        left_names = left.columns
    lkeys, rkeys = _join_keys(left, right, right_name, pairs)
    p1 = join_match_counts(rkeys, None, lkeys, None)
    miss_idx = torch.nonzero(p1.counts == 0).reshape(-1)
    n_miss = int(miss_idx.shape[0])
    if n_miss == 0:
        return base

    spec = []
    for name in base.columns:
        src = None
        if (name.startswith(right_name + ".")
                and name[len(right_name) + 1:] in right.columns):
            src = name[len(right_name) + 1:]
        elif name not in left_names and name in right.columns:
            src = name
        spec.append((name, src))

    brows, rrows = base.row_columns(), right.row_columns()
    new_cols, stats = {}, {}
    for name, src in spec:
        b = brows[name]
        if src is not None:
            tail = rrows[src][miss_idx]
        else:
            tail = torch.full((n_miss,), _fill_value(b.dtype), dtype=b.dtype,
                              device=b.device)
        new_cols[name] = torch.cat([b, tail])
        st = base.stats.get(name)
        if st is not None:
            stats[name] = (st if src is not None else
                           _left_fill_stats(st, name in base.dicts, n_miss))
    total = base.num_rows + n_miss
    return DeviceTable(new_cols, dict(base.dtypes), total, total,
                       stats=stats, dicts=dict(base.dicts),
                       device=base.device)


def _materialize_joins(query: Query, table, catalog: Optional[dict]):
    """The JOIN chain, left to right, with projection pushdown: a join's
    own condition columns count as needed only when a later join or a
    non-join clause reads them."""
    if not query.joins:
        return table
    catalog = catalog or {}
    base_needed = set()
    for node in [
        *query.select_list, query.where, query.having,
        *(t.expr for t in (query.order_by.terms if query.order_by else ())),
        *(query.group_by.keys if query.group_by else ()),
    ]:
        if node is None:
            continue
        for n in walk(node):
            if isinstance(n, Variable):
                base_needed.add(n.name)
                base_needed.add(n.unqualified)
    current = table
    for i, join in enumerate(query.joins):
        needed = set(base_needed)
        for later in query.joins[i + 1:]:
            if later.condition is None:
                continue
            for n in walk(later.condition):
                if isinstance(n, Variable):
                    needed.add(n.name)
                    needed.add(n.unqualified)
        right = catalog.get(join.table, table)
        current = _materialize_join(current, right, join.table,
                                    join.condition, needed,
                                    getattr(join, "kind", "inner"))
    return current


# ---------------------------------------------------------------------------
# Rewrites
# ---------------------------------------------------------------------------


class _EjaBail(Exception):
    """The eager-aggregation rewrite does not apply."""


def _try_eager_join_aggregate(query, table, catalog):
    """Aggregate pushdown through one inner join (reference
    ``_try_eager_join_aggregate``): ``SELECT AGG(e) FROM probe JOIN dim
    ON k = dim.k GROUP BY g``, where every aggregate factors across the
    join, becomes a per-key pre-aggregated build side plus a 1:1 join:
    ``SUM(p·b) → SUM(p · __eja_sum_b)``, ``SUM(p) → SUM(p · __eja_cnt)``,
    ``COUNT(e) → SUM(__eja_cnt)``, AVG from the two; MIN/MAX of probe
    expressions are kept, of bare build columns folded per key.  Returns
    ``(query', catalog')`` or None."""
    if not get_config().eager_join_aggregation:
        return None
    if query.group_by is None or len(query.joins) != 1:
        return None
    join = query.joins[0]
    if getattr(join, "kind", "inner") != "inner":
        return None
    catalog = catalog or {}
    right = catalog.get(join.table, table)

    # canonical() ignores aliases, but the rewritten query carries output
    # names, so the aliases are part of the key.
    sel_names = tuple(
        s.name if isinstance(s, Alias) else None for s in query.select_list
    )
    mkey = (query.canonical(), sel_names, _table_uid(right),
            mesh_width(table))
    hit = memo_get(table, "_eja_memo", mkey)
    if hit is not None:
        q2, dim2, _right_ref = hit
        catalog2 = dict(catalog)
        catalog2[join.table] = dim2
        return q2, catalog2
    try:
        pairs = _equality_pairs(join.condition)
    except UnsupportedError:
        return None
    if len(pairs) != 1:
        return None
    try:
        _lv, right_var = _resolve_join_sides(table, right, join.table,
                                             pairs)[0]
    except ValidationError:
        return None
    key_name = (right_var.name if right_var.name in right.columns
                else right_var.unqualified)

    def is_build(var: Variable) -> bool:
        if var.qualifier == join.table and (
            var.unqualified in right.columns or var.name in right.columns
        ):
            return True
        if var.name in table.columns or var.unqualified in table.columns:
            return False
        return var.name in right.columns or var.unqualified in right.columns

    def probe_only(node) -> bool:
        return all(
            not (isinstance(n, Variable) and is_build(n)) for n in walk(node)
        )

    for k in query.group_by.keys:
        if not probe_only(k):
            return None
    if query.where is not None and not probe_only(query.where):
        return None

    CNT = "__eja_cnt"
    partials: dict = {}  # alias -> ("count"|"sum"|"min"|"max", column)

    def build_col_of(node):
        node = unalias(node)
        if isinstance(node, Variable) and is_build(node):
            return node
        return None

    def sum_rewrite(e):
        if probe_only(e):
            partials[CNT] = ("count", None)
            return Aggregation(AggregationType.SUM,
                               BinaryOp("*", e, Variable(CNT)))
        b = build_col_of(e)
        if b is not None:
            alias = f"__eja_sum_{b.unqualified}"
            partials[alias] = ("sum", b.unqualified)
            return Aggregation(AggregationType.SUM, Variable(alias))
        if isinstance(e, BinaryOp) and e.op == "*":
            bl, br = build_col_of(e.left), build_col_of(e.right)
            if bl is not None and probe_only(e.right):
                p, b = e.right, bl
            elif br is not None and probe_only(e.left):
                p, b = e.left, br
            else:
                raise _EjaBail
            alias = f"__eja_sum_{b.unqualified}"
            partials[alias] = ("sum", b.unqualified)
            return Aggregation(AggregationType.SUM,
                               BinaryOp("*", p, Variable(alias)))
        raise _EjaBail

    def rewrite_agg(n: Aggregation):
        if n.agg is AggregationType.COUNT:
            partials[CNT] = ("count", None)
            return Aggregation(AggregationType.SUM, Variable(CNT))
        if n.agg is AggregationType.SUM:
            return sum_rewrite(n.expr)
        if n.agg is AggregationType.AVG:
            s = sum_rewrite(n.expr)
            partials[CNT] = ("count", None)
            return BinaryOp("/", s,
                            Aggregation(AggregationType.SUM, Variable(CNT)))
        if n.agg in (AggregationType.MIN, AggregationType.MAX):
            if probe_only(n.expr):
                return n  # duplicate-invariant
            b = build_col_of(n.expr)
            if b is None:
                raise _EjaBail
            tag = "min" if n.agg is AggregationType.MIN else "max"
            alias = f"__eja_{tag}_{b.unqualified}"
            partials[alias] = (tag, b.unqualified)
            return Aggregation(n.agg, Variable(alias))
        raise _EjaBail  # COUNT(DISTINCT) / MEDIAN do not merge

    def rw(node):
        if node is None:
            return None
        if isinstance(node, Alias):
            return Alias(rw(node.expr), node.name)
        if isinstance(node, Aggregation):
            return rewrite_agg(node)
        if isinstance(node, BinaryOp):
            return BinaryOp(node.op, rw(node.left), rw(node.right))
        if isinstance(node, CaseWhen):
            return CaseWhen(
                tuple(rw(c) for c in node.conditions),
                tuple(rw(v) for v in node.values),
                rw(node.default),
            )
        if isinstance(node, FunctionCall):
            return FunctionCall(node.name, tuple(rw(a) for a in node.args))
        if isinstance(node, Variable) and is_build(node):
            raise _EjaBail  # a bare build reference outside an aggregate
        return node

    def rw_select(s):
        # A rewritten item keeps its original display name.
        r = rw(s)
        if isinstance(s, Alias) or r.canonical() == s.canonical():
            return r
        name = s.canonical()
        if name.endswith("[idx]"):
            name = name[: -len("[idx]")]
        return Alias(r, name)

    try:
        new_select = [rw_select(s) for s in query.select_list]
        new_having = rw(query.having)
        new_order = None
        if query.order_by is not None:
            new_order = OrderBy(
                rw(query.order_by.expr),
                query.order_by.ascending,
                tuple(OrderBy(rw(t.expr), t.ascending)
                      for t in query.order_by.then),
            )
    except _EjaBail:
        return None
    if not partials:
        return None
    if any(a in table.columns for a in partials):
        return None  # a name collision with probe columns

    # Pre-aggregate the build side per join key, every partial from one
    # grouping pass.
    q_dim = Query()
    q_dim.from_table = join.table
    q_dim.group_by = GroupBy((Variable(key_name),))
    sel = [Alias(Variable(key_name), key_name)]
    agg_of = {
        "count": AggregationType.COUNT,
        "sum": AggregationType.SUM,
        "min": AggregationType.MIN,
        "max": AggregationType.MAX,
    }
    for alias, (tag, col) in partials.items():
        expr = Constant("1") if col is None else Variable(col)
        sel.append(Alias(Aggregation(agg_of[tag], expr), alias))
    q_dim.select_list = sel

    from .group_exec import run_grouped_columns

    out = run_grouped_columns(q_dim, right)
    arrays, dtypes = {}, {}
    # The key stays exact (the reference passes it through f32, which
    # rounds integer keys beyond 2^24).
    key_vals = np.asarray(out[key_name])
    key_dt = right.dtypes.get(key_name)
    if key_name in right.dicts:
        from ..storage.strings import decode_codes

        arrays[key_name] = np.asarray(
            decode_codes(key_vals, right.dicts[key_name]), dtype=object
        )
        dtypes[key_name] = key_dt
    elif key_dt is not None and key_dt.np_dtype is not None:
        arrays[key_name] = key_vals.astype(key_dt.np_dtype)
        dtypes[key_name] = key_dt
    else:
        arrays[key_name] = key_vals.astype(np.float32)
    for alias in partials:
        arrays[alias] = np.asarray(out[alias], np.float32)
    dim2 = DeviceTable.from_host(
        HostTable.from_dict(arrays, dtypes=dtypes or None), device=right.device
    )

    q2 = copy.copy(query)
    q2.select_list = new_select
    q2.having = new_having
    q2.order_by = new_order
    memo_put(table, "_eja_memo", mkey, (q2, dim2, right), 4)
    catalog2 = dict(catalog)
    catalog2[join.table] = dim2
    return q2, catalog2


def _split_join_residuals(query: Query) -> Query:
    """Theta joins: non-equality conjuncts of an INNER JOIN's ON move to
    WHERE (ON ≡ WHERE for INNER); an ON with no equality at all becomes
    CROSS JOIN + filter.  Outer joins keep the equality-only contract."""

    def is_eq(c):
        return (
            isinstance(c, BinaryOp)
            and c.op in ("=", "==")
            and isinstance(c.left, Variable)
            and isinstance(c.right, Variable)
        )

    new_joins = []
    residuals: list = []
    changed = False
    for j in query.joins:
        if j.condition is None:
            new_joins.append(j)
            continue
        parts = _and_conjuncts(j.condition)
        eq = [c for c in parts if is_eq(c)]
        res = [c for c in parts if not is_eq(c)]
        if not res:
            new_joins.append(j)
            continue
        if j.kind not in ("inner", "cross"):
            raise UnsupportedError(
                f"Non-equality {j.kind.upper()} JOIN conditions are not "
                "supported (outer-join ON decides matching; rewrite the "
                "residual predicate as WHERE if INNER semantics are "
                "intended)"
            )
        changed = True
        residuals.extend(res)
        if eq:
            new_joins.append(dataclasses.replace(j, condition=_and_chain(eq),
                                                 kind="inner"))
        else:
            new_joins.append(dataclasses.replace(j, condition=None,
                                                 kind="cross"))
    if not changed:
        return query
    q2 = copy.copy(query)
    q2.joins = new_joins
    where = query.where
    for r in residuals:
        where = r if where is None else BinaryOp("&&", where, r)
    q2.where = where
    return q2


def _lift_implicit_join_conditions(query: Query, table,
                                   catalog: Optional[dict]) -> Query:
    """SQL-89 implicit joins: ``FROM a, b WHERE a.k = b.k`` parses as
    CROSS JOIN + WHERE; each WHERE equality linking a relation to the
    chain before it moves into that join's ON.  Ambiguous conjuncts stay
    in WHERE."""
    if query.where is None or not any(
        j.kind == "cross" and j.condition is None for j in query.joins
    ):
        return query
    catalog = catalog or {}
    parts = _and_conjuncts(query.where)
    used = [False] * len(parts)
    left_cols = set(table.columns)
    left_quals = {query.from_table}
    new_joins = []
    any_lifted = False
    for j in query.joins:
        right = catalog.get(j.table, table)
        rcols = set(right.columns)
        if j.kind != "cross" or j.condition is not None:
            new_joins.append(j)
            left_cols |= rcols
            left_quals.add(j.table)
            continue

        def side_of(v, rcols=rcols, jt=j.table):
            if v.qualifier is not None:
                if v.qualifier == jt:
                    return "right"
                if v.qualifier in left_quals:
                    return "left"
                return None
            in_r, in_l = v.name in rcols, v.name in left_cols
            if in_r and not in_l:
                return "right"
            if in_l and not in_r:
                return "left"
            return None  # ambiguous or unknown

        picked = []
        for i, c in enumerate(parts):
            if used[i]:
                continue
            if (
                isinstance(c, BinaryOp)
                and c.op in ("==", "=")
                and isinstance(c.left, Variable)
                and isinstance(c.right, Variable)
                and {side_of(c.left), side_of(c.right)} == {"left", "right"}
            ):
                picked.append(c)
                used[i] = True
        if picked:
            new_joins.append(Join(j.table, _and_chain(picked), kind="inner",
                                  source=j.source))
            any_lifted = True
        else:
            new_joins.append(j)
        left_cols |= rcols
        left_quals.add(j.table)
    if not any_lifted:
        return query
    q2 = copy.copy(query)
    q2.joins = new_joins
    q2.where = _and_chain([c for i, c in enumerate(parts) if not used[i]])
    return q2


def _where_rows(table, where) -> torch.Tensor:
    """Row mask of ``where`` (string literals already bound)."""
    return broadcast(_as_bool(build_evaluator(where)(table.row_columns())),
                     table.num_rows)


def _build_prefilter_count(table, where) -> int:
    """Rows of ``table`` matching ``where``, memoised per table."""
    return _cached_count(
        table,
        ("where_count", where.canonical(), udf_mod.registry_version()),
        lambda: int(_where_rows(table, where).sum()),
    )


# The WHERE pushdown below joins compacts a table only when the filter
# keeps at most this share of its rows (the compaction would cost more
# than it saves above), and the probe side only from this many rows on
# (its count, positions, K5 gather and new table each wait on the card).
# Pushdown on against off, engine wall, NVIDIA H100 80GB HBM3, 700.00 W,
# ``chip_smoke.py --tiers``: on e2e_join_filtered's lookup against 32
# rates, at 2^25 rows 5.98 against 7.82 ms at 50% and 7.23 against 7.71
# at 75%, where it lost in two runs of three (the reference's 50%
# stays); it won from 2^24 rows at 1% and 10% (4.27 against 4.63 ms,
# 4.25 against 4.86) and lost below.  On join_dimk_sum's expanding join
# it won from 2^24 rows at 1, 10 and 50% (5.27 against 6.05, 4.60
# against 6.03, 4.98 against 6.71 ms) and lost at 2^22 (4.03 against
# 3.21 ms at 1%).  TPC-H's 2^22-row probes ran faster without it in
# each of the seven queries whose plan a 4096-row floor changed (q7
# 25.02 against 33.15 ms, q20 82.09 against 92.27).  So the floor is
# 2^24 rows.
PUSHDOWN_MAX_SHARE = 0.5
PUSHDOWN_MIN_ROWS = 1 << 24


def _filtered_table_for(table, where, base_cols):
    """``table`` compacted to the rows matching ``where``, or None when
    the filter keeps more than ``PUSHDOWN_MAX_SHARE`` of them.  The
    matching positions come from ``nonzero`` (ascending, so row order is
    kept) and K5 gathers every kept column at them in one launch.
    Memoised per table instance."""
    n_match = _build_prefilter_count(table, where)
    if n_match > PUSHDOWN_MAX_SHARE * table.num_rows:
        return None
    mkey = (where.canonical(), tuple(base_cols), udf_mod.registry_version())
    filtered = memo_get(table, "_prefilter_memo", mkey)
    if filtered is None:
        pos = torch.nonzero(_where_rows(table, where)).reshape(-1)
        rows = table.row_columns()
        taken = sorted_take([rows[c] for c in base_cols], pos)
        filtered = DeviceTable(
            dict(zip(base_cols, taken)),
            {c: table.dtypes[c] for c in base_cols if c in table.dtypes},
            n_match,
            n_match,
            # Parent stats bound any row subset.
            stats={c: table.stats[c] for c in base_cols if c in table.stats},
            dicts={c: table.dicts[c] for c in base_cols if c in table.dicts},
            device=table.device,
        )
        memo_put(table, "_prefilter_memo", mkey, filtered, 16)
    return filtered


def _pushdown_join_where(query: Query, table, catalog: Optional[dict]):
    """Probe-side WHERE pushdown: conjuncts that read only probe columns
    compact the probe before the joins (INNER/LEFT/CROSS chains, probe of
    at least ``PUSHDOWN_MIN_ROWS`` rows, selectivity at most
    ``PUSHDOWN_MAX_SHARE``); the rest stays in WHERE.
    Returns ``(query', probe')``."""
    where = query.where
    if where is None or not query.joins:
        return query, table
    if not get_config().join_filter_pushdown:
        return query, table
    if table.num_rows < PUSHDOWN_MIN_ROWS:
        return query, table
    for j in query.joins:
        if j.kind not in ("inner", "left", "cross"):
            return query, table
        # A self-join's build side is the probe table, which must stay
        # unfiltered.
        if (catalog or {}).get(j.table, table) is table:
            return query, table
    from .executor import bind_strings

    def _probe_only(c) -> bool:
        for n in walk(c):
            if isinstance(n, Variable):
                if n.qualifier is not None or n.name not in table.columns:
                    return False
            if isinstance(n, (Aggregation, Star)):
                return False
        return True

    push, residual = [], []
    for c in _and_conjuncts(where):
        (push if _probe_only(c) else residual).append(c)
    if not push:
        return query, table
    where = bind_strings(_and_chain(push), table)

    # Probe columns the rest of the query and the join conditions read.
    needed: set = set()
    star = False
    nodes = [
        *query.select_list,
        query.having,
        *(t.expr for t in (query.order_by.terms if query.order_by else ())),
        *(query.group_by.keys if query.group_by else ()),
        *(j.condition for j in query.joins if j.condition is not None),
        *residual,
    ]
    for node in nodes:
        if node is None:
            continue
        for n in walk(node):
            if isinstance(n, Variable):
                needed.add(n.name)
                needed.add(n.unqualified)
            elif isinstance(n, Star):
                star = True
    base_cols = [
        c for c in table.columns if star or c in needed
    ] or list(table.columns)[:1]

    filtered = _filtered_table_for(table, where, base_cols)
    if filtered is None:
        return query, table
    q2 = copy.copy(query)
    q2.where = _and_chain(residual) if residual else None
    return q2, filtered


def _classify_build_conjuncts(query: Query, table, catalog: Optional[dict]):
    """Split the WHERE conjuncts by the single INNER/CROSS-joined relation
    each reads: ``(by_relation, rest, pushable_tables, implied)``, where
    ``implied`` holds, per relation, the disjunction an OR conjunct
    implies on it (every branch restricting that relation)."""
    pushable: dict = {}
    kinds = {j.table: j.kind for j in query.joins}
    for j in query.joins:
        t = (catalog or {}).get(j.table)
        if (j.kind in ("inner", "cross") and t is not None and t is not table
                and t.num_rows >= 2):
            pushable[j.table] = t

    parts = _and_conjuncts(query.where) if query.where is not None else []
    if not pushable:
        return {}, parts, pushable, {}

    # Unqualified names resolve probe-first, then in join order: a name
    # is pushable only when exactly one relation owns it.
    owner: dict = {c: "__probe__" for c in table.columns}
    for j in query.joins:
        t = (catalog or {}).get(j.table, table)
        for c in t.columns:
            owner[c] = j.table if c not in owner else "__ambiguous__"

    probe_names = {query.from_table}
    if getattr(query, "from_source", None) is not None:
        probe_names.add(query.from_source)

    def conjunct_relation(c) -> Optional[str]:
        rel = None
        for n in walk(c):
            if isinstance(n, (Aggregation, Star)):
                return None
            if not isinstance(n, Variable):
                continue
            if n.qualifier is not None:
                if n.qualifier in probe_names:
                    return None
                r = n.qualifier if n.qualifier in pushable else None
            else:
                o = owner.get(n.name)
                r = o if o in pushable else None
            if r is None:
                return None
            if n.unqualified not in pushable[r].columns:
                return None
            if rel is not None and rel != r:
                return None
            rel = r
        return rel

    by_rel: dict = {}
    rest = []
    for c in parts:
        r = conjunct_relation(c)
        if r is not None and kinds.get(r) in ("inner", "cross"):
            by_rel.setdefault(r, []).append(c)
        else:
            rest.append(c)

    def _or_branches(c) -> list:
        if isinstance(c, BinaryOp) and c.op == "||":
            return _or_branches(c.left) + _or_branches(c.right)
        return [c]

    implied: dict = {}
    for c in rest:
        branches = _or_branches(c)
        if len(branches) < 2:
            continue
        per_branch = [_and_conjuncts(b) for b in branches]
        for r in pushable:
            if kinds.get(r) not in ("inner", "cross"):
                continue
            sels = []
            for bc in per_branch:
                rs = [x for x in bc if conjunct_relation(x) == r]
                if not rs:
                    sels = None
                    break
                sels.append(_and_chain(rs))
            if sels:
                disj = sels[0]
                for s in sels[1:]:
                    disj = BinaryOp("||", disj, s)
                implied.setdefault(r, []).append(disj)
    return by_rel, rest, pushable, implied


def _pushdown_build_filters(query: Query, table, catalog: Optional[dict]):
    """Build-side WHERE pushdown: conjuncts reading exactly one INNER/
    CROSS-joined relation (plus OR-implied restrictions, which also stay
    in WHERE) filter that relation before the join.  Returns
    ``(query', catalog')``."""
    if query.where is None or not query.joins:
        return query, catalog
    if not get_config().join_filter_pushdown:
        return query, catalog
    from .executor import bind_strings

    by_rel, rest, pushable, implied = _classify_build_conjuncts(
        query, table, catalog
    )
    if not by_rel and not implied:
        return query, catalog
    catalog2 = dict(catalog or {})
    changed = False
    for rname in sorted({*by_rel, *implied}):
        conjs = by_rel.get(rname, [])
        cond = _and_chain([*conjs, *implied.get(rname, [])])
        dim = pushable[rname]
        filtered = _filtered_table_for(dim, bind_strings(cond, dim),
                                       list(dim.columns))
        if filtered is None:
            rest.extend(conjs)  # too little filtered: keep it post-join
            continue
        catalog2[rname] = filtered
        changed = True
    if not changed:
        return query, catalog
    q2 = copy.copy(query)
    q2.where = _and_chain(rest)
    return q2, catalog2
