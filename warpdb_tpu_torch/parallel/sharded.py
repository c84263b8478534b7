"""Sharded tables and the sharded scan, top-k and GROUP BY.

Counterpart of ``warpdb_tpu/parallel/sharded.py``.  A
:class:`ShardedTable` holds contiguous row ranges, one
:class:`DeviceTable` a shard on that shard's device, plus the global
``num_rows``, stats, vocabularies and host mirror: shard-major order is
global row order.  The ranges need not be equal (the reference pads to
equal, lane-aligned shards, a TPU constraint).  Every shard carries the
GLOBAL stats and vocabularies, so stats-gated plans agree across shards
and codes compare everywhere.

Each operator runs its local phase shard by shard on the shard's device
and exchanges through ``mesh.comm`` (``comm.py``):

* ``run_expression_sharded``: fused filter + projection per shard, the
  pieces gathered in row order;
* ``run_topk_sharded``: ORDER BY … LIMIT: each shard's top-k (kernel K1),
  an ``all_gather`` of k candidates a shard, validity from the per-shard
  match counts (never ``isfinite``, which would drop real infinities),
  and a sort of the k·n candidates;
* ``run_grouped_sharded``: GROUP BY with the all_gather merge: each
  shard's partial group table (the single-device ladder's slot tier for
  one bounded key, decided once for the whole table: K2 where it takes
  the midrange tier; the sorted tier otherwise), gathered and
  re-aggregated, sums in float64.

Projections, global aggregates, DISTINCT and the per-group distinct
statistics run on every shard too (``project.py``).  An operator that
needs a global order (a full window ORDER BY, MEDIAN, STRING_AGG, the
outer joins' tails) gathers onto the mesh's root device and runs the
single-device operator there (:meth:`ShardedTable.gather`, where the
reference relies on GSPMD), moving only the columns it reads, after
each shard has dropped the rows its WHERE rejects.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple, Optional

import torch

from ..errors import ExecutionError
from ..frontend.ast import Node, Variable, WindowFunction, walk
from ..ops.aggregate import (
    group_scatter_stage,
    group_sort_stage,
    slot_group_aggregate,
    sorted_first_flags,
)
from ..ops.sort import lexsort, sort_key_any, sort_values, top_k_values
from ..storage.table import DeviceTable, HostTable
from ..utils.metrics import note_operator
from .mesh import DataMesh, data_mesh

__all__ = [
    "ShardedTable",
    "GroupPartials",
    "shard_table",
    "local_table",
    "is_sharded",
    "node_columns",
    "run_expression_sharded",
    "run_topk_sharded",
    "run_grouped_sharded",
]

_F64 = torch.float64
_INF = float("inf")


class _ColumnNames(Mapping):
    """A sharded table's column NAMES: membership and iteration work as
    a DeviceTable's ``columns``; reading a column raises, since the data
    lives on the shards."""

    def __init__(self, names):
        self._names = dict.fromkeys(names)

    def __contains__(self, name) -> bool:
        return name in self._names

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __getitem__(self, name):
        raise ExecutionError(
            f"column {name!r} of a sharded table lives on its shards: the "
            "operator must take a distributed route or gather()"
        )


class ShardedTable:
    """A table row-sharded over ``mesh``: ``shards`` are this process's
    shards (every shard in one process; the rank's own in a job), in
    mesh order; ``shard_rows`` the row count of every shard of the
    mesh.  Metadata (``dtypes``, ``stats``, ``dicts``, ``num_rows``) is
    global.  ``columns`` names the columns but holds no data: an
    operator either takes a distributed route over ``shards`` or calls
    :meth:`gather`."""

    def __init__(self, shards: list, mesh: DataMesh, shard_rows: list,
                 dtypes: dict, stats: dict, dicts: dict,
                 host: Optional[HostTable] = None):
        self.shards = shards
        self.mesh = mesh
        self.shard_rows = list(shard_rows)
        self.num_rows = int(sum(self.shard_rows))
        self.padded_rows = self.num_rows
        self.dtypes = dtypes
        self.stats = stats
        self.dicts = dicts
        self.host = host
        self.columns = _ColumnNames(shards[0].columns)

    @property
    def device(self) -> torch.device:
        return self.mesh.root

    def gather(self, columns=None, where: Optional[Node] = None
               ) -> DeviceTable:
        """The gather route: the shards' columns concatenated, in row
        order, into one DeviceTable on the mesh's root device (one
        ``all_gather``), for an operator with no distributed route.
        ``columns`` (names) keeps only those; ``where`` (a bound
        condition) drops on each shard the rows it rejects before
        anything moves.  Stats stay the global ones (bounds of any
        subset); a pruned or filtered table has no host mirror."""
        from ..engine.group_exec import _row_mask

        note_operator("mesh_gather", True)
        first = self.shards[0].columns
        keep = None if columns is None else set(columns)
        names = [n for n in first if keep is None or n in keep]
        # Joined tables name one tensor twice (bare and qualified):
        # gather it once.
        uniq: dict = {}
        for name in names:
            uniq.setdefault(id(first[name]), name)
        src = list(uniq.values())
        parts, kept = [], []
        for s in self.shards:
            rows = s.row_columns()
            cols = tuple(rows[n] for n in src)
            if where is not None:
                mask = _row_mask(where, s, rows)
                cols = tuple(c[mask] for c in cols)
                kept.append(int(mask.sum()))
            parts.append(cols)
        cat = []
        if src:
            got = self.mesh.comm.all_gather(parts)
            cat = [torch.cat([g[i] for g in got]) for i in range(len(src))]
            num_rows = int(cat[0].shape[0])
        elif where is not None:
            num_rows = sum(self.mesh.comm.gather_ints(kept))
        else:
            num_rows = self.num_rows
        by_src = dict(zip(src, cat))
        cols = {n: by_src[uniq[id(first[n])]] for n in names}
        whole = keep is None and where is None
        return DeviceTable(cols, {n: self.dtypes[n] for n in names},
                           num_rows, num_rows,
                           stats={n: st for n, st in self.stats.items()
                                  if n in cols},
                           host=self.host if whole else None,
                           dicts={n: d for n, d in self.dicts.items()
                                  if n in cols},
                           device=self.mesh.root)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{t.value}" for n, t in self.dtypes.items())
        return (f"ShardedTable({self.num_rows} rows over {self.mesh}, shard "
                f"rows {self.shard_rows}; {cols})")


def is_sharded(table) -> bool:
    return isinstance(table, ShardedTable)


def node_columns(table, nodes) -> list:
    """The columns of ``table`` that the expressions ``nodes`` read (a
    bare or a qualified name), in the table's order; a window's every
    ORDER BY term counts."""
    names: set = set()

    def visit(node) -> None:
        for n in walk(node):
            if isinstance(n, Variable):
                names.update((n.name, n.unqualified))
            elif isinstance(n, WindowFunction) and n.order_by is not None:
                for t in n.order_by.terms[1:]:
                    visit(t.expr)

    for root in nodes:
        if root is not None:
            visit(root)
    return [c for c in table.columns if c in names]


def local_table(table):
    """``table`` on one device: a sharded table takes the gather route."""
    return table.gather() if isinstance(table, ShardedTable) else table


def _copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of ``t`` with storage of its own on ``device``."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def split_table(table: DeviceTable, mesh: DataMesh,
                host: Optional[HostTable] = None) -> ShardedTable:
    """Cut a one-device table into ``mesh.size`` contiguous row ranges,
    each copied to its shard's device."""
    n, size = table.num_rows, mesh.size
    bounds = [n * i // size for i in range(size + 1)]
    shards = []
    for i in mesh.local_shards:
        a, b, dev = bounds[i], bounds[i + 1], mesh.devices[i]
        copies: dict = {}
        cols = {}
        for name, c in table.columns.items():
            if id(c) not in copies:
                copies[id(c)] = _copy_to(c[a:b], dev)
            cols[name] = copies[id(c)]
        shards.append(DeviceTable(cols, dict(table.dtypes), b - a, b - a,
                                  stats=dict(table.stats),
                                  dicts=dict(table.dicts), device=dev))
    return ShardedTable(shards, mesh,
                        [bounds[i + 1] - bounds[i] for i in range(size)],
                        dict(table.dtypes), dict(table.stats),
                        dict(table.dicts),
                        host if host is not None else table.host)


def shard_table(host: HostTable, mesh: Optional[DataMesh] = None,
                dicts_override: Optional[dict] = None):
    """Upload ``host`` row-sharded over ``mesh`` (default: every CUDA
    device).  ``dicts_override`` encodes string columns against supplied
    vocabularies (a stream's chunks).  On a one-device mesh this is a
    plain :class:`DeviceTable`, and queries run the single-device path."""
    if mesh is None:
        mesh = data_mesh()
    dt = DeviceTable.from_host(host, device=mesh.devices[0],
                               dicts_override=dicts_override)
    return dt if mesh.single_device else split_table(dt, mesh, host)


def _ensure_sharded(table, mesh: DataMesh):
    """``table`` sharded over ``mesh``: as it is when it already is,
    else re-laid (a one-device table split; a table of another mesh
    gathered and split).  Memoised per table instance (tables are
    immutable)."""
    from ..engine.compiler import memo_get, memo_put

    if isinstance(table, ShardedTable) and table.mesh == mesh:
        return table
    if mesh.single_device:
        return local_table(table)
    hit = memo_get(table, "_shard_memo", mesh.key)
    if hit is None:
        hit = memo_put(table, "_shard_memo", mesh.key,
                       split_table(local_table(table), mesh), 2)
    return hit


def _mesh_of(table, mesh: Optional[DataMesh]) -> DataMesh:
    if mesh is not None:
        return mesh
    if isinstance(table, ShardedTable):
        return table.mesh
    return data_mesh()


# ---------------------------------------------------------------------------
# Scan and top-k
# ---------------------------------------------------------------------------


def run_expression_sharded(table, expr: Node, cond: Optional[Node],
                           mesh: Optional[DataMesh] = None,
                           device_out: bool = False):
    """Fused filter + projection over a row-sharded table (a one-device
    table is re-laid over ``mesh`` first; a one-device mesh runs the
    single-device path).  Results concatenate in row order; with
    ``device_out`` the tensor stays on the root device, unsynchronised
    (the stream copies it out itself)."""
    from ..engine.executor import run_expression_device

    mesh = _mesh_of(table, mesh)
    if mesh.single_device:
        out = run_expression_device(local_table(table), expr, cond)
    else:
        table = _ensure_sharded(table, mesh)
        note_operator("sharded_filter_project", True)
        parts = [(run_expression_device(s, expr, cond),)
                 for s in table.shards]
        out = torch.cat([g[0] for g in mesh.comm.all_gather(parts)])
    return out if device_out else out.cpu().numpy()


def run_topk_sharded(select_expr: Node, cond: Optional[Node], table, k: int,
                     ascending: bool, mesh: Optional[DataMesh] = None):
    """Distributed ORDER BY … LIMIT k: ``(first k values, rows matching
    the filter)``.  Each shard pulls its local top-k (kernel K1 for
    1 < k <= 128), k candidates a shard cross the mesh, and one sort of
    the k·n candidates finishes: no global sort.  Rows past the match
    count are ±inf."""
    from ..engine.compiler import raw_int_item
    from ..engine.executor import _row_values
    from ..engine.group_exec import _row_mask

    mesh = _mesh_of(table, mesh)
    table = _ensure_sharded(table, mesh)
    note_operator("sharded_topk", True)
    parts = []
    for s in table.shards:
        vals = _row_values(select_expr, s, raw_int_item(select_expr, s))
        valid = _row_mask(cond, s, s.row_columns())
        n_match = valid.sum()
        local = top_k_values(vals, valid, k, ascending)
        parts.append((local, n_match.reshape(1).to(torch.int64)))
    cand = torch.cat([g[0] for g in mesh.comm.all_gather(
        [(p[0],) for p in parts])])
    counts = torch.cat([g[0] for g in mesh.comm.all_gather(
        [(p[1],) for p in parts])])
    slot = torch.arange(k, device=cand.device)
    mask = (slot[None, :] < torch.clamp(counts, max=k)[:, None]).reshape(-1)
    top = sort_values(cand, mask, ascending)[:k]
    total = int(counts.sum())
    fill = _INF if ascending else -_INF
    top = torch.where(torch.arange(k, device=top.device) < total, top,
                      torch.full_like(top, fill))
    return top.cpu().numpy(), total


# ---------------------------------------------------------------------------
# GROUP BY partials
# ---------------------------------------------------------------------------


class GroupPartials(NamedTuple):
    """A compacted group table: one row per key tuple.  ``counts`` int64,
    ``sums`` float64 (partials merge in float64), ``mins`` / ``maxs``
    f32; keys keep their evaluated type (raw int32 for a bare integer
    column, f32 otherwise)."""

    keys: tuple
    counts: torch.Tensor
    sums: tuple
    mins: tuple
    maxs: tuple

    @property
    def num_groups(self) -> int:
        return int(self.counts.shape[0])

    def flat(self) -> tuple:
        return (*self.keys, self.counts, *self.sums, *self.mins, *self.maxs)

    @classmethod
    def unflat(cls, cols, nk: int, nv: int) -> "GroupPartials":
        cols = tuple(cols)
        return cls(cols[:nk], cols[nk], cols[nk + 1:nk + 1 + nv],
                   cols[nk + 1 + nv:nk + 1 + 2 * nv],
                   cols[nk + 1 + 2 * nv:nk + 1 + 3 * nv])

    @classmethod
    def concat(cls, parts: list) -> "GroupPartials":
        return cls(*(
            tuple(torch.cat(cs) for cs in zip(*(getattr(p, f) for p in parts)))
            if f != "counts" else torch.cat([p.counts for p in parts])
            for f in cls._fields
        ))

    def to_host(self):
        """``(keys, counts, ((sum, min, max), ...))`` as NumPy, sums f32
        as the single-device group table has them."""
        keys = tuple(k.cpu().numpy() for k in self.keys)
        values = tuple(
            (s.to(torch.float32).cpu().numpy(), mn.cpu().numpy(),
             mx.cpu().numpy())
            for s, mn, mx in zip(self.sums, self.mins, self.maxs))
        return keys, self.counts.cpu().numpy(), values


def key_eval_fns(key_exprs, table) -> list:
    """Per-key evaluators (reference ``_key_eval_fns``): a bare INT
    column keys raw (int32, exact beyond 2^24), anything else in f32.
    Hashes and groups agree with the reference's because the key types
    do."""
    from ..engine.compiler import _as_f32, build_evaluator, raw_int_item

    fns = []
    for k in key_exprs:
        r = raw_int_item(k, table)
        if r is not None:
            fns.append(r[0])
        else:
            inner = build_evaluator(k)
            fns.append(lambda cols, _f=inner: _as_f32(_f(cols)))
    return fns


def _partials_of(res, idx, key_cols) -> GroupPartials:
    """The occupied rows ``idx`` of an ops-level GroupResult."""
    return GroupPartials(
        tuple(key_cols), res.counts[idx].to(torch.int64),
        tuple(v.sums[idx].to(_F64) for v in res.values),
        tuple(v.mins[idx].to(torch.float32) for v in res.values),
        tuple(v.maxs[idx].to(torch.float32) for v in res.values))


def slot_plan(table, key_exprs, need):
    """The single-device ladder's slot tier for one key (``slot_tier``:
    dense, or midrange with kernel K2 when only sums are wanted),
    decided once on the whole sharded table (global stats, rows and key
    integrality) so that every shard and rank takes the same tier; None
    for the sorted tier (composite or unbounded keys)."""
    from ..engine.group_exec import slot_tier

    if len(key_exprs) != 1:
        return None
    return slot_tier(table, list(key_exprs), need)


def rows_partials(keys: tuple, vals: tuple, mask, need,
                  tier=None) -> GroupPartials:
    """The group table of evaluated rows (``mask``: the rows that count,
    None for all), keys ascending: the slot table of ``tier``
    (``slot_plan``) or the sorted tier.  The scatter tiers add the
    values in float64; K2 takes them in f32 and adds its blocks in
    float64 itself, so partials stay within the float64 merge's
    tolerance either way."""
    if mask is None:
        mask = torch.ones(keys[0].shape[0], dtype=torch.bool,
                          device=keys[0].device)
    if tier is not None:
        kp, _name, use_k2 = tier
        res = slot_group_aggregate(
            keys[0], vals if use_k2 else tuple(v.to(_F64) for v in vals),
            mask, kp["base"], kp["num_slots"], need, use_k2)
        idx = torch.nonzero(res.counts > 0).reshape(-1)
        return _partials_of(res, idx, (res.keys[0][idx],))
    stage = group_sort_stage(keys, tuple(v.to(_F64) for v in vals), mask)
    ng = int(stage[4])
    res = group_scatter_stage(*stage, ng, need)
    return _partials_of(res, slice(None), res.keys)


def local_partials(shard: DeviceTable, key_exprs, value_exprs, cond, need,
                   tier) -> GroupPartials:
    """One shard's partial group table under ``tier`` (``slot_plan`` of
    the sharded table)."""
    from ..engine.compiler import _as_f32, broadcast, build_evaluator
    from ..engine.group_exec import _row_mask

    cols = shard.row_columns()
    n = shard.num_rows
    fns = [tier[0]["key_fn"]] if tier is not None else key_eval_fns(
        key_exprs, shard)
    keys = tuple(broadcast(f(cols), n) for f in fns)
    vals = tuple(broadcast(_as_f32(build_evaluator(v)(cols)), n)
                 for v in value_exprs)
    return rows_partials(keys, vals, _row_mask(cond, shard, cols), need,
                         tier)


def merge_partials(p: GroupPartials) -> GroupPartials:
    """Re-aggregate partial rows by key tuple, keys ascending in
    sort-key order: counts and float64 sums add, mins and maxs fold."""
    if p.num_groups == 0:
        return p
    skeys = tuple(sort_key_any(k) for k in p.keys)
    perm = lexsort(skeys)
    first = sorted_first_flags(tuple(sk[perm] for sk in skeys))
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    ng = int(first.sum())
    dev = p.counts.device

    def fold(v, init, how):
        out = torch.full((ng,), init, dtype=v.dtype, device=dev)
        return out.scatter_reduce_(0, seg, v[perm], how, include_self=True)

    return GroupPartials(
        tuple(k[perm][first] for k in p.keys),
        torch.zeros(ng, dtype=torch.int64, device=dev).index_add_(
            0, seg, p.counts[perm]),
        tuple(torch.zeros(ng, dtype=_F64, device=dev).index_add_(
            0, seg, s[perm]) for s in p.sums),
        tuple(fold(m, _INF, "amin") for m in p.mins),
        tuple(fold(m, -_INF, "amax") for m in p.maxs))


def gather_merge(mesh: DataMesh, parts: list, nk: int,
                 nv: int) -> GroupPartials:
    """``all_gather`` each local shard's partials to the root and merge
    them there."""
    got = mesh.comm.all_gather([p.flat() for p in parts])
    return merge_partials(GroupPartials.concat(
        [GroupPartials.unflat(g, nk, nv) for g in got]))


def run_grouped_sharded(keys_fn_exprs, value_exprs, cond, table,
                        mesh: Optional[DataMesh] = None,
                        need=("sum", "min", "max")) -> GroupPartials:
    """Distributed GROUP BY, all_gather merge (small key spaces): each
    shard's partial table, gathered to the root device and re-aggregated
    there; replicated on every rank of a job."""
    mesh = _mesh_of(table, mesh)
    table = _ensure_sharded(table, mesh)
    note_operator("sharded_group", True)
    keys = list(keys_fn_exprs)
    tier = slot_plan(table, keys, need)
    parts = [local_partials(s, keys, value_exprs, cond, need, tier)
             for s in table.shards]
    return gather_merge(mesh, parts, len(keys), len(value_exprs))


def bucketize(cols: tuple, dest: torch.Tensor, n: int) -> list:
    """Rows of ``cols`` grouped by destination shard (stable): one tuple
    of columns a destination."""
    order = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest, minlength=n).tolist()
    moved = [c[order].split(counts) for c in cols]
    return [tuple(m[d] for m in moved) for d in range(n)]
