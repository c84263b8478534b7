"""Grouped aggregation execution: plan → partials → finish.

Counterpart of ``warpdb_tpu/engine/group_exec.py`` for the single-table
slice.  The strategy ladder is the reference's: dense slot table for
small stats-bounded integral key ranges, midrange slot table for wider
ones (kernel K2 for SUM/COUNT-only queries at either), sorted segmented
aggregation otherwise.  PyTorch has dynamic shapes, so the reference's
capacity buckets and two-phase counting dispatches are gone; results,
including row order, are the reference's.  The partial form (keys,
counts, sum/min/max per value expression) is pulled to the host and
finished in NumPy.  Per-group statistics that need each group's values (COUNT
DISTINCT, MEDIAN, PERCENTILE, STRING_AGG, APPROX_COUNT_DISTINCT's
HyperLogLog registers) come from one stable sort by the group keys,
whose segments line up with the aggregate table row for row.
"""

from __future__ import annotations

import copy
import functools
from typing import Sequence

import numpy as np
import torch

from ..errors import ExecutionError, UnsupportedError
from ..frontend.ast import (
    Aggregation,
    AggregationType,
    Alias,
    BinaryOp,
    CaseWhen,
    Constant,
    FunctionCall,
    Node,
    NotNull,
    Query,
    Star as _Star,
    Variable,
    unalias,
    walk,
)
from ..config import get_config
from ..ops.aggregate import (
    group_scatter_stage,
    group_sort_stage,
    is_integral,
    slot_group_aggregate,
    sorted_first_flags,
)
from ..ops.hll import HLL_M, hll_estimate, hll_grouped_registers
from ..ops.sort import U32_MAX, float_sort_key, int_sort_key, lexsort
from ..parallel.routes import GATHER, mesh_route
from ..parallel.sharded import is_sharded
from ..utils.metrics import note_operator
from . import udf as udf_mod
from .compiler import (
    _as_bool,
    _as_f32,
    _bool_as_f32,
    broadcast,
    build_evaluator,
)
from .optimizer import expr_range

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Aggregation helpers
# ---------------------------------------------------------------------------


class _AggSpec:
    """One (agg type, value-expression[, parameter]) triple of a query."""

    def __init__(self, agg: AggregationType, expr: Node, param=None):
        self.agg = agg
        self.expr = expr
        self.param = param
        self.key = (agg.value, expr.canonical(), param)


def _collect_agg_specs(nodes: Sequence[Node]) -> list[_AggSpec]:
    specs: dict = {}
    for node in nodes:
        if node is None:
            continue
        for n in walk(node):
            if isinstance(n, Aggregation):
                spec = _AggSpec(n.agg, n.expr, getattr(n, "param", None))
                specs.setdefault(spec.key, spec)
    return list(specs.values())


def _host_udf(name: str, args: list) -> np.ndarray:
    """A registered scalar function applied to NumPy arrays on the host
    (UDFs of the port take torch tensors)."""
    targs = [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in args]
    out = udf_mod.resolve_udf(name)(*targs)
    if isinstance(out, torch.Tensor):
        out = out.to(_F32).numpy()
    return np.asarray(out, np.float32)


def _group_level_eval(node: Node, key_canon: dict, agg_values: dict):
    """NumPy evaluator over the (small) per-group aggregate table: select
    items, HAVING and group-level ORDER BY (reference
    ``_group_level_eval``)."""
    if isinstance(node, Alias):
        return _group_level_eval(node.expr, key_canon, agg_values)
    if isinstance(node, Aggregation):
        return agg_values[
            (node.agg.value, node.expr.canonical(), getattr(node, "param", None))
        ]
    # Expression group keys match by canonical before recursion.
    canon = node.canonical()
    if canon in key_canon:
        return key_canon[canon]
    if isinstance(node, Constant):
        v = float(node.value)
        if v.is_integer() and 2**24 <= abs(v) <= 2**53:
            # f32 would round large integer literals.
            return np.float64(v)
        return np.float32(v)
    if isinstance(node, BinaryOp):
        l = _group_level_eval(node.left, key_canon, agg_values)
        r = _group_level_eval(node.right, key_canon, agg_values)
        op = node.op
        if op == "+":
            return l + r
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "/":
            with np.errstate(divide="ignore", invalid="ignore"):
                return l / r
        if op == "%":
            with np.errstate(invalid="ignore"):
                return np.fmod(l, r)
        if op == "&&":
            return np.logical_and(l != 0, r != 0)
        if op == "||":
            return np.logical_or(l != 0, r != 0)
        cmp = {
            ">": np.greater, "<": np.less, ">=": np.greater_equal,
            "<=": np.less_equal, "==": np.equal, "=": np.equal,
            "!=": np.not_equal,
        }[op]
        return cmp(l, r)
    if isinstance(node, CaseWhen):
        out = (
            np.asarray(_group_level_eval(node.default, key_canon, agg_values),
                       np.float32)
            if node.default is not None
            else np.float32(0.0)
        )
        for c, v in zip(reversed(node.conditions), reversed(node.values)):
            m = np.asarray(_group_level_eval(c, key_canon, agg_values))
            m = m if m.dtype == bool else m != 0
            out = np.where(
                m,
                np.asarray(_group_level_eval(v, key_canon, agg_values),
                           np.float32),
                out,
            )
        return out
    if isinstance(node, FunctionCall):
        args = [
            np.asarray(_group_level_eval(a, key_canon, agg_values), np.float32)
            for a in node.args
        ]
        return _host_udf(node.name, args)
    raise UnsupportedError(
        "Grouped SELECT/HAVING/ORDER BY expressions must reference the "
        f"GROUP BY key or aggregates; got: {canon}"
    )


def _provably_not_null(expr, table) -> bool:
    """True when stats prove the bare column ``expr`` holds no NULLs, so
    COUNT(expr) rides the exact row counts."""
    e = unalias(expr)
    if table is None or not isinstance(e, Variable):
        return False
    name = e.name if e.name in table.stats else e.unqualified
    st = table.stats.get(name)
    if st is None:
        return False
    if name in table.dicts:
        return st.min is not None and st.min >= 0
    return st.null_count == 0


def _agg_value_from_result(spec: _AggSpec, counts, value_aggs) -> np.ndarray:
    counts_f = counts.astype(np.float32)
    if spec.agg is AggregationType.COUNT:
        if value_aggs is None:
            return counts_f
        # COUNT(expr) = exact row counts minus the summed IS-NULL
        # indicator, subtracted in f64.
        return (
            counts.astype(np.float64) - value_aggs[0].astype(np.float64)
        ).astype(np.float32)
    sums, mins, maxs = value_aggs
    if spec.agg is AggregationType.SUM:
        return sums
    if spec.agg is AggregationType.AVG:
        return sums / np.maximum(counts_f, 1.0)
    if spec.agg is AggregationType.MIN:
        return mins
    if spec.agg is AggregationType.MAX:
        return maxs
    raise ExecutionError(f"Unknown aggregation {spec.agg}")


def _run_grouped(query: Query, table) -> np.ndarray:
    """First select item of the grouped pipeline."""
    return _run_grouped_multi(query, table, [unalias(query.select_list[0])])[0]


def _grouped_plan(query: Query, select_items: list, table=None) -> dict:
    """Static planning: aggregate specs, deduplicated value expressions
    and the reductions the query needs (reference ``_grouped_plan``)."""
    group_keys = list(query.group_by.keys)
    order_terms = query.order_by.terms if query.order_by else ()
    specs = _collect_agg_specs(
        [*select_items, query.having, *(t.expr for t in order_terms)]
    )
    vexpr_canons: list[str] = []
    vexpr_nodes: list[Node] = []
    spec_to_vidx: dict = {}
    cd_specs: list[_AggSpec] = []
    for spec in specs:
        if spec.agg is AggregationType.COUNT:
            if isinstance(unalias(spec.expr), (_Star, Constant)):
                spec_to_vidx[spec.key] = None
                continue
            if _provably_not_null(spec.expr, table):
                spec_to_vidx[spec.key] = None
                continue
            ind = NotNull(spec.expr, negated=True)
            c = ind.canonical()
            if c not in vexpr_canons:
                vexpr_canons.append(c)
                vexpr_nodes.append(ind)
            spec_to_vidx[spec.key] = vexpr_canons.index(c)
            continue
        if spec.agg in (
            AggregationType.COUNT_DISTINCT,
            AggregationType.MEDIAN,
            AggregationType.PERCENTILE,
            AggregationType.STRING_AGG,
            AggregationType.APPROX_COUNT_DISTINCT,
        ):
            spec_to_vidx[spec.key] = "cd"
            cd_specs.append(spec)
            continue
        c = spec.expr.canonical()
        if c not in vexpr_canons:
            vexpr_canons.append(c)
            vexpr_nodes.append(spec.expr)
        spec_to_vidx[spec.key] = vexpr_canons.index(c)
    if not vexpr_nodes:
        vexpr_canons = ["1.0f"]
        vexpr_nodes = [Constant("1")]

    need = set()
    for spec in specs:
        if spec.agg in (AggregationType.SUM, AggregationType.AVG):
            need.add("sum")
        elif (spec.agg is AggregationType.COUNT
              and spec_to_vidx[spec.key] is not None):
            need.add("sum")
        elif spec.agg is AggregationType.MIN:
            need.add("min")
        elif spec.agg is AggregationType.MAX:
            need.add("max")
    return {
        "group_keys": group_keys,
        "keys_canon": tuple(k.canonical() for k in group_keys),
        "specs": specs,
        "spec_to_vidx": spec_to_vidx,
        "vexpr_nodes": vexpr_nodes,
        "vexpr_canons": vexpr_canons,
        "cd_specs": cd_specs,
        "need": tuple(sorted(need)),
    }


def _row_mask(where, table, cols) -> torch.Tensor:
    """The rows ``where`` keeps (every row when it is None)."""
    n = table.num_rows
    if where is None:
        return torch.ones(n, dtype=torch.bool, device=table.device)
    return broadcast(_as_bool(build_evaluator(where)(cols)), n)


def _grouped_partials(query: Query, table, plan: dict,
                      final: bool = True) -> "_HostGroupResult":
    """The per-group aggregate table (keys, counts, sum/min/max per value
    expression), computed on the device and pulled to the host.
    ``final=False`` (a streaming chunk's partial) keeps every group (no
    device finish: a chunk's partial aggregates cannot decide HAVING or
    ORDER BY … LIMIT) and turns APPROX_COUNT_DISTINCT into its mergeable
    u8 registers."""
    group_keys = plan["group_keys"]
    if is_sharded(table):
        return _distributed_group(query, table, plan, final)
    # LIMIT pushdown of the reference (legal when groups emerge in the
    # default key order): the port slices on the host instead, with the
    # same rows; the condition still decides the device finish below.
    order_is_default = query.order_by is None or (
        len(query.order_by.terms) == 1
        and query.order_by.ascending
        and len(group_keys) == 1
        and query.order_by.expr.canonical() == group_keys[0].canonical()
    )
    limit_pushdown = (
        query.limit is not None
        and query.having is None
        and order_is_default
        and not query.distinct
        and not plan["cd_specs"]
    )
    device_finish = None
    if (
        final
        and get_config().grouped_device_finish
        and not limit_pushdown
        and query.limit is not None
        and not query.distinct
        and not plan["cd_specs"]
        and query.order_by is not None
        and len(query.order_by.terms) == 1
        and any(isinstance(n, Aggregation)
                for n in walk(query.order_by.terms[0].expr))
    ):
        device_finish = {
            "limit": query.limit + (query.offset or 0),
            "order": query.order_by.terms[0],
            "having": query.having,
        }
    result = _try_dense_group(query, table, group_keys, plan["vexpr_nodes"],
                              plan["vexpr_canons"], plan["need"],
                              device_finish=device_finish)
    if result is None:
        result = _sorted_group(query, table, group_keys, plan["vexpr_nodes"],
                               plan["vexpr_canons"], plan["keys_canon"],
                               plan["need"], device_finish=device_finish)
    for spec in plan["cd_specs"]:
        if spec.agg is AggregationType.STRING_AGG:
            stat = _grouped_string_agg
        elif spec.agg is AggregationType.APPROX_COUNT_DISTINCT:
            stat = functools.partial(_grouped_hll, want_registers=not final)
        else:
            stat = _grouped_value_order_stat
        result.dcounts[spec.key] = stat(
            query, table, group_keys, spec, result.num_groups,
            raw_int_key=result.raw_int_key,
        )
    return result


def _distributed_group(query: Query, table, plan: dict,
                       final: bool) -> "_HostGroupResult":
    """Mesh GROUP BY (single or composite keys), the reference's route
    choice (``mesh_route``): the all_gather merge when the stats-bounded
    key space holds at most ``distributed_small_keys`` tuples, else the
    map-side combine and all_to_all of partials, falling back to the row
    shuffle when a shard holds more than its combine capacity of keys.
    Each shard's partial table takes the single-device slot tier where
    one applies (K2 on the card).  Per-group value statistics index the
    merged table's ascending keys, each by its ``mesh_route("stat")``:
    APPROX_COUNT_DISTINCT by each shard's registers (the exact
    COUNT(DISTINCT) above 2048 groups, as on one device), COUNT(DISTINCT)
    by each shard's unique (group, value) pairs, MEDIAN, PERCENTILE and
    STRING_AGG by the gather route of the key and value columns the
    WHERE keeps: one sort per statistic on the root device."""
    from ..parallel import project
    from ..parallel.sharded import node_columns, run_grouped_sharded
    from ..parallel.shuffle import combine_shuffle_grouped, shuffle_grouped

    group_keys = plan["group_keys"]
    vexprs, need = plan["vexpr_nodes"], plan["need"]
    if mesh_route("group", table, query) == "merge":
        gp = run_grouped_sharded(group_keys, vexprs, query.where, table,
                                 need=need)
    else:
        gp = combine_shuffle_grouped(group_keys, vexprs, query.where, table,
                                     need=need)
        if gp is None:
            gp = shuffle_grouped(group_keys, vexprs, query.where, table,
                                 need=need)
    keys, counts, values = gp.to_host()
    result = _HostGroupResult(keys, counts, values, gp.num_groups)
    result.raw_int_key = len(keys) == 1 and keys[0].dtype.kind in "iu"
    cd_specs = plan["cd_specs"]
    gkeys = project.merged_key_sort_keys(gp.keys, result.raw_int_key)
    args = (query, table, group_keys)
    gathered = [s for s in cd_specs
                if mesh_route("stat", table, agg=s.agg) == GATHER]
    if gathered:
        # One pruned, filtered gather serves every order statistic.
        local = table.gather(
            node_columns(table, [*group_keys, *(s.expr for s in gathered)]),
            where=query.where)
        local_query = copy.copy(query)
        local_query.where = None
    for spec in cd_specs:
        key = spec.key
        route = mesh_route("stat", table, agg=spec.agg)
        if route == "registers" and _hll_capacity(
                gp.num_groups, raise_for_stream=not final) is None:
            spec = _AggSpec(AggregationType.COUNT_DISTINCT, spec.expr)
            route = "dedupe"
        if route == "registers":
            out = project.grouped_hll_sharded(
                *args, spec, gkeys, result.raw_int_key,
                want_registers=not final)
        elif route == "dedupe":
            out = project.grouped_count_distinct_sharded(
                *args, spec, gkeys, result.raw_int_key)
        else:
            stat = (_grouped_string_agg
                    if spec.agg is AggregationType.STRING_AGG
                    else _grouped_value_order_stat)
            out = stat(local_query, local, group_keys, spec,
                       result.num_groups, raw_int_key=result.raw_int_key)
        result.dcounts[key] = out
    return result


def _run_grouped_multi(query: Query, table, select_items: list) -> list:
    """Grouped pipeline for any number of select items (aggregates, keys,
    or arithmetic over them); one row-aligned array per item."""
    plan = _grouped_plan(query, select_items, table=table)
    result = _grouped_partials(query, table, plan)
    return _finish_grouped(query, select_items, plan["specs"],
                           plan["spec_to_vidx"], result, plan["keys_canon"])


def run_grouped_columns(query: Query, table) -> dict:
    """Every select item of one grouped query, by output name (an alias,
    else the item's canonical form), from a single grouping pass; rows
    in the order ``_run_grouped`` gives.  The eager join rewrite builds
    its pre-aggregated build side with it."""
    from .executor import _bind_query_strings

    query = _bind_query_strings(query, table)
    names = [s.name if isinstance(s, Alias) else s.canonical()
             for s in query.select_list]
    items = [unalias(s) for s in query.select_list]
    return dict(zip(names, _run_grouped_multi(query, table, items)))


def _integral_key_check(table, key_expr) -> tuple:
    """``(integral_static, ok)`` for a dense/midrange key: static for
    int / string-code columns, else checked on the device once per
    table (tables are immutable)."""
    key_dtype = None
    if isinstance(key_expr, Variable):
        key_dtype = table.dtypes.get(key_expr.name) or table.dtypes.get(
            key_expr.unqualified
        )
    if key_dtype is not None and key_dtype.value in ("int32", "int64",
                                                     "string"):
        return True, True
    memo = getattr(table, "_integral_memo", None)
    if memo is None:
        memo = table._integral_memo = {}
    canon = key_expr.canonical()
    if canon not in memo:
        parts = table.shards if is_sharded(table) else [table]
        oks = []
        for t in parts:
            cols = t.row_columns()
            k = broadcast(_as_f32(build_evaluator(key_expr)(cols)),
                          t.num_rows)
            valid = torch.ones(t.num_rows, dtype=torch.bool, device=k.device)
            oks.append(int(is_integral(k, valid)))
        if is_sharded(table):
            # Every rank of a job plans alike.
            oks = table.mesh.comm.gather_ints(oks)
        memo[canon] = all(oks)
    return False, memo[canon]


def _dense_key_plan(table, group_keys):
    """Plan the dense/midrange key: stats-bounded integral range(s).
    Composite keys pack into one slot id ``Σ (kᵢ − baseᵢ)·strideᵢ``, whose
    ascending order is the lexicographic key order.  None → sort path."""
    cfg = get_config()
    infos = []
    total = 1
    for key_expr in group_keys:
        rng = expr_range(key_expr, table.stats)
        if rng is None:
            return None
        lo, hi = rng
        if not (np.isfinite(lo) and np.isfinite(hi)):
            return None
        b = int(np.floor(lo))
        w = int(np.floor(hi)) - b + 1
        if w < 1:
            return None
        if not (-(2**31) <= b and b + w <= 2**31 - 1):
            return None
        integral_static, ok = _integral_key_check(table, key_expr)
        if not ok:
            return None
        total *= w
        if total > cfg.midrange_group_max_slots:
            return None
        infos.append((key_expr, b, w, integral_static))

    if len(infos) == 1:
        key_expr, base, num_slots, integral_static = infos[0]
        return {
            "key_fn": _raw_or_f32_key_fn(key_expr, integral_static),
            "base": base,
            "num_slots": num_slots,
            "unpack": lambda arr: (arr,),
            "unpack_dev": lambda arr: (arr,),
            "raw_int_key": bool(isinstance(key_expr, Variable)
                                and integral_static),
        }

    strides = [1] * len(infos)
    for i in range(len(infos) - 2, -1, -1):
        strides[i] = strides[i + 1] * infos[i + 1][2]
    parts = [
        (_raw_or_f32_key_fn(k, st), b, s)
        for (k, b, _w, st), s in zip(infos, strides)
    ]

    def key_fn(cols):
        acc = None
        for f, b, s in parts:
            # Stats bound every key inside int32, so the cast is exact.
            term = (f(cols).to(torch.int32) - b) * s
            acc = term if acc is None else acc + term
        return acc

    def unpack(arr):
        g = np.asarray(arr).astype(np.int64)
        outs = []
        for (_k, b, w, st), s in zip(infos, strides):
            v = b + (g // s) % w
            outs.append(v if st else v.astype(np.float32))
        return tuple(outs)

    def unpack_dev(arr):
        g = arr.to(torch.int32)
        return tuple(
            ((torch.div(g, s, rounding_mode="floor") % w) + b).to(_F32)
            for (_k, b, w, _st), s in zip(infos, strides)
        )

    return {
        "key_fn": key_fn,
        "base": 0,
        "num_slots": total,
        "unpack": unpack,
        "unpack_dev": unpack_dev,
        "raw_int_key": all(isinstance(k, Variable) and st
                           for k, _b, _w, st in infos),
    }


def _partials_fn(node, keys_canon, vexpr_canons):
    """Compile an expression over GROUP PARTIALS into ``fn(env) ->
    tensor`` per slot, where ``env`` holds ``counts`` (f32), ``sums`` /
    ``mins`` / ``maxs`` per value expression and ``keys``.  None when the
    expression needs anything else (the host finish then runs alone)."""
    if node is None:
        return None
    node = unalias(node)
    if isinstance(node, Constant):
        v = float(np.float32(node.value))
        return lambda env: torch.tensor(v, dtype=_F32,
                                        device=env["counts"].device)
    if isinstance(node, Variable):
        c = node.canonical()
        if c in keys_canon:
            i = keys_canon.index(c)
            return lambda env: env["keys"][i]
        return None
    if isinstance(node, Aggregation):
        if node.agg is AggregationType.COUNT:
            if isinstance(unalias(node.expr), (_Star, Constant)):
                return lambda env: env["counts"]
            ci = NotNull(node.expr, negated=True).canonical()
            if ci in vexpr_canons:
                j = vexpr_canons.index(ci)
                return lambda env: env["counts"] - env["sums"][j]
            return lambda env: env["counts"]
        if isinstance(node.expr, _Star):
            return None
        c = node.expr.canonical()
        if c not in vexpr_canons:
            return None
        i = vexpr_canons.index(c)
        if node.agg is AggregationType.SUM:
            return lambda env: env["sums"][i]
        if node.agg is AggregationType.AVG:
            return lambda env: env["sums"][i] / torch.clamp(env["counts"],
                                                            min=1.0)
        if node.agg is AggregationType.MIN:
            return lambda env: env["mins"][i]
        if node.agg is AggregationType.MAX:
            return lambda env: env["maxs"][i]
        return None
    if isinstance(node, BinaryOp):
        lf = _partials_fn(node.left, keys_canon, vexpr_canons)
        rf = _partials_fn(node.right, keys_canon, vexpr_canons)
        if lf is None or rf is None:
            return None
        op = node.op
        if op in ("&&", "||"):
            comb = torch.logical_and if op == "&&" else torch.logical_or
            return lambda env: comb(_as_bool(lf(env)), _as_bool(rf(env)))
        cmp = {
            ">": torch.gt, "<": torch.lt, ">=": torch.ge, "<=": torch.le,
            "==": torch.eq, "=": torch.eq, "!=": torch.ne,
        }.get(op)
        if cmp is not None:
            return lambda env: cmp(_as_f32(lf(env)), _as_f32(rf(env)))
        arith = {
            "+": torch.add, "-": torch.sub, "*": torch.mul,
            "/": torch.div, "%": torch.fmod,
        }.get(op)
        if arith is None:
            return None
        return lambda env: arith(_as_f32(lf(env)), _as_f32(rf(env)))
    if isinstance(node, FunctionCall):
        arg_fns = [_partials_fn(a, keys_canon, vexpr_canons) for a in node.args]
        if any(f is None for f in arg_fns):
            return None
        name = node.name

        def call(env):
            fn = udf_mod.resolve_udf(name)
            out = _as_f32(fn(*[_bool_as_f32(a(env)) for a in arg_fns]))
            dev = env["counts"].device
            return out if out.device == dev else out.to(dev)

        return call
    return None


def _device_finish_plan(device_finish, keys_canon, vexpr_canons):
    """Compile the device finish (HAVING + one ORDER BY term + LIMIT over
    the slot table); None when it is not expressible over partials."""
    if device_finish is None:
        return None
    term = device_finish["order"]
    ord_fn = _partials_fn(term.expr, keys_canon, tuple(vexpr_canons))
    hav = device_finish["having"]
    hav_fn = (_partials_fn(hav, keys_canon, tuple(vexpr_canons))
              if hav is not None else False)
    if ord_fn is None or hav_fn is None:
        return None
    return {
        "limit": device_finish["limit"],
        "ord_fn": ord_fn,
        "asc": term.ascending,
        "hav_fn": hav_fn if hav is not None else None,
    }


def _finish_on_device(df, res, keys_dev) -> tuple:
    """Survivor order of the device finish: slots passing HAVING sorted
    by the order expression in ``float_sort_key`` space, ties on the slot
    id, the rest behind a sentinel.  Returns (slot index order truncated
    to the limit, survivor count)."""
    counts = res.counts.to(_F32)
    env = {
        "counts": counts,
        "sums": [v.sums for v in res.values],
        "mins": [v.mins for v in res.values],
        "maxs": [v.maxs for v in res.values],
        "keys": list(keys_dev),
    }
    mask = res.counts > 0
    if df["hav_fn"] is not None:
        mask = mask & _as_bool(broadcast(df["hav_fn"](env), counts.shape[0]))
    oku = float_sort_key(broadcast(_as_f32(df["ord_fn"](env)), counts.shape[0]))
    if not df["asc"]:
        oku = U32_MAX - oku
    oku = torch.where(mask, oku, U32_MAX)
    order = torch.sort(oku, stable=True).indices  # stable: ties by slot id
    n_surv = int(mask.sum())
    return order[: min(n_surv, df["limit"])], n_surv


def _to_host_result(keys, counts, values, raw_int_key) -> "_HostGroupResult":
    keys = tuple(k.cpu().numpy() if isinstance(k, torch.Tensor) else k
                 for k in keys)
    counts = counts.cpu().numpy()
    values = tuple(tuple(t.cpu().numpy() for t in v) for v in values)
    out = _HostGroupResult(keys, counts, values, int(counts.shape[0]))
    out.raw_int_key = raw_int_key
    return out


def _slot_table_result(res, kp, df) -> "_HostGroupResult":
    """Compact a slot table (dense or midrange tier) to its occupied
    slots in ascending key order, or to the device finish's survivors."""
    if df is not None:
        idx, _n = _finish_on_device(df, res, kp["unpack_dev"](res.keys[0]))
    else:
        idx = torch.nonzero(res.counts > 0).reshape(-1)
    keys = kp["unpack"](res.keys[0][idx].cpu().numpy())
    values = tuple(
        (v.sums[idx], v.mins[idx], v.maxs[idx]) for v in res.values
    )
    return _to_host_result(keys, res.counts[idx], values, kp["raw_int_key"])


def slot_tier(table, group_keys, need):
    """``(key plan, "DENSE" | "MIDRANGE", K2)`` of the sort-free GROUP BY
    ladder, or None for the sorted tier: dense slot table for small key
    ranges, midrange for wider ones.  SUM/COUNT-only queries up to
    ``group_hist_max_slots`` take kernel K2 at either tier (the
    reference's MXU one-hot served the midrange tier alone; on the H100
    K2 beats the dense scatter at every dense slot count, ``config.py``);
    K2 adds with atomics, so a non-finite value reaches only its own
    slot and the reference's finite-values gate (a one-hot product
    hazard) is dropped.  EXPLAIN names the tier from here."""
    kp = _dense_key_plan(table, group_keys)
    if kp is None:
        return None
    cfg = get_config()
    num_slots = kp["num_slots"]
    use_k2 = set(need) <= {"sum"} and num_slots <= cfg.group_hist_max_slots
    if num_slots <= cfg.dense_group_max_slots:
        return kp, "DENSE", use_k2
    if (num_slots > cfg.midrange_group_base_slots
            and num_slots > table.num_rows):
        return None
    return kp, "MIDRANGE", use_k2


def _try_dense_group(query, table, group_keys, vexpr_nodes, vexpr_canons,
                     need=("sum", "min", "max"), device_finish=None):
    """The sort-free GROUP BY ladder (``slot_tier``); None when stats
    cannot prove integral key range(s) narrow enough."""
    tier = slot_tier(table, group_keys, need)
    if tier is None:
        return None
    kp, name, use_hist = tier
    base, num_slots = kp["base"], kp["num_slots"]
    midrange = name == "MIDRANGE"
    # The reference's dense tier has no device finish.
    df = None
    if midrange:
        keys_canon = tuple(k.canonical() for k in group_keys)
        df = _device_finish_plan(device_finish, keys_canon, vexpr_canons)
    note_operator("midrange_group" if midrange else "dense_group", True)
    cols = table.row_columns()
    n = table.num_rows
    valid = _row_mask(query.where, table, cols)
    keys = broadcast(kp["key_fn"](cols), n)
    vals = [broadcast(_as_f32(build_evaluator(v)(cols)), n)
            for v in vexpr_nodes]
    res = slot_group_aggregate(keys, vals, valid, base, num_slots, need,
                               use_hist)
    return _slot_table_result(res, kp, df)


def _raw_or_f32_key_fn(key_expr, integral_static: bool):
    """Key evaluator for the dense/midrange tiers: bare integer/string
    columns feed raw int32 (f32 would corrupt ids beyond 2^24);
    everything else evaluates to f32."""
    if isinstance(key_expr, Variable) and integral_static:
        kname, kuname = key_expr.name, key_expr.unqualified

        def key_fn(cols):
            arr = cols.get(kname)
            return arr if arr is not None else cols[kuname]

        return key_fn
    inner = build_evaluator(key_expr)
    return lambda cols: _as_f32(inner(cols))


class _HostGroupResult:
    """Group table pulled to the host and compacted."""

    def __init__(self, keys, counts, values, num_groups, dcounts=None):
        self.keys = keys
        self.counts = counts
        self.values = values
        self.num_groups = num_groups
        # COUNT(DISTINCT) / MEDIAN / PERCENTILE per group, by spec key.
        self.dcounts: dict = dcounts or {}
        # Whether the producing path grouped on raw integer keys.
        self.raw_int_key: bool = False


def _order_stat_keys(query, table, group_keys, raw_int_key, cols):
    if raw_int_key and len(group_keys) == 1:
        kvar = group_keys[0]
        raw = cols.get(kvar.name)
        if raw is None:
            raw = cols[kvar.unqualified]
        return [int_sort_key(raw)]
    return [
        float_sort_key(broadcast(_as_f32(build_evaluator(k)(cols)),
                                 table.num_rows))
        for k in group_keys
    ]


def _grouped_value_order_stat(query, table, group_keys, spec, num_groups,
                              raw_int_key: bool = False) -> np.ndarray:
    """Per-group COUNT(DISTINCT e), MEDIAN(e) or PERCENTILE(e, q) from one
    sort by (group keys…, value).  Segments emerge in the same ascending
    key order as the aggregate table, so rows align."""
    note_operator("group_order_stat", True)
    agg, param = spec.agg, spec.param
    cols = table.row_columns()
    valid = _row_mask(query.where, table, cols)
    skeys = [k[valid] for k in
             _order_stat_keys(query, table, group_keys, raw_int_key, cols)]
    vals = broadcast(_as_f32(build_evaluator(spec.expr)(cols)),
                     table.num_rows)[valid]
    if vals.numel() == 0:
        return np.zeros(int(num_groups), np.float32)
    sval = float_sort_key(vals)
    perm = lexsort([*skeys, sval])
    skeys_s = tuple(k[perm] for k in skeys)
    sval_s, vals_s = sval[perm], vals[perm]
    key_first = sorted_first_flags(skeys_s)
    seg = torch.cumsum(key_first.to(torch.int64), 0) - 1
    ng = int(key_first.sum())
    if agg is AggregationType.COUNT_DISTINCT:
        val_first = key_first.clone()
        val_first[1:] |= sval_s[1:] != sval_s[:-1]
        out = torch.zeros(ng, dtype=torch.int64, device=vals.device)
        out.index_add_(0, seg, val_first.to(torch.int64))
        return out.to(_F32).cpu().numpy()[: int(num_groups)]
    counts = torch.bincount(seg, minlength=ng)
    starts = torch.nonzero(key_first).reshape(-1)
    c = torch.clamp(counts, min=1)
    q = 0.5 if agg is AggregationType.MEDIAN else float(param)
    pos = q * (c - 1).to(_F32)
    lo_off = torch.floor(pos).to(torch.int64)
    frac = pos - lo_off.to(_F32)
    last = vals_s.shape[0] - 1
    lo_idx = torch.clamp(starts + lo_off, 0, last)
    hi_idx = torch.clamp(starts + torch.minimum(lo_off + 1, c - 1), 0, last)
    out = vals_s[lo_idx] * (1.0 - frac) + vals_s[hi_idx] * frac
    return out.cpu().numpy().astype(np.float32)[: int(num_groups)]


def _sorted_segments(query, table, group_keys, spec, raw_int_key,
                     by_value: bool):
    """The valid rows sorted by the group keys (and, with ``by_value``,
    then by the value's ``float_sort_key``), stable: ``(values sorted,
    group-start flags)``, or None when no row is valid.  Segments emerge
    in the aggregate table's ascending key order."""
    cols = table.row_columns()
    valid = _row_mask(query.where, table, cols)
    skeys = [k[valid] for k in
             _order_stat_keys(query, table, group_keys, raw_int_key, cols)]
    vals = broadcast(_as_f32(build_evaluator(spec.expr)(cols)),
                     table.num_rows)[valid]
    if vals.numel() == 0:
        return None
    perm = lexsort([*skeys, float_sort_key(vals)] if by_value else skeys)
    return vals[perm], sorted_first_flags(tuple(k[perm] for k in skeys))


def _hll_capacity(num_groups: int, raise_for_stream: bool = False):
    """The reference's register-table rows for ``num_groups`` groups,
    ``next_pow2(max(G, 16))``, or None above ``capacity · m = 2^23``
    (over 2048 groups), where APPROX_COUNT_DISTINCT returns the exact
    COUNT(DISTINCT); ``raise_for_stream`` raises there instead (a
    stream's partial must be registers)."""
    ng = int(num_groups)
    capacity = 1 << (max(ng, 16) - 1).bit_length()
    if capacity * HLL_M <= (1 << 23):
        return capacity
    if raise_for_stream:
        raise UnsupportedError(
            "APPROX_COUNT_DISTINCT streaming supports up to "
            f"{(1 << 23) // HLL_M} groups per chunk (got {ng}); use "
            "COUNT(DISTINCT ...) — its streamed state is bounded by the "
            "distinct count"
        )
    return None


def _grouped_hll(query, table, group_keys, spec, num_groups,
                 raw_int_key: bool = False, want_registers: bool = False):
    """Per-group APPROX_COUNT_DISTINCT (HyperLogLog, ``ops/hll.py``): one
    stable sort by the group keys gives ascending segment ids; the values'
    ``float_sort_key`` images hash and scatter-max into a (groups, m)
    register table; the estimate runs on the device and O(groups) values
    come back.  ``want_registers`` (a streaming chunk's partial) returns
    the u8 registers instead, which merge by elementwise max.

    The reference sizes the table at ``capacity = next_pow2(max(G, 16))``
    rows and keeps ``capacity · m ≤ 2^23``; above that (over 2048 groups)
    it returns the EXACT COUNT(DISTINCT), as this port does."""
    ng = int(num_groups)
    if _hll_capacity(ng, raise_for_stream=want_registers) is None:
        exact = _AggSpec(AggregationType.COUNT_DISTINCT, spec.expr)
        return _grouped_value_order_stat(query, table, group_keys, exact,
                                         num_groups, raw_int_key=raw_int_key)
    note_operator("group_hll", True)
    got = _sorted_segments(query, table, group_keys, spec, raw_int_key,
                           by_value=False)
    if got is None:
        regs = torch.zeros((ng, HLL_M), dtype=torch.int32,
                           device=table.device)
    else:
        vals_s, key_first = got
        seg = torch.cumsum(key_first.to(torch.int64), 0) - 1
        regs = hll_grouped_registers(seg, float_sort_key(vals_s), None,
                                     max(ng, int(seg[-1]) + 1))[:ng]
    if want_registers:
        return regs.to(torch.uint8).cpu().numpy()
    return hll_estimate(regs).cpu().numpy().astype(np.float32)


def _grouped_string_agg(query, table, group_keys, spec, num_groups,
                        raw_int_key: bool = False) -> np.ndarray:
    """STRING_AGG(expr, sep): one stable sort by (group keys…, value) puts
    each group's values together, ascending (NaN last, -0.0 equal to
    +0.0); the sorted values and the group sizes come to the host (O(N):
    the result holds every value), which decodes and joins.  String
    expressions decode through their vocabulary, numbers format ``%g``
    from the f32 values; a group without values gives "".  An object
    array aligned row for row with the aggregate table."""
    from ..frontend.ast import CodeMap
    from ..storage.strings import decode_codes

    node = unalias(spec.expr)
    vocab = None
    if isinstance(node, CodeMap):
        vocab = node.out_vocab
    elif isinstance(node, Variable) and table.dicts:
        vocab = table.dicts.get(node.name)
        if vocab is None:
            vocab = table.dicts.get(node.unqualified)
    note_operator("group_string_agg", True)
    ng = int(num_groups)
    out = np.full(ng, "", dtype=object)
    got = _sorted_segments(query, table, group_keys, spec, raw_int_key,
                           by_value=True)
    if got is None:
        return out
    vals_s, key_first = got
    starts = torch.nonzero(key_first).reshape(-1)
    ends = torch.cat([starts[1:], starts.new_tensor([vals_s.shape[0]])])
    counts = (ends - starts).cpu().numpy()[:ng]
    vals_h = vals_s.cpu().numpy()
    if vocab is not None:
        parts = decode_codes(vals_h, vocab)
    else:
        parts = [f"{v:g}" for v in vals_h.tolist()]
    sep = "" if spec.param is None else str(spec.param)
    pos = 0
    for g, c in enumerate(counts.tolist()):
        out[g] = sep.join(parts[pos:pos + c])
        pos += c
    return out


def _sorted_group(query, table, group_keys, vexpr_nodes, vexpr_canons,
                  keys_canon, need=("sum", "min", "max"), device_finish=None):
    """Sort-based GROUP BY (reference ``_sorted_group``): one stable sort
    by the key tuple, then per-segment reductions.  A bare integer /
    string-code key sorts and carries its raw int32 bits."""
    note_operator("group_sort", True)
    cols = table.row_columns()
    n = table.num_rows
    raw_int = False
    if len(group_keys) == 1 and isinstance(group_keys[0], Variable):
        kd = table.dtypes.get(group_keys[0].name) or table.dtypes.get(
            group_keys[0].unqualified
        )
        raw_int = kd is not None and kd.value in ("int32", "int64", "string")
    valid = _row_mask(query.where, table, cols)
    vals = tuple(broadcast(_as_f32(build_evaluator(v)(cols)), n)
                 for v in vexpr_nodes)
    if raw_int:
        raw = broadcast(_raw_or_f32_key_fn(group_keys[0], True)(cols), n)
        stage = group_sort_stage((raw,), vals, valid,
                                 skeys=(int_sort_key(raw),))
    else:
        keys = tuple(broadcast(_as_f32(build_evaluator(k)(cols)), n)
                     for k in group_keys)
        stage = group_sort_stage(keys, vals, valid)
    ng = int(stage[4])
    res = group_scatter_stage(*stage, ng, need)
    df = _device_finish_plan(device_finish, keys_canon, vexpr_canons)
    if df is not None:
        idx, _n = _finish_on_device(df, res, res.keys)
        keys = tuple(k[idx] for k in res.keys)
        values = tuple((v.sums[idx], v.mins[idx], v.maxs[idx])
                       for v in res.values)
        return _to_host_result(keys, res.counts[idx], values, raw_int)
    values = tuple((v.sums, v.mins, v.maxs) for v in res.values)
    return _to_host_result(res.keys, res.counts, values, raw_int)


def _finish_grouped(query, select_items, specs, spec_to_vidx,
                    result: _HostGroupResult, keys_canon) -> list:
    """Host-side finishing on the group table: evaluate each select item
    over (keys, aggregates), then HAVING, ORDER BY over groups, DISTINCT
    (reference ``_finish_grouped``).  One array per select item."""
    num_groups = result.num_groups
    counts = result.counts
    agg_values = {}
    for spec in specs:
        vidx = spec_to_vidx[spec.key]
        if vidx == "cd":
            agg_values[spec.key] = result.dcounts[spec.key]
        else:
            agg_values[spec.key] = _agg_value_from_result(
                spec, counts, None if vidx is None else result.values[vidx]
            )
    key_canon_map = {c: result.keys[i] for i, c in enumerate(keys_canon)}

    mask = np.ones(num_groups, dtype=bool)
    if query.having is not None:
        hv = np.asarray(_group_level_eval(query.having, key_canon_map,
                                          agg_values))
        mask &= hv if hv.dtype == bool else hv != 0

    order = None
    if query.order_by is not None:
        # Lexicographic sort in f64 (exact for f32 values and int keys);
        # descending terms negate their key; ties keep key order.
        keys = []
        for t in query.order_by.terms:
            v = _group_level_eval(t.expr, key_canon_map, agg_values)
            v = np.broadcast_to(np.asarray(v, dtype=np.float64),
                                (num_groups,))[mask]
            keys.append(v if t.ascending else -v)
        order = np.lexsort(tuple(reversed(keys)))

    outs = []
    for item in select_items:
        arr = np.asarray(_group_level_eval(item, key_canon_map, agg_values))
        if arr.dtype == object or arr.dtype.kind in "iu":
            # STRING_AGG's strings stay an object array; integer group
            # keys stay integer (exact beyond 2^24).
            vals = np.broadcast_to(arr, (num_groups,))[mask]
        else:
            vals = np.broadcast_to(np.asarray(arr, dtype=np.float32),
                                   (num_groups,))[mask]
        if order is not None:
            vals = vals[order]
        if query.distinct:
            if vals.dtype == object:
                vals = np.unique(vals.astype(str)).astype(object)
            else:
                vals = np.unique(vals)
            if query.order_by is not None and not query.order_by.ascending:
                vals = vals[::-1]
        if vals.dtype == object:
            outs.append(np.asarray(vals, dtype=object))
        elif vals.dtype.kind in "iu":
            outs.append(np.ascontiguousarray(vals))
        else:
            outs.append(np.ascontiguousarray(vals, dtype=np.float32))
    return outs
