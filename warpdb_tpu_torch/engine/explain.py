"""EXPLAIN: a readable physical-plan description.

Counterpart of ``warpdb_tpu/engine/explain.py``: the same plan structure
and headings (``filter:``, ``join:``, ``group by:`` with its
``strategy:``, ``aggregates (one pass):``, ``finish:``, ``order by:``,
``distinct:``, ``window:``), naming the port's own mechanisms.  The tier
choices call the executor's own planners (``_dense_key_plan``,
``_grouped_plan``, ``_window_dense_cfg``) with the port's ``config.py``,
so the tier EXPLAIN names is the tier that runs.  Only stats and, for a
float key, the executor's memoised integral check touch the device.
"""

from __future__ import annotations

import copy
from typing import Optional

from ..config import get_config
from ..frontend.ast import (
    Aggregation,
    AggregationType,
    Query,
    StringLiteral,
    WindowFunction,
    unalias,
    walk,
)
from ..ops.topk_kernel import MAX_K
from ..parallel.routes import GATHER, mesh_key_space, mesh_route

__all__ = ["explain_query", "explain_expression"]

_K1 = "K1 top-k kernel (csrc/topk.cu)"
_K2 = "K2 shared-memory slot table (csrc/group_hist.cu)"


def _fmt(node) -> str:
    return node.canonical()


def _verdict_tag(verdict, false_tag: str) -> str:
    return {True: "stats: always true -> dropped", False: f"stats: {false_tag}",
            None: "fused into the pass"}[verdict]


def explain_expression(table, expr, cond) -> str:
    from .optimizer import analyze_condition, fold_constants

    lines = ["Expression plan (fused filter+projection, one pass of torch "
             "ops):"]
    expr = fold_constants(expr)
    lines.append(f"  project: {_fmt(expr)}")
    if cond is not None:
        verdict = analyze_condition(fold_constants(cond), table.stats)
        tag = _verdict_tag(verdict, "always false -> scan skipped")
        lines.append(f"  filter:  {_fmt(cond)}  [{tag}]")
    mesh = _mesh(table)
    if mesh is not None:
        lines.append(f"  scan: {table.num_rows} rows row-sharded over "
                     f"{mesh.size} shards, each evaluated on its device and "
                     "gathered in row order")
    else:
        lines.append(f"  scan: {table.num_rows} rows (padded "
                     f"{table.padded_rows}), columns on {table.device}")
    return "\n".join(lines)


def _group_strategy(query: Query, select_items: list, table) -> tuple:
    """``(tier, slots, use K2)`` of a grouped query over ``table``, as
    ``group_exec.slot_tier`` decides it: "DENSE", "MIDRANGE" or
    "SORTED"."""
    from .group_exec import _grouped_plan, slot_tier

    need = _grouped_plan(query, select_items, table=table)["need"]
    tier = slot_tier(table, list(query.group_by.keys), need)
    if tier is None:
        return "SORTED", None, False
    kp, name, use_k2 = tier
    return name, kp["num_slots"], use_k2


def _mesh(table):
    return getattr(table, "mesh", None)


def _gather_tag(table) -> str:
    """The gather route's tag: what an operator without a distributed
    route does on a sharded table."""
    mesh = _mesh(table)
    return (f"gather route: the {mesh.size} shards all_gather onto "
            f"{mesh.root} first, only the columns the operator reads, of "
            "the rows each shard's WHERE keeps")


def _route_text(route: str, table) -> str:
    """What a ``mesh_route`` family does, ``+``-joined families each."""
    n = _mesh(table).size
    texts = {
        "shard": (f"DISTRIBUTED shard route: each of the {n} shards "
                  "evaluates the items and compacts the rows WHERE keeps "
                  "(under a LIMIT only its first LIMIT + OFFSET in the "
                  "statement's order); the pieces gather in row order"),
        "partials": (f"DISTRIBUTED partials: a count (int64), float64 "
                     f"sum, min and max on each of the {n} shards, one "
                     "all_gather of the partials, finished on the merge"),
        "dedupe": (f"DISTRIBUTED dedupe: each of the {n} shards dedupes "
                   "its values (DISTINCT: gathered and deduped once more; "
                   "COUNT(DISTINCT): its (group, value) pairs hash-shuffled "
                   "to an owner shard, deduped and counted there, one "
                   "psum of the counts)"),
        "registers": (f"DISTRIBUTED registers: each of the {n} shards' "
                      "4096 u8 HyperLogLog registers a group, merged by "
                      "elementwise max"),
        GATHER: _gather_tag(table),
    }
    return "; ".join(texts[r] for r in route.split("+"))


def _join_lines(query: Query, table, catalog: dict) -> list:
    from .join_exec import PUSHDOWN_MAX_SHARE, _classify_build_conjuncts

    lines = []
    mesh = _mesh(table)
    for join in query.joins:
        right = catalog.get(join.table, table)
        how = ("phase 1: build-side torch.sort + probe searchsorted; unique "
               "build keys -> probe-order lookup, a uniform fan-out -> K4 "
               "uniform_expand, else K3 windowed_expand")
        if mesh is not None:
            route = mesh_route("join", table, join=(
                getattr(join, "kind", "inner"), join.condition))
            how = (f"DISTRIBUTED hash-partitioned all-to-all shuffle join "
                   f"({mesh.size} shards; per shard: phase 1 + K3 "
                   "windowed_expand)")
            if route == "shuffle+gather":
                how += ", then the build misses appended on the " \
                    f"gathered result ({_gather_tag(table)})"
            elif route == GATHER:
                how = _gather_tag(table)
        kind = {"left": "left outer", "right": "right outer",
                "full": "full outer", "cross": "cross"}.get(
            getattr(join, "kind", "inner"), "inner")
        if join.condition is None:
            lines.append(
                f"  join: cross join with '{join.table}' (cartesian product "
                f"via a constant-key equi-join) [{how}; build side "
                f"{right.num_rows} rows]")
        else:
            lines.append(
                f"  join: {kind} equi-join with '{join.table}' on "
                f"{_fmt(join.condition)} [{how}; build side {right.num_rows} "
                "rows]")
    if (query.where is not None and get_config().join_filter_pushdown
            and mesh is None):
        by_rel, _rest, _p, implied = _classify_build_conjuncts(
            query, table, catalog)
        for rname, conjs in by_rel.items():
            pred = " AND ".join(_fmt(c) for c in conjs)
            lines.append(
                f"  pushdown: {pred} -> compacts '{rname}' BEFORE the join "
                "(nonzero positions + K5 sorted_take; skipped above "
                f"{PUSHDOWN_MAX_SHARE:.0%} selectivity)")
        for rname, disjs in implied.items():
            pred = " AND ".join(_fmt(c) for c in disjs)
            lines.append(
                f"  pushdown (implied): {pred} -> pre-shrinks '{rname}' "
                "(derived from an OR conjunct; the original stays in WHERE)")
    return lines


def _group_lines(query: Query, select_items: list, current) -> list:
    from ..parallel.shuffle import COMBINE_CAP
    from .group_exec import _collect_agg_specs

    keys = ", ".join(_fmt(k) for k in query.group_by.keys)
    lines = [f"  group by: {keys}"]
    mesh = _mesh(current)
    tier, slots, use_k2 = _group_strategy(query, select_items, current)
    packed = ", packed composite key" if len(query.group_by.keys) > 1 else ""
    route = mesh_route("group", current, query) if mesh is not None else None
    if mesh is not None:
        # A shard's partial table: the slot tier for one key
        # (``sharded.slot_plan``), the sorted tier otherwise.
        shard_tier = tier if len(query.group_by.keys) == 1 else "SORTED"
        lines.append(
            f"    per shard: {shard_tier} partial table"
            + (f" ({_K2})" if shard_tier != "SORTED" and use_k2 else ""))
    if route == "merge":
        space = mesh_key_space(current, query.group_by.keys)
        lines.append(
            f"    strategy: DISTRIBUTED per-shard partial aggregation + "
            f"all_gather merge ({mesh.size} shards; {space} key tuples, "
            "stats-bounded; partials merge in float64)")
    elif mesh is not None:
        lines.append(
            f"    strategy: DISTRIBUTED map-side combine + all-to-all hash "
            f"shuffle of partials ({mesh.size} shards; the row shuffle when "
            f"a shard holds more than {COMBINE_CAP} key tuples), disjoint "
            "tables gathered in key order")
    elif tier == "DENSE":
        engine = (f"{_K2} for SUM/COUNT" if use_k2 else
                  "bincount / index_add_ / scatter_reduce_")
        lines.append(
            f"    strategy: DENSE integer-key aggregation ({slots} slots, "
            f"stats-bounded{packed}; no sort — one slot table by {engine})")
    elif tier == "MIDRANGE":
        engine = (f"{_K2} for SUM/COUNT" if use_k2 else
                  "scatter slot table (index_add_ / scatter_reduce_) for "
                  "every aggregate")
        lines.append(
            f"    strategy: MIDRANGE sort-free aggregation ({slots} slots, "
            f"stats-bounded{packed}; {engine}; occupied slots compacted on "
            "the device)")
    else:
        lines.append(
            "    strategy: SORTED segmented aggregation (stable torch.sort of "
            "the key tuple -> segment ids -> scatter reductions)")
    order_terms = query.order_by.terms if query.order_by else ()
    aggs = {
        n.canonical()
        for item in select_items + [query.having] + [t.expr
                                                     for t in order_terms]
        if item is not None
        for n in walk(item)
        if isinstance(n, Aggregation)
    }
    lines.append(f"    aggregates (one pass): {', '.join(sorted(aggs)) or '-'}")
    specs = _collect_agg_specs([*select_items, query.having,
                                *(t.expr for t in order_terms)])
    sorted_aggs = [s for s in specs if s.agg in (
        AggregationType.COUNT_DISTINCT, AggregationType.MEDIAN,
        AggregationType.PERCENTILE, AggregationType.STRING_AGG,
        AggregationType.APPROX_COUNT_DISTINCT)]
    if sorted_aggs:
        lines.append(
            "    per-group value statistics: one stable sort by (keys, value) "
            "each; APPROX_COUNT_DISTINCT -> HyperLogLog registers "
            "(scatter_reduce_ amax, exact COUNT(DISTINCT) above 2048 groups); "
            "STRING_AGG joins on the host")
        if mesh is not None:
            for s in sorted_aggs:
                lines.append(
                    f"      {s.agg.name}({_fmt(s.expr)}): "
                    f"[{_route_text(mesh_route('stat', current, agg=s.agg), current)}]")
    if (tier != "DENSE" and not sorted_aggs and mesh is None
            and get_config().grouped_device_finish and _device_finish(query)):
        lines.append(
            "    finish: HAVING + ORDER BY + LIMIT on the device when "
            "expressible over the partials — ships O(limit) groups, not "
            "O(G)")
    if query.having is not None:
        lines.append(f"  having: {_fmt(query.having)}  [host, over <=G "
                     "aggregate table]")
    return lines


def _device_finish(query: Query) -> bool:
    """``group_exec._grouped_partials``'s device-finish condition (the key
    order pushdown excluded)."""
    if query.limit is None or query.distinct or query.order_by is None:
        return False
    terms = query.order_by.terms
    if len(terms) != 1:
        return False
    keys = query.group_by.keys
    default_order = (query.order_by.ascending and len(keys) == 1
                     and terms[0].expr.canonical() == keys[0].canonical())
    if query.having is None and default_order:
        return False
    return any(isinstance(n, Aggregation) for n in walk(terms[0].expr))


def _window_line(w: WindowFunction, current, query: Query) -> str:
    from .window_exec import _window_dense_cfg

    mesh = _mesh(current)
    if mesh is not None:
        if mesh_route("window", current, query) == "dense":
            kind = (f"DISTRIBUTED dense partition slot tables merged by one "
                    f"psum/pmin/pmax ({mesh.size} shards; no row moves)")
        else:
            kind = _gather_tag(current)
        return f"  window: {_fmt(w)}  [{kind}]"
    if _window_dense_cfg(w, tuple(w.partition_by or ()), current) is not None:
        kind = "DENSE partition broadcast (stats-bounded key; no sort)"
    elif w.order_by:
        kind = "running (segmented scan over one packed int64 sort key)"
    else:
        kind = "partition broadcast (one packed int64 sort, segment reductions)"
    return f"  window: {_fmt(w)}  [{kind}]"


def _project_route(query: Query, select_items: list, current) -> str:
    """``mesh_route("project")`` of the select list, as the executor
    asks it: a one-item list as it is, a multi-item one (no aggregates:
    the shard route) likewise."""
    q = copy.copy(query)
    q.select_list = list(select_items)
    return mesh_route("project", current, q)


def _takes_topk(query: Query, select_items: list, current) -> bool:
    """Whether the executor runs this projection as a top-k: the gate it
    calls itself (``mesh_route`` on a mesh, ``_use_topk`` on one
    device)."""
    from .compiler import raw_int_item
    from .executor import _use_topk

    if query.group_by is not None or not select_items:
        return False
    if _mesh(current) is not None:
        q = copy.copy(query)
        q.select_list = list(select_items)
        return (len(select_items) == 1
                and mesh_route("project", current, q) == "topk")
    first = select_items[0]
    return not query.distinct and _use_topk(query, first, current,
                                            raw_int_item(first, current))


def _order_line(query: Query, select_items: list, current) -> str:
    from .executor import _next_pow2

    terms = ", ".join(f"{_fmt(t.expr)} {'ASC' if t.ascending else 'DESC'}"
                      for t in query.order_by.terms)
    if query.group_by is not None:
        return f"  order by: {terms}  [host lexsort over groups]"
    limit_total = (query.limit or 0) + (query.offset or 0)
    mesh = _mesh(current)
    if _takes_topk(query, select_items, current):
        k = _next_pow2(max(limit_total, 16))
        how = _K1 if k <= MAX_K else "torch.topk"
        if mesh is not None:
            return (f"  order by: {terms}  [DISTRIBUTED: {how} per shard "
                    f"({mesh.size} shards), k={k}; all_gather of k "
                    "candidates a shard, one sort finishes]")
        return f"  order by: {terms}  [{how}, k={k}]"
    tail = ("; on the root over the rows the shards gathered"
            if mesh is not None else "")
    return f"  order by: {terms}  [stable torch.sort, multi-key{tail}]"


def _distinct_line(query: Query, select_items: list, current) -> str:
    from .group_exec import slot_tier

    if _mesh(current) is not None:
        if len(select_items) > 1 or query.group_by is not None:
            return "  distinct: as GROUP BY over the select list (distributed)"
        return (f"  distinct: per shard slot occupancy or sort-unique "
                f"[{_route_text('dedupe', current)}]")
    tier = (slot_tier(current, [select_items[0]], ())
            if select_items and query.group_by is None else None)
    if tier is not None:
        return ("  distinct: DENSE/MIDRANGE slot occupancy (stats-bounded "
                "integral; no sort, O(distinct) transfer"
                + (f"; {_K2} counts" if tier[2] else "") + ")")
    return "  distinct: sort-unique on the device (stable torch.sort)"


def explain_query(query: Query, table, catalog: Optional[dict] = None,
                  title: Optional[Query] = None) -> str:
    """The plan of ``query`` over ``table`` (its FROM relation); ``title``
    is the statement the first line names (the query with its CTEs)."""
    from .executor import _bind_query_strings, expand_stars_query
    from .join_exec import _lift_implicit_join_conditions
    from .optimizer import analyze_condition, fold_constants

    catalog = catalog or {}
    lines = [f"Plan for: {(title or query).canonical()}"]
    if query.joins:
        # The plan the executor runs: implicit-join equalities move from
        # WHERE into ON conditions.
        query = _lift_implicit_join_conditions(query, table, catalog)
    if query.from_subquery is not None:
        lines.append(
            f"  from: derived table '{query.from_table}' — the inner SELECT "
            "materialises first (stats recomputed, so the outer query keeps "
            "every stats-gated fast path; memoised per source table)")
    if query.joins:
        lines += _join_lines(query, table, catalog)

    current = table
    select_items = [unalias(s) for s in expand_stars_query(query, current,
                                                           catalog)]
    if query.where is not None:
        verdict = analyze_condition(fold_constants(query.where), current.stats)
        tag = _verdict_tag(verdict, "always false -> empty result")
        lines.append(f"  where: {_fmt(query.where)}  [{tag}]")
    uses_strings = any(
        isinstance(n, StringLiteral)
        for item in select_items + [query.where, query.having]
        if item is not None
        for n in walk(item)
    )
    if uses_strings or current.dicts:
        dict_cols = ", ".join(sorted(current.dicts)) or "-"
        lines.append(f"  strings: dictionary-encoded columns [{dict_cols}]; "
                     "literals bind to codes at lowering")
    if query.qualify is not None:
        lines.append(
            f"  qualify: {_fmt(query.qualify)}  [window predicate: each "
            "comparison side rides the window pipeline as a hidden select "
            "item; boolean filter host-side over O(result) rows]")

    if query.group_by is not None and query.group_by.sets is not None:
        ks = query.group_by.keys
        rendered = ", ".join("(" + ", ".join(_fmt(ks[i]) for i in s) + ")"
                             for s in query.group_by.sets)
        lines.append(f"  group by grouping sets: {rendered}")
        lines.append(
            f"    strategy: {len(query.group_by.sets)} grouped passes (one "
            f"per set) through the dense / K2 / sort ladder; rolled-up keys "
            "read NULL; O(groups) host-side concat + order/limit")
    elif query.group_by is not None:
        bound = _bind_query_strings(query, current)
        items = [unalias(s) for s in bound.select_list]
        lines += _group_lines(bound, items, current)
    elif select_items and isinstance(select_items[0], WindowFunction):
        lines.append(_window_line(select_items[0], current, query))
    elif select_items and isinstance(select_items[0], Aggregation):
        agg = select_items[0]
        how = {
            AggregationType.APPROX_COUNT_DISTINCT:
                "HyperLogLog: one scatter_reduce_ amax into 4096 registers "
                "+ estimate",
            AggregationType.STRING_AGG:
                "one group over a constant key; values sorted, joined on "
                "the host",
        }.get(agg.agg, "single masked torch reduction")
        if _mesh(current) is not None:
            how = _route_text(_project_route(query, select_items, current),
                              current)
        lines.append(f"  global aggregate: {_fmt(agg)}  [{how}]")
    else:
        line = f"  project: {', '.join(_fmt(s) for s in select_items)}"
        if _mesh(current) is not None:
            if _takes_topk(query, select_items, current):
                line += (f"  [per shard on its device ({_mesh(current).size}"
                         " shards)]")
            elif not query.distinct or len(select_items) > 1:
                line += "  [" + _route_text(_project_route(
                    query, select_items, current), current) + "]"
        lines.append(line)

    if query.order_by is not None:
        lines.append(_order_line(query, select_items, current))
    if query.distinct:
        lines.append(_distinct_line(query, select_items, current))
    if query.offset is not None or query.limit is not None:
        lines.append(f"  offset/limit: offset={query.offset or 0} "
                     f"limit={query.limit}  [host-side, after sort]")
    mesh = _mesh(current)
    if mesh is not None:
        lines.append(f"  scan: {current.num_rows} rows row-sharded over "
                     f"{mesh.size} shards ({', '.join(map(str, current.shard_rows))}"
                     f" rows) on {', '.join(str(d) for d in mesh.devices)}")
    else:
        lines.append(f"  scan: {current.num_rows} rows (padded "
                     f"{current.padded_rows}) on {current.device}")
    return "\n".join(lines)
