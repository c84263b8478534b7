"""The route an operator takes on a sharded table.

One function decides it, for execution and EXPLAIN alike: either the
operator runs distributed over the shards (one route name a family:
``"shard"``, ``"partials"``, ``"dedupe"``, ``"registers"``, ``"topk"``,
``"dense"``, ``"merge"``, ``"shuffle"``), or it takes the gather route
(the columns the operator reads, filtered on each shard, ``all_gather``
onto the mesh's root device and the single-device operator runs
there).  The engine asks :func:`mesh_route` and dispatches; EXPLAIN
names what it answers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..frontend.ast import Aggregation, AggregationType, unalias, walk

__all__ = ["GATHER", "agg_route", "mesh_key_space", "mesh_route"]

GATHER = "gather"

# The route of an aggregate's mergeable state; every other aggregate
# (COUNT, SUM, AVG, MIN, MAX) takes "partials".
_AGG_ROUTES = {
    AggregationType.COUNT_DISTINCT: "dedupe",
    AggregationType.APPROX_COUNT_DISTINCT: "registers",
    AggregationType.MEDIAN: GATHER,
    AggregationType.PERCENTILE: GATHER,
    AggregationType.STRING_AGG: GATHER,
}


def agg_route(agg) -> str:
    """The route of one aggregate over a sharded table: ``"partials"``
    (a count, float64 sum, min and max a shard, merged), ``"dedupe"``
    (each shard's unique values or (group, value) pairs, deduped once
    more), ``"registers"`` (HyperLogLog registers, merged by max) or
    the gather route (the compacted value column, for an order
    statistic or STRING_AGG)."""
    return _AGG_ROUTES.get(agg, "partials")


def _project_route(query, table) -> str:
    from ..engine.compiler import raw_int_item
    from ..engine.executor import _use_topk

    select = unalias(query.select_list[0])
    aggs = [n.agg for it in query.select_list for n in walk(unalias(it))
            if isinstance(n, Aggregation)]
    if aggs:
        return "+".join(dict.fromkeys(agg_route(a) for a in aggs))
    if query.distinct:
        return "dedupe"
    if (len(query.select_list) == 1
            and _use_topk(query, select, table,
                          raw_int_item(select, table.shards[0]))):
        return "topk"
    return "shard"


def _window_route(query, table) -> str:
    from ..engine.window_exec import _window_dense_cfg

    select = unalias(query.select_list[0])
    if query.order_by is None and _window_dense_cfg(
            select, tuple(select.partition_by or ()), table) is not None:
        return "dense"
    return GATHER


def mesh_key_space(table, group_keys) -> Optional[int]:
    """The stats-bounded number of key tuples when it is at most
    ``distributed_small_keys`` (the mesh GROUP BY then takes the
    all_gather merge), else None."""
    from ..config import get_config
    from ..engine.optimizer import expr_range

    small = get_config().distributed_small_keys
    space = 1
    for k in group_keys:
        rng = expr_range(k, table.stats)
        if rng is None or not (np.isfinite(rng[0]) and np.isfinite(rng[1])):
            return None
        space *= max(int(rng[1] - rng[0] + 1), 1)
        if space > small:
            return None
    return space


def mesh_route(op: str, table, query=None, join: tuple = (),
               agg=None) -> str:
    """The route of ``op`` over the sharded ``table``:

    * ``"project"`` (the non-grouped select list of ``query``): over
      aggregates, the ``agg_route`` of each, joined by ``+`` in order of
      appearance (``"partials"``, ``"partials+gather"``, …); a one-item
      DISTINCT ``"dedupe"``; ``"topk"``, ORDER BY the item … LIMIT as K1
      on each shard and one sort of the gathered candidates; else
      ``"shard"``, each shard evaluating and compacting its rows (under
      a LIMIT only its first LIMIT + OFFSET in the statement's order),
      gathered in row order, an ORDER BY sorted on the root;
    * ``"stat"``: a per-group statistic of a distributed GROUP BY, the
      ``agg_route`` of ``agg`` (APPROX_COUNT_DISTINCT over more than
      2048 groups takes the exact COUNT(DISTINCT), as on one device:
      ``"dedupe"``);
    * ``"window"``: ``"dense"``, a dense partition aggregate (one
      stats-bounded integral key, no ORDER BY) by per-shard slot tables
      and one psum / pmin / pmax; else the gather route;
    * ``"group"``: ``"merge"``, the all_gather merge, when stats bound
      the key tuples to at most ``distributed_small_keys``; else
      ``"shuffle"``, the map-side combine and all-to-all of partials,
      which falls back to the row shuffle at run time when a shard holds
      more than ``shuffle.COMBINE_CAP`` key tuples;
    * ``"join"`` (``join``: the JOIN's kind and condition):
      ``"shuffle"``, the hash-partitioned shuffle join, for INNER and
      LEFT equi-joins;
      ``"shuffle+gather"`` for RIGHT and FULL (the shuffle join, then
      the build side's misses appended on the gathered result); the
      gather route for CROSS;
    * any other operator: the gather route."""
    if op == "project":
        return _project_route(query, table)
    if op == "stat":
        return agg_route(agg)
    if op == "window":
        return _window_route(query, table)
    if op == "group":
        return ("shuffle" if mesh_key_space(table, query.group_by.keys)
                is None else "merge")
    if op == "join":
        kind, condition = join
        if kind == "cross" or condition is None:
            return GATHER
        return "shuffle+gather" if kind in ("right", "full") else "shuffle"
    return GATHER
