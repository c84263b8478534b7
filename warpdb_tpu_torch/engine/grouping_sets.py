"""GROUP BY GROUPING SETS / ROLLUP / CUBE.

Counterpart of ``warpdb_tpu/engine/executor.py:2626-2807``.  One
ordinary grouped pass per set through ``run_query_table`` (so each set
takes the grouped ladder: dense slot table, midrange kernel K2 for
SUM/COUNT-only queries, sort), then the per-set results concatenate on
the host, O(groups).  In the engine's missing-value representation a
rolled-up key reads NaN (numeric) or code -1 (string, decoded to "");
rolled-up references outside aggregates lower to ``nullval()`` so NULL
propagates through arithmetic, while references inside aggregates keep
the column.  ``GROUPING(key)`` is a per-set 0/1 constant.
"""

from __future__ import annotations

import copy

import numpy as np

from ..errors import UnsupportedError, ValidationError
from ..frontend.ast import (
    Aggregation,
    AggregationType,
    Constant,
    FunctionCall,
    GroupBy,
    Node,
    Query,
    Star,
    Variable,
    WindowFunction,
    transform,
    unalias,
    walk,
)
from ..storage.table import DeviceTable
from ..utils.metrics import note_operator
from .compiler import build_evaluator
from .window_exec import _host_order_and_slice


def _is_string_key(expr: Node, table, catalog) -> bool:
    """True when a grouping-key expression is a bare reference to a
    dictionary-encoded column of the FROM relation or any catalog table
    (the NULL fill is then code -1, else NaN)."""
    expr = unalias(expr)
    if not isinstance(expr, Variable):
        return False
    cands = {expr.name, expr.unqualified}
    tables = [table, *(t for t in (catalog or {}).values()
                       if isinstance(t, DeviceTable))]
    return any(c in t.dicts for t in tables for c in cands)


def _is_row_free(expr: Node) -> bool:
    """True when an expression references no columns, aggregates or
    windows: a per-query constant (possibly NaN via ``nullval()``)."""
    return not any(isinstance(n, (Variable, Aggregation, WindowFunction,
                                  Star)) for n in walk(expr))


def _eval_scalar(expr: Node) -> float:
    """A row-free expression's value through the row evaluator, so NaN
    propagation, builtins and CASE behave as on the row path."""
    return float(build_evaluator(expr)({}))


def _truthy(v: float) -> bool:
    return v == v and v != 0.0  # NaN or false drops the row


def _run_grouping_sets(query: Query, table, catalog) -> dict:
    """One grouped pass per grouping set, concatenated, then the host
    ORDER BY / LIMIT / OFFSET over the combined rows."""
    from .executor import result_column_names, run_query_table

    note_operator("grouping_sets", True)
    gb = query.group_by
    keys = list(gb.keys)
    key_canon = [k.canonical() for k in keys]
    if query.distinct:
        raise UnsupportedError("DISTINCT with GROUPING SETS is not supported")
    if any(isinstance(n, WindowFunction)
           for it in query.select_list for n in walk(it)):
        raise UnsupportedError(
            "Window functions with GROUPING SETS are not supported"
        )
    names = result_column_names(query.select_list)
    parts: list = [[] for _ in query.select_list]
    is_str_fill = [_is_string_key(it, table, catalog)
                   for it in query.select_list]

    for s in gb.sets:
        in_set = {key_canon[i] for i in s}
        rolled = {c for c in key_canon if c not in in_set}

        def subst(node, in_set=in_set, rolled=rolled):
            if (isinstance(node, FunctionCall)
                    and node.name.upper() == "GROUPING"
                    and len(node.args) == 1):
                c = node.args[0].canonical()
                if c in in_set:
                    return Constant("0")
                if c in rolled:
                    return Constant("1")
                raise ValidationError(
                    "GROUPING() argument must be a GROUP BY key"
                )
            if node.canonical() in rolled:
                return FunctionCall("nullval", ())
            return node

        exec_items: list = []
        exec_pos: list = []
        fills: dict = {}
        for pos, item in enumerate(query.select_list):
            new = transform(unalias(item), subst, prune=(Aggregation,))
            if (isinstance(new, FunctionCall) and new.name == "nullval"
                    and not new.args):
                # String keys travel as dictionary codes: code -1 is the
                # missing marker; numeric NULL is NaN.
                fills[pos] = -1.0 if is_str_fill[pos] else float("nan")
            elif isinstance(new, Constant):
                fills[pos] = new.value
            elif _is_row_free(new):
                # A rolled-up key inside arithmetic leaves a per-set
                # constant, evaluated on the host.
                fills[pos] = _eval_scalar(new)
            else:
                exec_items.append(new)
                exec_pos.append(pos)

        having = (transform(query.having, subst, prune=(Aggregation,))
                  if query.having is not None else None)
        q2 = copy.copy(query)
        q2.order_by = q2.limit = q2.offset = None
        q2.group_by = GroupBy(tuple(keys[i] for i in s)) if s else None
        q2.having = having if s else None
        items = list(exec_items)
        having_pos = having_const = None
        if not s and having is not None:
            # The empty set has no grouped pipeline to run HAVING in:
            # it runs as one more aggregate item and filters the single
            # row on the host.
            if _is_row_free(having):
                having_const = _eval_scalar(having)
            else:
                having_pos = len(items)
                items.append(having)
        if not items:
            items.append(Aggregation(AggregationType.COUNT, Star()))
        q2.select_list = items
        vals = list(run_query_table(q2, table, catalog).values())
        n = len(vals[0]) if vals else 0
        if having_pos is not None and n and not _truthy(
                float(vals[having_pos][0])):
            n = 0
        if having_const is not None and not _truthy(float(having_const)):
            n = 0
        for j, pos in enumerate(exec_pos):
            parts[pos].append(np.asarray(vals[j])[:n])
        for pos, fv in fills.items():
            parts[pos].append(np.full(n, fv))

    combined = []
    for p in parts:
        nonempty = [a for a in p if len(a)]
        combined.append(np.concatenate(nonempty) if nonempty
                        else np.zeros(0, np.float32))
    return _host_order_and_slice(query, names, combined,
                                 "ORDER BY with GROUPING SETS")
