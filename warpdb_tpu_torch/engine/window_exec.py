"""Window functions and QUALIFY: lowering onto ``ops/window.py``.

Counterpart of ``warpdb_tpu/engine/executor.py:2188-2575`` (the bare
window item) and ``:2810-3404`` (window expressions, QUALIFY and the
host-side ORDER BY / LIMIT over finished result columns).

* ``_run_window``: ``SELECT AGG(e) OVER (…) FROM t [WHERE …] [ORDER BY
  …]`` — the window values of the rows WHERE keeps, in row order or
  sorted by the outer ORDER BY;
* ``_run_window_exprs``: select items mixing windows with row
  arithmetic (``v - AVG(v) OVER (PARTITION BY k)``);
* ``_run_qualify``: ``QUALIFY <predicate over windows>``.

Both of the latter try ``_try_fused_window_exprs`` first: the window
values, the select arithmetic and the predicate evaluate in one pass on
the table's device and a boolean mask keeps the surviving rows.  Items
that reference a string column take the reference's host route (each
window and column ships as its own result column and the arithmetic
runs in NumPy).  The reference's survivor counting, capacity buckets and
position-sort compaction are TPU workarounds and have no counterpart.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..config import get_config
from ..errors import UnsupportedError, ValidationError, WarpDBError
from ..frontend.ast import (
    Aggregation,
    AggregationType,
    Alias,
    BinaryOp,
    Constant,
    OrderBy,
    Query,
    Variable,
    WindowFunction,
    transform,
    unalias,
    walk,
)
from ..ops.sort import sort_by_keys
from ..parallel.routes import mesh_route
from ..parallel.sharded import is_sharded, node_columns
from ..utils.metrics import note_operator
from ..ops.window import (
    dense_window_aggregate,
    window_aggregate,
    window_edge_value,
    window_frame,
    window_nth_value,
    window_ntile,
    window_range_frame,
    window_rank,
    window_relative_rank,
    window_running,
    window_shift,
)
from .compiler import _as_bool, _as_f32, broadcast, build_evaluator
from .group_exec import (
    _group_level_eval,
    _integral_key_check,
    _raw_or_f32_key_fn,
    _row_mask,
)
from .optimizer import expr_range

_F32 = torch.float32


def _window_flags(select: WindowFunction) -> dict:
    """Static dispatch flags for one window node; validates the
    agg / ORDER BY / frame combination (``UnsupportedError``)."""
    shift_dir = {
        AggregationType.LAG: 1,
        AggregationType.LEAD: -1,
    }.get(select.agg, 0)
    if shift_dir:
        if select.order_by is None:
            raise UnsupportedError(
                "LAG/LEAD require an ORDER BY inside OVER (...)"
            )
        shift_dir *= int(select.param or 1)
    edge_last = select.agg is AggregationType.LAST_VALUE
    is_edge = edge_last or select.agg is AggregationType.FIRST_VALUE
    nth_n = 0
    if select.agg is AggregationType.NTH_VALUE:
        nth_n = int(select.param or 1)
        if select.order_by is None:
            raise UnsupportedError(
                "NTH_VALUE requires an ORDER BY inside OVER (...)"
            )
    ntile_n = 0
    if select.agg is AggregationType.NTILE:
        if not isinstance(select.expr, Constant):
            raise UnsupportedError("NTILE requires a constant bucket count")
        ntile_n = int(select.expr.value)
        if select.order_by is None:
            raise UnsupportedError(
                "NTILE requires an ORDER BY inside OVER (...)"
            )
    if select.frame is not None:
        fword = select.frame_type.upper()
        if select.order_by is None:
            raise UnsupportedError(
                f"A {fword} frame requires an ORDER BY inside OVER (...)"
            )
        if select.agg.value not in ("sum", "avg", "count", "min", "max"):
            raise UnsupportedError(
                f"{fword} frames support SUM/AVG/COUNT/MIN/MAX, "
                f"not {select.agg.name}"
            )
    return {
        "shift_dir": shift_dir,
        "edge_last": edge_last,
        "is_edge": is_edge,
        "nth_n": nth_n,
        "ntile_n": ntile_n,
    }


_RANKING = (AggregationType.ROW_NUMBER, AggregationType.RANK,
            AggregationType.DENSE_RANK)
_REL_RANK = (AggregationType.PERCENT_RANK, AggregationType.CUME_DIST)


def _build_window_value_fn(select: WindowFunction, part_exprs, dense_cfg):
    """``fn(cols, valid) -> f32[n]``: the per-row values of one window
    node over row columns ``cols`` and the row mask ``valid`` (0.0 where
    ``valid`` is false)."""
    f = _window_flags(select)
    val_fn = build_evaluator(select.expr)
    part_fns = [build_evaluator(p) for p in part_exprs]
    ord_fn = (build_evaluator(select.order_by.expr)
              if select.order_by is not None else None)
    ord_asc = select.order_by.ascending if select.order_by else True
    agg = select.agg.value
    dense_part_fn = (
        _raw_or_f32_key_fn(part_exprs[0], dense_cfg[2])
        if dense_cfg is not None and part_exprs else None
    )

    def win_fn(cols, valid):
        n = valid.shape[0]
        vals = broadcast(_as_f32(val_fn(cols)), n)
        if dense_cfg is not None:
            pk = (broadcast(dense_part_fn(cols), n)
                  if dense_part_fn is not None else torch.zeros_like(vals))
            return dense_window_aggregate(pk, vals, valid, agg,
                                          dense_cfg[0], dense_cfg[1])
        part = (tuple(broadcast(_as_f32(fn(cols)), n) for fn in part_fns)
                or (torch.zeros_like(vals),))
        okeys = (broadcast(_as_f32(ord_fn(cols)), n)
                 if ord_fn is not None else None)

        def okeys_or_rows():
            # Without ORDER BY, row order decides (the reference's f32
            # row positions, ties included).
            if okeys is not None:
                return okeys
            return torch.arange(n, dtype=_F32, device=vals.device)

        if f["shift_dir"]:
            return window_shift(part, okeys, vals, valid, f["shift_dir"],
                                ascending=ord_asc)
        if f["is_edge"]:
            return window_edge_value(part, okeys_or_rows(), vals, valid,
                                     last=f["edge_last"], ascending=ord_asc)
        if f["nth_n"]:
            return window_nth_value(part, okeys, vals, valid, f["nth_n"],
                                    ascending=ord_asc)
        if f["ntile_n"]:
            return window_ntile(part, okeys, valid, f["ntile_n"],
                                ascending=ord_asc)
        if select.agg in _REL_RANK:
            return window_relative_rank(part, okeys_or_rows(), valid, agg,
                                        ascending=ord_asc)
        if select.agg in _RANKING:
            return window_rank(part, okeys_or_rows(), valid, agg,
                               ascending=ord_asc)
        if select.frame is not None:
            prec, foll = select.frame
            if select.frame_type == "groups":
                # GROUPS frame (SQL:2011): a RANGE frame over the dense
                # rank of the order key — rank distance is peer-group
                # distance.
                dr = window_rank(part, okeys, valid, "dense_rank",
                                 ascending=ord_asc)
                return window_range_frame(
                    part, dr, vals, valid, agg,
                    None if prec is None else float(prec),
                    None if foll is None else float(foll),
                )
            framer = (window_range_frame if select.frame_type == "range"
                      else window_frame)
            return framer(part, okeys, vals, valid, agg, prec, foll,
                          ascending=ord_asc)
        if okeys is not None:
            return window_running(part, okeys, vals, valid, agg,
                                  ascending=ord_asc)
        return window_aggregate(part, vals, valid, agg)

    return win_fn


def _window_dense_cfg(select: WindowFunction, part_exprs, table):
    """Sort-free dense window gate: ``(base, num_slots, integral_static)``
    when stats bound a single integral partition key to at most
    ``dense_group_max_slots`` values, else None."""
    if (
        select.order_by is not None
        or select.agg.value not in ("sum", "avg", "count", "min", "max")
        or len(part_exprs) > 1
        or select.frame is not None
    ):
        return None
    if not part_exprs:
        return (0, 1, True)
    rng = expr_range(part_exprs[0], table.stats)
    if rng is None or not np.isfinite(rng[0]) or not np.isfinite(rng[1]):
        return None
    base = int(np.floor(rng[0]))
    num_slots = int(np.floor(rng[1])) - base + 1
    if (
        1 <= num_slots <= get_config().dense_group_max_slots
        and -(2**31) <= base
        and base + num_slots <= 2**31 - 1
    ):
        integral_static, ok = _integral_key_check(table, part_exprs[0])
        if ok:
            return (base, num_slots, integral_static)
    return None


def _window_values(select: WindowFunction, table, cols, valid):
    part_exprs = tuple(select.partition_by or ())
    dense_cfg = _window_dense_cfg(select, part_exprs, table)
    return _build_window_value_fn(select, part_exprs, dense_cfg)(cols, valid)


def _run_window(query: Query, table) -> np.ndarray:
    """``SELECT AGG(e) OVER (…)``: the window values of the rows WHERE
    keeps, in row order, or sorted by the outer ORDER BY (f32 keys,
    stable, as the reference)."""
    select: WindowFunction = query.select_list[0]
    if is_sharded(table):
        if mesh_route("window", table, query) == "dense":
            from ..parallel.window import run_window_partition_agg_sharded

            part_exprs = tuple(select.partition_by or ())
            dense_cfg = _window_dense_cfg(select, part_exprs, table)

            part_fn = (_raw_or_f32_key_fn(part_exprs[0], dense_cfg[2])
                       if part_exprs else None)
            return run_window_partition_agg_sharded(
                select, query.where, table, dense_cfg[0], dense_cfg[1],
                part_fn, table.mesh)
        # The gather route: the columns the window and the ORDER BY
        # read, of the rows WHERE keeps (it precedes the window).
        order_exprs = [t.expr for t in
                       (query.order_by.terms if query.order_by else ())]
        table = table.gather(node_columns(table, [select, *order_exprs]),
                             where=query.where)
        query = copy.copy(query)
        query.where = None
    note_operator("window", True)
    cols = table.row_columns()
    valid = _row_mask(query.where, table, cols)
    win = _window_values(select, table, cols, valid)
    if query.order_by is None:
        out = win[valid]
    else:
        n = table.num_rows
        keys = [(broadcast(_as_f32(build_evaluator(t.expr)(cols)), n),
                 t.ascending) for t in query.order_by.terms]
        out = sort_by_keys(keys, win, valid)[: int(valid.sum())]
    return out.cpu().numpy().astype(np.float32)


# ---------------------------------------------------------------------------
# Window expressions and QUALIFY
# ---------------------------------------------------------------------------


def _has_nested_window(item) -> bool:
    """True when a select item mixes a window function into a larger
    expression (``v - AVG(v) OVER (…)``)."""
    it = unalias(item)
    if isinstance(it, WindowFunction):
        return False
    return any(isinstance(n, WindowFunction) for n in walk(it))


def _window_extractor():
    """``(extract, win_nodes)``: ``extract(expr)`` replaces each distinct
    window function by a ``__winx<i>`` placeholder, collecting the
    windows in ``win_nodes``."""
    index: dict = {}
    win_nodes: list = []

    def extract(e):
        def repl(n):
            if isinstance(n, WindowFunction):
                c = n.canonical()
                if c not in index:
                    index[c] = len(win_nodes)
                    win_nodes.append(n)
                return Variable(f"__winx{index[c]}")
            return n

        return transform(unalias(e), repl)

    return extract, win_nodes


def _hidden_order_terms(query: Query):
    """ORDER BY terms resolved against the select items (alias or
    canonical), the others riding along as hidden ``__ord<i>`` items.
    Returns ``(hidden items, (expr, ascending) terms)``."""
    hidden: list = []
    terms: list = []
    if query.order_by is None:
        return hidden, terms
    sel_canon = {unalias(it).canonical() for it in query.select_list}
    alias_names = {it.name for it in query.select_list
                   if isinstance(it, Alias)}
    for i, t in enumerate(query.order_by.terms):
        e = unalias(t.expr)
        if (isinstance(e, Variable) and e.name in alias_names) \
                or e.canonical() in sel_canon:
            terms.append((t.expr, t.ascending))
            continue
        hname = f"__ord{i}"
        hidden.append(Alias(t.expr, hname))
        terms.append((Variable(hname), t.ascending))
    return hidden, terms


def _order_and_slice(query: Query, hidden, terms, columns, ctx: str) -> dict:
    """Host ORDER BY / LIMIT / OFFSET over the finished select columns
    and hidden order columns; returns the select items' columns."""
    from .executor import result_column_names

    q_sort = copy.copy(query)
    q_sort.select_list = [*query.select_list, *hidden]
    q_sort.order_by = None
    if terms:
        (e0, a0), *rest = terms
        q_sort.order_by = OrderBy(e0, a0,
                                  tuple(OrderBy(e, a) for e, a in rest))
    names = result_column_names(q_sort.select_list)
    sliced = _host_order_and_slice(q_sort, names, columns, ctx)
    return dict(list(sliced.items())[: len(query.select_list)])


def _run_window_exprs(query: Query, table, catalog) -> dict:
    """Select items mixing window functions with row arithmetic.  The
    fused pass first; with a string-column reference each window and
    each referenced column runs as a hidden select item and the
    arithmetic evaluates on the host in f64 (the reference's host
    route)."""
    from .executor import _dedup_rows, run_query_table

    note_operator("window_exprs", True)

    if query.group_by is not None:
        raise UnsupportedError(
            "Window functions inside expressions are not supported in "
            "grouped queries (use a bare AGG(..) OVER item)"
        )
    extract, win_nodes = _window_extractor()
    new_items = [extract(it) for it in query.select_list]
    cols: dict = {}
    for it in new_items:
        for n in walk(it):
            if isinstance(n, Aggregation):
                raise UnsupportedError(
                    "Mixing plain aggregates with window functions in "
                    "one ungrouped expression is not supported"
                )
            if isinstance(n, Variable) and not n.name.startswith("__winx"):
                cols.setdefault(n.canonical(), n)
    hidden_items = [Alias(w, f"__winx{i}") for i, w in enumerate(win_nodes)]
    hidden_items += [Alias(v, f"__colx{j}")
                     for j, v in enumerate(cols.values())]
    extra_order, terms = _hidden_order_terms(query)

    fused = _try_fused_window_exprs(query, table, win_nodes, new_items,
                                    [a.expr for a in extra_order])
    if fused is not None:
        result_cols, ord_cols = fused
    else:
        q2 = copy.copy(query)
        q2.order_by = q2.limit = q2.offset = None
        q2.select_list = [*hidden_items, *extra_order]
        vals = [np.asarray(v, np.float64)
                for v in run_query_table(q2, table, catalog).values()]
        env = {f"__winx{i}[idx]": vals[i] for i in range(len(win_nodes))}
        for j, c in enumerate(cols):
            env[c] = vals[len(win_nodes) + j]
        n_rows = len(vals[0]) if vals else 0
        result_cols = [
            np.broadcast_to(np.asarray(_group_level_eval(it, env, {}),
                                       np.float64), (n_rows,))
            for it in new_items
        ]
        ord_cols = vals[len(hidden_items):]

    if query.distinct:
        # DISTINCT ORDER BY terms must appear in the select list.
        if extra_order:
            raise UnsupportedError(
                "DISTINCT ORDER BY terms must appear in the select list"
            )
        result_cols = _dedup_rows(result_cols, ordered=False)
    return _order_and_slice(query, extra_order, terms,
                            [*result_cols, *ord_cols],
                            "ORDER BY with window expressions")


def _try_fused_window_exprs(query: Query, table, win_nodes, new_items,
                            order_exprs, pred=None):
    """One pass on the table's device: every distinct window value
    (``__winx<i>``), the select and hidden order expressions over them,
    WHERE before the windows and the QUALIFY predicate ``pred`` after;
    a boolean mask keeps the surviving rows in row order.  Returns
    ``(result_cols, ord_cols)`` as f64 host arrays, or None where an
    expression references a string-coded or unknown column (the host
    route) or a string literal does not bind."""
    from .executor import bind_strings

    if is_sharded(table):
        # The hidden-item route: each window runs on its own, the dense
        # partition aggregates distributed (the reference's fused pass
        # declines on a mesh too).
        return None
    tcols = table.columns
    for root in [*new_items, *win_nodes, *order_exprs, pred, query.where]:
        if root is None:
            continue
        for n in walk(root):
            if isinstance(n, Variable) and not n.name.startswith("__winx"):
                nm = n.name if n.name in tcols else n.unqualified
                if nm not in tcols or nm in table.dicts:
                    return None
    try:
        b_wins = [bind_strings(w, table) for w in win_nodes]
        b_items = [bind_strings(it, table) for it in new_items]
        b_order = [bind_strings(e, table) for e in order_exprs]
        b_pred = bind_strings(pred, table) if pred is not None else None
        where = bind_strings(query.where, table)
    except WarpDBError:
        return None

    cols = table.row_columns()
    n = table.num_rows
    valid = _row_mask(where, table, cols)
    env = dict(cols)
    for i, w in enumerate(b_wins):
        env[f"__winx{i}"] = _window_values(w, table, cols, valid)
    outs = [broadcast(_as_f32(build_evaluator(e)(env)), n)
            for e in [*b_items, *b_order]]
    mask = valid
    if b_pred is not None:
        # QUALIFY filters after the windows evaluate.
        mask = mask & broadcast(_as_bool(build_evaluator(b_pred)(env)), n)
    host = [o[mask].cpu().numpy().astype(np.float64) for o in outs]
    return host[: len(b_items)], host[len(b_items):]


_CMPS = {
    ">": np.greater, "<": np.less, ">=": np.greater_equal,
    "<=": np.less_equal, "==": np.equal, "=": np.equal, "!=": np.not_equal,
}


def _run_qualify(query: Query, table, catalog) -> dict:
    """``QUALIFY <predicate>``: filters rows after the window functions
    evaluate.  The fused pass first; otherwise (aggregates or string
    references) each comparison side of the predicate runs as a hidden
    select item and the predicate's boolean structure evaluates on the
    host over the finished columns."""
    note_operator("qualify", True)
    from .executor import _dedup_rows, run_query_table

    qualify = query.qualify
    if not any(isinstance(n, WindowFunction) for n in walk(qualify)):
        raise ValidationError(
            "QUALIFY requires a window function (use WHERE or HAVING "
            "for row/group predicates)"
        )
    hidden, terms = _hidden_order_terms(query)

    extract, win_nodes = _window_extractor()
    f_items = [extract(it) for it in query.select_list]
    f_order = [extract(h.expr) for h in hidden]
    f_pred = extract(qualify)
    fused = None
    if not any(isinstance(n, Aggregation)
               for it in [*f_items, *f_order, f_pred] for n in walk(it)):
        fused = _try_fused_window_exprs(query, table, win_nodes, f_items,
                                        f_order, pred=f_pred)
    if fused is not None:
        cols = [*fused[0], *fused[1]]
    else:
        leaves: list = []

        def leaf(e) -> int:
            leaves.append(Alias(e, f"__q{len(leaves)}"))
            return len(leaves) - 1

        def plan(e):
            """The predicate as a host closure over the leaf columns."""
            if isinstance(e, BinaryOp) and e.op in ("&&", "||"):
                lf, rf = plan(e.left), plan(e.right)
                comb = np.logical_and if e.op == "&&" else np.logical_or
                return lambda vs: comb(lf(vs), rf(vs))
            if isinstance(e, BinaryOp) and e.op in _CMPS:
                op = _CMPS[e.op]

                def side(x):
                    if isinstance(x, Constant):
                        c = np.float32(x.value)
                        return lambda vs: c
                    i = leaf(x)
                    return lambda vs: vs[i]

                lf, rf = side(e.left), side(e.right)
                return lambda vs: op(lf(vs), rf(vs))
            i = leaf(e)  # a bare boolean-valued window expression
            return lambda vs: np.nan_to_num(vs[i], nan=0.0) != 0.0

        pred = plan(qualify)
        q2 = copy.copy(query)
        q2.qualify = q2.order_by = q2.limit = q2.offset = None
        q2.select_list = [*query.select_list, *hidden, *leaves]
        vals = list(run_query_table(q2, table, catalog).values())
        n_vis = len(vals) - len(leaves)
        keep = np.flatnonzero(pred([np.asarray(v, np.float64)
                                    for v in vals[n_vis:]]))
        cols = [np.asarray(v)[keep] for v in vals[:n_vis]]
    if query.distinct:
        if hidden:
            raise UnsupportedError(
                "DISTINCT ORDER BY terms must appear in the select list"
            )
        cols = _dedup_rows(cols, ordered=False)
    return _order_and_slice(query, hidden, terms, cols,
                            "ORDER BY with QUALIFY")


def _host_order_and_slice(query: Query, names: list, columns: list,
                          ctx: str) -> dict:
    """ORDER BY / LIMIT / OFFSET on the host over finished result
    columns, one per select item (numeric: strings are still dictionary
    codes, whose order is the strings').  ORDER BY terms must name select
    items (alias or canonical).  NaN is the largest value (last ASC,
    first DESC); the sort is a stable ``np.lexsort`` in f64."""
    columns = [np.asarray(c) for c in columns]
    order = None
    if query.order_by is not None and columns and len(columns[0]):
        sort_keys: list = []
        for t in query.order_by.terms:
            e = unalias(t.expr)
            target = None
            if isinstance(e, Variable):
                target = next((i for i, it in enumerate(query.select_list)
                               if isinstance(it, Alias) and it.name == e.name),
                              None)
            if target is None:
                c = e.canonical()
                target = next((i for i, it in enumerate(query.select_list)
                               if unalias(it).canonical() == c), None)
            if target is None:
                raise UnsupportedError(f"{ctx} must reference select-list "
                                       "items")
            # Significance order: term-major, the NaN flag before the
            # value; np.lexsort takes the last key as primary.
            arr = columns[target].astype(np.float64)
            nan = np.isnan(arr)
            filled = np.where(nan, 0.0, arr)
            sort_keys += [nan, filled] if t.ascending else [~nan, -filled]
        order = np.lexsort(sort_keys[::-1])
    off = query.offset or 0
    end = None if query.limit is None else off + query.limit
    return {name: (col if order is None else col[order])[off:end]
            for name, col in zip(names, columns)}
