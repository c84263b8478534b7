"""Plan executor: lowers parsed queries onto the port's operators.

Counterpart of ``warpdb_tpu/engine/executor.py`` for the port's slice:

* ``run_expression``: fused filter + projection, a length-N f32 vector
  (filtered-out rows 0.0), the reference ``WarpDB::query`` contract;
* ``run_query``: derived tables, decorrelation and expression subqueries
  (``subquery``) → join rewrites and the JOIN chain (``join_exec``) →
  WHERE → GROUP BY/HAVING or projection → DISTINCT → ORDER BY (top-k or
  full sort) → OFFSET/LIMIT;
* ``run_query_table``: the same pipeline returning every select item as
  a named, row-aligned column.

CTEs and set operations resolve at the facade.  Windows, QUALIFY,
grouping sets, STRING_AGG and APPROX_COUNT_DISTINCT raise
``UnsupportedError`` naming the feature.  Operators evaluate over the
table's unpadded row views; PyTorch's dynamic shapes replace the
reference's capacity buckets, and a filter is a boolean index, which
keeps row order.
"""

from __future__ import annotations

import copy
import decimal
import re
from typing import Optional

import numpy as np
import torch

from ..errors import (
    ExecutionError,
    UnsupportedError,
    ValidationError,
)
from ..frontend.ast import (
    Aggregation,
    AggregationType,
    Alias,
    BinaryOp,
    CaseWhen,
    CodeMap,
    Constant,
    ExistsSubquery,
    FunctionCall,
    GroupBy,
    InCodeSet,
    InSubquery,
    LikePattern,
    Node,
    OrderBy,
    Query,
    ScalarSubquery,
    Star,
    StringLiteral,
    Variable,
    WindowFunction,
    transform,
    unalias,
    walk,
)
from ..storage.strings import literal_code
from ..ops.aggregate import count_distinct
from ..ops.sort import (
    lexsort,
    order_key,
    sort_by_keys,
    sort_key_any,
    sort_pairs,
    sort_values,
    top_k_values,
)
from . import join_exec as jx
from .compiler import (
    _as_bool,
    _as_f32,
    _const_value,
    broadcast,
    build_evaluator,
    compile_filter_project,
    raw_int_item,
)
from .group_exec import (
    _collect_agg_specs,
    _group_level_eval,
    _provably_not_null,
    _run_grouped,
    _run_grouped_multi,
    _try_dense_group,
)
from .optimizer import analyze_condition, expr_range, fold_constants
from .subquery import (
    _CORR_PREFIX,
    _decorrelate_subqueries,
    _resolve_expr_subqueries,
    _resolve_from_subquery,
)

__all__ = [
    "run_expression",
    "run_query",
    "run_query_table",
    "result_column_name",
    "bind_strings",
    "expand_stars_query",
    "reject_unsupported",
    "resolve_order_aliases",
]

_F32 = torch.float32


def _next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


# ---------------------------------------------------------------------------
# The slice's boundary
# ---------------------------------------------------------------------------

def _reject_nodes(node: Optional[Node]) -> None:
    if node is None:
        return
    for n in walk(node):
        if isinstance(n, WindowFunction):
            raise UnsupportedError(
                "Window functions are not supported by warpdb_tpu_torch yet"
            )
        if isinstance(n, Aggregation) and n.agg in (
            AggregationType.STRING_AGG, AggregationType.APPROX_COUNT_DISTINCT,
        ):
            raise UnsupportedError(
                f"{n.agg.name} is not supported by warpdb_tpu_torch yet"
            )


def reject_unsupported(query: Query) -> None:
    """Raise ``UnsupportedError`` naming the first feature of ``query``
    outside the port (windows, QUALIFY, grouping sets, STRING_AGG,
    APPROX_COUNT_DISTINCT).  Subqueries, CTE bodies and set-op branches
    are checked when they run."""
    if query.qualify is not None:
        raise UnsupportedError("QUALIFY is not supported by warpdb_tpu_torch yet")
    if query.group_by is not None and query.group_by.sets is not None:
        raise UnsupportedError(
            "GROUPING SETS / ROLLUP / CUBE are not supported by "
            "warpdb_tpu_torch yet"
        )
    for node in [
        *query.select_list, query.where, query.having,
        *(query.group_by.keys if query.group_by else ()),
        *(t.expr for t in (query.order_by.terms if query.order_by else ())),
        *(j.condition for j in query.joins),
    ]:
        _reject_nodes(node)


def _reject_facade_only(query: Query) -> None:
    """Set operations and CTEs resolve at the facade, not here."""
    if query.set_ops:
        raise UnsupportedError(
            "Set operations (UNION/EXCEPT/INTERSECT) execute at the "
            "facade: use WarpDB.query_sql / query_sql_table"
        )
    if query.ctes:
        raise UnsupportedError(
            "WITH (CTEs) resolve at the facade: use WarpDB.query_sql / "
            "query_sql_table"
        )


# ---------------------------------------------------------------------------
# String-literal binding (dictionary codes)
# ---------------------------------------------------------------------------

_CMP_OPS = (">", "<", ">=", "<=", "==", "=", "!=")


def _vocab_of(node: Node, table):
    if isinstance(node, Variable):
        v = table.dicts.get(node.name)
        if v is None:
            v = table.dicts.get(node.unqualified)
        return v
    if isinstance(node, CodeMap):
        return node.out_vocab
    return None


def _exact_int_literal(node) -> Optional[int]:
    """The exact integer an all-constant ``+ - *`` subtree denotes, with
    Python ints throughout, or None.  The reference folds these through
    f64, which is lossy beyond 2^53 when binding against a wide-int64
    vocabulary; this keeps such literals exact."""
    if isinstance(node, Alias):
        return _exact_int_literal(node.expr)
    if isinstance(node, Constant):
        try:
            d = decimal.Decimal(node.text)
        except decimal.InvalidOperation:
            return None
        return int(d) if d == d.to_integral_value() else None
    if isinstance(node, BinaryOp) and node.op in ("+", "-", "*"):
        l, r = _exact_int_literal(node.left), _exact_int_literal(node.right)
        if l is None or r is None:
            return None
        return l + r if node.op == "+" else l - r if node.op == "-" else l * r
    return None


def _int_literal_code(vocab: np.ndarray, node) -> Optional[float]:
    """Code of a constant subtree under an int64 vocabulary (exact code
    for members, rank - 0.5 otherwise); None when not constant."""
    iv = _exact_int_literal(node)
    if iv is not None and -(2**63) <= iv < 2**63:
        return literal_code(vocab, np.int64(iv))
    cv = _const_value(node)
    if cv is None:
        return None
    return literal_code(vocab, cv)


def _like_regex(pattern: str, flags: int):
    return re.compile(
        "".join(
            ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
            for ch in pattern
        ),
        flags,
    )


def bind_strings(node: Optional[Node], table) -> Optional[Node]:
    """Rewrite string literals into dictionary-code constants against
    ``table``'s vocabularies (reference ``bind_strings``).  The sorted
    vocabulary makes every comparison operator order-correct."""
    from ..storage.strfuncs import bind_string_func, is_string_func

    if node is None:
        return None
    if isinstance(node, StringLiteral):
        raise ValidationError(
            f"String literal {node.canonical()} can only be used in a "
            "comparison with a string column"
        )
    if isinstance(node, Alias):
        return Alias(bind_strings(node.expr, table), node.name)
    if isinstance(node, BinaryOp):
        l, r = node.left, node.right
        if isinstance(l, StringLiteral) or isinstance(r, StringLiteral):
            if node.op not in _CMP_OPS:
                raise ValidationError(
                    "String literals only support comparison operators; "
                    f"got '{node.op}'"
                )
            lit, other = (l, r) if isinstance(l, StringLiteral) else (r, l)
            other_b = bind_strings(other, table)
            vocab = _vocab_of(other_b, table)
            if vocab is None or vocab.dtype.kind in "iu":
                raise ValidationError(
                    f"String literal {lit.canonical()} compared to "
                    "a non-string expression"
                )
            const = Constant(repr(literal_code(vocab, lit.text)))
            return BinaryOp(node.op, const if l is lit else other_b,
                            const if r is lit else other_b)
        if node.op in _CMP_OPS:
            l, r = bind_strings(l, table), bind_strings(r, table)
            lv, rv = _vocab_of(l, table), _vocab_of(r, table)
            if lv is not None and rv is not None and lv is not rv:
                if len(lv) != len(rv) or not np.array_equal(lv, rv):
                    raise ValidationError(
                        "Comparing string columns with different "
                        "dictionaries is only supported as a JOIN condition"
                    )
            elif (lv is None) != (rv is None):
                v = lv if lv is not None else rv
                if v.dtype.kind in "iu":
                    code = _int_literal_code(v, r if lv is not None else l)
                    if code is not None:
                        const = Constant(repr(code))
                        return BinaryOp(
                            node.op,
                            l if lv is not None else const,
                            const if lv is not None else r,
                        )
                    raise ValidationError(
                        "Comparing an int64 column beyond the int32 range "
                        "with a non-constant expression is not supported "
                        "(its device representation is dictionary codes); "
                        "compare against literals or JOIN on it"
                    )
                if isinstance(l, Variable) and isinstance(r, Variable):
                    raise ValidationError(
                        "Comparing a string column with a numeric column"
                    )
            return BinaryOp(node.op, l, r)
        lb, rb = bind_strings(l, table), bind_strings(r, table)
        if node.op not in ("&&", "||"):
            for side in (lb, rb):
                sv = _vocab_of(side, table)
                if sv is not None and sv.dtype.kind in "iu":
                    raise ValidationError(
                        "Arithmetic over an int64 column beyond the int32 "
                        "range is not supported (its values exceed the "
                        "exact f32 device range); use it as a key (GROUP "
                        "BY/JOIN/ORDER BY/comparisons) or pre-scale it at "
                        "load"
                    )
        return BinaryOp(node.op, lb, rb)
    if isinstance(node, LikePattern):
        like_expr = bind_strings(node.expr, table)
        vocab = _vocab_of(like_expr, table)
        if vocab is None:
            raise ValidationError(
                "LIKE requires a string column on its left side"
            )
        flags = re.IGNORECASE if getattr(node, "ci", False) else 0
        if getattr(node, "regex", False):
            try:
                rx = re.compile(node.pattern, flags)
            except re.error as e:
                raise ValidationError(
                    f"Invalid REGEXP pattern {node.pattern!r}: {e}"
                ) from None
            codes = tuple(i for i, s in enumerate(vocab) if rx.search(str(s)))
        else:
            rx = _like_regex(node.pattern, flags)
            codes = tuple(
                i for i, s in enumerate(vocab) if rx.fullmatch(str(s))
            )
        return InCodeSet(like_expr, codes, len(vocab))
    if isinstance(node, CaseWhen):
        return CaseWhen(
            tuple(bind_strings(c, table) for c in node.conditions),
            tuple(bind_strings(v, table) for v in node.values),
            bind_strings(node.default, table),
        )
    if isinstance(node, FunctionCall):
        fname = node.name.lower()
        if (
            fname in ("starts_with", "ends_with", "contains", "regexp_matches")
            and len(node.args) == 2
            and isinstance(node.args[1], StringLiteral)
        ):
            sexpr = bind_strings(node.args[0], table)
            vocab = _vocab_of(sexpr, table)
            if vocab is None:
                raise ValidationError(
                    f"{node.name.upper()} requires a string column as its "
                    "first argument"
                )
            pat = node.args[1].text
            if fname == "regexp_matches":
                try:
                    rx = re.compile(pat)
                except re.error as e:
                    raise ValidationError(
                        f"Invalid REGEXP pattern {pat!r}: {e}"
                    ) from None
                pred = lambda s: rx.search(s) is not None  # noqa: E731
            elif fname == "starts_with":
                pred = lambda s: s.startswith(pat)  # noqa: E731
            elif fname == "ends_with":
                pred = lambda s: s.endswith(pat)  # noqa: E731
            else:
                pred = lambda s: pat in s  # noqa: E731
            codes = tuple(i for i, s in enumerate(vocab) if pred(str(s)))
            return InCodeSet(sexpr, codes, len(vocab))
        if is_string_func(node.name):
            args = tuple(
                a if isinstance(a, StringLiteral) else bind_strings(a, table)
                for a in node.args
            )
            cm = bind_string_func(FunctionCall(node.name, args), table)
            if cm is not None:
                return cm
        bargs = tuple(bind_strings(a, table) for a in node.args)
        for a in bargs:
            fv = _vocab_of(a, table)
            if fv is not None and fv.dtype.kind in "iu":
                raise ValidationError(
                    f"{node.name.upper()} over an int64 column beyond the "
                    "int32 range is not supported (its device "
                    "representation is dictionary codes); use it as a key "
                    "(GROUP BY/JOIN/ORDER BY/comparisons)"
                )
        return FunctionCall(node.name, bargs)
    if isinstance(node, Aggregation):
        be = bind_strings(node.expr, table)
        if node.agg in (AggregationType.SUM, AggregationType.AVG,
                        AggregationType.MEDIAN, AggregationType.PERCENTILE):
            av = _vocab_of(be, table)
            if av is not None and av.dtype.kind in "iu":
                raise ValidationError(
                    f"{node.agg.name} over an int64 column beyond the int32 "
                    "range is not supported (its values exceed the exact "
                    "f32 device range); COUNT/MIN/MAX/COUNT(DISTINCT) and "
                    "key usage remain exact"
                )
        return Aggregation(node.agg, be, node.param)
    return node


def _bind_query_strings(query: Query, table) -> Query:
    """Bind string literals in every clause."""
    if not table.dicts and not any(
        isinstance(n, (StringLiteral, LikePattern))
        for item in [
            *query.select_list, query.where, query.having,
            *(t.expr for t in (query.order_by.terms if query.order_by else ())),
            *(query.group_by.keys if query.group_by else ()),
        ]
        if item is not None
        for n in walk(item)
    ):
        return query
    q = copy.copy(query)
    q.select_list = [bind_strings(s, table) for s in query.select_list]
    q.where = bind_strings(query.where, table)
    q.having = bind_strings(query.having, table)
    if query.order_by is not None:
        q.order_by = OrderBy(
            bind_strings(query.order_by.expr, table),
            query.order_by.ascending,
            tuple(OrderBy(bind_strings(t.expr, table), t.ascending)
                  for t in query.order_by.then),
        )
    if query.group_by is not None:
        q.group_by = GroupBy(
            tuple(bind_strings(k, table) for k in query.group_by.keys)
        )
    return q


# ---------------------------------------------------------------------------
# Scalar expression path (WarpDB::query semantics)
# ---------------------------------------------------------------------------


def run_expression(table, expr: Node, cond: Optional[Node]) -> np.ndarray:
    """Fused filter + projection; exactly ``num_rows`` f32 values
    (filtered-out rows 0.0).  A provably-false filter skips the device;
    a provably-true one is dropped."""
    _reject_nodes(expr)
    _reject_nodes(cond)
    expr = fold_constants(bind_strings(expr, table))
    if cond is not None:
        cond = fold_constants(bind_strings(cond, table))
        verdict = analyze_condition(cond, table.stats)
        if verdict is False:
            return np.zeros(table.num_rows, dtype=np.float32)
        if verdict is True:
            cond = None
    cols = table.row_columns()
    run = compile_filter_project(expr, cond, cols)
    return run(cols, table.num_rows).cpu().numpy()


# ---------------------------------------------------------------------------
# Relational path
# ---------------------------------------------------------------------------


def expand_stars_query(query: Query, table, catalog=None) -> list:
    """``*`` / ``t.*`` select items → columns (catalog-aware): over a
    join, the build sides' columns follow the probe's, unqualified where
    the name is free and qualified otherwise (the joined table's
    namespace).  Decorrelation joins (``__corr…``) are plumbing and add
    no columns."""
    if not any(isinstance(unalias(s), Star) for s in query.select_list):
        return query.select_list
    catalog = catalog or {}
    base_names = [n for n in table.dtypes if "." not in n]
    seen = set(base_names)
    join_names: dict = {}
    for join in query.joins:
        if join.table.startswith(_CORR_PREFIX):
            continue
        right = catalog.get(join.table, table)
        lst = join_names.setdefault(join.table, [])
        for n in right.dtypes:
            if "." in n:
                continue
            if n in seen:
                lst.append(f"{join.table}.{n}")
            else:
                lst.append(n)
                seen.add(n)
    out: list = []
    for s in query.select_list:
        node = unalias(s)
        if isinstance(node, Star):
            if node.table is None:
                out.extend(Variable(n) for n in base_names)
                for lst in join_names.values():
                    out.extend(Variable(n) for n in lst)
            elif node.table == query.from_table:
                out.extend(Variable(n) for n in base_names)
            elif node.table in join_names:
                out.extend(Variable(n) for n in join_names[node.table])
            else:
                raise ValidationError(f"Unknown table: {node.table}")
        else:
            out.append(s)
    return out


def _resolve_alias_catalog(query: Query, table, catalog):
    """The catalog extended with this statement's relation aliases
    (``FROM x AS a``, ``JOIN y AS b``) bound to their tables, so the
    join machinery works in alias names; a self-join gives two aliases
    of one table.  A copy: the given catalog, and its ``strict`` flag,
    stay as they are."""
    if query.from_source is None and not any(j.source for j in query.joins):
        return catalog
    catalog = copy.copy(catalog) if catalog is not None else {}
    if query.from_source is not None:
        catalog[query.from_table] = table  # the alias shadows a real name
    for j in query.joins:
        if j.source:
            catalog[j.table] = catalog.get(j.source, table)
    return catalog


def _is_strict(catalog) -> bool:
    """A catalog is strict once a table was registered: unknown relation
    names raise.  Plain-dict catalogs count as strict when they hold more
    than the primary and its ``t`` alias."""
    return getattr(catalog, "strict", len(catalog) > 2)


def _validate_relations(query: Query, catalog,
                        outer_names=frozenset()) -> None:
    """Every FROM / JOIN / subquery relation must be a catalog name once
    the catalog is strict (``_is_strict``); before that any name means
    the primary table, the reference's demo semantics.  Derived tables,
    set-op branches and subqueries are checked too; a subquery may name
    its outer relations (correlation), and the decorrelation joins are
    skipped."""
    if catalog is None or not _is_strict(catalog):
        return
    names = set(catalog) | set(outer_names)
    local: set = set()

    def check(real_name, alias=None):
        if real_name and real_name not in names:
            raise ValidationError(f"Unknown table: {real_name}")
        local.update(n for n in (real_name, alias) if n)

    if query.from_subquery is not None:
        _validate_relations(query.from_subquery, catalog, names)
        local.add(query.from_table)  # the derived table's alias
    else:
        check(query.from_source or query.from_table, query.from_table)
    for j in query.joins:
        if not j.table.startswith(_CORR_PREFIX):
            check(j.source or j.table, j.table)
    for _op, _all, branch in query.set_ops:
        _validate_relations(branch, catalog, names)
    for n in [*query.select_list, query.where, query.having, query.qualify,
              *(query.group_by.keys if query.group_by else ()),
              *(t.expr for t in (query.order_by.terms if query.order_by
                                 else ()))]:
        if n is None:
            continue
        for x in walk(n):
            if isinstance(x, (ScalarSubquery, InSubquery, ExistsSubquery)):
                _validate_relations(x.query, catalog, names | local)


def resolve_order_aliases(query: Query, columns=None) -> Query:
    """Rewrite ORDER BY terms and bare HAVING references naming a select
    alias into the aliased expression; GROUP BY keys resolve aliases when
    no input column has the name (reference ``resolve_order_aliases``).
    Returns ``query`` itself when nothing references an alias."""
    alias_map = {
        item.name: unalias(item)
        for item in query.select_list
        if isinstance(item, Alias)
    }
    if not alias_map:
        return query

    def is_alias_ref(e):
        return (isinstance(e, Variable) and e.qualifier is None
                and e.name in alias_map)

    changed = False
    new_order = query.order_by
    if query.order_by is not None:
        terms = [(alias_map[t.expr.name] if is_alias_ref(t.expr) else t.expr,
                  t.ascending) for t in query.order_by.terms]
        if any(is_alias_ref(t.expr) for t in query.order_by.terms):
            (e0, a0), *rest = terms
            new_order = OrderBy(e0, a0, tuple(OrderBy(e, a) for e, a in rest))
            changed = True

    new_having = query.having
    if query.having is not None:
        rewritten = transform(
            query.having,
            lambda n: alias_map[n.name] if is_alias_ref(n) else n,
            prune=(Aggregation,),
        )
        if rewritten is not query.having:
            new_having = rewritten
            changed = True

    new_group = query.group_by
    if columns is not None and query.group_by is not None:
        cols = set(columns)
        keys = [
            alias_map[k.name] if is_alias_ref(k) and k.name not in cols else k
            for k in query.group_by.keys
        ]
        if any(a is not b for a, b in zip(keys, query.group_by.keys)):
            new_group = GroupBy(tuple(keys))
            changed = True

    if not changed:
        return query
    query = copy.copy(query)
    query.order_by = new_order
    query.having = new_having
    query.group_by = new_group
    return query


def _dedup_rows(arrays: list, ordered: bool) -> list:
    """Host-side row dedup over aligned result columns (reference
    ``_dedup_rows``): with ``ordered`` the first occurrence wins, else
    rows emerge ascending.  NaNs compare equal."""
    if not arrays or len(arrays[0]) == 0:
        return list(arrays)
    cols = [np.asarray(a) for a in arrays]
    n = len(cols[0])
    order = np.lexsort(tuple(reversed(cols)))
    newgrp = np.zeros(n, dtype=bool)
    newgrp[0] = True
    for c in cols:
        s = c[order]
        a, b = s[1:], s[:-1]
        eq = a == b
        if c.dtype.kind == "f":
            eq |= np.isnan(a) & np.isnan(b)
        newgrp[1:] |= ~eq
    if ordered:
        starts = np.flatnonzero(newgrp)
        idx = np.sort(np.minimum.reduceat(order, starts))
    else:
        idx = order[newgrp]
    return [c[idx] for c in cols]


def _resolve_subqueries(query: Query, table, catalog):
    """The steps every query takes before its joins, in the reference's
    order: the facade-only and unsupported checks, ORDER BY / HAVING /
    GROUP BY aliases, relation names, the derived table, the alias
    catalog, decorrelation, then expression subqueries.  Returns
    ``(query', table', catalog')``."""
    _reject_facade_only(query)
    reject_unsupported(query)
    query = resolve_order_aliases(query, table.columns)
    _validate_relations(query, catalog)
    if query.from_subquery is not None:
        query, table = _resolve_from_subquery(query, table, catalog)
        # The derived table answers to its alias from here on, so the
        # query's later passes (the join's, each item's) find it.  The
        # reference leaves it out and raises "Unknown table" there.
        catalog = copy.copy(catalog) if catalog is not None else {}
        catalog[query.from_table] = table
    catalog = _resolve_alias_catalog(query, table, catalog)
    query, catalog = _decorrelate_subqueries(query, table, catalog)
    query = _resolve_expr_subqueries(query, table, catalog)
    return query, table, catalog or {}


def _join_rewrites(query: Query, table, catalog):
    """The join rewrites before materialisation: implicit joins, theta
    residuals, build-side then probe-side WHERE pushdown (removing
    single-relation conjuncts can leave an all-probe WHERE), the eager
    aggregation.  Returns ``(query', probe', catalog')``."""
    query = jx._lift_implicit_join_conditions(query, table, catalog)
    query = jx._split_join_residuals(query)
    query, catalog = jx._pushdown_build_filters(query, table, catalog)
    query, table = jx._pushdown_join_where(query, table, catalog)
    if query.group_by is not None:
        rewritten = jx._try_eager_join_aggregate(query, table, catalog)
        if rewritten is not None:
            query, catalog = rewritten
    return query, table, catalog


def run_query(query: Query, table, catalog: Optional[dict] = None
              ) -> np.ndarray:
    """Execute a parsed SELECT against ``table`` (the FROM relation,
    resolved by the facade); JOIN relations resolve through ``catalog``
    (an unknown name means ``table`` itself, the reference's demo
    semantics).  Returns the first select item's values (the reference's
    single-vector contract)."""
    query, table, catalog = _resolve_subqueries(query, table, catalog)
    if any(isinstance(s, Alias) for s in query.select_list):
        query = copy.copy(query)
        query.select_list = [unalias(s) for s in query.select_list]
    expanded = expand_stars_query(query, table, catalog)
    if expanded is not query.select_list:
        query = copy.copy(query)
        query.select_list = expanded

    if query.joins:
        query, table, catalog = _join_rewrites(query, table, catalog)
        table = jx._materialize_joins(query, table, catalog)

    query = _bind_query_strings(query, table)
    if not query.select_list:
        raise ExecutionError("Empty SELECT list")

    if query.where is not None:
        where = fold_constants(query.where)
        verdict = analyze_condition(where, table.stats)
        is_global_agg = query.group_by is None and any(
            isinstance(n, Aggregation) for n in walk(query.select_list[0])
        )
        if verdict is False and not is_global_agg:
            return np.zeros(0, dtype=np.float32)  # filter eliminates all rows
        query = copy.copy(query)
        query.where = None if verdict is True else where

    if query.group_by is not None:
        values = _run_grouped(query, table)
        if query.distinct:
            values = _dedup_rows([values], ordered=query.order_by is not None)[0]
    else:
        values = _run_projection(query, table)

    if query.offset is not None:
        values = values[query.offset:] if query.offset < len(values) else values[:0]
    if query.limit is not None and query.limit < len(values):
        values = values[: query.limit]
    return values


def result_column_name(item, i: int, taken) -> str:
    """Output column name of a select item: its alias, else its
    canonical form without the ``[idx]`` suffix; a name already taken
    gets ``_i``."""
    if isinstance(item, Alias):
        name = item.name
    else:
        name = item.canonical()
        if name.endswith("[idx]"):
            name = name[: -len("[idx]")]
    if name in taken:
        name = f"{name}_{i}"
    return name


def result_column_names(select_list) -> list:
    """``result_column_name`` of every item, in order."""
    names: list = []
    for i, item in enumerate(select_list):
        names.append(result_column_name(item, i, set(names)))
    return names


def _slice_rows(vals, query: Query):
    """OFFSET, then LIMIT, on the host."""
    if query.offset is not None:
        vals = vals[query.offset:] if query.offset < len(vals) else vals[:0]
    if query.limit is not None and query.limit < len(vals):
        vals = vals[: query.limit]
    return vals


def _where_verdict(query: Query, table):
    """``query`` with its WHERE folded and, where stats decide it,
    dropped; None when the WHERE provably keeps no row."""
    if query.where is None:
        return query
    where = fold_constants(query.where)
    verdict = analyze_condition(where, table.stats)
    if verdict is False:
        return None
    query = copy.copy(query)
    query.where = None if verdict is True else where
    return query


def run_query_table(query: Query, table, catalog: Optional[dict] = None
                    ) -> dict:
    """Execute a SELECT returning every select item as a named column
    (``result_column_name``), rows aligned across columns (reference
    ``run_query_table``).  Multi-column DISTINCT without aggregates
    becomes GROUP BY over the select list; DISTINCT over aggregates
    deduplicates the finished rows on the host."""
    query, table, catalog = _resolve_subqueries(query, table, catalog)
    expanded = expand_stars_query(query, table, catalog)
    if expanded is not query.select_list:
        query = copy.copy(query)
        query.select_list = expanded

    if query.joins:
        # Materialise the join chain once; the join-free rest runs on
        # the joined table.
        query, table, catalog = _join_rewrites(query, table, catalog)
        joined = jx._materialize_joins(query, table, catalog)
        q2 = copy.copy(query)
        q2.joins = ()
        return run_query_table(q2, joined, catalog)

    items = [unalias(s) for s in query.select_list]
    if query.distinct and (len(items) > 1 or query.group_by is not None):
        if query.group_by is None and not any(
            isinstance(n, Aggregation) for it in items for n in walk(it)
        ):
            # SELECT DISTINCT a, b ≡ SELECT a, b GROUP BY a, b.
            keys = {it.canonical(): it for it in items}
            query = copy.copy(query)
            query.distinct = False
            query.group_by = GroupBy(tuple(keys.values()))
        else:
            q2 = copy.copy(query)
            q2.distinct = False
            q2.limit = q2.offset = None
            out = run_query_table(q2, table, catalog)
            deduped = _dedup_rows(list(out.values()),
                                  ordered=query.order_by is not None)
            return {k: _slice_rows(v, query) for k, v in zip(out, deduped)}

    names = result_column_names(query.select_list)
    if query.group_by is not None:
        # One grouped pass serves every select item.
        q = _where_verdict(_bind_query_strings(query, table), table)
        if q is None:
            return {n: np.zeros(0, np.float32) for n in names}
        cols = _run_grouped_multi(q, table, [unalias(s) for s in
                                             q.select_list])
        return {n: _slice_rows(v, query) for n, v in zip(names, cols)}

    if len(items) > 1 and not any(
        isinstance(n, Aggregation) for it in items for n in walk(it)
    ):
        # Non-grouped, join-free multi-item SELECT: one mask, one sort.
        q = _where_verdict(query, table)
        if q is None:
            return {n: np.zeros(0, np.float32) for n in names}
        q = _bind_query_strings(q, table)
        cols = _run_projection_multi(q, table,
                                     [unalias(s) for s in q.select_list])
        return {n: _slice_rows(v, query) for n, v in zip(names, cols)}

    out = {}
    for name, item in zip(names, query.select_list):
        q = copy.copy(query)
        q.select_list = [item]
        out[name] = run_query(q, table, catalog)
    return out


def _run_projection_multi(query: Query, table, select_items: list) -> list:
    """Non-grouped multi-item SELECT: every item over one WHERE mask,
    carried through one stable sort (ORDER BY) or the mask's order;
    row-aligned by construction (reference ``_run_projection_multi``)."""
    raw_specs = [raw_int_item(s, table) for s in select_items]
    outs = [_row_values(s, table, r) for s, r in zip(select_items, raw_specs)]
    valid = _where_mask(query, table)
    order = query.order_by
    if order is None:
        if valid is not None:
            outs = [o[valid] for o in outs]
    else:
        count = table.num_rows if valid is None else int(valid.sum())
        if query.limit is not None:
            count = min(count, query.limit + (query.offset or 0))
        perm = lexsort([
            order_key(_order_operand(t, table), valid if i == 0 else None,
                      t.ascending)
            for i, t in enumerate(order.terms)
        ])[:count]
        outs = [o[perm] for o in outs]
    return [o.cpu().numpy().astype(np.float32 if r is None else r[1])
            for o, r in zip(outs, raw_specs)]


def _row_values(item, table, raw_spec):
    cols = table.row_columns()
    if raw_spec is not None:
        return broadcast(raw_spec[0](cols), table.num_rows)
    return broadcast(_as_f32(build_evaluator(item)(cols)), table.num_rows)


def _where_mask(query, table):
    if query.where is None:
        return None
    cols = table.row_columns()
    return broadcast(_as_bool(build_evaluator(query.where)(cols)),
                     table.num_rows)


def _order_operand(term, table) -> torch.Tensor:
    """An ORDER BY key: raw for bare INT columns (exact), else f32."""
    return _row_values(term.expr, table, raw_int_item(term.expr, table))


def _run_projection(query: Query, table) -> np.ndarray:
    """Non-grouped SELECT of one item: projection, WHERE, ORDER BY (top-k
    or full sort), DISTINCT; one device→host transfer."""
    select = query.select_list[0]
    if isinstance(select, Aggregation):
        return _run_global_agg(query, table)
    if any(isinstance(n, Aggregation) for n in walk(select)):
        return _run_global_agg_expr(query, table)
    if query.distinct:
        return _run_distinct(query, table, select)

    order = query.order_by
    order_terms = order.terms if order is not None else ()
    single_term = len(order_terms) == 1
    same_expr = single_term and order_terms[0].expr.canonical() == select.canonical()
    limit_total = (query.limit or 0) + (query.offset or 0)
    # The value-space top-k cannot represent the NaN total order, so it
    # only runs when stats prove the order key finite.
    order_nan_free = bool(
        single_term and expr_range(order_terms[0].expr, table.stats) is not None
    )
    raw_spec = raw_int_item(select, table)
    use_topk = (
        same_expr
        and order_nan_free
        and query.limit is not None
        and 0 < limit_total < table.padded_rows // 2
        and raw_spec is None
    )
    out_dtype = np.float32 if raw_spec is None else raw_spec[1]
    vals = _row_values(select, table, raw_spec)
    valid = _where_mask(query, table)
    count = table.num_rows if valid is None else int(valid.sum())

    if order is None:
        out = vals if valid is None else vals[valid]
    elif use_topk:
        out = top_k_values(vals, valid, _next_pow2(max(limit_total, 16)),
                           order.ascending)
        out = out[: min(limit_total, count)]
    else:
        if same_expr:
            out = sort_values(vals, valid, order.ascending)
        elif single_term:
            out, _ = sort_pairs(_order_operand(order_terms[0], table), vals,
                                valid, order.ascending)
        else:
            keys = [(_order_operand(t, table), t.ascending) for t in order_terms]
            out = sort_by_keys(keys, vals, valid)
        end = count if query.limit is None else min(count, limit_total)
        out = out[:end]
    return out.cpu().numpy().astype(out_dtype)


def _run_distinct(query: Query, table, select) -> np.ndarray:
    """SELECT DISTINCT of one item, ascending (reference host sort+unique
    order); ORDER BY … DESC reverses it.  A stats-bounded integral item
    groups through the slot-table ladder; otherwise one sort."""
    order = query.order_by
    raw_spec = raw_int_item(select, table)
    out_dtype = np.float32 if raw_spec is None else raw_spec[1]
    dres = _try_dense_group(query, table, [select], [Constant("1")], ["1.0f"],
                            need=())
    if dres is not None:
        values = np.asarray(dres.keys[0]).astype(out_dtype)
    else:
        vals = _row_values(select, table, raw_spec)
        valid = _where_mask(query, table)
        x = vals if valid is None else vals[valid]
        if x.numel():
            k = sort_key_any(x)
            perm = torch.sort(k, stable=True).indices
            ks = k[perm]
            first = torch.ones_like(ks, dtype=torch.bool)
            first[1:] = ks[1:] != ks[:-1]
            x = x[perm][first]
        values = x.cpu().numpy().astype(out_dtype)
    if order is not None and not order.ascending:
        values = values[::-1].copy()
    return values


def _global_agg_value(agg, param, vals, valid):
    """One global aggregate over f32 ``vals`` and the row mask ``valid``
    (reference ``_global_agg_value``).  Counts accumulate in integers."""
    cnt_i = valid.sum()
    cnt = cnt_i.to(_F32)
    if agg == "count_nullsub":
        nulls = torch.where(valid, vals, 0.0).sum().to(torch.int64)
        return (cnt_i - nulls).to(_F32)
    if agg is AggregationType.COUNT_DISTINCT:
        return count_distinct((vals,), valid).to(_F32)
    if vals.numel() == 0 and agg in (
        AggregationType.MIN, AggregationType.MAX,
        AggregationType.MEDIAN, AggregationType.PERCENTILE,
    ):
        # An empty table: these reductions need at least one element.
        empty = {AggregationType.MIN: float("inf"),
                 AggregationType.MAX: float("-inf")}.get(agg, float("nan"))
        return torch.tensor(empty, dtype=_F32)
    if agg in (AggregationType.MEDIAN, AggregationType.PERCENTILE):
        v = sort_values(vals, valid, ascending=True)
        c = torch.clamp(cnt_i, min=1)
        q = 0.5 if agg is AggregationType.MEDIAN else float(param)
        pos = q * (c - 1).to(_F32)
        lo_off = torch.floor(pos).to(torch.int64)
        frac = pos - lo_off.to(_F32)
        last = v.shape[0] - 1
        lo = v[torch.clamp(lo_off, 0, last)]
        hi = v[torch.clamp(torch.minimum(lo_off + 1, c - 1), 0, last)]
        return lo * (1.0 - frac) + hi * frac
    if agg is AggregationType.COUNT:
        return cnt
    if agg is AggregationType.SUM:
        return torch.where(valid, vals, 0.0).sum()
    if agg is AggregationType.AVG:
        return torch.where(valid, vals, 0.0).sum() / torch.clamp(cnt, min=1.0)
    if agg is AggregationType.MIN:
        return torch.where(valid, vals, float("inf")).amin()
    if agg is AggregationType.MAX:
        return torch.where(valid, vals, float("-inf")).amax()
    raise ExecutionError(f"Unknown aggregation {agg}")


def _count_rewrite(agg, expr, table=None):
    """SQL COUNT(expr) skips NULLs: stats-proven non-NULL columns keep the
    exact row count, else ``cnt − SUM(IsNull(expr))``."""
    from ..frontend.ast import NotNull

    if agg is AggregationType.COUNT and not isinstance(
        unalias(expr), (Star, Constant)
    ):
        if _provably_not_null(expr, table):
            return AggregationType.COUNT, expr
        return "count_nullsub", NotNull(expr, negated=True)
    return agg, expr


def _global_inputs(query, table):
    valid = _where_mask(query, table)
    if valid is None:
        valid = torch.ones(table.num_rows, dtype=torch.bool,
                           device=table.device)
    return table.row_columns(), valid


def _run_global_agg(query: Query, table) -> np.ndarray:
    """SELECT AGG(expr) with no GROUP BY → one scalar."""
    select = query.select_list[0]
    cols, valid = _global_inputs(query, table)
    agg, expr = _count_rewrite(select.agg, select.expr, table)
    vals = broadcast(_as_f32(build_evaluator(expr)(cols)), table.num_rows)
    out = _global_agg_value(agg, select.param, vals, valid)
    return np.asarray([float(out)], dtype=np.float32)


def _run_global_agg_expr(query: Query, table) -> np.ndarray:
    """SELECT <expression over aggregates> with no GROUP BY: every
    aggregate in one pass, then the arithmetic on the host scalars."""
    select = query.select_list[0]
    specs = _collect_agg_specs([select])
    cols, valid = _global_inputs(query, table)
    agg_values = {}
    for s in specs:
        agg, expr = _count_rewrite(s.agg, s.expr, table)
        vals = broadcast(_as_f32(build_evaluator(expr)(cols)), table.num_rows)
        out = _global_agg_value(agg, s.param, vals, valid)
        agg_values[s.key] = np.float32(float(out))
    val = _group_level_eval(select, {}, agg_values)
    return np.asarray([val], dtype=np.float32).reshape(1)
