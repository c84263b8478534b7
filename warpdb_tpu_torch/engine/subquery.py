"""Derived tables, expression subqueries and decorrelation.

Counterpart of ``warpdb_tpu/engine/executor.py:453-1354``:

* ``materialize_query_table`` lands a query's result as a fresh
  ``DeviceTable`` on the device of the relation it read (derived tables,
  CTEs and the decorrelated build sides all go through it);
* ``_resolve_from_subquery``: ``FROM (SELECT …) AS alias``;
* ``_resolve_expr_subqueries``: uncorrelated scalar, ``IN``, ``EXISTS``
  and ``ANY``/``ALL`` subqueries become constants, value sets and
  literal comparisons before plan lowering;
* ``_decorrelate_subqueries``: correlated ``EXISTS``, ``IN`` and scalar
  aggregate subqueries become grouped derived tables, LEFT-joined as
  ``__corr{i}`` through the join path.

Materialised tables are memoised on the table they were computed from
(``_subq_memo``), keyed by ``query_dep_key``.  Results round-trip
through the host as the reference's do: strings decode and re-encode
with a fresh vocabulary, other columns become f32.
"""

from __future__ import annotations

import copy
import dataclasses
from collections import OrderedDict

import numpy as np

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
    Constant,
    ExistsSubquery,
    FunctionCall,
    GroupBy,
    InSubquery,
    InValueSet,
    Join,
    Node,
    OrderBy,
    QuantifiedComparison,
    Query,
    ScalarSubquery,
    Star,
    StringLiteral,
    Variable,
    transform,
    unalias,
    walk,
)
from ..storage.strings import decode_codes, literal_code
from ..storage.table import DataType, DeviceTable, HostTable
from . import udf as udf_mod
from .join_exec import _and_chain, _and_conjuncts, _table_uid

_CORR_PREFIX = "__corr"
_IN_SUBQUERY_MAX_VALUES = 65536
_IN_SUBQUERY_MAX_STRINGS = 1024
_MEMO_ENTRIES = 4


def _clause_nodes(query: Query) -> list:
    return [
        *query.select_list, query.where, query.having,
        *(query.group_by.keys if query.group_by else ()),
        *(t.expr for t in (query.order_by.terms if query.order_by else ())),
    ]


def _map_query_exprs(query: Query, fn) -> Query:
    """A copy of ``query`` with ``fn`` applied to every clause expression
    (select items, WHERE, HAVING, GROUP BY keys, ORDER BY terms)."""
    q2 = copy.copy(query)
    q2.select_list = [fn(s) for s in query.select_list]
    q2.where = None if query.where is None else fn(query.where)
    q2.having = None if query.having is None else fn(query.having)
    if query.group_by is not None:
        q2.group_by = dataclasses.replace(
            query.group_by, keys=tuple(fn(k) for k in query.group_by.keys)
        )
    if query.order_by is not None:
        (e0, a0), *rest = [(fn(t.expr), t.ascending)
                           for t in query.order_by.terms]
        q2.order_by = OrderBy(e0, a0, tuple(OrderBy(e, a) for e, a in rest))
    return q2


def _from_relation(q: Query, catalog, default):
    """A query's FROM relation through the catalog, honouring a FROM
    alias (``FROM sales AS s`` looks up "sales")."""
    return (catalog or {}).get(q.from_source or q.from_table, default)


def query_dep_key(q: Query, base, catalog) -> tuple:
    """Memo-key tail of everything that can change a materialised
    result: the plan canonical, the base and every joined table
    instance (tables are immutable, so identity is content), each
    set-op branch's relations, and the UDF registry version."""
    catalog = catalog or {}

    def join_uids(query):
        return tuple(
            (j.table, _table_uid(catalog.get(j.source or j.table, base)))
            for j in query.joins
        )

    branch_uids = tuple(
        ((b.from_table, _table_uid(_from_relation(b, catalog, base))),)
        + join_uids(b)
        for _op, _all, b in q.set_ops
    )
    return (q.canonical(), _table_uid(base), join_uids(q), branch_uids,
            udf_mod.registry_version())


def _memoised(owner, key, make, attr="_subq_memo", entries=_MEMO_ENTRIES):
    """``make()`` memoised on ``owner.<attr>``, an LRU of ``entries``."""
    memo = getattr(owner, attr, None)
    if memo is None:
        memo = OrderedDict()
        setattr(owner, attr, memo)
    hit = memo.get(key)
    if hit is not None:
        memo.move_to_end(key)
        return hit
    hit = memo[key] = make()
    while len(memo) > entries:
        memo.popitem(last=False)
    return hit


def decode_table(query: Query, base, catalog):
    """The relation ``query``'s result decodes against: its derived
    table when the FROM is a subquery (a memo hit once the query ran;
    its strings carry a fresh vocabulary), else ``base``."""
    if query.from_subquery is None:
        return base
    return _resolve_from_subquery(query, base, catalog)[1]


def materialize_query_table(sub: Query, base, catalog) -> DeviceTable:
    """Run ``sub`` against ``base`` and land the result as a fresh
    DeviceTable on ``base``'s device (stats computed, so stats-gated
    paths stay live downstream).  Every column ``decode_result_column``
    decodes to strings re-encodes with a fresh vocabulary; the others
    become f32."""
    from ..api import decode_result_column
    from .executor import (
        _resolve_alias_catalog,
        expand_stars_query,
        run_query_table,
    )

    out = run_query_table(sub, base, catalog)
    dbase = decode_table(sub, base, catalog)
    dcat = _resolve_alias_catalog(sub, dbase, catalog)
    items = expand_stars_query(sub, dbase, dcat)
    arrays: dict = {}
    dtypes: dict = {}
    for item, (name, vals) in zip(items, out.items()):
        decoded = decode_result_column(
            item, np.asarray(vals, np.float32), dbase, dcat, sub.joins
        )
        if decoded and isinstance(decoded[0], str):
            arrays[name] = np.asarray(decoded, dtype=object)
            dtypes[name] = DataType.STRING
        else:
            arrays[name] = np.asarray(vals, np.float32)
    return DeviceTable.from_host(
        HostTable.from_dict(arrays, dtypes=dtypes or None), device=base.device
    )


def _resolve_from_subquery(query: Query, table, catalog):
    """Materialise a derived table (``FROM (SELECT …) AS alias``), memoised
    on ``table``; returns ``(query without the subquery, derived)``."""
    from .executor import result_column_names

    sub = query.from_subquery
    base = _from_relation(sub, catalog, table)
    # canonical() drops aliases; the derived schema is alias-named.
    mkey = (tuple(result_column_names(sub.select_list)),) + query_dep_key(
        sub, base, catalog
    )
    derived = _memoised(table, mkey,
                        lambda: materialize_query_table(sub, base, catalog))
    q2 = copy.copy(query)
    q2.from_subquery = None
    return q2, derived


# ---------------------------------------------------------------------------
# Uncorrelated expression subqueries
# ---------------------------------------------------------------------------


def _resolve_expr_subqueries(query: Query, table, catalog) -> Query:
    """Resolve uncorrelated expression subqueries before plan lowering:

    * scalar ``(SELECT …)`` → a ``Constant`` (numbers round through f32,
      wide-int64 values stay exact Python ints, no row → NaN) or a
      ``StringLiteral``;
    * numeric ``expr IN (SELECT …)`` → ``InValueSet`` (deduplicated,
      NaN-free); over a wide-int64 column, its codes; string values →
      an OR-chain of literal equalities;
    * ``EXISTS`` → ``Constant`` 1/0;
    * ``expr op ANY|ALL (SELECT …)`` → a min/max bound comparison, IN /
      NOT IN, or a constant (empty set: ANY false, ALL true)."""
    if not any(
        n is not None and any(
            isinstance(x, (ScalarSubquery, InSubquery, ExistsSubquery,
                           QuantifiedComparison))
            for x in walk(n)
        )
        for n in _clause_nodes(query)
    ):
        return query
    from ..api import _column_vocab
    from .executor import _resolve_alias_catalog, _vocab_of, run_query_table

    def exec_sub(q):
        base = _from_relation(q, catalog, table)
        out = run_query_table(q, base, catalog)
        if len(out) != 1:
            raise ValidationError(
                "Subquery used as a value must select exactly one column"
            )
        ((_name, vals),) = out.items()
        vals = np.asarray(vals)
        node = unalias(q.select_list[0]) if q.select_list else None
        if isinstance(node, Aggregation) and node.agg in (
            AggregationType.MIN, AggregationType.MAX,
        ):
            node = node.expr
        vocab = None
        if isinstance(node, Variable) and q.from_subquery is None:
            vocab = _column_vocab(node, base,
                                  _resolve_alias_catalog(q, base, catalog),
                                  q.joins)
        if vocab is not None:
            if vals.dtype.kind == "f" and not np.all(np.isfinite(vals)):
                raise ExecutionError(
                    "String subquery produced a non-finite sentinel "
                    "(empty aggregate has no string form)"
                )
            # Wide-int64 columns decode to Python ints: numeric, exact.
            return decode_codes(vals, vocab), vocab.dtype.kind not in "iu"
        return vals, False

    def scalar(node: ScalarSubquery):
        vals, is_str = exec_sub(node.query)
        if len(vals) > 1:
            raise ExecutionError(f"Scalar subquery returned {len(vals)} rows")
        if is_str:
            if len(vals) == 0:
                raise ExecutionError("Scalar string subquery returned no rows")
            return StringLiteral(str(vals[0]))
        if len(vals) == 0:
            return Constant("nan")
        v0 = vals[0]
        if v0 is None:
            return Constant("nan")  # wide-int64 NULL (a join miss)
        if isinstance(v0, (int, np.integer)):
            return Constant(repr(int(v0)))
        return Constant(repr(float(np.float32(v0))))

    def in_set(node: InSubquery):
        expr = rw(node.expr)
        vals, is_str = exec_sub(node.query)
        if is_str:
            uniq = sorted(set(str(v) for v in vals))
            if len(uniq) > _IN_SUBQUERY_MAX_STRINGS:
                raise UnsupportedError(
                    f"IN (SELECT …) with {len(uniq)} distinct strings "
                    f"(max {_IN_SUBQUERY_MAX_STRINGS}) — use a JOIN"
                )
            if not uniq:
                return Constant("0")  # empty set: matches nothing
            out = None
            for s in uniq:
                eq = BinaryOp("==", expr, StringLiteral(s))
                out = eq if out is None else BinaryOp("||", out, eq)
            return out
        vlist = [v for v in vals if v is not None]
        if vlist and all(isinstance(v, (int, np.integer)) for v in vlist):
            ev = _vocab_of(expr, table)
            if ev is not None and ev.dtype.kind in "iu":
                # A coded wide-int outer column: the set in its code
                # space (exact for members, no match for the rest).
                arr = sorted({literal_code(ev, int(v)) for v in vlist})
                if len(arr) > _IN_SUBQUERY_MAX_VALUES:
                    raise UnsupportedError(
                        f"IN (SELECT …) with {len(arr)} distinct values "
                        f"(max {_IN_SUBQUERY_MAX_VALUES}) — use a JOIN"
                    )
                return InValueSet(expr, tuple(arr))
            # The set compares in f32: only ints f32 represents exactly
            # can equal an outer value.  Compared as Python ints; the
            # reference compares in f64, where 2^53 + 1 passes.
            vlist = [v for v in vlist if int(np.float32(v)) == int(v)]
        arr = np.unique(np.asarray(vlist, np.float32))
        arr = arr[~np.isnan(arr)]
        if arr.shape[0] > _IN_SUBQUERY_MAX_VALUES:
            raise UnsupportedError(
                f"IN (SELECT …) with {arr.shape[0]} distinct values "
                f"(max {_IN_SUBQUERY_MAX_VALUES}) — use a JOIN"
            )
        return InValueSet(expr, tuple(float(v) for v in arr))

    def exists(node: ExistsSubquery):
        q = copy.copy(node.query)
        if q.limit is None or q.limit > 1:
            q.limit = 1  # existence needs at most one row
        out = run_query_table(q, _from_relation(q, catalog, table), catalog)
        return Constant("1" if len(next(iter(out.values()), ())) else "0")

    def quantified(node: QuantifiedComparison):
        expr = rw(node.expr)
        op = "==" if node.op == "=" else node.op
        if op == "==" and node.quantifier == "ANY":
            return in_set(InSubquery(expr, node.query))
        vals, is_str = exec_sub(node.query)
        if is_str:
            items = sorted(str(v) for v in vals)
            empty = not items
        else:
            arr = np.asarray(vals, np.float32)
            arr = arr[~np.isnan(arr)]
            empty = arr.shape[0] == 0
        if empty:
            return Constant("0" if node.quantifier == "ANY" else "1")

        def lit(v):
            if is_str:
                return StringLiteral(str(v))
            return Constant(repr(float(np.float32(v))))

        if is_str:
            lo, hi = items[0], items[-1]
            n_distinct = len(set(items))
        else:
            lo, hi = float(arr.min()), float(arr.max())
            n_distinct = int(np.unique(arr).shape[0])
        if op == "!=":
            if node.quantifier == "ALL":
                positive = in_set(InSubquery(expr, node.query))
                return BinaryOp("==", positive, Constant("0"))  # NOT IN
            if n_distinct > 1:
                return Constant("1")  # some element always differs
            return BinaryOp("!=", expr, lit(lo))
        if op == "==":  # = ALL
            if n_distinct > 1:
                return Constant("0")
            return BinaryOp("==", expr, lit(lo))
        bound = {
            (">", "ANY"): lo, (">=", "ANY"): lo,
            ("<", "ANY"): hi, ("<=", "ANY"): hi,
            (">", "ALL"): hi, (">=", "ALL"): hi,
            ("<", "ALL"): lo, ("<=", "ALL"): lo,
        }[(op, node.quantifier)]
        return BinaryOp(op, expr, lit(bound))

    resolvers = {ScalarSubquery: scalar, InSubquery: in_set,
                 ExistsSubquery: exists, QuantifiedComparison: quantified}

    def rw(node):
        return transform(
            node, lambda n: resolvers[type(n)](n) if type(n) in resolvers
            else n
        )

    return _map_query_exprs(query, rw)


# ---------------------------------------------------------------------------
# Correlated subqueries
# ---------------------------------------------------------------------------


def _decorrelate_subqueries(query: Query, table, catalog):
    """Rewrite single-level correlated expression subqueries into LEFT
    joins against grouped derived tables (one grouped build and one
    lookup, instead of a rescan per outer row):

    * ``[NOT] EXISTS (SELECT … FROM u WHERE u.k = t.k [AND …])`` → derived
      ``SELECT k, COUNT(*) AS __hit … GROUP BY k``; EXISTS becomes
      ``__hit IS NOT NULL`` after the LEFT join.  One ``u.c <> t.c``
      conjunct is allowed (TPC-H q21): per-group MIN and MAX of ``u.c``
      decide it (a row differs unless min = max = the outer value);
    * scalar ``(SELECT f(AGG(x), …) FROM u WHERE u.k = t.k [AND …])`` →
      each aggregate a derived column; COUNT over no match is 0, other
      aggregates NaN;
    * ``e [NOT] IN (SELECT x FROM u WHERE u.k = t.k …)`` (bare columns)
      → an EXISTS keyed on ``x`` too.

    Correlation predicates are top-level AND-ed column equalities; NaN
    keys never match.  Returns ``(query', catalog')``."""
    sub_nodes: list = []
    seen_ids = set()
    for n in _clause_nodes(query):
        if n is None:
            continue
        for x in walk(n):
            if (isinstance(x, (ScalarSubquery, InSubquery, ExistsSubquery))
                    and id(x) not in seen_ids):
                seen_ids.add(id(x))
                sub_nodes.append(x)
    if not sub_nodes:
        return query, catalog

    catalog = catalog or {}
    # The outer namespace: the FROM relation's columns and every joined
    # relation's, free and qualified (the joined table's namespace).
    outer_rels = {query.from_table} | {j.table for j in query.joins}
    outer_cols = set()
    for n in table.dtypes:
        outer_cols.add(n)
        outer_cols.add(n.rsplit(".", 1)[-1])
    for j in query.joins:
        for n in catalog.get(j.table, table).dtypes:
            outer_cols.add(n.rsplit(".", 1)[-1])
            outer_cols.add(f"{j.table}.{n.rsplit('.', 1)[-1]}")

    def inner_namespace(sub: Query):
        """(relation names, column names) of the subquery's own scope;
        an unknown FROM name means the outer table."""
        rels = {sub.from_table} | {j.table for j in sub.joins}
        if sub.from_source:
            rels.add(sub.from_source)
        cols = set()
        for n in catalog.get(sub.from_source or sub.from_table, table).dtypes:
            cols.add(n)
            cols.add(n.rsplit(".", 1)[-1])
            cols.add(f"{sub.from_table}.{n.rsplit('.', 1)[-1]}")
        for j in sub.joins:
            jt = catalog.get(j.source or j.table)
            if jt is not None:
                for n in jt.dtypes:
                    cols.add(n.rsplit(".", 1)[-1])
                    cols.add(f"{j.table}.{n.rsplit('.', 1)[-1]}")
        return rels, cols

    def is_outer(v: Variable, inner_rels, inner_cols) -> bool:
        if v.qualifier is not None:
            if v.qualifier in inner_rels:
                return False
            return v.qualifier in outer_rels
        if v.name in inner_cols:
            return False  # the inner scope shadows the outer
        return v.name in outer_cols

    def outer_refs_in(node, inner_rels, inner_cols) -> list:
        if node is None:
            return []
        return [v for v in walk(node) if isinstance(v, Variable)
                and is_outer(v, inner_rels, inner_cols)]

    replacements: dict = {}
    new_joins: list = []
    derived_tables: dict = {}

    def decorrelate_one(node) -> None:
        sub = node.query
        inner_rels, inner_cols = inner_namespace(sub)
        non_where = [
            *sub.select_list, sub.having,
            *(sub.group_by.keys if sub.group_by else ()),
            *(t.expr for t in (sub.order_by.terms if sub.order_by else ())),
        ]
        where_refs = outer_refs_in(sub.where, inner_rels, inner_cols)
        other_refs = [r for n in non_where
                      for r in outer_refs_in(n, inner_rels, inner_cols)]
        if not where_refs and not other_refs:
            return  # uncorrelated: _resolve_expr_subqueries owns it
        if other_refs:
            raise UnsupportedError(
                "Correlated subqueries may reference outer columns only "
                "in WHERE equality predicates (got outer reference "
                f"{other_refs[0].name} elsewhere)"
            )
        if (sub.group_by is not None or sub.having is not None
                or sub.set_ops or sub.ctes):
            raise UnsupportedError(
                "Correlated subqueries do not support their own "
                "GROUP BY/HAVING/set operations"
            )

        pairs: list = []  # (inner Variable, outer Variable)
        neq_pairs: list = []  # the same for one <> conjunct
        residual: list = []
        for c in _and_conjuncts(sub.where):
            if not outer_refs_in(c, inner_rels, inner_cols):
                residual.append(c)
                continue
            ok = (isinstance(c, BinaryOp) and isinstance(c.left, Variable)
                  and isinstance(c.right, Variable)
                  and c.op in ("=", "==", "!="))
            if ok:
                lo = is_outer(c.left, inner_rels, inner_cols)
                ro = is_outer(c.right, inner_rels, inner_cols)
                ok = lo != ro
            if not ok:
                raise UnsupportedError(
                    "Correlated subquery predicates must be column "
                    f"equalities (inner.col = outer.col); got: "
                    f"{c.canonical()}"
                )
            inner_v, outer_v = (c.right, c.left) if lo else (c.left, c.right)
            if c.op == "!=":
                # Two <> conjuncts would need one row witnessing both,
                # which per-group marginals cannot show.
                if not isinstance(node, ExistsSubquery) or neq_pairs:
                    raise UnsupportedError(
                        "Correlated <> predicates are supported only in "
                        "EXISTS subqueries, at most one per subquery; "
                        f"got: {c.canonical()}"
                    )
                neq_pairs.append((inner_v, outer_v))
            else:
                pairs.append((inner_v, outer_v))
        if neq_pairs and not pairs:
            raise UnsupportedError(
                "Correlated EXISTS with a <> predicate needs at least "
                "one equality correlation key alongside it"
            )

        name = f"{_CORR_PREFIX}{len(new_joins)}"
        if isinstance(node, InSubquery):
            if not isinstance(unalias(node.expr), Variable):
                raise UnsupportedError(
                    "Correlated IN requires a bare column on the left of IN"
                )
            if len(sub.select_list) != 1 or not isinstance(
                unalias(sub.select_list[0]), Variable
            ):
                raise UnsupportedError(
                    "Correlated IN (SELECT …) must select a single bare "
                    "column"
                )
            pairs.append((unalias(sub.select_list[0]), unalias(node.expr)))

        dq = copy.copy(sub)
        # NaN keys never match: groups keyed by NaN leave the build side
        # (``k == k`` is false only for NaN).  The reference keeps them,
        # and its join matches NaN with NaN.
        dq.where = _and_chain(residual + [BinaryOp("==", iv, iv)
                                          for iv, _ov in pairs])
        dq.select_list = [Alias(iv, f"__k{j}") for j, (iv, _ov) in
                          enumerate(pairs)]
        dq.group_by = GroupBy(tuple(iv for iv, _ov in pairs))
        dq.order_by = dq.limit = dq.offset = None
        dq.distinct = False
        if isinstance(node, ScalarSubquery):
            if len(sub.select_list) != 1:
                raise ValidationError(
                    "Subquery used as a value must select exactly one "
                    "column"
                )
            sel = unalias(sub.select_list[0])
            # Any expression over aggregates (q17's 0.2 * AVG(x)): each
            # distinct aggregate becomes a derived column, and the
            # expression re-binds to them after the join.
            aggs: dict = {}
            for x in walk(sel):
                if isinstance(x, Aggregation):
                    aggs.setdefault(x.canonical(), x)
            if not aggs:
                raise UnsupportedError(
                    "Correlated scalar subqueries must select a single "
                    "aggregate (e.g. (SELECT MAX(x) FROM …)); bare "
                    "columns are ambiguous per outer row"
                )
            bare = _vars_outside_aggs(sel)
            if bare:
                raise UnsupportedError(
                    "Correlated scalar subqueries may reference columns "
                    "only inside aggregates (bare "
                    f"{bare[0].name} is ambiguous per outer row)"
                )
            agg_cols: dict = {}
            for j, (canon, a) in enumerate(aggs.items()):
                dq.select_list.append(Alias(a, f"__v{j}"))
                col: Node = Variable(f"{name}.__v{j}")
                if a.agg in (AggregationType.COUNT,
                             AggregationType.COUNT_DISTINCT):
                    # COUNT over an empty match set is 0, not NULL.
                    col = FunctionCall("coalesce", (col, Constant("0")))
                agg_cols[canon] = col
            replacement: Node = transform(
                sel, lambda n: agg_cols[n.canonical()]
                if isinstance(n, Aggregation) else n,
            )
        else:
            dq.select_list.append(
                Alias(Aggregation(AggregationType.COUNT, Star()), "__hit")
            )
            # [NOT] EXISTS / IN → hit IS NOT NULL after the LEFT join.
            replacement = BinaryOp(
                "==", FunctionCall("isnan", (Variable(f"{name}.__hit"),)),
                Constant("0"),
            )
            if neq_pairs:
                # ∃ row with inner ≠ v ⟺ matched ∧ ¬(min = v ∧ max = v).
                iv, ov = neq_pairs[0]
                dq.select_list.append(
                    Alias(Aggregation(AggregationType.MIN, iv), "__nqmin"))
                dq.select_list.append(
                    Alias(Aggregation(AggregationType.MAX, iv), "__nqmax"))
                differs = BinaryOp(
                    "||",
                    BinaryOp("!=", Variable(f"{name}.__nqmin"), ov),
                    BinaryOp("!=", Variable(f"{name}.__nqmax"), ov),
                )
                replacement = BinaryOp("&&", replacement, differs)

        base = _from_relation(dq, catalog, table)
        # The output names are part of the key: canonical() drops the
        # aliases, and an EXISTS and a COUNT(*) over the same keys share
        # one canonical (the reference's key omits them and hands the
        # EXISTS table, without ``__v0``, to the COUNT).
        from .executor import result_column_names

        mkey = ("decorr", tuple(result_column_names(dq.select_list))) + \
            query_dep_key(dq, base, catalog)
        derived = _memoised(
            base, mkey, lambda: materialize_query_table(dq, base, catalog)
        )
        cond = _and_chain([BinaryOp("=", ov, Variable(f"{name}.__k{j}"))
                           for j, (_iv, ov) in enumerate(pairs)])
        derived_tables[name] = derived
        new_joins.append(Join(name, cond, "left", None))
        replacements[id(node)] = replacement

    for node in sub_nodes:
        decorrelate_one(node)
    if not replacements:
        return query, catalog

    q2 = _map_query_exprs(query, lambda node: transform(
        node, lambda n: replacements.get(id(n), n)))
    q2.joins = list(query.joins) + new_joins
    catalog = copy.copy(catalog)
    catalog.update(derived_tables)
    return q2, catalog


def _vars_outside_aggs(n: Node) -> list:
    if isinstance(n, Aggregation):
        return []
    if isinstance(n, Variable):
        return [n]
    return [v for ch in n.children() for v in _vars_outside_aggs(ch)]
