"""Typed expression / query AST.

Node inventory mirrors the reference hierarchy (reference include/
expression.hpp:18-143): Constant, Variable, BinaryOp, FunctionCall,
Aggregation, WindowFunction, plus the QueryAST clause structs.

Instead of the reference's ``to_cuda_expr()`` CUDA-source codegen we expose
``canonical()`` — a deterministic canonical string.  It intentionally
reproduces the reference's golden codegen strings (the de-facto spec pinned
by reference tests/test_expression.cpp and precedence_tests.cpp:
``(price[idx] + (quantity[idx] * 2.0f))`` …) and doubles as the jit-cache /
plan-cache key: two expressions with equal ``canonical()`` compile to the
same fused XLA kernel.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterator, Optional

__all__ = [
    "Node", "Constant", "Variable", "BinaryOp", "FunctionCall",
    "AggregationType", "Aggregation", "WindowFunction", "Star", "Alias",
    "StringLiteral", "LikePattern", "InCodeSet", "CaseWhen", "NotNull",
    "ScalarSubquery", "InSubquery", "InValueSet", "ExistsSubquery",
    "QuantifiedComparison",
    "CodeMap",
    "OrderBy", "Join", "GroupBy", "Query",
    "walk", "column_refs", "unalias",
]


class Node:
    """Base expression node."""

    def canonical(self) -> str:
        raise NotImplementedError

    def children(self) -> tuple["Node", ...]:
        return ()

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.canonical()})"


@dataclass(frozen=True, repr=False)
class Constant(Node):
    """Numeric literal.  Kept as the source string; the engine evaluates all
    constants as float32 (reference expression.hpp:32-38 suffixes every
    literal with ``f``)."""

    text: str

    @property
    def value(self) -> float:
        return float(self.text)

    def canonical(self) -> str:
        if "." in self.text:
            return self.text + "f"
        return self.text + ".0f"


@dataclass(frozen=True, repr=False)
class Variable(Node):
    """Column reference; may be dot-qualified (``sales.id``)."""

    name: str

    @property
    def unqualified(self) -> str:
        return self.name.rsplit(".", 1)[-1]

    @property
    def qualifier(self) -> Optional[str]:
        if "." in self.name:
            return self.name.rsplit(".", 1)[0]
        return None

    def canonical(self) -> str:
        return f"{self.name}[idx]"


@dataclass(frozen=True, repr=False)
class BinaryOp(Node):
    """Infix binary operator.  ``op`` is one of
    ``+ - * / > < >= <= == != = && ||`` (bare ``=`` is accepted as a
    comparison, reference expression.cpp:159)."""

    op: str
    left: Node
    right: Node

    def canonical(self) -> str:
        return f"({self.left.canonical()} {self.op} {self.right.canonical()})"

    def children(self) -> tuple[Node, ...]:
        return (self.left, self.right)


@dataclass(frozen=True, repr=False)
class FunctionCall(Node):
    """UDF invocation — resolved against the UDF registry at compile time
    (the TPU-native replacement for the reference's ``custom.cu``
    convention, jit.cpp:66-73)."""

    name: str
    args: tuple[Node, ...]

    def canonical(self) -> str:
        return f"{self.name}({', '.join(a.canonical() for a in self.args)})"

    def children(self) -> tuple[Node, ...]:
        return self.args


@dataclass(frozen=True, repr=False)
class StringLiteral(Node):
    """A quoted string literal (``'toys'``) — extension over the reference
    grammar (its tokenizer has no string form).  Bound to a dictionary
    code against the queried table at plan-lowering time."""

    text: str

    def canonical(self) -> str:
        return f"'{self.text}'"


@dataclass(frozen=True, repr=False)
class LikePattern(Node):
    """``expr LIKE 'pat%'`` (extension).  Bound against the column's
    dictionary at plan lowering into an :class:`InCodeSet`.  ``ci``
    marks the case-insensitive ILIKE spelling (PostgreSQL extension);
    ``regex`` marks the REGEXP / RLIKE spelling (MySQL extension) —
    the pattern is then a full regular expression, matched with
    ``re.search`` semantics against the vocabulary."""

    expr: Node
    pattern: str
    ci: bool = False
    regex: bool = False

    def canonical(self) -> str:
        word = (
            "REGEXP" if self.regex else "ILIKE" if self.ci else "LIKE"
        )
        return f"({self.expr.canonical()} {word} '{self.pattern}')"

    def children(self) -> tuple[Node, ...]:
        return (self.expr,)


@dataclass(frozen=True, repr=False)
class InCodeSet(Node):
    """Membership of a dictionary-coded column in a static code set (the
    bound form of LIKE).  The code tuple is part of the canonical string,
    so kernels cache correctly across tables with different
    vocabularies."""

    expr: Node
    codes: tuple
    vocab_size: int

    def canonical(self) -> str:
        return (
            f"({self.expr.canonical()} IN_CODES "
            f"{self.vocab_size}:{','.join(str(c) for c in self.codes)})"
        )

    def children(self) -> tuple[Node, ...]:
        return (self.expr,)


@dataclass(frozen=True, repr=False, eq=False)
class ScalarSubquery(Node):
    """``(SELECT …)`` used as a value (extension; uncorrelated only).
    The executor runs the inner query up front and substitutes a
    :class:`Constant` (numeric) or :class:`StringLiteral` — the inner
    query is therefore NOT part of ``children()``/``walk``: its columns
    resolve against its own FROM relation, not the outer table."""

    query: object  # frontend.ast.Query (kept loose: Query is mutable)

    def canonical(self) -> str:
        return f"({self.query.canonical()})"


@dataclass(frozen=True, repr=False, eq=False)
class InSubquery(Node):
    """``expr IN (SELECT …)`` (extension; uncorrelated only).  Resolved
    by the executor into :class:`InValueSet` (numeric) or
    :class:`InCodeSet` (strings) before compilation."""

    expr: Node
    query: object

    def canonical(self) -> str:
        return f"({self.expr.canonical()} IN ({self.query.canonical()}))"

    def children(self) -> tuple[Node, ...]:
        return (self.expr,)


@dataclass(frozen=True, repr=False, eq=False)
class QuantifiedComparison(Node):
    """``expr <op> ANY|SOME|ALL (SELECT …)`` (extension; uncorrelated
    only).  Resolved by the executor before plan lowering: ordering ops
    reduce against the subquery's min/max, ``= ANY`` becomes IN,
    ``<> ALL`` becomes NOT IN, empty sets fold to the standard constants
    (ANY → false, ALL → true).  Like the other subquery nodes the inner
    query is NOT part of ``children()``."""

    op: str
    expr: Node
    query: object
    quantifier: str  # "ANY" | "ALL" (SOME normalises to ANY)

    def canonical(self) -> str:
        return (
            f"({self.expr.canonical()} {self.op} {self.quantifier} "
            f"({self.query.canonical()}))"
        )

    def children(self) -> tuple[Node, ...]:
        return (self.expr,)


@dataclass(frozen=True, repr=False, eq=False)
class CodeMap(Node):
    """A per-code lookup over a dictionary-coded expression — the bound
    form of a string scalar function (``UPPER(name)``, ``LENGTH(name)``,
    …).  The function was applied host-side to the (small) vocabulary at
    plan lowering; on device only a tiny-table gather of ``values``
    remains.  ``out_vocab`` is the sorted result vocabulary for
    string-valued functions (``values`` are codes into it) or None for
    numeric-valued ones (``values`` are the numbers).  ``tag`` uniquely
    fingerprints (function, literal args, source vocabulary) and is part
    of the canonical string — the kernel-cache key must change whenever
    the mapping changes."""

    expr: Node
    values: tuple  # float32 LUT indexed by source code
    tag: str
    out_vocab: object = None  # np.ndarray of strings, or None

    def canonical(self) -> str:
        return f"CODEMAP[{self.tag}]({self.expr.canonical()})"

    def children(self) -> tuple[Node, ...]:
        return (self.expr,)


@dataclass(frozen=True, repr=False, eq=False)
class ExistsSubquery(Node):
    """``EXISTS (SELECT …)`` (extension; uncorrelated only).  Resolved
    by the executor to Constant 1/0 — true iff the subquery returns at
    least one row (its column list is irrelevant, per standard SQL).
    Like :class:`ScalarSubquery`, the inner query is NOT part of
    ``children()``: its columns resolve against its own FROM."""

    query: object

    def canonical(self) -> str:
        return f"EXISTS ({self.query.canonical()})"


@dataclass(frozen=True, repr=False)
class InValueSet(Node):
    """Membership of a numeric expression in a static value set (the
    bound form of ``IN (SELECT …)``).  The values are part of the
    canonical string — anything that changes results must be in the
    kernel cache key."""

    expr: Node
    values: tuple

    def canonical(self) -> str:
        return (
            f"({self.expr.canonical()} IN_VALUES "
            f"{','.join(repr(float(v)) for v in self.values)})"
        )

    def children(self) -> tuple[Node, ...]:
        return (self.expr,)


@dataclass(frozen=True, repr=False)
class NotNull(Node):
    """Internal not-NULL indicator (no SQL surface syntax): 1.0 where
    ``expr`` is present, 0.0 where it is the engine's missing-value
    marker (NaN for float columns/expressions, code/value -1 for i32 —
    the LEFT-JOIN fill convention, engine/join_exec.left_fill).  The
    planner routes SQL's NULL-skipping ``COUNT(expr)`` through
    ``SUM(NotNull(expr))`` so every grouped path (dense, sorted,
    streaming partials, distributed) inherits the semantics from the
    existing SUM machinery.

    ``negated=True`` flips the indicator (1.0 where NULL): the planner
    prefers ``COUNT(expr) = counts − SUM(IsNull(expr))`` because the
    per-group row counts are exact i32 while a summed f32 indicator
    loses exactness past 2^24 non-null rows per group — the flipped
    form is exact until a group holds 2^24 NULLs (ADVICE r4)."""

    expr: Node
    negated: bool = False

    def canonical(self) -> str:
        tag = "ISNULL" if self.negated else "ISNOTNULL"
        return f"{tag}({self.expr.canonical()})"

    def children(self) -> tuple[Node, ...]:
        return (self.expr,)


@dataclass(frozen=True, repr=False)
class CaseWhen(Node):
    """``CASE WHEN c1 THEN v1 [WHEN c2 THEN v2 …] [ELSE d] END``
    (extension).  Evaluates to the first matching branch; without ELSE,
    unmatched rows yield 0.0 (the engine's defined filtered-out value)."""

    conditions: tuple[Node, ...]
    values: tuple[Node, ...]
    default: Optional[Node] = None

    def canonical(self) -> str:
        parts = ["CASE"]
        for c, v in zip(self.conditions, self.values):
            parts.append(f"WHEN {c.canonical()} THEN {v.canonical()}")
        if self.default is not None:
            parts.append(f"ELSE {self.default.canonical()}")
        parts.append("END")
        return " ".join(parts)

    def children(self) -> tuple[Node, ...]:
        kids = [*self.conditions, *self.values]
        if self.default is not None:
            kids.append(self.default)
        return tuple(kids)


@dataclass(frozen=True, repr=False)
class Star(Node):
    """The ``*`` in ``COUNT(*)`` / ``SELECT *`` and the qualified
    ``SELECT t.*`` (``table`` holds the qualifier).  As an aggregate
    argument it evaluates row-wise as 1.0 (every row in this engine is
    non-null).  Extension over the reference grammar, which has no ``*``
    select/aggregate form."""

    table: Optional[str] = None

    def canonical(self) -> str:
        return f"{self.table}.*" if self.table else "*"


@dataclass(frozen=True, repr=False)
class Alias(Node):
    """``expr AS name`` select-item wrapper (extension over the reference
    grammar).  ``canonical()`` delegates to the inner expression so plan /
    kernel cache keys are alias-insensitive; the name only affects output
    column labelling in ``query_sql_table``."""

    expr: Node
    name: str

    def canonical(self) -> str:
        return self.expr.canonical()

    def children(self) -> tuple[Node, ...]:
        return (self.expr,)


def unalias(node: Node) -> Node:
    """Strip an Alias wrapper (identity for everything else)."""
    return node.expr if isinstance(node, Alias) else node


class AggregationType(enum.Enum):
    SUM = "sum"
    AVG = "avg"
    COUNT = "count"
    MIN = "min"
    MAX = "max"
    # Window-only ranking functions (extension over the reference's five
    # aggregates, expression.hpp:86).
    ROW_NUMBER = "row_number"
    RANK = "rank"
    DENSE_RANK = "dense_rank"
    # Window-only neighbour functions (offset 1): previous / next row's
    # value within the partition; NaN where absent.
    LAG = "lag"
    LEAD = "lead"
    # Window-only partition-edge values.  FIRST_VALUE follows the
    # standard default frame (first row of the partition in order-key
    # order); LAST_VALUE deliberately uses the whole-partition frame
    # (UNBOUNDED FOLLOWING) — the standard's default current-row frame
    # makes it a no-op, which no user ever wants.
    FIRST_VALUE = "first_value"
    LAST_VALUE = "last_value"
    # NTILE(n): bucket number 1..n, partition rows split as evenly as
    # possible with earlier buckets taking the remainder (standard).
    NTILE = "ntile"
    # Window-only relative ranks: PERCENT_RANK = (rank−1)/(count−1)
    # (0 for a single-row partition); CUME_DIST = rows with order key
    # ≤ current / partition count (peers included).
    PERCENT_RANK = "percent_rank"
    CUME_DIST = "cume_dist"
    # NTH_VALUE(expr, n): the expression's value at the partition's n-th
    # row in order-key order (whole-partition frame, matching
    # FIRST_VALUE/LAST_VALUE above); NaN when the partition has < n rows.
    NTH_VALUE = "nth_value"
    # COUNT(DISTINCT expr) — extension.
    COUNT_DISTINCT = "count_distinct"
    # MEDIAN(expr) — extension (interpolated: mean of the two middle
    # values for even counts).
    MEDIAN = "median"
    # PERCENTILE(expr, q) — extension (linear interpolation at
    # q·(count−1), numpy's default scheme; MEDIAN ≡ PERCENTILE 0.5).
    PERCENTILE = "percentile"
    # STRING_AGG(expr, sep) / GROUP_CONCAT — extension.  Values
    # concatenate in ascending value order (deterministic; the engine
    # has no per-group input-order notion after its sorts).
    STRING_AGG = "string_agg"
    # APPROX_COUNT_DISTINCT(expr) — extension: HyperLogLog estimate
    # (~1.6% standard error at m=4096 registers).  Same distinct
    # semantics as COUNT(DISTINCT): every NaN is one value, -0 ≡ +0.
    APPROX_COUNT_DISTINCT = "approx_count_distinct"


@dataclass(frozen=True, repr=False)
class Aggregation(Node):
    """``SUM(expr)`` etc.  ``kernel_name`` mirrors the reference's
    ``AggregationNode::agg_kernel`` (expression.cpp:533-547)."""

    agg: AggregationType
    expr: Node
    # Parameterised aggregates (PERCENTILE's q); part of canonical() so
    # kernels cache per parameter value.
    param: Optional[float] = None

    @property
    def kernel_name(self) -> str:
        return self.agg.value

    def canonical(self) -> str:
        if self.agg is AggregationType.COUNT_DISTINCT:
            return f"COUNT(DISTINCT {self.expr.canonical()})"
        if self.agg is AggregationType.PERCENTILE:
            return f"PERCENTILE({self.expr.canonical()}, {self.param!r})"
        if self.agg is AggregationType.STRING_AGG:
            return f"STRING_AGG({self.expr.canonical()}, {self.param!r})"
        return f"{self.agg.name}({self.expr.canonical()})"

    def children(self) -> tuple[Node, ...]:
        return (self.expr,)


@dataclass(frozen=True, repr=False)
class WindowFunction(Node):
    """``AGG(expr) OVER (PARTITION BY … ORDER BY …)``.

    The reference parses these but its codegen is a stub returning
    ``"<window>"`` (expression.hpp:112-121); this engine executes them
    (partitioned aggregation broadcast back to rows)."""

    agg: AggregationType
    expr: Node
    partition_by: tuple[Node, ...] = ()
    order_by: Optional["OrderBy"] = None
    #: ROWS frame ``(preceding, following)`` — row counts relative to the
    #: current row, ``None`` meaning UNBOUNDED on that side.  ``None`` as
    #: a whole means no explicit frame (default running/whole-partition
    #: semantics).  Normalised at parse time: ``CURRENT ROW`` → 0.
    #: With ``frame_type == "range"`` the bounds are ORDER-BY-VALUE
    #: offsets (floats): the frame holds every partition row whose order
    #: key lies within [o − preceding, o + following] — peers (ties on
    #: the order key) are always in.
    frame: Optional[tuple[Optional[float], Optional[float]]] = None
    #: "rows" | "range" | "groups" — meaningless unless ``frame`` is
    #: set.  With "groups" the bounds count PEER GROUPS (distinct order-
    #: key values) relative to the current row's group (SQL:2011).
    frame_type: str = "rows"
    #: Integer parameter: NTH_VALUE's n, LAG/LEAD's offset (None = 1).
    #: Changes results, so it joins ``canonical()`` (the cache key).
    param: Optional[int] = None

    def canonical(self) -> str:
        arg = self.expr.canonical()
        if self.param is not None:
            arg += f", {self.param}"
        parts = [f"{self.agg.name}({arg}) OVER ("]
        if self.partition_by:
            parts.append(
                "PARTITION BY " + ", ".join(p.canonical() for p in self.partition_by)
            )
        if self.order_by is not None:
            parts.append(" ORDER BY " + self.order_by.canonical())
        if self.frame is not None:
            # Frame bounds change results, so they MUST appear in the
            # canonical form (it doubles as the kernel-cache key).
            prec, foll = self.frame

            def _bound(v, side):
                if v is None:
                    return f"UNBOUNDED {side}"
                if v == 0:
                    return "CURRENT ROW"
                return f"{v:g} {side}"

            parts.append(
                (" ROWS BETWEEN " if self.frame_type == "rows"
                 else " GROUPS BETWEEN " if self.frame_type == "groups"
                 else " RANGE BETWEEN ")
                + _bound(prec, "PRECEDING")
                + " AND "
                + _bound(foll, "FOLLOWING")
            )
        parts.append(")")
        return "".join(parts)

    def children(self) -> tuple[Node, ...]:
        kids: list[Node] = [self.expr, *self.partition_by]
        if self.order_by is not None:
            kids.append(self.order_by.expr)
        return tuple(kids)


# --------------------------------------------------------------------------
# Query clause structures (reference expression.hpp:99-143)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class OrderBy:
    """One or more sort terms.  ``expr``/``ascending`` is the primary term
    (the reference grammar allows exactly one, expression.cpp:474-513);
    ``then`` holds additional ``ORDER BY a, b DESC, …`` tie-breaker terms
    (extension)."""

    expr: Node
    ascending: bool = True
    then: tuple["OrderBy", ...] = ()

    @property
    def terms(self) -> tuple["OrderBy", ...]:
        """All (expr, ascending) terms, primary first, each with empty
        ``then``."""
        head = self if not self.then else OrderBy(self.expr, self.ascending)
        return (head, *self.then)

    def canonical(self) -> str:
        out = f"{self.expr.canonical()} {'ASC' if self.ascending else 'DESC'}"
        for t in self.then:
            out += f", {t.canonical()}"
        return out


@dataclass(frozen=True)
class Join:
    table: str
    # ``None`` only for CROSS JOIN (no ON clause).
    condition: Optional[Node]
    # "inner" (default), "left", "right", "full", or "cross".  OUTER
    # variants keep unmatched rows with the other side's columns filled
    # NaN (codes -1 for strings) — the engine's missing-value marker (it
    # has no NULL representation).  CROSS is the full cartesian product.
    kind: str = "inner"
    # When the join relation is aliased (``JOIN sales AS s``), ``table``
    # holds the alias (all qualified refs resolve against it) and
    # ``source`` the real catalog name; None when unaliased.
    source: Optional[str] = None


@dataclass(frozen=True)
class GroupBy:
    keys: tuple[Node, ...]
    # Grouping sets (ROLLUP / CUBE / GROUPING SETS — extension; the
    # reference grammar has GROUP BY only, expression.hpp:132-143):
    # each element is a tuple of indices into ``keys`` naming the keys
    # grouped in that set.  ``None`` means plain GROUP BY (one implicit
    # set over every key).  Duplicate sets are kept (standard: they
    # produce duplicate result rows).
    sets: Optional[tuple[tuple[int, ...], ...]] = None


@dataclass
class Query:
    """Parsed ``SELECT`` statement (reference ``QueryAST``,
    expression.hpp:132-143)."""

    select_list: list[Node] = field(default_factory=list)
    from_table: str = ""
    # Derived table: ``FROM (SELECT …) AS alias`` — the inner query
    # materialises first and ``from_table`` holds the alias.
    from_subquery: Optional["Query"] = None
    # Aliased FROM (``FROM sales AS s`` / ``FROM sales s``):
    # ``from_table`` holds the alias, ``from_source`` the real name.
    from_source: Optional[str] = None
    joins: list[Join] = field(default_factory=list)
    where: Optional[Node] = None
    group_by: Optional[GroupBy] = None
    having: Optional[Node] = None
    order_by: Optional[OrderBy] = None
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
    # QUALIFY <predicate over window functions> (extension, the
    # Snowflake/BigQuery/DuckDB clause): filters rows AFTER window
    # functions evaluate, before ORDER BY/LIMIT.
    qualify: Optional[Node] = None
    # Common table expressions: [(name, Query), …] from a ``WITH``
    # prefix.  Each CTE materialises once per statement (in order —
    # later CTEs may reference earlier ones) and is visible to the main
    # query and every set-op branch as an ordinary table name.
    ctes: list = field(default_factory=list)
    # Set operations: [(op, all_flag, Query), …] with op in
    # {"UNION", "EXCEPT", "INTERSECT"}.  UNION/EXCEPT chain
    # left-to-right; INTERSECT binds tighter (standard SQL precedence:
    # ``A UNION B INTERSECT C`` is ``A UNION (B INTERSECT C)``).  Only
    # the FINAL branch may carry ORDER BY/LIMIT/OFFSET — they apply to
    # the whole combined result (standard SQL placement).
    set_ops: list = field(default_factory=list)

    def canonical(self) -> str:
        """Deterministic cache key for the whole statement."""
        parts = []
        if self.ctes:
            parts.append(
                "WITH "
                + ", ".join(
                    f"{name} AS ({q.canonical()})" for name, q in self.ctes
                )
            )
        parts.append("SELECT")
        if self.distinct:
            parts.append("DISTINCT")
        parts.append(", ".join(e.canonical() for e in self.select_list))
        if self.from_subquery is not None:
            parts.append(
                f"FROM ({self.from_subquery.canonical()}) AS {self.from_table}"
            )
        elif self.from_source is not None:
            parts.append(f"FROM {self.from_source} AS {self.from_table}")
        else:
            parts.append(f"FROM {self.from_table}")
        for j in self.joins:
            prefix = {
                "left": "LEFT JOIN",
                "right": "RIGHT JOIN",
                "full": "FULL JOIN",
                "cross": "CROSS JOIN",
            }.get(j.kind, "JOIN")
            rel = f"{j.source} AS {j.table}" if j.source else j.table
            if j.condition is None:
                parts.append(f"{prefix} {rel}")
            else:
                parts.append(f"{prefix} {rel} ON {j.condition.canonical()}")
        if self.where is not None:
            parts.append(f"WHERE {self.where.canonical()}")
        if self.group_by is not None:
            if self.group_by.sets is not None:
                # The sets ARE the semantics (and so the cache key);
                # rendering the normalised GROUPING SETS form makes
                # ROLLUP(a, b) and its expansion share compiled plans.
                ks = self.group_by.keys
                rendered = ", ".join(
                    "(" + ", ".join(ks[i].canonical() for i in s) + ")"
                    for s in self.group_by.sets
                )
                parts.append(f"GROUP BY GROUPING SETS ({rendered})")
            else:
                parts.append(
                    "GROUP BY "
                    + ", ".join(k.canonical() for k in self.group_by.keys)
                )
        if self.having is not None:
            parts.append(f"HAVING {self.having.canonical()}")
        if self.qualify is not None:
            parts.append(f"QUALIFY {self.qualify.canonical()}")
        if self.order_by is not None:
            parts.append(f"ORDER BY {self.order_by.canonical()}")
        if self.limit is not None:
            parts.append(f"LIMIT {self.limit}")
        if self.offset is not None:
            parts.append(f"OFFSET {self.offset}")
        for op, all_flag, branch in self.set_ops:
            parts.append(f"{op} ALL" if all_flag else op)
            parts.append(branch.canonical())
        return " ".join(parts)


# --------------------------------------------------------------------------
# Traversal helpers
# --------------------------------------------------------------------------


def walk(node: Node) -> Iterator[Node]:
    """Pre-order traversal."""
    yield node
    for child in node.children():
        yield from walk(child)


def column_refs(node: Node) -> list[Variable]:
    """All column references in an expression, in source order."""
    return [n for n in walk(node) if isinstance(n, Variable)]


def transform(node: Node, fn, *, prune: tuple = ()) -> Node:
    """Top-down rewrite: apply ``fn`` to each node; when it returns a
    replacement, graft it and stop descending into that subtree.  Node
    types in ``prune`` are kept verbatim without visiting their
    children (e.g. ``Aggregation`` when a rewrite must only touch
    row-level context).  Untouched subtrees are returned by identity,
    so plan-cache keys survive no-op transforms."""
    import dataclasses

    new = fn(node)
    if new is not node:
        return new
    if prune and isinstance(node, prune):
        return node
    if not dataclasses.is_dataclass(node):
        return node
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, Node):
            nv = transform(v, fn, prune=prune)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple) and any(isinstance(x, Node) for x in v):
            nv = tuple(
                transform(x, fn, prune=prune) if isinstance(x, Node) else x
                for x in v
            )
            if any(a is not b for a, b in zip(nv, v)):
                changes[f.name] = nv
    return dataclasses.replace(node, **changes) if changes else node
