"""Recursive-descent expression parser + SQL query parser.

Grammar parity with the reference (reference src/expression.cpp):

* precedence: ``OR`` < ``AND`` < comparisons (incl. bare ``=``) < ``+ -``
  < ``* /`` < factor (expression.cpp:144-235); no unary minus;
* factor = number | identifier | call ``f(a, b)`` | parenthesised expr;
* SQL: ``SELECT [DISTINCT] items FROM table [JOIN t ON cond]* [WHERE e]
  [GROUP BY k,…] [HAVING e] [ORDER BY e [ASC|DESC]] [LIMIT n] [OFFSET n]``
  (expression.cpp:270-531) — with two deliberate repairs of reference
  bitrot (SURVEY.md §0): the duplicated HAVING block is collapsed, and
  LIMIT/OFFSET are accepted in either order (the reference's own
  sql_features_test.cpp:33 uses ``OFFSET 1 LIMIT 2``);
* error messages keep the phrases the reference tests assert on
  ("Unexpected token", "Expected ')'", "Expected keyword", line/column).

Unlike the reference's file-static mutable parser state
(expression.cpp:123-124 — not reentrant), this parser is a plain object:
reentrant and thread-safe by construction.
"""

from __future__ import annotations

from typing import Optional

from ..errors import ParseError
from .ast import (
    Aggregation,
    AggregationType,
    Alias,
    BinaryOp,
    CaseWhen,
    Constant,
    ExistsSubquery,
    FunctionCall,
    GroupBy,
    InSubquery,
    Join,
    LikePattern,
    Node,
    OrderBy,
    QuantifiedComparison,
    Query,
    ScalarSubquery,
    Star,
    StringLiteral,
    Variable,
    WindowFunction,
)
from .lexer import Token, TokenType, tokenize

__all__ = [
    "parse_expression",
    "parse_logical_and",
    "parse_logical_or",
    "parse_query",
    "parse_expression_text",
    "parse_query_text",
]

_AGG_KEYWORDS = {
    "SUM": AggregationType.SUM,
    "AVG": AggregationType.AVG,
    "COUNT": AggregationType.COUNT,
    "MIN": AggregationType.MIN,
    "MAX": AggregationType.MAX,
}

# Ranking functions: argument-less, only meaningful with OVER (...).
_RANK_KEYWORDS = {
    "ROW_NUMBER": AggregationType.ROW_NUMBER,
    "RANK": AggregationType.RANK,
    "DENSE_RANK": AggregationType.DENSE_RANK,
    "PERCENT_RANK": AggregationType.PERCENT_RANK,
    "CUME_DIST": AggregationType.CUME_DIST,
}

# Window functions taking one expression argument before OVER (...).
_ARG_WINDOW_FNS = {
    "LAG": AggregationType.LAG,
    "LEAD": AggregationType.LEAD,
    "FIRST_VALUE": AggregationType.FIRST_VALUE,
    "LAST_VALUE": AggregationType.LAST_VALUE,
    "NTILE": AggregationType.NTILE,
    "NTH_VALUE": AggregationType.NTH_VALUE,
}

# Of those, the ones accepting an integer second argument:
# LAG/LEAD(expr [, offset]) — optional, default 1;
# NTH_VALUE(expr, n) — mandatory.
_INT_PARAM_WINDOW_FNS = frozenset(
    {
        AggregationType.LAG,
        AggregationType.LEAD,
        AggregationType.NTH_VALUE,
    }
)

_COMPARISON_OPS = (">", "<", ">=", "<=", "==", "!=", "=")

_VARIANCE_FNS = frozenset(
    {"VARIANCE", "VAR_SAMP", "VAR_POP", "STDDEV", "STDDEV_SAMP", "STDDEV_POP"}
)


def _variance_rewrite(name: str, inner: Node) -> Node:
    """Lower VARIANCE/STDDEV to arithmetic over SUM/SUM-of-squares/COUNT
    aggregates: var = (Σx² − (Σx)²/n) / (n − ddof).  Sample forms
    (ddof=1) yield NaN for n=1 (0/0), matching SQL's NULL; population
    forms yield 0."""
    cnt = Aggregation(AggregationType.COUNT, inner)
    s = Aggregation(AggregationType.SUM, inner)
    ss = Aggregation(AggregationType.SUM, BinaryOp("*", inner, inner))
    num = BinaryOp("-", ss, BinaryOp("/", BinaryOp("*", s, s), cnt))
    denom = cnt if name.endswith("_POP") else BinaryOp("-", cnt, Constant("1"))
    var = BinaryOp("/", num, denom)
    if name.startswith("STDDEV"):
        # Clamp tiny negative rounding residue before the sqrt; NaN
        # (n=1 sample form) propagates through maximum.
        return FunctionCall("sqrt", (FunctionCall("maximum", (var, Constant("0"))),))
    return var


def _apply_agg_filter(node: Node, cond: Node) -> Node:
    """Rewrite every aggregate in ``node`` to apply ``FILTER (WHERE
    cond)``: masked CASE arithmetic over the same mergeable partials
    (see ``_maybe_filter_suffix``)."""
    from .ast import transform

    def case(val: Node, other: Node) -> Node:
        return CaseWhen((cond,), (val,), other)

    match_count = Aggregation(AggregationType.SUM, case(Constant("1"), Constant("0")))

    def guard_empty(expr: Node) -> Node:
        # Standard: an aggregate over zero qualifying rows is NULL.
        return CaseWhen(
            (BinaryOp("==", match_count, Constant("0")),),
            (FunctionCall("nullval", ()),),
            expr,
        )

    def rewrite(n: Node) -> Node:
        if not isinstance(n, Aggregation):
            return n
        a = n.agg
        if a is AggregationType.COUNT:
            return match_count
        if a is AggregationType.SUM:
            return guard_empty(
                Aggregation(AggregationType.SUM, case(n.expr, Constant("0")))
            )
        if a is AggregationType.AVG:
            # masked sum / masked count; 0/0 → NaN (NULL) automatically.
            return BinaryOp(
                "/",
                Aggregation(AggregationType.SUM, case(n.expr, Constant("0"))),
                match_count,
            )
        if a is AggregationType.MIN:
            return guard_empty(
                Aggregation(AggregationType.MIN, case(n.expr, Constant("inf")))
            )
        if a is AggregationType.MAX:
            return guard_empty(
                Aggregation(AggregationType.MAX, case(n.expr, Constant("-inf")))
            )
        raise ParseError(
            f"FILTER is not supported with {a.name} aggregates"
        )

    new = transform(node, rewrite)
    if new is node:
        raise ParseError("FILTER requires an aggregate function")
    # Label with the surface form, not the expanded CASE partials
    # (canonical() delegates through Alias, so cache keys still see the
    # expansion; an explicit user AS wraps outside and wins).
    label = (
        f"{node.canonical().replace('[idx]', '')} FILTER "
        f"(WHERE {cond.canonical().replace('[idx]', '')})"
    )
    return Alias(new, label)


class _ExprParser:
    def __init__(self, tokens: list[Token]):
        self.toks = tokens
        self.pos = 0

    # -- token helpers ----------------------------------------------------
    def peek(self) -> Token:
        return self.toks[self.pos]

    def advance(self) -> Token:
        tok = self.toks[self.pos]
        self.pos += 1
        return tok

    def _maybe_filter_suffix(self, node: Node) -> Node:
        """Postfix ``FILTER (WHERE cond)`` after an aggregate (standard;
        contextual keyword — a column named ``filter`` stays usable).
        Rewrites every aggregate inside ``node`` into masked mergeable
        partials (CASE arithmetic), so filtered aggregates group,
        distribute, and stream wherever plain ones do:

        * ``COUNT(x|*)``   → ``SUM(CASE WHEN c THEN 1 ELSE 0 END)``
        * ``SUM(x)``       → guarded masked SUM (0 matches → NULL)
        * ``AVG(x)``       → masked SUM / masked COUNT (0/0 → NULL)
        * ``MIN/MAX(x)``   → guarded masked MIN/MAX (±inf identity)
        * variance family  → inner SUM/COUNT partials masked individually
        """
        if not (
            self.pos + 1 < len(self.toks)
            and self.toks[self.pos].type is TokenType.IDENTIFIER
            and self.toks[self.pos].value.upper() == "FILTER"
            and self.toks[self.pos + 1].type is TokenType.OPERATOR
            and self.toks[self.pos + 1].value == "("
        ):
            return node
        self.pos += 2
        if not self.match_kw("WHERE"):
            raise ParseError("Expected WHERE in FILTER clause")
        cond = self.logical_or()
        if not self.match_op(")"):
            raise ParseError("Expected ')' to close FILTER clause")
        return _apply_agg_filter(node, cond)

    def match_op(self, *ops: str) -> Optional[str]:
        tok = self.peek()
        if tok.type is TokenType.OPERATOR and tok.value in ops:
            self.advance()
            return tok.value
        return None

    def match_kw(self, *kws: str) -> Optional[str]:
        tok = self.peek()
        if tok.type is TokenType.KEYWORD and tok.value in kws:
            self.advance()
            return tok.value
        return None

    # -- grammar rules -----------------------------------------------------
    def logical_or(self) -> Node:
        node = self.logical_and()
        while self.match_kw("OR"):
            node = BinaryOp("||", node, self.logical_and())
        return node

    def logical_and(self) -> Node:
        node = self.unary_not()
        while self.match_kw("AND"):
            node = BinaryOp("&&", node, self.unary_not())
        return node

    def unary_not(self) -> Node:
        # SQL NOT (extension): rewrites to (expr == 0) — the engine's
        # boolean representation is {0, 1} f32.
        if self.match_kw("NOT"):
            return BinaryOp("==", self.unary_not(), Constant("0"))
        return self.comparison()

    def comparison(self) -> Node:
        node = self.additive()
        # expr IS [NOT] NULL (extension): NaN is the engine's missing-value
        # marker, so the predicate lowers to an isnan test.
        if self.match_kw("IS"):
            negate = self.match_kw("NOT") is not None
            if not self.match_kw("NULL"):
                raise ParseError("Expected NULL after IS")
            test = FunctionCall("isnan", (node,))
            if negate:
                return BinaryOp("==", test, Constant("0"))
            return test
        # Negated predicate forms: a NOT IN (...), a NOT BETWEEN x AND y,
        # a NOT LIKE 'p' — the standard SQL spellings.
        if (
            self.peek().type is TokenType.KEYWORD
            and self.peek().value == "NOT"
            and self.pos + 1 < len(self.toks)
            and (
                (
                    self.toks[self.pos + 1].type is TokenType.KEYWORD
                    and self.toks[self.pos + 1].value
                    in ("IN", "BETWEEN", "LIKE")
                )
                or (
                    self.toks[self.pos + 1].type is TokenType.IDENTIFIER
                    and self.toks[self.pos + 1].value.upper()
                    in ("ILIKE", "REGEXP", "RLIKE")
                )
            )
        ):
            self.advance()  # NOT
            positive = self._predicate_tail(node)
            return BinaryOp("==", positive, Constant("0"))
        tail = self._maybe_predicate_tail(node)
        if tail is not None:
            return tail
        while True:
            op = self.match_op(*_COMPARISON_OPS)
            if op is None:
                return node
            # Quantified comparison: expr op ANY|SOME|ALL (SELECT …) —
            # ANY/SOME are contextual identifiers; ALL is already a
            # keyword (UNION ALL).  Resolved before plan lowering.
            tok = self.peek()
            at_quant = (
                tok.type is TokenType.IDENTIFIER
                and tok.value.upper() in ("ANY", "SOME")
            ) or (tok.type is TokenType.KEYWORD and tok.value == "ALL")
            if (
                at_quant
                and self.pos + 1 < len(self.toks)
                and self.toks[self.pos + 1].type is TokenType.OPERATOR
                and self.toks[self.pos + 1].value == "("
            ):
                quant = self.advance().value.upper()
                self.advance()  # consume '('
                if not self._at_select():
                    raise ParseError(
                        "Expected SELECT in quantified comparison"
                    )
                sub = self._collect_subquery()
                node = QuantifiedComparison(
                    op, node, sub, "ANY" if quant == "SOME" else quant
                )
                continue
            node = BinaryOp(op, node, self.additive())

    def _maybe_predicate_tail(self, node: Node) -> Optional[Node]:
        if self.peek().type is TokenType.KEYWORD and self.peek().value in (
            "IN", "BETWEEN", "LIKE",
        ):
            return self._predicate_tail(node)
        # ILIKE / REGEXP / RLIKE are contextual: only a following string
        # literal makes them operators (bare columns with those names
        # keep working).
        if (
            self.peek().type is TokenType.IDENTIFIER
            and self.peek().value.upper() in ("ILIKE", "REGEXP", "RLIKE")
            and self.pos + 1 < len(self.toks)
            and self.toks[self.pos + 1].type is TokenType.STRING
        ):
            return self._predicate_tail(node)
        return None

    def _at_select(self) -> bool:
        tok = self.peek()
        return tok.type is TokenType.KEYWORD and tok.value == "SELECT"

    def _collect_subquery(self):
        """Collect tokens up to the ')' matching an already-consumed '('
        and parse them as a full SELECT (uncorrelated subquery)."""
        depth = 1
        inner: list[Token] = []
        while self.pos < len(self.toks):
            tok = self.toks[self.pos]
            if tok.type is TokenType.OPERATOR and tok.value == "(":
                depth += 1
            elif tok.type is TokenType.OPERATOR and tok.value == ")":
                depth -= 1
                if depth == 0:
                    break
            inner.append(tok)
            self.pos += 1
        if depth != 0:
            raise ParseError("Expected ')' to close subquery")
        self.pos += 1  # consume ')'
        return _QueryParser(inner + [Token(TokenType.END, "")]).parse()

    def _predicate_tail(self, node: Node) -> Node:
        # IN / BETWEEN / LIKE (extensions) — pure grammar rewrites.
        if self.match_kw("IN"):
            if not self.match_op("("):
                raise ParseError("Expected '(' after IN")
            if self._at_select():
                return InSubquery(node, self._collect_subquery())
            out: Optional[Node] = None
            while True:
                item = self.logical_or()
                eq = BinaryOp("==", node, item)
                out = eq if out is None else BinaryOp("||", out, eq)
                if not self.match_op(","):
                    break
            if not self.match_op(")"):
                raise ParseError("Expected ')' after IN list")
            return out
        if self.match_kw("BETWEEN"):
            lo = self.additive()
            if not self.match_kw("AND"):
                raise ParseError("Expected AND in BETWEEN")
            hi = self.additive()
            return BinaryOp(
                "&&", BinaryOp(">=", node, lo), BinaryOp("<=", node, hi)
            )
        if self.match_kw("LIKE"):
            tok = self.peek()
            if tok.type is not TokenType.STRING:
                raise ParseError("Expected string pattern after LIKE")
            self.advance()
            return LikePattern(node, tok.value)
        # ILIKE — contextual (PostgreSQL's case-insensitive LIKE).
        if (
            self.peek().type is TokenType.IDENTIFIER
            and self.peek().value.upper() == "ILIKE"
        ):
            self.advance()
            tok = self.peek()
            if tok.type is not TokenType.STRING:
                raise ParseError("Expected string pattern after ILIKE")
            self.advance()
            return LikePattern(node, tok.value, ci=True)
        # REGEXP / RLIKE — contextual (MySQL's regex predicate): the
        # pattern is a full regular expression with re.search
        # semantics, matched against the vocabulary at plan lowering
        # (one boolean LUT gather on device, same as LIKE).
        if (
            self.peek().type is TokenType.IDENTIFIER
            and self.peek().value.upper() in ("REGEXP", "RLIKE")
        ):
            word = self.advance().value.upper()
            tok = self.peek()
            if tok.type is not TokenType.STRING:
                raise ParseError(f"Expected string pattern after {word}")
            self.advance()
            return LikePattern(node, tok.value, regex=True)
        raise ParseError("Expected IN, BETWEEN or LIKE")

    def additive(self) -> Node:
        node = self.term()
        while True:
            op = self.match_op("+", "-")
            if op is None:
                return node
            node = BinaryOp(op, node, self.term())

    def term(self) -> Node:
        node = self.factor()
        while True:
            op = self.match_op("*", "/", "%")
            if op is None:
                return node
            node = BinaryOp(op, node, self.factor())

    def factor(self) -> Node:
        tok = self.peek()
        # Unary minus/plus (extension over the reference grammar, which
        # has neither): -x lowers to (0 - x) so every downstream pass
        # sees only binary arithmetic.
        if tok.type is TokenType.OPERATOR and tok.value == "-":
            self.advance()
            return BinaryOp("-", Constant("0"), self.factor())
        if tok.type is TokenType.OPERATOR and tok.value == "+":
            self.advance()
            return self.factor()
        if tok.type is TokenType.KEYWORD and tok.value == "NULL":
            # Bare NULL literal (extension): the engine's missing value
            # is NaN; nullval() is a registered builtin returning it.
            self.advance()
            return FunctionCall("nullval", ())
        if tok.type is TokenType.KEYWORD and tok.value == "CASE":
            self.advance()
            # Simple form ``CASE operand WHEN v THEN r …`` rewrites each
            # branch to the searched form's ``operand == v`` (standard).
            operand: Optional[Node] = None
            if not (
                self.pos < len(self.toks)
                and self.toks[self.pos].type is TokenType.KEYWORD
                and self.toks[self.pos].value == "WHEN"
            ):
                operand = self.logical_or()
            conds: list[Node] = []
            vals: list[Node] = []
            while self.match_kw("WHEN"):
                cond = self.logical_or()
                if operand is not None:
                    cond = BinaryOp("==", operand, cond)
                conds.append(cond)
                if not self.match_kw("THEN"):
                    raise ParseError("Expected THEN in CASE expression")
                vals.append(self.logical_or())
            if not conds:
                raise ParseError("CASE requires at least one WHEN branch")
            default = None
            if self.match_kw("ELSE"):
                default = self.logical_or()
            if not self.match_kw("END"):
                raise ParseError("Expected END to close CASE expression")
            return CaseWhen(tuple(conds), tuple(vals), default)
        if tok.type is TokenType.NUMBER:
            self.advance()
            return Constant(tok.value)
        if tok.type is TokenType.STRING:
            self.advance()
            return StringLiteral(tok.value)
        if tok.type is TokenType.IDENTIFIER:
            self.advance()
            # EXISTS (SELECT …) — contextual (requires the literal
            # "(SELECT" to follow, so exists(...) stays available as a
            # UDF name and a bare "exists" column keeps working).
            if (
                tok.value.upper() == "EXISTS"
                and self.peek().type is TokenType.OPERATOR
                and self.peek().value == "("
                and self.pos + 1 < len(self.toks)
                and self.toks[self.pos + 1].type is TokenType.KEYWORD
                and self.toks[self.pos + 1].value == "SELECT"
            ):
                self.advance()  # consume '('
                return ExistsSubquery(self._collect_subquery())
            # CAST(expr AS type) — contextual (a column named "cast"
            # still works).  The pipeline is all-f32 (reference parity),
            # so integer casts lower to trunc() and float casts are
            # identity; BOOLEAN lowers to (expr != 0).
            if tok.value.upper() == "CAST" and self.match_op("("):
                inner = self.logical_or()
                if not self.match_kw("AS"):
                    raise ParseError("Expected AS in CAST")
                ttok = self.peek()
                if ttok.type not in (
                    TokenType.IDENTIFIER, TokenType.KEYWORD,
                ):
                    raise ParseError("Expected a type name in CAST")
                self.advance()
                tname = ttok.value.upper()
                if not self.match_op(")"):
                    raise ParseError("Expected ')' after arguments")
                if tname in (
                    "INT", "INTEGER", "BIGINT", "SMALLINT", "TINYINT",
                ):
                    return FunctionCall("trunc", (inner,))
                if tname in (
                    "FLOAT", "REAL", "DOUBLE", "DECIMAL", "NUMERIC",
                ):
                    return inner
                if tname in ("BOOLEAN", "BOOL"):
                    return BinaryOp("!=", inner, Constant("0"))
                raise ParseError(f"Unsupported CAST type: {tname}")
            # STDDEV / VARIANCE family — contextual aggregates rewritten
            # into agg arithmetic over the existing mergeable partials
            # (SUM, SUM of squares, COUNT): no new plan machinery, and
            # they distribute/stream wherever those partials do.  f32
            # throughout (reference's all-f32 pipeline), so extreme
            # mean-to-spread ratios lose precision to cancellation.
            if tok.value.upper() in _VARIANCE_FNS and self.match_op("("):
                inner = self.logical_or()
                if not self.match_op(")"):
                    raise ParseError("Expected ')' after arguments")
                return self._maybe_filter_suffix(
                    _variance_rewrite(tok.value.upper(), inner)
                )
            # MEDIAN(expr) — contextual aggregate (not a reserved word;
            # a bare column named "median" still parses as a Variable).
            # EXTRACT(part FROM expr) — standard spelling of the
            # date-part functions (lowers to the same YEAR()/MONTH()/…
            # vocabulary-transform calls; extension — the reference has
            # no date support at all).
            if tok.value.upper() == "EXTRACT" and self.match_op("("):
                part_tok = self.peek()
                if part_tok.type is not TokenType.IDENTIFIER or (
                    part_tok.value.upper()
                    not in ("YEAR", "MONTH", "DAY", "HOUR", "MINUTE",
                            "SECOND")
                ):
                    raise ParseError(
                        "EXTRACT expects YEAR/MONTH/DAY/HOUR/MINUTE/"
                        "SECOND"
                    )
                self.advance()
                if not self.match_kw("FROM"):
                    raise ParseError("Expected FROM in EXTRACT")
                inner = self.logical_or()
                if not self.match_op(")"):
                    raise ParseError("Expected ')' after arguments")
                return FunctionCall(part_tok.value.lower(), (inner,))
            if tok.value.upper() == "MEDIAN" and self.match_op("("):
                inner = self.logical_or()
                if not self.match_op(")"):
                    raise ParseError("Expected ')' after arguments")
                return self._maybe_filter_suffix(
                    Aggregation(AggregationType.MEDIAN, inner)
                )
            # APPROX_COUNT_DISTINCT(expr) — contextual aggregate:
            # HyperLogLog estimate with bounded mergeable state (the
            # streaming/distributed-friendly sibling of the exact
            # COUNT(DISTINCT)).
            if tok.value.upper() == "APPROX_COUNT_DISTINCT" and (
                self.match_op("(")
            ):
                inner = self.logical_or()
                if not self.match_op(")"):
                    raise ParseError("Expected ')' after arguments")
                return self._maybe_filter_suffix(
                    Aggregation(
                        AggregationType.APPROX_COUNT_DISTINCT, inner
                    )
                )
            # TRUE / FALSE boolean literals (extension) — lower to
            # always-true/false comparisons so they work both as values
            # (0/1 f32, the engine's boolean convention) and as WHERE
            # conditions the optimizer's interval analysis can prune.
            # Contextual: a call ``true(...)`` still resolves as a UDF.
            if tok.value.upper() in ("TRUE", "FALSE") and not (
                self.peek().type is TokenType.OPERATOR
                and self.peek().value == "("
            ):
                if tok.value.upper() == "TRUE":
                    return BinaryOp("==", Constant("1"), Constant("1"))
                return BinaryOp("==", Constant("1"), Constant("0"))
            # BOOL_AND / BOOL_OR (extension): every/any row satisfies the
            # predicate — rewritten to MIN/MAX over the predicate's 0/1
            # CASE form, so they group, distribute, and stream wherever
            # plain MIN/MAX do.  ANY_VALUE picks a deterministic witness
            # (the minimum; the standard allows any input value).
            if tok.value.upper() in ("BOOL_AND", "BOOL_OR") and (
                self.match_op("(")
            ):
                inner = self.logical_or()
                if not self.match_op(")"):
                    raise ParseError("Expected ')' after arguments")
                case = CaseWhen((inner,), (Constant("1"),), Constant("0"))
                agg = (
                    AggregationType.MIN
                    if tok.value.upper() == "BOOL_AND"
                    else AggregationType.MAX
                )
                return self._maybe_filter_suffix(Aggregation(agg, case))
            if tok.value.upper() == "ANY_VALUE" and self.match_op("("):
                inner = self.logical_or()
                if not self.match_op(")"):
                    raise ParseError("Expected ')' after arguments")
                return self._maybe_filter_suffix(
                    Aggregation(AggregationType.MIN, inner)
                )
            # STRING_AGG(expr, 'sep') / GROUP_CONCAT(expr[, 'sep']) —
            # contextual grouped string concatenation (ascending value
            # order; deterministic).
            if tok.value.upper() in ("STRING_AGG", "GROUP_CONCAT") and (
                self.match_op("(")
            ):
                inner = self.logical_or()
                sep = "," if tok.value.upper() == "GROUP_CONCAT" else None
                if self.match_op(","):
                    sep_tok = self.peek()
                    if sep_tok.type is not TokenType.STRING:
                        raise ParseError(
                            f"{tok.value.upper()} separator must be a "
                            "string literal"
                        )
                    self.advance()
                    sep = sep_tok.value
                elif sep is None:
                    raise ParseError(
                        "STRING_AGG requires a separator: "
                        "STRING_AGG(expr, 'sep')"
                    )
                if not self.match_op(")"):
                    raise ParseError("Expected ')' after arguments")
                return self._maybe_filter_suffix(
                    Aggregation(AggregationType.STRING_AGG, inner, sep)
                )
            # PERCENTILE(expr, q) — contextual parameterised aggregate.
            if tok.value.upper() == "PERCENTILE" and self.match_op("("):
                inner = self.logical_or()
                if not self.match_op(","):
                    raise ParseError(
                        "Expected ',' and a quantile in PERCENTILE"
                    )
                qtok = self.peek()
                if qtok.type is not TokenType.NUMBER:
                    raise ParseError(
                        "Expected a numeric quantile in PERCENTILE"
                    )
                self.advance()
                q = float(qtok.value)
                if not 0.0 <= q <= 1.0:
                    raise ParseError(
                        "PERCENTILE quantile must be between 0 and 1"
                    )
                if not self.match_op(")"):
                    raise ParseError("Expected ')' after arguments")
                return self._maybe_filter_suffix(
                    Aggregation(AggregationType.PERCENTILE, inner, q)
                )
            if self.match_op("("):
                args: list[Node] = []
                if not self.match_op(")"):
                    while True:
                        args.append(self.logical_or())
                        if not self.match_op(","):
                            break
                    if not self.match_op(")"):
                        raise ParseError("Expected ')' after arguments")
                return FunctionCall(tok.value, tuple(args))
            return Variable(tok.value)
        # Aggregates appearing inside plain expressions (e.g. a HAVING
        # clause like ``SUM(price) > 15``) parse as Aggregation nodes.
        if tok.type is TokenType.KEYWORD and tok.value in _AGG_KEYWORDS:
            self.advance()
            if not self.match_op("("):
                raise ParseError(f"Invalid syntax for {tok.value} aggregation")
            # COUNT(*) / COUNT(DISTINCT e) — extensions over the reference.
            if tok.value == "COUNT" and self.match_op("*"):
                if not self.match_op(")"):
                    raise ParseError("Expected ')' after arguments")
                return self._maybe_filter_suffix(
                    Aggregation(AggregationType.COUNT, Star())
                )
            if tok.value == "COUNT" and self.match_kw("DISTINCT"):
                inner = self.logical_or()
                if not self.match_op(")"):
                    raise ParseError("Expected ')' after arguments")
                return self._maybe_filter_suffix(
                    Aggregation(AggregationType.COUNT_DISTINCT, inner)
                )
            inner = self.logical_or()
            if not self.match_op(")"):
                raise ParseError("Expected ')' after arguments")
            return self._maybe_filter_suffix(
                Aggregation(_AGG_KEYWORDS[tok.value], inner)
            )
        if self.match_op("("):
            # Scalar subquery: (SELECT …) as a value (extension;
            # uncorrelated — resolved to a constant before execution).
            if self._at_select():
                return ScalarSubquery(self._collect_subquery())
            # Superset of the reference (which only allowed additive
            # expressions inside parens, expression.cpp:228-231): full
            # boolean grouping parses here too.
            node = self.logical_or()
            if not self.match_op(")"):
                raise ParseError("Expected ')'")
            return node
        raise ParseError(
            f"Unexpected token ({tok.type.value}: {tok.value})"
        )

    def expect_end(self, node: Node) -> Node:
        if self.peek().type is not TokenType.END:
            raise ParseError(f"Unexpected tokens remaining: {self.peek().value}")
        return node


def _tokens(tokens_or_text) -> list[Token]:
    if isinstance(tokens_or_text, str):
        return tokenize(tokens_or_text)
    return list(tokens_or_text)


def parse_expression(tokens) -> Node:
    """Parse a full expression (entry precedence: logical OR)."""
    p = _ExprParser(_tokens(tokens))
    return p.expect_end(p.logical_or())


def parse_logical_and(tokens) -> Node:
    p = _ExprParser(_tokens(tokens))
    return p.expect_end(p.logical_and())


def parse_logical_or(tokens) -> Node:
    p = _ExprParser(_tokens(tokens))
    return p.expect_end(p.logical_or())


def parse_expression_text(text: str) -> Node:
    return parse_expression(tokenize(text))


# ---------------------------------------------------------------------------
# SQL query parser
# ---------------------------------------------------------------------------

_CLAUSE_BOUNDARY_AFTER_JOIN = (
    "WHERE", "GROUP", "ORDER", "HAVING", "JOIN", "LEFT", "RIGHT", "FULL",
    "INNER", "LIMIT", "OFFSET",
)
_CLAUSE_BOUNDARY_AFTER_WHERE = ("GROUP", "ORDER", "HAVING", "LIMIT", "OFFSET")
_CLAUSE_BOUNDARY_AFTER_HAVING = ("ORDER", "LIMIT", "OFFSET")


def _at_ident(p: "_QueryParser", word: str) -> bool:
    """True when the next token is the identifier ``word`` (case-insensitive).
    Used for contextual (non-reserved) words like ROWS/UNBOUNDED/PRECEDING."""
    return (
        p.pos < len(p.toks)
        and p.toks[p.pos].type is TokenType.IDENTIFIER
        and p.toks[p.pos].value.upper() == word
    )


def _parse_rows_frame(
    p: "_QueryParser", range_frame: bool = False, word: Optional[str] = None,
) -> tuple:
    """Parse a ROWS, RANGE, or GROUPS frame (the leading frame word
    already consumed): ``BETWEEN <bound> AND <bound>`` or the shorthand
    ``<bound>`` (meaning BETWEEN <bound> AND CURRENT ROW).  Bounds:
    ``UNBOUNDED PRECEDING``, ``<n> PRECEDING``, ``CURRENT ROW``,
    ``<n> FOLLOWING``, ``UNBOUNDED FOLLOWING``.  Returns
    ``(preceding, following)`` with ``None`` = unbounded — relative row
    counts (ints) for ROWS, order-key-value offsets (floats) for RANGE;
    start/end are normalised so the frame always contains the current
    row (start ≤ 0 ≤ end) — the engine rejects frames excluding it."""

    def bound() -> tuple:
        """Returns (kind, n): kind ∈ {'prec','foll','cur'}, n = count|None."""
        if _at_ident(p, "UNBOUNDED"):
            p.pos += 1
            if _at_ident(p, "PRECEDING"):
                p.pos += 1
                return ("prec", None)
            if _at_ident(p, "FOLLOWING"):
                p.pos += 1
                return ("foll", None)
            line, col = p._loc()
            raise ParseError(
                f"Expected PRECEDING or FOLLOWING after UNBOUNDED "
                f"at line {line} column {col}"
            )
        if _at_ident(p, "CURRENT"):
            p.pos += 1
            if not _at_ident(p, "ROW"):
                line, col = p._loc()
                raise ParseError(
                    f"Expected ROW after CURRENT at line {line} column {col}"
                )
            p.pos += 1
            return ("cur", 0)
        if (
            p.pos < len(p.toks)
            and p.toks[p.pos].type is TokenType.NUMBER
        ):
            n = float(p.toks[p.pos].value)
            if not range_frame:
                n = int(n)
            if n < 0:
                line, col = p._loc()
                raise ParseError(
                    f"Frame bound must be non-negative at line {line} "
                    f"column {col}"
                )
            p.pos += 1
            if _at_ident(p, "PRECEDING"):
                p.pos += 1
                return ("prec", n)
            if _at_ident(p, "FOLLOWING"):
                p.pos += 1
                return ("foll", n)
            line, col = p._loc()
            raise ParseError(
                f"Expected PRECEDING or FOLLOWING in frame bound "
                f"at line {line} column {col}"
            )
        line, col = p._loc()
        raise ParseError(
            f"Expected frame bound at line {line} column {col}"
        )

    if p.at_kw("BETWEEN"):
        p.pos += 1
        start = bound()
        p.expect_kw("AND")
        end = bound()
    else:
        start = bound()
        end = ("cur", 0)

    # Normalise to (preceding, following); the frame must contain the
    # current row (start on/before it, end on/after it).
    if start[0] == "foll" or end[0] == "prec":
        raise ParseError(
            (word or ("RANGE" if range_frame else "ROWS"))
            + " frames must include the current row "
            "(start ≤ CURRENT ROW ≤ end)"
        )
    zero = 0.0 if range_frame else 0
    preceding = start[1] if start[0] == "prec" else zero
    following = end[1] if end[0] == "foll" else zero
    return (preceding, following)


class _QueryParser:
    def __init__(self, tokens: list[Token]):
        # Strip the trailing End token; clause slicing re-appends it.
        if tokens and tokens[-1].type is TokenType.END:
            self.end_tok = tokens[-1]
            tokens = tokens[:-1]
        else:
            self.end_tok = Token(TokenType.END, "")
        self.toks = tokens
        self.pos = 0

    def _loc(self) -> tuple[int, int]:
        if self.pos < len(self.toks):
            tok = self.toks[self.pos]
        elif self.toks:
            tok = self.toks[-1]
        else:
            tok = self.end_tok
        return tok.line, tok.column

    def at_kw(self, *kws: str) -> bool:
        return (
            self.pos < len(self.toks)
            and self.toks[self.pos].type is TokenType.KEYWORD
            and self.toks[self.pos].value in kws
        )

    def at_op(self, op: str) -> bool:
        return (
            self.pos < len(self.toks)
            and self.toks[self.pos].type is TokenType.OPERATOR
            and self.toks[self.pos].value == op
        )

    def expect_kw(self, kw: str) -> None:
        if not self.at_kw(kw):
            line, col = self._loc()
            raise ParseError(
                f"Expected keyword '{kw}' at line {line} column {col}"
            )
        self.pos += 1

    def _find_window_spans(self, body: list[Token]) -> list:
        """Top-level ``FN ( … ) OVER ( … | name )`` token spans."""
        spans = []
        i, n = 0, len(body)
        while i < n:
            tok = body[i]
            is_head = (
                tok.type is TokenType.KEYWORD and tok.value in _AGG_KEYWORDS
            ) or (
                tok.type is TokenType.IDENTIFIER
                and tok.value.upper() in _RANK_KEYWORDS
            ) or (
                tok.type is TokenType.IDENTIFIER
                and tok.value.upper() in _ARG_WINDOW_FNS
            ) or (
                tok.type is TokenType.IDENTIFIER
                and tok.value.upper() in _VARIANCE_FNS
            )
            if not (
                is_head
                and i + 1 < n
                and body[i + 1].type is TokenType.OPERATOR
                and body[i + 1].value == "("
            ):
                i += 1
                continue
            d = 0
            j = i + 1
            while j < n:
                t = body[j]
                if t.type is TokenType.OPERATOR and t.value == "(":
                    d += 1
                elif t.type is TokenType.OPERATOR and t.value == ")":
                    d -= 1
                    if d == 0:
                        break
                j += 1
            if j >= n:
                break  # unbalanced — let the normal parse error out
            if not (
                j + 1 < n
                and body[j + 1].type is TokenType.KEYWORD
                and body[j + 1].value == "OVER"
            ):
                i = j + 1
                continue
            k = j + 2
            if (
                k < n
                and body[k].type is TokenType.OPERATOR
                and body[k].value == "("
            ):
                d = 0
                while k < n:
                    t = body[k]
                    if t.type is TokenType.OPERATOR and t.value == "(":
                        d += 1
                    elif t.type is TokenType.OPERATOR and t.value == ")":
                        d -= 1
                        if d == 0:
                            break
                    k += 1
                if k >= n:
                    break
                end = k
            elif k < n and body[k].type is TokenType.IDENTIFIER:
                end = k  # named window: OVER w
            else:
                raise ParseError("Expected window specification after OVER")
            spans.append((i, end))
            i = end + 1
        return spans

    def _maybe_embedded_windows(self, body: list[Token]):
        """Parse a select item whose expression CONTAINS window
        functions (not a lone ``FN(...) OVER (...)`` item — those keep
        the dedicated path).  Each window span parses via the
        single-item machinery and grafts back through a placeholder."""
        spans = self._find_window_spans(body)
        if not spans:
            return None
        lone = len(spans) == 1 and spans[0] == (0, len(body) - 1)
        if lone and body[0].value.upper() not in _VARIANCE_FNS:
            return None  # lone window item — dedicated path handles it
        if lone:
            return self._parse_window_span(body)
        placeholders: list[Node] = []
        new_toks: list[Token] = []
        prev = 0
        for a, b in spans:
            new_toks += body[prev:a]
            placeholders.append(self._parse_window_span(body[a : b + 1]))
            new_toks.append(
                Token(TokenType.IDENTIFIER, f"__wf{len(placeholders) - 1}")
            )
            prev = b + 1
        new_toks += body[prev:]
        node = parse_expression(new_toks + [Token(TokenType.END, "")])

        from .ast import transform

        def repl(n):
            if isinstance(n, Variable) and n.qualifier is None and (
                n.name.startswith("__wf")
            ):
                try:
                    return placeholders[int(n.name[4:])]
                except (ValueError, IndexError):
                    return n
            return n

        return transform(node, repl)

    def _parse_window_span(self, toks: list[Token]) -> Node:
        """Parse one ``FN ( … ) OVER ( … | name )`` span.  Variance-
        family heads rewrite to arithmetic over SUM/COUNT windows of the
        same spec (the window pipeline lowers bare SUM/COUNT; the
        surrounding expression evaluates host-side)."""
        up = toks[0].value.upper()
        if up not in _VARIANCE_FNS:
            return self.parse_select_item(
                toks + [Token(TokenType.END, "")]
            )
        # Locate the top-level OVER split.
        d = 0
        over_idx = None
        for k, t in enumerate(toks):
            if t.type is TokenType.OPERATOR and t.value == "(":
                d += 1
            elif t.type is TokenType.OPERATOR and t.value == ")":
                d -= 1
            elif d == 0 and t.type is TokenType.KEYWORD and t.value == "OVER":
                over_idx = k
                break
        if over_idx is None or over_idx < 4:
            raise ParseError(f"Invalid window syntax for {up}")
        inner = parse_expression(
            toks[2 : over_idx - 1] + [Token(TokenType.END, "")]
        )
        over_part = toks[over_idx:]
        var_expr = _variance_rewrite(up, inner)

        from .ast import transform

        def to_window(n):
            if isinstance(n, Aggregation):
                return self._parse_window(
                    n.agg, n.expr, list(over_part), param=n.param
                )
            return n

        return transform(var_expr, to_window)

    def _parse_qualify(self, toks: list[Token]) -> Node:
        """QUALIFY predicate: an AND-chain of comparisons where either
        side of each comparison may be a window-function item
        (``ROW_NUMBER() OVER (…) <= 3``).  Window functions only parse
        at item level (the expression grammar has no OVER), so each side
        routes through :meth:`parse_select_item`, which falls back to
        ``parse_expression`` for plain sides."""
        body = [t for t in toks if t.type is not TokenType.END]
        parts: list[list[Token]] = []
        depth = 0
        start = 0
        for k, tok in enumerate(body):
            if tok.type is TokenType.OPERATOR and tok.value == "(":
                depth += 1
            elif tok.type is TokenType.OPERATOR and tok.value == ")":
                depth -= 1
            elif (
                depth == 0
                and tok.type is TokenType.KEYWORD
                and tok.value == "AND"
            ):
                parts.append(body[start:k])
                start = k + 1
        parts.append(body[start:])
        node: Optional[Node] = None
        for p in parts:
            if not p:
                raise ParseError("Empty QUALIFY predicate")
            c = self._parse_qualify_cmp(p)
            node = c if node is None else BinaryOp("&&", node, c)
        if node is None:
            raise ParseError("Empty QUALIFY predicate")
        return node

    def _parse_qualify_cmp(self, body: list[Token]) -> Node:
        depth = 0
        for k, tok in enumerate(body):
            if tok.type is TokenType.OPERATOR and tok.value == "(":
                depth += 1
            elif tok.type is TokenType.OPERATOR and tok.value == ")":
                depth -= 1
            elif (
                depth == 0
                and tok.type is TokenType.OPERATOR
                and tok.value in _COMPARISON_OPS
            ):
                end = [Token(TokenType.END, "")]
                return BinaryOp(
                    tok.value,
                    self.parse_select_item(body[:k] + end),
                    self.parse_select_item(body[k + 1 :] + end),
                )
        return self.parse_select_item(body + [Token(TokenType.END, "")])

    def _order_term_expr(self, ord_toks, q) -> Node:
        """Parse one ORDER BY term; a bare integer literal resolves as a
        1-based select-list ordinal (``ORDER BY 2 DESC`` — standard
        output-column reference; extension over the reference grammar)."""
        if (
            len(ord_toks) == 2  # NUMBER + END sentinel
            and ord_toks[0].type is TokenType.NUMBER
            and "." not in ord_toks[0].value
        ):
            ix = int(ord_toks[0].value)
            if not 1 <= ix <= len(q.select_list):
                raise ParseError(
                    f"ORDER BY position {ix} is not in the select list"
                )
            item = q.select_list[ix - 1]
            while isinstance(item, Alias):
                item = item.expr
            if isinstance(item, Star):
                raise ParseError(
                    "ORDER BY ordinal cannot reference a * select item"
                )
            return item
        return parse_expression(ord_toks)

    def _at_nulls_placement(self) -> bool:
        """At contextual ``NULLS FIRST`` / ``NULLS LAST``?"""
        nxt = self._peek_tok(1)
        return (
            self._at_ident("NULLS")
            and nxt is not None
            and nxt.type is TokenType.IDENTIFIER
            and nxt.value.upper() in ("FIRST", "LAST")
        )

    def _at_ident(self, *names: str) -> bool:
        """Contextual (non-reserved) keyword test — ROLLUP/CUBE/GROUPING
        tokenize as identifiers, so they stay usable as column names."""
        return (
            self.pos < len(self.toks)
            and self.toks[self.pos].type is TokenType.IDENTIFIER
            and self.toks[self.pos].value.upper() in names
        )

    def _peek_tok(self, off: int) -> Optional[Token]:
        i = self.pos + off
        return self.toks[i] if i < len(self.toks) else None

    def _slice_balanced(self) -> list[Token]:
        """Tokens until a top-level ',' or ')' (parenthesised lists)."""
        start = self.pos
        depth = 0
        while self.pos < len(self.toks):
            tok = self.toks[self.pos]
            if tok.type is TokenType.OPERATOR and tok.value == "(":
                depth += 1
            elif tok.type is TokenType.OPERATOR and tok.value == ")":
                if depth == 0:
                    break
                depth -= 1
            elif (
                tok.type is TokenType.OPERATOR
                and tok.value == ","
                and depth == 0
            ):
                break
            self.pos += 1
        return self.toks[start : self.pos] + [Token(TokenType.END, "")]

    def _paren_key_list(self) -> list[Node]:
        """Parse ``( [expr [, expr]*] )`` into key expressions."""
        line, col = self._loc()
        if not self.at_op("("):
            raise ParseError(f"Expected '(' at line {line} column {col}")
        self.pos += 1
        items: list[Node] = []
        if self.at_op(")"):
            self.pos += 1
            return items
        while True:
            items.append(parse_expression(self._slice_balanced()))
            if self.at_op(","):
                self.pos += 1
                continue
            line, col = self._loc()
            if not self.at_op(")"):
                raise ParseError(
                    f"Expected ')' at line {line} column {col}"
                )
            self.pos += 1
            return items

    def _parse_group_by(self) -> GroupBy:
        """GROUP BY element list.  Elements are plain key expressions or
        the multi-set constructs ROLLUP(...) / CUBE(...) /
        GROUPING SETS ((...), ...) — extension; the reference grammar has
        plain GROUP BY only (expression.hpp:132-143).  Mixed elements
        follow the standard: the statement's grouping sets are the
        cross-product concatenation of each element's alternatives."""
        elements: list[list[list[Node]]] = []  # element → alternatives → keys
        plain = True
        while self.pos < len(self.toks):
            nxt = self._peek_tok(1)
            at_call = (
                nxt is not None
                and nxt.type is TokenType.OPERATOR
                and nxt.value == "("
            )
            if self._at_ident("ROLLUP") and at_call:
                self.pos += 1
                ks = self._paren_key_list()
                if not ks:
                    raise ParseError("ROLLUP requires at least one key")
                elements.append([ks[:i] for i in range(len(ks), -1, -1)])
                plain = False
            elif self._at_ident("CUBE") and at_call:
                self.pos += 1
                ks = self._paren_key_list()
                if not ks:
                    raise ParseError("CUBE requires at least one key")
                if len(ks) > 8:
                    raise ParseError(
                        "CUBE supports at most 8 keys (2^n grouping sets)"
                    )
                n = len(ks)
                elements.append(
                    [
                        [k for j, k in enumerate(ks) if mask >> (n - 1 - j) & 1]
                        for mask in range((1 << n) - 1, -1, -1)
                    ]
                )
                plain = False
            elif self._at_ident("GROUPING") and (
                nxt is not None
                and nxt.type is TokenType.IDENTIFIER
                and nxt.value.upper() == "SETS"
            ):
                self.pos += 2
                line, col = self._loc()
                if not self.at_op("("):
                    raise ParseError(
                        f"Expected '(' at line {line} column {col}"
                    )
                self.pos += 1
                alts: list[list[Node]] = []
                while True:
                    if self.at_op("("):
                        alts.append(self._paren_key_list())
                    else:
                        alts.append(
                            [parse_expression(self._slice_balanced())]
                        )
                    if self.at_op(","):
                        self.pos += 1
                        continue
                    line, col = self._loc()
                    if not self.at_op(")"):
                        raise ParseError(
                            f"Expected ')' at line {line} column {col}"
                        )
                    self.pos += 1
                    break
                elements.append(alts)
                plain = False
            else:
                key = self.slice_until(
                    "ORDER", "HAVING", "LIMIT", "OFFSET", stop_on_comma=True
                )
                elements.append([[parse_expression(key)]])
            if self.at_op(","):
                self.pos += 1
                continue
            break

        if plain:
            return GroupBy(tuple(e[0][0] for e in elements))

        # Master key list: first appearance order across every
        # alternative; sets index into it.
        master: list[Node] = []
        canon_ix: dict[str, int] = {}

        def ix(k: Node) -> int:
            c = k.canonical()
            if c not in canon_ix:
                canon_ix[c] = len(master)
                master.append(k)
            return canon_ix[c]

        for alts in elements:
            for ks in alts:
                for k in ks:
                    ix(k)
        total = 1
        for alts in elements:
            total *= len(alts)
        if total > 128:
            raise ParseError(
                "GROUP BY expands to more than 128 grouping sets"
            )
        import itertools

        sets: list[tuple[int, ...]] = []
        for combo in itertools.product(*elements):
            s: list[int] = []
            for ks in combo:
                for k in ks:
                    i = ix(k)
                    if i not in s:
                        s.append(i)
            sets.append(tuple(s))
        if len(sets) == 1 and sets[0] == tuple(range(len(master))):
            return GroupBy(tuple(master))  # degenerate: plain GROUP BY
        return GroupBy(tuple(master), tuple(sets))

    def slice_until(self, *stop_kws: str, stop_on_comma: bool = False) -> list[Token]:
        """Collect tokens until a top-level stop keyword (or comma)."""
        start = self.pos
        depth = 0
        while self.pos < len(self.toks):
            tok = self.toks[self.pos]
            if tok.type is TokenType.OPERATOR and tok.value == "(":
                depth += 1
            elif tok.type is TokenType.OPERATOR and tok.value == ")":
                depth -= 1
            if depth == 0:
                if tok.type is TokenType.KEYWORD and tok.value in stop_kws:
                    break
                if stop_on_comma and tok.type is TokenType.OPERATOR and tok.value == ",":
                    break
                # Contextual ``CROSS JOIN`` opens a join clause wherever
                # the JOIN keyword itself would stop the slice (a column
                # named `cross` can never directly precede JOIN in a
                # valid expression).
                if "JOIN" in stop_kws and self._at_cross_join():
                    break
                # Contextual ``NULLS FIRST|LAST`` ends an ORDER BY term
                # (two adjacent identifiers are never a valid expression,
                # so a column named `nulls` can't be confused here).
                if "ASC" in stop_kws and self._at_nulls_placement():
                    break
                # Contextual QUALIFY opens its clause wherever ORDER
                # would stop the slice (semi-reserved: a UDF named
                # ``qualify`` cannot be CALLED at the top level of a
                # clause tail — parenthesise it if ever needed).
                if (
                    "ORDER" in stop_kws
                    and tok.type is TokenType.IDENTIFIER
                    and tok.value.upper() == "QUALIFY"
                ):
                    break
            self.pos += 1
        out = self.toks[start : self.pos]
        return out + [Token(TokenType.END, "")]

    def _maybe_alias(self) -> Optional[str]:
        """Consume an optional relation alias after a table name:
        ``AS name`` or a bare identifier (standard SQL — every clause
        opener is a keyword, so a bare IDENTIFIER here can only be an
        alias)."""
        if self.at_kw("AS"):
            self.pos += 1
            if (
                self.pos >= len(self.toks)
                or self.toks[self.pos].type is not TokenType.IDENTIFIER
            ):
                line, col = self._loc()
                raise ParseError(
                    f"Expected alias after AS at line {line} column {col}"
                )
            alias = self.toks[self.pos].value
            self.pos += 1
            return alias
        if (
            self.pos < len(self.toks)
            and self.toks[self.pos].type is TokenType.IDENTIFIER
        ):
            # Contextual QUALIFY: a clause opener, not an alias for the
            # relation (alias a relation `qualify` with AS if needed).
            if self.toks[self.pos].value.upper() == "QUALIFY":
                return None
            # Contextual CROSS: in ``t CROSS JOIN u`` the identifier is
            # the join prefix, not an alias for t (a relation named or
            # aliased `cross` keeps working everywhere else).
            if self._at_cross_join():
                return None
            alias = self.toks[self.pos].value
            self.pos += 1
            return alias
        return None

    def _at_cross_join(self) -> bool:
        """True at the contextual ``CROSS JOIN`` prefix (CROSS is not a
        reserved keyword — the reference's 23-keyword set is preserved)."""
        return (
            self.pos < len(self.toks)
            and self.toks[self.pos].type is TokenType.IDENTIFIER
            and self.toks[self.pos].value.upper() == "CROSS"
            and self.pos + 1 < len(self.toks)
            and self.toks[self.pos + 1].type is TokenType.KEYWORD
            and self.toks[self.pos + 1].value == "JOIN"
        )

    # -- select items -------------------------------------------------------
    def parse_select_item(self, item: list[Token]) -> Node:
        """Parse one select item; handles AGG(expr), AGG(expr) OVER (...)
        (reference expression.cpp:296-337), COUNT(*) and ``expr AS name``
        aliases (extensions)."""
        body = item[:-1]  # drop End
        # Bare `*` select item (extension): expands to every column.
        if (
            len(body) == 1
            and body[0].type is TokenType.OPERATOR
            and body[0].value == "*"
        ):
            return Star()
        # Qualified star `t.*` (extension).  The lexer folds a trailing
        # dot into the identifier (`t.`); with whitespace it arrives as
        # three tokens (`t`, `.`, `*`).
        if (
            len(body) == 2
            and body[0].type is TokenType.IDENTIFIER
            and body[0].value.endswith(".")
            and body[1].type is TokenType.OPERATOR
            and body[1].value == "*"
        ):
            return Star(body[0].value[:-1])
        if (
            len(body) == 3
            and body[0].type is TokenType.IDENTIFIER
            and body[1].type is TokenType.OPERATOR
            and body[1].value == "."
            and body[2].type is TokenType.OPERATOR
            and body[2].value == "*"
        ):
            return Star(body[0].value)
        # Top-level AS alias: split, parse the prefix, wrap.
        depth = 0
        for k, tok in enumerate(body):
            if tok.type is TokenType.OPERATOR and tok.value == "(":
                depth += 1
            elif tok.type is TokenType.OPERATOR and tok.value == ")":
                depth -= 1
            elif depth == 0 and tok.type is TokenType.KEYWORD and tok.value == "AS":
                if (
                    k + 1 >= len(body)
                    or body[k + 1].type is not TokenType.IDENTIFIER
                    or k + 2 != len(body)
                ):
                    raise ParseError(
                        f"Expected column alias after AS at line {tok.line} "
                        f"column {tok.column}"
                    )
                inner = self.parse_select_item(
                    body[:k] + [Token(TokenType.END, "")]
                )
                return Alias(inner, body[k + 1].value)
        # Window functions embedded in larger expressions
        # (``v - AVG(v) OVER (PARTITION BY k)``): extract each window
        # span, parse it with the single-item machinery, and graft the
        # nodes back into the surrounding expression.
        emb = self._maybe_embedded_windows(body)
        if emb is not None:
            return emb
        # ROW_NUMBER() / RANK() OVER (...) — extension.  Contextual, not
        # reserved: a bare `rank` stays an ordinary column reference.
        if (
            len(body) >= 3
            and body[0].type is TokenType.IDENTIFIER
            and body[0].value.upper() in _RANK_KEYWORDS
            and body[1].type is TokenType.OPERATOR
            and body[1].value == "("
            and body[2].type is TokenType.OPERATOR
            and body[2].value == ")"
        ):
            if not (
                len(body) > 3
                and body[3].type is TokenType.KEYWORD
                and body[3].value == "OVER"
            ):
                raise ParseError(
                    f"{body[0].value}() requires an OVER (...) clause"
                )
            return self._parse_window(
                _RANK_KEYWORDS[body[0].value.upper()], Constant("1"), body[3:]
            )
        # LAG/LEAD/FIRST_VALUE/LAST_VALUE/NTILE (expr) OVER (...) —
        # contextual identifiers (a bare `lag` column keeps working),
        # expression argument, OVER mandatory.
        if (
            len(body) >= 4
            and body[0].type is TokenType.IDENTIFIER
            and body[0].value.upper() in _ARG_WINDOW_FNS
            and body[1].type is TokenType.OPERATOR
            and body[1].value == "("
        ):
            depth_sh = 0
            close = -1
            for k, tok in enumerate(body[1:], start=1):
                if tok.type is TokenType.OPERATOR and tok.value == "(":
                    depth_sh += 1
                elif tok.type is TokenType.OPERATOR and tok.value == ")":
                    depth_sh -= 1
                    if depth_sh == 0:
                        close = k
                        break
            if close > 1 and (
                close + 1 < len(body)
                and body[close + 1].type is TokenType.KEYWORD
                and body[close + 1].value == "OVER"
            ):
                agg = _ARG_WINDOW_FNS[body[0].value.upper()]
                arg_toks = body[2:close]
                param: Optional[int] = None
                if agg in _INT_PARAM_WINDOW_FNS:
                    # Split off an integer second argument at the
                    # top-level comma: LAG/LEAD(expr [, offset]),
                    # NTH_VALUE(expr, n).
                    depth_c = 0
                    comma = -1
                    for k, tok in enumerate(arg_toks):
                        if tok.type is TokenType.OPERATOR and tok.value == "(":
                            depth_c += 1
                        elif tok.type is TokenType.OPERATOR and tok.value == ")":
                            depth_c -= 1
                        elif (
                            depth_c == 0
                            and tok.type is TokenType.OPERATOR
                            and tok.value == ","
                        ):
                            comma = k
                            break
                    name = body[0].value.upper()
                    if comma >= 0:
                        ptoks = arg_toks[comma + 1 :]
                        arg_toks = arg_toks[:comma]
                        if not (
                            len(ptoks) == 1
                            and ptoks[0].type is TokenType.NUMBER
                            and float(ptoks[0].value) >= 1
                            and float(ptoks[0].value)
                            == int(float(ptoks[0].value))
                        ):
                            raise ParseError(
                                f"{name} takes a positive integer "
                                f"second argument"
                            )
                        param = int(float(ptoks[0].value))
                    elif agg is AggregationType.NTH_VALUE:
                        raise ParseError(
                            "NTH_VALUE requires a row number: "
                            "NTH_VALUE(expr, n)"
                        )
                inner_expr = parse_expression(
                    arg_toks + [Token(TokenType.END, "")]
                )
                if agg is AggregationType.NTILE and not (
                    isinstance(inner_expr, Constant)
                    and float(inner_expr.value) >= 1
                    and float(inner_expr.value) == int(inner_expr.value)
                ):
                    raise ParseError(
                        "NTILE requires a positive integer bucket count"
                    )
                return self._parse_window(
                    agg, inner_expr, body[close + 1 :], param=param
                )
        if body and body[0].type is TokenType.KEYWORD and body[0].value in _AGG_KEYWORDS:
            kw = body[0].value
            over_idx = len(body)
            depth = 0
            for k, tok in enumerate(body):
                if tok.type is TokenType.OPERATOR and tok.value == "(":
                    depth += 1
                elif tok.type is TokenType.OPERATOR and tok.value == ")":
                    depth -= 1
                elif depth == 0 and tok.type is TokenType.KEYWORD and tok.value == "OVER":
                    over_idx = k
                    break
            # The item is a lone AGG(...) [OVER ...] only when the paren
            # opened right after the keyword closes at over_idx-1; in
            # anything else (e.g. SUM(a)/COUNT(b)) the aggregate is part
            # of a larger expression — defer to parse_expression.
            has_paren = (
                over_idx > 1
                and body[1].type is TokenType.OPERATOR
                and body[1].value == "("
                and body[over_idx - 1].type is TokenType.OPERATOR
                and body[over_idx - 1].value == ")"
            )
            if has_paren:
                depth2 = 0
                for k in range(1, over_idx):
                    tok = body[k]
                    if tok.type is TokenType.OPERATOR and tok.value == "(":
                        depth2 += 1
                    elif tok.type is TokenType.OPERATOR and tok.value == ")":
                        depth2 -= 1
                        if depth2 == 0 and k != over_idx - 1:
                            has_paren = False
                            break
            if not has_paren:
                if over_idx < len(body):
                    raise ParseError(f"Invalid syntax for {kw} aggregation")
                return parse_expression(item)
            inner = body[2 : over_idx - 1] + [Token(TokenType.END, "")]
            agg_type = _AGG_KEYWORDS[kw]
            if (
                kw == "COUNT"
                and len(inner) == 2
                and inner[0].type is TokenType.OPERATOR
                and inner[0].value == "*"
            ):
                inner_expr: Node = Star()
            elif (
                kw == "COUNT"
                and inner
                and inner[0].type is TokenType.KEYWORD
                and inner[0].value == "DISTINCT"
            ):
                if over_idx < len(body):
                    raise ParseError(
                        "COUNT(DISTINCT ...) cannot be used as a window "
                        "function"
                    )
                agg_type = AggregationType.COUNT_DISTINCT
                inner_expr = parse_expression(inner[1:])
            else:
                inner_expr = parse_expression(inner)
            if over_idx < len(body):
                return self._parse_window(agg_type, inner_expr, body[over_idx:])
            return Aggregation(agg_type, inner_expr)
        return parse_expression(item)

    def _parse_window(
        self,
        agg: AggregationType,
        expr: Node,
        tail: list[Token],
        param: Optional[int] = None,
    ) -> WindowFunction:
        """Parse ``OVER ( [PARTITION BY k,…] [ORDER BY e [ASC|DESC]] )``.

        The reference drops everything after OVER (expression.cpp:296-329
        never inspects the window spec); we parse and execute it.
        """
        p = _QueryParser(tail + [Token(TokenType.END, "")])
        p.expect_kw("OVER")
        # ``OVER name`` — splice the named-window spec registered by the
        # statement's WINDOW clause.
        if (
            not p.at_op("(")
            and p.pos < len(p.toks)
            and p.toks[p.pos].type is TokenType.IDENTIFIER
        ):
            spec = getattr(self, "_named_windows", {}).get(
                p.toks[p.pos].value.lower()
            )
            if spec is None:
                raise ParseError(
                    f"Unknown window name: {p.toks[p.pos].value} "
                    "(declare it in a WINDOW clause)"
                )
            p.toks = p.toks[: p.pos] + list(spec) + p.toks[p.pos + 1 :]
        partition: tuple[Node, ...] = ()
        order: Optional[OrderBy] = None
        frame: Optional[tuple[Optional[int], Optional[int]]] = None
        if p.at_op("("):
            p.pos += 1
            if p.at_kw("PARTITION"):
                p.pos += 1
                p.expect_kw("BY")
                keys: list[Node] = []
                while True:
                    key_toks = []
                    depth = 0
                    while p.pos < len(p.toks):
                        tok = p.toks[p.pos]
                        if tok.type is TokenType.OPERATOR and tok.value == "(":
                            depth += 1
                        elif tok.type is TokenType.OPERATOR and tok.value == ")":
                            if depth == 0:
                                break
                            depth -= 1
                        if depth == 0 and (
                            (tok.type is TokenType.OPERATOR and tok.value == ",")
                            or (tok.type is TokenType.KEYWORD and tok.value == "ORDER")
                            # Contextual ROWS/RANGE starts a frame —
                            # but only once the key has content, so a
                            # column actually named "rows" still parses.
                            or (key_toks and (_at_ident(p, "ROWS")
                                              or _at_ident(p, "RANGE")
                                              or _at_ident(p, "GROUPS")))
                        ):
                            break
                        key_toks.append(tok)
                        p.pos += 1
                    keys.append(parse_expression(key_toks + [Token(TokenType.END, "")]))
                    if p.at_op(","):
                        p.pos += 1
                        continue
                    break
                partition = tuple(keys)
            if p.at_kw("ORDER"):
                p.pos += 1
                p.expect_kw("BY")
                ord_toks = []
                while p.pos < len(p.toks) and not (
                    p.at_kw("ASC", "DESC")
                    or p.at_op(")")
                    # Contextual: a column named "rows" may BE the order
                    # key, so only a non-leading ROWS opens the frame.
                    or (ord_toks and (_at_ident(p, "ROWS")
                                      or _at_ident(p, "RANGE")
                                      or _at_ident(p, "GROUPS")))
                ):
                    ord_toks.append(p.toks[p.pos])
                    p.pos += 1
                asc = True
                if p.at_kw("ASC", "DESC"):
                    asc = p.toks[p.pos].value == "ASC"
                    p.pos += 1
                order = OrderBy(
                    parse_expression(ord_toks + [Token(TokenType.END, "")]), asc
                )
            frame_type = "rows"
            if (
                _at_ident(p, "ROWS") or _at_ident(p, "RANGE")
                or _at_ident(p, "GROUPS")
            ):
                # ROWS/RANGE/GROUPS frame.  All frame words are
                # recognised contextually (NOT reserved keywords), so
                # columns with those names keep working everywhere else.
                # The reference never parses past OVER at all
                # (expression.cpp:296-329).
                is_range = _at_ident(p, "RANGE")
                is_groups = _at_ident(p, "GROUPS")
                frame_type = (
                    "range" if is_range else "groups" if is_groups
                    else "rows"
                )
                p.pos += 1
                frame = _parse_rows_frame(
                    p, range_frame=is_range, word=frame_type.upper()
                )
                if is_groups and order is None:
                    raise ParseError(
                        "GROUPS mode requires an ORDER BY inside "
                        "OVER (...)"
                    )
        return WindowFunction(
            agg, expr, partition, order, frame, frame_type, param
        )

    # -- the statement -------------------------------------------------------
    def _extract_window_clause(self) -> dict:
        """Pre-scan for a named-window clause ``WINDOW w AS (spec)
        [, w2 AS (spec2)]*`` (extension; standard SQL:2003).  The clause
        tokens are removed from the stream and the specs registered so
        ``OVER w`` splices them in during select-item parsing (select
        items parse before the clause position is reached).  Detection
        keys on the 4-token shape ``WINDOW <ident> AS (`` at top level —
        unambiguous: no expression or alias position allows it."""
        toks = self.toks
        depth = 0
        i = 0
        while i < len(toks):
            t = toks[i]
            if t.type is TokenType.OPERATOR and t.value == "(":
                depth += 1
            elif t.type is TokenType.OPERATOR and t.value == ")":
                depth -= 1
            elif (
                depth == 0
                and t.type is TokenType.IDENTIFIER
                and t.value.upper() == "WINDOW"
                and i + 3 < len(toks)
                and toks[i + 1].type is TokenType.IDENTIFIER
                and toks[i + 2].type is TokenType.KEYWORD
                and toks[i + 2].value == "AS"
                and toks[i + 3].type is TokenType.OPERATOR
                and toks[i + 3].value == "("
            ):
                start = i
                j = i + 1
                named: dict = {}
                while True:
                    name = toks[j].value.lower()
                    j += 2  # past `name AS`
                    d = 0
                    spec_start = j
                    while j < len(toks):
                        tt = toks[j]
                        if tt.type is TokenType.OPERATOR and tt.value == "(":
                            d += 1
                        elif tt.type is TokenType.OPERATOR and tt.value == ")":
                            d -= 1
                            if d == 0:
                                j += 1
                                break
                        j += 1
                    else:
                        raise ParseError(
                            "Expected ')' to close WINDOW specification"
                        )
                    named[name] = toks[spec_start:j]
                    if (
                        j + 3 < len(toks)
                        and toks[j].type is TokenType.OPERATOR
                        and toks[j].value == ","
                        and toks[j + 1].type is TokenType.IDENTIFIER
                        and toks[j + 2].type is TokenType.KEYWORD
                        and toks[j + 2].value == "AS"
                        and toks[j + 3].type is TokenType.OPERATOR
                        and toks[j + 3].value == "("
                    ):
                        j += 1
                        continue
                    break
                self.toks = toks[:start] + toks[j:]
                return named
            i += 1
        return {}

    def parse(self) -> Query:
        self._named_windows = self._extract_window_clause()
        q = Query()
        self.expect_kw("SELECT")
        if self.at_kw("DISTINCT"):
            q.distinct = True
            self.pos += 1

        while self.pos < len(self.toks) and not self.at_kw("FROM"):
            item = self.slice_until("FROM", stop_on_comma=True)
            q.select_list.append(self.parse_select_item(item))
            if self.at_op(","):
                self.pos += 1

        self.expect_kw("FROM")
        if self.at_op("("):
            # Derived table: FROM ( SELECT ... ) [AS] alias
            self.pos += 1
            depth = 1
            inner: list[Token] = []
            while self.pos < len(self.toks):
                tok = self.toks[self.pos]
                if tok.type is TokenType.OPERATOR and tok.value == "(":
                    depth += 1
                elif tok.type is TokenType.OPERATOR and tok.value == ")":
                    depth -= 1
                    if depth == 0:
                        break
                inner.append(tok)
                self.pos += 1
            if depth != 0:
                line, col = self._loc()
                raise ParseError(
                    f"Expected ')' to close subquery at line {line} "
                    f"column {col}"
                )
            self.pos += 1  # consume ')'
            q.from_subquery = _QueryParser(
                inner + [Token(TokenType.END, "")]
            ).parse()
            alias = "subquery"
            if self.at_kw("AS"):
                self.pos += 1
            if (
                self.pos < len(self.toks)
                and self.toks[self.pos].type is TokenType.IDENTIFIER
            ):
                alias = self.toks[self.pos].value
                self.pos += 1
            q.from_table = alias
        elif (
            self.pos >= len(self.toks)
            or self.toks[self.pos].type is not TokenType.IDENTIFIER
        ):
            line, col = self._loc()
            raise ParseError(
                f"Expected table name after FROM at line {line} column {col}"
            )
        else:
            q.from_table = self.toks[self.pos].value
            self.pos += 1
            alias = self._maybe_alias()
            if alias is not None:
                q.from_source = q.from_table
                q.from_table = alias

        # Implicit joins: ``FROM a, b [, c]`` (SQL-89 comma syntax) —
        # each extra relation parses as a CROSS JOIN; the executor's
        # implicit-join rewrite then lifts WHERE equality conjuncts
        # linking the relations into real equi-join conditions.
        while self.at_op(","):
            self.pos += 1
            if (
                self.pos >= len(self.toks)
                or self.toks[self.pos].type is not TokenType.IDENTIFIER
            ):
                line, col = self._loc()
                raise ParseError(
                    f"Expected table name after ',' at line {line} "
                    f"column {col}"
                )
            tname = self.toks[self.pos].value
            self.pos += 1
            alias = self._maybe_alias()
            q.joins.append(
                Join(
                    alias or tname,
                    None,
                    kind="cross",
                    source=tname if alias else None,
                )
            )

        while (
            self.at_kw("JOIN")
            or self.at_kw("LEFT")
            or self.at_kw("RIGHT")
            or self.at_kw("FULL")
            or self.at_kw("INNER")
            or self._at_cross_join()
        ):
            kind = "inner"
            if self._at_cross_join():
                kind = "cross"
                self.pos += 1
            elif self.at_kw("LEFT") or self.at_kw("RIGHT") or self.at_kw("FULL"):
                kind = self.toks[self.pos].value.lower()
                self.pos += 1
                if self.at_kw("OUTER"):
                    self.pos += 1
            elif self.at_kw("INNER"):
                self.pos += 1
            self.expect_kw("JOIN")
            if (
                self.pos >= len(self.toks)
                or self.toks[self.pos].type is not TokenType.IDENTIFIER
            ):
                line, col = self._loc()
                raise ParseError(
                    f"Expected table name after JOIN at line {line} column {col}"
                )
            table = self.toks[self.pos].value
            self.pos += 1
            source = None
            alias = self._maybe_alias()
            if alias is not None:
                source = table
                table = alias
            if kind == "cross":
                if self.at_kw("ON"):
                    raise ParseError("CROSS JOIN takes no ON condition")
                cond = None
            else:
                self.expect_kw("ON")
                cond = parse_expression(
                    self.slice_until(*_CLAUSE_BOUNDARY_AFTER_JOIN)
                )
            q.joins.append(Join(table, cond, kind, source))

        if self.at_kw("WHERE"):
            self.pos += 1
            q.where = parse_expression(self.slice_until(*_CLAUSE_BOUNDARY_AFTER_WHERE))

        if self.at_kw("GROUP"):
            self.pos += 1
            self.expect_kw("BY")
            q.group_by = self._parse_group_by()

        if self.at_kw("HAVING"):
            self.pos += 1
            q.having = parse_expression(self.slice_until(*_CLAUSE_BOUNDARY_AFTER_HAVING))

        if self._at_ident("QUALIFY"):
            # QUALIFY <predicate with window functions> (extension —
            # Snowflake/BigQuery/DuckDB): filters rows after windows
            # evaluate, before ORDER BY/LIMIT.
            self.pos += 1
            q.qualify = self._parse_qualify(
                self.slice_until("ORDER", "LIMIT", "OFFSET")
            )

        if self.at_kw("ORDER"):
            self.pos += 1
            self.expect_kw("BY")
            terms: list[OrderBy] = []
            while True:
                ord_toks = self.slice_until(
                    "ASC", "DESC", "LIMIT", "OFFSET", stop_on_comma=True
                )
                asc = True
                if self.at_kw("ASC", "DESC"):
                    asc = self.toks[self.pos].value == "ASC"
                    self.pos += 1
                # NULLS FIRST | NULLS LAST (extension; contextual
                # keywords).  The engine's total order already puts NaN
                # last ASC / first DESC (the PostgreSQL defaults); the
                # non-default placement prepends an IS-NULL flag term.
                nulls_first = None
                if self._at_nulls_placement():
                    self.pos += 1
                    nulls_first = self.toks[self.pos].value.upper() == "FIRST"
                    self.pos += 1
                expr = self._order_term_expr(ord_toks, q)
                # Bare output-column (alias) references resolve here so
                # the NULLS flag below wraps the resolved expression
                # (standard rule: a bare name prefers the select alias;
                # names inside larger expressions stay input columns).
                if isinstance(expr, Variable) and expr.qualifier is None:
                    for item in q.select_list:
                        if isinstance(item, Alias) and item.name == expr.name:
                            expr = item.expr
                            while isinstance(expr, Alias):
                                expr = expr.expr
                            break
                if nulls_first is not None and nulls_first != (not asc):
                    flag = FunctionCall("isnan", (expr,))
                    terms.append(OrderBy(flag, not nulls_first))
                terms.append(OrderBy(expr, asc))
                # Comma-separated tie-breaker terms (extension; the
                # reference allows exactly one ORDER BY expression).
                if self.at_op(","):
                    self.pos += 1
                    continue
                break
            q.order_by = OrderBy(
                terms[0].expr, terms[0].ascending, tuple(terms[1:])
            )

        # LIMIT / OFFSET in either order (reference intent; its own test
        # sql_features_test.cpp:33 writes "OFFSET 1 LIMIT 2").
        seen = set()
        while self.at_kw("LIMIT", "OFFSET") and len(seen) < 2:
            kw = self.toks[self.pos].value
            if kw in seen:
                break
            seen.add(kw)
            self.pos += 1
            if (
                self.pos >= len(self.toks)
                or self.toks[self.pos].type is not TokenType.NUMBER
            ):
                line, col = self._loc()
                raise ParseError(
                    f"Expected numeric value after {kw} at line {line} column {col}"
                )
            value = int(float(self.toks[self.pos].value))
            self.pos += 1
            if kw == "LIMIT":
                q.limit = value
            else:
                q.offset = value

        if self.pos != len(self.toks):
            raise ParseError(
                f"Unexpected token in query near: {self.toks[self.pos].value}"
            )
        return q


_SET_OPS = ("UNION", "EXCEPT", "INTERSECT")


def _parse_with_prefix(toks):
    """Consume ``WITH name AS ( query ) [, name2 AS ( query2 )]*`` from
    the front of a token list; returns (remaining tokens, ctes list).
    CTE bodies parse recursively through :func:`parse_query` (they may
    themselves contain set operations or nested WITHs)."""
    pos = 1  # past WITH
    ctes: list = []
    while True:
        if pos >= len(toks) or toks[pos].type is not TokenType.IDENTIFIER:
            raise ParseError("Expected CTE name after WITH")
        name = toks[pos].value
        pos += 1
        if not (
            pos < len(toks)
            and toks[pos].type is TokenType.KEYWORD
            and toks[pos].value == "AS"
        ):
            raise ParseError(f"Expected AS after WITH {name}")
        pos += 1
        if not (
            pos < len(toks)
            and toks[pos].type is TokenType.OPERATOR
            and toks[pos].value == "("
        ):
            raise ParseError(f"Expected '(' after WITH {name} AS")
        depth = 1
        pos += 1
        body_start = pos
        while pos < len(toks) and depth > 0:
            t = toks[pos]
            if t.type is TokenType.OPERATOR and t.value == "(":
                depth += 1
            elif t.type is TokenType.OPERATOR and t.value == ")":
                depth -= 1
            pos += 1
        if depth != 0:
            raise ParseError(f"Expected ')' closing WITH {name} AS (")
        ctes.append((name, parse_query(toks[body_start : pos - 1])))
        if (
            pos < len(toks)
            and toks[pos].type is TokenType.OPERATOR
            and toks[pos].value == ","
        ):
            pos += 1
            continue
        break
    return toks[pos:], ctes


def parse_query(tokens) -> Query:
    """Parse a SELECT statement (or raw SQL text), including top-level
    ``UNION / EXCEPT / INTERSECT [ALL]`` chains (extension).  The token
    stream splits at paren-depth-0 set-operation boundaries; each
    segment parses as a full SELECT.  The op list is kept flat in
    source order — standard INTERSECT-binds-tighter precedence is
    applied at evaluation (``api.py`` ``_setop_table``).  ORDER BY/
    LIMIT/OFFSET are only legal on the final branch (standard SQL:
    they apply to the whole combined result)."""
    toks = _tokens(tokens)
    if toks and toks[-1].type is TokenType.END:
        toks = toks[:-1]

    ctes: list = []
    if toks and toks[0].type is TokenType.KEYWORD and toks[0].value == "WITH":
        toks, ctes = _parse_with_prefix(toks)

    segments: list[list[Token]] = []
    ops: list[str] = []
    all_flags: list[bool] = []
    depth = 0
    start = 0
    i = 0
    while i < len(toks):
        t = toks[i]
        if t.type is TokenType.OPERATOR and t.value == "(":
            depth += 1
        elif t.type is TokenType.OPERATOR and t.value == ")":
            depth -= 1
        elif (
            depth == 0
            and t.type is TokenType.KEYWORD
            and t.value in _SET_OPS
        ):
            segments.append(toks[start:i])
            ops.append(t.value)
            j = i + 1
            all_flag = False
            if (
                j < len(toks)
                and toks[j].type is TokenType.KEYWORD
                and toks[j].value == "ALL"
            ):
                all_flag = True
                j += 1
            all_flags.append(all_flag)
            start = j
            i = j
            continue
        i += 1
    segments.append(toks[start:])

    end = [Token(TokenType.END, "")]
    q = _QueryParser(segments[0] + end).parse()
    q.ctes = ctes
    if len(segments) == 1:
        return q
    branches = [
        _QueryParser(seg + end).parse() for seg in segments[1:]
    ]
    for b in [q, *branches[:-1]]:
        if b.order_by is not None or b.limit is not None or b.offset is not None:
            raise ParseError(
                "ORDER BY/LIMIT/OFFSET in a UNION/EXCEPT/INTERSECT must "
                "follow the final branch (they apply to the whole result)"
            )
    q.set_ops = list(zip(ops, all_flags, branches))
    return q


def parse_query_text(sql: str) -> Query:
    return parse_query(tokenize(sql))
