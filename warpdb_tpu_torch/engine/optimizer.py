"""Query optimizer: constant folding + stats-driven filter analysis.

Ported line for line from ``warpdb_tpu/engine/optimizer.py`` (43-222),
which has no device code but cannot be imported without JAX (its
package ``__init__`` imports the JAX compiler).

* ``fold_constants`` — collapses constant subtrees at plan time;
* ``expr_range`` — interval arithmetic over per-column min/max stats
  (``ColumnStats``, computed at load);
* ``analyze_condition`` — tri-state filter verdict used by the executor
  to prune always-false scans and drop always-true conditions.
"""

from __future__ import annotations

import math
from typing import Optional

from ..frontend.ast import (
    Aggregation,
    CodeMap,
    BinaryOp,
    Constant,
    FunctionCall,
    Node,
    NotNull,
    Variable,
)

__all__ = ["fold_constants", "expr_range", "analyze_condition"]

_Interval = tuple[float, float]


def fold_constants(node: Node) -> Node:
    """Collapse constant arithmetic subtrees (``2 * 3 + 1`` → ``7``)."""
    if isinstance(node, BinaryOp):
        left = fold_constants(node.left)
        right = fold_constants(node.right)
        if isinstance(left, Constant) and isinstance(right, Constant):
            l, r = left.value, right.value
            val: Optional[float] = None
            if node.op == "+":
                val = l + r
            elif node.op == "-":
                val = l - r
            elif node.op == "*":
                val = l * r
            elif node.op == "/" and r != 0:
                val = l / r
            if val is not None and val >= 0 and math.isfinite(val):
                # The grammar has no unary minus, so only non-negative
                # results can round-trip through a Constant literal.
                text = repr(float(val)) if val != int(val) else str(int(val))
                return Constant(text)
        if left is node.left and right is node.right:
            return node
        return BinaryOp(node.op, left, right)
    if isinstance(node, FunctionCall):
        args = tuple(fold_constants(a) for a in node.args)
        if all(a is b for a, b in zip(args, node.args)):
            return node
        return FunctionCall(node.name, args)
    if isinstance(node, Aggregation):
        return Aggregation(node.agg, fold_constants(node.expr), node.param)
    return node


def expr_range(node: Node, stats: dict) -> Optional[_Interval]:
    """Value interval of an expression, or None when unbounded/unknown.

    ``stats`` maps column name → ColumnStats (populated at load time —
    the reference's never-written TableStats made real)."""
    if isinstance(node, Constant):
        v = node.value
        return (v, v)
    if isinstance(node, Variable):
        st = stats.get(node.name) or stats.get(node.unqualified)
        if st is None or st.min is None or st.max is None:
            return None
        if st.null_count:
            # NaN rows are outside [min, max]; a verdict derived from the
            # range would wrongly keep (always-true) or drop
            # (always-false) them.
            return None
        return (float(st.min), float(st.max))
    if isinstance(node, NotNull):
        # NULL indicator (COUNT(expr) lowering) is 0/1 by construction;
        # without this branch grouped COUNT(expr) queries would fall off
        # the stats-gated slot tiers (and K2) to the sorted tier.
        return (0.0, 1.0)
    if isinstance(node, CodeMap):
        # The LUT's own extent, valid only when stats prove the source
        # codes land inside it (no outer-join miss sentinels).
        inner = expr_range(node.expr, stats)
        if inner is None or not node.values:
            return None
        lo, hi = inner
        if lo < 0 or hi > len(node.values) - 1:
            return None
        vals = [float(v) for v in node.values]
        if not all(math.isfinite(v) for v in vals):
            return None
        return (min(vals), max(vals))
    if isinstance(node, BinaryOp):
        lr = expr_range(node.left, stats)
        rr = expr_range(node.right, stats)
        if lr is None or rr is None:
            return None
        (a, b), (c, d) = lr, rr
        if node.op == "+":
            return (a + c, b + d)
        if node.op == "-":
            return (a - d, b - c)
        if node.op == "*":
            prods = (a * c, a * d, b * c, b * d)
            return (min(prods), max(prods))
        if node.op == "/":
            if c <= 0 <= d:
                return None  # denominator may cross zero
            quots = (a / c, a / d, b / c, b / d)
            return (min(quots), max(quots))
        if node.op not in (
            ">", "<", ">=", "<=", "==", "=", "!=", "&&", "||",
        ):
            return None  # e.g. % — not interval-analysed
        # Comparisons/logicals produce {0, 1}.
        verdict = _compare_verdict(node, stats)
        if verdict is True:
            return (1.0, 1.0)
        if verdict is False:
            return (0.0, 0.0)
        return (0.0, 1.0)
    return None  # UDFs, aggregates: unknown


def _compare_verdict(node: BinaryOp, stats: dict) -> Optional[bool]:
    lr = expr_range(node.left, stats)
    rr = expr_range(node.right, stats)
    if lr is None or rr is None:
        return None
    (a, b), (c, d) = lr, rr
    op = node.op
    if op == ">":
        if a > d:
            return True
        if b <= c:
            return False
    elif op == ">=":
        if a >= d:
            return True
        if b < c:
            return False
    elif op == "<":
        if b < c:
            return True
        if a >= d:
            return False
    elif op == "<=":
        if b <= c:
            return True
        if a > d:
            return False
    elif op in ("==", "="):
        if a == b == c == d:
            return True
        if b < c or a > d:
            return False
    elif op == "!=":
        if b < c or a > d:
            return True
        if a == b == c == d:
            return False
    return None


def analyze_condition(node: Optional[Node], stats: dict) -> Optional[bool]:
    """Tri-state verdict for a WHERE condition against column stats:
    True = always true (drop the filter — the fusion the reference
    intended at optimizer.cpp:45-47), False = always false (skip the
    scan, optimizer.cpp:38-41), None = must evaluate."""
    if node is None:
        return True
    if isinstance(node, Constant):
        return node.value != 0.0
    if isinstance(node, BinaryOp):
        if node.op == "&&":
            l = analyze_condition(node.left, stats)
            r = analyze_condition(node.right, stats)
            if l is False or r is False:
                return False
            if l is True and r is True:
                return True
            return None
        if node.op == "||":
            l = analyze_condition(node.left, stats)
            r = analyze_condition(node.right, stats)
            if l is True or r is True:
                return True
            if l is False and r is False:
                return False
            return None
        if node.op in (">", "<", ">=", "<=", "==", "=", "!="):
            return _compare_verdict(node, stats)
        # Arithmetic used as a boolean: nonzero-ness.
        rng = expr_range(node, stats)
        if rng is not None:
            lo, hi = rng
            if lo > 0 or hi < 0:
                return True
            if lo == hi == 0:
                return False
        return None
    return None
