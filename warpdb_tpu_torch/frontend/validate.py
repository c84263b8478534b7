"""Semantic validation of expressions against a table schema.

Mirrors the reference's ``validate_ast`` recursion (warpdb.cpp:18-44):
every column reference must name an existing column, else
``Unknown column: X``.  Function calls validate their arguments (function
names themselves are resolved later against the UDF registry at compile
time).  Qualified references (``sales.id``) validate their unqualified
name when the qualifier matches a known table name.
"""

from __future__ import annotations

from typing import Collection, Optional

from ..errors import ValidationError
from .ast import Node, Query, Variable, walk

__all__ = ["validate_expression", "validate_query"]


def validate_expression(
    node: Optional[Node],
    columns: Collection[str],
    table_names: Collection[str] = (),
) -> None:
    """Raise ``ValidationError('Unknown column: X')`` for unresolvable refs."""
    if node is None:
        return
    cols = set(columns)
    tables = set(table_names)
    for n in walk(node):
        if isinstance(n, Variable):
            if n.name in cols:
                continue
            if n.qualifier is not None and n.qualifier in tables and n.unqualified in cols:
                continue
            raise ValidationError(f"Unknown column: {n.name}")


def validate_query(
    query: Query,
    columns: Collection[str],
    table_names: Collection[str] = (),
) -> None:
    """Validate every clause, labelling errors with clause context
    (reference warpdb.cpp:309-334: ``SELECT clause: Unknown column: x``)."""

    def check(node: Optional[Node], ctx: str) -> None:
        if node is None:
            return
        try:
            validate_expression(node, columns, table_names)
        except ValidationError as e:
            raise ValidationError(f"{ctx}: {e}") from None

    for expr in query.select_list:
        check(expr, "SELECT clause")
    for join in query.joins:
        check(join.condition, "JOIN condition")
    check(query.where, "WHERE clause")
    # Output-column resolution: bare names in ORDER BY (standard),
    # GROUP BY (PostgreSQL fallback: input columns win over aliases)
    # and HAVING (MySQL/DuckDB convenience) may reference select-list
    # aliases — the executor rewrites them via resolve_order_aliases.
    from .ast import Alias

    aliases = {
        item.name for item in query.select_list if isinstance(item, Alias)
    }
    out_cols = set(columns) | aliases
    if query.group_by is not None:
        for key in query.group_by.keys:
            try:
                validate_expression(key, out_cols, table_names)
            except ValidationError as e:
                raise ValidationError(f"GROUP BY: {e}") from None
    if query.having is not None:
        try:
            validate_expression(query.having, out_cols, table_names)
        except ValidationError as e:
            raise ValidationError(f"HAVING clause: {e}") from None
    check(getattr(query, "qualify", None), "QUALIFY clause")
    if query.order_by is not None:
        for term in query.order_by.terms:
            try:
                validate_expression(term.expr, out_cols, table_names)
            except ValidationError as e:
                raise ValidationError(f"ORDER BY: {e}") from None
