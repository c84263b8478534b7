"""Query frontend: lexer, expression/SQL parsers, AST, validation.

Pure Python, no device dependencies — the analogue of the reference's
expression.hpp/expression.cpp layer.
"""

from .ast import (
    Aggregation,
    AggregationType,
    BinaryOp,
    Constant,
    FunctionCall,
    GroupBy,
    Join,
    Node,
    OrderBy,
    Query,
    Variable,
    WindowFunction,
    column_refs,
    walk,
)
from .lexer import KEYWORDS, Token, TokenType, tokenize
from .parser import (
    parse_expression,
    parse_expression_text,
    parse_logical_and,
    parse_logical_or,
    parse_query,
    parse_query_text,
)
from .validate import validate_expression, validate_query

__all__ = [
    "Aggregation", "AggregationType", "BinaryOp", "Constant", "FunctionCall",
    "GroupBy", "Join", "Node", "OrderBy", "Query", "Variable",
    "WindowFunction", "column_refs", "walk",
    "KEYWORDS", "Token", "TokenType", "tokenize",
    "parse_expression", "parse_expression_text", "parse_logical_and",
    "parse_logical_or", "parse_query", "parse_query_text",
    "validate_expression", "validate_query",
]
