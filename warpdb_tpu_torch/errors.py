"""Structured error taxonomy for warpdb_tpu.

The reference engine (WarpDB) raises ``std::runtime_error`` with specific
message phrases that its test suite asserts on as substrings (e.g.
"Unknown character", "Unexpected token", "Expected ')'", "Unknown column",
"line ... column ...").  We preserve that message taxonomy — see
reference tests/tokenize_error_test.cpp, parsing_error_tests.cpp,
parse_query_error_test.cpp, identifier_validation_test.cpp — while giving
each failure stage a distinct Python exception type so callers can catch
precisely.
"""

from __future__ import annotations


class WarpDBError(RuntimeError):
    """Base class for all engine errors."""


class TokenizeError(WarpDBError):
    """Lexer failure.  Message format mirrors reference expression.cpp:110-113:
    ``Unknown character 'X' at line L column C``."""


class ParseError(WarpDBError):
    """Expression / SQL parse failure (reference expression.cpp:232-235,
    241-243, 275-286)."""


class ValidationError(WarpDBError):
    """Semantic validation failure, e.g. ``Unknown column: X``
    (reference warpdb.cpp:18-44)."""


class ExecutionError(WarpDBError):
    """Runtime execution failure (compile or device error)."""


class UnsupportedError(WarpDBError):
    """Feature gated off or not supported (reference arrow_loader.hpp:26-37
    throwing stubs when Arrow absent)."""
