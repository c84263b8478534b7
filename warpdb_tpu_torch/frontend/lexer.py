"""SQL-ish lexer.

Behavioral parity with the reference tokenizer (reference src/
expression.cpp:22-120):

* identifiers: ``[A-Za-z_][A-Za-z0-9_.]*`` — the ``.`` allows qualified
  names like ``sales.id`` (expression.cpp:50);
* numbers: unsigned, at most one dot, no exponent; a leading ``.5`` is a
  number when followed by a digit (expression.cpp:69-84);
* two-character comparison operators ``>= <= == !=`` are matched before
  one-character ones (expression.cpp:85-98);
* remaining single-char operators: ``+ - * / ( ) < > , . =`` and a bare
  ``!`` never forms a token on its own — ``!`` not followed by ``=``
  produces the single-char operator ``!`` (which no parser rule accepts);
* 23 keywords, matched case-insensitively and normalised to upper case
  (expression.cpp:58-62);
* line/column tracking (1-based), errors formatted exactly as
  ``Unknown character 'X' at line L column C`` (expression.cpp:110-113);
* a trailing ``End`` token is always appended (expression.cpp:118).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..errors import TokenizeError

__all__ = ["TokenType", "Token", "tokenize", "KEYWORDS"]


class TokenType(enum.Enum):
    IDENTIFIER = "Identifier"
    NUMBER = "Number"
    OPERATOR = "Operator"
    KEYWORD = "Keyword"
    STRING = "String"  # quoted literal — extension over the reference
    END = "End"

    # Friendly aliases matching the reference enum spellings so tests can
    # write TokenType.Identifier etc.
    Identifier = IDENTIFIER
    Number = NUMBER
    Operator = OPERATOR
    Keyword = KEYWORD
    String = STRING
    End = END


KEYWORDS = frozenset(
    {
        "SELECT", "FROM", "WHERE", "JOIN", "ON", "GROUP",
        "BY", "ORDER", "ASC", "DESC", "LIMIT", "OFFSET",
        "SUM", "AVG", "COUNT", "MIN", "MAX", "OVER",
        "PARTITION", "AND", "OR", "HAVING", "DISTINCT",
        # Extensions over the reference's 23 keywords (expression.cpp:58-62).
        # ROW_NUMBER/RANK are deliberately NOT keywords: they are
        # recognised contextually (`RANK() OVER ...`) so columns named
        # "rank" keep working.  NOT/IN/BETWEEN/LIKE are reserved in
        # standard SQL, so reserving them here is safe.
        "AS", "NOT", "IN", "BETWEEN", "LIKE",
        "CASE", "WHEN", "THEN", "ELSE", "END",
        # LEFT/RIGHT/FULL/INNER/OUTER JOIN qualifiers (reserved in
        # standard SQL).
        "LEFT", "RIGHT", "FULL", "INNER", "OUTER",
        # Set operations (reserved in standard SQL).
        "UNION", "EXCEPT", "INTERSECT", "ALL",
        # Common table expressions.
        "WITH",
        # NULL predicate / literal (reserved in standard SQL).
        "IS", "NULL",
    }
)

_SINGLE_OPS = set("+-*/%()<>,.")


@dataclass(frozen=True)
class Token:
    type: TokenType
    value: str
    line: int = 1
    column: int = 1

    def __repr__(self) -> str:  # compact for golden tests
        return f"Token({self.type.value}, {self.value!r}, {self.line}:{self.column})"


def tokenize(text: str) -> list[Token]:
    """Lex ``text`` into a token list terminated by an ``End`` token."""
    tokens: list[Token] = []
    i = 0
    line = 1
    column = 1
    n = len(text)

    def advance(c: str) -> None:
        nonlocal line, column
        if c == "\n":
            line += 1
            column = 1
        else:
            column += 1

    while i < n:
        c = text[i]
        if c.isspace():
            advance(c)
            i += 1
            continue

        if c.isalpha() or c == "_":
            start_line, start_col = line, column
            j = i
            while j < n and (text[j].isalnum() or text[j] in "_."):
                advance(text[j])
                j += 1
            ident = text[i:j]
            i = j
            upper = ident.upper()
            if upper in KEYWORDS:
                tokens.append(Token(TokenType.KEYWORD, upper, start_line, start_col))
            else:
                tokens.append(Token(TokenType.IDENTIFIER, ident, start_line, start_col))
            continue

        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            start_line, start_col = line, column
            j = i
            has_dot = False
            while j < n and (text[j].isdigit() or (text[j] == "." and not has_dot)):
                if text[j] == ".":
                    has_dot = True
                advance(text[j])
                j += 1
            tokens.append(Token(TokenType.NUMBER, text[i:j], start_line, start_col))
            i = j
            continue

        if c in ("'", '"'):
            # Quoted string literal (extension; the reference tokenizer,
            # expression.cpp:22-120, has no string form).  No escapes;
            # a doubled quote ('' or "") embeds one quote, SQL-style.
            quote = c
            start_line, start_col = line, column
            advance(c)
            i += 1
            buf = []
            closed = False
            while i < n:
                ch = text[i]
                if ch == quote:
                    if i + 1 < n and text[i + 1] == quote:
                        buf.append(quote)
                        advance(ch)
                        advance(text[i + 1])
                        i += 2
                        continue
                    advance(ch)
                    i += 1
                    closed = True
                    break
                buf.append(ch)
                advance(ch)
                i += 1
            if not closed:
                raise TokenizeError(
                    f"Unterminated string literal at line {start_line} "
                    f"column {start_col}"
                )
            tokens.append(
                Token(TokenType.STRING, "".join(buf), start_line, start_col)
            )
            continue

        if c in "><=!":
            start_line, start_col = line, column
            if i + 1 < n and text[i + 1] == "=":
                op = c + "="
                advance(text[i])
                advance(text[i + 1])
                i += 2
            elif c == "<" and i + 1 < n and text[i + 1] == ">":
                # Standard SQL inequality ``<>`` (extension over the
                # reference lexer); normalised to ``!=`` so downstream
                # canonical forms and cache keys see one spelling.
                op = "!="
                advance(text[i])
                advance(text[i + 1])
                i += 2
            else:
                op = c
                advance(c)
                i += 1
            if op == "!":
                # A lone '!' is not a valid operator anywhere in the grammar;
                # the reference emits it as an Operator token and the parser
                # rejects it later.  Keep identical behavior.
                pass
            tokens.append(Token(TokenType.OPERATOR, op, start_line, start_col))
            continue

        if c in _SINGLE_OPS:
            start_line, start_col = line, column
            advance(c)
            i += 1
            tokens.append(Token(TokenType.OPERATOR, c, start_line, start_col))
            continue

        raise TokenizeError(
            f"Unknown character '{c}' at line {line} column {column}"
        )

    tokens.append(Token(TokenType.END, "", line, column))
    return tokens
