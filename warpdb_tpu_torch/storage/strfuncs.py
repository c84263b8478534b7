"""String scalar functions over dictionary-coded columns.

A string function never touches row data on device: at plan lowering
the engine applies it host-side to the column's (small, sorted)
VOCABULARY once, then ships only a per-code lookup table — O(V) host
work plus a tiny-table gather per row (docs/DESIGN.md: small-source
takes are single-digit ms at 2^25 rows).  The reference could not run
any string expression at all (string columns never reach the device,
csv_loader.cpp:151-155).

String-valued results re-encode against a fresh sorted vocabulary, so
codes stay order-correct: ORDER BY / MIN / MAX / comparisons on
``UPPER(name)`` are exact, and nested functions compose
(``SUBSTR(UPPER(name), 1, 2)`` binds inside-out).
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

from ..errors import UnsupportedError, ValidationError
from ..frontend.ast import (
    CodeMap,
    Constant,
    FunctionCall,
    Node,
    StringLiteral,
    Variable,
)

__all__ = ["is_string_func", "bind_string_func", "STRING_FUNCS"]


def _pad(s: str, n, fill: str = " ", left: bool = True) -> str:
    # PostgreSQL semantics: truncate to n when longer; an explicitly
    # empty fill pads nothing (the string returns unchanged).
    n = max(int(float(n)), 0)
    if len(s) >= n:
        return s[:n]
    fill = str(fill)
    if not fill:
        return s
    pad = (fill * n)[: n - len(s)]
    return pad + s if left else s + pad


def _initcap(s: str) -> str:
    # PostgreSQL initcap: uppercase letters that follow a
    # NON-ALPHANUMERIC character, lowercase the rest — digits count as
    # word characters ('abc2def' → 'Abc2def'; str.title() would give
    # 'Abc2Def').
    out = []
    prev_alnum = False
    for ch in s:
        out.append(
            ch.upper() if (ch.isalpha() and not prev_alnum) else ch.lower()
        )
        prev_alnum = ch.isalnum()
    return "".join(out)


def _split_part(s: str, delim: str, n) -> str:
    # PostgreSQL: 1-based field index; out-of-range yields "".
    if delim == "":
        raise ValidationError("SPLIT_PART: empty delimiter")
    parts = s.split(str(delim))
    i = int(float(n))
    return parts[i - 1] if 1 <= i <= len(parts) else ""


def _substr(s: str, start: float, length: Optional[float] = None) -> str:
    # SQL SUBSTR is 1-based; a zero/negative start clamps to 1
    # (SQLite/Postgres-compatible enough for the supported surface).
    b = max(int(start) - 1, 0)
    if length is None:
        return s[b:]
    n = max(int(length), 0)
    return s[b : b + n]


# name -> (result kind "str" | "num", impl(entry, *literal_args))
STRING_FUNCS = {
    "upper": ("str", lambda s: s.upper()),
    "lower": ("str", lambda s: s.lower()),
    "trim": ("str", lambda s: s.strip()),
    "ltrim": ("str", lambda s: s.lstrip()),
    "rtrim": ("str", lambda s: s.rstrip()),
    "reverse": ("str", lambda s: s[::-1]),
    "substr": ("str", _substr),
    "substring": ("str", _substr),
    "replace": ("str", lambda s, a, b: s.replace(a, b)),
    "concat": ("str", None),  # variadic; special-cased below
    "length": ("num", lambda s: float(len(s))),
    "char_length": ("num", lambda s: float(len(s))),
    # Padding / splitting / search (PostgreSQL semantics; LEFT/RIGHT
    # are join-qualifier keywords, so SUBSTR covers those forms).
    "lpad": ("str", lambda s, n, fill=" ": _pad(s, n, fill, True)),
    "rpad": ("str", lambda s, n, fill=" ": _pad(s, n, fill, False)),
    "split_part": ("str", _split_part),
    "repeat": ("str", lambda s, n: s * max(int(float(n)), 0)),
    "initcap": ("str", _initcap),
    # 1-based position of the substring; 0 when absent (PostgreSQL
    # strpos / MySQL instr).
    "strpos": ("num", lambda s, sub: float(s.find(str(sub)) + 1)),
    "instr": ("num", lambda s, sub: float(s.find(str(sub)) + 1)),
    # Date-part extraction over ISO-8601 date/timestamp strings
    # ("YYYY-MM-DD[ HH:MM:SS]" — the reference has no date type at all;
    # ISO strings already sort chronologically through the dictionary,
    # and these expose the parts as numbers for grouping/filtering).
    # Malformed entries yield NaN (the engine's NULL).
    "year": ("num", lambda s: _date_part(s, 0, 4)),
    "month": ("num", lambda s: _date_part(s, 5, 7)),
    "day": ("num", lambda s: _date_part(s, 8, 10)),
    "hour": ("num", lambda s: _date_part(s, 11, 13)),
    "minute": ("num", lambda s: _date_part(s, 14, 16)),
    "second": ("num", lambda s: _date_part(s, 17, 19)),
    # DATE_TRUNC('part', d) — truncated ISO strings keep sorting
    # chronologically, so grouped-by-month/quarter rollups ride the
    # ordinary string GROUP BY.  Malformed entries map to "" (sorts
    # first; decodes to the empty string, the engine's string missing
    # marker).  Argument order follows PostgreSQL.
    "date_trunc": ("str", None),  # part precedes the column; below
}


def _date_trunc(s: str, part: str) -> str:
    p = str(part).lower()
    if len(s) < 10 or not (s[0:4] + s[5:7] + s[8:10]).isdigit():
        return ""
    y, mo, d = s[0:4], s[5:7], s[8:10]
    if p == "year":
        return f"{y}-01-01"
    if p == "quarter":
        q0 = (int(mo) - 1) // 3 * 3 + 1
        return f"{y}-{q0:02d}-01"
    if p == "month":
        return f"{y}-{mo}-01"
    if p == "day":
        return f"{y}-{mo}-{d}"
    if p in ("hour", "minute"):
        hh = s[11:13] if len(s) >= 13 and s[11:13].isdigit() else "00"
        if p == "hour":
            return f"{y}-{mo}-{d} {hh}:00:00"
        mi = s[14:16] if len(s) >= 16 and s[14:16].isdigit() else "00"
        return f"{y}-{mo}-{d} {hh}:{mi}:00"
    raise ValidationError(
        "DATE_TRUNC supports year/quarter/month/day/hour/minute"
    )


def _date_part(s: str, a: int, b: int) -> float:
    part = s[a:b]
    if len(part) == b - a and part.isdigit():
        return float(int(part))
    return float("nan")


def is_string_func(name: str) -> bool:
    return name.lower() in STRING_FUNCS


def _vocab_of_arg(node: Node, table) -> Optional[np.ndarray]:
    if isinstance(node, CodeMap):
        return node.out_vocab
    if isinstance(node, Variable) and table is not None:
        v = table.dicts.get(node.name)
        if v is None:
            v = table.dicts.get(node.unqualified)
        return v
    return None


def _vocab_tag(vocab: np.ndarray) -> str:
    h = hashlib.sha1()
    h.update(np.int64(len(vocab)).tobytes())
    for s in vocab:
        h.update(str(s).encode())
        h.update(b"\x00")
    return h.hexdigest()[:12]


def bind_string_func(fc: FunctionCall, table) -> Optional[CodeMap]:
    """Lower a string-function call whose argument is a dictionary-coded
    expression into a :class:`CodeMap`.  Returns None when no argument
    carries a vocabulary (the call then resolves as an ordinary UDF).
    Arguments must already be string-bound (nested functions compose
    inside-out)."""
    name = fc.name.lower()
    kind, impl = STRING_FUNCS[name]

    vocab = None
    vocab_pos = -1
    for i, a in enumerate(fc.args):
        v = _vocab_of_arg(a, table)
        if v is not None:
            if vocab is not None:
                raise UnsupportedError(
                    f"{fc.name} over two string columns is not supported "
                    "(apply it per column, or JOIN)"
                )
            vocab, vocab_pos = v, i
    if vocab is None:
        return None

    lit_args: list = []
    for i, a in enumerate(fc.args):
        if i == vocab_pos:
            continue
        if isinstance(a, StringLiteral):
            lit_args.append((i, a.text))
        elif isinstance(a, Constant):
            lit_args.append((i, a.value))
        else:
            raise ValidationError(
                f"{fc.name}: non-column arguments must be literals"
            )

    entries = [str(s) for s in vocab]
    if name == "concat":
        parts = {i: str(t) for i, t in lit_args}

        def apply(entry: str) -> str:
            return "".join(
                entry if i == vocab_pos else parts[i]
                for i in range(len(fc.args))
            )

        transformed = [apply(e) for e in entries]
    elif name == "date_trunc":
        if len(lit_args) != 1:
            raise ValidationError(
                "DATE_TRUNC expects ('part', date_column)"
            )
        transformed = [_date_trunc(e, lit_args[0][1]) for e in entries]
    else:
        args_only = [t for _i, t in lit_args]
        try:
            transformed = [impl(e, *args_only) for e in entries]
        except TypeError:
            raise ValidationError(
                f"Wrong number of arguments for {fc.name}"
            ) from None

    arg_sig = ",".join(repr(t) for _i, t in lit_args)
    if kind == "num":
        values = tuple(np.float32(x) for x in transformed)
        tag = f"{name}({arg_sig})@{_vocab_tag(vocab)}"
        return CodeMap(fc.args[vocab_pos], values, tag, None)
    out_vocab = np.unique(np.asarray(transformed))
    codes = np.searchsorted(out_vocab, np.asarray(transformed))
    values = tuple(np.float32(c) for c in codes)
    tag = f"{name}({arg_sig})@{_vocab_tag(vocab)}"
    return CodeMap(fc.args[vocab_pos], values, tag, out_vocab)
