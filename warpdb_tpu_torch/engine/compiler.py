"""Expression compiler: AST → torch closure over columns.

Counterpart of ``warpdb_tpu/engine/compiler.py``.  The AST is walked once
into a Python closure over torch ops; PyTorch runs it eagerly, so there
is no ``jit``.  A plan-keyed cache (canonical expression, schema, UDF
registry version) keeps the built closures.

Numeric semantics are the reference's: every column and constant
evaluates in float32; comparisons whose operands are both integral (INT
column, dictionary code, integral literal) compare in int32, so key
values beyond 2^24 do not collide; ``%`` is C ``fmod``.  Constants are
0-d f32 tensors on the columns' device, so torch's type promotion never
widens a result to float64.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from ..errors import ExecutionError, ValidationError
from ..frontend.ast import (
    Aggregation,
    Alias,
    BinaryOp,
    CaseWhen,
    CodeMap,
    Constant,
    ExistsSubquery,
    FunctionCall,
    InCodeSet,
    InSubquery,
    InValueSet,
    Node,
    NotNull,
    QuantifiedComparison,
    ScalarSubquery,
    Star,
    Variable,
    WindowFunction,
    unalias,
)
from ..utils.metrics import note_operator
from . import udf as udf_mod

__all__ = [
    "build_evaluator",
    "raw_int_item",
    "compile_filter_project",
    "schema_signature",
    "cache_stats",
    "device_of",
    "broadcast",
]

_F32 = torch.float32
_CPU = torch.device("cpu")


def device_of(cols: dict) -> torch.device:
    """The device of the first tensor in ``cols`` (CPU when none)."""
    for v in cols.values():
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, (list, tuple)) and v and isinstance(v[0], torch.Tensor):
            return v[0].device
    return _CPU


def broadcast(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` as a length-``n`` row vector (constants broadcast)."""
    if x.dim() == 0:
        return x.expand(n)
    return x


def _as_bool(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bool:
        return x
    return x != 0


def _bool_as_f32(x: torch.Tensor) -> torch.Tensor:
    """A comparison result passed to a function: f32 {0, 1}, as in
    arithmetic (torch's math functions take no bool tensors)."""
    return x.to(_F32) if x.dtype == torch.bool else x


def _as_f32(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        return torch.tensor(float(np.float32(x)), dtype=_F32)
    if x.dtype != _F32:
        return x.to(_F32)
    return x


def _const_fn(value: float, dtype=_F32) -> Callable[[dict], torch.Tensor]:
    """Evaluator of a constant: a 0-d tensor on the columns' device,
    made once per device."""
    per_device: dict = {}

    def const(cols):
        dev = device_of(cols)
        t = per_device.get(dev)
        if t is None:
            t = per_device[dev] = torch.tensor(value, dtype=dtype, device=dev)
        return t

    return const


def _const_value(node) -> Optional[float]:
    """Fold an all-Constant arithmetic subtree in f64 (exact for integer
    literals: ``-16777217`` arrives as ``0 - 16777217``).  None when the
    subtree is not constant."""
    if isinstance(node, Alias):
        return _const_value(node.expr)
    if isinstance(node, Constant):
        return float(node.value)
    if isinstance(node, BinaryOp) and node.op in ("+", "-", "*", "/"):
        l = _const_value(node.left)
        r = _const_value(node.right)
        if l is None or r is None:
            return None
        if node.op == "+":
            return l + r
        if node.op == "-":
            return l - r
        if node.op == "*":
            return l * r
        return l / r if r != 0 else None
    return None


def _lookup(cols: dict, name: str, uname: str) -> torch.Tensor:
    arr = cols.get(name)
    if arr is None:
        arr = cols.get(uname)
    if arr is None:
        raise ValidationError(f"Unknown column: {name}")
    return arr


def _raw_operand(node):
    """Evaluator for a COMPARISON operand preserving exactness: a bare
    Variable gives the raw column (int32 for INT / code columns), a
    constant subtree gives the Python float, anything else the f32
    evaluator."""
    if isinstance(node, Alias):
        return _raw_operand(node.expr)
    cval = _const_value(node)
    if cval is not None:
        return lambda cols: cval
    if isinstance(node, Variable):
        name, uname = node.name, node.unqualified
        return lambda cols: _lookup(cols, name, uname)
    return build_evaluator(node)


def _is_int_arr(x) -> bool:
    return (
        isinstance(x, torch.Tensor)
        and not x.dtype.is_floating_point
        and x.dtype != torch.bool
    )


_CMP = {
    ">": torch.gt, "<": torch.lt, ">=": torch.ge, "<=": torch.le,
    "==": torch.eq, "=": torch.eq, "!=": torch.ne,
}
_SWAP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}


def _exact_compare(op, lhs, rhs, dev):
    """Comparison with integer-exact semantics where possible (reference
    ``compiler._exact_compare``): int array vs int array or integral
    scalar compares in int32; int array vs non-integral scalar rewrites
    to the equivalent integer comparison (``k < 2.5`` ⟺ ``k <= 2``);
    everything else compares in f32."""
    cmp = _CMP[op]
    li, ri = _is_int_arr(lhs), _is_int_arr(rhs)
    if li and ri:
        return cmp(lhs, rhs)
    for a, b, swap in ((lhs, rhs, False), (rhs, lhs, True)):
        if not (_is_int_arr(a) and isinstance(b, float)):
            continue
        if float(b).is_integer() and -(2.0**31) <= b <= 2.0**31 - 1:
            bi = int(b)
            return cmp(a, bi) if not swap else cmp(
                torch.tensor(bi, dtype=a.dtype, device=a.device), a
            )
        if op in ("==", "="):
            return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
        if op == "!=":
            return torch.ones(a.shape, dtype=torch.bool, device=a.device)
        if math.isfinite(b) and -(2.0**31) < b < 2.0**31 - 1:
            effective = op if not swap else _SWAP[op]
            if effective in ("<", "<="):
                return a <= int(math.floor(b))
            return a >= int(math.ceil(b))
        break  # out-of-int32-range scalar: f32 handles the ±inf regime
    # Both operands in f32.  A Python float rounds to f32 first, so the
    # comparison is the reference's f32 comparison.
    l = _as_f32(lhs).to(dev) if not isinstance(lhs, torch.Tensor) else _as_f32(lhs)
    r = _as_f32(rhs).to(dev) if not isinstance(rhs, torch.Tensor) else _as_f32(rhs)
    return cmp(l, r)


def raw_int_item(item, table):
    """``(raw evaluator, np output dtype)`` when ``item`` is a bare INT
    column whose device tensor is integer-typed, else None (reference
    ``compiler.raw_int_item``)."""
    node = unalias(item)
    if not isinstance(node, Variable):
        return None
    dt = table.dtypes.get(node.name) or table.dtypes.get(node.unqualified)
    if dt is None or getattr(dt, "value", None) not in ("int32", "int64"):
        return None
    arr = table.columns.get(node.name)
    if arr is None:
        arr = table.columns.get(node.unqualified)
    if arr is None or arr.dtype.is_floating_point:
        return None
    name, uname = node.name, node.unqualified
    return (
        lambda cols: _lookup(cols, name, uname),
        np.int64 if dt.value == "int64" else np.int32,
    )


_ARITH = {
    "+": torch.add,
    "-": torch.sub,
    "*": torch.mul,
    "/": torch.div,
    # SQL % is C fmod (sign of the dividend), not Python mod.
    "%": torch.fmod,
}


def build_evaluator(node: Node) -> Callable[[dict], torch.Tensor]:
    """Closure ``columns -> tensor`` evaluating ``node`` rowwise.

    Comparisons yield bool tensors; bools promote to f32 {0, 1} when used
    arithmetically.  Aggregations are lowered by the executor."""
    if isinstance(node, Alias):
        return build_evaluator(node.expr)
    if isinstance(node, Star):
        return _const_fn(1.0)  # COUNT(*)'s argument: every row counts
    if isinstance(node, Constant):
        return _const_fn(float(np.float32(node.value)))
    if isinstance(node, Variable):
        name, uname = node.name, node.unqualified
        return lambda cols: _as_f32(_lookup(cols, name, uname))
    if isinstance(node, BinaryOp):
        op = node.op
        if op in ("&&", "||"):
            left, right = build_evaluator(node.left), build_evaluator(node.right)
            combine = torch.logical_and if op == "&&" else torch.logical_or
            return lambda cols: combine(
                _as_bool(left(cols)), _as_bool(right(cols))
            )
        if op in _CMP:
            lraw, rraw = _raw_operand(node.left), _raw_operand(node.right)
            return lambda cols: _exact_compare(
                op, lraw(cols), rraw(cols), device_of(cols)
            )
        arith = _ARITH.get(op)
        if arith is None:
            raise ValidationError(f"Unsupported operator: {op}")
        left, right = build_evaluator(node.left), build_evaluator(node.right)
        return lambda cols: arith(_as_f32(left(cols)), _as_f32(right(cols)))
    if isinstance(node, FunctionCall):
        arg_fns = [build_evaluator(a) for a in node.args]
        name = node.name

        def call_fn(cols):
            fn = udf_mod.resolve_udf(name)
            out = _as_f32(fn(*[_bool_as_f32(a(cols)) for a in arg_fns]))
            dev = device_of(cols)
            return out if out.device == dev else out.to(dev)

        return call_fn
    if isinstance(node, NotNull):
        # Bare Variables read raw so the missing-value marker stays
        # visible: -1 for i32 columns, NaN for float columns.
        raw = _raw_operand(node.expr)
        neg = node.negated

        def notnull_fn(cols):
            arr = raw(cols)
            if not isinstance(arr, torch.Tensor):  # constant subtree
                isnull = float(arr) != float(arr)
                v = (1.0 if isnull else 0.0) if neg else (0.0 if isnull else 1.0)
                return torch.tensor(v, dtype=_F32, device=device_of(cols))
            if not arr.dtype.is_floating_point:
                ind = (arr == -1) if neg else (arr != -1)
            else:
                ind = (arr != arr) if neg else (arr == arr)
            return ind.to(_F32)

        return notnull_fn
    if isinstance(node, CaseWhen):
        cond_fns = [build_evaluator(c) for c in node.conditions]
        val_fns = [build_evaluator(v) for v in node.values]
        default_fn = (
            build_evaluator(node.default) if node.default is not None
            else _const_fn(0.0)
        )

        def case_fn(cols):
            out = _as_f32(default_fn(cols))
            # First matching branch wins: fold right to left.
            for c, v in zip(reversed(cond_fns), reversed(val_fns)):
                out = torch.where(_as_bool(c(cols)), _as_f32(v(cols)), out)
            return out

        return case_fn
    if isinstance(node, InCodeSet):
        inner = build_evaluator(node.expr)
        lut_np = np.zeros(max(node.vocab_size, 1), np.bool_)
        if node.codes:
            lut_np[list(node.codes)] = True
        lut_cpu = torch.from_numpy(lut_np)

        def in_codes_fn(cols):
            codes = inner(cols).to(torch.int64)
            lut = lut_cpu.to(codes.device)
            return lut[codes.clamp(0, lut.shape[0] - 1)]

        return in_codes_fn
    if isinstance(node, CodeMap):
        inner = build_evaluator(node.expr)
        n_entries = len(node.values)
        lut_cpu = torch.from_numpy(np.asarray(node.values, np.float32))
        # Missing codes (-1 / NaN) stay missing: -1 for code-valued
        # results, NaN for numeric ones.
        miss = -1.0 if node.out_vocab is not None else float("nan")

        def codemap_fn(cols):
            c = _as_f32(inner(cols))
            if n_entries == 0:
                return torch.full(c.shape, miss, dtype=_F32, device=c.device)
            ci = c.to(torch.int64).clamp(0, n_entries - 1)
            out = lut_cpu.to(c.device)[ci]
            return torch.where(c >= 0, out, torch.tensor(miss, device=c.device))

        return codemap_fn
    if isinstance(node, InValueSet):
        inner = build_evaluator(node.expr)
        vals_cpu = torch.from_numpy(np.asarray(node.values, np.float32))

        def in_values_fn(cols):
            # f32 equality, as the reference's compare sweep: NaN and
            # values that do not round-trip through f32 never match.
            x = _as_f32(inner(cols))
            return torch.isin(x, vals_cpu.to(x.device))

        return in_values_fn
    if isinstance(node, (ScalarSubquery, InSubquery, ExistsSubquery,
                         QuantifiedComparison)):
        raise ExecutionError(
            "Unresolved subquery reached the compiler — subqueries are "
            "resolved by the executor before kernel compilation"
        )
    if isinstance(node, (Aggregation, WindowFunction)):
        raise ExecutionError(
            f"{type(node).__name__} is not a row-level expression; "
            "it must be lowered by the plan executor"
        )
    raise ExecutionError(f"Cannot compile node type {type(node).__name__}")


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------

_cache_lock = threading.Lock()
_CACHE_MAX_ENTRIES = 1024
_plan_cache: "OrderedDict" = OrderedDict()
_cache_hits = 0
_cache_misses = 0


def schema_signature(columns: dict) -> tuple:
    """Hashable signature of a column dict: name, dtype, device."""
    return tuple(
        (name, str(t.dtype), str(t.device))
        for name, t in sorted(columns.items())
    )


def cache_stats() -> dict:
    with _cache_lock:
        return {"entries": len(_plan_cache), "hits": _cache_hits,
                "misses": _cache_misses}


def get_or_build(key: tuple, build: Callable[[], Callable]) -> Callable:
    """Plan-keyed closure cache: ``build`` runs once per distinct key."""
    global _cache_hits, _cache_misses
    with _cache_lock:
        fn = _plan_cache.get(key)
        if fn is not None:
            _plan_cache.move_to_end(key)
            _cache_hits += 1
    if fn is not None:
        note_operator(key[0], True)
        return fn
    note_operator(key[0], False)
    fn = build()
    with _cache_lock:
        _plan_cache[key] = fn
        _plan_cache.move_to_end(key)
        while len(_plan_cache) > _CACHE_MAX_ENTRIES:
            _plan_cache.popitem(last=False)
        _cache_misses += 1
    return fn


# Per-instance LRU memos (joins, pushdown filters, eager rewrites,
# subqueries, CTEs).  One lock guards every lookup and update, so threads
# sharing a facade (the HTTP server's) never see an entry evicted between
# its lookup and its move to the end.  Two threads that miss one key may
# both build it; the later entry stays, and both are the same table.
_memo_lock = threading.Lock()


def memo_get(owner, attr: str, key):
    """``owner.<attr>[key]``, marked most recently used; None if absent."""
    with _memo_lock:
        memo = getattr(owner, attr, None)
        hit = None if memo is None else memo.get(key)
        if hit is not None:
            memo.move_to_end(key)
        return hit


def memo_put(owner, attr: str, key, value, entries: int):
    """Store ``value`` in ``owner.<attr>``, an LRU of ``entries``; returns
    ``value``."""
    with _memo_lock:
        memo = getattr(owner, attr, None)
        if memo is None:
            memo = OrderedDict()
            setattr(owner, attr, memo)
        memo[key] = value
        memo.move_to_end(key)
        while len(memo) > entries:
            memo.popitem(last=False)
    return value


def compile_filter_project(expr: Node, cond: Optional[Node], columns: dict):
    """``fn(cols, n) -> f32[n]``: ``cond ? expr : 0`` over row columns
    (the reference's fused filter+projection; rows failing the filter
    give 0.0)."""
    key = (
        "filter_project",
        expr.canonical(),
        cond.canonical() if cond is not None else "",
        schema_signature(columns),
        udf_mod.registry_version(),
    )

    def build():
        expr_fn = build_evaluator(expr)
        cond_fn = build_evaluator(cond) if cond is not None else None

        def run(cols, n):
            out = broadcast(_as_f32(expr_fn(cols)), n)
            if cond_fn is None:
                return out
            keep = broadcast(_as_bool(cond_fn(cols)), n)
            return torch.where(keep, out, 0.0)

        return run

    return get_or_build(key, build)
