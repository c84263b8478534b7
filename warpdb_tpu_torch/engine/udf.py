"""User-defined function registry of the port (counterpart of
``warpdb_tpu/engine/udf.py``).

A UDF is any callable over torch tensors:

* ``register_udf(name, fn)`` registers one;
* a ``custom.py`` in the working directory is discovered, and every
  public top-level function in it is registered (``discount(price, rate)
  = price * rate`` runs unchanged on tensors);
* the registry carries a version counter for plan-cache keys.

Builtins are the reference's scalar math set (``udf.py:38-137``) in
torch.  Arguments arrive as f32 tensors (0-d for constants).
"""

from __future__ import annotations

import math
import os
import runpy
import threading
from typing import Callable, Optional

import torch

from ..errors import ValidationError

__all__ = ["register_udf", "resolve_udf", "registry_version",
           "load_custom_module"]

_lock = threading.Lock()
_registry: dict[str, Callable] = {}
_version = 0
_custom_py_mtime: Optional[float] = None

_F32 = torch.float32


def _builtin_discount(price, rate):
    return price * rate


def _f32(value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=_F32)


def _coalesce(*args):
    if not args:
        raise ValidationError("COALESCE requires at least one argument")
    out = args[-1]
    for a in reversed(args[:-1]):
        out = torch.where(torch.isnan(a), out, a)
    return out


def _nullif(a, b):
    return torch.where(a == b, _f32(float("nan")).to(a.device), a)


def _fold(fn):
    def folded(*args):
        if not args:
            raise ValidationError("Function requires at least one argument")
        out = args[0]
        for a in args[1:]:
            out = fn(out, a)
        return out

    return folded


def _round(x, n=None):
    if n is None:
        return torch.round(x)
    p = torch.pow(_f32(10.0).to(x.device), n)
    return torch.round(x * p) / p


def _trunc(x, n=None):
    if n is None:
        return torch.trunc(x)
    p = torch.pow(_f32(10.0).to(x.device), n)
    return torch.trunc(x * p) / p


def _log(a, b=None):
    # One arg: natural log; two args: LOG(base, x).
    if b is None:
        return torch.log(a)
    return torch.log(b) / torch.log(a)


def _sign(x):
    # torch.sign maps NaN to 0; the reference (jnp.sign) keeps NaN.
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_MATH: dict[str, Callable] = {
    "abs": torch.abs,
    "sqrt": torch.sqrt,
    "cbrt": _cbrt,
    "log": _log,
    "ln": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "exp": torch.exp,
    "round": _round,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "ceiling": torch.ceil,
    "pow": torch.pow,
    "power": torch.pow,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "atan2": torch.atan2,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "pi": lambda: _f32(math.pi),
    "minimum": torch.minimum,
    "maximum": torch.maximum,
    # NULL handling (NaN is the engine's missing-value marker).
    "isnan": torch.isnan,
    "nullval": lambda: _f32(float("nan")),
    "coalesce": _coalesce,
    "nullif": _nullif,
    "trunc": _trunc,
    "sign": _sign,
    "fmod": torch.fmod,
    "mod": torch.fmod,
    "greatest": _fold(torch.maximum),
    "least": _fold(torch.minimum),
}

_BUILTINS: dict[str, Callable] = {"discount": _builtin_discount}


def register_udf(name: str, fn: Optional[Callable]) -> None:
    """Register (or replace) a UDF over torch tensors; ``fn=None``
    unregisters."""
    global _version
    with _lock:
        if fn is None:
            _registry.pop(name, None)
        else:
            _registry[name] = fn
        _version += 1


def load_custom_module(path: Optional[str] = None) -> int:
    """(Re)load UDFs from ``custom.py`` when present and changed (cached
    on mtime).  Returns the number of functions registered."""
    global _custom_py_mtime
    if path is None:
        from ..config import get_config

        path = get_config().udf_module
    if not os.path.exists(path):
        return 0
    mtime = os.path.getmtime(path)
    with _lock:
        if mtime == _custom_py_mtime:
            return 0
        _custom_py_mtime = mtime
    ns = runpy.run_path(path)
    count = 0
    for name, obj in ns.items():
        if name.startswith("_"):
            continue
        if callable(obj) and getattr(obj, "__module__", None) != "builtins":
            register_udf(name, obj)
            count += 1
    return count


def resolve_udf(name: str) -> Callable:
    load_custom_module()
    with _lock:
        fn = _registry.get(name)
    if fn is None:
        fn = _BUILTINS.get(name) or _BUILTINS.get(name.lower())
    if fn is None:
        fn = _MATH.get(name) or _MATH.get(name.lower())
    if fn is None:
        raise ValidationError(f"Unknown function: {name}")
    return fn


def registry_version() -> int:
    """Version stamp for plan-cache keys (loads ``custom.py`` first, so
    the stamp is stable across one query)."""
    load_custom_module()
    with _lock:
        return _version
