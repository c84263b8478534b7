"""Observability: per-query metrics, the operator trace and profiler hooks.

Counterpart of ``warpdb_tpu/utils/metrics.py``.  Every query records its
wall time, rows and bytes scanned and the operators it ran into a bounded
in-process history (``history``, ``last``, ``report``).  The port has no
jit cache: the engine's operator entry points and each kernel wrapper call
:func:`note_operator`, a kernel wrapper with ``cache_hit`` false on the
launch that built its kernel with nvcc.  ``profile_trace`` wraps
``torch.profiler`` and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger("warpdb_tpu_torch")

__all__ = ["QueryMetrics", "record", "history", "last", "timed_query",
           "note_operator", "note_transfer", "note_collective",
           "profile_trace", "peak_hbm_bytes_per_s", "roofline_fraction",
           "report", "logger"]


@dataclass(frozen=True)
class QueryMetrics:
    query: str
    kind: str              # "expression" | "sql"
    wall_s: float
    rows: int
    bytes_scanned: int
    output_rows: int
    # Operators the query ran, in order, with cache-hit flags:
    # ((name, was_cache_hit), ...).
    operators: tuple = ()
    # Cross-device collectives: ((op, bytes_per_device), ...).
    collectives: tuple = ()
    # The device the query ran on ("cpu", "cuda:0", ...): its peak memory
    # rate is the roofline's.
    device: str = "cpu"

    @property
    def rows_per_s(self) -> float:
        return self.rows / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def gb_per_s(self) -> float:
        return self.bytes_scanned / self.wall_s / 1e9 if self.wall_s > 0 else 0.0


_lock = threading.Lock()
_history: deque = deque(maxlen=256)


def record(m: QueryMetrics) -> None:
    with _lock:
        _history.append(m)
    logger.debug(
        "query %r: %.3f ms, %.1fM rows/s, %.2f GB/s",
        m.query[:80], m.wall_s * 1e3, m.rows_per_s / 1e6, m.gb_per_s,
    )


def history() -> list:
    with _lock:
        return list(_history)


def last() -> Optional[QueryMetrics]:
    with _lock:
        return _history[-1] if _history else None


# Per-thread trace of the query running on this thread.
_trace_local = threading.local()


def note_operator(name: str, cache_hit: bool) -> None:
    """Record one operator of the running query (nothing outside one)."""
    ops = getattr(_trace_local, "ops", None)
    if ops is not None:
        ops.append((name, cache_hit))


_transfer_lock = threading.Lock()
_transfer_bytes = [0]


def note_transfer(nbytes: int) -> None:
    """Device→host result bytes, process-wide and monotonic."""
    with _transfer_lock:
        _transfer_bytes[0] += int(nbytes)


def transfer_bytes() -> int:
    with _transfer_lock:
        return _transfer_bytes[0]


def note_collective(op: str, bytes_per_device: int) -> None:
    """A collective of the running query with its per-device bytes."""
    cs = getattr(_trace_local, "collectives", None)
    if cs is not None:
        cs.append((op, int(bytes_per_device)))


@contextlib.contextmanager
def timed_query(query: str, kind: str, rows: int, bytes_scanned: int,
                device: str = "cpu"):
    """Record one query execution on ``device`` and the operators it ran;
    yields a one-element list the caller sets to the output row count."""
    t0 = time.perf_counter()
    out_rows = [0]
    prev_ops = getattr(_trace_local, "ops", None)
    prev_cs = getattr(_trace_local, "collectives", None)
    _trace_local.ops = []
    _trace_local.collectives = []
    try:
        yield out_rows
    finally:
        ops = tuple(_trace_local.ops)
        cs = tuple(_trace_local.collectives)
        _trace_local.ops = prev_ops
        _trace_local.collectives = prev_cs
        record(QueryMetrics(
            query=query, kind=kind, wall_s=time.perf_counter() - t0,
            rows=rows, bytes_scanned=bytes_scanned, output_rows=out_rows[0],
            operators=ops, collectives=cs, device=str(device),
        ))


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where there is a
    card); writes ``trace.json`` (Chrome trace format) into ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# Roofline accounting: a query's bytes scanned per second against the
# device's peak memory rate.
# ---------------------------------------------------------------------------

# Peak memory rate, bytes/s: the H100 SXM from NVIDIA's data sheet; the
# host figure is the reference's.
_PEAK_HBM = {
    "H100": 3.35e12,
}
_PEAK_HOST = 50e9


def peak_hbm_bytes_per_s(device: str = "cpu") -> Optional[float]:
    """Peak memory rate of ``device``: the host's for ``"cpu"``, a card's
    by its ``torch.cuda.get_device_name``; None for a card the table does
    not hold."""
    import torch

    dev = torch.device(device)
    if dev.type == "cpu":
        return _PEAK_HOST
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name(dev)
    for name, bw in _PEAK_HBM.items():
        if name.lower() in kind.lower():
            return bw
    return None


def roofline_fraction(m: QueryMetrics) -> Optional[float]:
    """Share of its device's peak memory rate this query's scan reached;
    None where that peak is unknown."""
    peak = peak_hbm_bytes_per_s(m.device)
    return None if peak is None else m.gb_per_s * 1e9 / peak


def report(last_n: int = 20) -> str:
    """Recent queries with their roofline shares."""
    lines = ["query                                    kind        ms    "
             "Mrows/s   GB/s  %peak"]
    for m in history()[-last_n:]:
        share = roofline_fraction(m)
        lines.append(
            f"{m.query[:40]:<40} {m.kind:<10} {m.wall_s*1e3:6.1f} "
            f"{m.rows_per_s/1e6:9.1f} {m.gb_per_s:6.2f} "
            + (f"{share*100:5.1f}" if share is not None else "    -")
        )
    return "\n".join(lines)
