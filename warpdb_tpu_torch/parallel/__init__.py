"""Execution beyond one in-memory table: the out-of-core stream
(``streaming.py``).  Multi-device execution is not ported yet."""

from .streaming import last_stream_stats, run_streaming_csv, run_streaming_sql

__all__ = ["last_stream_stats", "run_streaming_csv", "run_streaming_sql"]
