"""Engine configuration of the port.

Only the fields the port reads.  The thresholds start at the
reference's values (``warpdb_tpu/config.py:21-24,28,39-63``); they are
v5e-derived and not yet measured on the H100.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["EngineConfig", "get_config", "set_config"]


@dataclasses.dataclass
class EngineConfig:
    # Padding multiple of device columns (reference pad_multiple).
    pad_multiple: int = 1024
    # Rows per chunk of the out-of-core stream (reference rows_per_chunk).
    rows_per_chunk: int = 1_000_000
    # GROUP BY tiers over stats-bounded integral keys: dense up to this
    # many slots (v5e-derived, not yet measured on the H100).
    dense_group_max_slots: int = 4096
    # Midrange slot table: unconditional up to base, up to max when the
    # input has at least as many rows as slots (v5e-derived).
    midrange_group_base_slots: int = 1 << 20
    midrange_group_max_slots: int = 1 << 23
    # SUM/COUNT-only midrange queries take the histogram kernel (K2) up
    # to this many slots (reference: mxu_group_max_slots; v5e-derived).
    group_hist_max_slots: int = 1 << 16
    # Materialised joins memoised per probe table (LRU entries; 0 turns
    # the memo off, as timing runs must).
    join_cache_entries: int = 4
    # Aggregate pushdown through a join (reference eager_join_aggregation).
    eager_join_aggregation: bool = True
    # Probe- and build-side WHERE pushdown below joins.
    join_filter_pushdown: bool = True
    # Float64 load policy ("strict" | "downcast"), as the reference.
    f64_policy: str = "strict"
    # UDF module discovered in the working directory.
    udf_module: str = "custom.py"


_config: Optional[EngineConfig] = None


def get_config() -> EngineConfig:
    global _config
    if _config is None:
        _config = EngineConfig()
    return _config


def set_config(cfg: EngineConfig) -> None:
    global _config
    _config = cfg
