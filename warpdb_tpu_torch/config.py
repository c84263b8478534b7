"""Engine configuration of the port.

Only the fields the single-table slice reads.  The thresholds start at
the reference's values (``warpdb_tpu/config.py:21,28,39-43``); they are
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
