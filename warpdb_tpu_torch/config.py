"""Engine configuration of the port.

One dataclass, as the reference's (``warpdb_tpu/config.py``), overridable
per process by ``set_config`` and from ``WARPDB_<FIELD>`` environment
variables, which ``get_config`` reads once.  The fields are the
reference's, with one renamed and three left out:

* ``group_hist_max_slots`` is the reference's ``mxu_group_max_slots``:
  the cap of the SUM/COUNT group kernel K2, not of an MXU one-hot;
* ``compilation_cache_dir`` has no counterpart: it is XLA's executable
  cache, and ``_build.py`` already keys the built kernels by a hash of
  their sources;
* ``join_dense_build_max`` and ``shuffle_overlap`` have no counterpart:
  they are TPU workarounds the port does not carry (``ROADMAP.md``).

Every tier threshold was measured on the H100 by ``python3 chip_smoke.py
--tiers`` (``PERF.md`` §6): each is the crossover, the smallest swept
size from which the next tier wins on both key mixes there and at every
larger size, at every row count swept; the mesh's, where the two key
mixes part, goes by the root card's peak memory, on NCCL ranks.  Each comment gives
both sides' engine walls there.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = ["EngineConfig", "get_config", "set_config"]


@dataclasses.dataclass
class EngineConfig:
    # Padding multiple of device columns (reference pad_multiple).
    pad_multiple: int = 1024
    # Rows per chunk of the out-of-core stream (reference rows_per_chunk).
    rows_per_chunk: int = 1_000_000
    # The crossovers below: engine wall, median of 5 warm runs, 2^25
    # rows unless stated, uniform / Zipf(1.3) keys, on an NVIDIA H100
    # 80GB HBM3, 700.00 W (``chip_smoke.py --tiers``, PERF.md §6).
    #
    # GROUP BY tiers over stats-bounded integral keys: dense up to this
    # many slots; the window's dense partition broadcast too.  The group
    # side's crossover is the grouped finish (ORDER BY SUM(..) LIMIT),
    # the midrange tier's on the device against this tier's on the host:
    # at 4096 slots 1.67 against 2.10 ms uniform, 1.97 against 2.03 ms
    # Zipf; at 8192, 1.44 against 2.25 and 2.05 against 2.06 (three
    # runs put the crossover at 4096-8192 slots: the reference's value
    # stays).  The window's broadcast beats the sort through 2^20 slots
    # (118.7 against 142.3 ms uniform at 2^20), so the field takes the
    # group side's, the lower.
    dense_group_max_slots: int = 4096
    # Midrange slot table: unconditional up to base, up to max when the
    # input has at least as many rows as slots.  Base: with fewer rows
    # than slots the sort wins on both key mixes from 2^22 slots at 2^12
    # rows (1.27 / 1.27 ms against the table's 1.34 / 1.33; at 2^23,
    # 1.14 / 1.11 against 1.21 / 1.53) and at no row count (2^10-2^20)
    # through 2^21 slots, where the table holds 61 MB (the sort under
    # 1 MB).  Max: with as many rows as slots the sorted tier wins on
    # neither key mix at once through 2^23 slots at 2^23 or 2^25 rows:
    # at 2^23 slots and 2^25 rows the slot table takes 120.0 / 40.4 ms
    # against the sort's 99.9 / 97.7 (uniform / Zipf); the sweep's
    # widest key is 2^23.
    midrange_group_base_slots: int = 1 << 21
    midrange_group_max_slots: int = 1 << 23
    # SUM/COUNT-only queries take the group kernel K2 up to this many
    # slots, dense or midrange (reference mxu_group_max_slots; K2 holds
    # at most 2^16).  K2 beats the scatter at every swept size, 2 to
    # 2^16 slots: at 2^16, 1.94 against 3.23 ms uniform and 3.84
    # against 32.61 ms Zipf.
    group_hist_max_slots: int = 1 << 16
    # Materialised joins memoised per probe table (LRU entries; 0 turns
    # the memo off, as timing runs must).
    join_cache_entries: int = 4
    # Aggregate pushdown through a join (reference eager_join_aggregation).
    eager_join_aggregation: bool = True
    # Probe- and build-side WHERE pushdown below joins.
    join_filter_pushdown: bool = True
    # The midrange tier's grouped finish on the device: HAVING, ORDER BY
    # <aggregate> and LIMIT prune and order the slot table there, so
    # O(limit) groups reach the host instead of O(groups).
    grouped_device_finish: bool = True
    # Mesh GROUP BY: up to this many stats-bounded key tuples the
    # all_gather merge of per-shard partials, above it the all-to-all
    # shuffle.  Four NCCL ranks, one shard a card, dense single keys:
    # the merge wins on both key mixes through 2^19 key tuples (10.00 /
    # 16.89 ms against the combine's 14.25 / 22.07, uniform / Zipf);
    # from 2^20 the mixes part (uniform 28.90 against 18.14, Zipf 18.01
    # against 22.80) and the merge's root card peaks 2.1x the combine's
    # (466 against 219 MB above resident at 2^20, 2361 against 1137 at
    # 2^23), so the shuffle takes them.  Four shards of one card part
    # one size later (2^21).  Sparse composite keys (512 of up to 2^23
    # tuples) sort on every shard whatever the route: the merge is
    # 17-40% faster at every size, peaks equal (696 MB).
    distributed_small_keys: int = 1 << 19
    # Float64 load policy ("strict" | "downcast"), as the reference.
    f64_policy: str = "strict"
    # UDF module discovered in the working directory.
    udf_module: str = "custom.py"

    @classmethod
    def from_env(cls) -> "EngineConfig":
        """The defaults, each overridden by ``WARPDB_<FIELD UPPER>``
        where set: int, float, bool (``1``, ``true``, ``yes``, any case)
        or str by the field's annotation."""
        cfg = cls()
        for field in dataclasses.fields(cls):
            env = os.environ.get(f"WARPDB_{field.name.upper()}")
            if env is None:
                continue
            # Under ``from __future__ import annotations`` the type is
            # the annotation's string.
            tname = (field.type if isinstance(field.type, str)
                     else getattr(field.type, "__name__", "str"))
            if tname == "int":
                value = int(env)
            elif tname == "float":
                value = float(env)
            elif tname == "bool":
                value = env.lower() in ("1", "true", "yes")
            else:
                value = env
            setattr(cfg, field.name, value)
        return cfg


_config: Optional[EngineConfig] = None


def get_config() -> EngineConfig:
    """The process's configuration, read from the environment on the
    first call."""
    global _config
    if _config is None:
        _config = EngineConfig.from_env()
    return _config


def set_config(cfg: EngineConfig) -> None:
    global _config
    _config = cfg
