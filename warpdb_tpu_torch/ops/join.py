"""Equi-join phase 1: match ranges of each probe row in the sorted build.

Counterpart of ``warpdb_tpu/ops/join.py``.  Keys compare in sort-key
space (``ops.sort.sort_key_any``): raw int32 keys for integer columns,
the f32 total-order key otherwise, so -0.0 matches +0.0 and every NaN
matches the canonical NaN.  The build side sorts once, stably; each
probe row's duplicate range ``[lo, lo + counts)`` in that order comes
from two ``torch.searchsorted`` calls.  The TPU avoided searchsorted
(its lowering loops over gathers) with merged probe∪build sorts; the
values are the same.

Phase 2, the expansion of those ranges into output rows, is
``ops/expand.py`` (kernels K3 and K4) and the engine's gathers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .sort import U32_MAX, lexsort, sort_key_any

__all__ = ["JoinPhase1", "join_match_counts"]


class JoinPhase1(NamedTuple):
    build_order: torch.Tensor   # i64[n_build] original index of sorted build rows
    build_sorted: torch.Tensor  # i64[n_build] sorted build sort keys
    lo: torch.Tensor            # i64[n_probe] first matching sorted-build slot
    counts: torch.Tensor        # i64[n_probe] matches per probe row
    total: torch.Tensor         # i64 scalar, total matched pairs


def _masked(keys: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return keys if mask is None else torch.where(mask, keys, U32_MAX)


def _composite_ids(probe_keys, probe_mask, build_keys, build_mask):
    """Dense ids of composite key tuples over probe ∪ build (reference
    ``_composite_ids``): one stable multi-key sort, equal tuples get
    equal ids, so the single-key machinery applies unchanged."""
    n_p = probe_keys[0].shape[0]
    allk = [
        torch.cat([_masked(sort_key_any(p), probe_mask),
                   _masked(sort_key_any(b), build_mask)])
        for p, b in zip(probe_keys, build_keys)
    ]
    perm = lexsort(allk)
    first = torch.zeros(perm.shape[0], dtype=torch.bool, device=perm.device)
    if perm.shape[0]:
        first[0] = True
    for k in allk:
        ks = k[perm]
        first[1:] |= ks[1:] != ks[:-1]
    pid = torch.cumsum(first.to(torch.int64), 0) - 1
    ids = torch.empty_like(pid)
    ids[perm] = pid
    return ids[:n_p], ids[n_p:]


def _sorted_build(bkey, build_mask):
    bkey = _masked(bkey, build_mask)
    bkey_s, order = torch.sort(bkey, stable=True)
    return bkey_s, order


def join_match_counts(probe_keys, probe_mask, build_keys,
                      build_mask) -> JoinPhase1:
    """Phase 1 (reference ``join_match_counts``).  ``probe_keys`` /
    ``build_keys`` are single tensors or equal-length sequences for
    composite ``ON a = b AND c = d`` conditions; a mask of None means
    every row is valid."""
    if isinstance(probe_keys, (tuple, list)) and len(probe_keys) > 1:
        pkey, bkey = _composite_ids(tuple(probe_keys), probe_mask,
                                    tuple(build_keys), build_mask)
    else:
        if isinstance(probe_keys, (tuple, list)):
            probe_keys, build_keys = probe_keys[0], build_keys[0]
        pkey, bkey = sort_key_any(probe_keys), sort_key_any(build_keys)
    bkey_s, order = _sorted_build(bkey, build_mask)
    lo = torch.searchsorted(bkey_s, pkey)
    hi = torch.searchsorted(bkey_s, pkey, right=True)
    counts = _masked_counts(hi - lo, probe_mask)
    return JoinPhase1(order, bkey_s, lo, counts, counts.sum())


def _masked_counts(counts, mask):
    return counts if mask is None else torch.where(mask, counts, 0)
