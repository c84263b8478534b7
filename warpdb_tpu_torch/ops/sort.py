"""Sort and top-k operators (ORDER BY, LIMIT, grouping keys).

Counterpart of ``warpdb_tpu/ops/sort.py``.  The reference keys sorts in
uint32 space; torch supports few operations on ``torch.uint32``, so keys
here are int64 tensors holding the same uint32 values (the same
bijections, so the order is identical):

* ``float_sort_key``: f32 → [0, 2^32) total order, -0.0 → +0.0 and every
  NaN → the canonical NaN, which ranks above +inf;
* ``int_sort_key``: int32 → [0, 2^32), exact beyond 2^24;
* ``U32_MAX`` (0xFFFFFFFF) is the invalid-row sentinel.

Sorts are stable; multi-key sorts are successive stable sorts from the
least significant key.
"""

from __future__ import annotations

import torch

from .topk_kernel import MAX_K, topk_candidates

__all__ = [
    "sort_values", "sort_pairs", "sort_by_keys", "top_k_values",
    "order_key", "float_sort_key", "int_sort_key", "sort_key_any",
    "lexsort", "U32_MAX",
]

U32_MAX = 0xFFFFFFFF
_SIGN = 0x80000000


def float_sort_key(values: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection f32 → [0, 2^32) as int64."""
    v = torch.where(values == 0.0, torch.zeros_like(values), values)
    v = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), v)
    bits = v.contiguous().view(torch.int32).to(torch.int64) & U32_MAX
    return torch.where(bits >= _SIGN, bits ^ U32_MAX, bits | _SIGN)


def int_sort_key(values: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection int32 → [0, 2^32) as int64 (the
    reference's sign-bit flip)."""
    return values.to(torch.int32).to(torch.int64) + _SIGN


def sort_key_any(values: torch.Tensor) -> torch.Tensor:
    """Raw int key for integer tensors, the f32 total-order key
    otherwise."""
    if not values.dtype.is_floating_point:
        return int_sort_key(values)
    return float_sort_key(values)


def order_key(values: torch.Tensor, mask, ascending: bool) -> torch.Tensor:
    """Direction-aware key with an invalid-last sentinel."""
    k = sort_key_any(values)
    if not ascending:
        k = U32_MAX - k
    if mask is None:
        return k
    return torch.where(mask, k, U32_MAX)


def lexsort(keys) -> torch.Tensor:
    """Stable permutation sorting by ``keys`` (most significant first)."""
    keys = list(keys)
    perm = torch.sort(keys[-1], stable=True).indices
    for k in reversed(keys[:-1]):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def sort_values(values: torch.Tensor, mask, ascending: bool) -> torch.Tensor:
    """Sort valid values; invalid lanes sort to the back."""
    perm = torch.sort(order_key(values, mask, ascending), stable=True).indices
    return values[perm]


def sort_pairs(keys: torch.Tensor, values: torch.Tensor, mask,
               ascending: bool):
    """Sort ``values`` by ``keys``, stable, invalid lanes last; returns
    (values_sorted, mask_sorted)."""
    perm = torch.sort(order_key(keys, mask, ascending), stable=True).indices
    m = mask[perm] if mask is not None else None
    return values[perm], m


def sort_by_keys(keys_dirs, values: torch.Tensor, mask) -> torch.Tensor:
    """Sort ``values`` by several (key, ascending) terms, stable, invalid
    lanes last."""
    ks = [
        order_key(k, mask if i == 0 else None, asc)
        for i, (k, asc) in enumerate(keys_dirs)
    ]
    return values[lexsort(ks)]


def top_k_values(values: torch.Tensor, mask, k: int,
                 ascending: bool) -> torch.Tensor:
    """First ``k`` values of the sorted order (ORDER BY … LIMIT k).

    Invalid rows become ±inf; the problem turns into "k largest" in
    descending-priority space; kernel K1 shrinks the input to a candidate
    table and one ``torch.topk`` finishes.  Callers gate this on order
    keys that provably cannot be NaN."""
    inf = float("inf") if ascending else float("-inf")
    v = values if mask is None else torch.where(mask, values, inf)
    u = -v if ascending else v
    n = u.shape[0]
    if n == 0:
        return torch.full((k,), inf, dtype=values.dtype, device=values.device)
    if 1 < k <= MAX_K:
        u = topk_candidates(u, k).reshape(-1)
    top = torch.topk(u, min(k, u.shape[0])).values
    if top.shape[0] < k:
        pad = torch.full((k - top.shape[0],), float("-inf"),
                         dtype=top.dtype, device=top.device)
        top = torch.cat([top, pad])
    return -top if ascending else top
