"""Kernel K1: top-k candidates for ORDER BY ... LIMIT.

Replaces ``warpdb_tpu/ops/pallas_topk.py:pallas_topk_candidates`` (the
streaming per-lane top-k Pallas kernel).  The CUDA kernel is
``csrc/topk.cu``: a grid-stride pass keeps a sorted top-k per thread in
registers, then each block merges its threads' lists into k candidates.
It reads every input byte once, so it is bound by device-memory
bandwidth; see the source for the design.

Contract: ``u`` is f32[n] in descending-priority space (invalid rows
-inf, no NaN), ``1 < k <= 128``, any n.  The result is a 2-D candidate
tensor whose multiset contains the top-k multiset of ``u``, duplicates
included; :func:`warpdb_tpu_torch.ops.sort.top_k_values` finishes it with
one ``torch.topk``.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`topk_candidates_plain`.  ``topk_candidates.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import torch

from ..errors import ExecutionError

__all__ = ["topk_candidates", "topk_candidates_plain", "kernel_k", "MAX_K"]

MAX_K = 128
_BLOCKS_PER_SM = 4


def kernel_k(k: int) -> int:
    """The kernel's template width for a request of ``k``: the smallest
    of 16, 32, 64, 128 that is at least ``k``."""
    if not 1 < k <= MAX_K:
        raise ValueError(f"top-k kernel needs 1 < k <= {MAX_K}, got {k}")
    kk = 16
    while kk < k:
        kk *= 2
    return kk


def topk_candidates_plain(u: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: the top-k of ``u`` itself, as a (1, k)
    candidate table padded with -inf."""
    kernel_k(k)
    n = u.shape[0]
    top = torch.topk(u, min(k, n)).values
    if n < k:
        pad = torch.full((k - n,), float("-inf"), dtype=u.dtype,
                         device=u.device)
        top = torch.cat([top, pad])
    return top.reshape(1, k)


def topk_candidates(u: torch.Tensor, k: int) -> torch.Tensor:
    """(blocks, kernel_k(k)) candidate table of ``u`` (see module doc)."""
    if u.device.type == "cpu":
        return topk_candidates_plain(u, k)
    if u.device.type != "cuda":
        raise ExecutionError(f"top-k kernel: unsupported device {u.device}")
    if u.dtype != torch.float32 or u.dim() != 1:
        raise ExecutionError(
            f"top-k kernel takes f32[n], got {u.dtype} of shape "
            f"{tuple(u.shape)}"
        )
    from .. import _build

    kk = kernel_k(k)
    u = u.contiguous()
    n = u.shape[0]
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    grid = max(1, min(sms * _BLOCKS_PER_SM, -(-n // 128)))
    out = torch.empty((grid, kk), dtype=torch.float32, device=u.device)
    lib = _build.load("topk")
    rc = lib.warpdb_topk_candidates(
        u.data_ptr(), n, kk, out.data_ptr(), grid,
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    if rc != 0:
        raise ExecutionError(f"top-k kernel launch failed: CUDA error {rc}")
    topk_candidates.launches += 1
    return out


topk_candidates.launches = 0
