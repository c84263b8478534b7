"""Kernel K1: top-k for ORDER BY ... LIMIT.

Replaces ``warpdb_tpu/ops/pallas_topk.py:pallas_topk_candidates`` (the
streaming per-lane top-k Pallas kernel).  The CUDA kernel is
``csrc/topk.cu``: one launch streams the input with 16-byte loads, keeps
each warp's top-k in shared memory behind a block-wide threshold, merges
the warps' lists in each block and the blocks' lists in the last block to
finish.  It reads every input byte once, so it is bound by device-memory
bandwidth; see the source for the design.

Contract: ``u`` is f32[n] in descending-priority space (invalid rows
-inf, no NaN), ``1 < k <= 128``, any n.  The result is a ``(1, w)`` row
sorted descending whose first k values are the top-k multiset of ``u``,
duplicates included, padded with -inf where ``n < k``: ``w`` is
``kernel_k(k)`` from the kernel and ``k`` from the plain version.
:func:`warpdb_tpu_torch.ops.sort.top_k_values` takes its first k.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`topk_candidates_plain`.  ``topk_candidates.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import torch

from ..errors import ExecutionError
from ..utils.metrics import note_operator

__all__ = ["topk_candidates", "topk_candidates_plain", "kernel_k", "MAX_K",
           "THREADS", "UNROLL"]

MAX_K = 128
# One block of THREADS an SM; each lane keeps UNROLL 16-byte loads in
# flight (csrc/topk.cu's U).
THREADS = 1024
UNROLL = 8


def kernel_k(k: int) -> int:
    """The kernel's template width for a request of ``k``: the smallest
    of 16, 32, 64, 128 that is at least ``k``."""
    if not 1 < k <= MAX_K:
        raise ValueError(f"top-k kernel needs 1 < k <= {MAX_K}, got {k}")
    kk = 16
    while kk < k:
        kk *= 2
    return kk


def grid_size(n: int, sms: int) -> int:
    """Blocks of one launch: one an SM, fewer where the input gives each
    lane fewer than UNROLL 16-byte units."""
    return max(1, min(sms, -(-n // (THREADS * UNROLL * 4))))


def topk_candidates_plain(u: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: the top-k of ``u`` itself, as a (1, k)
    row sorted descending, padded with -inf."""
    kernel_k(k)
    n = u.shape[0]
    top = torch.topk(u, min(k, n)).values
    if n < k:
        pad = torch.full((k - n,), float("-inf"), dtype=u.dtype,
                         device=u.device)
        top = torch.cat([top, pad])
    return top.reshape(1, k)


# Per (device, stream): a zeroed ticket, which the kernel's last block
# resets, and the blocks' scratch lists; launches on one stream reuse
# both in order.
_scratch: dict = {}


def topk_candidates(u: torch.Tensor, k: int) -> torch.Tensor:
    """(1, kernel_k(k)) sorted top row of ``u`` (see module doc)."""
    if u.device.type == "cpu":
        note_operator("K1 topk (plain)", True)
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
    dev = u.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch.get((dev.index, stream))
    if scratch is None:
        # The ticket, then room for every block's list at the widest k.
        scratch = _scratch[(dev.index, stream)] = torch.zeros(
            1 + sms * MAX_K, dtype=torch.int32, device=dev)
    grid = grid_size(n, sms)
    ticket, blocks = scratch[:1], scratch[1:].view(torch.float32)
    out = torch.empty((1, kk), dtype=torch.float32, device=dev)
    lib = _build.load("topk")
    # The runtime launches on the current device: make it the tensor's.
    with torch.cuda.device(dev):
        rc = lib.warpdb_topk(u.data_ptr(), n, kk, blocks.data_ptr(),
                             out.data_ptr(), ticket.data_ptr(), grid, stream)
    if rc != 0:
        raise ExecutionError(f"top-k kernel launch failed: CUDA error {rc}")
    topk_candidates.launches += 1
    _build.note_launch("topk", "K1 topk")
    return out


topk_candidates.launches = 0
