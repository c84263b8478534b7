"""Kernel K2: dense group histogram (exact counts, f32 sums per slot).

Replaces ``warpdb_tpu/ops/pallas_group.py:pallas_group_counts_sums`` (the
MXU one-hot Pallas kernel).  The CUDA kernel is ``csrc/group_hist.cu``:
one grid-stride pass of atomic adds into the slot table.  It reads the
input once and its adds stay in L2, so it is bound by device-memory
bandwidth on the input; see the source for the design.

Contract: ``gid`` is i32[n]; ``values`` is a sequence of f32[n] (may be
empty); ``num_slots <= 2^16`` for the midrange tier that calls it, any n.
Returns ``(counts i32[num_slots], tuple of f32[num_slots])``.  Ids
outside ``[0, num_slots)`` contribute nothing; callers pass invalid rows
as ``num_slots``.  Counts are exact at any row count.  Sums are f32, added
in a run-dependent order on the card (compare with a tolerance).  Unlike
the TPU kernel, values need not be finite: ±inf and NaN reach only their
own slot.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`group_counts_sums_plain`.  ``group_counts_sums.launches`` counts
kernel launches (one per batch of up to four value columns).
"""

from __future__ import annotations

import torch

from ..errors import ExecutionError

__all__ = ["group_counts_sums", "group_counts_sums_plain"]

_COLS_PER_LAUNCH = 4
_BLOCKS_PER_SM = 8


def group_counts_sums_plain(gid: torch.Tensor, values, num_slots: int):
    """Plain PyTorch version: ``bincount`` / ``index_add_`` with the same
    out-of-range rule."""
    ok = (gid >= 0) & (gid < num_slots)
    # Out-of-range rows go to an extra slot that is dropped.
    idx = torch.where(ok, gid, num_slots).to(torch.int64)
    counts = torch.bincount(idx, minlength=num_slots + 1)[:num_slots]
    sums = tuple(
        torch.zeros(num_slots + 1, dtype=torch.float32, device=gid.device)
        .index_add_(0, idx, v)[:num_slots]
        for v in values
    )
    return counts.to(torch.int32), sums


def group_counts_sums(gid: torch.Tensor, values, num_slots: int):
    """Counts and per-slot sums of ``values`` by ``gid`` (module doc)."""
    values = tuple(values)
    if gid.device.type == "cpu":
        return group_counts_sums_plain(gid, values, num_slots)
    if gid.device.type != "cuda":
        raise ExecutionError(f"group kernel: unsupported device {gid.device}")
    n = gid.shape[0]
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise ExecutionError(
            f"group kernel takes gid i32[n], got {gid.dtype} of shape "
            f"{tuple(gid.shape)}"
        )
    for v in values:
        if v.dtype != torch.float32 or v.shape != (n,) or v.device != gid.device:
            raise ExecutionError(
                "group kernel takes f32[n] value columns on the id's device"
            )
    if not 0 < num_slots < 2**31:
        raise ExecutionError(f"group kernel: bad slot count {num_slots}")
    from .. import _build

    gid = gid.contiguous()
    values = tuple(v.contiguous() for v in values)
    counts = torch.zeros(num_slots, dtype=torch.int32, device=gid.device)
    sums = torch.zeros((len(values), num_slots), dtype=torch.float32,
                       device=gid.device)
    sms = torch.cuda.get_device_properties(gid.device).multi_processor_count
    grid = max(1, min(sms * _BLOCKS_PER_SM, -(-n // 256)))
    stream = torch.cuda.current_stream(gid.device).cuda_stream
    fn = _build.load("group_hist").warpdb_group_hist
    # The first launch counts; each batch of up to four columns sums.
    batches = [
        list(range(s, min(s + _COLS_PER_LAUNCH, len(values))))
        for s in range(0, max(len(values), 1), _COLS_PER_LAUNCH)
    ]
    for b, cols in enumerate(batches):
        ptrs = [values[c].data_ptr() for c in cols]
        ptrs += [None] * (_COLS_PER_LAUNCH - len(ptrs))
        sums_ptr = sums[cols[0]].data_ptr() if cols else None
        rc = fn(
            gid.data_ptr(), n, num_slots, *ptrs, len(cols),
            counts.data_ptr() if b == 0 else None, sums_ptr, grid, stream,
        )
        if rc != 0:
            raise ExecutionError(
                f"group kernel launch failed: CUDA error {rc}"
            )
        group_counts_sums.launches += 1
    return counts, tuple(sums[i] for i in range(len(values)))


group_counts_sums.launches = 0
