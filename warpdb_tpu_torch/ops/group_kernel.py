"""Kernel K2: dense group histogram (exact counts, f32 sums per slot).

Replaces ``warpdb_tpu/ops/pallas_group.py:pallas_group_counts_sums`` (the
MXU one-hot Pallas kernel).  The CUDA kernel is ``csrc/group_hist.cu``:
the slot table lives in shared memory, cut into slices of at most 200 KB,
one a block; blocks in groups of one block a slice each read all of the
group's rows and add the ones they own with shared-memory atomics; each
group flushes a partial table that a second pass adds up.  See the source
for the design and its measured alternatives.

Contract: ``gid`` is i32[n]; ``values`` is a sequence of f32[n] (may be
empty); ``0 < num_slots <= MAX_SLOTS`` (2^16, the midrange tier's cap),
any n.  Returns ``(counts i32[num_slots], tuple of f32[num_slots])``.
Ids outside ``[0, num_slots)`` contribute nothing; callers pass invalid
rows as ``num_slots``.  Counts are exact at any row count.  Sums are f32,
added in a run-dependent order on the card (compare with a tolerance).
Unlike the TPU kernel, values need not be finite: ±inf and NaN reach only
their own slot.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`group_counts_sums_plain`.  Both refuse a slot count outside the
contract.  ``group_counts_sums.launches`` counts kernel launches (one per
batch of up to four value columns).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..errors import ExecutionError
from ..utils.metrics import note_operator

__all__ = ["group_counts_sums", "group_counts_sums_plain", "slice_plan",
           "Plan", "MAX_SLOTS"]

_COLS_PER_LAUNCH = 4
MAX_SLOTS = 1 << 16
# A slice of the table takes at most this much of a block's shared memory
# (Hopper gives a block 227 KB); up to four blocks share an SM, 1024
# threads an SM in all.
SLICE_BYTES = 200 * 1024
_SM_BYTES = 233_472  # shared memory of an SM, less 1 KB a block reserved
_BLOCKS_PER_SM = 4


class Plan(NamedTuple):
    slices: int   # blocks the table is cut over
    S: int        # slots a slice
    magic: int    # ceil(2^32 / S): slot g lies in slice umulhi(g, magic)
    threads: int  # threads a block
    smem: int     # dynamic shared memory a block, bytes


def _check_slots(num_slots: int) -> None:
    if not 0 < num_slots <= MAX_SLOTS:
        raise ExecutionError(
            f"group kernel holds 1..{MAX_SLOTS} slots (the midrange tier's "
            f"cap), got {num_slots}"
        )


def slice_plan(num_slots: int, has_count: int, nv: int) -> Plan:
    """The launch plan of one batch: the table of ``has_count + nv``
    4-byte words a slot cut into the fewest slices of at most
    SLICE_BYTES, ``S = ceil(num_slots / slices)`` slots each (at least 2
    where there are several, so that the magic fits 32 bits); slot ``g``
    lies in slice ``umulhi(g, magic) == g // S`` at local index
    ``g - slice * S``; as many blocks an SM (up to four) as fit."""
    _check_slots(num_slots)
    words = has_count + nv
    slices = 1
    while -(-num_slots // slices) * words * 4 > SLICE_BYTES:
        slices += 1
    S = -(-num_slots // slices)
    if slices > 1:
        S = max(S, 2)
    smem = S * words * 4
    per_sm = max(1, min(_BLOCKS_PER_SM, _SM_BYTES // (smem + 1024)))
    magic = 0 if slices == 1 else -(-(1 << 32) // S)
    return Plan(slices, S, magic, 1024 // per_sm // 32 * 32, smem)


def group_counts_sums_plain(gid: torch.Tensor, values, num_slots: int):
    """Plain PyTorch version: ``bincount`` / ``index_add_`` with the same
    out-of-range rule.  Each slot adds in float64 and rounds to f32 once,
    as the card's kernel combines its partial tables in f64 (one f32 add
    chain a slot drifts by 5e-4 at 2^21 rows on one hot slot)."""
    _check_slots(num_slots)
    ok = (gid >= 0) & (gid < num_slots)
    # Out-of-range rows go to an extra slot that is dropped.
    idx = torch.where(ok, gid, num_slots).to(torch.int64)
    counts = torch.bincount(idx, minlength=num_slots + 1)[:num_slots]
    sums = tuple(
        torch.zeros(num_slots + 1, dtype=torch.float64, device=gid.device)
        .index_add_(0, idx, v.to(torch.float64))[:num_slots]
        .to(torch.float32)
        for v in values
    )
    return counts.to(torch.int32), sums


_blocks_cache: dict = {}


def _blocks_per_sm(fn, device, hc: int, nv: int, plan: Plan) -> int:
    key = (device.index, hc, nv, plan)
    got = _blocks_cache.get(key)
    if got is None:
        import ctypes

        out = ctypes.c_int(0)
        rc = fn(hc, nv, plan.threads, plan.smem, ctypes.addressof(out))
        if rc != 0 or out.value < 1:
            raise ExecutionError(
                f"group kernel: no block of {plan.threads} threads and "
                f"{plan.smem} bytes of shared memory fits an SM (CUDA error "
                f"{rc})"
            )
        got = _blocks_cache[key] = out.value
    return got


def group_counts_sums(gid: torch.Tensor, values, num_slots: int):
    """Counts and per-slot sums of ``values`` by ``gid`` (module doc)."""
    values = tuple(values)
    if gid.device.type == "cpu":
        note_operator("K2 group_hist (plain)", True)
        return group_counts_sums_plain(gid, values, num_slots)
    if gid.device.type != "cuda":
        raise ExecutionError(f"group kernel: unsupported device {gid.device}")
    _check_slots(num_slots)
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
    from .. import _build

    gid = gid.contiguous()
    values = tuple(v.contiguous() for v in values)
    dev = gid.device
    counts = torch.empty(num_slots, dtype=torch.int32, device=dev)
    sums = torch.empty((len(values), num_slots), dtype=torch.float32,
                       device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load("group_hist")
    # The first launch counts; each batch of up to four columns sums.
    batches = [
        list(range(s, min(s + _COLS_PER_LAUNCH, len(values))))
        for s in range(0, max(len(values), 1), _COLS_PER_LAUNCH)
    ]
    # The runtime launches on the current device: make it the ids'.
    with torch.cuda.device(dev):
        for b, cols in enumerate(batches):
            hc = int(b == 0)
            plan = slice_plan(num_slots, hc, len(cols))
            # Persistent groups of `slices` blocks, each block of a group with
            # at least eight rows a thread.
            resident = _blocks_per_sm(lib.warpdb_group_hist_blocks, dev, hc,
                                      len(cols), plan) * sms
            groups = max(1, min(resident // plan.slices,
                                -(-n // (plan.threads * 8))))
            partials = torch.empty(groups * (hc + len(cols)) * num_slots,
                                   dtype=torch.int32, device=dev)
            ptrs = [values[c].data_ptr() for c in cols]
            ptrs += [None] * (_COLS_PER_LAUNCH - len(ptrs))
            rc = lib.warpdb_group_hist(
                gid.data_ptr(), n, num_slots, *ptrs, len(cols),
                counts.data_ptr() if hc else None,
                sums[cols[0]].data_ptr() if cols else None,
                partials.data_ptr(), plan.slices, groups, plan.S, plan.magic,
                plan.threads, plan.smem, stream,
            )
            if rc != 0:
                raise ExecutionError(
                    f"group kernel launch failed: CUDA error {rc}"
                )
            group_counts_sums.launches += 1
            _build.note_launch("group_hist", "K2 group_hist")
    return counts, tuple(sums[i] for i in range(len(values)))


group_counts_sums.launches = 0
