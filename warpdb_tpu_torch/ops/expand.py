"""Kernels K3, K4 and K5: the join's expansion and gathers.

Replace the three Pallas kernels of ``warpdb_tpu/ops/pallas_expand.py``:

* K3 :func:`windowed_expand` (``windowed_expand``): for each output row
  r < total, its owner probe row (the last row whose exclusive offset is
  <= r), ``dup = r - offsets[owner]`` and C columns gathered at the owner
  (``csrc/windowed_expand.cu``);
* K4 :func:`uniform_expand` (``uniform_expand``): ``out_c[r] =
  col_c[r // k]`` for a uniform fan-out k (``csrc/uniform_expand.cu``);
* K5 :func:`sorted_take` (``windowed_sorted_take``): ``out_c[r] =
  valid[r] ? col_c[idx[r]] : 0`` at a nondecreasing index
  (``csrc/sorted_take.cu``).

All three move 32-bit words: columns are any 4-byte dtype (f32, int32)
and come back bit for bit, NaN payloads, -0.0 and full-range codes
included.  The TPU kernels' shape rules (1024-row blocks, k in {2, 4, 8},
span gates) do not apply: any length, k and offsets work.  Each is bound
by device-memory bandwidth; the sources say what their designs do about
it.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain PyTorch version beside it.  Each wrapper's ``launches`` counts its
kernel launches (one per batch of up to 16 columns).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..errors import ExecutionError
from ..utils.metrics import note_operator

__all__ = [
    "windowed_expand", "windowed_expand_plain",
    "uniform_expand", "uniform_expand_plain",
    "sorted_take", "sorted_take_plain",
]

_I32 = torch.int32
_MAX_COLS = 16
_BLOCKS_PER_SM = 8
_THREADS = 256
# Merged items (probe rows + outputs) per K3 tile (kTile in its source;
# the kernel refuses a smaller partition scratch).
_K3_TILE = 1024


def _words(cols: Sequence[torch.Tensor], n: Optional[int] = None) -> list:
    """int32 views of 4-byte 1-D columns of one length."""
    out = []
    for c in cols:
        if c.dim() != 1 or c.element_size() != 4:
            raise ExecutionError(
                f"expansion kernels take 4-byte 1-D columns, got {c.dtype} "
                f"of shape {tuple(c.shape)}"
            )
        if n is not None and c.shape[0] != n:
            raise ExecutionError("expansion kernels take columns of one length")
        n = c.shape[0]
        out.append(c.view(_I32))
    return out


def _unwords(rows, cols) -> tuple:
    return tuple(r.view(c.dtype) for r, c in zip(rows, cols))


# --- plain PyTorch versions -------------------------------------------------


def windowed_expand_plain(offsets: torch.Tensor, cols, total: int,
                          owner: bool = False):
    """Plain K3: ``searchsorted`` for the owners, then one index gather
    per column on the int32 views."""
    words = _words(cols)
    off = offsets.to(torch.int64)
    r = torch.arange(total, dtype=torch.int64, device=off.device)
    own = torch.searchsorted(off, r, right=True) - 1
    dup = (r - off[own]).to(_I32)
    taken = _unwords([w[own] for w in words], cols)
    return (own.to(_I32) if owner else None), dup, taken


def uniform_expand_plain(cols, k: int, total: int) -> tuple:
    """Plain K4: ``col[arange(total) // k]`` on the int32 views."""
    words = _words(cols)
    src = torch.arange(total, dtype=torch.int64, device=words[0].device) // k
    return _unwords([w[src] for w in words], cols)


def sorted_take_plain(cols, idx: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> tuple:
    """Plain K5: ``where(valid, col[idx], 0)`` on the int32 views."""
    words = _words(cols)
    if valid is not None:
        idx = torch.where(valid, idx, 0)
    taken = [w[idx] if valid is None else torch.where(valid, w[idx], 0)
             for w in words]
    return _unwords(taken, cols)


# --- CUDA wrappers ------------------------------------------------------------


def _on_cuda(name: str, *tensors) -> bool:
    """True for CUDA inputs, False for CPU ones; raises otherwise."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ExecutionError(f"{name} kernel: unsupported device(s) {devs}")
    return True


def _chunks(words: list) -> list:
    """(start, host pointer array) per batch of up to 16 columns."""
    out = []
    for s in range(0, len(words), _MAX_COLS):
        part = words[s:s + _MAX_COLS]
        out.append((s, (ctypes.c_void_p * len(part))(
            *[w.data_ptr() for w in part])))
    return out


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise ExecutionError(f"{name} kernel launch failed: CUDA error {rc}")


def _grid(dev, n: int) -> int:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(sms * _BLOCKS_PER_SM, -(-n // _THREADS)))


def windowed_expand(offsets: torch.Tensor, cols, total: int,
                    owner: bool = False):
    """``(owner i32[total] or None, dup i32[total], taken)`` of the
    expansion whose exclusive offsets are ``offsets`` (nondecreasing,
    starting at 0, none above ``total``); ``taken`` holds each column of
    ``cols`` (one per probe row) gathered at the owners."""
    cols = tuple(cols)
    if not cols:
        raise ExecutionError("windowed_expand takes at least one column")
    if not _on_cuda("windowed_expand", offsets, *cols):
        note_operator("K3 windowed_expand (plain)", True)
        return windowed_expand_plain(offsets, cols, total, owner)
    from .. import _build

    n = offsets.shape[0]
    words = [w.contiguous() for w in _words(cols, n)]
    dev = offsets.device
    out = torch.empty((len(words), total), dtype=_I32, device=dev)
    own = torch.empty(total, dtype=_I32, device=dev) if owner else None
    dup = torch.empty(total, dtype=_I32, device=dev)
    if total == 0:
        return own, dup, _unwords(list(out), cols)
    if n == 0:
        raise ExecutionError("windowed_expand: no probe rows for a total > 0")
    off = offsets.to(torch.int64).contiguous()
    # Each tile's split of the merge path, found by the kernel's first pass.
    part = torch.empty(-(-(total + n - 1) // _K3_TILE) + 1,
                       dtype=torch.int64, device=dev)
    fn = _build.load("windowed_expand").warpdb_windowed_expand
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The runtime launches on the current device: make it the columns'.
    with torch.cuda.device(dev):
        for s, ptrs in _chunks(words):
            # Owners and dups come out of the first launch only.
            first = s == 0
            _check("windowed_expand", fn(
                off.data_ptr(), n, total, ctypes.addressof(ptrs), len(ptrs),
                out[s].data_ptr(), total,
                own.data_ptr() if (first and own is not None) else None,
                dup.data_ptr() if first else None, part.data_ptr(),
                part.shape[0], stream,
            ))
            windowed_expand.launches += 1
            _build.note_launch("windowed_expand", "K3 windowed_expand")
    return own, dup, _unwords(list(out), cols)


def uniform_expand(cols, k: int, total: int) -> tuple:
    """``col[r // k]`` for r < ``total`` of each column (``total`` at most
    ``len(col) * k``)."""
    cols = tuple(cols)
    if not cols:
        return ()
    if not _on_cuda("uniform_expand", *cols):
        note_operator("K4 uniform_expand (plain)", True)
        return uniform_expand_plain(cols, k, total)
    from .. import _build

    words = [w.contiguous() for w in _words(cols)]
    if k < 1 or total > words[0].shape[0] * k:
        raise ExecutionError(
            f"uniform_expand: total {total} beyond {words[0].shape[0]} "
            f"rows x k={k}"
        )
    dev = words[0].device
    # Rows padded to a multiple of 4 words: the kernel stores 16-byte runs.
    stride = -(-total // 4) * 4
    out = torch.empty((len(words), stride), dtype=_I32, device=dev)[:, :total]
    if total == 0:
        return _unwords(list(out), cols)
    fn = _build.load("uniform_expand").warpdb_uniform_expand
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The runtime launches on the current device: make it the columns'.
    with torch.cuda.device(dev):
        for s, ptrs in _chunks(words):
            _check("uniform_expand", fn(
                ctypes.addressof(ptrs), len(ptrs), words[0].shape[0], k, total,
                out[s].data_ptr(), stride, stream,
            ))
            uniform_expand.launches += 1
            _build.note_launch("uniform_expand", "K4 uniform_expand")
    return _unwords(list(out), cols)


def sorted_take(cols, idx: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> tuple:
    """Each column gathered at the nondecreasing ``idx``; rows where
    ``valid`` (bool, optional) is False give 0 and may carry any index.
    Valid indices must lie inside the columns."""
    cols = tuple(cols)
    if not cols:
        return ()
    if not _on_cuda("sorted_take", idx, valid, *cols):
        note_operator("K5 sorted_take (plain)", True)
        return sorted_take_plain(cols, idx, valid)
    from .. import _build

    words = [w.contiguous() for w in _words(cols)]
    n = idx.shape[0]
    if valid is not None and (valid.dtype != torch.bool or valid.shape != (n,)):
        raise ExecutionError("sorted_take: valid must be bool of idx's shape")
    dev = idx.device
    out = torch.empty((len(words), n), dtype=_I32, device=dev)
    if n == 0:
        return _unwords(list(out), cols)
    idx64 = idx.to(torch.int64).contiguous()
    valid = valid.contiguous() if valid is not None else None
    vptr = valid.data_ptr() if valid is not None else None
    fn = _build.load("sorted_take").warpdb_sorted_take
    stream = torch.cuda.current_stream(dev).cuda_stream
    grid = _grid(dev, n)
    # The runtime launches on the current device: make it the columns'.
    with torch.cuda.device(dev):
        for s, ptrs in _chunks(words):
            _check("sorted_take", fn(
                ctypes.addressof(ptrs), len(ptrs), idx64.data_ptr(), vptr, n,
                out[s].data_ptr(), n, grid, stream,
            ))
            sorted_take.launches += 1
            _build.note_launch("sorted_take", "K5 sorted_take")
    return _unwords(list(out), cols)


windowed_expand.launches = 0
uniform_expand.launches = 0
sorted_take.launches = 0
