"""The collective interface every parallel operator is written against.

The reference's ``shard_map`` bodies call ``lax.all_gather``,
``lax.all_to_all`` and ``lax.psum`` over the mesh's data axis, and
``fetch_global`` pulls results across processes
(``warpdb_tpu/parallel/sharded.py:120-139``).  Here one interface has two
implementations:

* :class:`LocalComm`: one process holds every shard, on the mesh's
  devices (which may repeat); an exchange is a device-to-device copy;
* :class:`DistComm`: one shard a rank of a ``torch.distributed`` group
  (NCCL on CUDA, gloo on the CPU), the torchrun layout.

An operator passes the parts of the shards THIS process holds
(``mesh.local_shards``), in order, and gets back:

* ``all_gather(parts)``: every shard's part, in mesh order, on the root
  device (replicated in a job: every rank gets them all);
* ``all_to_all(send)``: ``send[i][d]`` goes from local shard ``i`` to
  shard ``d``; returns ``recv[j][s]``, what local shard ``j`` got from
  shard ``s``, on its device.  Sizes are exact: the counts travel first,
  then the payload (the reference's static send buckets, overflow flags
  and retries are XLA's static-shape protocol, not needed here);
* ``reduce(parts, op)``: the elementwise ``"sum"`` / ``"min"`` /
  ``"max"`` over every shard's tensor (``psum`` / ``pmin`` / ``pmax``),
  on the root device;
* ``gather_ints(values)``: one Python int from every shard, in order.

A part is a tuple of tensors with one row count (columns of one table).
Each call records its bytes per device with ``note_collective``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..utils.metrics import note_collective

__all__ = ["LocalComm", "DistComm", "fetch_global"]


def _nbytes(cols) -> int:
    return sum(c.numel() * c.element_size() for c in cols)


class LocalComm:
    """Every shard in this process; exchanges are ``Tensor.to`` copies
    (no copy at all between shards that share a device)."""

    kind = "local"

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = tuple(devices)
        self.local_shards = range(len(self.devices))
        self.root = self.devices[0]

    def all_gather(self, parts: list) -> list:
        note_collective("all_gather", sum(_nbytes(p) for p in parts))
        return [tuple(c.to(self.root) for c in p) for p in parts]

    def all_to_all(self, send: list) -> list:
        n = len(self.devices)
        note_collective("all_to_all",
                        sum(_nbytes(c) for row in send for c in row) // n)
        return [[tuple(c.to(self.devices[j]) for c in send[s][j])
                 for s in range(n)] for j in range(n)]

    def reduce(self, parts: list, op: str) -> torch.Tensor:
        note_collective(f"p{op}", _nbytes(parts[:1]))
        stacked = torch.stack([p.to(self.root) for p in parts])
        if op == "sum":
            return stacked.sum(0)
        return stacked.amin(0) if op == "min" else stacked.amax(0)

    def gather_ints(self, values: list) -> list:
        return [int(v) for v in values]


def _wire(t: torch.Tensor) -> torch.Tensor:
    """NCCL moves no bools: they travel as bytes."""
    return t.to(torch.uint8) if t.dtype == torch.bool else t


class DistComm:
    """One shard a rank of a ``torch.distributed`` process group; the
    rank's part rides ``all_gather`` / ``all_to_all_single`` (with split
    sizes) / ``all_reduce`` on its own device."""

    kind = "dist"

    def __init__(self, device: torch.device, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.local_shards = range(self.rank, self.rank + 1)
        self.root = torch.device(device)

    def gather_ints(self, values: list) -> list:
        t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=self.root)
        bufs = [torch.empty_like(t) for _ in range(self.world)]
        self._dist.all_gather(bufs, t, group=self.group)
        return torch.cat(bufs).tolist()

    def all_gather(self, parts: list) -> list:
        (cols,) = parts
        n = cols[0].shape[0] if cols else 0
        sizes = self.gather_ints([n])
        m = max(sizes)
        row_bytes = sum(c.element_size() * math.prod(c.shape[1:])
                        for c in cols)
        note_collective("all_gather", row_bytes * sum(sizes))
        per_col = []
        for c in cols:
            w = _wire(c.to(self.root)).contiguous()
            if m == 0:
                per_col.append([w[:0].to(c.dtype)] * self.world)
                continue
            pad = torch.zeros((m,) + tuple(w.shape[1:]), dtype=w.dtype,
                              device=self.root)
            pad[:n] = w
            bufs = [torch.empty_like(pad) for _ in range(self.world)]
            self._dist.all_gather(bufs, pad, group=self.group)
            per_col.append([b[:s].to(c.dtype) for b, s in zip(bufs, sizes)])
        return [tuple(col[r] for col in per_col) for r in range(self.world)]

    def all_to_all(self, send: list) -> list:
        (row,) = send
        counts_send = [int(p[0].shape[0]) if p else 0 for p in row]
        cs = torch.tensor(counts_send, dtype=torch.int64, device=self.root)
        cr = torch.empty_like(cs)
        self._dist.all_to_all_single(cr, cs, group=self.group)
        counts_recv = cr.tolist()
        note_collective("all_to_all",
                        sum(_nbytes(p) for p in row))
        recv_cols = []
        for j in range(len(row[0])):
            like = row[0][j]
            inp = torch.cat([_wire(p[j].to(self.root)) for p in row])
            out = torch.empty((sum(counts_recv),) + tuple(inp.shape[1:]),
                              dtype=inp.dtype, device=self.root)
            self._dist.all_to_all_single(
                out, inp.contiguous(), output_split_sizes=counts_recv,
                input_split_sizes=counts_send, group=self.group)
            recv_cols.append(out.to(like.dtype).split(counts_recv))
        return [[tuple(col[s] for col in recv_cols)
                 for s in range(self.world)]]

    def reduce(self, parts: list, op: str) -> torch.Tensor:
        (t,) = parts
        note_collective(f"p{op}", _nbytes((t,)))
        red = {"sum": self._dist.ReduceOp.SUM, "min": self._dist.ReduceOp.MIN,
               "max": self._dist.ReduceOp.MAX}[op]
        out = _wire(t.to(self.root)).clone()
        self._dist.all_reduce(out, op=red, group=self.group)
        return out.to(t.dtype)


def fetch_global(x, mesh=None):
    """A result to the host as NumPy: a replicated tensor as it is, or,
    with ``mesh``, the list of this process's per-shard tensors gathered
    over the mesh in shard order."""
    if mesh is not None:
        got = mesh.comm.all_gather([(p,) for p in x])
        x = torch.cat([g[0] for g in got])
    return x.cpu().numpy()
