"""Multi-process execution over ``torch.distributed``.

Counterpart of ``warpdb_tpu/parallel/multihost.py`` (which wraps
``jax.distributed``).  One process a shard, the torchrun layout: every
rank holds its contiguous slice of a table on its own device, and every
rank runs the same statement (SPMD) and gets the same result.

* ``initialize(coordinator, num_processes, process_id)``: joins the
  process group (NCCL for a CUDA device, gloo for the CPU), with a
  timeout so that a lost peer fails instead of hanging; without
  arguments it reads torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
  ``WORLD_SIZE`` / ``RANK`` and is a no-op where they are absent;
* ``global_mesh()``: the job's mesh, one shard a rank, exchanging
  through ``comm.DistComm``;
* ``plan_global_layout`` / ``host_shard_range``: the contiguous row
  range each rank ingests; ``load_csv_host_shard`` reads it;
* ``make_global_table``: a :class:`ShardedTable` from every rank's local
  rows, with job-wide vocabularies (``all_gather_object``) and column
  stats (``all_reduce``), so every rank plans alike and codes compare
  everywhere;
* ``gather_to_host``: every rank's tensor, concatenated, as NumPy.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch

from ..errors import ExecutionError
from ..storage.table import ColumnStats, DeviceTable, HostTable
from .comm import DistComm
from .mesh import DataMesh, data_mesh
from .sharded import ShardedTable, split_table

__all__ = [
    "initialize",
    "is_multiprocess",
    "global_mesh",
    "plan_global_layout",
    "host_shard_range",
    "load_csv_host_shard",
    "make_global_table",
    "gather_to_host",
]

# The device this process's shard lives on, set by ``initialize``.
_STATE: dict = {"device": None}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout_s: float = 60.0) -> None:
    """Join the job at ``coordinator_address`` (``host:port``) as rank
    ``process_id`` of ``num_processes``.  Without a coordinator this
    reads ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
    and does nothing where they are absent (one process).  ``device``
    None means the card (``cuda:LOCAL_RANK``, NCCL); ``"cpu"`` uses
    gloo.  A group that cannot form raises."""
    import torch.distributed as dist

    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        return
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", "1"))
    rank = int(process_id if process_id is not None
               else env.get("RANK", "0"))
    if device is None:
        if not torch.cuda.is_available():
            raise ExecutionError(
                "initialize: CUDA is not available; pass device='cpu' for "
                "a gloo group")
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _STATE["device"] = device


def is_multiprocess() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def global_mesh() -> DataMesh:
    """The job's 1-D mesh, one shard a rank (every rank builds it the
    same way); without a process group, every local CUDA device."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return data_mesh()
    dev = _STATE["device"]
    return DataMesh([dev] * dist.get_world_size(), comm=DistComm(dev))


def _world() -> tuple:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def plan_global_layout(n_rows: int) -> tuple:
    """``(global rows, rows a rank)``: rank r holds rows
    ``[r·per, min((r+1)·per, n))``, so shard-major order is row order.
    (The reference pads to equal, lane-aligned shards; shards here need
    not be equal.)"""
    _rank, p = _world()
    return n_rows, -(-n_rows // max(p, 1))


def host_shard_range(n_rows: int) -> tuple:
    """The contiguous ``[start, end)`` row range this rank ingests."""
    rank, _p = _world()
    _n, per = plan_global_layout(n_rows)
    return min(rank * per, n_rows), min((rank + 1) * per, n_rows)


def load_csv_host_shard(path: str, schema=None) -> tuple:
    """This rank's row slice of a CSV: ``(local HostTable, global
    rows)``.  Rows are counted first (the native library's newline scan
    where it is built), then the file is read and sliced."""
    from ..interchange import native as native_mod
    from ..storage.csv import load_csv_to_host

    lib = native_mod.load_native()
    if lib is not None:
        total = int(lib.wdb_csv_count_rows(os.fsencode(path)))
    else:
        with open(path) as f:
            total = sum(1 for line in f if line.strip()) - 1
    start, end = host_shard_range(total)
    return load_csv_to_host(path, schema).slice(start, end), total


def _gather_objects(obj) -> list:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _global_vocabs(local: HostTable) -> dict:
    """Job-wide sorted vocabularies: every string column, and every
    int64 column whose values leave the int32 range on some rank (two
    ``all_gather_object`` rounds, the second only for such columns)."""
    n = local.num_rows
    strs, ranges = {}, {}
    for c in local.columns:
        v = c.data[:n]
        if not c.dtype.is_numeric:
            strs[c.name] = sorted({"" if x is None else str(x) for x in v})
        elif c.data.dtype == np.int64:
            ranges[c.name] = (int(v.min()), int(v.max())) if n else None
    parts = _gather_objects((strs, ranges))
    vocabs = {name: np.asarray(sorted(set().union(*(p[0][name]
                                                    for p in parts))))
              for name in strs}
    wide = [
        name for name in ranges
        if any(p[1][name] is not None and (p[1][name][0] < -(2**31)
                                           or p[1][name][1] > 2**31 - 1)
               for p in parts)
    ]
    if wide:
        mine = {name: np.unique(local.get_column(name).data[:n]).tolist()
                for name in wide}
        got = _gather_objects(mine)
        for name in wide:
            vocabs[name] = np.asarray(
                sorted(set().union(*(g[name] for g in got))), np.int64)
    return vocabs


def _global_stats(dt: DeviceTable, device) -> dict:
    """Job-wide column stats (min over ranks, max, summed null counts):
    stats decide plans (slot tiers, top-k gates, the mesh GROUP BY's
    route), so every rank must see the same."""
    import torch.distributed as dist

    names = list(dt.stats)
    vec = torch.tensor(
        [[np.inf if dt.stats[n].min is None else float(dt.stats[n].min),
          np.inf if dt.stats[n].max is None else -float(dt.stats[n].max),
          float(dt.stats[n].null_count)] for n in names],
        dtype=torch.float64, device=device).reshape(len(names), 3)
    if dist.is_available() and dist.is_initialized():
        lo = vec[:, :2].contiguous()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        nulls = vec[:, 2].contiguous()
        dist.all_reduce(nulls, op=dist.ReduceOp.SUM)
        vec = torch.cat([lo, nulls[:, None]], 1)
    out = {}
    for n, (mn, neg_mx, nulls) in zip(names, vec.cpu().tolist()):
        out[n] = ColumnStats(min=None if not np.isfinite(mn) else mn,
                             max=None if not np.isfinite(neg_mx) else -neg_mx,
                             null_count=int(nulls))
    return out


def make_global_table(local: HostTable, total_rows: int,
                      mesh: Optional[DataMesh] = None) -> ShardedTable:
    """The job-wide table from every rank's local rows (rank order is
    row order; each rank passes its ``host_shard_range`` slice; a mesh of
    this process's devices shards the rows over them).  String
    columns, and int64 columns wider than int32 anywhere, encode against
    job-wide vocabularies; stats reduce over the job."""
    if mesh is None:
        mesh = global_mesh()
    device = mesh.root
    vocabs = _global_vocabs(local)
    dt = DeviceTable.from_host(local, device=device, keep_host=False,
                               dicts_override=vocabs)
    stats = _global_stats(dt, device)
    for name, vocab in vocabs.items():
        stats[name] = ColumnStats(min=0.0, max=float(max(len(vocab) - 1, 0)),
                                  null_count=0)
    dt.stats = dict(stats)
    if mesh.comm.kind == "local":
        # One process holds the whole table: shard it over the devices.
        return dt if mesh.single_device else split_table(dt, mesh)
    rows = mesh.comm.gather_ints([dt.num_rows])
    if sum(rows) != total_rows:
        raise ExecutionError(
            f"make_global_table: the ranks hold {sum(rows)} rows, not "
            f"{total_rows}; slice with host_shard_range")
    return ShardedTable([dt], mesh, rows, dict(dt.dtypes), stats,
                        dict(dt.dicts))


def gather_to_host(arr: torch.Tensor, mesh: Optional[DataMesh] = None
                   ) -> np.ndarray:
    """Every rank's ``arr`` (rows of its shard), concatenated in rank
    order, on every rank."""
    if mesh is None:
        if _world()[1] == 1:
            return arr.cpu().numpy()
        mesh = global_mesh()
    if mesh.comm.kind != "dist":
        return arr.cpu().numpy()
    got = mesh.comm.all_gather([(arr,)])
    return torch.cat([g[0] for g in got]).cpu().numpy()
