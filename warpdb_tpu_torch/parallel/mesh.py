"""The device mesh of the port: an ordered tuple of devices, one a shard.

Counterpart of ``warpdb_tpu/parallel/mesh.py``.  The reference lays a
table row-sharded over a 1-D ``jax.sharding.Mesh`` and lets GSPMD insert
the collectives; PyTorch has no GSPMD, so a :class:`DataMesh` names the
device of each shard and the collective interface (``comm.py``) that
every parallel operator exchanges data through.  Devices may repeat:
``DataMesh(["cpu"] * 8)`` is the CPU mesh the tests run (the reference's
eight virtual CPU devices), ``DataMesh(["cuda:0"] * 4)`` four shards on
one card.  ``multihost.global_mesh()`` builds the mesh of a
``torch.distributed`` job, one shard per rank.

The reference's ``row_sharding`` and ``replicated`` name JAX shardings
and have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..errors import ExecutionError

__all__ = ["DATA_AXIS", "DataMesh", "data_mesh", "mesh_width"]

DATA_AXIS = "data"


class DataMesh:
    """A 1-D mesh: ``devices[i]`` holds shard ``i``; ``comm`` moves data
    between shards (in-process copies unless a process-group comm is
    given).  ``size`` is the reference's ``mesh.devices.size``."""

    def __init__(self, devices: Sequence, comm=None):
        from .comm import LocalComm

        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ExecutionError("a mesh needs at least one device")
        self.comm = comm if comm is not None else LocalComm(self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def root(self) -> torch.device:
        """The device replicated results (merged groups, gathered rows)
        land on: the first device here, the rank's own in a job."""
        return self.comm.root

    @property
    def local_shards(self) -> range:
        """The shards this process holds, in mesh order."""
        return self.comm.local_shards

    @property
    def single_device(self) -> bool:
        """One shard in this process: queries run the single-device path
        (the reference's one-device fallback)."""
        return self.size == 1 and self.comm.kind == "local"

    @property
    def key(self) -> tuple:
        return (self.devices, self.comm.kind)

    def __eq__(self, other) -> bool:
        return isinstance(other, DataMesh) and other.key == self.key

    def __hash__(self) -> int:
        return hash(self.key)

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        return f"DataMesh([{devs}], {self.comm.kind})"


def data_mesh(n_devices: Optional[int] = None, devices=None) -> DataMesh:
    """A mesh over ``devices`` (default: every local CUDA device; without
    CUDA this raises rather than build a CPU mesh), cut to ``n_devices``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise ExecutionError(
                "data_mesh: CUDA is not available; pass devices=['cpu'] * n "
                "for a mesh of CPU shards"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    from ..api import resolve_device

    return DataMesh([resolve_device(d) for d in devices])


def mesh_width(table) -> Optional[int]:
    """The width of the mesh ``table`` is sharded over, None for a table
    on one device: every memo key carries it."""
    mesh = getattr(table, "mesh", None)
    return None if mesh is None else mesh.size
