"""Distributed GROUP BY by hash-partitioned all-to-all exchange.

Counterpart of ``warpdb_tpu/parallel/shuffle.py``.  Where the key space
is too large for the all_gather merge (``sharded.run_grouped_sharded``),
rows or partials move so that every occurrence of a key tuple lands on
one shard (``hash_dest``), each shard aggregates the keys it owns, and
the disjoint per-shard tables gather to the root in key order:

* ``combine_shuffle_grouped`` (tried first): each shard pre-aggregates
  (map-side combine) and ships its partial rows, at most one per key and
  shard, so no skew can swell an exchange; it declines (None) when some
  shard holds more than ``local_cap`` distinct key tuples;
* ``shuffle_grouped``: the row shuffle, for very high cardinality.

Sizes are exact (``comm.all_to_all`` sends the counts first), so the
reference's send buckets, overflow flags and doubling retries are gone.
The reference's ``shuffle_overlap`` variant (two half exchanges, the
first aggregated while the second is in flight) is not ported: an
exchange here is one blocking call, with no copy to overlap.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.sort import sort_key_any
from ..utils.metrics import note_operator
from .mesh import DataMesh
from .sharded import (
    GroupPartials,
    _ensure_sharded,
    _mesh_of,
    bucketize,
    gather_merge,
    key_eval_fns,
    local_partials,
    merge_partials,
    rows_partials,
    slot_plan,
)

__all__ = ["hash_dest", "combine_shuffle_grouped", "shuffle_grouped",
           "COMBINE_CAP"]

# The map-side combine's capacity: distinct key tuples a shard may hold
# before the row shuffle takes over (the reference's ``local_cap``).  At
# 2^25 rows on four NCCL ranks, one shard a card, the row shuffle wins
# on neither key mix at once through 2^23 key tuples, sparse composite
# keys included (dense keys at 2^23: 130.03 / 49.31 ms against the
# combine's 124.53 / 24.29, uniform / Zipf, engine wall, NVIDIA H100
# 80GB HBM3, 700.00 W, ``chip_smoke.py --tiers --cards``; four shards
# of one card the same).
COMBINE_CAP = 1 << 23
_M32 = 0xFFFFFFFF
# Knuth's multiplicative constant, in 16-bit halves so that every
# product stays inside int64.
_HASH_MULT = 2654435761
_MULT_LO = _HASH_MULT & 0xFFFF


def _mul32(a: torch.Tensor) -> torch.Tensor:
    """``a * _HASH_MULT mod 2^32`` for ``a`` in [0, 2^32), in int64:
    ``a = hi·2^16 + lo`` gives ``lo·M + (hi·M_lo)·2^16`` modulo 2^32."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * _HASH_MULT + ((hi * _MULT_LO) << 16)) & _M32


def hash_dest(key_tuple, n_dev: int) -> torch.Tensor:
    """Destination shard of each row from its key TUPLE, bit for bit the
    reference's (``shuffle.py:72-82``): per-column Knuth multiplicative
    hashes of the order-preserving key bits (``sort_key_any``: -0.0 and
    0.0 share one, as every NaN does), folded with a rotate-xor, in
    uint32 arithmetic carried in int64."""
    h = torch.zeros(key_tuple[0].shape, dtype=torch.int64,
                    device=key_tuple[0].device)
    for k in key_tuple:
        kb = _mul32(sort_key_any(k))
        h = (((h << 5) & _M32) ^ (h >> 27)) ^ kb
    return (h >> 16) % n_dev


def _exchange_partials(mesh: DataMesh, parts: list, nk: int,
                       nv: int) -> list:
    """Send each partial row to the shard its key tuple hashes to and
    merge what each shard receives: disjoint per-shard group tables."""
    n = mesh.size
    send = [bucketize(p.flat(), hash_dest(p.keys, n), n) for p in parts]
    recv = mesh.comm.all_to_all(send)
    return [merge_partials(GroupPartials.concat(
        [GroupPartials.unflat(r, nk, nv) for r in row])) for row in recv]


def combine_shuffle_grouped(key_exprs, value_exprs, cond, table,
                            mesh: Optional[DataMesh] = None,
                            local_cap: Optional[int] = None,
                            need=("sum", "min", "max")
                            ) -> Optional[GroupPartials]:
    """Skew-proof distributed GROUP BY: map-side combine, an all_to_all
    of partial rows, a merge per shard, then the disjoint tables gathered
    to the root in key order.  None when any shard holds more than
    ``local_cap`` (default ``COMBINE_CAP``) distinct key tuples (the
    caller falls back to :func:`shuffle_grouped`); every rank decides
    alike."""
    key_exprs = list(key_exprs) if isinstance(key_exprs, (list, tuple)) \
        else [key_exprs]
    mesh = _mesh_of(table, mesh)
    table = _ensure_sharded(table, mesh)
    nk, nv = len(key_exprs), len(value_exprs)
    tier = slot_plan(table, key_exprs, need)
    parts = [local_partials(s, key_exprs, value_exprs, cond, need, tier)
             for s in table.shards]
    sizes = mesh.comm.gather_ints([p.num_groups for p in parts])
    if max(sizes) > (COMBINE_CAP if local_cap is None else local_cap):
        return None
    note_operator("combine_shuffle_group", True)
    owned = _exchange_partials(mesh, parts, nk, nv)
    return gather_merge(mesh, owned, nk, nv)


def shuffle_grouped(key_exprs, value_exprs, cond, table,
                    mesh: Optional[DataMesh] = None,
                    need=("sum", "min", "max")) -> GroupPartials:
    """Distributed GROUP BY with a row shuffle: each shard sends its
    valid rows (keys and values) to the shard their key tuple hashes to,
    every shard aggregates the rows it owns, and the disjoint tables
    gather to the root in key order."""
    from ..engine.compiler import _as_f32, broadcast, build_evaluator
    from ..engine.group_exec import _row_mask

    key_exprs = list(key_exprs) if isinstance(key_exprs, (list, tuple)) \
        else [key_exprs]
    mesh = _mesh_of(table, mesh)
    table = _ensure_sharded(table, mesh)
    n, nk, nv = mesh.size, len(key_exprs), len(value_exprs)
    note_operator("shuffle_group", True)
    tier = slot_plan(table, key_exprs, need)
    send = []
    for s in table.shards:
        cols = s.row_columns()
        valid = _row_mask(cond, s, cols)
        keys = tuple(broadcast(f(cols), s.num_rows)[valid]
                     for f in key_eval_fns(key_exprs, s))
        vals = tuple(broadcast(_as_f32(build_evaluator(v)(cols)),
                               s.num_rows)[valid] for v in value_exprs)
        send.append(bucketize(keys + vals, hash_dest(keys, n), n))
    owned = []
    for row in mesh.comm.all_to_all(send):
        cols = tuple(torch.cat(c) for c in zip(*row))
        owned.append(rows_partials(cols[:nk], cols[nk:], None, need, tier))
    return gather_merge(mesh, owned, nk, nv)
