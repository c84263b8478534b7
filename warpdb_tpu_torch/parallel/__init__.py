"""Execution beyond one in-memory table on one device: meshes and the
collective interface (``mesh.py``, ``comm.py``), sharded tables and the
sharded scan / top-k / GROUP BY (``sharded.py``), the all-to-all
GROUP BY (``shuffle.py``), the shuffle join (``dist_join.py``),
distributed windows (``window.py``), multi-process jobs over
``torch.distributed`` (``multihost.py``), the out-of-core stream
(``streaming.py``) and the n-shard dry run (``dryrun.py``)."""

from .dist_join import distributed_join
from .mesh import DATA_AXIS, DataMesh, data_mesh
from .sharded import (
    ShardedTable,
    run_expression_sharded,
    run_grouped_sharded,
    run_topk_sharded,
    shard_table,
)
from .shuffle import combine_shuffle_grouped, shuffle_grouped
from .streaming import last_stream_stats, run_streaming_csv, run_streaming_sql

__all__ = [
    "DATA_AXIS",
    "DataMesh",
    "data_mesh",
    "ShardedTable",
    "shard_table",
    "run_expression_sharded",
    "run_grouped_sharded",
    "run_topk_sharded",
    "shuffle_grouped",
    "combine_shuffle_grouped",
    "distributed_join",
    "last_stream_stats",
    "run_streaming_csv",
    "run_streaming_sql",
]
