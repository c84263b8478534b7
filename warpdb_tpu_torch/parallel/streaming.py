"""Out-of-core streaming execution on one device or a mesh.

Counterpart of ``warpdb_tpu/parallel/streaming.py``: a file streams in
chunks of ``rows_per_chunk`` rows (``storage/chunks.py``); each chunk is
uploaded from page-locked buffers and runs through the ordinary engine
on the device, and the host merges what the chunks return.

* ``run_streaming_csv``: ``expr [WHERE cond]`` per chunk, concatenated
  in row order.  Up to two chunks are in flight: chunk k's result copies
  into page-locked memory behind a CUDA event while chunk k+1 parses and
  uploads (the native CSV stream also parses ahead on a worker thread).
* ``run_streaming_sql``: grouped and global aggregates (chunk partials
  merged on the host: sums in float64, rounded to f32 once), DISTINCT,
  COUNT(DISTINCT) (distinct pair sets), APPROX_COUNT_DISTINCT (u8 HLL
  registers merged by max), per-row SELECT with WHERE / LIMIT (early
  stop) / ORDER BY … LIMIT (a running top-k), INNER / LEFT / CROSS
  joins against in-memory ``dims``, and partition-aggregate windows in
  two passes.

String columns, and int64 columns whose values leave the int32 range in
any chunk, encode against one sorted vocabulary built by a host pre-pass
over the stream (``_stream_grouped``), so that group keys from different chunks compare.  (The
reference builds it for strings only and merges the per-chunk codes of
wide int64 keys from different vocabularies.)  With a ``mesh`` each
chunk (and each dimension table) is sharded over it, with the stream's
vocabularies, and runs through the distributed operators.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..errors import (
    ParseError,
    TokenizeError,
    UnsupportedError,
    WarpDBError,
)
from ..frontend import (
    parse_expression,
    parse_query,
    tokenize,
    validate_expression,
    validate_query,
)
from ..frontend.ast import (
    Aggregation,
    AggregationType,
    Alias,
    Constant,
    GroupBy,
    OrderBy,
    Variable,
    WindowFunction,
    transform,
    unalias,
    walk,
)
from ..storage.chunks import iter_table_chunks, table_column_names
from ..storage.table import DeviceTable, HostTable

__all__ = ["run_streaming_csv", "run_streaming_sql", "last_stream_stats"]

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


@dataclass
class StreamStats:
    """What the last top-level stream did: chunks and rows of its main
    passes, chunks of the vocabulary pre-pass, host seconds waiting on
    the parser and merging, and the card's time over the chunks' device
    work (CUDA events from before each upload, its host encoding
    included, to after its result; None on the CPU)."""

    chunks: int = 0
    rows: int = 0
    prepass_chunks: int = 0
    parse_s: float = 0.0
    merge_s: float = 0.0
    device_ms: Optional[float] = None
    _events: list = None


_LAST = StreamStats()


def last_stream_stats() -> StreamStats:
    """The counters of the last ``run_streaming_*`` call."""
    return _LAST


def _begin_stats() -> StreamStats:
    global _LAST
    _LAST = StreamStats(_events=[])
    return _LAST


def _end_stats(stats: StreamStats) -> None:
    if stats._events:
        torch.cuda.synchronize()
        stats.device_ms = sum(a.elapsed_time(b) for a, b in stats._events)
    stats._events = None


class _DeviceSpan:
    """Records a pair of CUDA events around the chunk's device work."""

    def __init__(self, stats: StreamStats, device: torch.device):
        self.stats = stats
        self.on = _root(device).type == "cuda" and stats._events is not None

    def __enter__(self):
        if self.on:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        return self

    def __exit__(self, *exc):
        if self.on and exc[0] is None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.stats._events.append((self.start, end))


def _chunks(path, rows_per_chunk, schema, prepass: bool = False):
    """``iter_table_chunks`` counting the chunks and the host time spent
    waiting for each; an early stop closes the file."""
    stats = _LAST
    it = iter_table_chunks(path, rows_per_chunk, schema)
    try:
        while True:
            t0 = time.perf_counter()
            try:
                chunk = next(it)
            except StopIteration:
                return
            stats.parse_s += time.perf_counter() - t0
            if prepass:
                stats.prepass_chunks += 1
            else:
                stats.chunks += 1
                stats.rows += chunk.num_rows
            yield chunk
    finally:
        it.close()


def _placement(mesh, device):
    """Where the stream's chunks go: ``mesh`` (a DataMesh wider than one
    local device), else one device (a one-device mesh's, or ``device``,
    None meaning the card)."""
    from ..api import resolve_device

    if mesh is None:
        return resolve_device(device)
    return resolve_device(mesh.devices[0]) if mesh.single_device else mesh


def _root(place) -> torch.device:
    """The device a placement's results land on."""
    return place if isinstance(place, torch.device) else place.root


def _rows_per_chunk(rows_per_chunk: Optional[int]) -> int:
    if rows_per_chunk is None:
        from ..config import get_config

        return get_config().rows_per_chunk
    return rows_per_chunk


def _upload(chunk: HostTable, device, dicts=None):
    if not isinstance(device, torch.device):
        from .sharded import shard_table

        return shard_table(chunk, device, dicts_override=dicts)
    return DeviceTable.from_host(chunk, device=device, keep_host=False,
                                 dicts_override=dicts)


def run_streaming_csv(
    csv_path: str,
    expr: str,
    rows_per_chunk: Optional[int] = None,
    mesh=None,
    schema=None,
    device=None,
) -> np.ndarray:
    """Stream ``csv_path`` in chunks, evaluating ``expr [WHERE cond]`` on
    every chunk on ``device`` (None: the card); results concatenate in
    row order (filtered-out rows 0.0)."""
    from ..api import _split_where
    from ..engine.executor import run_expression_device

    device = _placement(mesh, device)
    if not expr or not expr.strip():
        raise WarpDBError("Empty query expression")
    rows_per_chunk = _rows_per_chunk(rows_per_chunk)
    expr_part, where_part = _split_where(expr)
    try:
        expr_ast = parse_expression(tokenize(expr_part))
    except (ParseError, TokenizeError) as e:
        raise ParseError(f"Failed to parse expression: {e}") from None
    cond_ast = None
    if where_part is not None and where_part.strip():
        try:
            cond_ast = parse_expression(tokenize(where_part))
        except (ParseError, TokenizeError) as e:
            raise ParseError(f"Failed to parse WHERE clause: {e}") from None
    # Validate against the header / schema before reading any data.
    columns = set(table_column_names(csv_path))
    validate_expression(expr_ast, columns)
    if cond_ast is not None:
        validate_expression(cond_ast, columns)

    stats = _begin_stats()
    # At most two chunks in flight: a chunk's result is drained (its
    # event waited on) only once the next chunk has been dispatched.
    in_flight: list = []  # (host tensor, event or None)
    pieces: list = []

    def drain_one() -> None:
        host, event = in_flight.pop(0)
        if event is not None:
            event.synchronize()
        t0 = time.perf_counter()
        pieces.append(host.numpy().copy())  # frees the page-locked stage
        stats.merge_s += time.perf_counter() - t0

    for chunk in _chunks(csv_path, rows_per_chunk, schema):
        with _DeviceSpan(stats, device):
            dt = _upload(chunk, device)
            if dt.dicts:
                raise WarpDBError(
                    "Streaming expressions do not support string columns "
                    "(per-chunk dictionaries are not comparable across "
                    "chunks)"
                )
            out = run_expression_device(dt, expr_ast, cond_ast)
            event = None
            if _root(device).type == "cuda":
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host = out
        in_flight.append((host, event))
        if len(in_flight) >= 2:
            drain_one()
    while in_flight:
        drain_one()
    _end_stats(stats)
    if not pieces:
        return np.zeros(0, dtype=np.float32)
    return np.concatenate(pieces)


def _u32_keys(key_cols) -> np.ndarray:
    """Per-key arrays → a lexicographically orderable u32 matrix.  Float
    keys use ``float_sort_key`` semantics (-0.0 ≡ +0.0, all NaNs equal
    and last); integer keys (raw int32 columns and codes) their int32
    bits: the grouping the device uses, so the merge never splits or
    fuses a group."""
    rows = []
    for a in key_cols:
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            rows.append(a.astype(np.int32).view(np.uint32)
                        ^ np.uint32(0x80000000))
            continue
        a = np.asarray(a, np.float32)
        a = np.where(a == 0.0, np.float32(0.0), a)
        a = np.where(np.isnan(a), np.float32(np.nan), a)
        bits = a.view(np.uint32)
        rows.append(np.where(bits >= 0x80000000, ~bits, bits | 0x80000000))
    return np.stack(rows, axis=0) if rows else np.zeros((0, 0), np.uint32)


def _unique_columns(u: np.ndarray, **kw):
    """``np.unique(u, axis=1, **kw)`` of a u32 key matrix.  One or two
    rows pack into one uint64 a column (row 0 the high word: the same
    lexicographic order) for a 1-D unique, which is several times
    faster; the unique values come back packed."""
    if u.shape[0] > 2:
        return np.unique(u, axis=1, **kw)
    packed = np.zeros(u.shape[1], np.uint64)
    for row in u:
        packed = (packed << np.uint64(32)) | row.astype(np.uint64)
    return np.unique(packed, **kw)


def _stream_vocabularies(csv_path, rows_per_chunk, schema, wide) -> dict:
    """The stream's shared vocabularies: one sorted str vocabulary for
    every string column, and one sorted int64 vocabulary for each int64
    column named in ``wide`` or wide in the first chunk.  Reads the whole
    stream when it needs one, else its first chunk only."""
    str_names: list = []
    uniques: set = set()
    i64_parts: dict = {name: [] for name in wide}
    first = True
    for chunk in _chunks(csv_path, rows_per_chunk, schema, prepass=True):
        n = chunk.num_rows
        if first:
            i64_parts.update({name: [] for name in
                              _wide_names(chunk, i64_parts)})
            first = False
        for col in chunk.columns:
            if not col.dtype.is_numeric:
                if col.name not in str_names:
                    str_names.append(col.name)
                uniques.update("" if v is None else str(v)
                               for v in col.data[:n])
            elif col.name in i64_parts:
                i64_parts[col.name].append(np.unique(col.data[:n]))
        if not str_names and not i64_parts:
            break  # the first chunk fixes the schema: nothing to share
    out = {name: np.unique(np.concatenate(parts or [np.zeros(0, np.int64)]))
           for name, parts in sorted(i64_parts.items())}
    if str_names:
        vocab = np.asarray(sorted(uniques))
        out.update({name: vocab for name in str_names})
    return out


class _WideColumns(Exception):
    """A chunk holds int64 values beyond the int32 range in columns that
    have no shared vocabulary yet."""

    def __init__(self, names: set):
        super().__init__(sorted(names))
        self.names = names


def _wide_names(chunk: HostTable, vocabs: dict) -> set:
    """The chunk's int64 columns whose values leave the int32 range and
    that ``vocabs`` does not cover."""
    n = chunk.num_rows
    return {
        c.name for c in chunk.columns
        if n and c.dtype.is_numeric and c.data.dtype == np.int64
        and c.name not in vocabs
        and (c.data[:n].min() < _INT32_MIN or c.data[:n].max() > _INT32_MAX)
    }


def _dims_on(dims: dict, device) -> dict:
    if not isinstance(device, torch.device):
        from .sharded import shard_table

        return {name: shard_table(ht, device) for name, ht in dims.items()}
    return {name: DeviceTable.from_host(ht, device=device)
            for name, ht in dims.items()}


def run_streaming_sql(
    csv_path: str,
    sql: str,
    rows_per_chunk: Optional[int] = None,
    mesh=None,
    schema=None,
    dims: Optional[dict] = None,
    device=None,
) -> dict:
    """Out-of-core SQL over ``csv_path`` (any format ``iter_table_chunks``
    reads) on ``device`` (None: the card) or sharded over ``mesh``: each
    chunk aggregates on the
    device into a per-group partial table (keys, counts, sum/min/max per
    value expression), the host merges the partials and applies HAVING /
    ORDER BY / LIMIT to the merged table.  Per-row statements and
    partition-aggregate windows stream too (``_stream_perrow``,
    ``_stream_windowed``); MEDIAN, PERCENTILE, STRING_AGG, ordered or
    framed windows, ORDER BY without LIMIT, set operations and grouping
    sets are refused.

    ``dims`` maps table names to in-memory ``HostTable`` dimension
    tables, uploaded once: the streamed chunks JOIN against them (INNER,
    LEFT and CROSS; RIGHT and FULL need whole-stream state).

    Returns ``{column_name: list}`` like ``query_sql_table``."""
    device = _placement(mesh, device)
    stats = _begin_stats()
    out = _run_sql(parse_query(tokenize(sql)), csv_path,
                   _rows_per_chunk(rows_per_chunk), schema, dims or {},
                   device)
    _end_stats(stats)
    return out


def _run_sql(ast, csv_path, rows_per_chunk, schema, dims: dict, device,
             catalog_dev: Optional[dict] = None) -> dict:
    """:func:`run_streaming_sql` on a parsed statement; ``catalog_dev``:
    ``dims`` already on the device."""
    if getattr(ast, "set_ops", None):
        raise UnsupportedError(
            "Streaming SQL does not support UNION/EXCEPT/INTERSECT"
        )
    if ast.group_by is not None and ast.group_by.sets is not None:
        raise UnsupportedError(
            "Streaming SQL does not support GROUPING SETS / ROLLUP / "
            "CUBE — run one streaming query per grouping set"
        )
    for j in ast.joins:
        if (j.source or j.table) not in dims:
            raise UnsupportedError(
                "Streaming SQL joins require the build table in `dims` "
                f"(got JOIN {j.source or j.table})"
            )
        if getattr(j, "kind", "inner") in ("right", "full"):
            # Whether a dimension row is unmatched is a whole-stream
            # property; INNER and LEFT are chunk-local.
            raise UnsupportedError(
                "Streaming SQL supports INNER and LEFT joins only"
            )
    if _streaming_windows_eligible(ast, csv_path):
        return _stream_windowed(ast, csv_path, rows_per_chunk, schema, dims,
                                device)
    for item in [*ast.select_list, ast.having,
                 *(t.expr for t in (ast.order_by.terms
                                    if ast.order_by else ()))]:
        if item is None:
            continue
        for n in walk(item):
            if isinstance(n, WindowFunction):
                raise UnsupportedError(
                    "Streaming SQL supports only the partition-aggregate "
                    "window family (SUM/AVG/COUNT/MIN/MAX OVER "
                    "(PARTITION BY bare columns)) — ordered/framed "
                    "windows need global row order"
                )
            if isinstance(n, Aggregation) and n.agg in (
                AggregationType.MEDIAN, AggregationType.PERCENTILE,
                AggregationType.STRING_AGG,
            ):
                raise UnsupportedError(
                    f"Streaming SQL does not support {n.agg.name}"
                )

    columns = set(table_column_names(csv_path))
    if not ast.joins:
        catalog_dev = {}
    elif catalog_dev is None:
        catalog_dev = _dims_on(dims, device)
    for name, dt_dim in catalog_dev.items():
        for col in dt_dim.dtypes:
            columns.add(col)
            columns.add(f"{name}.{col}")
    validate_query(
        ast, columns,
        {ast.from_table, *catalog_dev.keys(), *(j.table for j in ast.joins)},
    )

    query = copy.copy(ast)
    if (
        query.group_by is None
        and not query.distinct
        and query.having is None
        and not any(
            isinstance(n, Aggregation)
            for item in [
                *query.select_list,
                *(t.expr for t in
                  (query.order_by.terms if query.order_by else ())),
            ]
            for n in walk(unalias(item))
        )
    ):
        return _stream_perrow(query, csv_path, rows_per_chunk, schema,
                              catalog_dev, device)
    if query.distinct:
        # SELECT DISTINCT e1, e2, … ≡ GROUP BY e1, e2, … selecting the
        # keys; the merge unions the chunks' distinct tuples exactly.
        sels = [unalias(s) for s in query.select_list]
        if any(isinstance(n, Aggregation) for s in sels for n in walk(s)):
            raise UnsupportedError(
                "Streaming SQL does not support DISTINCT over aggregates"
            )
        keys, seen = [], set()
        for s in sels:
            c = s.canonical()
            if c not in seen:
                seen.add(c)
                keys.append(s)
        query.distinct = False
        query.group_by = GroupBy(tuple(keys))
    if query.group_by is None:
        # Global aggregates: one synthetic constant group.
        if not all(isinstance(unalias(s), Aggregation)
                   for s in query.select_list):
            raise UnsupportedError(
                "Streaming SQL supports aggregation queries only "
                "(per-row results need the expression streaming path)"
            )
        query.group_by = GroupBy((Constant("1"),))
    return _stream_grouped(ast, query, csv_path, rows_per_chunk, schema,
                           catalog_dev, device)


def _stream_grouped(ast, query, csv_path, rows_per_chunk, schema,
                    catalog_dev, device) -> dict:
    """The grouped stream: chunk partials merged per key tuple on the
    host (``np.unique`` over the u32 key matrix), then the host finish
    of the in-memory path over the merged table.

    Wide int64 keys need one vocabulary for the whole stream, which only
    a pre-pass over all of it can build.  The pre-pass builds one for
    each int64 column that is wide in the first chunk; a later chunk
    with int64 values beyond the int32 range in another column ends the
    pass, and the stream runs again behind a pre-pass that builds the
    vocabulary of every such column seen so far.  A stream whose int64
    columns stay narrow (and has no string column) is read once, after
    the first chunk that fixes its schema."""
    stats = _LAST
    wide: set = set()
    while True:
        chunks, rows = stats.chunks, stats.rows
        global_dicts = _stream_vocabularies(csv_path, rows_per_chunk,
                                            schema, wide)
        try:
            return _stream_grouped_pass(ast, query, csv_path, rows_per_chunk,
                                        schema, catalog_dev, device,
                                        global_dicts)
        except _WideColumns as e:
            wide |= e.names
            # The chunks of the abandoned pass count as a pre-pass.
            stats.prepass_chunks += stats.chunks - chunks
            stats.chunks, stats.rows = chunks, rows


def _stream_grouped_pass(ast, query, csv_path, rows_per_chunk, schema,
                         catalog_dev, device, global_dicts: dict) -> dict:
    """One pass of :func:`_stream_grouped` with the stream's shared
    vocabularies ``global_dicts``."""
    from ..engine.executor import _bind_query_strings, result_column_name
    from ..engine.group_exec import (
        _finish_grouped,
        _grouped_partials,
        _grouped_plan,
        _HostGroupResult,
    )
    from ..engine.join_exec import _materialize_joins
    from ..ops.hll import HLL_M, hll_estimate_np
    from ..storage.strings import decode_codes

    stats = _LAST
    bind_dicts: dict = {}
    for name, dt_dim in catalog_dev.items():
        for col, vocab_d in dt_dim.dicts.items():
            bind_dicts[f"{name}.{col}"] = vocab_d
            bind_dicts.setdefault(col, vocab_d)
    bind_dicts.update(global_dicts)
    if bind_dicts:
        query = _bind_query_strings(query, SimpleNamespace(dicts=bind_dicts))

    q_join = None
    if query.joins:
        q_join = query
        query = copy.copy(query)
        query.joins = []

    select_items = [unalias(s) for s in query.select_list]
    plan = _grouped_plan(query, select_items)
    nv = len(plan["vexpr_nodes"])

    # COUNT(DISTINCT e): each chunk's distinct (keys…, e) tuples (the
    # group keys of GROUP BY keys…, e) union across chunks; the count per
    # group is a bincount at the end.  APPROX_COUNT_DISTINCT: the chunk
    # partials carry u8 HLL registers, merged by elementwise max.
    cd_runs, hll_specs = [], []
    for spec in plan["cd_specs"]:
        if spec.agg is AggregationType.APPROX_COUNT_DISTINCT:
            hll_specs.append(spec)
            continue
        q_cd = copy.copy(query)
        q_cd.group_by = GroupBy((*query.group_by.keys, spec.expr))
        items_cd = [Aggregation(AggregationType.COUNT, Constant("1"))]
        cd_runs.append((spec, q_cd, _grouped_plan(q_cd, items_cd)))

    nk = len(plan["keys_canon"])
    # Keys accumulate as per-key arrays so that integer keys keep their
    # dtype (exact beyond 2^24).
    acc_keys = None
    acc_counts = np.zeros(0, np.int64)
    acc_sums = [np.zeros(0, np.float64) for _ in range(nv)]
    acc_mins = [np.zeros(0, np.float32) for _ in range(nv)]
    acc_maxs = [np.zeros(0, np.float32) for _ in range(nv)]
    acc_cd = {spec.key: None for spec, _q, _p in cd_runs}
    acc_hll = {spec.key: np.zeros((0, HLL_M), np.uint8)
               for spec in hll_specs}

    for chunk in _chunks(csv_path, rows_per_chunk, schema):
        new_wide = _wide_names(chunk, global_dicts)
        if new_wide:
            raise _WideColumns(new_wide)
        with _DeviceSpan(stats, device):
            dt = _upload(chunk, device, global_dicts or None)
            if q_join is not None:
                dt = _materialize_joins(q_join, dt, catalog_dev)
            part = _grouped_partials(query, dt, plan, final=False)
            cd_parts = [_grouped_partials(q_cd, dt, plan_cd, final=False)
                        for _spec, q_cd, plan_cd in cd_runs]
        t0 = time.perf_counter()
        ng = int(part.num_groups)
        ck = [np.asarray(k)[:ng] for k in part.keys]
        keys_all = ck if acc_keys is None else [
            np.concatenate([a, c]) for a, c in zip(acc_keys, ck)
        ]
        counts_all = np.concatenate(
            [acc_counts, np.asarray(part.counts)[:ng].astype(np.int64)]
        )
        # Keyless (global) aggregates merge as one group: an empty-row
        # u32 matrix must still carry the column count.
        u = (_u32_keys(keys_all) if nk
             else np.zeros((0, counts_all.shape[0]), np.uint32))
        _, idx, inv = _unique_columns(u, return_index=True,
                                      return_inverse=True)
        inv = inv.reshape(-1)
        m = idx.shape[0]
        new_counts = np.zeros(m, np.int64)
        np.add.at(new_counts, inv, counts_all)
        new_keys = [k[idx] for k in keys_all]
        for i in range(nv):
            sums, mins, maxs = part.values[i]
            s_all = np.concatenate(
                [acc_sums[i], np.asarray(sums)[:ng].astype(np.float64)])
            acc = np.zeros(m, np.float64)
            np.add.at(acc, inv, s_all)
            acc_sums[i] = acc
            mn = np.full(m, np.inf, np.float32)
            np.minimum.at(mn, inv, np.concatenate(
                [acc_mins[i], np.asarray(mins)[:ng]]))
            acc_mins[i] = mn
            mx = np.full(m, -np.inf, np.float32)
            np.maximum.at(mx, inv, np.concatenate(
                [acc_maxs[i], np.asarray(maxs)[:ng]]))
            acc_maxs[i] = mx
        for spec in hll_specs:
            # The [acc, chunk] order of counts_all, so ``inv`` aligns the
            # register rows too.
            regs_all = np.concatenate(
                [acc_hll[spec.key], np.asarray(part.dcounts[spec.key])[:ng]])
            merged = np.zeros((m, HLL_M), np.uint8)
            np.maximum.at(merged, inv, regs_all)
            acc_hll[spec.key] = merged
        acc_keys, acc_counts = new_keys, new_counts

        for (spec, _q, _p), part_cd in zip(cd_runs, cd_parts):
            ng_cd = int(part_cd.num_groups)
            pairs = [np.asarray(k)[:ng_cd] for k in part_cd.keys]
            prev = acc_cd[spec.key]
            both = pairs if prev is None else [
                np.concatenate([a, c]) for a, c in zip(prev, pairs)
            ]
            _, pidx = _unique_columns(_u32_keys(both), return_index=True)
            acc_cd[spec.key] = [b[pidx] for b in both]
        stats.merge_s += time.perf_counter() - t0

    t0 = time.perf_counter()
    ngroups = acc_counts.shape[0]
    if acc_keys is None:
        acc_keys = [np.zeros(0, np.float32) for _ in range(nk)]
    if ngroups == 0 and ast.group_by is None and not ast.distinct:
        # A global aggregate over no surviving row: one empty group
        # (COUNT 0, SUM 0, MIN inf, MAX -inf), as in memory.
        ngroups = 1
        acc_keys = [np.ones(1, np.float32) for _ in range(nk)]
        acc_counts = np.zeros(1, np.int64)
        acc_sums = [np.zeros(1, np.float64) for _ in range(nv)]
        acc_mins = [np.full(1, np.inf, np.float32) for _ in range(nv)]
        acc_maxs = [np.full(1, -np.inf, np.float32) for _ in range(nv)]
        acc_cd = {k: None for k in acc_cd}
        acc_hll = {k: np.zeros((1, HLL_M), np.uint8) for k in acc_hll}

    merged_vals = tuple(
        (acc_sums[i].astype(np.float32), acc_mins[i], acc_maxs[i])
        for i in range(nv)
    )
    result = _HostGroupResult(tuple(acc_keys[:nk]), acc_counts, merged_vals,
                              ngroups)
    for spec, _q, _p in cd_runs:
        pairs = acc_cd[spec.key]
        # Group id of each distinct pair: the same chunks and WHERE gave
        # both tables, so the group sets coincide and the u32 order is
        # the merged ascending key order.
        if pairs is not None and len(pairs[0]):
            _, ginv = _unique_columns(_u32_keys(pairs[:nk]),
                                      return_inverse=True)
            dc = np.bincount(ginv.reshape(-1),
                             minlength=ngroups).astype(np.float32)
        else:
            dc = np.zeros(ngroups, np.float32)
        result.dcounts[spec.key] = dc
    for spec in hll_specs:
        result.dcounts[spec.key] = hll_estimate_np(acc_hll[spec.key])
    outs = _finish_grouped(query, select_items, plan["specs"],
                           plan["spec_to_vidx"], result, plan["keys_canon"])

    table_out: dict = {}
    for i, (item, vals) in enumerate(zip(ast.select_list, outs)):
        if query.offset is not None:
            vals = vals[query.offset:]
        if query.limit is not None:
            vals = vals[:query.limit]
        node = unalias(item)
        vocab = None
        if isinstance(node, Variable):
            vocab = global_dicts.get(node.name,
                                     global_dicts.get(node.unqualified))
        if vocab is not None and np.all(np.isfinite(vals)):
            out_vals = decode_codes(vals, vocab)
        else:
            out_vals = vals.tolist()
        table_out[result_column_name(item, i, table_out)] = out_vals
    stats.merge_s += time.perf_counter() - t0
    return table_out


def _perrow_sort_key(vals: list, ascending: bool) -> np.ndarray:
    """One ORDER BY term's host-merge sort key: u32 ranks ascending.
    Floats through the ``float_sort_key`` bit transform (the device
    sorts' total order: -0.0 ≡ +0.0, NaN above +inf); integers (int64
    values, which f32 would round together) and strings (decoded; their
    lexicographic order is the code order) by a dense rank of their
    values."""
    arr = np.asarray(vals)
    if arr.dtype.kind in "OUS":
        _, inv = np.unique(arr.astype(str), return_inverse=True)
        u = inv.reshape(-1).astype(np.uint32)
    elif arr.dtype.kind in "iu":
        _, inv = np.unique(arr.astype(np.int64), return_inverse=True)
        u = inv.reshape(-1).astype(np.uint32)
    else:
        a = arr.astype(np.float32)
        a = np.where(a == 0.0, np.float32(0.0), a)
        a = np.where(np.isnan(a), np.float32(np.nan), a)
        bits = a.view(np.uint32)
        u = np.where(bits >= 0x80000000, ~bits, bits | 0x80000000)
    if not ascending:
        u = np.iinfo(np.uint32).max - u
    return u


def _stream_perrow(query, csv_path, rows_per_chunk, schema, catalog_dev,
                   device, augment=None) -> dict:
    """Out-of-core per-row SQL: ``SELECT exprs FROM t [JOIN dims…]
    [WHERE c] [ORDER BY o LIMIT k] [LIMIT n]``.  Each chunk runs through
    the ordinary engine and decodes its own string columns; then

    * without ORDER BY, chunks concatenate in stream order and a LIMIT
      stops the stream once enough rows survive;
    * with ORDER BY … LIMIT k, a running top-k: each chunk returns at
      most its best k rows (the order terms ride as hidden select items)
      and the host keeps the best k of the union by a stable lexsort.

    ORDER BY without LIMIT is refused: it would hold the whole stream.
    ``augment`` (the streamed windows' second pass) adds columns to each
    host chunk before its upload."""
    from ..api import decode_result_column
    from ..engine.executor import (
        expand_stars_query,
        resolve_order_aliases,
        result_column_name,
        run_query_table,
    )

    stats = _LAST
    query = resolve_order_aliases(query)
    order = query.order_by
    limit = query.limit
    offset = query.offset or 0
    if order is not None and limit is None:
        raise UnsupportedError(
            "Streaming SQL supports ORDER BY only together with LIMIT "
            "(a full out-of-core sort would materialise the stream)"
        )
    keep = None if limit is None else limit + offset
    terms = order.terms if order is not None else ()
    catalog = catalog_dev or None

    q_chunk = None
    n_vis = 0
    vis_items: list = []
    acc: list = []
    total = 0

    def best(acc, count):
        mats = [_perrow_sort_key(acc[n_vis + i], t.ascending)
                for i, t in enumerate(terms)]
        perm = np.lexsort(tuple(reversed(mats)))[:count]
        return [[a[j] for j in perm] for a in acc]

    for chunk in _chunks(csv_path, rows_per_chunk, schema):
        if augment is not None:
            chunk = augment(chunk)
        with _DeviceSpan(stats, device):
            dt = _upload(chunk, device)
            if q_chunk is None:
                # The first chunk fixes the schema: expand stars, then
                # append the order terms as hidden select items.
                q_chunk = copy.copy(query)
                vis_items = list(expand_stars_query(query, dt, catalog))
                n_vis = len(vis_items)
                q_chunk.select_list = [*vis_items, *(t.expr for t in terms)]
                q_chunk.offset = None
                q_chunk.limit = keep
                acc = [[] for _ in q_chunk.select_list]
            out = run_query_table(q_chunk, dt, catalog)
        t0 = time.perf_counter()
        # Decoded strings (unlike per-chunk codes) compare across chunks.
        cols = [decode_result_column(item, vals, dt, catalog, q_chunk.joins)
                for item, vals in zip(q_chunk.select_list, out.values())]
        got = len(cols[0]) if cols else 0
        for a, c in zip(acc, cols):
            a.extend(c)
        total += got
        stop = False
        if order is not None and keep is not None and total > keep:
            acc = best(acc, keep)
            total = keep
        elif order is None and keep is not None and total >= keep:
            stop = True  # LIMIT satisfied: stop reading the stream
        stats.merge_s += time.perf_counter() - t0
        if stop:
            break

    if q_chunk is None:
        # Empty stream: the output names come from the raw list.
        vis_items = list(query.select_list)
        acc = [[] for _ in vis_items]
    if order is not None and total > 0:
        acc = best(acc, total)

    table_out: dict = {}
    for i, item in enumerate(vis_items):
        vals = acc[i][offset:]
        if limit is not None:
            vals = vals[:limit]
        table_out[result_column_name(item, i, table_out)] = vals
    return table_out


def _streaming_windows_eligible(ast, csv_path) -> bool:
    """True when every window of the statement is a mergeable
    partition aggregate (SUM/AVG/COUNT/MIN/MAX, no ORDER BY or frame)
    over bare streamed columns, in an ungrouped per-row statement."""
    if ast.group_by is not None or ast.distinct or ast.having is not None:
        return False
    if getattr(ast, "qualify", None) is not None:
        return False
    items = [
        *ast.select_list,
        *(t.expr for t in (ast.order_by.terms if ast.order_by else ())),
    ]
    wins = [n for it in items for n in walk(unalias(it))
            if isinstance(n, WindowFunction)]
    if not wins:
        return False
    cols = set(table_column_names(csv_path))
    for w in wins:
        if (w.agg.value not in ("sum", "avg", "count", "min", "max")
                or w.order_by is not None or w.frame is not None):
            return False
        for pk in (w.partition_by or ()):
            e = unalias(pk)
            if not isinstance(e, Variable) or (
                e.name not in cols and e.unqualified not in cols
            ):
                return False
    # Plain aggregates cannot mix into a per-row stream.
    return not any(isinstance(n, Aggregation)
                   for it in items for n in walk(unalias(it)))


def _key_codes(col_m, col_c) -> tuple:
    """Joint integer codes of one key column over merged ∪ chunk values
    (exact for strings, int64 and floats; -0.0 ≡ +0.0 and NaNs one
    partition, the engine's key semantics)."""
    a = np.asarray(col_m)
    b = np.asarray(col_c)
    if a.dtype.kind in "OUS" or b.dtype.kind in "OUS":
        a = np.asarray([str(x) for x in a])
        b = np.asarray([str(x) for x in b])
        _, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
    elif a.dtype.kind in "iu" and b.dtype.kind in "iu":
        _, inv = np.unique(np.concatenate([a.astype(np.int64),
                                           b.astype(np.int64)]),
                           return_inverse=True)
    else:
        allv = np.concatenate([a.astype(np.float64), b.astype(np.float64)])
        _, inv = np.unique(allv + 0.0, return_inverse=True, equal_nan=True)
    return inv[: len(a)], inv[len(a):], int(inv.max(initial=0)) + 1


def _stream_windowed(ast, csv_path, rows_per_chunk, schema, dims,
                     device) -> dict:
    """Partition-aggregate windows out of core, in two passes (state
    O(partitions)):

    1. one streaming GROUP BY per distinct PARTITION BY signature gives
       the merged per-partition aggregates (AVG as SUM and COUNT);
    2. the per-row stream reads the file again; each host chunk gains its
       rows' partition aggregates as columns (a vectorised lookup on its
       key columns), and the statement, windows now column references,
       runs through ``_stream_perrow`` (WHERE, ORDER BY … LIMIT)."""
    wins: dict = {}
    nodes: list = []

    def repl(n):
        if isinstance(n, WindowFunction):
            c = n.canonical()
            if c not in wins:
                wins[c] = len(nodes)
                nodes.append(n)
            return Variable(f"__winS{wins[c]}")
        return n

    q2 = copy.copy(ast)
    q2.select_list = [transform(s, repl) for s in ast.select_list]
    if ast.order_by is not None:
        terms = [OrderBy(transform(t.expr, repl), t.ascending)
                 for t in ast.order_by.terms]
        head, *rest = terms
        q2.order_by = OrderBy(head.expr, head.ascending, tuple(rest))

    groups: dict = {}
    for j, w in enumerate(nodes):
        keys = tuple(unalias(p) for p in (w.partition_by or ()))
        sig = tuple(k.canonical() for k in keys)
        groups.setdefault(sig, {"keys": keys, "wins": []})
        groups[sig]["wins"].append(j)

    catalog_dev = _dims_on(dims, device) if ast.joins else {}
    merged: dict = {}
    for sig, g in groups.items():
        keys = g["keys"]
        sel: list = [Alias(k, f"__pk{i}") for i, k in enumerate(keys)]
        for j in g["wins"]:
            w = nodes[j]
            if w.agg.value == "avg":
                sel.append(Alias(Aggregation(AggregationType.SUM, w.expr),
                                 f"__ws{j}"))
                sel.append(Alias(Aggregation(AggregationType.COUNT,
                                             Constant("1")), f"__wc{j}"))
            elif w.agg.value == "count":
                # COUNT OVER counts the partition's rows, as in memory.
                sel.append(Alias(Aggregation(AggregationType.COUNT,
                                             Constant("1")), f"__wv{j}"))
            else:
                agg = {"sum": AggregationType.SUM,
                       "min": AggregationType.MIN,
                       "max": AggregationType.MAX}[w.agg.value]
                sel.append(Alias(Aggregation(agg, w.expr), f"__wv{j}"))
        q_agg = copy.copy(ast)
        q_agg.select_list = sel
        q_agg.order_by = None
        q_agg.limit = None
        q_agg.offset = None
        q_agg.group_by = GroupBy(tuple(keys) if keys else (Constant("1"),))
        out = _run_sql(q_agg, csv_path, rows_per_chunk, schema, dims,
                       device, catalog_dev)
        vals: dict = {}
        for j in g["wins"]:
            if nodes[j].agg.value == "avg":
                s = np.asarray(out[f"__ws{j}"], np.float64)
                c = np.asarray(out[f"__wc{j}"], np.float64)
                vals[j] = s / np.maximum(c, 1.0)
            else:
                vals[j] = np.asarray(out[f"__wv{j}"], np.float64)
        merged[sig] = {
            "key_names": [k.unqualified for k in keys],
            "keys": [np.asarray(out[f"__pk{i}"]) for i in range(len(keys))],
            "vals": vals,
        }

    def augment(chunk):
        data = {c.name: c.data for c in chunk.columns}
        n = chunk.num_rows
        for sig, g in groups.items():
            info = merged[sig]
            G = len(info["keys"][0]) if info["keys"] else 1
            comb_m = np.zeros(G, np.int64)
            comb_c = np.zeros(n, np.int64)
            for km, name in zip(info["keys"], info["key_names"]):
                cm, cc, base = _key_codes(km, data[name][:n])
                comb_m = comb_m * base + cm
                comb_c = comb_c * base + cc
            order = np.argsort(comb_m, kind="stable")
            sm = comb_m[order]
            pos = np.clip(np.searchsorted(sm, comb_c), 0, max(G - 1, 0))
            hit = sm[pos] == comb_c if G else np.zeros(n, bool)
            for j in g["wins"]:
                v = info["vals"][j]
                if len(v) == 0:
                    data[f"__winS{j}"] = np.full(n, np.nan, np.float32)
                else:
                    data[f"__winS{j}"] = np.where(
                        hit, v[order][pos], np.nan).astype(np.float32)
        return HostTable.from_dict(data)

    return _stream_perrow(q2, csv_path, rows_per_chunk, schema, catalog_dev,
                          device, augment=augment)
