"""Drive warpdb_tpu_torch once on a CUDA card, end to end.

    python3 chip_smoke.py [--profile | --kernels | --stream | --mesh |
                           --cards | --tiers [--cards] [--sweep=NAME,...]]

Phases, each raising on failure:

1. environment: the card's name and power limit, torch and CUDA versions;
   no CUDA device means exit code 2 and no result;
2. build: all five CUDA kernels (top-k K1, group histogram K2, the join's
   expansions K3 and K4 and its sorted gather K5) compile from
   ``warpdb_tpu_torch/csrc`` with nvcc for sm_90a, in parallel;
3. kernels: each kernel against its plain PyTorch version on the card:
   K1 at k = 16, 32, 64, 128 over random, ascending and duplicate values
   at 2^25 rows and at its edge shapes (n = 1000, under one wave, ragged,
   views 1 and 3 floats in); K2 at 4097..65536 slots with 0, 1, 4 and 5
   value columns, one hot slot, a Zipf mix and ±inf/NaN values (sums held
   to the plain version, which adds in float64, and to NumPy float64);
   K3-K5 bit for bit at the join's full sizes (K3
   and K4 also at their edge shapes).  Then each timed at the main path's
   shapes beside its plain version, the one PyTorch call computing the
   same function where there is one, and its bound (bytes over the card's
   memory rate), K1 and K2 also by ``torch.profiler`` device time (not
   with ``--profile``) and K1 also without the finish; and a table of K1
   and K2 at other inputs (each k, ascending and duplicate values, skewed
   ids, nv = 4).
   ``--kernels`` stops here, after printing each kernel instance's ptxas
   usage, ``--stream`` runs phase 10 alone after the build, and
   ``--mesh`` phase 11;
4. slice: ``WarpDB(..., device="cuda")`` over bench.py's table (2^25
   rows, seed 12345) runs bench.py's query set and four more queries,
   each checked against NumPy on the same arrays; the K1 and K2 launch
   counters must rise during this phase;
5. joins: the same table joins bench.py's ``rates`` and ``dup`` and a
   98K-row ``dimk`` (2^16 keys, each 0-3 times) through bench.py's join
   queries and five more, each checked against NumPy; the K3, K4 and K5
   launch counters must rise during this phase;
6. timing: median wall time of 5 warm runs per query (joins with every
   join memo off or dropped before the run);
7. windows: window functions, window expressions, QUALIFY and grouping
   sets over the same 2^25-row table through ``query_sql`` /
   ``query_sql_table``, each checked against NumPy (ranks, counts and row
   order exactly, sums within SUM_RTOL of float64) and timed (median of 5
   warm runs); the grouping set over ``k`` must launch K2;
8. TPC-H: the 22 queries of ``benchmarks/tpch.py`` (subqueries, CTEs,
   derived tables, multi-way joins) through ``query_sql_table`` at 2^22
   lineitem rows, each checked against the suite's NumPy oracle with its
   own gate; per query the K1-K5 launches, the device of every
   materialised table (it must be the card), the median of 5 warm runs
   with every memo dropped before each run, and the host round trip of
   its materialised tables; the phase must launch a kernel;
9. surfaces: APPROX_COUNT_DISTINCT over bench.py's table (32 groups,
   global, 65536 groups by the exact route) and per TPC-H supplier, each
   held to a NumPy HyperLogLog model (registers bit for bit) and to the
   exact distinct count; STRING_AGG per TPC-H customer against a Python
   model; the Arrow export at 2^25 rows in process and in shared memory,
   read back through the exporter's ctypes structs, and a struct array
   with a utf8 column; ``query`` / ``query_np`` / ``query_arrow`` timed;
   EXPLAIN ANALYZE naming K2 and K1; CREATE / query / DROP TABLE; the
   DB-API; 20 HTTP requests (two threads at once for half) and the CLI in
   a subprocess; the K1 and K2 counters must rise;
10. streaming: ``make`` builds the native CSV library from a copy of
   ``native/`` in the phase's temporary directory, so the checkout ends
   as it began (its prefetching stream parses the next chunk on a worker
   thread); K2 and K3 are held to their plain versions at the stream's
   chunk shapes (``GROUP BY k`` on one chunk, the chunk's INNER and LEFT
   expansions against ``dimk``); a CSV
   of bench.py's columns at 2^25 rows (``price`` in whole cents so that
   its text parses back bit for bit, written by digit arithmetic into a
   temporary directory removed at the end) streams in the reference's
   default chunks of 10^6 rows through ``query_streaming_csv`` /
   ``query_streaming_sql``: an expression, grouped (dense and K2) and
   global aggregates, top-k, LIMIT with early stop, DISTINCT,
   COUNT(DISTINCT), APPROX_COUNT_DISTINCT, two joins against ``dimk``,
   a two-pass window, and 2^20-row side files with a string column, wide
   int64 keys and narrow int64 keys; each against NumPy, with its
   launches, chunks, median wall, parser wait, device time, host merge
   and peak device memory; K2 must launch once a chunk in ``s_group_k``,
   a join kernel in each join, the narrow int64 stream must be read once,
   and no peak may reach half the file's device bytes; then the columns
   of bench.py's 2^25-row table, one chunk and the TPC-H tables go to the
   card through ``from_host``'s page-locked stage and through a pageable
   copy, each timed;
11. mesh: bench.py's table re-laid by ``distribute`` over four shards of
   the one card (``data_mesh(devices=["cuda:0"] * 4)``, 2^23 rows each)
   with ``dimk`` registered: the sharded scan, GROUP BY quantity (the
   all_gather merge, K2 once a shard), GROUP BY k (the row shuffle's
   all_to_all, K2 on each shard's owned rows), ORDER BY …
   LIMIT (K1 once a shard), the INNER and LEFT ``dimk`` joins with
   GROUP BY (K3 in each), the dense partition window, a two-key GROUP
   BY (the map-side combine's all_to_all), the two GROUP BYs on their
   routes whatever the merge's threshold (``MESH_FORCED``, each run
   must show its route), APPROX_COUNT_DISTINCT (each shard's
   registers, merged by max), the shard routes of
   ``parallel/project.py`` (a global aggregate by its partials, a
   filtered projection, a filtered full
   sort, DISTINCT k with K2 once a shard, a grouped COUNT(DISTINCT) by
   unique pairs, MEDIAN by the gather of its compacted column; none
   takes ``mesh_gather``) and a 2^19-row CSV streamed over the mesh;
   each against NumPy and the
   single-device result (keys, counts and row order exactly, sums within
   1e-6 of float64), with its collectives and bytes, launches, the root
   card's peak memory beside the shard's and the result's bytes, and the
   median of 5 warm runs beside the single-device one (through the
   engine, without the facade's Python list; the stream through the
   facade).  K1 (the top-k), K2 (GROUP BY k, DISTINCT k) and K3 (both
   joins) are held to their plain versions on the inputs the path gave
   the first shard, recorded in one more run of each.  Then a
   ``torch.distributed`` NCCL group of one rank on
   cuda:0: ``make_global_table`` and two distributed GROUP BYs against
   NumPy, one by the all_gather merge and GROUP BY k by the row
   shuffle's all_to_all.
   ``--cards`` (on a machine with several cards, not in the default run)
   runs the same statements with one shard a card in this process, then
   an NCCL group of one process a card (``--rank``, this script once a
   rank), each rank holding its slice and checking every statement and
   its kernels on its own shard's inputs, and printing its own card's
   peak memory a statement;
12. tiers: every routing threshold of the planner (the GROUP BY slot
   tiers, the window's dense partition broadcast, the grouped device
   finish, the mesh GROUP BY's merge / combine / row shuffle, the join
   pushdown gate) forced once from each side (``set_config`` or the
   module constant) at one size on each side of its default, uniform
   keys at 2^25 rows, each result against NumPy, K2 against its plain
   version wherever it runs, and the default configuration's own tier
   at each size.  ``--tiers`` runs the full sweep instead, after the
   build and nothing else (``TIER_SWEEPS``: uniform and Zipf(1.3) keys,
   engine wall and device ms, median of 5 warm runs each, and per
   threshold the size from which the upper tier wins, the root card's
   peak memory a point, and TPC-H's 22 queries under both pushdown
   floors); ``--tiers --cards`` runs its mesh sweeps on an NCCL group
   of one process a card (``--tier-rank``), one shard a card;
   ``--sweep=NAME,...`` (spaces as ``-``) keeps the named sweeps alone;
13. with ``--profile`` only: one ``torch.profiler`` run per query (card
   busy time, idle share, largest device items; of the stream,
   ``s_group_k`` and ``s_join_dimk``) and each kernel's registers and
   spills from ``ptxas -v``.

The kernels' JSON record and the card's name and power limit come before
the last line, ``{"ok": true, "device": {...}}``.  Neither the script nor
the port imports JAX or ``warpdb_tpu``.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

ROWS = 1 << 25
SEED = 12345
GROUP_SLOTS = 32
KEY_SLOTS = 1 << 16

# bench.py's query set (EXPR_QUERIES, SQL_QUERIES) and the slice extras.
EXPR_QUERIES = [
    ("proj_revenue", "price * quantity"),
    ("filter_gt", "price WHERE price > 15"),
    ("filter_proj", "price * 0.9 WHERE price > 20"),
    ("proj_tax", "price * quantity * 1.08"),
    ("udf_discount", "discount(price, 0.9)"),
]
SQL_QUERIES = [
    ("group_sum",
     "SELECT SUM(price) FROM t GROUP BY quantity ORDER BY quantity ASC"),
    ("orderby_limit", "SELECT price FROM t ORDER BY price DESC LIMIT 5"),
    ("group_sum_k", "SELECT SUM(price) FROM t GROUP BY k"),
    ("having_count",
     "SELECT quantity, COUNT(*) FROM t GROUP BY quantity "
     "HAVING SUM(price) > 1000"),
    ("distinct", "SELECT DISTINCT quantity FROM t"),
    ("filter_sql", "SELECT price FROM t WHERE price > 99.5"),
]

# The join phase: bench.py's join queries (e2e_join, e2e_join_expand,
# e2e_join_filtered) and more, as (name, SQL, eager join aggregation).
# e2e_join's filter keeps 17 of the 32 rates, more than half, so the
# build side is not filtered first and the join is a lookup;
# e2e_join_semi's keeps 13, so the filtered build side leaves probe rows
# unmatched and the join compacts the probe (K5).
DIMK_KEYS = 1 << 16
JOIN_QUERIES = [
    ("e2e_join",
     "SELECT price FROM t JOIN rates ON quantity = rates.quantity "
     "WHERE rates.rate > 0.5 ORDER BY price DESC LIMIT 5", True),
    ("e2e_join_semi",
     "SELECT price FROM t JOIN rates ON quantity = rates.quantity "
     "WHERE rates.rate > 0.6 ORDER BY price DESC LIMIT 5", True),
    ("e2e_join_expand",
     "SELECT SUM(price * dup.bonus) FROM t JOIN dup ON quantity = "
     "dup.quantity GROUP BY quantity ORDER BY quantity ASC", False),
    ("e2e_join_expand_eager",
     "SELECT SUM(price * dup.bonus) FROM t JOIN dup ON quantity = "
     "dup.quantity GROUP BY quantity ORDER BY quantity ASC", True),
    ("e2e_join_filtered",
     "SELECT SUM(price * rate) FROM t JOIN rates ON quantity = "
     "rates.quantity WHERE price > 99 GROUP BY quantity ORDER BY quantity "
     "ASC LIMIT 5", True),
    ("join_dimk_sum",
     "SELECT SUM(price * dimk.w) FROM t JOIN dimk ON k = dimk.k "
     "GROUP BY quantity ORDER BY quantity ASC", False),
    ("join_left_sum",
     "SELECT SUM(price) FROM t LEFT JOIN dimk ON k = dimk.k "
     "GROUP BY quantity ORDER BY quantity ASC", True),
    ("join_left_count",
     "SELECT COUNT(dimk.w) FROM t LEFT JOIN dimk ON k = dimk.k", True),
]

# The window phase: (name, SQL, entry point), over bench.py's table.
WINDOW_QUERIES = [
    ("win_part_sum", "SELECT SUM(price) OVER (PARTITION BY quantity) FROM t "
     "WHERE price > 99", "sql"),
    ("win_part_avg_k", "SELECT AVG(price) OVER (PARTITION BY k) FROM t",
     "sql"),
    ("win_row_number", "SELECT ROW_NUMBER() OVER (PARTITION BY quantity "
     "ORDER BY price DESC) FROM t", "sql"),
    ("win_running_sum", "SELECT SUM(price) OVER (PARTITION BY quantity "
     "ORDER BY price ASC) FROM t", "sql"),
    ("win_rows_frame", "SELECT AVG(price) OVER (PARTITION BY quantity ORDER "
     "BY price ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING) FROM t", "sql"),
    ("win_range_count", "SELECT COUNT(price) OVER (PARTITION BY k ORDER BY "
     "price RANGE BETWEEN 0.5 PRECEDING AND 0.5 FOLLOWING) FROM t", "sql"),
    ("win_lag", "SELECT LAG(price, 1) OVER (PARTITION BY k ORDER BY price) "
     "FROM t", "sql"),
    ("win_expr_dev", "SELECT price - AVG(price) OVER (PARTITION BY quantity) "
     "AS dev FROM t WHERE price > 99 ORDER BY dev DESC LIMIT 10", "sql"),
    ("qualify_top3", "SELECT k, price FROM t QUALIFY ROW_NUMBER() OVER "
     "(PARTITION BY k ORDER BY price DESC) <= 3 ORDER BY k ASC, price DESC",
     "table"),
    ("sets_k_quantity", "SELECT quantity, k, SUM(price) FROM t GROUP BY "
     "GROUPING SETS ((k), (quantity), ())", "table"),
]
WINDOW_SUMS = {"win_part_sum", "win_part_avg_k", "win_running_sum",
               "win_rows_frame", "win_expr_dev", "sets_k_quantity"}

# What the join path memoises on a table instance (besides the join memo,
# which ``join_cache_entries = 0`` turns off).
JOIN_MEMOS = ("_prefilter_memo", "_count_memo", "_eja_memo")
# The derived and decorrelation tables memoised on a table instance (the
# CTE memo is the facade's ``_cte_memo``).
SUBQUERY_MEMOS = ("_subq_memo",)

# The TPC-H phase: the suite's own default scale (benchmarks/tpch.py).
TPCH_ROWS = 1 << 22
TPCH_SEED = 42
# The kernels the 22 queries reach at that scale: K3 in q13's LEFT join,
# K5 in the pushdown compactions and semicompact joins.  K1 serves only a
# one-column ORDER BY … LIMIT (q2 selects several columns, which sort in
# full, as the reference's ``_run_projection_multi`` does); K2 runs where
# a SUM/COUNT-only grouping takes a slot tier, and no join fans out
# uniformly (K4).
TPCH_KERNELS = ("windowed_expand", "sorted_take")

# f32 sums per group (2^20 rows per group for GROUP BY quantity, 512 for
# GROUP BY k, up to 2^21 joined rows per group in the join phase) add in
# a run-dependent order on the card; against a float64 sum the relative
# error stays below this bound.
SUM_RTOL = 1e-4

# The H100 SXM's device-memory rate (NVIDIA's data sheet); every kernel
# here is bound by bytes, none by operations.
HBM_TB_S = 3.35
SUMS = {"group_sum", "group_sum_k", "e2e_join_expand",
        "e2e_join_expand_eager", "e2e_join_filtered", "join_dimk_sum",
        "join_left_sum"}


# The streaming phase: bench.py's columns as a CSV of 2^25 rows, read in
# the reference's default chunks (warpdb_tpu/config.py:22-24), and two
# 2^20-row side files that take the Python parser (a string column, wide
# int64 keys, narrow int64 keys).  (name, kind, statement); kind "once" runs and is timed
# once (the pair-set merge, the two-pass window).
STREAM_CHUNK = 1_000_000
STREAM_SIDE_ROWS = 1 << 20
STREAM_STRINGS = 200
STREAM_QUERIES = [
    ("s_expr", "expr", "price * quantity WHERE price > 15"),
    ("s_group_q", "sql", "SELECT quantity, COUNT(*), SUM(price), MIN(price), "
     "MAX(price) FROM t GROUP BY quantity"),
    ("s_group_k", "sql", "SELECT k, SUM(price) FROM t GROUP BY k"),
    ("s_global", "sql", "SELECT COUNT(*), SUM(price), AVG(price) FROM t "
     "WHERE price > 50"),
    ("s_topk", "sql", "SELECT price FROM t ORDER BY price DESC LIMIT 5"),
    ("s_limit", "sql", "SELECT price, k FROM t WHERE price > 99.9 LIMIT 100"),
    ("s_distinct", "sql", "SELECT DISTINCT quantity FROM t"),
    ("s_count_distinct", "once", "SELECT quantity, COUNT(DISTINCT k) FROM t "
     "GROUP BY quantity"),
    ("s_hll", "sql", "SELECT quantity, APPROX_COUNT_DISTINCT(k) FROM t "
     "GROUP BY quantity"),
    ("s_join_dimk", "join", "SELECT quantity, SUM(price * dimk.w) FROM t "
     "JOIN dimk ON k = dimk.k GROUP BY quantity"),
    ("s_join_left", "join", "SELECT COUNT(dimk.w) FROM t LEFT JOIN dimk "
     "ON k = dimk.k"),
    ("s_window", "once", "SELECT price - AVG(price) OVER (PARTITION BY "
     "quantity) AS dev FROM t WHERE price > 99 ORDER BY dev DESC LIMIT 10"),
    ("s_strings", "strings", "SELECT c, SUM(price) FROM t GROUP BY c"),
    ("s_int64_wide", "wide", "SELECT k64, COUNT(*), SUM(price) FROM t "
     "GROUP BY k64"),
    ("s_int64_narrow", "narrow", "SELECT kn, COUNT(*), SUM(price) FROM t "
     "GROUP BY kn"),
]
# Columns held within SUM_RTOL of float64 (sums, averages, deviations
# from an average), by statement and position.
STREAM_SUMS = {"s_group_q": {2}, "s_group_k": {1}, "s_global": {1, 2},
               "s_join_dimk": {1}, "s_window": {0}, "s_strings": {1},
               "s_int64_wide": {2}, "s_int64_narrow": {2}}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def make_table() -> dict:
    rng = np.random.default_rng(SEED)
    return {
        "price": rng.uniform(0.0, 100.0, ROWS).astype(np.float32),
        "quantity": rng.integers(0, GROUP_SLOTS, ROWS).astype(np.float32),
        "k": rng.integers(0, KEY_SLOTS, ROWS).astype(np.float32),
    }


def expected(d: dict) -> dict:
    p, q, k = d["price"], d["quantity"], d["k"]
    f = np.float32
    qi, ki = q.astype(np.int64), k.astype(np.int64)
    sums_q = np.bincount(qi, weights=p.astype(np.float64),
                         minlength=GROUP_SLOTS)
    sums_k = np.bincount(ki, weights=p.astype(np.float64), minlength=KEY_SLOTS)
    occ_k = np.bincount(ki, minlength=KEY_SLOTS) > 0
    return {
        "proj_revenue": p * q,
        "filter_gt": np.where(p > f(15), p, f(0)),
        "filter_proj": np.where(p > f(20), p * f(0.9), f(0)),
        "proj_tax": p * q * f(1.08),
        "udf_discount": p * f(0.9),
        "group_sum": sums_q,
        "orderby_limit": np.sort(p)[::-1][:5],
        "group_sum_k": sums_k[occ_k],
        "having_count": np.flatnonzero(sums_q > 1000).astype(np.float32),
        "distinct": np.unique(q),
        "filter_sql": p[p > f(99.5)],
    }


def make_join_tables() -> dict:
    """bench.py's ``rates`` and ``dup`` (bench.py:342-363, same seed and
    order) and ``dimk``: 2^16 keys, each present 0-3 times, with a
    weight ``w``."""
    rng = np.random.default_rng(7)
    rates = {
        "quantity": np.arange(GROUP_SLOTS, dtype=np.float32),
        "rate": rng.uniform(0.0, 1.0, GROUP_SLOTS).astype(np.float32),
    }
    dup = {
        "quantity": np.tile(np.arange(GROUP_SLOTS, dtype=np.float32), 2),
        "bonus": rng.uniform(0.0, 1.0, 2 * GROUP_SLOTS).astype(np.float32),
    }
    g = np.random.default_rng(SEED + 1)
    reps = g.integers(0, 4, DIMK_KEYS)
    dimk = {
        "k": np.repeat(np.arange(DIMK_KEYS), reps).astype(np.float32),
        "w": g.uniform(0.0, 1.0, int(reps.sum())).astype(np.float32),
    }
    return {"rates": rates, "dup": dup, "dimk": dimk}


def expected_joins(d: dict, j: dict) -> dict:
    p, q, k = d["price"], d["quantity"], d["k"]
    qi, ki = q.astype(np.int64), k.astype(np.int64)
    p64 = p.astype(np.float64)
    rate = j["rates"]["rate"]
    bonus = np.bincount(j["dup"]["quantity"].astype(np.int64),
                        weights=j["dup"]["bonus"].astype(np.float64),
                        minlength=GROUP_SLOTS)
    dk = j["dimk"]["k"].astype(np.int64)
    cnt = np.bincount(dk, minlength=DIMK_KEYS)
    wsum = np.bincount(dk, weights=j["dimk"]["w"].astype(np.float64),
                       minlength=DIMK_KEYS)

    def top5(keep):
        return np.sort(p[keep[qi]])[::-1][:5]

    hot = p > np.float32(99)
    filt = np.bincount(qi[hot], weights=(p64 * rate[qi])[hot],
                       minlength=GROUP_SLOTS)
    present = np.bincount(qi[hot], minlength=GROUP_SLOTS) > 0
    expand = np.bincount(qi, weights=p64 * bonus[qi], minlength=GROUP_SLOTS)
    return {
        "e2e_join": top5(rate > np.float32(0.5)),
        "e2e_join_semi": top5(rate > np.float32(0.6)),
        "e2e_join_expand": expand,
        "e2e_join_expand_eager": expand,
        "e2e_join_filtered": filt[present][:5],
        "join_dimk_sum": np.bincount(qi, weights=p64 * wsum[ki],
                                     minlength=GROUP_SLOTS),
        "join_left_sum": np.bincount(qi, weights=p64 * np.maximum(cnt[ki], 1),
                                     minlength=GROUP_SLOTS),
        "join_left_count": np.float32([cnt[ki].sum()]),
    }


def _fsk(x: np.ndarray) -> np.ndarray:
    """The engine's f32 total-order key (``float_sort_key``) in NumPy."""
    x = np.where(x == 0, np.float32(0), x).astype(np.float32)
    x = np.where(np.isnan(x), np.float32(np.nan), x)
    b = x.view(np.uint32).astype(np.int64)
    return np.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)


def _run_starts(*cols) -> np.ndarray:
    """Run-start flags over sorted rows: row 0, and each row where any
    column differs from the row before."""
    first = np.zeros(cols[0].shape[0], bool)
    first[:1] = True
    for c in cols:
        first[1:] |= c[1:] != c[:-1]
    return first


def _segments(first: np.ndarray) -> tuple:
    """Each row's run start and end from the run-start flags."""
    n = first.shape[0]
    rows = np.arange(n)
    last = np.ones(n, bool)
    last[:-1] = first[1:]
    start = np.maximum.accumulate(np.where(first, rows, 0))
    end = np.minimum.accumulate(np.where(last, rows, n)[::-1])[::-1]
    return start, end


def _desc_row_number(part_s, val_s) -> np.ndarray:
    """ROW_NUMBER() OVER (PARTITION BY part ORDER BY val DESC), ties by
    row, for rows sorted stably by (part, val ascending): the rows after
    the row's tie run in its partition, then its place in the run."""
    pos = np.arange(part_s.shape[0])
    _ps, pe = _segments(_run_starts(part_s))
    rs, re_ = _segments(_run_starts(part_s, val_s))
    return (pe - re_) + (pos - rs) + 1


def expected_windows(d: dict) -> dict:
    """The window phase's answers in NumPy, from one stable sort by
    (quantity, price) and one by (k, price); sums in float64."""
    p, q, k = d["price"], d["quantity"], d["k"]
    n = p.shape[0]
    qi, ki = q.astype(np.int64), k.astype(np.int64)
    p64 = p.astype(np.float64)
    hot = p > np.float32(99)
    sum_hot = np.bincount(qi[hot], weights=p64[hot], minlength=GROUP_SLOTS)
    cnt_hot = np.bincount(qi[hot], minlength=GROUP_SLOTS)
    sums_k = np.bincount(ki, weights=p64, minlength=KEY_SLOTS)
    cnt_k = np.bincount(ki, minlength=KEY_SLOTS)
    sums_q = np.bincount(qi, weights=p64, minlength=GROUP_SLOTS)
    out = {"win_part_sum": sum_hot[qi[hot]],
           "win_part_avg_k": (sums_k / np.maximum(cnt_k, 1))[ki]}

    # Stable sorts by (partition, price): one int64 key each.
    oq = np.argsort((qi << 32) | _fsk(p), kind="stable")
    qs, ps = q[oq], p[oq]
    rn = np.empty(n)
    rn[oq] = _desc_row_number(qs, ps)
    out["win_row_number"] = rn
    run, frame = np.empty(n), np.empty(n)
    qfirst = _run_starts(qs)
    _qs0, qend = _segments(qfirst)
    for lo_row in np.flatnonzero(qfirst):
        idx = oq[lo_row:qend[lo_row] + 1]
        m = idx.shape[0]
        pre = np.concatenate([[0.0], np.cumsum(p64[idx])])
        i = np.arange(m)
        run[idx] = pre[1:]
        lo, hi = np.maximum(i - 3, 0), np.minimum(i + 3, m - 1)
        frame[idx] = (pre[hi + 1] - pre[lo]) / (hi - lo + 1)
    out["win_running_sum"], out["win_rows_frame"] = run, frame
    del run, frame, rn, qs, ps, oq

    keys = (ki << 32) | _fsk(p)
    ok = np.argsort(keys, kind="stable")
    keys = keys[ok]
    ks, ps = k[ok], p[ok]
    kstart, _kend = _segments(_run_starts(ks))
    seg = ki[ok] << 32
    lo = np.searchsorted(keys, seg | _fsk(ps - np.float32(0.5)), "left")
    hi = np.searchsorted(keys, seg | _fsk(ps + np.float32(0.5)), "right")
    cnt = np.empty(n)
    cnt[ok] = hi - lo
    out["win_range_count"] = cnt
    pos = np.arange(n)
    lag = np.empty(n, np.float32)
    lag[ok] = np.where(pos > kstart, ps[np.maximum(pos - 1, 0)], np.nan)
    out["win_lag"] = lag
    rn_k = _desc_row_number(ks, ps)
    top = np.sort(ok[rn_k <= 3])
    top = top[np.lexsort((-p[top], k[top]))]
    out["qualify_top3"] = {"k": k[top], "price": p[top]}
    del keys, seg, lo, hi, cnt, lag, rn_k, ok, ks, ps

    dev = p64[hot] - (sum_hot / np.maximum(cnt_hot, 1))[qi[hot]]
    out["win_expr_dev"] = np.sort(dev)[::-1][:10]
    occ = np.flatnonzero(cnt_k > 0)
    nan_k, nan_q = np.full(occ.shape[0], np.nan), np.full(GROUP_SLOTS, np.nan)
    out["sets_k_quantity"] = {
        "quantity": np.concatenate([nan_k, np.arange(GROUP_SLOTS), [np.nan]]),
        "k": np.concatenate([occ, nan_q, [np.nan]]),
        "SUM(price[idx])": np.concatenate([sums_k[occ], sums_q,
                                           [p64.sum()]]),
    }
    return out


def check_window(name: str, got, want) -> float:
    """One window query's answer against NumPy: exact, or within SUM_RTOL
    of float64 for sums (NaN equal to NaN); a table column by column.
    Returns the largest absolute error."""
    if isinstance(want, dict):
        if list(got) != list(want):
            raise AssertionError(f"{name}: columns {list(got)}")
        return max(check_window(f"{name}[{c}]", got[c], want[c])
                   for c in want)
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if name == "win_expr_dev":
        got = np.sort(got)[::-1]  # near-equal deviations may swap
    if name.split("[")[0] in WINDOW_SUMS and not name.endswith(
            ("[quantity]", "[k]")):
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, equal_nan=True,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)
    fin = np.isfinite(want)
    return float(np.max(np.abs(got[fin] - want[fin]))) if fin.any() else 0.0


def check(name: str, got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if name in SUMS:
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def turns_ms(kernel, *others) -> tuple:
    """The kernel's time and each other function's, in turns (others,
    kernel, kernel, others reversed): ``(kernel ms, [other ms, ...])``."""
    first = [cuda_ms(f) for f in others]
    k = (cuda_ms(kernel) + cuda_ms(kernel)) / 2
    last = [cuda_ms(f) for f in reversed(others)][::-1]
    return k, [(a + b) / 2 for a, b in zip(first, last)]


def bound_ms(nbytes: int) -> float:
    """The least time the card could move ``nbytes`` in: each input byte
    read once and each output byte written once, at HBM_TB_S."""
    return nbytes / (HBM_TB_S * 1e9)


def timing(kernel, plain, library, nbytes: int, shape: str) -> dict:
    """One kernel's timing record: the kernel, its plain version and the
    single PyTorch call for the same function (None where there is none),
    timed in turns, beside its bound."""
    others = (plain,) if library is None else (plain, library)
    k, o = turns_ms(kernel, *others)
    return {"ms": k, "plain_ms": o[0],
            "library_ms": o[1] if library is not None else None,
            "bound_ms": bound_ms(nbytes), "shape": shape}


def device_ms(fn, keys, reps: int = 20):
    """Mean device time per call of the kernels whose names hold one of
    ``keys``, from ``torch.profiler`` (None when the tracer returned no
    such kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and any(k in e.name for k in keys)]
    if not dev:
        return None
    return sum(e.time_range.end - e.time_range.start for e in dev) / 1e3 / reps


K1_NAMES = ("topk_kernel",)
K2_NAMES = ("group_hist_",)


def _check_topk(topk, x, k: int, what: str, err: dict) -> None:
    cand = topk.topk_candidates(x, k)
    want = topk.topk_candidates_plain(x, k).reshape(-1)
    got = torch.topk(cand.reshape(-1), k).values
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not torch.equal(cand[0, :k], want):
        raise AssertionError(f"K1 {what} k={k}: top-k differs from plain")
    fin = torch.isfinite(want)
    if bool(fin.any()):
        err["topk"] = max(err["topk"],
                          float((got[fin] - want[fin]).abs().max()))


def _topk_input(g, case: str, n: int) -> torch.Tensor:
    if case == "random":
        x = g.uniform(-100, 100, n).astype(np.float32)
    elif case == "ascending":
        x = np.sort(g.uniform(-100, 100, n).astype(np.float32))
    else:
        x = g.choice(np.float32([1.0, 2.0, 3.0, 99.5]), n)
    return torch.from_numpy(x).cuda()


def _group_ids(g, case: str, slots: int, n: int) -> np.ndarray:
    if case == "uniform":
        gid = g.integers(0, slots, n)
    elif case == "one_slot":
        gid = np.full(n, slots // 3)
    else:  # a Zipf-like mix over shuffled slot labels
        gid = g.permutation(slots)[(g.zipf(1.3, n) - 1) % slots]
    gid = gid.astype(np.int32)
    gid[::17] = slots          # invalid rows, as callers pass them
    gid[5::29] = -3            # stray negative ids
    return gid


def _check_group(group, gid, gd, vals, vd, slots, what, err, ref) -> str:
    """K2 on the card against its plain version (which adds in float64)
    and NumPy float64 sums (``ref[c]`` memoises column c's bincount).
    Returns the kernel's largest relative error against float64."""
    c, s = group.group_counts_sums(gd, vd, slots)
    cp, sp = group.group_counts_sums_plain(gd, vd, slots)
    torch.cuda.synchronize()
    if not torch.equal(c, cp):
        raise AssertionError(f"K2 {what}: counts differ")
    ok = (gid >= 0) & (gid < slots)
    rel = 0.0
    for i, (a, b) in enumerate(zip(s, sp)):
        torch.testing.assert_close(a, b, rtol=SUM_RTOL, atol=1e-2)
        err["group_hist"] = max(err["group_hist"],
                                float((a - b).abs().max()))
        if i not in ref:
            ref[i] = np.bincount(gid[ok], weights=vals[i][ok].astype(
                np.float64), minlength=slots)
        got = a.cpu().numpy()
        np.testing.assert_allclose(got, ref[i], rtol=SUM_RTOL, atol=1e-2)
        big = np.abs(ref[i]) > 1.0
        if big.any():
            rel = max(rel, float(np.max(np.abs(got[big] - ref[i][big])
                                        / np.abs(ref[i][big]))))
    return rel


def phase_kernels(topk, group, device_times: bool) -> tuple:
    """K1 and K2 against their plain versions on the card (the slice's
    shapes and the edge shapes), each timed at the slice's shapes, and
    timed at other inputs; with ``device_times`` also by the profiler."""
    from warpdb_tpu_torch.ops.sort import top_k_values

    g = np.random.default_rng(7)
    err = {"topk": 0.0, "group_hist": 0.0}
    ks = (16, 32, 64, 128)
    for n in (ROWS, ROWS - 37):
        for case in ("random", "ascending", "duplicates"):
            xd = _topk_input(g, case, n)
            for k in ks:
                _check_topk(topk, xd, k, f"{case} n={n}", err)
            log(f"K1 n={n} {case}: top-k multiset equal to plain, sorted "
                "row (k=16,32,64,128)")
    # Edge shapes: n = 1000, fewer values than one wave of threads, a
    # ragged 2^22 - 37, and views 1-3 floats in (not 16-byte aligned).
    wave = 132 * topk.THREADS * 4
    for case in ("random", "ascending", "duplicates"):
        base = _topk_input(g, case, (1 << 22) - 34)
        for what, xd in (("n=1000", base[:1000]),
                         (f"n={wave // 2} (under one wave)", base[:wave // 2]),
                         (f"n={(1 << 22) - 37}", base[:(1 << 22) - 37]),
                         ("offset 1 float", base[1:]),
                         ("offset 3 floats", base[3:])):
            for k in ks:
                _check_topk(topk, xd, k, f"{case} {what}", err)
        log(f"K1 {case} at n=1000, {wave // 2}, {(1 << 22) - 37} and "
            "offsets 1, 3: equal to plain (k=16,32,64,128)")
    # K2: 4097..65536 slots, nv 0/1/4/5 (5: two launches), the slice's
    # row count.
    pool = [g.uniform(0, 100, ROWS).astype(np.float32) for _ in range(5)]
    pool_d = [torch.from_numpy(v).cuda() for v in pool]
    for slots in (4097, 6000, 16385, 40000, KEY_SLOTS):
        gid = _group_ids(g, "uniform", slots, ROWS)
        gd = torch.from_numpy(gid).cuda()
        ref: dict = {}
        for nv in (0, 1, 4, 5):
            _check_group(group, gid, gd, pool[:nv], pool_d[:nv], slots,
                         f"slots={slots} nv={nv}", err, ref)
        log(f"K2 slots={slots} nv=0,1,4,5: counts exact, sums within rtol "
            f"{SUM_RTOL} of plain and float64")
    for slots in (4097, KEY_SLOTS):
        for case in ("one_slot", "zipf"):
            gid = _group_ids(g, case, slots, ROWS)
            rel = _check_group(group, gid, torch.from_numpy(gid).cuda(),
                               pool[:1], pool_d[:1], slots,
                               f"{case} slots={slots}", err, {})
            log(f"K2 {case} slots={slots} nv=1: counts exact, sums within "
                f"rtol {SUM_RTOL} of plain and float64 (kernel {rel!r} "
                "from float64)")
    # ±inf and NaN values go through K2 (the TPU path gated them off): a
    # non-finite value reaches only its own slot, as the reference's
    # scatter engine gives; slot 5 takes one warp's rows (the hot path).
    gid = torch.arange(8, dtype=torch.int32, device="cuda").repeat(2048)
    gid[256:384] = 5
    v = torch.ones(gid.shape[0], device="cuda")
    v[3], v[12], v[300] = float("inf"), float("-inf"), float("nan")
    c, (s,) = group.group_counts_sums(gid, [v], 4097)
    want = group.group_counts_sums_plain(gid, [v], 4097)[1][0]
    if not (torch.equal(s.isnan(), want.isnan())
            and torch.equal(s[~want.isnan()], want[~want.isnan()])):
        raise AssertionError(f"K2 ±inf/NaN: {s[:8].tolist()}")
    log("K2 ±inf/NaN values: only their own slots are non-finite")

    # The slice's shapes: ORDER BY price DESC LIMIT 5 over 2^25 uniform
    # prices (k = 16 after rounding up) and GROUP BY k (2^16 slots, one
    # value column).  "With the finish" is top_k_values (the kernel, then
    # the first k of its sorted row), against torch.topk.
    u = pool_d[0]
    ms = {"topk": timing(lambda: top_k_values(u, None, 16, False),
                         lambda: topk.topk_candidates_plain(u, 16),
                         lambda: torch.topk(u, 16), ROWS * 4 + 16 * 4,
                         f"n={ROWS} k=16, with the finish")}
    gid = torch.from_numpy(g.integers(0, KEY_SLOTS, ROWS).astype(np.int32)).cuda()
    ms["group_hist"] = timing(
        lambda: group.group_counts_sums(gid, [u], KEY_SLOTS),
        lambda: group.group_counts_sums_plain(gid, [u], KEY_SLOTS),
        None, ROWS * 8 + KEY_SLOTS * 8, f"n={ROWS} slots={KEY_SLOTS} nv=1")
    ms["topk"]["alone_ms"] = cuda_ms(lambda: topk.topk_candidates(u, 16))
    if device_times:
        ms["topk"]["profiler_ms"] = device_ms(
            lambda: top_k_values(u, None, 16, False), K1_NAMES)
        ms["group_hist"]["profiler_ms"] = device_ms(
            lambda: group.group_counts_sums(gid, [u], KEY_SLOTS), K2_NAMES)
    others = _other_inputs(topk, group, top_k_values, u, pool_d, g,
                           device_times)
    return err, ms, others


def _other_inputs(topk, group, top_k_values, u, pool_d, g,
                  device_times: bool) -> list:
    """K1 and K2 at other inputs than the slice's (2^25 rows): each k,
    ascending and duplicate values, skewed ids, four value columns.
    CUDA-event and profiler ms per call (None without ``device_times``)
    and the bound of the same work."""
    asc = torch.sort(u).values
    dup = torch.from_numpy(
        g.choice(np.float32([1.0, 2.0, 3.0, 99.5]), ROWS)).cuda()
    rows = []
    for k in (16, 32, 64, 128):
        rows.append((f"K1 random k={k}, kernel alone",
                     lambda k=k: topk.topk_candidates(u, k), K1_NAMES,
                     ROWS * 4 + k * 4))
    rows.append(("K1 random k=128, with the finish",
                 lambda: top_k_values(u, None, 128, False), K1_NAMES,
                 ROWS * 4 + 128 * 4))
    for k in (16, 128):
        rows.append((f"K1 ascending k={k}",
                     lambda k=k: topk.topk_candidates(asc, k), K1_NAMES,
                     ROWS * 4 + k * 4))
    rows.append(("K1 duplicates k=16", lambda: topk.topk_candidates(dup, 16),
                 K1_NAMES, ROWS * 4 + 64))
    for slots in (4097, KEY_SLOTS):
        ids = {case: torch.from_numpy(_group_ids(g, case, slots, ROWS)).cuda()
               for case in ("uniform", "one_slot", "zipf")}
        table = slots * 8
        for case in ("uniform", "one_slot", "zipf"):
            rows.append((f"K2 slots={slots} nv=1 {case} ids",
                         lambda d=ids[case], ns=slots: group.group_counts_sums(
                             d, [u], ns),
                         K2_NAMES, ROWS * 8 + table))
        rows.append((f"K2 slots={slots} nv=4 uniform ids",
                     lambda d=ids["uniform"], ns=slots: group.group_counts_sums(
                         d, pool_d[:4], ns),
                     K2_NAMES, ROWS * 20 + slots * 20))
    out = []
    for what, fn, keys, nbytes in rows:
        out.append((what, cuda_ms(fn),
                    device_ms(fn, keys) if device_times else None,
                    bound_ms(nbytes)))
    return out


def _special_words(g, n: int) -> list:
    """Three 4-byte columns: f32 with NaN payloads, ±inf and -0.0; a
    full-range int32; a uniform f32 (the join's price)."""
    f = g.normal(0, 1e10, n).astype(np.float32)
    bits = f.view(np.uint32)
    bits[1::97] = 0x7FC01234
    bits[3::89] = 0xFF800001
    f[5::83], f[7::79], f[9::73] = -np.inf, np.inf, -0.0
    i = g.integers(-2**31, 2**31 - 1, n, dtype=np.int32)
    i[0], i[1] = -2**31, 2**31 - 1
    u = g.uniform(0, 100, n).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (f, i, u)]


def _bit_err(got, want, what: str) -> float:
    """Max |difference| of the int32 words; raises unless 0."""
    err = 0.0
    for a, b in zip(got, want):
        wa, wb = a.view(torch.int32), b.view(torch.int32)
        if a.dtype != b.dtype or not torch.equal(wa, wb):
            raise AssertionError(f"{what}: differs from its plain version")
        err = max(err, float((wa.to(torch.int64) - wb.to(torch.int64))
                             .abs().max()) if wa.numel() else 0.0)
    return err


def phase_expand_kernels(expand) -> tuple:
    """K3, K4 and K5 against their plain versions, bit for bit, at the
    join's full sizes, and each timed beside its plain version."""
    g = np.random.default_rng(8)
    err = {"windowed_expand": 0.0, "uniform_expand": 0.0, "sorted_take": 0.0}
    ms = {}
    # K3: 2^25 probe rows, counts in {0..3}; the total is ragged.
    counts = g.integers(0, 4, ROWS)
    if counts.sum() % 2 == 0:
        counts[-1] = 3 - counts[-1] % 2
    offsets = torch.from_numpy(np.cumsum(counts) - counts).cuda()
    total = int(counts.sum())
    cols = _special_words(g, ROWS)
    # Edge shapes at the same scale: long runs of zero-count rows (a tile
    # whose owners span thousands of rows), one row owning every output,
    # a single probe row; owner on and off, C = 1, 3 and 16.
    zero_runs = np.zeros(ROWS, np.int64)
    zero_runs[::7919] = g.integers(1, 4, zero_runs[::7919].shape[0])
    one_owner = np.zeros(ROWS, np.int64)
    one_owner[ROWS // 3] = ROWS
    for case, cnt, ncols in (("ragged", counts, 3), ("ragged", counts, 16),
                             ("zero_runs", zero_runs, 1),
                             ("zero_runs", zero_runs, 16),
                             ("one_owner", one_owner, 1),
                             ("one_owner", one_owner, 16),
                             ("one_row", np.array([ROWS]), 1),
                             ("one_row", np.array([ROWS]), 16)):
        off = torch.from_numpy(np.cumsum(cnt) - cnt).cuda()
        tot = int(cnt.sum())
        src = [cols[c % 3][: cnt.shape[0]] for c in range(ncols)]
        for owner in (True, False):
            o, d, t = expand.windowed_expand(off, src, tot, owner=owner)
            po, pd, pt = expand.windowed_expand_plain(off, src, tot, owner)
            torch.cuda.synchronize()
            err["windowed_expand"] = max(
                err["windowed_expand"],
                _bit_err(t + (d,) + ((o,) if owner else ()),
                         pt + (pd,) + ((po,) if owner else ()), "K3 " + case),
            )
            del o, d, t, po, pd, pt
        log(f"K3 windowed_expand {case} n={cnt.shape[0]} total={tot} "
            f"C={ncols}: owner, dup and columns equal to plain bit for bit "
            "(owner on and off)")
    del off
    # Bytes: the offsets, the column words of rows that emit, and dup plus
    # three columns per output (owner is off in the timed call).
    ms["windowed_expand"] = timing(
        lambda: expand.windowed_expand(offsets, cols, total),
        lambda: expand.windowed_expand_plain(offsets, cols, total), None,
        ROWS * 8 + int((counts > 0).sum()) * 12 + total * 16,
        f"n={ROWS} total={total} C=3")
    del offsets
    # K4: 2^25 source rows, k = 1, 2, 3 and 7, ragged totals, and source
    # columns at an odd word offset (not 16-byte aligned).
    for shift in (0, 1):
        src = [c[shift:] for c in cols]
        for k in (1, 2, 3, 7):
            tot = (ROWS - shift) * k - 5
            got = expand.uniform_expand(src, k, tot)
            want = expand.uniform_expand_plain(src, k, tot)
            torch.cuda.synchronize()
            err["uniform_expand"] = max(err["uniform_expand"],
                                        _bit_err(got, want, f"K4 k={k}"))
            del got, want
            log(f"K4 uniform_expand n={ROWS - shift} k={k} total={tot} C=3 "
                f"source offset {shift} words: equal to plain bit for bit")
    ms["uniform_expand"] = timing(
        lambda: expand.uniform_expand(cols, 2, ROWS * 2),
        lambda: expand.uniform_expand_plain(cols, 2, ROWS * 2),
        lambda: [torch.repeat_interleave(c, 2) for c in cols],
        ROWS * 12 + ROWS * 2 * 12, f"n={ROWS} k=2 C=3")
    # K5: 2^25 nondecreasing indices into 2^25 - 37 rows, with and
    # without a validity mask (a ragged invalid tail).
    src = [c[: ROWS - 37] for c in cols]
    idx = torch.sort(torch.from_numpy(
        g.integers(0, ROWS - 37, ROWS)).cuda()).values
    valid = torch.ones(ROWS, dtype=torch.bool, device=idx.device)
    valid[-1000:] = False
    valid[::7] = False
    for v in (None, valid):
        got = expand.sorted_take(src, idx, v)
        want = expand.sorted_take_plain(src, idx, v)
        torch.cuda.synchronize()
        err["sorted_take"] = max(err["sorted_take"],
                                 _bit_err(got, want, "K5"))
        del got, want
    log(f"K5 sorted_take n_idx={ROWS} n_src={ROWS - 37} C=3, with and "
        "without a mask: equal to plain bit for bit")
    # Bytes: the indices, each distinct source word once, the outputs.
    ms["sorted_take"] = timing(
        lambda: expand.sorted_take(src, idx),
        lambda: expand.sorted_take_plain(src, idx),
        lambda: [torch.index_select(c, 0, idx) for c in src],
        ROWS * 8 + torch.unique_consecutive(idx).numel() * 12 + ROWS * 12,
        f"n_idx={ROWS} C=3")
    return err, ms


def phase_inf_group(WarpDB, HostTable, group) -> None:
    """The reference's ±inf GROUP BY case (tests/test_pallas_ops.py,
    test_midrange_inf_values_route_to_scatter_engine) through the query
    path: the TPU routes it to its scatter engine; here it rides K2."""
    rng = np.random.default_rng(5)
    n = 20_000
    k = rng.integers(0, 30_000, n).astype(np.float32)
    v = rng.uniform(0, 10, n).astype(np.float32)
    v[7] = np.inf
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}), device="cuda")
    before = group.group_counts_sums.launches
    out = np.asarray(db.query_sql("SELECT SUM(v) FROM t GROUP BY k"))
    if group.group_counts_sums.launches <= before:
        raise AssertionError("±inf GROUP BY did not run K2")
    uniq = np.unique(k)
    inf_slot = int(np.searchsorted(uniq, k[7]))
    want = np.bincount(np.searchsorted(uniq, k), weights=v.astype(np.float64))
    if out.shape != uniq.shape or out[inf_slot] != np.inf:
        raise AssertionError("±inf GROUP BY: wrong shape or inf slot")
    finite = np.delete(out, inf_slot)
    np.testing.assert_allclose(finite, np.delete(want, inf_slot), rtol=SUM_RTOL)
    log("K2 ±inf GROUP BY through the query path: the reference's answer")


def phase_windows(db, data: dict, kernels: dict, name: str) -> tuple:
    """The window queries over bench.py's table, each checked against
    NumPy, with the kernel launches they make (counters from 0), then the
    median of 5 warm runs each.  Returns ``(launches, run, queries)``."""
    t0 = time.perf_counter()
    want = expected_windows(data)
    log(f"windows: NumPy oracle {time.perf_counter() - t0!r} s")

    def run(kind, q):
        return db.query_sql_table(q) if kind == "table" else db.query_sql(q)

    queries = [(api, n, q) for n, q, api in WINDOW_QUERIES]
    for fn in kernels.values():
        fn.launches = 0
    for kind, n, q in queries:
        before = {k: fn.launches for k, fn in kernels.items()}
        got = run(kind, q)
        torch.cuda.synchronize()
        per = {k: fn.launches - before[k] for k, fn in kernels.items()
               if fn.launches > before[k]}
        e = check_window(n, got, want[n])
        rows = len(next(iter(got.values())) if isinstance(got, dict) else got)
        log(f"window {n}: agrees with numpy ({rows} rows, max abs err {e!r}; "
            f"launches {per}) — {q}")
        del got
    launches = {k: fn.launches for k, fn in kernels.items()}
    if launches["group_hist"] <= 0:
        raise AssertionError("windows: the grouping set over k did not "
                             "launch K2")
    log(f"window launches: {launches}")
    del want
    log(f"window timing on {name} (median of 5 warm runs, host clock, call "
        "to the host result):")
    for kind, n, q in queries:
        run(kind, q)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            run(kind, q)
            ts.append(time.perf_counter() - t0)
        log(f"  query {n}: median {sorted(ts)[2] * 1e3!r} ms over 5 warm runs "
            f"[{name}]")
    return launches, run, queries


def load_tpch():
    """``benchmarks/tpch.py`` (numpy only at module level; its
    ``build_db`` is the JAX package's and is not called here)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                           / "benchmarks"))
    import tpch

    return tpch


class RoundTrip:
    """Host time of ``materialize_query_table`` outside the query it
    materialises: the decode, the re-encode and the upload of each
    derived, CTE and decorrelation table (the result's own device→host
    copy is inside the query).  Wraps the two functions while active."""

    def __init__(self, subquery, executor):
        self.mods = (subquery, executor)
        self.frames: list = []  # [run seconds, run depth] per materialise
        self.total = self.seconds = 0.0

    def __enter__(self):
        sub, ex = self.mods
        self.saved = (sub.materialize_query_table, ex.run_query_table)
        mat, run = self.saved

        def materialize(*a, **kw):
            self.frames.append([0.0, 0])
            t0 = time.perf_counter()
            try:
                return mat(*a, **kw)
            finally:
                el = time.perf_counter() - t0
                inner, _depth = self.frames.pop()
                if not self.frames:
                    self.total += el
                self.seconds += el - inner

        def run_table(*a, **kw):
            frame = self.frames[-1] if self.frames else None
            if frame is not None:
                frame[1] += 1
            t0 = time.perf_counter()
            try:
                return run(*a, **kw)
            finally:
                if frame is not None:
                    frame[1] -= 1
                    if frame[1] == 0:
                        frame[0] += time.perf_counter() - t0

        sub.materialize_query_table, ex.run_query_table = materialize, run_table
        return self

    def __exit__(self, *exc):
        sub, ex = self.mods
        sub.materialize_query_table, ex.run_query_table = self.saved


def phase_tpch(WarpDB, HostTable, kernels: dict, name: str) -> tuple:
    """The 22 TPC-H-derived queries through ``query_sql_table`` at
    ``TPCH_ROWS`` lineitem rows, each checked with the suite's own gate
    against its NumPy oracle; per query the kernel launches, the
    materialised tables (all on the card), the median of 5 warm runs
    and the host round trip of its materialised tables.  Returns
    ``(kernel launches over the checked runs, run function, queries,
    facade, tables)``: the profile's inputs and the surfaces phase's."""
    from warpdb_tpu_torch.engine import executor, subquery
    from warpdb_tpu_torch.storage import DeviceTable

    tpch = load_tpch()
    t0 = time.perf_counter()
    tables = tpch.make_tables(TPCH_ROWS, seed=TPCH_SEED)
    t_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    db = WarpDB(HostTable.from_dict(tables["lineitem"]), device="cuda")
    db.register_table("lineitem", db.table)
    for tname in ("orders", "customer", "supplier", "nation", "region",
                  "part", "partsupp"):
        db.register_table(tname, HostTable.from_dict(tables[tname]))
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = {q: tpch.oracle(tables, q) for q in tpch.QUERIES}
    t_oracle = time.perf_counter() - t0
    log(f"tpch: {TPCH_ROWS} lineitem rows, seed {TPCH_SEED}; set-up: "
        f"make_tables {t_make!r} s, upload {t_upload!r} s, oracle "
        f"{t_oracle!r} s")

    def run(_kind, sql):
        # Every run materialises anew: the join memo is off, and the
        # pushdown, count, eager, subquery and CTE memos are dropped.
        for t in (db.table, *db._catalog.values()):
            for memo in JOIN_MEMOS + SUBQUERY_MEMOS:
                getattr(t, memo, {}).clear()
        getattr(db, "_cte_memo", {}).clear()
        return db.query_sql_table(sql)

    # Every table a query materialises (derived, CTE, set-op and
    # decorrelation tables) is made by DeviceTable.from_host; collect them.
    made: list = []
    from_host = DeviceTable.from_host.__func__

    def collect(cls, *a, **kw):
        made.append(from_host(cls, *a, **kw))
        return made[-1]

    for fn in kernels.values():
        fn.launches = 0
    DeviceTable.from_host = classmethod(collect)
    try:
        for q, sql in tpch.QUERIES.items():
            before = {k: fn.launches for k, fn in kernels.items()}
            del made[:]
            got = run("sql", sql)
            torch.cuda.synchronize()
            per = {k: fn.launches - before[k] for k, fn in kernels.items()}
            tpch.check_results(q, got, want[q])
            off = [str(t.device) for t in made if t.device.type != "cuda"
                   or any(c.device.type != "cuda"
                          for c in t.columns.values())]
            if off:
                raise AssertionError(f"tpch {q}: materialised tables on {off}")
            log(f"tpch {q}: agrees with the oracle "
                f"({len(next(iter(got.values())))} rows); launches {per}; "
                f"{len(made)} materialised tables, all on cuda")
    finally:
        DeviceTable.from_host = classmethod(from_host)
    total = {k: fn.launches for k, fn in kernels.items()}
    for k in TPCH_KERNELS:
        if total[k] <= 0:
            raise AssertionError(f"tpch: kernel {k} was not launched")
    log(f"tpch launches: {total}")

    log(f"tpch timing on {name} (median of 5 warm runs; materialise = "
        "time in materialize_query_table, round trip = its part outside "
        "the materialised query):")
    for q, sql in tpch.QUERIES.items():
        run("sql", sql)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            run("sql", sql)
            ts.append(time.perf_counter() - t0)
        med = sorted(ts)[2]
        with RoundTrip(subquery, executor) as rt:
            t0 = time.perf_counter()
            run("sql", sql)
            wall = time.perf_counter() - t0
        extra = ""
        if rt.total:
            extra = (f"; materialise {rt.total * 1e3!r} ms, round trip "
                     f"{rt.seconds * 1e3!r} ms = "
                     f"{100 * rt.seconds / wall!r}% of that run's "
                     f"{wall * 1e3!r} ms")
        log(f"  tpch {q}: median {med * 1e3!r} ms{extra} [{name}]")
    queries = [("sql", f"tpch_{q}", sql) for q, sql in tpch.QUERIES.items()]
    return total, run, queries, db, tables


def np_hll_registers(group: np.ndarray, skey: np.ndarray,
                     n_groups: int) -> np.ndarray:
    """The reference's HyperLogLog registers in NumPy from (group, f32
    sort key) pairs (duplicates change nothing): murmur3 fmix32 of the
    key in uint32, bucket = low 12 bits, rho = 21 - bit length of the
    other 20; per (group, bucket) the largest rho."""
    h = skey.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    w = (h >> np.uint32(12)).astype(np.int64)
    bits = np.where(w > 0, np.floor(np.log2(np.maximum(w, 1))) + 1, 0)
    rho = (21 - bits).astype(np.int32)
    slot = group.astype(np.int64) * 4096 + (h & np.uint32(4095)).astype(np.int64)
    regs = np.zeros(n_groups * 4096, np.int32)
    for r in range(1, 22):  # ascending: a larger rho overwrites
        regs[slot[rho == r]] = r
    return regs.reshape(n_groups, 4096)


def np_distinct_pairs(group: np.ndarray, values: np.ndarray,
                      value_slots: int = 0) -> tuple:
    """The distinct (group, value) pairs, as (group ids, f32 sort keys),
    ascending; -0.0 equals +0.0 and every NaN is one value.  With
    ``value_slots`` (small non-negative integral values) an occupancy
    table replaces the sort."""
    g = group.astype(np.int64)
    if value_slots:
        occ = np.bincount(g * value_slots + values.astype(np.int64),
                          minlength=(int(g.max()) + 1) * value_slots)
        pairs = np.flatnonzero(occ)
        return (pairs // value_slots,
                _fsk((pairs % value_slots).astype(np.float32)))
    # A sort and a neighbour compare (np.unique can take a slower hash
    # path on tens of millions of distinct values).
    pairs = np.sort((g << 32) | _fsk(values))
    keep = np.ones(pairs.shape[0], bool)
    keep[1:] = pairs[1:] != pairs[:-1]
    pairs = pairs[keep]
    return pairs >> 32, pairs & 0xFFFFFFFF


def np_distinct_counts(pair_groups: np.ndarray) -> np.ndarray:
    """Distinct values per occupied group, ascending group ids."""
    counts = np.bincount(pair_groups)
    return counts[counts > 0]


def profiled(fn) -> tuple:
    """One ``torch.profiler`` run of ``fn`` (CPU and CUDA activities):
    ``(wall ms, device events, card busy ms)``, busy being the union of
    the device intervals.  The tracer now and then returns a run without
    its device events; such a run is profiled again, up to three times in
    all (busy None after that)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            break
    else:
        return wall, [], None
    busy, cur = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if cur is None or s > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return wall, dev, (busy + cur[1] - cur[0]) / 1e3


def wall_busy(fn, reps: int = 5) -> tuple:
    """Median host-clock wall of ``reps`` warm calls, then one profiled
    run: (median ms, profiled wall ms, card busy ms)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    wall, _dev, busy = profiled(fn)
    return sorted(ts)[reps // 2] * 1e3, wall, busy


def _grouped_registers(db, sql: str, table):
    """The u8 HLL registers the query path builds for ``sql`` (its grouped
    partial with ``final=False``, the streaming form)."""
    from warpdb_tpu_torch.engine import group_exec
    from warpdb_tpu_torch.engine.executor import _bind_query_strings
    from warpdb_tpu_torch.frontend import parse_query_text
    from warpdb_tpu_torch.frontend.ast import unalias

    q = _bind_query_strings(parse_query_text(sql), table)
    items = [unalias(s) for s in q.select_list]
    plan = group_exec._grouped_plan(q, items, table=table)
    res = group_exec._grouped_partials(q, table, plan, final=False)
    (spec,) = plan["cd_specs"]
    return res.dcounts[spec.key]


def _check_hll(what: str, got_est, model_regs, exact, got_regs=None,
               rel: float = 0.05) -> str:
    """Registers equal bit for bit, the estimate equal to the NumPy
    estimator over them (rtol 1e-5) and within ``rel`` of the exact
    count."""
    from warpdb_tpu_torch.ops.hll import hll_estimate_np

    if got_regs is not None and not np.array_equal(
            np.asarray(got_regs, np.int32), model_regs):
        raise AssertionError(f"{what}: registers differ from the NumPy model")
    got_est = np.asarray(got_est, np.float64)
    np.testing.assert_allclose(got_est, hll_estimate_np(model_regs),
                               rtol=1e-5, err_msg=what)
    err = np.abs(got_est - exact) / np.maximum(exact, 1)
    if err.max() > rel:
        raise AssertionError(f"{what}: {err.max()!r} from the exact count")
    return (f"registers equal to the NumPy model, estimate within rtol 1e-5 "
            f"of its estimator and {float(err.max())!r} of the exact count")


def _read_capsule(arr_c, schema_c):
    """The exported ``(ArrowArray, ArrowSchema)`` structs behind two
    capsules, through the module's ctypes layouts."""
    from warpdb_tpu_torch.api import _capsule_address
    from warpdb_tpu_torch.interchange.arrow_export import (
        ArrowArrayStruct,
        ArrowSchemaStruct,
    )

    return (ArrowArrayStruct.from_address(_capsule_address(arr_c)),
            ArrowSchemaStruct.from_address(_capsule_address(schema_c)))


def _f32_buffer(arr) -> np.ndarray:
    """A NumPy view of a float column's data buffer (no copy)."""
    import ctypes

    buf = (ctypes.c_float * arr.length).from_address(arr.buffers[1])
    return np.ctypeslib.as_array(buf)


def _release(arr) -> None:
    """Call the exporter's release callback, as a consumer would."""
    import ctypes

    arr.release(ctypes.pointer(arr))


SURFACE_HTTP = [
    "SELECT quantity, SUM(price) AS s FROM t GROUP BY quantity",
    "SELECT price FROM t ORDER BY price DESC LIMIT 5",
    "SELECT k, COUNT(*) AS n FROM t WHERE price > 99.9 GROUP BY k "
    "ORDER BY n DESC, k ASC LIMIT 10",
    "SELECT quantity, APPROX_COUNT_DISTINCT(k) AS d FROM t GROUP BY quantity",
]


def phase_surfaces(db, data: dict, host, tdb, tables: dict, kernels: dict,
                   name: str) -> dict:
    """APPROX_COUNT_DISTINCT, STRING_AGG and the result surfaces (Arrow
    export, EXPLAIN ANALYZE, DDL, DB-API, HTTP server, CLI) at full size:
    bench.py's table ``db`` and the TPC-H tables of ``tdb``.  Returns the
    kernel launches of the phase (counters from 0)."""
    import os
    import threading
    import urllib.request

    import warpdb_tpu_torch.dbapi as dbapi
    from warpdb_tpu_torch.errors import ValidationError
    from warpdb_tpu_torch.interchange import arrow_export
    from warpdb_tpu_torch.ops.hll import hll_grouped_registers
    from warpdb_tpu_torch.ops.sort import float_sort_key
    from warpdb_tpu_torch.serve import QueryServer, _jsonable

    for fn in kernels.values():
        fn.launches = 0
    p, q, k = data["price"], data["quantity"], data["k"]
    qi = q.astype(np.int64)

    # HLL over bench.py's table: 32 groups, the global form, 65536 groups
    # (the exact route).
    t0 = time.perf_counter()
    sql = "SELECT APPROX_COUNT_DISTINCT(k) FROM t GROUP BY quantity"
    got = db.query_sql(sql)
    regs = _grouped_registers(db, sql, db.table)
    t_model = time.perf_counter()
    pg, pk = np_distinct_pairs(qi, k, KEY_SLOTS)
    model = np_hll_registers(pg, pk, GROUP_SLOTS)
    t_model = time.perf_counter() - t_model
    log(f"surfaces hll_k_by_quantity: {_check_hll('hll_k_by_quantity', got, model, np_distinct_counts(pg), regs)} — {sql}")
    sql = "SELECT APPROX_COUNT_DISTINCT(price) FROM t"
    got = db.query_sql(sql)
    pd_ = db.table.row_columns()["price"]
    seg0 = torch.zeros(ROWS, dtype=torch.int64, device=pd_.device)
    regs = hll_grouped_registers(seg0, float_sort_key(pd_), None, 1)
    t1 = time.perf_counter()
    pg, pk = np_distinct_pairs(np.zeros(ROWS, np.int64), p)
    model = np_hll_registers(pg, pk, 1)
    t_model += time.perf_counter() - t1
    exact = np.float64([pk.shape[0]])
    log(f"surfaces hll_price_global: {_check_hll('hll_price_global', got, model, exact, regs.cpu().numpy())} — {sql}")
    sql = "SELECT APPROX_COUNT_DISTINCT(price) FROM t GROUP BY k"
    got = np.asarray(db.query_sql(sql), np.float64)
    t1 = time.perf_counter()
    want = np_distinct_counts(np_distinct_pairs(k, p)[0])
    t_model += time.perf_counter() - t1
    np.testing.assert_array_equal(got, want, err_msg="hll_price_by_k")
    log(f"surfaces hll_price_by_k: {got.shape[0]} groups, the exact route: "
        f"equal to NumPy's distinct counts — {sql}")
    log(f"surfaces hll checks: {time.perf_counter() - t0!r} s, the NumPy "
        f"models {t_model!r} s of it")
    # The register build at the main path's shape (2^25 rows, 32 groups):
    # int64 group ids and keys in, the table out.
    seg = torch.from_numpy(qi).to(pd_.device)
    skey = float_sort_key(db.table.row_columns()["k"])
    hll_ms = cuda_ms(lambda: hll_grouped_registers(seg, skey, None, 32))
    hll_bound = bound_ms(ROWS * 16 + 32 * 4096 * 4)
    del seg, skey, seg0, regs
    q_hll = "SELECT APPROX_COUNT_DISTINCT(k) FROM t GROUP BY quantity"
    hll_wall, hll_prof, hll_busy = wall_busy(lambda: db.query_sql(q_hll))
    log(f"surfaces timing hll_registers n={ROWS} groups=32: CUDA events "
        f"{hll_ms!r} ms, bound {hll_bound!r} ms = {100 * hll_bound / hll_ms!r}% "
        f"[{name}]")
    log(f"surfaces timing hll_k_by_quantity: median {hll_wall!r} ms over 5 "
        f"warm runs; profiled wall {hll_prof!r} ms, card busy {hll_busy!r} ms "
        f"[{name}]")

    # TPC-H at 2^22 lineitem rows: HLL per supplier, STRING_AGG per customer.
    li, od = tables["lineitem"], tables["orders"]
    sql = ("SELECT l_suppkey, APPROX_COUNT_DISTINCT(l_partkey) FROM lineitem "
           "GROUP BY l_suppkey")
    got = tdb.query_sql_table(sql)
    supp = li["l_suppkey"].astype(np.int64)
    uniq, gid = np.unique(supp, return_inverse=True)
    if not np.array_equal(np.asarray(got["l_suppkey"]), uniq):
        raise AssertionError("tpch_hll: supplier keys differ")
    regs = _grouped_registers(tdb, sql, tdb._catalog["lineitem"])
    pg, pk = np_distinct_pairs(gid, li["l_partkey"])
    model = np_hll_registers(pg, pk, uniq.shape[0])
    exact = np_distinct_counts(pg)
    est = list(got.values())[1]
    log(f"surfaces tpch_hll ({uniq.shape[0]} suppliers): "
        f"{_check_hll('tpch_hll', est, model, exact, regs, rel=0.082)} — {sql}")
    sql = ("SELECT o_custkey, STRING_AGG(o_orderpriority, ',') FROM orders "
           "GROUP BY o_custkey")
    got = tdb.query_sql_table(sql)
    cust = od["o_custkey"].astype(np.int64)
    prio = np.asarray(od["o_orderpriority"]).astype(str)
    order = np.lexsort((prio, cust))
    keys, starts = np.unique(cust[order], return_index=True)
    pieces = np.split(prio[order], starts[1:])
    want = [",".join(x) for x in pieces]
    if (not np.array_equal(np.asarray(got["o_custkey"]), keys)
            or list(got.values())[1] != want):
        raise AssertionError("tpch_string_agg: differs from the Python model")
    sa_wall, sa_prof, sa_busy = wall_busy(lambda: tdb.query_sql_table(sql))
    log(f"surfaces tpch_string_agg: {keys.shape[0]} groups over "
        f"{cust.shape[0]} orders, equal to the Python model — {sql}")
    log(f"surfaces timing tpch_string_agg: median {sa_wall!r} ms over 5 warm "
        f"runs; profiled wall {sa_prof!r} ms, card busy {sa_busy!r} ms, host "
        f"{sa_prof - (sa_busy or 0.0)!r} ms [{name}]")

    # Arrow: the expression result at 2^25 rows, in process memory and in
    # POSIX shared memory, read back through the module's ctypes structs.
    want = db.query_np("price * quantity")
    arr, schema = _read_capsule(*db.query_arrow("price * quantity"))
    if (schema.format != b"f" or arr.length != ROWS or arr.n_buffers != 2
            or _f32_buffer(arr).tobytes() != want.tobytes()):
        raise AssertionError("arrow: exported column differs from query_np")
    _release(arr)
    shm = os.statvfs("/dev/shm")
    shm_rows = ROWS if shm.f_bavail * shm.f_frsize > ROWS * 4 * 2 else 1 << 20
    sdb = db if shm_rows == ROWS else type(db)(
        type(host).from_dict({c: v[:shm_rows] for c, v in data.items()}),
        device=db.device)
    arr_c, schema_c = sdb.query_arrow("price * quantity", shared_memory=True)
    shm_path = arrow_export.shared_memory_path(arr_c)
    if shm_path is None:
        raise AssertionError("arrow shm: the export reports no segment")
    arr, _schema = _read_capsule(arr_c, schema_c)
    with open(shm_path, "rb") as f:
        raw = f.read(shm_rows * 4)
    if raw != want[:shm_rows].tobytes() or _f32_buffer(arr).tobytes() != raw:
        raise AssertionError(f"arrow shm: {shm_path} differs")
    del raw
    _release(arr)
    if os.path.exists(shm_path):
        raise AssertionError(f"arrow shm: release left {shm_path}")
    log(f"surfaces arrow: query_arrow n={ROWS} equal to query_np byte for "
        f"byte; shared_memory n={shm_rows} in {shm_path} (/dev/shm free "
        f"{shm.f_bavail * shm.f_frsize!r} bytes) equal, unlinked on release")
    sql = ("SELECT o_orderpriority, COUNT(*) AS n FROM orders "
           "GROUP BY o_orderpriority")
    parent, pschema = _read_capsule(*tdb.query_arrow_table(sql))
    fmts = [pschema.children[i].contents.format
            for i in range(pschema.n_children)]
    if pschema.format != b"+s" or fmts != [b"u", b"f"] or parent.length != 5:
        raise AssertionError(f"arrow table: {pschema.format} {fmts} "
                             f"{parent.length}")
    _release(parent)
    ts = {"query": [], "query_np": [], "query_arrow": []}
    for _ in range(5):
        for fn, call in (("query", db.query), ("query_np", db.query_np),
                         ("query_arrow", db.query_arrow)):
            t0 = time.perf_counter()
            out = call("price * quantity")
            ts[fn].append((time.perf_counter() - t0) * 1e3)
            if fn == "query_arrow":
                _release(_read_capsule(*out)[0])
            del out
    log("surfaces arrow table: struct array of utf8 + float32 (5 rows); "
        f"timing price * quantity n={ROWS} (host clock, median of 5, in "
        "turns): " + ", ".join(f"{fn} {sorted(v)[2]!r} ms"
                               for fn, v in ts.items()) + f" [{name}]")

    # EXPLAIN ANALYZE: the trailer names the kernel each query ran.
    for qname, kname, kfn in (("group_sum_k", "K2 group_hist", "group_hist"),
                              ("orderby_limit", "K1 topk", "topk")):
        sql = dict(SQL_QUERIES)[qname]
        before = kernels[kfn].launches
        plan = db.explain(sql, analyze=True)
        ops = [ln for ln in plan.splitlines() if "operators:" in ln]
        if not ops or kname not in ops[0] or kernels[kfn].launches <= before:
            raise AssertionError(f"explain {qname}: {plan}")
        log(f"surfaces explain {qname}: " + " | ".join(
            ln.strip() for ln in plan.splitlines()
            if "strategy:" in ln or "order by:" in ln or "operators:" in ln))

    # DDL: CREATE a K2 aggregate table, query it, DROP it.
    before = kernels["group_hist"].launches
    db.query_sql("CREATE TABLE agg_k AS SELECT k, SUM(price) AS s FROM t "
                 "GROUP BY k")
    if kernels["group_hist"].launches <= before:
        raise AssertionError("ddl: CREATE TABLE did not launch K2")
    got = db.query_sql_table("SELECT k, s FROM agg_k WHERE k < 100")
    ki = k.astype(np.int64)
    sums_k = np.bincount(ki, weights=p.astype(np.float64), minlength=KEY_SLOTS)
    occ = np.flatnonzero(np.bincount(ki, minlength=KEY_SLOTS)[:100])
    np.testing.assert_array_equal(got["k"], occ.astype(np.float64))
    np.testing.assert_allclose(got["s"], sums_k[occ], rtol=SUM_RTOL)
    if db._catalog["agg_k"].device != db.device:
        raise AssertionError("ddl: agg_k is not on the facade's device")
    db.query_sql("DROP TABLE agg_k")
    try:
        db.query_sql("SELECT s FROM agg_k")
    except ValidationError:
        pass
    else:
        raise AssertionError("ddl: agg_k still answers after DROP")
    log("surfaces ddl: CREATE TABLE agg_k (K2), a query over it against "
        "NumPy, DROP TABLE agg_k")

    # DB-API over the same host table, uploaded again.
    sql = "SELECT quantity, SUM(price) AS s, COUNT(*) AS n FROM t GROUP BY quantity"
    conn = dbapi.connect(host, device=db.device.type)
    rows = conn.cursor().execute(sql).fetchall()
    conn.close()
    want = db.query_sql_table(sql)
    # Keys and counts exactly; f32 sums add in a run-dependent order.
    got = np.asarray(rows, np.float64).T
    np.testing.assert_array_equal(got[[0, 2]], np.asarray(
        [want["quantity"], want["n"]], np.float64), err_msg="dbapi")
    np.testing.assert_allclose(got[1], want["s"], rtol=SUM_RTOL,
                               err_msg="dbapi")
    log(f"surfaces dbapi: {len(rows)} rows equal to query_sql_table — {sql}")

    # HTTP: 20 POST /query (10 one at a time, 10 from two threads at once).
    srv = QueryServer(db, port=0).start()
    want = {s: {c: _jsonable(v) for c, v in db.query_sql_table(s).items()}
            for s in SURFACE_HTTP}
    lat: list = []
    errors: list = []

    def post(sql):
        body = json.dumps({"sql": sql}).encode()
        req = urllib.request.Request(
            f"http://{srv.host}:{srv.port}/query", data=body,
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())["columns"]
        lat.append((time.perf_counter() - t0) * 1e3)
        # Keys, counts and estimates exactly; f32 sums add in a
        # run-dependent order on the card.
        if list(out) != list(want[sql]) or not all(
                np.allclose(np.asarray(out[c], np.float64),
                            np.asarray(want[sql][c], np.float64),
                            rtol=SUM_RTOL if sql == SURFACE_HTTP[0] else 0,
                            atol=0)
                for c in out):
            errors.append(sql)

    def worker(sqls):
        try:
            for s in sqls:
                post(s)
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(repr(e))

    try:
        for i in range(10):
            post(SURFACE_HTTP[i % len(SURFACE_HTTP)])
        threads = [threading.Thread(target=worker, args=(
            [SURFACE_HTTP[(i + j) % len(SURFACE_HTTP)] for i in range(5)],))
            for j in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads) or errors or len(lat) != 20:
            raise AssertionError(f"http: {errors} ({len(lat)} answers)")
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/schema", timeout=30) as r:
            schema = json.loads(r.read())
    finally:
        srv.shutdown()
    if not health["ok"] or health["rows"] != ROWS or sorted(
            schema["columns"]) != ["k", "price", "quantity"]:
        raise AssertionError(f"http: {health} {schema}")
    lat.sort()
    log(f"surfaces http: 20 POST /query equal to query_sql_table (10 "
        f"sequential, 10 from two threads at once), /healthz and /schema; "
        f"latency median {lat[10]!r} ms, p90 {lat[17]!r} ms [{name}]")

    # CLI, as a user runs it.
    root = pathlib.Path(__file__).resolve().parent
    base = [sys.executable, "-m", "warpdb_tpu_torch",
            "price * quantity WHERE price > 10", "data/test.csv",
            "--device", db.device.type]
    for extra, need in (([], ["Result[0] = 31.5", "Result[3] = 150.0"]),
                        (["--explain", "--analyze"],
                         ["Expression plan", "Execution (measured):"])):
        t0 = time.perf_counter()
        proc = subprocess.run(base + extra, cwd=root, capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0 or any(s not in proc.stdout for s in need):
            raise AssertionError(f"cli {extra}: rc {proc.returncode}\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        log(f"surfaces cli {' '.join(extra) or '(query)'}: rc 0 in "
            f"{time.perf_counter() - t0!r} s, lines {need} present")

    launches = {kk: fn.launches for kk, fn in kernels.items()}
    for kk in ("topk", "group_hist"):
        if launches[kk] <= 0:
            raise AssertionError(f"surfaces: kernel {kk} was not launched")
    log(f"surfaces launches: {launches}")
    return launches


def _num(v, width: int, pad: bool = False) -> tuple:
    """ASCII digits of non-negative ints ``v`` in ``width`` columns and
    the mask keeping them (leading zeros dropped unless ``pad``); up to
    five digits through a table of every value."""
    v = np.asarray(v, np.int64)
    if width <= 5 and v.shape[0] > 10 ** width:
        digits, keep = _num(np.arange(10 ** width), width, pad)
        return digits[v], keep[v]
    p10 = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((48 + (v[:, None] // p10) % 10).astype(np.uint8),
            (v[:, None] >= p10) | (p10 == 1) | pad)


def _text(n: int, s: str) -> tuple:
    b = np.frombuffer(s.encode(), np.uint8)
    return np.broadcast_to(b, (n, b.size)), np.ones((n, b.size), bool)


def _cents(c) -> list:
    """``c / 100`` written as ``int.dd``."""
    return [_num(c // 100, 2), _text(len(c), "."), _num(c % 100, 2, True)]


def write_digit_csv(path, header: str, cells: list, n: int) -> int:
    """Write ``n`` rows by digit arithmetic (``np.savetxt`` takes minutes
    at 2^25 rows): each of ``cells`` maps a row slice to its cell's
    (digits, mask) pieces.  Returns the bytes written."""
    size = 0
    with open(path, "wb") as f:
        f.write(header.encode() + b"\n")
        for lo in range(0, n, 1 << 22):
            s = slice(lo, min(n, lo + (1 << 22)))
            rows = s.stop - s.start
            pieces = []
            for i, cell in enumerate(cells):
                if i:
                    pieces.append(_text(rows, ","))
                pieces += cell(s)
            pieces.append(_text(rows, "\n"))
            mat = np.concatenate([m for m, _k in pieces], axis=1)
            keep = np.concatenate([np.broadcast_to(k, m.shape)
                                   for m, k in pieces], axis=1)
            body = mat[keep].tobytes()
            size += len(body)
            f.write(body)
    return size


def make_stream_data() -> tuple:
    """The stream's arrays from SEED: ``price`` whole cents in [0, 100)
    (its text round-trips to f32), ``quantity`` in [0, 32), ``k`` in
    [0, 65536); and the side files' string codes and wide keys."""
    rng = np.random.default_rng(SEED)
    cents = rng.integers(0, 10_000, ROWS)
    d = {"cents": cents,
         "price": (cents / 100).astype(np.float32),
         "quantity": rng.integers(0, GROUP_SLOTS, ROWS),
         "k": rng.integers(0, KEY_SLOTS, ROWS)}
    side = np.random.default_rng(SEED + 2)
    d["c"] = side.integers(0, STREAM_STRINGS, STREAM_SIDE_ROWS)
    d["k64"] = (1 << 40) + side.integers(0, 4096, STREAM_SIDE_ROWS)
    return d


def expected_stream(d: dict, dimk: dict) -> dict:
    """NumPy answers of STREAM_QUERIES, one array per result column."""
    from warpdb_tpu_torch.ops.hll import hll_estimate_np

    p, qi, ki = d["price"], d["quantity"], d["k"]
    p64 = p.astype(np.float64)
    f = np.float32
    keys_q = np.arange(GROUP_SLOTS)
    mins = np.full(GROUP_SLOTS, np.inf, np.float32)
    maxs = np.full(GROUP_SLOTS, -np.inf, np.float32)
    np.minimum.at(mins, qi, p)
    np.maximum.at(maxs, qi, p)
    occ_k = np.bincount(ki, minlength=KEY_SLOTS) > 0
    hot50 = p > f(50)
    hot999 = p > f(99.9)
    pair_g, _v = np_distinct_pairs(qi, ki, KEY_SLOTS)
    regs = np_hll_registers(qi, _fsk(ki.astype(np.float32)), GROUP_SLOTS)
    dk = dimk["k"].astype(np.int64)
    cnt = np.bincount(dk, minlength=DIMK_KEYS)
    wsum = np.bincount(dk, weights=dimk["w"].astype(np.float64),
                       minlength=DIMK_KEYS)
    hot = p > f(99)
    avg = (np.bincount(qi[hot], weights=p64[hot], minlength=GROUP_SLOTS)
           / np.maximum(np.bincount(qi[hot], minlength=GROUP_SLOTS), 1))
    dev = p[hot] - avg.astype(np.float32)[qi[hot]]
    sp = p[:STREAM_SIDE_ROWS].astype(np.float64)
    k64s, k64i = np.unique(d["k64"], return_inverse=True)
    kn = ki[:STREAM_SIDE_ROWS]
    occ_n = np.bincount(kn, minlength=KEY_SLOTS) > 0
    s50 = p64[hot50].sum()
    return {
        "s_expr": [np.where(p > f(15), p * qi.astype(np.float32), f(0))],
        "s_group_q": [keys_q, np.bincount(qi, minlength=GROUP_SLOTS),
                      np.bincount(qi, weights=p64, minlength=GROUP_SLOTS),
                      mins, maxs],
        "s_group_k": [np.flatnonzero(occ_k),
                      np.bincount(ki, weights=p64,
                                  minlength=KEY_SLOTS)[occ_k]],
        # Counts come back as f32, as in memory (exact up to 2^24).
        "s_global": [[f(hot50.sum())], [s50], [s50 / hot50.sum()]],
        "s_topk": [np.sort(p)[::-1][:5]],
        "s_limit": [p[hot999][:100], ki[hot999][:100]],
        "s_distinct": [keys_q],
        "s_count_distinct": [keys_q, np_distinct_counts(pair_g)],
        "s_hll": [keys_q, hll_estimate_np(regs)],
        "s_join_dimk": [keys_q, np.bincount(qi, weights=p64 * wsum[ki],
                                            minlength=GROUP_SLOTS)],
        "s_join_left": [[f(cnt[ki].sum())]],
        "s_window": [np.sort(dev)[::-1][:10]],
        "s_strings": [[f"c{i:03d}" for i in range(STREAM_STRINGS)],
                      np.bincount(d["c"], weights=sp,
                                  minlength=STREAM_STRINGS)],
        "s_int64_wide": [[int(x) for x in k64s], np.bincount(k64i),
                         np.bincount(k64i, weights=sp)],
        "s_int64_narrow": [[int(x) for x in np.flatnonzero(occ_n)],
                           np.bincount(kn, minlength=KEY_SLOTS)[occ_n],
                           np.bincount(kn, weights=sp,
                                       minlength=KEY_SLOTS)[occ_n]],
    }


def check_stream(name: str, got, want: list) -> float:
    """A streamed answer against NumPy, column by column: exact (values,
    counts, keys, strings, row order), or within SUM_RTOL of float64 for
    STREAM_SUMS.  Returns the largest absolute error."""
    cols = list(got.values()) if isinstance(got, dict) else [got]
    if len(cols) != len(want):
        raise AssertionError(f"{name}: {len(cols)} columns")
    err = 0.0
    for i, (g, w) in enumerate(zip(cols, want)):
        what = f"{name}[{i}]"
        if len(g) != len(w):
            raise AssertionError(f"{what}: {len(g)} values, want {len(w)}")
        if isinstance(w, list) and w and not isinstance(w[0], float):
            if list(g) != list(w):  # strings, wide keys: exact
                raise AssertionError(f"{what}: differs")
            continue
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        if name == "s_window":
            g = np.sort(g)[::-1]  # near-equal deviations may swap
        if i in STREAM_SUMS.get(name, ()):
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL, err_msg=what)
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)
        if g.size:
            err = max(err, float(np.max(np.abs(g - w))))
    return err


@contextlib.contextmanager
def native_library(tmp: pathlib.Path):
    """The native CSV library, built by ``make`` from a copy of
    ``native/`` in ``tmp`` and loaded from there for the stream; the
    loader's state is restored on leaving, and the checkout is untouched.
    Yields the build time in seconds."""
    from warpdb_tpu_torch.interchange import native as native_mod

    src = pathlib.Path(__file__).resolve().parent / "native"
    t0 = time.perf_counter()
    shutil.copytree(src, tmp / "native",
                    ignore=shutil.ignore_patterns("*.so"))
    subprocess.run(["make", "-s", "-C", str(tmp / "native")], check=True)
    lib = ctypes.CDLL(str(tmp / "native" / "libwarpdb_native.so"))
    native_mod._configure(lib)
    saved = native_mod._lib, native_mod._lib_checked
    native_mod._lib, native_mod._lib_checked = lib, True
    try:
        yield time.perf_counter() - t0
    finally:
        native_mod._lib, native_mod._lib_checked = saved


def check_stream_kernels(first, dimk: dict) -> dict:
    """K2 and K3 at the stream's chunk shapes, on the first chunk's
    columns, against their plain versions.  K2 as ``GROUP BY k`` gives
    it: int32 ids at the chunk's row count, 65536 slots, the price
    (counts exact, sums within SUM_RTOL of plain and float64).  K3 as
    the joins against ``dimk`` give it: int64 exclusive offsets of each
    row's matches (0-3); INNER gathers price, quantity and the build
    slot, LEFT the build slot and the match counts with every row
    emitting at least once (bit for bit).  These launches count for no
    path.  Returns the largest absolute errors."""
    from warpdb_tpu_torch.ops import expand
    from warpdb_tpu_torch.ops import group_kernel as group

    err = {"group_hist": 0.0, "windowed_expand": 0.0}

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    price = first.get_column("price").data
    quantity = first.get_column("quantity").data
    k = first.get_column("k").data.astype(np.int64)
    gid = k.astype(np.int32)
    _check_group(group, gid, cuda(gid), [price], [cuda(price)], KEY_SLOTS,
                 f"stream chunk n={gid.shape[0]}", err, {})
    log(f"K2 stream chunk n={gid.shape[0]} slots={KEY_SLOTS} nv=1: counts "
        f"exact, sums within rtol {SUM_RTOL} of plain and float64")
    cnt = np.bincount(dimk["k"].astype(np.int64), minlength=KEY_SLOTS)
    counts = cnt[k]
    lo32 = cuda((np.cumsum(cnt) - cnt)[k].astype(np.int32))
    for kind, emit, cols in (
            ("INNER", counts, [cuda(price), cuda(quantity), lo32]),
            ("LEFT", np.maximum(counts, 1),
             [lo32, cuda(counts.astype(np.int32))])):
        off = cuda(np.cumsum(emit) - emit)
        total = int(emit.sum())
        _o, dup, taken = expand.windowed_expand(off, cols, total)
        _po, pdup, ptaken = expand.windowed_expand_plain(off, cols, total,
                                                         False)
        torch.cuda.synchronize()
        err["windowed_expand"] = max(
            err["windowed_expand"],
            _bit_err(taken + (dup,), ptaken + (pdup,),
                     f"K3 stream chunk {kind}"))
        log(f"K3 stream chunk {kind} n={k.shape[0]} total={total} "
            f"C={len(cols)}: dup and columns equal to plain bit for bit")
    return err


def phase_streaming(WarpDB, HostTable, kernels: dict, dimk: dict,
                    name: str, tmp: pathlib.Path) -> tuple:
    """Out-of-core streaming through the facade's ``query_streaming_csv``
    / ``query_streaming_sql``: STREAM_QUERIES over a 2^25-row CSV in
    chunks of 10^6 rows (and the two side files), each checked against
    NumPy; per statement its K1-K5 launches, chunks, the median of 3 warm
    runs, the parser wait, the device time (CUDA events), the host merge
    and the peak device memory above the start.  K2 must launch once a
    chunk in ``s_group_k``, a join kernel in each join statement, the
    narrow int64 stream must be read once, and no peak may reach half the
    file's device bytes.  K2 and K3 are first held to their plain
    versions at the chunk's shapes.  Runs inside :func:`native_library`.
    Returns ``(launches, run, queries, max errors of K2 and K3, the
    first chunk)``."""
    from warpdb_tpu_torch.interchange import native as native_mod
    from warpdb_tpu_torch.parallel import last_stream_stats, run_streaming_csv
    from warpdb_tpu_torch.storage import DataType, padded_length
    from warpdb_tpu_torch.storage.chunks import iter_table_chunks

    t_phase = time.perf_counter()
    if not native_mod.has_native_stream():
        raise AssertionError("streaming: the native CSV stream did not load")
    log("streaming: parse backend: native prefetching stream (all-f32 "
        "file), Python parser (side files)")

    t0 = time.perf_counter()
    d = make_stream_data()
    path, spath, wpath, npath = (tmp / "stream.csv", tmp / "strings.csv",
                                 tmp / "wide.csv", tmp / "narrow.csv")
    size = write_digit_csv(path, "price,quantity,k", [
        lambda s: _cents(d["cents"][s]), lambda s: [_num(d["quantity"][s], 2)],
        lambda s: [_num(d["k"][s], 5)]], ROWS)
    write_digit_csv(spath, "price,c", [
        lambda s: _cents(d["cents"][s]),
        lambda s: [_text(s.stop - s.start, "c"), _num(d["c"][s], 3, True)]],
        STREAM_SIDE_ROWS)
    write_digit_csv(wpath, "price,k64", [
        lambda s: _cents(d["cents"][s]), lambda s: [_num(d["k64"][s], 13)]],
        STREAM_SIDE_ROWS)
    write_digit_csv(npath, "price,kn", [
        lambda s: _cents(d["cents"][s]), lambda s: [_num(d["k"][s], 5)]],
        STREAM_SIDE_ROWS)
    log(f"streaming: wrote {ROWS} rows, {size} bytes, and three "
        f"{STREAM_SIDE_ROWS}-row side files in {time.perf_counter() - t0!r} s")
    it = iter_table_chunks(str(path), STREAM_CHUNK)
    first = next(it)
    it.close()
    for col, arr in (("price", d["price"]), ("quantity", d["quantity"]),
                     ("k", d["k"])):
        parsed = first.get_column(col).data
        if not np.array_equal(parsed.view(np.uint32), np.asarray(
                arr[:STREAM_CHUNK], np.float32).view(np.uint32)):
            raise AssertionError(f"streaming: {col} did not parse back "
                                 "bit for bit")
    t0 = time.perf_counter()
    want = expected_stream(d, dimk)
    log(f"streaming: the first chunk parses back bit for bit; NumPy oracle "
        f"{time.perf_counter() - t0!r} s")
    err = check_stream_kernels(first, dimk)

    dims = {"dimk": HostTable.from_dict(dimk)}
    schemas = {"strings": (spath, [DataType.FLOAT32, DataType.STRING]),
               "wide": (wpath, [DataType.FLOAT32, DataType.INT64]),
               "narrow": (npath, [DataType.FLOAT32, DataType.INT64])}

    def run(kind, q):
        if kind == "expr":
            return run_streaming_csv(str(path), q, STREAM_CHUNK,
                                     device="cuda")
        if kind in schemas:
            p, schema = schemas[kind]
            return WarpDB.query_streaming_sql(str(p), q, STREAM_CHUNK,
                                              schema=schema, device="cuda")
        return WarpDB.query_streaming_sql(
            str(path), q, STREAM_CHUNK, device="cuda",
            dims=dims if kind == "join" else None)

    one_chunk = 12 * padded_length(STREAM_CHUNK)
    whole = 12 * ROWS
    launches = {k: 0 for k in kernels}
    log(f"streaming on {name} (wall: host clock, call to the host result, "
        "median of 3 warm runs unless marked; parser wait, device time and "
        f"merge of that run; peak device memory above the start, one "
        f"chunk {one_chunk} B, the file {whole} B on the device):")
    for n, kind, q in STREAM_QUERIES:
        before = {k: fn.launches for k, fn in kernels.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = run(kind, q)
        torch.cuda.synchronize()
        first_wall = time.perf_counter() - t0
        per = {k: fn.launches - before[k] for k, fn in kernels.items()
               if fn.launches > before[k]}
        for k, c in per.items():
            launches[k] += c
        e = check_stream(n, got, want[n])
        runs = [(first_wall, last_stream_stats())]
        chunks = runs[0][1].chunks
        if kind != "once":
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                run(kind, q)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0, last_stream_stats()))
        peak = torch.cuda.max_memory_allocated() - base
        wall, st = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
        if n == "s_expr":
            facade = WarpDB.query_streaming_csv(str(path), q, STREAM_CHUNK,
                                                device="cuda")
            if facade != got.tolist():
                raise AssertionError("s_expr: the facade's list differs")
        log(f"stream {n}: agrees with numpy (max abs err {e!r}; launches "
            f"{per}); chunks {chunks}"
            + (f" (+{st.prepass_chunks} pre-pass)" if st.prepass_chunks else "")
            + f"; wall {wall * 1e3!r} ms"
            + (" (one run, timed once)" if kind == "once" else "")
            + f", {st.rows} rows read = {st.rows / wall / 1e6!r} M rows/s; "
            f"parser wait "
            f"{st.parse_s * 1e3!r} ms, device {st.device_ms!r} ms, merge "
            f"{st.merge_s * 1e3!r} ms; peak {peak} B [{name}] — {q}")
        if n == "s_group_k" and per.get("group_hist") != chunks:
            raise AssertionError(f"s_group_k: K2 launched "
                                 f"{per.get('group_hist')} times in {chunks} "
                                 "chunks")
        if n == "s_int64_narrow" and st.prepass_chunks != 1:
            raise AssertionError(f"s_int64_narrow: {st.prepass_chunks} "
                                 "pre-pass chunks (one fixes the schema)")
        if kind == "join" and not any(per.get(k) for k in (
                "windowed_expand", "uniform_expand", "sorted_take")):
            raise AssertionError(f"{n}: no join kernel launched")
        if peak >= whole // 2:
            raise AssertionError(f"{n}: peak device memory {peak} B holds "
                                 "half the file")
        del got
    log(f"streaming launches: {launches}; phase "
        f"{time.perf_counter() - t_phase!r} s")
    return launches, run, [(kind, n, q) for n, kind, q in STREAM_QUERIES
                           if n in ("s_group_k", "s_join_dimk")], err, first


def phase_uploads(tables: dict, name: str) -> None:
    """Each table's columns (as a ``DeviceTable`` holds them: padded,
    strings as codes) to the card two ways: ``storage.table._upload``,
    what ``DeviceTable.from_host`` does on a card (a page-locked stage
    and a non-blocking copy), and a pageable copy (a zero-padded NumPy
    buffer, ``torch.from_numpy(buf).to("cuda")``).  Per table the first
    call of each way (pageable first), then the median of 3 more of
    each, alternating; each call synchronised."""
    from warpdb_tpu_torch.storage.table import _upload

    dev = torch.device("cuda")

    def pageable(a, n, padded):
        buf = np.zeros(padded, dtype=a.dtype)
        buf[:n] = a[:n]
        return torch.from_numpy(buf).to(dev)

    ways = {"pageable": pageable,
            "stage": lambda a, n, padded: _upload(a, n, padded, dev)}
    log(f"uploads on {name} (host clock, synchronised; first call, then "
        "median of 3):")
    for what, dt in tables.items():
        cols = [t.cpu().numpy() for t in dt.columns.values()]
        n, padded = dt.num_rows, dt.padded_rows
        times = {w: [] for w in ways}
        for way in ("pageable", "stage", "stage", "pageable", "pageable",
                    "stage", "stage", "pageable"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = [ways[way](a, n, padded) for a in cols]
            torch.cuda.synchronize()
            times[way].append(time.perf_counter() - t0)
            del out
        log(f"  upload {what} ({len(cols)} columns, "
            f"{sum(a.nbytes for a in cols)} B): " + "; ".join(
                f"{w} first {ts[0] * 1e3!r} ms, median "
                f"{sorted(ts[1:])[1] * 1e3!r} ms" for w, ts in times.items())
            + f" [{name}]")


# The mesh phase: bench.py's table re-laid over MESH_SHARDS shards of the
# one card (``distribute(data_mesh(devices=["cuda:0"] * 4))``); each
# statement against NumPy and the single-device result.  (name, kind,
# statement); kind "expr" runs ``query_sharded``, "stream" streams a
# MESH_STREAM_ROWS-row CSV over the mesh.
MESH_SHARDS = 4
MESH_STREAM_ROWS = 1 << 19
MESH_QUERIES = [
    ("m_scan", "expr", "price * quantity WHERE price > 15"),
    ("m_group_q", "sql", "SELECT quantity, COUNT(*), SUM(price) FROM t "
     "GROUP BY quantity ORDER BY quantity ASC"),
    ("m_group_k", "sql", "SELECT k, COUNT(*), SUM(price) FROM t GROUP BY k "
     "ORDER BY k ASC"),
    ("m_topk", "sql", "SELECT price FROM t ORDER BY price DESC LIMIT 5"),
    ("m_join_inner", "sql", "SELECT quantity, SUM(price * dimk.w) FROM t "
     "JOIN dimk ON k = dimk.k GROUP BY quantity ORDER BY quantity ASC"),
    ("m_join_left", "sql", "SELECT quantity, COUNT(dimk.w), SUM(price) FROM t "
     "LEFT JOIN dimk ON k = dimk.k GROUP BY quantity ORDER BY quantity ASC"),
    ("m_window", "sql", "SELECT SUM(price) OVER (PARTITION BY quantity) "
     "FROM t WHERE price > 15"),
    ("m_group_2key", "sql", "SELECT quantity, k, COUNT(*), SUM(price) FROM t "
     "WHERE k < 16 GROUP BY quantity, k ORDER BY quantity ASC, k ASC"),
    ("m_hll", "sql", "SELECT quantity, APPROX_COUNT_DISTINCT(k) FROM t "
     "GROUP BY quantity ORDER BY quantity ASC"),
    ("m_global", "sql", "SELECT COUNT(*), SUM(price), AVG(price), "
     "MIN(price), MAX(price) FROM t WHERE price > 15"),
    ("m_project", "sql", "SELECT price * quantity, k FROM t WHERE price > 99"),
    ("m_sort", "sql", "SELECT price FROM t WHERE price > 99 ORDER BY price"),
    ("m_distinct_k", "sql", "SELECT DISTINCT k FROM t"),
    ("m_count_distinct", "sql", "SELECT quantity, COUNT(DISTINCT k) FROM t "
     "GROUP BY quantity"),
    ("m_median", "sql", "SELECT MEDIAN(price) FROM t"),
    ("m_stream", "stream", "SELECT quantity, COUNT(*), SUM(price) FROM t "
     "GROUP BY quantity"),
]
# The GROUP BYs that keep a shuffle route whatever the merge's threshold
# (``distributed_small_keys``), so that the GROUP BY's all_to_all runs
# on every mesh and NCCL group: GROUP BY k (65,536 keys a shard, more
# than the combine holds) by the row shuffle, the two-key GROUP BY (512
# key tuples a shard) by the map-side combine.  Sides of TIER_SIDES.
MESH_FORCED = {"m_group_k": "row shuffle", "m_group_2key": "combine"}
# Result columns that are float sums, by statement.
MESH_SUMS = {"m_group_q": {2}, "m_group_k": {2}, "m_join_inner": {1},
             "m_join_left": {2}, "m_window": {0}, "m_group_2key": {3},
             "m_stream": {2}, "m_global": {1, 2}, "m_median": {0}}
# Sums on the mesh merge in float64 (a shard's partials add in float64,
# or in K2, which adds its f32 blocks in float64):
# held to the float64 NumPy sum within this, and to the single-device
# result within this plus the single-device result's own distance from
# float64.
MESH_RTOL = 1e-6


def expected_mesh(d: dict, dimk: dict, stream: dict) -> dict:
    """NumPy answers of MESH_QUERIES (m_hll: the exact distinct counts
    and the HyperLogLog model's registers)."""
    p, q, k = d["price"], d["quantity"], d["k"]
    f = np.float32
    qi, ki = q.astype(np.int64), k.astype(np.int64)
    p64 = p.astype(np.float64)
    dk = dimk["k"].astype(np.int64)
    cnt = np.bincount(dk, minlength=KEY_SLOTS)
    wsum = np.bincount(dk, weights=dimk["w"].astype(np.float64),
                       minlength=KEY_SLOTS)
    keep = p > f(15)
    occ_k = np.bincount(ki, minlength=KEY_SLOTS) > 0
    small = ki < 16
    pair = qi[small] * 16 + ki[small]
    pocc = np.bincount(pair, minlength=GROUP_SLOTS * 16)
    pid = np.flatnonzero(pocc)
    pg, skey = np_distinct_pairs(q, k, value_slots=KEY_SLOTS)
    sq = stream["quantity"]
    ps = np.sort(p)
    hi = p > f(99)
    # MEDIAN as the engine interpolates it, in f32.
    pos = f(0.5) * f(p.size - 1)
    lo = int(np.floor(pos))
    frac = f(pos - f(lo))
    median = ps[lo] * (f(1) - frac) + ps[min(lo + 1, p.size - 1)] * frac
    kept = p64[keep]
    return {
        "m_scan": [np.where(keep, p * q, f(0))],
        "m_group_q": [np.arange(GROUP_SLOTS), np.bincount(qi),
                      np.bincount(qi, weights=p64)],
        "m_group_k": [np.flatnonzero(occ_k),
                      np.bincount(ki, minlength=KEY_SLOTS)[occ_k],
                      np.bincount(ki, weights=p64,
                                  minlength=KEY_SLOTS)[occ_k]],
        "m_topk": [ps[::-1][:5]],
        "m_join_inner": [np.arange(GROUP_SLOTS),
                         np.bincount(qi, weights=p64 * wsum[ki])],
        "m_join_left": [np.arange(GROUP_SLOTS),
                        np.bincount(qi, weights=cnt[ki]),
                        np.bincount(qi, weights=p64 * np.maximum(cnt[ki],
                                                                 1))],
        "m_window": [np.bincount(qi[keep], weights=p64[keep],
                                 minlength=GROUP_SLOTS)[qi[keep]]],
        "m_group_2key": [pid // 16, pid % 16, pocc[pid],
                         np.bincount(pair, weights=p64[small],
                                     minlength=GROUP_SLOTS * 16)[pid]],
        "m_hll": (np_distinct_counts(pg),
                  np_hll_registers(pg, skey, GROUP_SLOTS)),
        "m_stream": [np.arange(GROUP_SLOTS), np.bincount(sq),
                     np.bincount(sq, weights=stream["price"].astype(
                         np.float64))],
        # COUNT(*) is an f32 result, as every aggregate of the engine.
        "m_global": [[f(kept.size)], [kept.sum()], [kept.sum() / kept.size],
                     [p[keep].min()], [p[keep].max()]],
        "m_project": [(p * q)[hi], k[hi]],
        "m_sort": [np.sort(p[hi])],
        "m_distinct_k": [np.flatnonzero(occ_k)],
        "m_count_distinct": [np.arange(GROUP_SLOTS), np_distinct_counts(pg)],
        "m_median": [[median]],
    }


def check_mesh(name: str, got: list, single: list, want) -> float:
    """One mesh statement: every column equal to the single-device one
    and NumPy's, sums within MESH_RTOL of float64 (and of the
    single-device sum beyond its own distance from float64).  Returns
    the largest relative distance of a sum from the single-device one."""
    if name == "m_hll":
        exact, regs = want
        np.testing.assert_array_equal(got[0], np.arange(GROUP_SLOTS))
        np.testing.assert_array_equal(got[1], single[1], err_msg=name)
        _check_hll(name, got[1], regs, exact)
        return 0.0
    if len(got) != len(want) or len(single) != len(want):
        raise AssertionError(f"{name}: {len(got)} columns")
    worst = 0.0
    for i, (g, s, w) in enumerate(zip(got, single, want)):
        g, s, w = (np.asarray(x, np.float64) for x in (g, s, w))
        if not g.shape == s.shape == w.shape:
            raise AssertionError(f"{name}[{i}]: shapes {g.shape} {s.shape} "
                                 f"{w.shape}")
        if i in MESH_SUMS.get(name, ()):
            np.testing.assert_allclose(g, w, rtol=MESH_RTOL,
                                       err_msg=f"{name}[{i}]")
            bound = MESH_RTOL * np.abs(w) + np.abs(s - w)
            if not np.all(np.abs(g - s) <= bound):
                raise AssertionError(f"{name}[{i}]: off the single-device "
                                     "sum")
            worst = max(worst, float(np.max(np.abs(g - s)
                                            / np.maximum(np.abs(s), 1e-30))))
        else:
            np.testing.assert_array_equal(g, s, err_msg=f"{name}[{i}]")
            np.testing.assert_array_equal(g, w, err_msg=f"{name}[{i}]")
    return worst


# The statements whose kernels check_mesh_kernels holds to their plain
# versions on one shard's inputs, and the kernels each gives.
MESH_KERNEL_CHECKS = {"m_topk": ("topk",), "m_group_k": ("group_hist",),
                      "m_join_inner": ("windowed_expand",),
                      "m_join_left": ("windowed_expand",),
                      "m_distinct_k": ("group_hist",)}


@contextlib.contextmanager
def first_kernel_inputs():
    """Record the arguments of the first call of K1, K2 and K3 made by
    the modules of the mesh path (``ops.sort``, ``ops.aggregate``,
    ``parallel.dist_join``), keyed as the kernels dict; every call goes
    on to the wrapper, which keeps its own count."""
    from warpdb_tpu_torch.ops import aggregate
    from warpdb_tpu_torch.ops import sort as sort_mod
    from warpdb_tpu_torch.parallel import dist_join

    first: dict = {}
    sites = [(sort_mod, "topk_candidates", "topk"),
             (aggregate, "group_counts_sums", "group_hist"),
             (dist_join, "windowed_expand", "windowed_expand")]
    saved = []
    for mod, attr, key in sites:
        fn = getattr(mod, attr)

        def record(*a, _fn=fn, _key=key, **kw):
            first.setdefault(_key, a)
            return _fn(*a, **kw)

        saved.append((mod, attr, fn))
        setattr(mod, attr, record)
    try:
        yield first
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def check_mesh_kernels(name: str, first: dict, err: dict, where: str) -> None:
    """The kernels of mesh statement ``name`` against their plain
    versions on the inputs the path gave the first shard
    (``first_kernel_inputs``): K1 at the shard's k (candidates equal bit
    for bit), K2 at the shard's slot ids and values (counts exact, sums
    within SUM_RTOL of plain and float64), K3 at the shard's offsets and
    gather columns after the exchange (dup and columns bit for bit).
    Adds each largest error to ``err``.  These launches count for no
    path."""
    from warpdb_tpu_torch.ops import expand
    from warpdb_tpu_torch.ops import group_kernel as group
    from warpdb_tpu_torch.ops import topk_kernel as topk

    for kname in MESH_KERNEL_CHECKS[name]:
        if kname not in first:
            raise AssertionError(f"{name}: {kname} did not run on {where}")
        a = first[kname]
        if kname == "topk":
            u, k = a[0], a[1]
            _check_topk(topk, u, k, f"{where} {name} n={u.shape[0]}", err)
            log(f"K1 {where} {name} n={u.shape[0]} k={k} on {u.device}: "
                "candidates equal to plain bit for bit")
        elif kname == "group_hist":
            gd, vd, slots = a[0], list(a[1]), a[2]
            _check_group(group, gd.cpu().numpy(), gd,
                         [v.cpu().numpy() for v in vd], vd, slots,
                         f"{where} {name}", err, {})
            log(f"K2 {where} {name} n={gd.shape[0]} slots={slots} "
                f"nv={len(vd)} on {gd.device}: counts exact, sums within "
                f"rtol {SUM_RTOL} of plain and float64")
        else:
            off, cols, total = a[0], tuple(a[1]), a[2]
            _o, dup, taken = expand.windowed_expand(off, cols, total)
            _po, pdup, ptaken = expand.windowed_expand_plain(off, cols,
                                                             total, False)
            torch.cuda.synchronize(off.device)
            err[kname] = max(err[kname], _bit_err(
                taken + (dup,), ptaken + (pdup,), f"K3 {where} {name}"))
            log(f"K3 {where} {name} n={off.shape[0]} total={total} "
                f"C={len(cols)} on {off.device}: dup and columns equal to "
                "plain bit for bit")


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_nccl(HostTable, data: dict, name: str) -> None:
    """The multi-process path as a world-size-1 NCCL group on cuda:0:
    ``initialize``, ``make_global_table``, a distributed GROUP BY by the
    all_gather merge and, through SQL, GROUP BY k by the row shuffle
    (its all_to_all; forced, whatever the merge's threshold), each
    against NumPy."""
    import torch.distributed as dist

    from warpdb_tpu_torch import WarpDB
    from warpdb_tpu_torch.frontend import parse_expression_text
    from warpdb_tpu_torch.parallel import multihost
    from warpdb_tpu_torch.parallel.sharded import run_grouped_sharded
    from warpdb_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda:0")
    try:
        mesh = multihost.global_mesh()
        start, end = multihost.host_shard_range(ROWS)
        table = multihost.make_global_table(HostTable.from_dict(
            {c: v[start:end] for c, v in data.items()}), ROWS, mesh)
        set_up = time.perf_counter() - t0
        p, q, k = data["price"], data["quantity"], data["k"]
        keep = p > np.float32(50)
        qi, ki = q.astype(np.int64)[keep], k.astype(np.int64)
        with metrics.timed_query("nccl group", "sql", ROWS, 0, "cuda:0"):
            gp = run_grouped_sharded([parse_expression_text("quantity")],
                                     [parse_expression_text("price")],
                                     parse_expression_text("price > 50"),
                                     table)
        cs = metrics.last().collectives
        np.testing.assert_array_equal(gp.counts.cpu().numpy(),
                                      np.bincount(qi))
        np.testing.assert_allclose(
            gp.sums[0].cpu().numpy(),
            np.bincount(qi, weights=p[keep].astype(np.float64)),
            rtol=MESH_RTOL)
        db = WarpDB.from_device_table(table, mesh=mesh, name="t")
        sql = "SELECT k, COUNT(*) FROM t GROUP BY k"
        with forced("row shuffle"):
            t1 = time.perf_counter()
            got = db.query_sql_table(sql)
            wall = time.perf_counter() - t1
            ops = [o for o, _h in metrics.last().operators]
            cs2 = metrics.last().collectives
            walls = []
            for _ in range(3):
                t1 = time.perf_counter()
                db.query_sql_table(sql)
                walls.append(time.perf_counter() - t1)
        if "shuffle_group" not in ops or "combine_shuffle_group" in ops \
                or not any(op == "all_to_all" for op, _b in cs2):
            raise AssertionError(f"nccl GROUP BY k: not the row shuffle "
                                 f"({ops}, {cs2})")
        occ = np.bincount(ki, minlength=KEY_SLOTS)
        np.testing.assert_array_equal(got["k"], np.flatnonzero(occ))
        np.testing.assert_array_equal(list(got.values())[1], occ[occ > 0])
        log(f"nccl: a torch.distributed NCCL group of ONE rank on cuda:0 "
            f"(backend {dist.get_backend()}, world {dist.get_world_size()}): "
            f"make_global_table {set_up!r} s; GROUP BY quantity (all_gather "
            f"merge) agrees with numpy, collectives {cs}; GROUP BY k "
            f"({'/'.join(ops)}) agrees with numpy in {wall * 1e3!r} ms "
            f"(the first run; median of 3 more {sorted(walls)[1] * 1e3!r} "
            f"ms), collectives {cs2} (one rank; --cards runs one a card) "
            f"[{name}]")
    finally:
        dist.destroy_process_group()


def sync_all() -> None:
    """Wait for every card: in a torch.distributed group, the rank's
    own (its peers' cards are theirs)."""
    if _in_group():
        torch.cuda.synchronize()
        return
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def phase_mesh(WarpDB, HostTable, kernels: dict, name: str, tmp, err: dict,
               data=None, single=None, dimk=None, devices=None) -> dict:
    """MESH_QUERIES over bench.py's table re-laid on ``devices`` (default
    MESH_SHARDS shards of cuda:0; the single-device facade ``single`` on
    cuda:0 alongside), each against NumPy and the single-device result,
    with its launches (K1 once a shard a top-k, K2 in GROUP BY k, K3 in
    each join), collectives and bytes, and the median wall of 5 warm
    runs beside the single-device one; then one more run of the
    statements in MESH_KERNEL_CHECKS, whose kernels are held to their
    plain versions on the first shard's inputs (errors into ``err``).
    Returns the launches of the mesh path."""
    from warpdb_tpu_torch.config import get_config
    from warpdb_tpu_torch.engine.executor import run_expression, \
        run_query_table
    from warpdb_tpu_torch.parallel import (
        ShardedTable,
        data_mesh,
        run_expression_sharded,
    )
    from warpdb_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    if data is None:
        data = make_table()
    if single is None:
        single = WarpDB(HostTable.from_dict(data), device="cuda")
    if dimk is None:
        dimk = make_join_tables()["dimk"]
    devices = devices or ["cuda:0"] * MESH_SHARDS
    mesh = data_mesh(devices=devices)
    mdb = WarpDB(HostTable.from_dict(data), device="cuda").distribute(mesh)
    for db in (mdb, single):
        db.register_table("dimk", HostTable.from_dict(dimk))
    if not isinstance(mdb.table, ShardedTable) or any(
            s.device.type != "cuda" for s in mdb.table.shards):
        raise AssertionError("the mesh table is not sharded on the card")
    g = np.random.default_rng(SEED + 3)
    stream = {"cents": g.integers(0, 10_000, MESH_STREAM_ROWS),
              "quantity": g.integers(0, GROUP_SLOTS, MESH_STREAM_ROWS)}
    stream["price"] = (stream["cents"] / 100).astype(np.float32)
    path = pathlib.Path(tmp) / "mesh_stream.csv"
    write_digit_csv(path, "price,quantity",
                    [lambda s: _cents(stream["cents"][s]),
                     lambda s: [_num(stream["quantity"][s], 2)]],
                    MESH_STREAM_ROWS)
    want = expected_mesh(data, dimk, stream)
    cfg = get_config()
    cfg.join_cache_entries = 0
    log(f"mesh: {ROWS} rows on {mesh.size} shards ({', '.join(devices)}; "
        f"rows {mdb.table.shard_rows}), set-up and NumPy "
        f"{time.perf_counter() - t0:.3f} s")

    routes = {q: MESH_FORCED.get(n) for n, _k, q in MESH_QUERIES}

    def run(db, kind: str, q: str, engine: bool = False):
        """The statement through the facade, or with ``engine`` through
        the engine alone (the timed runs: the facade's Python list of a
        2^25-row result costs the same seconds on both sides); on the
        mesh under its MESH_FORCED route."""
        with forced(routes[q] if db is mdb else None):
            return run_on(db, kind, q, engine)

    def run_on(db, kind: str, q: str, engine: bool):
        drop_join_memos(db)
        if engine and kind == "expr":
            ast = db._parse_expr_query(q)
            if db is mdb:
                return [run_expression_sharded(db.table, *ast)]
            return [run_expression(db.table, *ast)]
        if engine and kind == "sql":
            ast, catalog = db._prepare_sql(q)
            return list(run_query_table(ast, db._base_table(ast, catalog),
                                        catalog).values())
        if kind == "expr":
            return [np.asarray(db.query_sharded(q) if db is mdb
                               else db.query(q))]
        if kind == "stream":
            m = mesh if db is mdb else None
            with metrics.timed_query(q, "sql", MESH_STREAM_ROWS, 0, "cuda:0"):
                out = WarpDB.query_streaming_sql(
                    str(path), q, rows_per_chunk=MESH_STREAM_ROWS // 4,
                    mesh=m, device="cuda")
            return list(out.values())
        return list(db.query_sql_table(q).values())

    total = {k: 0 for k in kernels}
    shard = shard_bytes(mdb.table)
    for n, kind, q in MESH_QUERIES:
        for fn in kernels.values():
            fn.launches = 0
        got, mem = root_memory(lambda: run(mdb, kind, q), mesh.root)
        sync_all()
        launch = {k: fn.launches for k, fn in kernels.items()}
        m = metrics.last()
        ops = [o for o, _h in m.operators]
        cs = {}
        for op, nbytes in m.collectives:
            cs[op] = cs.get(op, 0) + nbytes
        for k, c in launch.items():
            total[k] += c
        if n == "m_topk" and launch["topk"] != mesh.size:
            raise AssertionError(f"m_topk: K1 launched {launch['topk']} "
                                 f"times, not once a shard")
        if n.startswith("m_join") and launch["windowed_expand"] < 1:
            raise AssertionError(f"{n}: K3 did not launch")
        if n == "m_group_k" and launch["group_hist"] < mesh.size:
            raise AssertionError(f"m_group_k: K2 launched "
                                 f"{launch['group_hist']} times, not at "
                                 "least once a shard")
        check_mesh_route(n, ops, cs, launch, mesh.size)
        check_forced_route(n, ops, cs)
        if n in MESH_KERNEL_CHECKS:
            with first_kernel_inputs() as first:
                run(mdb, kind, q)
            check_mesh_kernels(n, first, err, "mesh shard 0")
            del first
        sgot = run(single, kind, q)
        worst = check_mesh(n, got, sgot, want[n])
        ts = {}
        for which, db in (("mesh", mdb), ("single", single)):
            walls = []
            for _ in range(5):
                t1 = time.perf_counter()
                run(db, kind, q, engine=True)
                sync_all()
                walls.append(time.perf_counter() - t1)
            ts[which] = sorted(walls)[2] * 1e3
        launched = {k: c for k, c in launch.items() if c}
        log(f"mesh {n}: agrees with numpy and the single-device result "
            f"(sums within {MESH_RTOL} of float64; largest sum distance from "
            f"single-device {worst!r}); median of 5 warm runs "
            f"{ts['mesh']!r} ms, single-device {ts['single']!r} ms "
            f"({'the facade' if kind == 'stream' else 'the engine'}); "
            "collectives "
            f"{ {op: f'{b} B' for op, b in cs.items()} }; launches {launched}; "
            f"route {'/'.join(dict.fromkeys(ops))}; "
            f"{memory_text(mem, shard, got)} [{name}] — {q}")
    return total


# The statements of the shard routes (parallel/project.py): no column
# of the table crosses the mesh, only partials, compacted rows, unique
# values or registers; m_median's compacted column is its gather.
MESH_NO_GATHER = {"m_hll", "m_global", "m_project", "m_sort",
                  "m_distinct_k", "m_count_distinct", "m_median"}
# m_hll's all_gathers: the GROUP BY merge (3,584 B) and 4 shards x 32
# groups x 4096 one-byte registers (524,288 B), under about 2.1 MB.
MESH_HLL_GATHER_MAX = 2_100_000


def check_mesh_route(name: str, ops: list, cs: dict, launch: dict,
                     shards: int) -> None:
    """The route a shard-route statement must take: no ``mesh_gather``,
    m_hll's gathers within MESH_HLL_GATHER_MAX, K2 once a shard in the
    DISTINCT of the 65536-slot ``k``."""
    if name in MESH_NO_GATHER and "mesh_gather" in ops:
        raise AssertionError(f"{name}: took the gather route ({ops})")
    if name == "m_hll" and cs.get("all_gather", 0) > MESH_HLL_GATHER_MAX:
        raise AssertionError(f"m_hll: all_gather {cs['all_gather']} B")
    if name == "m_distinct_k" and launch["group_hist"] != shards:
        raise AssertionError(f"m_distinct_k: K2 launched "
                             f"{launch['group_hist']} times, not once a "
                             "shard")


def check_forced_route(name: str, ops: list, cs: dict) -> None:
    """A MESH_FORCED statement took its route, through an all_to_all."""
    side = MESH_FORCED.get(name)
    if side is None:
        return
    _t, op, not_op, _k2 = TIER_SIDES[side][2]
    if op not in ops or (not_op is not None and not_op in ops) \
            or not cs.get("all_to_all"):
        raise AssertionError(f"{name}: did not take the {side} ({ops}, "
                             f"collectives {cs})")


def drop_join_memos(db) -> None:
    """Clear the pushdown, count and eager memos of ``db``'s tables, so
    that a run (with the join memo off) joins, and launches its join
    kernels, anew."""
    for t in (db.table, *db._catalog.values()):
        for memo in JOIN_MEMOS:
            getattr(t, memo, {}).clear()


def shard_bytes(table) -> int:
    """The bytes of the first local shard's columns (a tensor named
    twice counted once)."""
    cols = {id(c): c for c in table.shards[0].row_columns().values()}
    return sum(c.numel() * c.element_size() for c in cols.values())


def root_memory(fn, root) -> tuple:
    """``(fn(), (peak, resident))``: ``torch.cuda.max_memory_allocated``
    of the root card during ``fn`` and what was allocated there before
    it."""
    torch.cuda.synchronize(root)
    torch.cuda.reset_peak_memory_stats(root)
    resident = torch.cuda.memory_allocated(root)
    out = fn()
    torch.cuda.synchronize(root)
    return out, (torch.cuda.max_memory_allocated(root), resident)


def memory_text(mem: tuple, shard: int, result: list) -> str:
    """The root card's peak beside the shard's bytes and the result's,
    and the bound 1.25 x (shard + result) on the peak above the
    resident bytes."""
    peak, resident = mem
    out = sum(np.asarray(c).nbytes for c in result)
    return (f"root peak {peak} B (resident before {resident} B, above it "
            f"{peak - resident} B; shard {shard} B, result {out} B, "
            f"1.25 x (shard + result) {int(1.25 * (shard + out))} B)")


def rank_main(rank: int, world: int, port: int) -> int:
    """One rank of ``--cards``: joins the NCCL group on cuda:<rank>,
    ingests its ``host_shard_range`` slice of bench.py's table, and runs
    MESH_QUERIES but the stream SPMD against NumPy (the query's launches
    on this rank's shard: K1 once in the top-k, K3 once in each join)."""
    import torch.distributed as dist

    from warpdb_tpu_torch import WarpDB
    from warpdb_tpu_torch.config import get_config
    from warpdb_tpu_torch.engine.executor import run_query_table
    from warpdb_tpu_torch.ops import expand
    from warpdb_tpu_torch.ops import group_kernel as group
    from warpdb_tpu_torch.ops import topk_kernel as topk
    from warpdb_tpu_torch.parallel import multihost, run_expression_sharded
    from warpdb_tpu_torch.storage import HostTable
    from warpdb_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{port}", world, rank,
                         device=f"cuda:{rank}")
    try:
        mesh = multihost.global_mesh()
        data = make_table()
        dimk = make_join_tables()["dimk"]
        start, end = multihost.host_shard_range(ROWS)
        table = multihost.make_global_table(HostTable.from_dict(
            {c: v[start:end] for c, v in data.items()}), ROWS, mesh)
        db = WarpDB.from_device_table(table, mesh=mesh, name="t")
        db.register_table("dimk", HostTable.from_dict(dimk))
        # Every run joins anew, so that the kernel check's run of a join
        # statement launches K3 again (as the one-process phase does).
        get_config().join_cache_entries = 0
        want = expected_mesh(data, dimk, {"quantity": np.zeros(1, np.int64),
                                          "price": np.zeros(1, np.float32)})
        shard = shard_bytes(table)
        err = {"topk": 0.0, "group_hist": 0.0, "windowed_expand": 0.0}
        log(f"rank {rank}/{world}: rows [{start}, {end}) on cuda:{rank}, "
            f"set-up {time.perf_counter() - t0:.3f} s")
        for n, kind, q in MESH_QUERIES:
            if kind == "stream":
                continue
            with forced(MESH_FORCED.get(n)):
                drop_join_memos(db)
                before = (topk.topk_candidates.launches,
                          expand.windowed_expand.launches,
                          group.group_counts_sums.launches)
                got, mem = root_memory(
                    lambda: ([np.asarray(db.query_sharded(q))]
                             if kind == "expr"
                             else list(db.query_sql_table(q).values())),
                    torch.device(f"cuda:{rank}"))
                torch.cuda.synchronize()
                k1 = topk.topk_candidates.launches - before[0]
                k3 = expand.windowed_expand.launches - before[1]
                k2 = group.group_counts_sums.launches - before[2]
                if n == "m_topk" and k1 != 1:
                    raise AssertionError(f"{n}: K1 launched {k1} times")
                if n.startswith("m_join") and k3 != 1:
                    raise AssertionError(f"{n}: K3 launched {k3} times")
                cs = {}
                for op, nbytes in metrics.last().collectives:
                    cs[op] = cs.get(op, 0) + nbytes
                ops = [o for o, _h in metrics.last().operators]
                check_mesh_route(n, ops, cs, {"group_hist": k2}, 1)
                check_forced_route(n, ops, cs)
                if n in MESH_KERNEL_CHECKS:
                    drop_join_memos(db)
                    with first_kernel_inputs() as first:
                        if kind == "expr":
                            db.query_sharded(q)
                        else:
                            db.query_sql_table(q)
                    check_mesh_kernels(n, first, err, f"rank {rank}")
                    del first
                check_mesh(n, got, got, want[n])
                walls = []
                for _ in range(3):
                    drop_join_memos(db)
                    dist.barrier()
                    t1 = time.perf_counter()
                    if kind == "expr":
                        run_expression_sharded(db.table,
                                               *db._parse_expr_query(q))
                    else:
                        ast, catalog = db._prepare_sql(q)
                        run_query_table(ast, db._base_table(ast, catalog),
                                        catalog)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t1)
                log(f"rank {rank} {n}: agrees with numpy (sums within "
                    f"{MESH_RTOL} of float64); median of 3 runs through the "
                    f"engine {sorted(walls)[1] * 1e3!r} ms; collectives "
                    f"{ {op: f'{b} B' for op, b in cs.items()} }; K1 {k1}, "
                    f"K2 {k2}, K3 {k3}; {memory_text(mem, shard, got)}")
    finally:
        dist.destroy_process_group()
    return 0


def phase_ranks(name: str, world: int, tiers: Optional[list] = None) -> None:
    """The multi-process path across ``world`` cards: ``world`` processes
    of this script (``--rank``; with ``tiers``, ``--tier-rank`` and those
    arguments), one a card, joined in one NCCL group; each must exit 0
    within its time limit."""
    port = _free_port()
    t0 = time.perf_counter()
    flag = "--rank" if tiers is None else "--tier-rank"
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), flag,
         str(r), str(world), str(port), *(tiers or [])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            log(f"  {line} [{name}]" if line.startswith("rank ") else
                f"  rank {r}: {line}")
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}")
    log(f"ranks: an NCCL group of {world} ranks on {world} cards agrees "
        f"with numpy on every {'point' if tiers is not None else 'statement'}"
        f", {time.perf_counter() - t0!r} s")


def phase_profile(run, queries, name: str) -> None:
    """One profiled warm run per slice query (torch.profiler, CPU and
    CUDA activities): profiled wall, card-busy time (the union of the
    device intervals), idle share and the three largest device items."""
    log(f"profile on {name} (profiled wall exceeds the unprofiled one):")
    for kind, n, q in queries:
        run(kind, q)
        torch.cuda.synchronize()
        wall, dev, busy = profiled(lambda: run(kind, q))
        if not dev:
            raise AssertionError(f"profile {n}: no device activity traced")
        by: dict = {}
        for e in dev:
            by[e.name[:50]] = (by.get(e.name[:50], 0.0)
                               + (e.time_range.end - e.time_range.start) / 1e3)
        top = "; ".join(f"{k} {v!r} ms" for k, v in
                        sorted(by.items(), key=lambda x: -x[1])[:3])
        log(f"  profile {n}: wall {wall!r} ms, card busy {busy!r} ms, idle "
            f"{100 * (1 - busy / wall)!r}%; top: {top} [{name}]")


def phase_ptxas(_build) -> None:
    """Registers and spills of each kernel, from ``ptxas -v`` with the
    package's own nvcc flags."""
    for kname in _build.KERNELS:
        out = _build.build_dir() / f"ptxas_{kname}.so"
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out), str(_build.source_path(kname))],
            capture_output=True, text=True, check=True,
        )
        out.unlink()
        entry = ""
        for line in proc.stderr.splitlines():
            if "Compiling entry function" in line:
                # The kernel and its template arguments, unmangled enough
                # to tell the instances apart.
                mangled = line.split("'")[1]
                entry = re.sub(r"^_ZN\d+_GLOBAL__N__.*?_cu_[0-9a-f]{8}\d+",
                               "", mangled)
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {kname} {entry}: {line.strip()}")


# --- The planner's crossovers (--tiers) -----------------------------------
#
# Every routing threshold of the planner (``warpdb_tpu_torch/config.py``,
# the combine's capacity ``parallel/shuffle.py:COMBINE_CAP`` and the join
# pushdown gate ``engine/join_exec.py:PUSHDOWN_*``) timed from both sides:
# each side is forced through ``set_config`` (or the module constant),
# every result is held to NumPy, and K2 to its plain version wherever it
# runs.  The table is bench.py's size (2^25 rows) with one key column per
# slot count, uniform and Zipf(1.3), each spanning exactly its slots.
TIER_BIG = 1 << 30
TIER_KEY_BITS = 24
TIER_GROUP = "SELECT {key}, COUNT(*), SUM(price) FROM t GROUP BY {key}"
TIER_WINDOW = "SELECT SUM(price) OVER (PARTITION BY {key}) FROM t"
# The grouped finish: the midrange tier orders and cuts on the device,
# the dense tier on the host.
TIER_FINISH = ("SELECT {key}, SUM(price) AS s FROM t GROUP BY {key} "
               "ORDER BY s DESC LIMIT 10")
# A sparse composite key: 32 quantities by the key's values under 16,
# 512 occupied tuples in a stats-bounded space of 32 x 2^e (m_group_2key's
# shape; the key's bound ignores the WHERE).
TIER_GROUP2 = ("SELECT quantity, {key}, COUNT(*), SUM(price) FROM t WHERE "
               "{key} < 16 GROUP BY quantity, {key} ORDER BY quantity ASC, "
               "{key} ASC")
# e2e_join_filtered with its WHERE on price (uniform in [0, 100)) cut to
# keep a chosen share of the rows.
TIER_JOIN = ("SELECT SUM(price * rate) FROM t JOIN rates ON quantity = "
             "rates.quantity WHERE price > {cut} GROUP BY quantity ORDER BY "
             "quantity ASC LIMIT 5")
# An expanding join: join_dimk_sum (each probe row meets 0-3 ``dimk``
# rows, K3) with the same WHERE; run with the eager rewrite off, as
# join_dimk_sum is, so that the join expands.
TIER_JOINX = ("SELECT SUM(price * dimk.w) FROM t JOIN dimk ON k = dimk.k "
              "WHERE price > {cut} GROUP BY quantity ORDER BY quantity ASC "
              "LIMIT 5")
# The statement of each kind of sweep.
TIER_QUERIES = {"group": TIER_GROUP, "mesh": TIER_GROUP,
                "mesh2": TIER_GROUP2, "window": TIER_WINDOW,
                "finish": TIER_FINISH, "join": TIER_JOIN,
                "joinx": TIER_JOINX}
_MID = {"dense_group_max_slots": 0, "midrange_group_base_slots": TIER_BIG,
        "midrange_group_max_slots": TIER_BIG}
# side: (config fields, module constants, what the run must show).  What
# it must show: ("ops", operator, operator it must not have, K2 launched),
# ("explain", phrase EXPLAIN names or not, present) or ("pushdown", the
# probe compacted or not).
TIER_SIDES = {
    "dense scatter": ({"dense_group_max_slots": TIER_BIG,
                       "group_hist_max_slots": 0}, {},
                      ("ops", "dense_group", None, False)),
    "dense K2": ({"dense_group_max_slots": TIER_BIG,
                  "group_hist_max_slots": 1 << 16}, {},
                 ("ops", "dense_group", None, True)),
    "midrange K2": ({**_MID, "group_hist_max_slots": 1 << 16}, {},
                    ("ops", "midrange_group", None, True)),
    "midrange scatter": ({**_MID, "group_hist_max_slots": 0}, {},
                         ("ops", "midrange_group", None, False)),
    "sorted": ({"dense_group_max_slots": 0, "midrange_group_max_slots": 0},
               {}, ("ops", "group_sort", None, False)),
    "window dense": ({"dense_group_max_slots": TIER_BIG}, {},
                     ("explain", "DENSE partition broadcast", True)),
    "window sorted": ({"dense_group_max_slots": 0}, {},
                      ("explain", "DENSE partition broadcast", False)),
    "merge": ({"distributed_small_keys": TIER_BIG}, {},
              ("ops", "sharded_group", None, None)),
    "combine": ({"distributed_small_keys": 0},
                {"parallel.shuffle.COMBINE_CAP": TIER_BIG},
                ("ops", "combine_shuffle_group", None, None)),
    "row shuffle": ({"distributed_small_keys": 0},
                    {"parallel.shuffle.COMBINE_CAP": 0},
                    ("ops", "shuffle_group", "combine_shuffle_group", None)),
    "pushdown on": ({"join_filter_pushdown": True},
                    {"engine.join_exec.PUSHDOWN_MAX_SHARE": 1.0,
                     "engine.join_exec.PUSHDOWN_MIN_ROWS": 0},
                    ("pushdown", True)),
    "pushdown off": ({"join_filter_pushdown": False}, {},
                     ("pushdown", False)),
    # TPC-H under each probe floor, the share gate as configured.
    "floor 4096": ({"join_filter_pushdown": True},
                   {"engine.join_exec.PUSHDOWN_MIN_ROWS": 4096}, None),
    "floor 2^25": ({"join_filter_pushdown": True},
                   {"engine.join_exec.PUSHDOWN_MIN_ROWS": 1 << 25}, None),
}
# (threshold, statement kind, sides (the tier below the threshold first),
# sizes: log2 of the slots (of the key tuples for "mesh2"), or the
# pushdown's share in percent, rows).
TIER_SWEEPS = [
    ("dense K2", "group", ("dense scatter", "dense K2"),
     [1, 3, *range(5, 14)], (1 << 20, ROWS)),
    ("window", "window", ("window dense", "window sorted"),
     [5, 7, 9, 11, 12, 13, 14, 16, 18, 20], (ROWS,)),
    ("finish", "finish", ("dense K2", "midrange K2"),
     [5, 7, 9, 10, 11, 12, 13, 14, 16], (ROWS,)),
    ("hist", "group", ("midrange K2", "midrange scatter"),
     list(range(12, 17)), (1 << 20, ROWS)),
    ("midrange", "group", ("midrange scatter", "sorted"),
     list(range(16, 24)), (1 << 16, 1 << 20, 1 << 23, ROWS)),
    # Fewer rows than slots: ``midrange_group_base_slots`` alone decides.
    ("midrange base", "group", ("midrange scatter", "sorted"),
     list(range(17, 24)), (1 << 10, 1 << 12, 1 << 14)),
    ("mesh", "mesh", ("merge", "combine", "row shuffle"),
     list(range(8, 24)), (ROWS,)),
    ("mesh 2key", "mesh2", ("merge", "combine", "row shuffle"),
     list(range(8, 24)), (ROWS,)),
    ("pushdown share", "join", ("pushdown on", "pushdown off"),
     [1, 10, 25, 50, 75, 90], (ROWS,)),
    ("pushdown rows", "join", ("pushdown on", "pushdown off"),
     [1, 10, 50], tuple(1 << e for e in (10, 12, 14, 16, 18, 20, 22, 24,
                                         25))),
    ("pushdown expand", "joinx", ("pushdown on", "pushdown off"),
     [1, 10, 50], tuple(1 << e for e in (12, 16, 18, 20, 22, 24, 25))),
]
# The key bits of a "mesh2" size (32 quantities, GROUP_SLOTS).
TIER_Q_BITS = 5


def tier_data(rows: int, bits, zipf: bool = True) -> dict:
    """``price`` and ``quantity`` as bench.py's, and for each ``e`` in
    ``bits`` a uniform key ``u<e>`` and (with ``zipf``) a Zipf(1.3) key
    ``z<e>`` (``(zipf - 1) mod 2^e``: a quarter of the rows on key 0),
    int32, each spanning exactly 2^e slots (rows 0 and 1 hold its ends,
    so a prefix of the rows keeps the span)."""
    g = np.random.default_rng(SEED + 5)
    d = {"price": g.uniform(0.0, 100.0, rows).astype(np.float32),
         "quantity": g.integers(0, GROUP_SLOTS, rows).astype(np.float32)}
    u = g.integers(0, 1 << TIER_KEY_BITS, rows)
    z = g.zipf(1.3, rows) - 1 if zipf else None
    for e in bits:
        srcs = [("u", u >> (TIER_KEY_BITS - e))]
        if zipf:
            srcs.append(("z", z % (1 << e)))
        for pre, src in srcs:
            col = src.astype(np.int32)
            col[0], col[1] = 0, (1 << e) - 1
            d[f"{pre}{e}"] = col
    # The expanding join's key, as bench.py's ``k``: 2^16 values, f32.
    d["k"] = (u >> (TIER_KEY_BITS - 16)).astype(np.float32)
    return d


@contextlib.contextmanager
def forced(side: Optional[str], **extra):
    """Run the block with ``side``'s configuration fields (through
    ``set_config``), the fields ``extra`` and ``side``'s module
    constants, restored afterwards; ``side`` None: ``extra`` alone."""
    import dataclasses
    import importlib

    from warpdb_tpu_torch import config

    fields, consts, _want = (TIER_SIDES[side] if side is not None
                             else ({}, {}, None))
    fields = {**fields, **extra}
    cfg = config.get_config()
    saved = []
    for path, value in consts.items():
        mod_name, attr = path.rsplit(".", 1)
        mod = importlib.import_module(f"warpdb_tpu_torch.{mod_name}")
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, value)
    config.set_config(dataclasses.replace(cfg, **fields))
    try:
        yield
    finally:
        config.set_config(cfg)
        for mod, attr, value in saved:
            setattr(mod, attr, value)


def tier_engine(db, q: str) -> list:
    """``q`` through the engine (no facade list), every join memo
    dropped first; the result's columns on the host."""
    from warpdb_tpu_torch.engine.executor import run_query_table

    drop_join_memos(db)
    ast, catalog = db._prepare_sql(q)
    return list(run_query_table(ast, db._base_table(ast, catalog),
                                catalog).values())


def _in_group() -> bool:
    """Whether this process is a rank of a torch.distributed group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def tier_time(fn, reps: int) -> tuple:
    """``(engine wall ms, device ms)``, each the median of ``reps`` runs
    (warm: the caller ran ``fn`` first): the host clock from the call to
    its host result, and CUDA events recorded on the root card around
    the call.  The ranks of a group meet at a barrier before each run."""
    import torch.distributed as dist

    walls, devs = [], []
    for _ in range(reps):
        if _in_group():
            dist.barrier()
        sync_all()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        sync_all()
        walls.append((time.perf_counter() - t0) * 1e3)
        devs.append(start.elapsed_time(end))
    return sorted(walls)[reps // 2], sorted(devs)[reps // 2]


class TierWant:
    """NumPy's answers, memoised by key column and rows."""

    def __init__(self, data: dict, joins: dict):
        self.data, self.joins, self.memo = data, joins, {}
        # (mesh, key, rows) at which K2 was held to its plain version.
        self.k2_held: set = set()

    def group(self, key: str, rows: int) -> tuple:
        if (key, rows) not in self.memo:
            k = self.data[key][:rows].astype(np.int64)
            p = self.data["price"][:rows].astype(np.float64)
            cnt = np.bincount(k)
            occ = np.flatnonzero(cnt)
            self.memo[(key, rows)] = (occ, cnt[occ],
                                      np.bincount(k, weights=p)[occ])
        return self.memo[(key, rows)]

    def group2(self, key: str, rows: int) -> tuple:
        """TIER_GROUP2's answer: quantity, key, count and float64 sum of
        each occupied (quantity, key < 16) tuple, in key order."""
        if ("2key", key, rows) not in self.memo:
            k = self.data[key][:rows].astype(np.int64)
            q = self.data["quantity"][:rows].astype(np.int64)
            p = self.data["price"][:rows].astype(np.float64)
            keep = k < 16
            pid = q[keep] * 16 + k[keep]
            cnt = np.bincount(pid, minlength=GROUP_SLOTS * 16)
            occ = np.flatnonzero(cnt)
            sums = np.bincount(pid, weights=p[keep],
                               minlength=GROUP_SLOTS * 16)
            self.memo[("2key", key, rows)] = (occ // 16, occ % 16, cnt[occ],
                                              sums[occ])
        return self.memo[("2key", key, rows)]

    def finish(self, key: str, rows: int) -> tuple:
        """Every occupied key and its float64 sum, and the ten largest
        sums in descending order."""
        occ, _cnt, sums = self.group(key, rows)
        return occ, sums, np.sort(sums)[::-1][:10]

    def window(self, key: str, rows: int) -> np.ndarray:
        if ("window", key, rows) not in self.memo:
            k = self.data[key][:rows].astype(np.int64)
            p = self.data["price"][:rows].astype(np.float64)
            self.memo[("window", key, rows)] = np.bincount(k, weights=p)[k]
        return self.memo[("window", key, rows)]

    def join(self, kind: str, cut: float, rows: int) -> np.ndarray:
        """TIER_JOIN's (``kind`` "join") or TIER_JOINX's ("joinx") five
        sums: per quantity, the float64 sum over the matching rows."""
        p = self.data["price"][:rows]
        q = self.data["quantity"][:rows].astype(np.int64)
        hot = p > np.float32(cut)
        if kind == "join":
            rate = self.joins["rates"]["rate"].astype(np.float64)
            w = p.astype(np.float64) * rate[q]
        else:
            dk = self.joins["dimk"]["k"].astype(np.int64)
            wk = np.bincount(dk, weights=self.joins["dimk"]["w"].astype(
                np.float64), minlength=DIMK_KEYS)
            k = self.data["k"][:rows].astype(np.int64)
            hot &= (np.bincount(dk, minlength=DIMK_KEYS) > 0)[k]
            w = p.astype(np.float64) * wk[k]
        filt = np.bincount(q[hot], weights=w[hot], minlength=GROUP_SLOTS)
        present = np.bincount(q[hot], minlength=GROUP_SLOTS) > 0
        return filt[present][:5]


def tier_check(what: str, kind: str, got: list, want: TierWant, key: str,
               size: int, rows: int) -> None:
    """Keys and counts exactly, sums within SUM_RTOL of float64."""
    def exact(col, ref, label):
        np.testing.assert_array_equal(np.asarray(col).astype(np.int64), ref,
                                      err_msg=f"{what}: {label}")

    if kind in ("group", "mesh", "mesh2"):
        *keys, cnt, sums = (want.group(key, rows) if kind != "mesh2"
                            else want.group2(key, rows))
        for i, ref in enumerate(keys):
            exact(got[i], ref, f"key {i}")
        exact(got[len(keys)], cnt, "counts")
        np.testing.assert_allclose(np.asarray(got[len(keys) + 1],
                                              dtype=np.float64),
                                   sums, rtol=SUM_RTOL, err_msg=what)
    elif kind == "finish":
        # Near-equal sums may trade places in f32: the ten sums are
        # NumPy's ten largest, and each key's sum is NumPy's for it.
        occ, sums, top = want.finish(key, rows)
        keys = np.asarray(got[0]).astype(np.int64)
        vals = np.asarray(got[1], dtype=np.float64)
        np.testing.assert_allclose(vals, top, rtol=SUM_RTOL, err_msg=what)
        np.testing.assert_allclose(vals, sums[np.searchsorted(occ, keys)],
                                   rtol=SUM_RTOL, err_msg=f"{what}: keys")
    elif kind == "window":
        np.testing.assert_allclose(np.asarray(got[0], dtype=np.float64),
                                   want.window(key, rows), rtol=SUM_RTOL,
                                   err_msg=what)
    else:
        w = want.join(kind, 100.0 - size, rows)
        np.testing.assert_allclose(np.asarray(got[0], dtype=np.float64), w,
                                   rtol=SUM_RTOL, err_msg=what)


def tier_shows(side: str, db, q: str, ops: list, k2: int) -> bool:
    """Whether the run (its operators ``ops``, ``k2`` K2 launches) took
    ``side``'s tier."""
    want = TIER_SIDES[side][2]
    if want[0] == "ops":
        _t, op, not_op, k2_want = want
        return (op in ops and (not_op is None or not_op not in ops)
                and (k2_want is None or (k2 > 0) == k2_want))
    if want[0] == "explain":
        return (want[1] in db.explain(q)) == want[2]
    return bool(getattr(db.table, "_prefilter_memo", None)) == want[1]


def tier_key(kind: str, size: int, dist: str) -> str:
    """The key column of a point: ``u<bits>`` or ``z<bits>``."""
    return f"{dist[0]}{size - TIER_Q_BITS if kind == 'mesh2' else size}"


def tier_point(db, sweep: str, kind: str, side: str, size: int, rows: int,
               dist: str, want: TierWant, reps: int, err: dict,
               force: bool = True, root=None) -> tuple:
    """One statement at one size under ``side`` (forced, or with
    ``force=False`` the default configuration, which must take
    ``side``'s tier): held to NumPy and to its tier, K2 (where it runs)
    to its plain version on the inputs the path gave it, once for each
    key, rows and table kind (``want.k2_held``); returns ``(engine wall
    ms, device ms, K2 launches of the checked run, the root card's peak
    bytes above its resident bytes in the checked run)``.  ``root``:
    the card that gathers (default cuda:0)."""
    from warpdb_tpu_torch.ops import group_kernel as group
    from warpdb_tpu_torch.utils import metrics

    key = tier_key(kind, size, dist)
    q = TIER_QUERIES[kind].format(key=key, cut=100.0 - size)
    what = (f"tiers {sweep} {side}{'' if force else ' (default)'} "
            f"size={size} rows={rows} {dist}")
    extra = {"eager_join_aggregation": False} if kind == "joinx" else {}
    with forced(side if force else None, **extra):
        before = group.group_counts_sums.launches
        with metrics.timed_query(q, "sql", rows, 0, "cuda:0"):
            got, (peak, resident) = root_memory(
                lambda: tier_engine(db, q), root or torch.device("cuda:0"))
        sync_all()
        k2 = group.group_counts_sums.launches - before
        ops = [o for o, _h in metrics.last().operators]
        tier_check(what, kind, got, want, key, size, rows)
        if not tier_shows(side, db, q, ops, k2):
            raise AssertionError(f"{what}: did not take {side} ({ops}, "
                                 f"K2 {k2})")
        held = (kind in ("mesh", "mesh2"), key, rows)
        if k2 and held not in want.k2_held:
            want.k2_held.add(held)
            with first_kernel_inputs() as first:
                tier_engine(db, q)
            a = first["group_hist"]
            _check_group(group, a[0].cpu().numpy(), a[0],
                         [v.cpu().numpy() for v in a[1]], list(a[1]), a[2],
                         what, err, {})
            del first, a
        wall, dev = tier_time(lambda: tier_engine(db, q), reps)
    return wall, dev, k2, peak - resident


def tier_default(sweep: str, size: int, rows: int, data: dict) -> str:
    """The side the default configuration takes at ``size`` over the
    uniform key of ``data`` (a mesh: by the distinct keys each of
    MESH_SHARDS row ranges holds)."""
    from warpdb_tpu_torch.config import get_config
    from warpdb_tpu_torch.engine import join_exec
    from warpdb_tpu_torch.parallel import shuffle

    cfg = get_config()
    s = 1 << size
    if sweep == "dense K2":
        return "dense K2" if s <= cfg.group_hist_max_slots else "dense scatter"
    if sweep == "window":
        return ("window dense" if s <= cfg.dense_group_max_slots
                else "window sorted")
    if sweep in ("hist", "midrange", "midrange base", "finish"):
        if s <= cfg.dense_group_max_slots:
            return ("dense K2" if s <= cfg.group_hist_max_slots
                    else "dense scatter")
        if s > cfg.midrange_group_base_slots and (
                s > cfg.midrange_group_max_slots or s > rows):
            return "sorted"
        return ("midrange K2" if s <= cfg.group_hist_max_slots
                else "midrange scatter")
    if sweep in ("mesh", "mesh 2key"):
        if s <= cfg.distributed_small_keys:
            return "merge"
        k = data[tier_key("mesh2" if sweep == "mesh 2key" else "mesh",
                          size, "uniform")][:rows].astype(np.int64)
        if sweep == "mesh 2key":
            q = data["quantity"][:rows].astype(np.int64)
            k = np.where(k < 16, q * 16 + k, -1)
        held = max(np.count_nonzero(np.bincount(part[part >= 0]))
                   for part in np.array_split(k, MESH_SHARDS))
        return "combine" if held <= shuffle.COMBINE_CAP else "row shuffle"
    return ("pushdown on" if size <= 100 * join_exec.PUSHDOWN_MAX_SHARE
            and rows >= join_exec.PUSHDOWN_MIN_ROWS else "pushdown off")


def tier_checks() -> list:
    """The default run's sweeps: one size on each side of each default
    (``TIER_SWEEPS``' form, uniform keys), and the side the default
    configuration must take at each."""
    from warpdb_tpu_torch.config import get_config
    from warpdb_tpu_torch.engine import join_exec
    from warpdb_tpu_torch.parallel import shuffle

    cfg = get_config()

    def lg(n: int) -> int:
        return int(n).bit_length() - 1

    d, h = lg(cfg.dense_group_max_slots), lg(cfg.group_hist_max_slots)
    b, m = lg(cfg.midrange_group_base_slots), lg(cfg.midrange_group_max_slots)
    s, c = lg(cfg.distributed_small_keys), lg(shuffle.COMBINE_CAP)
    share = round(100 * join_exec.PUSHDOWN_MAX_SHARE)
    floor = join_exec.PUSHDOWN_MIN_ROWS
    return [
        ("dense K2", "group", ("dense scatter", "dense K2"), [5], (ROWS,)),
        ("window", "window", ("window dense", "window sorted"), [d, d + 1],
         (ROWS,)),
        ("finish", "finish", ("dense K2", "midrange K2"), [d, d + 1],
         (ROWS,)),
        ("hist", "group", ("midrange K2", "midrange scatter"), [h, h + 1],
         (ROWS,)),
        ("midrange base", "group", ("midrange scatter", "sorted"),
         [b, b + 1], (1 << b,)),
        ("midrange", "group", ("midrange scatter", "sorted"), [m, m + 1],
         (ROWS,)),
        *([("mesh", "mesh", ("merge", "combine", "row shuffle"),
            [s, s + 1], (ROWS,))] if s == c else
          [("mesh", "mesh", ("merge", "combine"), [s, s + 1], (ROWS,)),
           ("mesh", "mesh", ("combine", "row shuffle"), [c, c + 1],
            (ROWS,))]),
        ("pushdown share", "join", ("pushdown on", "pushdown off"),
         [max(share - 5, 1), min(share + 5, 99)], (ROWS,)),
        ("pushdown rows", "join", ("pushdown on", "pushdown off"), [10],
         (floor // 2, floor)),
    ]


MESH_KINDS = ("mesh", "mesh2")


def phase_tiers(WarpDB, HostTable, name: str, err: dict, full: bool,
                select=None, table_for=None, root=None,
                quiet: bool = False) -> int:
    """The planner's thresholds from both sides (``TIER_SWEEPS`` with
    ``full``, uniform and Zipf keys, median of 5 warm runs, then TPC-H
    under both pushdown floors; else ``tier_checks``: one size on each
    side of each default, uniform keys, one timed run, and the default
    configuration's own tier at each).  ``select``: the names of the
    sweeps to run (None: all).  The mesh is four shards of cuda:0, or
    with ``table_for(columns)`` (the facade over a table this rank's
    group holds, ``--tier-rank``) the group, and then only the mesh
    sweeps run.  ``root``: the card that gathers.  ``quiet``: check
    every point, print none (the ranks but the first).  Returns K2's
    launches in the checked runs."""
    from warpdb_tpu_torch.config import get_config
    from warpdb_tpu_torch.parallel import data_mesh

    say = (lambda _m: None) if quiet else log
    t0 = time.perf_counter()
    sweeps = TIER_SWEEPS if full else tier_checks()
    if select is not None:
        sweeps = [s for s in sweeps if s[0] in select]
    meshed_only = table_for is not None
    if meshed_only:
        sweeps = [s for s in sweeps if s[1] in MESH_KINDS]
    dists = ("uniform", "zipf") if full else ("uniform",)
    reps = 5 if full else 1
    single = {e for sw in sweeps if sw[1] in ("group", "window", "finish")
              for e in sw[3]}
    meshed = {e - (TIER_Q_BITS if sw[1] == "mesh2" else 0)
              for sw in sweeps if sw[1] in MESH_KINDS for e in sw[3]}
    data = tier_data(ROWS, sorted(single | meshed), zipf=full)
    joins = make_join_tables()
    want = TierWant(data, joins)
    get_config().join_cache_entries = 0
    dbs: dict = {}

    def db_for(kind: str, rows: int):
        """The sweep's table: the first ``rows`` rows of ``price``,
        ``quantity`` and the key columns of its kind (a mesh: over the
        mesh's shards; else with ``k`` and the join tables)."""
        mkind = kind in MESH_KINDS
        if (mkind, rows) not in dbs:
            bits = meshed if mkind else single
            cols = {c: v[:rows] for c, v in data.items()
                    if c in ("price", "quantity") or (
                        c == "k" and not mkind) or (
                        c != "k" and int(c[1:]) in bits)}
            if table_for is not None:
                db = table_for(cols)
            else:
                db = WarpDB(HostTable.from_dict(cols), device="cuda")
            if mkind and table_for is None:
                db = db.distribute(data_mesh(
                    devices=["cuda:0"] * MESH_SHARDS))
            elif not mkind:
                for t in ("rates", "dimk"):
                    db.register_table(t, HostTable.from_dict(joins[t]))
            dbs[(mkind, rows)] = db
        return dbs[(mkind, rows)]

    say(f"tiers: {ROWS} rows, key columns 2^{min(single | meshed, default=0)}"
        f"..2^{max(single | meshed, default=0)} slots ({', '.join(dists)}), "
        f"set-up {time.perf_counter() - t0:.3f} s")
    k2_total = 0
    res: dict = {}
    for sweep, kind, sides, sizes, rows_list in sweeps:
        for rows in rows_list:
            db = db_for(kind, rows)
            for size in sizes:
                ds = dists if kind not in ("join", "joinx") else ("uniform",)
                for dist in ds:
                    line = []
                    for side in sides:
                        if "K2" in side and size > 16:
                            continue
                        wall, dev, k2, mem = tier_point(
                            db, sweep, kind, side, size, rows, dist, want,
                            reps, err, root=root)
                        k2_total += k2
                        res[(sweep, size, rows, dist, side)] = (wall, dev,
                                                                mem)
                        line.append(f"{side} wall {wall!r} ms device "
                                    f"{dev!r} ms root +{mem} B")
                    if not full and dist == "uniform":
                        side = tier_default(sweep, size, rows, data)
                        _w, _d, k2, _m = tier_point(
                            db, sweep, kind, side, size, rows, dist, want, 1,
                            err, force=False, root=root)
                        k2_total += k2
                        line.append(f"default takes {side}")
                    unit = ("%" if kind in ("join", "joinx") else
                            " (log2 key tuples)" if kind == "mesh2" else
                            " (log2 slots)")
                    say(f"tiers {sweep} size {size}{unit} rows {rows} "
                        f"{dist}: {'; '.join(line)}; agrees with numpy "
                        f"[{name}]")
    if full:
        tier_summary(sweeps, dists, res, name, say)
    for db in dbs.values():
        drop_join_memos(db)
    dbs.clear()
    torch.cuda.empty_cache()
    if full and not meshed_only and (select is None
                                     or "tpch pushdown" in select):
        tier_tpch(WarpDB, HostTable, name)
    say(f"tiers phase: {time.perf_counter() - t0!r} s")
    return k2_total


def tier_summary(sweeps, dists, res: dict, name: str, say=log) -> None:
    """Per sweep and rows (the pushdown's row sweeps: across their
    rows), each size's wall ratio of the second side to the first on
    each key mix, and the smallest size from which the second side
    beats the first on every mix there and at every larger size (engine
    wall, medians)."""
    for sweep, kind, sides, sizes, rows_list in sweeps:
        ds = dists if kind not in ("join", "joinx") else ("uniform",)
        by_rows = sweep in ("pushdown rows", "pushdown expand")
        if by_rows:
            series = [[(f"{r} rows", s, r) for r in rows_list]
                      for s in sizes]
        else:
            series = [[(str(s), s, r) for s in sizes] for r in rows_list]
        for lo, hi in zip(sides, sides[1:]):
            for points in series:
                ratios, wins = [], []
                for label, size, rows in points:
                    pair = [(res.get((sweep, size, rows, d, hi)),
                             res.get((sweep, size, rows, d, lo)))
                            for d in ds]
                    if any(a is None or b is None for a, b in pair):
                        continue
                    r = [a[0] / b[0] for a, b in pair]
                    ratios.append(f"{label}: " + "/".join(f"{x:.3f}"
                                                          for x in r))
                    # Up the rows the pushdown (the first side) gains.
                    wins.append((label, all((x > 1.0) if by_rows
                                            else (x < 1.0) for x in r)))
                cross = None
                for label, won in reversed(wins):
                    if not won:
                        break
                    cross = label
                where = (f"size {points[0][1]}" if by_rows
                         else f"{points[0][2]} rows")
                say(f"tiers summary {sweep}: {hi} over {lo} at {where} "
                    f"(wall ratio {hi}/{lo}, {'/'.join(ds)}): "
                    f"{', '.join(ratios)}; {lo if by_rows else hi} wins "
                    f"from {'none' if cross is None else cross} on "
                    f"[{name}]")


def tier_tpch(WarpDB, HostTable, name: str) -> None:
    """TPC-H's 22 queries at ``TPCH_ROWS`` lineitem rows under each probe
    floor of the join pushdown, the reference's 4096 rows and 2^25 (the
    share gate as configured): each result against the suite's oracle,
    the K5 launches (each compaction gathers by K5) and the median of 5
    warm runs through ``query_sql_table``, the floors alternating, every
    memo dropped before each run; then the medians' sums."""
    from warpdb_tpu_torch.ops import expand

    t0 = time.perf_counter()
    tpch = load_tpch()
    tables = tpch.make_tables(TPCH_ROWS, seed=TPCH_SEED)
    db = WarpDB(HostTable.from_dict(tables["lineitem"]), device="cuda")
    db.register_table("lineitem", db.table)
    for tname in ("orders", "customer", "supplier", "nation", "region",
                  "part", "partsupp"):
        db.register_table(tname, HostTable.from_dict(tables[tname]))
    log(f"tiers tpch: {TPCH_ROWS} lineitem rows, set-up "
        f"{time.perf_counter() - t0:.3f} s")

    def run(sql):
        for t in (db.table, *db._catalog.values()):
            for memo in JOIN_MEMOS + SUBQUERY_MEMOS:
                getattr(t, memo, {}).clear()
        getattr(db, "_cte_memo", {}).clear()
        out = db.query_sql_table(sql)
        torch.cuda.synchronize()
        return out

    sides = ("floor 4096", "floor 2^25")
    total = {s: 0.0 for s in sides}
    for q, sql in tpch.QUERIES.items():
        want = tpch.oracle(tables, q)
        k5, walls = {}, {s: [] for s in sides}
        for side in sides:
            with forced(side):
                before = expand.sorted_take.launches
                tpch.check_results(q, run(sql), want)
                k5[side] = expand.sorted_take.launches - before
        for i in range(5):
            for side in (sides if i % 2 == 0 else sides[::-1]):
                with forced(side):
                    t1 = time.perf_counter()
                    run(sql)
                    walls[side].append((time.perf_counter() - t1) * 1e3)
        meds = {s: sorted(w)[2] for s, w in walls.items()}
        for s in sides:
            total[s] += meds[s]
        log(f"tiers tpch {q}: " + "; ".join(
            f"{s} median {meds[s]!r} ms, K5 {k5[s]}" for s in sides)
            + f"; agrees with the oracle [{name}]")
    log("tiers tpch: the 22 medians summed: " + "; ".join(
        f"{s} {total[s]!r} ms" for s in sides) + f" [{name}]")


def tier_rank_main(rank: int, world: int, port: int, select) -> int:
    """One rank of ``--tiers --cards``: joins the NCCL group on
    cuda:<rank> and runs the mesh sweeps of TIER_SWEEPS over tables of
    which it holds its ``host_shard_range`` slice, one shard a card;
    every rank checks every point, the first prints them."""
    import torch.distributed as dist

    from warpdb_tpu_torch import WarpDB
    from warpdb_tpu_torch.parallel import multihost
    from warpdb_tpu_torch.storage import HostTable

    multihost.initialize(f"127.0.0.1:{port}", world, rank,
                         device=f"cuda:{rank}")
    try:
        mesh = multihost.global_mesh()

        def table_for(cols: dict):
            rows = len(cols["price"])
            start, end = multihost.host_shard_range(rows)
            table = multihost.make_global_table(HostTable.from_dict(
                {c: v[start:end] for c, v in cols.items()}), rows, mesh)
            return WarpDB.from_device_table(table, mesh=mesh, name="t")

        err = {"group_hist": 0.0}
        name = card()
        phase_tiers(WarpDB, HostTable, f"rank {rank}/{world}, one shard a "
                    f"card, {name}", err, full=True, select=select,
                    table_for=table_for, root=torch.device(f"cuda:{rank}"),
                    quiet=rank != 0)
        log(f"rank {rank} tiers: every point agrees with numpy; K2 against "
            f"its plain version wherever it ran: max abs err "
            f"{err['group_hist']!r}")
    finally:
        dist.destroy_process_group()
    return 0


def sweep_names(argv: list) -> Optional[list]:
    """The sweeps ``--sweep=NAME,...`` names (``-`` for a space), or
    None for all."""
    picked = [a.split("=", 1)[1] for a in argv if a.startswith("--sweep=")]
    if not picked:
        return None
    names = [n.replace("-", " ") for a in picked for n in a.split(",")]
    known = {s[0] for s in TIER_SWEEPS} | {"tpch pushdown"}
    if set(names) - known:
        raise SystemExit(f"chip_smoke: unknown sweeps "
                         f"{sorted(set(names) - known)}; known: "
                         f"{sorted(known)}")
    return names


def main(argv: list) -> int:
    if argv[:1] == ["--rank"] and len(argv) == 4:
        return rank_main(*map(int, argv[1:]))
    if argv[:1] == ["--tier-rank"] and len(argv) >= 4:
        return tier_rank_main(*map(int, argv[1:4]), sweep_names(argv[4:]))
    profile = "--profile" in argv
    kernels_only = "--kernels" in argv
    stream_only = "--stream" in argv
    mesh_only = "--mesh" in argv
    cards = "--cards" in argv
    tiers = "--tiers" in argv
    select = sweep_names(argv)
    if set(a for a in argv if not a.startswith("--sweep=")) - {
            "--profile", "--kernels", "--stream", "--mesh", "--cards",
            "--tiers"} or (select is not None and not tiers):
        print("usage: python3 chip_smoke.py [--profile | --kernels | "
              "--stream | --mesh | --cards | --tiers [--cards] "
              "[--sweep=NAME,...]]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    if cards and torch.cuda.device_count() < 2:
        print("chip_smoke --cards: needs several CUDA devices",
              file=sys.stderr)
        return 2
    from warpdb_tpu_torch import WarpDB, _build
    from warpdb_tpu_torch.config import get_config
    from warpdb_tpu_torch.ops import expand
    from warpdb_tpu_torch.ops import group_kernel as group
    from warpdb_tpu_torch.ops import topk_kernel as topk
    from warpdb_tpu_torch.storage import DeviceTable, HostTable

    name = card()
    log(f"card: {name}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc {' '.join(_build.NVCC_FLAGS[:2])}) "
        + ", ".join(f"{k}={v}" for k, v in libs.items()))
    kernels = {"topk": topk.topk_candidates,
               "group_hist": group.group_counts_sums,
               "windowed_expand": expand.windowed_expand,
               "uniform_expand": expand.uniform_expand,
               "sorted_take": expand.sorted_take}
    if tiers and cards:
        phase_ranks(name, torch.cuda.device_count(),
                    tiers=[a for a in argv if a.startswith("--sweep=")])
    elif tiers:
        terr = {"group_hist": 0.0}
        phase_tiers(WarpDB, HostTable, name, terr, full=True, select=select)
        log(f"tiers: K2 against its plain version wherever it ran: max "
            f"abs err {terr['group_hist']!r}")
    if tiers:
        print(name)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    if mesh_only or cards:
        with tempfile.TemporaryDirectory(prefix="warpdb_mesh_") as tmp:
            t0 = time.perf_counter()
            n = torch.cuda.device_count()
            merr = {k: 0.0 for k in kernels}
            phase_mesh(WarpDB, HostTable, kernels, name, tmp, merr,
                       devices=[f"cuda:{i}" for i in range(n)]
                       if cards else None)
            log("mesh kernels against their plain versions: max abs err "
                + str({k: merr[k] for k in ("topk", "group_hist",
                                            "windowed_expand")}))
            if cards:
                phase_ranks(name, n)
            else:
                phase_nccl(HostTable, make_table(), name)
            log(f"mesh phase: {time.perf_counter() - t0!r} s")
        print(name)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    if stream_only:
        with tempfile.TemporaryDirectory(prefix="warpdb_stream_") as tmp, \
                native_library(pathlib.Path(tmp)) as t_native:
            log(f"streaming: native CSV library built in {t_native!r} s")
            _l, srun, sq, _e, chunk = phase_streaming(
                WarpDB, HostTable, kernels, make_join_tables()["dimk"], name,
                pathlib.Path(tmp))
            if profile:
                phase_profile(srun, sq, name)
        phase_uploads({
            "bench 2^25 rows": DeviceTable.from_host(
                HostTable.from_dict(make_table()), device="cpu"),
            "stream chunk": DeviceTable.from_host(chunk, device="cpu")}, name)
        return 0

    # With --profile the kernel phase opens no profiler session: after
    # those sessions, every later one of a --profile run traced no device
    # activity (the query profiles, 2^25 rows, NVIDIA H100 80GB HBM3).
    err, kms, others = phase_kernels(topk, group, device_times=not profile)
    xerr, xms = phase_expand_kernels(expand)
    err.update(xerr)
    kms.update(xms)
    torch.cuda.empty_cache()
    log(f"kernel timing on {name} (CUDA events, mean of 20 launches; "
        f"bound at {HBM_TB_S} TB/s):")
    for kname, t in kms.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']!r} ms"
        extra = ""
        if "alone_ms" in t:
            extra += f", kernel alone {t['alone_ms']!r} ms"
        if "profiler_ms" in t:
            extra += f", profiler device time {t['profiler_ms']!r} ms"
        log(f"  {kname} {t['shape']}: kernel {t['ms']!r} ms, plain "
            f"{t['plain_ms']!r} ms, library {lib}, bound {t['bound_ms']!r} "
            f"ms = {100 * t['bound_ms'] / t['ms']!r}%{extra} [{name}]")
    log(f"K1/K2 at other inputs on {name} (n={ROWS}; CUDA events, mean of "
        "20 calls; profiler device time of the kernels a call; bound):")
    for what, ev, dev, bd in others:
        share = "" if dev is None else f" = {100 * bd / dev!r}% of the device time"
        log(f"  {what}: events {ev!r} ms, device {dev!r} ms, bound {bd!r} ms"
            f"{share} [{name}]")
    if kernels_only:
        phase_ptxas(_build)
        return 0
    phase_inf_group(WarpDB, HostTable, group)

    t0 = time.perf_counter()
    data = make_table()
    host = HostTable.from_dict(data)
    db = WarpDB(host, device="cuda")
    want = expected(data)
    log(f"table: {ROWS} rows on {db.device}, set-up {time.perf_counter() - t0:.3f} s")

    cfg = get_config()

    def run(kind: str, q: str):
        if kind == "expr":
            return db.query_np(q)
        # The join memo is off (below); the pushdown, count and eager
        # memos on the tables are dropped too, so that every run filters,
        # compacts and pre-aggregates anew.
        for t in (db.table, *db._catalog.values()):
            for memo in JOIN_MEMOS:
                getattr(t, memo, {}).clear()
        cfg.eager_join_aggregation = kind != "sql-no-eager"
        try:
            return db.query_sql(q)
        finally:
            cfg.eager_join_aggregation = True

    queries = [("expr", n, q) for n, q in EXPR_QUERIES] + [
        ("sql", n, q) for n, q in SQL_QUERIES
    ]

    def run_counted(qs) -> tuple:
        """Each query's result and the kernel launches it made."""
        res, per = {}, {}
        for kind, n, q in qs:
            before = {k: fn.launches for k, fn in kernels.items()}
            res[n] = run(kind, q)
            per[n] = {k: fn.launches - before[k] for k, fn in kernels.items()
                      if fn.launches > before[k]}
        return res, per

    topk.topk_candidates.launches = 0
    group.group_counts_sums.launches = 0
    results, per_query = run_counted(queries)
    torch.cuda.synchronize()
    launches = {"topk": topk.topk_candidates.launches,
                "group_hist": group.group_counts_sums.launches}
    for kind, n, q in queries:
        e = check(n, results[n], want[n])
        log(f"slice {n}: agrees with numpy ({len(results[n])} values, "
            f"max abs err {e!r}; launches {per_query[n]}) — {q}")
    for k, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {k} was not launched by the slice")
    log(f"slice launches: {launches}")

    # The join phase.  The join memo stays off from here on, so that every
    # run (and every timed run) materialises its joins; ``run`` drops the
    # other join memos before each run.
    t0 = time.perf_counter()
    jtabs = make_join_tables()
    for tname, tcols in jtabs.items():
        db.register_table(tname, HostTable.from_dict(tcols))
    jwant = expected_joins(data, jtabs)
    cfg.join_cache_entries = 0
    log(f"join tables: rates 32, dup 64, dimk {len(jtabs['dimk']['k'])} rows "
        f"on the card, set-up {time.perf_counter() - t0:.3f} s")
    join_queries = [("sql" if eager else "sql-no-eager", n, q)
                    for n, q, eager in JOIN_QUERIES]
    for fn in (expand.windowed_expand, expand.uniform_expand,
               expand.sorted_take):
        fn.launches = 0
    jres, per_query = run_counted(join_queries)
    torch.cuda.synchronize()
    # K1 and K2 count on from the slice phase; K3-K5 from 0.
    launches = {k: fn.launches for k, fn in kernels.items()}
    for kind, n, q in join_queries:
        e = check(n, jres[n], jwant[n])
        log(f"join {n}: agrees with numpy ({len(jres[n])} values, max abs "
            f"err {e!r}; launches {per_query[n]}) — {q}" + (" [eager rewrite off]"
                                   if kind == "sql-no-eager" else ""))
    for k in ("windowed_expand", "uniform_expand", "sorted_take"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the joins")
    log("join launches: " + str({k: launches[k] for k in (
        "windowed_expand", "uniform_expand", "sorted_take")}))
    del jres

    log(f"timing on {name}:")
    for kind, n, q in queries + join_queries:
        ts = []
        run(kind, q)
        for _ in range(5):
            t0 = time.perf_counter()
            run(kind, q)
            ts.append(time.perf_counter() - t0)
        log(f"  query {n}: median {sorted(ts)[2] * 1e3!r} ms over 5 warm runs "
            f"[{name}]")

    win_launches, win_run, win_queries = phase_windows(db, data, kernels,
                                                       name)
    for k, c in win_launches.items():
        launches[k] += c

    tpch_launches, tpch_run, tpch_queries, tdb, ttables = phase_tpch(
        WarpDB, HostTable, kernels, name)
    for k, c in tpch_launches.items():
        launches[k] += c

    t0 = time.perf_counter()
    surf_launches = phase_surfaces(db, data, host, tdb, ttables, kernels,
                                   name)
    for k, c in surf_launches.items():
        launches[k] += c
    log(f"surfaces phase: {time.perf_counter() - t0!r} s")

    # The stream's files and the native library live in a directory of
    # their own, removed at the end (about 0.5 GB).
    with tempfile.TemporaryDirectory(prefix="warpdb_stream_") as tmp, \
            native_library(pathlib.Path(tmp)) as t_native:
        log(f"streaming: native CSV library built in {t_native!r} s")
        (stream_launches, stream_run, stream_queries, serr,
         chunk) = phase_streaming(WarpDB, HostTable, kernels, jtabs["dimk"],
                                  name, pathlib.Path(tmp))
        for k, c in stream_launches.items():
            launches[k] += c
        for k, e in serr.items():
            err[k] = max(err[k], e)
        if profile:
            phase_profile(stream_run, stream_queries, name)
    phase_uploads({"bench 2^25 rows": db.table,
                   "stream chunk": DeviceTable.from_host(chunk, device="cpu"),
                   **{f"tpch {t}": tdb._catalog[t] for t in ttables}}, name)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="warpdb_mesh_") as tmp:
        mesh_launches = phase_mesh(WarpDB, HostTable, kernels, name, tmp,
                                   err, data=data, single=db,
                                   dimk=jtabs["dimk"])
        phase_nccl(HostTable, data, name)
    for k, c in mesh_launches.items():
        launches[k] += c
    log(f"mesh phase: {time.perf_counter() - t0!r} s")

    launches["group_hist"] += phase_tiers(WarpDB, HostTable, name, err,
                                          full=False)

    if profile:
        phase_profile(run, queries + join_queries, name)
        phase_profile(win_run, win_queries, name)
        phase_profile(tpch_run, tpch_queries, name)
        phase_ptxas(_build)

    for mod in ("jax", "warpdb_tpu"):
        if mod in sys.modules:
            raise AssertionError(f"the port imported {mod}")

    replaces = {"topk": ("topk_candidates", "pallas_topk.py:94"),
                "group_hist": ("group_counts_sums", "pallas_group.py:139"),
                "windowed_expand": ("windowed_expand", "pallas_expand.py:302"),
                "uniform_expand": ("uniform_expand", "pallas_expand.py:416"),
                "sorted_take": ("sorted_take", "pallas_expand.py:134")}
    record = {"kernels": [
        {"name": fn, "route": "cuda",
         "source": f"warpdb_tpu_torch/csrc/{kname}.cu",
         "replaces": f"warpdb_tpu/ops/{where}",
         "launches": launches[kname], "max_abs_err": err[kname],
         "ms": kms[kname]["ms"], "plain_ms": kms[kname]["plain_ms"],
         "bound_ms": kms[kname]["bound_ms"], "bound_by": "bytes",
         "library_ms": kms[kname]["library_ms"],
         "lib_ms": kms[kname]["library_ms"]}
        for kname, (fn, where) in replaces.items()
    ]}
    print(json.dumps(record))
    print(name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
