"""Drive warpdb_tpu_torch once on a CUDA card, end to end.

    python3 chip_smoke.py [--profile | --kernels]

Phases, each raising on failure:

1. environment: the card's name and power limit, torch and CUDA versions;
   no CUDA device means exit code 2 and no result;
2. build: all five CUDA kernels (top-k K1, group histogram K2, the join's
   expansions K3 and K4 and its sorted gather K5) compile from
   ``warpdb_tpu_torch/csrc`` with nvcc for sm_90a, in parallel;
3. kernels: each kernel against its plain PyTorch version on the card,
   K3-K5 bit for bit at the join's full sizes (K3 and K4 also at their
   edge shapes), then each timed at the main path's shapes beside its
   plain version, the one PyTorch call computing the same function where
   there is one, and its bound (bytes over the card's memory rate);
   ``--kernels`` stops here, after printing each kernel's ptxas usage;
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
7. TPC-H: the 22 queries of ``benchmarks/tpch.py`` (subqueries, CTEs,
   derived tables, multi-way joins) through ``query_sql_table`` at 2^22
   lineitem rows, each checked against the suite's NumPy oracle with its
   own gate; per query the K1-K5 launches, the device of every
   materialised table (it must be the card), the median of 5 warm runs
   with every memo dropped before each run, and the host round trip of
   its materialised tables; the phase must launch a kernel;
8. with ``--profile`` only: one ``torch.profiler`` run per query (card
   busy time, idle share, largest device items) and each kernel's
   registers and spills from ``ptxas -v``.

The kernels' JSON record and the card's name and power limit come before
the last line, ``{"ok": true, "device": {...}}``.  Neither the script nor
the port imports JAX or ``warpdb_tpu``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

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
# full, as the reference's ``_run_projection_multi`` does); no grouping
# takes the midrange tier (K2) and no join fans out uniformly (K4).
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


def phase_kernels(topk, group) -> tuple:
    """K1 and K2 against their plain versions on the card, and each timed
    at the slice's shapes."""
    from warpdb_tpu_torch.ops.sort import top_k_values

    g = np.random.default_rng(7)
    err = {"topk": 0.0, "group_hist": 0.0}
    for n in (ROWS, ROWS - 37):
        for case in ("random", "ascending", "duplicates"):
            if case == "random":
                x = g.uniform(-100, 100, n).astype(np.float32)
            elif case == "ascending":
                x = np.sort(g.uniform(-100, 100, n).astype(np.float32))
            else:
                x = g.choice(np.float32([1.0, 2.0, 3.0, 99.5]), n)
            xd = torch.from_numpy(x).cuda()
            for k in (16, 128):
                got = torch.topk(topk.topk_candidates(xd, k).reshape(-1), k).values
                want = topk.topk_candidates_plain(xd, k).reshape(-1)
                torch.cuda.synchronize()
                err["topk"] = max(err["topk"], float((got - want).abs().max()))
                if not torch.equal(got, want):
                    raise AssertionError(f"K1 {case} n={n} k={k}: top-k differs")
            log(f"K1 n={n} {case}: top-k multiset equal to plain (k=16,128)")
    for slots in (6000, 40000, KEY_SLOTS):
        gid = g.integers(0, slots, ROWS).astype(np.int32)
        gid[::17] = slots          # invalid rows, as callers pass them
        gid[5::29] = -3            # stray negative ids
        gd = torch.from_numpy(gid).cuda()
        for nv in (0, 1, 2):
            vals = [g.uniform(0, 100, ROWS).astype(np.float32) for _ in range(nv)]
            vd = [torch.from_numpy(v).cuda() for v in vals]
            c, s = group.group_counts_sums(gd, vd, slots)
            cp, sp = group.group_counts_sums_plain(gd, vd, slots)
            torch.cuda.synchronize()
            if not torch.equal(c, cp):
                raise AssertionError(f"K2 slots={slots} nv={nv}: counts differ")
            ok = (gid >= 0) & (gid < slots)
            for a, b, v in zip(s, sp, vals):
                torch.testing.assert_close(a, b, rtol=SUM_RTOL, atol=1e-2)
                ref = np.bincount(gid[ok], weights=v[ok].astype(np.float64),
                                  minlength=slots)
                np.testing.assert_allclose(a.cpu().numpy(), ref, rtol=SUM_RTOL,
                                           atol=1e-2)
                err["group_hist"] = max(
                    err["group_hist"], float((a - b).abs().max())
                )
            log(f"K2 slots={slots} nv={nv}: counts exact, sums within "
                f"rtol {SUM_RTOL} of plain and float64")
    # ±inf values go through K2 (the TPU path gated them off): the inf
    # reaches only its own slot, as the reference's scatter engine gives.
    gid = torch.arange(8, dtype=torch.int32, device="cuda").repeat(128)
    v = torch.ones(gid.shape[0], device="cuda")
    v[3] = float("inf")
    v[12] = float("-inf")
    c, (s,) = group.group_counts_sums(gid, [v], 8)
    want = torch.full((8,), 128.0, device="cuda")
    want[3], want[4] = float("inf"), float("-inf")
    if not torch.equal(s, want):
        raise AssertionError(f"K2 ±inf: {s.tolist()}")
    log("K2 ±inf values: only their own slots are non-finite")
    # The slice's shapes: ORDER BY price DESC LIMIT 5 over 2^25 uniform
    # prices (k = 16 after rounding up) and GROUP BY k (2^16 slots, one
    # value column).  Both K1 sides give the final top-k: the kernel plus
    # the torch.topk finish over its candidates, against torch.topk.
    u = torch.from_numpy(g.uniform(0, 100, ROWS).astype(np.float32)).cuda()
    ms = {"topk": timing(lambda: top_k_values(u, None, 16, False),
                         lambda: topk.topk_candidates_plain(u, 16),
                         lambda: torch.topk(u, 16), ROWS * 4 + 16 * 4,
                         f"n={ROWS} k=16, with the finish")}
    gid = torch.from_numpy(g.integers(0, KEY_SLOTS, ROWS).astype(np.int32)).cuda()
    ms["group_hist"] = timing(
        lambda: group.group_counts_sums(gid, [u], KEY_SLOTS),
        lambda: group.group_counts_sums_plain(gid, [u], KEY_SLOTS),
        None, ROWS * 8 + KEY_SLOTS * 8, f"n={ROWS} slots={KEY_SLOTS} nv=1")
    return err, ms


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
    ``(kernel launches over the checked runs, run function, queries)``
    for the profile."""
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
    return total, run, queries


def phase_profile(run, queries, name: str) -> None:
    """One profiled warm run per slice query (torch.profiler, CPU and
    CUDA activities): profiled wall, card-busy time (the union of the
    device intervals), idle share and the three largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    log(f"profile on {name} (profiled wall exceeds the unprofiled one):")
    for kind, n, q in queries:
        run(kind, q)
        torch.cuda.synchronize()
        # The tracer now and then returns a run without its device events;
        # such a run is profiled again, up to three times in all.
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                t0 = time.perf_counter()
                run(kind, q)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            dev = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            if dev:
                break
            log(f"  profile {n}: no device activity traced, run again")
        else:
            raise AssertionError(f"profile {n}: no device activity traced")
        busy, cur = 0.0, None
        for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
            if cur is None or s > cur[1]:
                busy += 0.0 if cur is None else cur[1] - cur[0]
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        busy = (busy + cur[1] - cur[0]) / 1e3
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
        for line in proc.stderr.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {kname}: {line.strip()}")


def main(argv: list) -> int:
    profile = "--profile" in argv
    kernels_only = "--kernels" in argv
    if set(argv) - {"--profile", "--kernels"}:
        print("usage: python3 chip_smoke.py [--profile | --kernels]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from warpdb_tpu_torch import WarpDB, _build
    from warpdb_tpu_torch.config import get_config
    from warpdb_tpu_torch.ops import expand
    from warpdb_tpu_torch.ops import group_kernel as group
    from warpdb_tpu_torch.ops import topk_kernel as topk
    from warpdb_tpu_torch.storage import HostTable

    name = card()
    log(f"card: {name}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc {' '.join(_build.NVCC_FLAGS[:2])}) "
        + ", ".join(f"{k}={v}" for k, v in libs.items()))

    err, kms = phase_kernels(topk, group)
    xerr, xms = phase_expand_kernels(expand)
    err.update(xerr)
    kms.update(xms)
    torch.cuda.empty_cache()
    log(f"kernel timing on {name} (CUDA events, mean of 20 launches; "
        f"bound at {HBM_TB_S} TB/s):")
    for kname, t in kms.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']!r} ms"
        log(f"  {kname} {t['shape']}: kernel {t['ms']!r} ms, plain "
            f"{t['plain_ms']!r} ms, library {lib}, bound {t['bound_ms']!r} "
            f"ms = {100 * t['bound_ms'] / t['ms']!r}% [{name}]")
    if kernels_only:
        phase_ptxas(_build)
        return 0
    phase_inf_group(WarpDB, HostTable, group)

    t0 = time.perf_counter()
    data = make_table()
    db = WarpDB(HostTable.from_dict(data), device="cuda")
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
    kernels = {"topk": topk.topk_candidates,
               "group_hist": group.group_counts_sums,
               "windowed_expand": expand.windowed_expand,
               "uniform_expand": expand.uniform_expand,
               "sorted_take": expand.sorted_take}

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

    tpch_launches, tpch_run, tpch_queries = phase_tpch(WarpDB, HostTable,
                                                       kernels, name)
    for k, c in tpch_launches.items():
        launches[k] += c

    if profile:
        phase_profile(run, queries + join_queries, name)
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
