"""Drive warpdb_tpu_torch once on a CUDA card, end to end.

    python3 chip_smoke.py [--profile]

Phases, each raising on failure:

1. environment: the card's name and power limit, torch and CUDA versions;
   no CUDA device means exit code 2 and no result;
2. build: both CUDA kernels (top-k K1, group histogram K2) compile from
   ``warpdb_tpu_torch/csrc`` with nvcc for sm_90a;
3. kernels: each kernel against its plain PyTorch version on the card;
4. slice: ``WarpDB(..., device="cuda")`` over bench.py's table (2^25
   rows, seed 12345) runs bench.py's query set and four more queries,
   each checked against NumPy on the same arrays; both kernels' launch
   counters must rise during this phase;
5. timing: median wall time of 5 warm runs per query, and each kernel's
   time beside its plain version at the slice's shapes (CUDA events);
6. with ``--profile`` only: one ``torch.profiler`` run per query (card
   busy time, idle share, largest device items) and each kernel's
   registers and spills from ``ptxas -v``.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  The script imports no JAX.
"""

from __future__ import annotations

import json
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

# f32 sums per group (2^20 rows per group for GROUP BY quantity, 512 for
# GROUP BY k) add in a run-dependent order on the card; against a float64
# sum the relative error stays far below this bound.
SUM_RTOL = 1e-4


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


def check(name: str, got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if name in ("group_sum", "group_sum_k"):
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


def paired_ms(kernel, plain) -> tuple:
    """Kernel and plain times in turns (plain, kernel, kernel, plain)."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_kernels(topk, group) -> dict:
    """K1 and K2 against their plain versions on the card."""
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
    return err


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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            run(kind, q)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not dev:
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
    if set(argv) - {"--profile"}:
        print("usage: python3 chip_smoke.py [--profile]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from warpdb_tpu_torch import WarpDB, _build
    from warpdb_tpu_torch.ops import group_kernel as group
    from warpdb_tpu_torch.ops import topk_kernel as topk
    from warpdb_tpu_torch.ops.sort import top_k_values
    from warpdb_tpu_torch.storage import HostTable

    name = card()
    log(f"card: {name}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc {' '.join(_build.NVCC_FLAGS[:2])}) "
        + ", ".join(f"{k}={v}" for k, v in libs.items()))

    err = phase_kernels(topk, group)
    phase_inf_group(WarpDB, HostTable, group)

    t0 = time.perf_counter()
    data = make_table()
    db = WarpDB(HostTable.from_dict(data), device="cuda")
    want = expected(data)
    log(f"table: {ROWS} rows on {db.device}, set-up {time.perf_counter() - t0:.3f} s")

    def run(kind: str, q: str):
        return db.query_np(q) if kind == "expr" else db.query_sql(q)

    queries = [("expr", n, q) for n, q in EXPR_QUERIES] + [
        ("sql", n, q) for n, q in SQL_QUERIES
    ]
    topk.topk_candidates.launches = 0
    group.group_counts_sums.launches = 0
    results = {n: run(kind, q) for kind, n, q in queries}
    torch.cuda.synchronize()
    launches = {"topk": topk.topk_candidates.launches,
                "group_hist": group.group_counts_sums.launches}
    for kind, n, q in queries:
        e = check(n, results[n], want[n])
        log(f"slice {n}: agrees with numpy ({len(results[n])} values, "
            f"max abs err {e!r}) — {q}")
    for k, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {k} was not launched by the slice")
    log(f"slice launches: {launches}")

    log(f"timing on {name}:")
    for kind, n, q in queries:
        ts = []
        run(kind, q)
        for _ in range(5):
            t0 = time.perf_counter()
            run(kind, q)
            ts.append(time.perf_counter() - t0)
        log(f"  query {n}: median {sorted(ts)[2] * 1e3!r} ms over 5 warm runs "
            f"[{name}]")

    cols = db.table.row_columns()
    u = cols["price"]
    # Both sides give the final top-k: K1 plus the torch.topk finish over
    # its candidates, against one torch.topk over the column.
    k_ms, k_plain = paired_ms(lambda: top_k_values(u, None, 16, False),
                              lambda: topk.topk_candidates_plain(u, 16))
    k_alone = cuda_ms(lambda: topk.topk_candidates(u, 16))
    gid = cols["k"].to(torch.int32)
    price = cols["price"]
    g_ms, g_plain = paired_ms(
        lambda: group.group_counts_sums(gid, [price], KEY_SLOTS),
        lambda: group.group_counts_sums_plain(gid, [price], KEY_SLOTS),
    )
    log(f"  K1 top-k n={ROWS} k=16: kernel + finish {k_ms!r} ms (kernel "
        f"alone {k_alone!r} ms), plain torch.topk {k_plain!r} ms [{name}]")
    log(f"  K2 group histogram n={ROWS} slots={KEY_SLOTS} nv=1: kernel "
        f"{g_ms!r} ms, plain bincount+index_add_ {g_plain!r} ms [{name}]")

    if profile:
        phase_profile(run, queries, name)
        phase_ptxas(_build)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    record = {"kernels": [
        {"name": "topk_candidates", "route": "cuda",
         "source": "warpdb_tpu_torch/csrc/topk.cu",
         "replaces": "warpdb_tpu/ops/pallas_topk.py:84",
         "launches": launches["topk"], "max_abs_err": err["topk"],
         "ms": k_ms, "plain_ms": k_plain},
        {"name": "group_counts_sums", "route": "cuda",
         "source": "warpdb_tpu_torch/csrc/group_hist.cu",
         "replaces": "warpdb_tpu/ops/pallas_group.py:101",
         "launches": launches["group_hist"],
         "max_abs_err": err["group_hist"], "ms": g_ms, "plain_ms": g_plain},
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
