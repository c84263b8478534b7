"""warpdb_tpu_torch on a CUDA card: each kernel against its plain
version, and the slice on the card against the same slice on the CPU.

Every test here needs a card and skips without one.  This file imports
no JAX (the card's machine has none), so it runs there without the
repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from warpdb_tpu_torch import WarpDB
from warpdb_tpu_torch.ops import group_kernel, topk_kernel
from warpdb_tpu_torch.storage import HostTable

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


def _topk_input(case: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    if case == "random":
        return rng.uniform(-100, 100, n).astype(np.float32)
    if case == "ascending":
        return np.sort(rng.uniform(-100, 100, n).astype(np.float32))
    return rng.choice(np.float32([1.0, 2.0, 3.0, 99.5]), n)


@pytest.mark.parametrize("k", [16, 64, 128])
@pytest.mark.parametrize("case", ["random", "ascending", "duplicates"])
@pytest.mark.parametrize("n", [1 << 22, (1 << 22) - 37, 1000])
def test_topk_kernel_matches_plain(cuda, case, k, n):
    xd = torch.from_numpy(_topk_input(case, n)).to(cuda)
    before = topk_kernel.topk_candidates.launches
    got = torch.topk(topk_kernel.topk_candidates(xd, k).reshape(-1), k).values
    want = topk_kernel.topk_candidates_plain(xd, k).reshape(-1)
    torch.cuda.synchronize()
    assert topk_kernel.topk_candidates.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("nv", [0, 1, 5])
@pytest.mark.parametrize("num_slots", [6000, 65536])
def test_group_kernel_matches_plain(cuda, num_slots, nv):
    rng = np.random.default_rng(33)
    n = 1 << 20
    gid = rng.integers(0, num_slots, n).astype(np.int32)
    gid[::17] = num_slots
    gid[5::29] = -3
    gd = torch.from_numpy(gid).to(cuda)
    vd = [torch.from_numpy(rng.uniform(0, 100, n).astype(np.float32)).to(cuda)
          for _ in range(nv)]
    before = group_kernel.group_counts_sums.launches
    c, s = group_kernel.group_counts_sums(gd, vd, num_slots)
    cp, sp = group_kernel.group_counts_sums_plain(gd, vd, num_slots)
    torch.cuda.synchronize()
    assert group_kernel.group_counts_sums.launches > before
    assert torch.equal(c, cp)
    for a, b in zip(s, sp):
        # Atomic f32 adds in a run-dependent order.
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)


def _host() -> HostTable:
    rng = np.random.default_rng(99)
    n = 50_000
    nv = rng.uniform(0, 10, n).astype(np.float32)
    nv[::53] = np.nan
    return HostTable.from_dict({
        "price": rng.uniform(0, 100, n).astype(np.float32),
        "quantity": rng.integers(0, 32, n).astype(np.float32),
        "k": rng.integers(0, 60_000, n).astype(np.float32),
        "ki": rng.integers(0, 5000, n).astype(np.int32),
        "fk": (rng.integers(0, 300, n) / 4).astype(np.float32),
        "nv": nv,
        "s": rng.choice(["apple", "banana", "cherry"], n),
        "wide": rng.choice(np.array([-(2**40), 7, 2**53 + 1], np.int64), n),
    })


@pytest.fixture(scope="module")
def dbs(cuda):
    host = _host()
    return WarpDB(host, device="cuda"), WarpDB(host, device="cpu")


QUERIES = [
    ("expr", "price * quantity"),
    ("expr", "price * 0.9 WHERE price > 20"),
    ("expr", "discount(price, 0.9)"),
    ("expr", "CASE WHEN price > 50 THEN 1 ELSE 0 END"),
    ("expr", "coalesce(nv, 0 - 1) + sqrt(price)"),
    ("expr", "price WHERE s = 'banana'"),
    ("sql", "SELECT SUM(price) FROM t GROUP BY quantity ORDER BY quantity ASC"),
    ("sql", "SELECT price FROM t ORDER BY price DESC LIMIT 5"),
    ("sql", "SELECT price FROM t ORDER BY price ASC LIMIT 200 OFFSET 3"),
    ("sql", "SELECT SUM(price) FROM t GROUP BY k"),
    ("sql", "SELECT COUNT(*) FROM t GROUP BY k"),
    ("sql", "SELECT MAX(price) FROM t GROUP BY k"),
    ("sql", "SELECT k FROM t GROUP BY k HAVING COUNT(*) > 1 "
            "ORDER BY SUM(price) DESC LIMIT 10"),
    ("sql", "SELECT SUM(quantity) FROM t GROUP BY fk"),
    ("sql", "SELECT fk FROM t GROUP BY fk ORDER BY MAX(nv) DESC LIMIT 6"),
    ("sql", "SELECT COUNT(*) FROM t GROUP BY quantity, s"),
    ("sql", "SELECT quantity, COUNT(*) FROM t GROUP BY quantity "
            "HAVING SUM(price) > 1000"),
    ("sql", "SELECT DISTINCT quantity FROM t"),
    ("sql", "SELECT DISTINCT ki FROM t ORDER BY ki DESC"),
    ("sql", "SELECT DISTINCT fk FROM t"),
    ("sql", "SELECT price FROM t WHERE price > 99.5"),
    ("sql", "SELECT price FROM t ORDER BY quantity DESC, price ASC LIMIT 20"),
    ("sql", "SELECT nv FROM t ORDER BY nv DESC LIMIT 5"),
    ("sql", "SELECT COUNT(nv) FROM t"),
    ("sql", "SELECT MEDIAN(price) FROM t GROUP BY s"),
    ("sql", "SELECT COUNT(DISTINCT quantity) FROM t"),
    ("sql", "SELECT AVG(price) FROM t WHERE quantity > 20"),
    ("sql", "SELECT s FROM t ORDER BY s DESC LIMIT 4"),
    ("sql", "SELECT UPPER(s) FROM t LIMIT 5"),
    ("sql", "SELECT wide FROM t WHERE wide > 7 ORDER BY wide ASC LIMIT 5"),
]


@pytest.mark.parametrize("kind,q", QUERIES)
def test_slice_on_card_matches_cpu(dbs, kind, q):
    gpu, cpu = dbs
    run = (lambda db: db.query(q)) if kind == "expr" else (
        lambda db: db.query_sql(q))
    got, want = run(gpu), run(cpu)
    assert len(got) == len(want), q
    if want and isinstance(want[0], str):
        assert got == want, q
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype.kind == w.dtype.kind, q
    # Sums add in another order on the card (atomics): rtol 1e-5.
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, equal_nan=True,
                               err_msg=q)


def test_slice_launches_both_kernels(dbs):
    gpu, _cpu = dbs
    k1 = topk_kernel.topk_candidates.launches
    k2 = group_kernel.group_counts_sums.launches
    gpu.query_sql("SELECT price FROM t ORDER BY price DESC LIMIT 5")
    gpu.query_sql("SELECT SUM(price) FROM t GROUP BY k")
    assert topk_kernel.topk_candidates.launches == k1 + 1
    assert group_kernel.group_counts_sums.launches == k2 + 1
