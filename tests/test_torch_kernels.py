"""The port's kernels K1 (top-k candidates) and K2 (group histogram).

Here on the CPU the wrappers run their plain PyTorch versions, held
against the JAX package: K2 against the Pallas kernel in interpret mode,
K1 by its candidate contract and through ``top_k_values`` end to end
(the Pallas top-k kernel has no CPU interpret run, see
test_pallas_ops.py).  The CUDA kernels themselves are compared with
their plain versions on a card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdb_tpu_torch.errors import ExecutionError
from warpdb_tpu_torch.ops import group_kernel, topk_kernel
from warpdb_tpu_torch.ops.sort import top_k_values


def _topk_input(case: str, n: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if case == "random":
        return rng.uniform(-100, 100, n).astype(np.float32)
    if case == "ascending":
        return np.sort(rng.uniform(-100, 100, n).astype(np.float32))
    return rng.choice(np.float32([1.0, 2.0, 3.0, 99.5]), n)


def _group_input(num_slots: int, n: int, nv: int):
    rng = np.random.default_rng(33)
    gid = rng.integers(0, num_slots, n).astype(np.int32)
    glo = 128 if num_slots <= (1 << 14) else 256
    gid[::17] = -(-num_slots // glo) * glo  # invalid rows match no slot
    vals = [rng.uniform(0, 100, n).astype(np.float32) for _ in range(nv)]
    return gid, vals


# --- K2 ---------------------------------------------------------------------


@pytest.mark.parametrize("nv", [0, 1, 2])
@pytest.mark.parametrize("num_slots,n", [(6000, 4096), (40_000, 8192)])
def test_group_plain_matches_pallas_interpret(num_slots, n, nv):
    from warpdb_tpu.ops.pallas_group import pallas_group_counts_sums

    gid, vals = _group_input(num_slots, n, nv)
    want_c, want_s = pallas_group_counts_sums(
        jnp.asarray(gid), tuple(jnp.asarray(v) for v in vals), num_slots,
        interpret=jax.default_backend() == "cpu",
    )
    got_c, got_s = group_kernel.group_counts_sums(
        torch.from_numpy(gid), [torch.from_numpy(v) for v in vals], num_slots
    )
    assert got_c.dtype == torch.int32 and got_c.shape == (num_slots,)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert len(got_s) == nv
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-6,
                                   atol=1e-3)


def test_group_plain_out_of_range_and_inf():
    gid = torch.tensor([0, 1, 2, -1, 3, 7, 1], dtype=torch.int32)
    v = torch.tensor([1.0, float("inf"), 2.0, 5.0, 4.0, 9.0, 3.0])
    counts, (sums,) = group_kernel.group_counts_sums(gid, [v], 4)
    assert counts.tolist() == [1, 2, 1, 1]
    assert sums.tolist() == [1.0, float("inf"), 2.0, 4.0]


def test_group_wrapper_rejects_other_devices():
    gid = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ExecutionError, match="unsupported device"):
        group_kernel.group_counts_sums(gid, (), 4)


# --- K1 ---------------------------------------------------------------------


@pytest.mark.parametrize("k", [16, 33, 128])
@pytest.mark.parametrize("case", ["random", "ascending", "duplicates"])
def test_topk_plain_candidate_contract(case, k):
    x = _topk_input(case, 1 << 14)
    cand = topk_kernel.topk_candidates(torch.from_numpy(x), k)
    assert cand.dim() == 2 and cand.shape[1] == k
    got = np.sort(cand.numpy().reshape(-1))[::-1][:k]
    np.testing.assert_array_equal(got, np.sort(x)[::-1][:k])


def test_topk_plain_pads_short_inputs():
    cand = topk_kernel.topk_candidates(torch.tensor([3.0, 1.0]), 16)
    assert cand.shape == (1, 16)
    assert cand[0, :2].tolist() == [3.0, 1.0]
    assert torch.isinf(cand[0, 2:]).all()


def test_topk_kernel_widths():
    assert [topk_kernel.kernel_k(k) for k in (2, 16, 17, 64, 65, 128)] == [
        16, 16, 32, 64, 128, 128,
    ]
    with pytest.raises(ValueError):
        topk_kernel.kernel_k(129)
    with pytest.raises(ExecutionError, match="unsupported device"):
        topk_kernel.topk_candidates(torch.zeros(8, device="meta"), 16)


@pytest.mark.parametrize("ascending", [False, True])
@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("case", ["random", "ascending", "duplicates"])
def test_top_k_values_matches_reference(case, k, ascending):
    from warpdb_tpu.ops.sort import top_k_values as ref_top_k_values

    n = 1 << 16
    x = _topk_input(case, n, seed=11)
    mask = np.random.default_rng(12).random(n) < 0.7
    want = np.asarray(
        jax.jit(lambda v, m: ref_top_k_values(v, m, k, ascending))(
            jnp.asarray(x), jnp.asarray(mask)
        )
    )
    got = top_k_values(torch.from_numpy(x), torch.from_numpy(mask), k,
                       ascending).numpy()
    np.testing.assert_array_equal(got, want)
