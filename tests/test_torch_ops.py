"""Operator parity: ``warpdb_tpu_torch.ops.sort`` and ``ops.aggregate``
against ``warpdb_tpu.ops`` on the same inputs.  The port holds sort keys
as int64 images of the reference's uint32 keys, so keys compare equal
after a cast.  The midrange tier's histogram engine (kernel K2's plain
version here) is held against the reference's MXU engine."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from warpdb_tpu.ops import aggregate as ref_agg
from warpdb_tpu.ops import sort as ref_sort
from warpdb_tpu_torch.ops import aggregate as agg
from warpdb_tpu_torch.ops import sort

N = 4096


def _floats(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.choice(np.float32([-2.5, -0.0, 0.0, 1.0, 3.5, 7.0]), N)
    x[::97] = np.nan
    x[5::101] = np.inf
    x[7::103] = -np.inf
    x[11::89] = np.float32(-np.nan)
    return x


def _mask(seed=1):
    return np.random.default_rng(seed).random(N) < 0.8


def test_float_sort_key_matches_reference():
    x = np.concatenate([_floats(), np.random.default_rng(2).normal(size=N)
                        .astype(np.float32)])
    want = np.asarray(ref_sort.float_sort_key(jnp.asarray(x))).astype(np.int64)
    got = sort.float_sort_key(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_int_sort_key_matches_reference():
    x = np.array([-(2**31), -1, 0, 1, 2**24 + 1, 2**31 - 1], np.int32)
    want = np.asarray(ref_sort.int_sort_key(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(sort.int_sort_key(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.mark.parametrize("ascending", [True, False])
def test_order_key_and_sorts_match_reference(ascending):
    x, m = _floats(), _mask()
    keys = np.random.default_rng(3).integers(0, 9, N).astype(np.int32)
    jx, jm, jk = jnp.asarray(x), jnp.asarray(m), jnp.asarray(keys)
    tx, tm, tk = torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(keys)
    np.testing.assert_array_equal(
        sort.order_key(tx, tm, ascending).numpy(),
        np.asarray(ref_sort.order_key(jx, jm, ascending)).astype(np.int64),
    )
    np.testing.assert_array_equal(
        sort.sort_values(tx, tm, ascending).numpy(),
        np.asarray(ref_sort.sort_values(jx, jm, ascending)),
    )
    got_v, got_m = sort.sort_pairs(tk, tx, tm, ascending)
    want_v, want_m = ref_sort.sort_pairs(jk, jx, jm, ascending)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(
        sort.sort_by_keys([(tk, ascending), (tx, not ascending)], tx, tm).numpy(),
        np.asarray(ref_sort.sort_by_keys([(jk, ascending), (jx, not ascending)],
                                         jx, jm)),
    )


def _group_result_equal(got, want, ng):
    for gk, wk in zip(got.keys, want.keys):
        np.testing.assert_array_equal(gk[:ng].numpy(), np.asarray(wk)[:ng])
    np.testing.assert_array_equal(got.counts[:ng].numpy(),
                                  np.asarray(want.counts)[:ng])
    for gv, wv in zip(got.values, want.values):
        np.testing.assert_allclose(gv.sums[:ng].numpy(), np.asarray(wv.sums)[:ng],
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(gv.mins[:ng].numpy(),
                                      np.asarray(wv.mins)[:ng])
        np.testing.assert_array_equal(gv.maxs[:ng].numpy(),
                                      np.asarray(wv.maxs)[:ng])


def test_group_aggregate_matches_reference():
    rng = np.random.default_rng(4)
    k1 = rng.integers(0, 20, N).astype(np.float32)
    k1[::131] = np.nan
    k2 = rng.integers(-3, 3, N).astype(np.int32)
    v = rng.uniform(-10, 10, N).astype(np.float32)
    m = _mask(5)
    want = ref_agg.group_aggregate((jnp.asarray(k1), jnp.asarray(k2)),
                                   (jnp.asarray(v),), jnp.asarray(m), N)
    got = agg.group_aggregate((torch.from_numpy(k1), torch.from_numpy(k2)),
                              (torch.from_numpy(v),), torch.from_numpy(m), N)
    ng = int(want.num_groups)
    assert int(got.num_groups) == ng
    _group_result_equal(got, want, ng)
    assert int(agg.count_distinct((torch.from_numpy(k1), torch.from_numpy(k2)),
                                  torch.from_numpy(m))) == int(
        ref_agg.count_distinct((jnp.asarray(k1), jnp.asarray(k2)),
                               jnp.asarray(m)))


@pytest.mark.parametrize("int_keys", [True, False])
def test_dense_group_aggregate_matches_reference(int_keys):
    rng = np.random.default_rng(6)
    keys = rng.integers(-5, 60, N)
    keys = keys.astype(np.int32 if int_keys else np.float32)
    v = rng.uniform(0, 10, N).astype(np.float32)
    m = _mask(7)
    want = ref_agg.dense_group_aggregate(jnp.asarray(keys), (jnp.asarray(v),),
                                         jnp.asarray(m), -2, 50)
    got = agg.slot_group_aggregate(torch.from_numpy(keys), (torch.from_numpy(v),),
                                   torch.from_numpy(m), -2, 50)
    assert got.keys[0].dtype == (torch.int32 if int_keys else torch.float32)
    assert int(got.num_groups) == int(want.num_groups)
    _group_result_equal(got, want, 50)


@pytest.mark.parametrize("need", [("sum",), ("sum", "min", "max")])
def test_midrange_group_aggregate_matches_reference(need):
    rng = np.random.default_rng(8)
    keys = rng.integers(100, 6100, N).astype(np.float32)
    v = rng.uniform(0, 10, N).astype(np.float32)
    m = _mask(9)
    hist = need == ("sum",)
    want = ref_agg.midrange_group_aggregate(jnp.asarray(keys), (jnp.asarray(v),),
                                            jnp.asarray(m), 100, 6000, need,
                                            use_mxu=hist)
    got = agg.slot_group_aggregate(torch.from_numpy(keys),
                                   (torch.from_numpy(v),),
                                   torch.from_numpy(m), 100, 6000, need,
                                   use_hist=hist)
    assert int(got.num_groups) == int(want.num_groups)
    _group_result_equal(got, want, 6000)
