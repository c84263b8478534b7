"""build_evaluator and optimizer parity between the JAX package and the
port: the same expression text, parsed by each package's own frontend,
over the same columns gives the same values."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from warpdb_tpu.engine import optimizer as ref_opt
from warpdb_tpu.engine.compiler import build_evaluator as ref_build
from warpdb_tpu.frontend import parse_expression_text as ref_parse
from warpdb_tpu.storage import HostTable as RefHostTable
from warpdb_tpu.storage.table import DeviceTable as RefDeviceTable
from warpdb_tpu_torch.engine import optimizer as port_opt
from warpdb_tpu_torch.engine.compiler import (
    build_evaluator,
    cache_stats,
    compile_filter_project,
)
from warpdb_tpu_torch.frontend import parse_expression_text
from warpdb_tpu_torch.storage import DeviceTable, HostTable

N = 2048


def _columns():
    rng = np.random.default_rng(21)
    price = rng.uniform(-50, 100, N).astype(np.float32)
    price[::131] = np.nan
    big = (2**24 + rng.integers(-3, 4, N)).astype(np.int32)
    return {
        "price": price,
        "quantity": rng.integers(0, 32, N).astype(np.float32),
        "qty": rng.integers(-7, 9, N).astype(np.int32),
        "big": big,
        "pos": rng.uniform(0.5, 10, N).astype(np.float32),
    }


COLS = _columns()

EXACT = [
    # bench.py's expressions
    "price * quantity",
    "price * 0.9",
    "price * quantity * 1.08",
    "discount(price, 0.9)",
    "price > 15",
    "(price > 20) * price",
    # % is C fmod, with negative dividends
    "price % 7",
    "qty % 3",
    # integer comparisons beyond 2^24 stay exact
    "big == 16777217",
    "big > 16777216",
    "big != 16777215",
    "big < 16777218.5",
    "big >= 16777216.5",
    "big == 16777216.5",
    "qty <= 2.5",
    "qty == big",
    "(0 - 3) < qty",
    # logic and NULL handling
    "price > 10 AND quantity < 5",
    "price > 90 OR qty == 0 - 7",
    "CASE WHEN price > 50 THEN 1 WHEN price > 0 THEN price ELSE 0 - 1 END",
    "CASE WHEN qty > 0 THEN quantity END",
    "coalesce(price, 0 - 1)",
    "nullif(quantity, 3)",
    "isnan(price)",
    "greatest(price, quantity, 7)",
    "least(price, quantity)",
    "abs(price - 50)",
    "floor(price) + ceil(pos)",
    "round(price, 1)",
    "trunc(price)",
    "sign(price)",
    "maximum(price, 0)",
    "2 * 3 + quantity",
]

TRANSCENDENTAL = [
    "sqrt(pos)",
    "ln(pos)",
    "log(2, pos)",
    "log10(pos)",
    "log2(pos)",
    "exp(pos)",
    "pow(pos, 1.5)",
    "sin(price) + cos(price)",
    "tan(pos)",
    "atan2(price, pos)",
    "tanh(pos)",
    "cbrt(price)",
    "degrees(pos) + radians(pos)",
    "pi() * pos",
]


def _eval_both(text):
    node = parse_expression_text(text)
    ref = np.asarray(ref_build(ref_parse(text))(
        {k: jnp.asarray(v) for k, v in COLS.items()}))
    got = build_evaluator(node)({k: torch.from_numpy(v) for k, v in COLS.items()})
    got = got.numpy()
    ref = np.broadcast_to(ref, (N,)) if ref.ndim == 0 else ref
    got = np.broadcast_to(got, (N,)) if got.ndim == 0 else got
    return ref, got


@pytest.mark.parametrize("text", EXACT)
def test_build_evaluator_exact(text):
    ref, got = _eval_both(text)
    if ref.dtype == np.bool_:
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, ref)
    else:
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("text", TRANSCENDENTAL)
def test_build_evaluator_transcendental(text):
    # The reference itself allows rtol 1e-4 for transcendentals.
    ref, got = _eval_both(text)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6, equal_nan=True)


def test_int_compare_beyond_2_24_is_exact():
    node = parse_expression_text("big == 16777217")
    got = build_evaluator(node)({"big": torch.from_numpy(COLS["big"])})
    np.testing.assert_array_equal(got.numpy(), COLS["big"] == 16777217)


def test_filter_project_cache():
    cols = {k: torch.from_numpy(v) for k, v in COLS.items()}
    expr = parse_expression_text("price * 2")
    cond = parse_expression_text("quantity > 3")
    before = cache_stats()["hits"]
    fn = compile_filter_project(expr, cond, cols)
    assert compile_filter_project(expr, cond, cols) is fn
    assert cache_stats()["hits"] == before + 1
    out = fn(cols, N).numpy()
    want = np.where(COLS["quantity"] > 3, COLS["price"] * np.float32(2), 0)
    np.testing.assert_array_equal(out, want.astype(np.float32))


OPT_EXPRS = [
    "2 * 3 + 1",
    "quantity * 2 + 1",
    "price > 200",
    "quantity >= 0",
    "quantity < 0 OR quantity > 40",
    "quantity >= 0 AND qty > 0 - 8",
    "pos / quantity",
    "pos * 2 - qty",
    "qty % 2",
    "quantity == 3",
]


@pytest.mark.parametrize("text", OPT_EXPRS)
def test_optimizer_matches_reference(text):
    ref_stats = RefDeviceTable.from_host(RefHostTable.from_dict(COLS)).stats
    stats = DeviceTable.from_host(HostTable.from_dict(COLS), device="cpu").stats
    assert ({k: dataclasses.astuple(v) for k, v in stats.items()}
            == {k: dataclasses.astuple(v) for k, v in ref_stats.items()})
    node, ref_node = parse_expression_text(text), ref_parse(text)
    assert port_opt.fold_constants(node).canonical() == (
        ref_opt.fold_constants(ref_node).canonical()
    )
    assert port_opt.expr_range(node, stats) == ref_opt.expr_range(
        ref_node, ref_stats)
    assert port_opt.analyze_condition(node, stats) == (
        ref_opt.analyze_condition(ref_node, ref_stats)
    )
