"""DeviceTable.from_host parity: the port's columns, dictionaries and
stats equal the JAX package's for the same numpy columns, each side's
HostTable built by its own package."""

import dataclasses

import numpy as np
import pytest
import torch

from warpdb_tpu.config import EngineConfig as RefConfig
from warpdb_tpu.config import get_config as ref_get_config
from warpdb_tpu.config import set_config as ref_set_config
from warpdb_tpu.errors import ValidationError as RefValidationError
from warpdb_tpu.storage import HostTable as RefHostTable
from warpdb_tpu.storage.table import DeviceTable as RefDeviceTable
from warpdb_tpu_torch import config as port_config
from warpdb_tpu_torch.errors import ExecutionError, ValidationError
from warpdb_tpu_torch.storage import DeviceTable, HostTable


def _data(seed: int = 3, n: int = 3000) -> dict:
    rng = np.random.default_rng(seed)
    price = rng.uniform(0, 100, n).astype(np.float32)
    price[::97] = np.nan
    return {
        "price": price,
        "qty": rng.integers(-5, 40, n).astype(np.int32),
        "narrow64": rng.integers(-(2**31), 2**31 - 1, n).astype(np.int64),
        "wide64": rng.integers(-(2**62), 2**62, n).astype(np.int64),
        "wide64b": (rng.integers(0, 50, n) + 2**40).astype(np.int64),
        "exact64": rng.integers(0, 1000, n).astype(np.float64) / 8,
        "name": rng.choice(["apple", "kiwi", "fig", ""], n),
        "tag": rng.choice(["fig", "zebra"], n),
    }


def _stats(stats: dict) -> dict:
    return {name: dataclasses.astuple(s) for name, s in stats.items()}


def test_columns_dicts_and_stats_match_reference():
    data = _data()
    ref = RefDeviceTable.from_host(RefHostTable.from_dict(data))
    port = DeviceTable.from_host(HostTable.from_dict(data), device="cpu")
    assert port.num_rows == ref.num_rows
    assert port.padded_rows == ref.padded_rows
    assert list(port.dtypes) == list(ref.dtypes)
    assert ({k: t.value for k, t in port.dtypes.items()}
            == {k: t.value for k, t in ref.dtypes.items()})
    for name in ref.columns:
        want = np.asarray(ref.columns[name])
        got = port.columns[name].numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert set(port.dicts) == set(ref.dicts) == {"name", "tag", "wide64",
                                                 "wide64b"}
    for name, vocab in ref.dicts.items():
        np.testing.assert_array_equal(port.dicts[name], vocab)
    assert _stats(port.stats) == _stats(ref.stats)
    # One shared string vocabulary, one shared wide-int vocabulary.
    assert port.dicts["name"] is port.dicts["tag"]
    assert port.dicts["wide64"] is port.dicts["wide64b"]


def test_row_views_drop_padding():
    port = DeviceTable.from_host(HostTable.from_dict(_data(n=1500)),
                                 device="cpu")
    views = port.row_columns()
    assert port.padded_rows == 2048
    assert all(v.shape == (1500,) for v in views.values())
    assert torch.equal(port.columns["qty"][1500:],
                       torch.zeros(548, dtype=torch.int32))


def test_f64_strict_refusal_matches_reference():
    data = {"x": np.array([1.0, 16777217.0, 2.5], np.float64)}
    with pytest.raises(RefValidationError) as ref_err:
        RefDeviceTable.from_host(RefHostTable.from_dict(data))
    with pytest.raises(ValidationError) as port_err:
        DeviceTable.from_host(HostTable.from_dict(data), device="cpu")
    assert str(port_err.value) == str(ref_err.value)
    assert "16777217.0" in str(port_err.value)


def test_f64_downcast_policy_matches_reference():
    data = {"x": np.array([1.0, 16777217.0, 2.5], np.float64)}
    old_ref = ref_get_config()
    old_port = port_config.get_config()
    try:
        ref_set_config(RefConfig(f64_policy="downcast"))
        port_config.set_config(port_config.EngineConfig(f64_policy="downcast"))
        ref = RefDeviceTable.from_host(RefHostTable.from_dict(data))
        port = DeviceTable.from_host(HostTable.from_dict(data), device="cpu")
    finally:
        ref_set_config(old_ref)
        port_config.set_config(old_port)
    np.testing.assert_array_equal(port.columns["x"].numpy(),
                                  np.asarray(ref.columns["x"]))


def test_empty_table():
    host = HostTable.from_dict({"a": np.zeros(0, np.float32)})
    port = DeviceTable.from_host(host, device="cpu")
    assert port.num_rows == 0 and port.padded_rows == 1024
    assert port.row_columns()["a"].shape == (0,)


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    """``from_host`` without a device means the card; with no CUDA device
    it raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = HostTable.from_dict({"a": np.arange(3, dtype=np.float32)})
    with pytest.raises(ExecutionError, match="CUDA is not available"):
        DeviceTable.from_host(host)
