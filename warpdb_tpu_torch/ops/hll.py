"""HyperLogLog: APPROX_COUNT_DISTINCT with mergeable bounded state.

Counterpart of ``warpdb_tpu/ops/hll.py``; the registers are the
reference's bit for bit.  Per group, ``m = 4096`` one-byte registers
(standard error ≈ 1.04/√m ≈ 1.6%) that merge by elementwise max, the
mergeable partial of the streaming and distributed tiers.

* Values hash through their ``float_sort_key`` image (an int64 in
  [0, 2^32) here, the reference's uint32), so -0.0 ≡ +0.0 and every NaN
  is one value, as in the exact COUNT(DISTINCT).
* Torch supports few operations on ``uint32``: the murmur3 fmix32
  finaliser runs in int64, each 32-bit product split into 16-bit halves
  so no intermediate passes 2^63, masked to 32 bits.
* The register update is one ``scatter_reduce_(…, "amax")`` over the
  valid rows only (compacted first: no spare slot takes the dropped rows).
* The estimator (harmonic mean with the linear-counting correction) is f32
  elementwise work over the (G, m) table; torch adds the 4096 ``exp2``
  terms in another order than XLA, so estimates may differ in the last
  bits.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["HLL_P", "HLL_M", "hll_hash", "hll_rho_bucket",
           "hll_grouped_registers", "hll_estimate", "hll_estimate_np"]

HLL_P = 12               # register-index bits
HLL_M = 1 << HLL_P       # 4096 registers, ~1.6% standard error
_U32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64 ``h`` in [0, 2^32) and a 32-bit
    constant, without an intermediate beyond 2^49."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def hll_hash(u: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over 32-bit words held in int64 (result in
    [0, 2^32)): a full-avalanche finaliser, so the low bits (bucket) and
    the high bits (rho) mix independently."""
    h = u.to(torch.int64) & _U32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hll_rho_bucket(h: torch.Tensor) -> tuple:
    """(rho, bucket) of a mixed hash, both int32: bucket = the low p bits;
    rho = the 1-based position of the leftmost 1 among the other 32 - p
    bits (all zero → 32 - p + 1).  ``rho = 21 - bit_length(w)`` for the
    20-bit word ``w``, the bit length exact from ``frexp`` of f32(w)
    (w < 2^20 is exact in f32; frexp(0) gives exponent 0)."""
    bucket = (h & (HLL_M - 1)).to(torch.int32)
    w = (h >> HLL_P).to(torch.float32)
    _mant, exp = torch.frexp(w)
    rho = (32 - HLL_P + 1) - exp.to(torch.int32)
    return rho, bucket


def hll_grouped_registers(seg: torch.Tensor, skey: torch.Tensor,
                          valid, capacity: int) -> torch.Tensor:
    """Scatter-max HLL registers of ``capacity`` groups.

    ``seg``: each row's group id in [0, capacity) (ignored where invalid);
    ``skey``: the value's ``float_sort_key`` image; ``valid``: a row mask
    or None.  Returns int32[capacity, HLL_M]."""
    if valid is not None:
        seg, skey = seg[valid], skey[valid]
    rho, bucket = hll_rho_bucket(hll_hash(skey))
    slot = seg.to(torch.int64) * HLL_M + bucket
    regs = torch.zeros(capacity * HLL_M, dtype=torch.int32, device=skey.device)
    regs.scatter_reduce_(0, slot, rho, "amax")
    return regs.reshape(capacity, HLL_M)


def _alpha(m: int) -> float:
    return 0.7213 / (1.0 + 1.079 / m)


def hll_estimate(regs: torch.Tensor) -> torch.Tensor:
    """Per-group cardinality estimates (f32) from (G, m) registers.

    Harmonic-mean raw estimate with the small-range linear-counting
    correction (E ≤ 2.5m with empty registers); no 2^32-range correction,
    as in the reference."""
    m = regs.shape[1]
    rf = regs.to(torch.float32)
    z = torch.exp2(-rf).sum(dim=1)
    raw = torch.tensor(_alpha(m) * m * m, dtype=torch.float32,
                       device=regs.device) / z
    zeros = (regs == 0).to(torch.float32).sum(dim=1)
    linear = float(m) * torch.log(float(m) / torch.clamp(zeros, min=1.0))
    use_linear = (raw <= 2.5 * m) & (zeros > 0)
    return torch.where(use_linear, linear, raw)


def hll_estimate_np(regs: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`hll_estimate` for merged streaming partials,
    f32 throughout (the reference's ``hll_estimate_np``)."""
    regs = np.asarray(regs)
    m = regs.shape[1]
    rf = regs.astype(np.float32)
    z = np.sum(np.exp2(-rf), axis=1, dtype=np.float32)
    raw = np.float32(_alpha(m) * m * m) / z
    zeros = np.sum(regs == 0, axis=1).astype(np.float32)
    linear = np.float32(m) * np.log(
        np.float32(m) / np.maximum(zeros, 1)
    ).astype(np.float32)
    use_linear = (raw <= 2.5 * m) & (zeros > 0)
    return np.where(use_linear, linear, raw).astype(np.float32)
