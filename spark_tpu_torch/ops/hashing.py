"""Device hashing kernels (counterpart of `spark_tpu/ops/hashing.py`).

A 64-bit splitmix finalizer over int64 lanes; it decides every hash
partition id, so it matches the JAX package bit for bit. torch has no
uint64 arithmetic: products are taken in int64, which wraps modulo 2^64
exactly as the unsigned product does, with the constants converted to their
signed values, and each right shift is made logical by masking off the sign
bits an arithmetic shift brings in. A string key enters as its equality
lanes (`Column.eq_keys`: the dictionary's value hash per row), so its
partition id equals the reference's whatever dictionary holds the value.
"""

from __future__ import annotations

import torch

_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_GOLDEN = 0x9E3779B97F4A7C15


def _signed(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


_M1_S = _signed(_M1)
_M2_S = _signed(_M2)
_GOLDEN_S = _signed(_GOLDEN)


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (public-domain constant set)."""
    x = x.to(torch.int64)
    x = x ^ _lsr(x, 30)
    x = x * _M1_S
    x = x ^ _lsr(x, 27)
    x = x * _M2_S
    return x ^ _lsr(x, 31)


def _to_i64_lanes(d: torch.Tensor) -> torch.Tensor:
    """Reinterpret a column's device data as int64 lanes for hashing."""
    if d.dtype == torch.bool:
        return d.to(torch.int64)
    if d.dtype in (torch.float32, torch.float64):
        # normalize -0.0 == 0.0 so they hash equal
        d = torch.where(d == 0, torch.zeros_like(d), d)
        if d.dtype == torch.float32:
            return d.view(torch.int32).to(torch.int64)
        return d.view(torch.int64)
    return d.to(torch.int64)


def hash_columns(cols, validities=None, seed: int = 42) -> torch.Tensor:
    """Combined 64-bit hash over one or more key columns.

    validities: optional list of bool tensors; a null key contributes a
    fixed per-position tag (null == null for grouping). Returns int64[cap].
    """
    h = None
    for i, c in enumerate(cols):
        k = mix64(_to_i64_lanes(c))
        if validities is not None and validities[i] is not None:
            null_tag = mix64(torch.full((), 0x6E756C6C + i,
                                        dtype=torch.int64, device=k.device))
            k = torch.where(validities[i], k, null_tag)
        if h is None:
            h = k
        else:
            h = mix64(h * 31 + k + _GOLDEN_S)
    if h is None:
        raise ValueError("hash_columns needs at least one column")
    # nonlinear seed fold: h' = mix64(h ^ mix64(seed))
    seed_h = mix64(torch.full((), seed, dtype=torch.int64, device=h.device))
    return mix64(h ^ seed_h)


def partition_ids(hashes: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Non-negative modulo (reference: HashPartitioner pmod)."""
    m = hashes % num_partitions
    return torch.where(m < 0, m + num_partitions, m).to(torch.int32)
