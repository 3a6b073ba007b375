"""The runtime bloom join filter's bitset: build and probe (the hand-written
kernel `spark_tpu_torch/csrc/bloom_filter.cu`, which replaces the
reference's XLA-lowered loop in `spark_tpu/physical/operators.py:1486-1570`).

  * `bloom_build(h, mask, nbits, off0, off1) -> uint8[nbits]`: a byte per
    bit, set at mix64(h + off) & (nbits - 1) for each live row, for both
    offsets (`utils/sketch.bloom_position_offsets(2)`).
  * `bloom_probe(bits, h, mask, nbits, off0, off1) -> (bool[n],
    int64[1])`: a row stays live only when it is live and both of its
    positions are set; the second output counts the rows kept, on the
    device, so the caller reads it on the host only where it must.

The hashes are the port's `hash_columns` of the join keys (seed 42). Each
wrapper takes its plain PyTorch version (`*_plain`) only for tensors on the
CPU. Given CUDA tensors it launches the kernel or raises; it never drops to
the plain version. On the card neither reads anything on the host nor
allocates by the data, so both run inside a CUDA graph capture.
`scatter_kernels.LAUNCHES` counts the calls that launched each kernel
(`bloom_build`, `bloom_probe`).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from .hashing import mix64
from .scatter_kernels import LAUNCHES, _as, _on_device, _raise_on, _stream

SOURCE = "bloom_filter"


def _positions(h: torch.Tensor, nbits: int, off: int) -> torch.Tensor:
    return mix64(h.to(torch.int64) + off) & (nbits - 1)


# --- plain versions ---------------------------------------------------------

def bloom_build_plain(h: torch.Tensor, mask: torch.Tensor, nbits: int,
                      off0: int, off1: int) -> torch.Tensor:
    bits = torch.zeros(nbits + 1, dtype=torch.uint8, device=h.device)
    park = torch.full((), nbits, dtype=torch.int64, device=h.device)
    for off in (off0, off1):
        bits.index_fill_(0, torch.where(mask, _positions(h, nbits, off),
                                        park), 1)
    return bits[:nbits]


def bloom_probe_plain(bits: torch.Tensor, h: torch.Tensor,
                      mask: torch.Tensor, nbits: int, off0: int,
                      off1: int) -> tuple[torch.Tensor, torch.Tensor]:
    keep = (bits[_positions(h, nbits, off0)] != 0) \
        & (bits[_positions(h, nbits, off1)] != 0)
    out = mask & keep
    return out, out.sum().reshape(1).to(torch.int64)


# --- CUDA launch ---------------------------------------------------------------

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = cuda_build.load(SOURCE)
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.spark_bloom_build.argtypes = [p, p, i64, i64, i64, i64, p, p]
        lib.spark_bloom_build.restype = ctypes.c_int
        lib.spark_bloom_probe.argtypes = [p, p, p, i64, i64, i64, i64, p, p,
                                          p]
        lib.spark_bloom_probe.restype = ctypes.c_int
        _bound = lib
    return _bound


def _check(h: torch.Tensor, mask: torch.Tensor, nbits: int,
           bits: torch.Tensor | None = None) -> str:
    dev = h.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"the bloom kernel runs on cpu or cuda, not {dev}")
    if h.dim() != 1 or mask.shape != h.shape or mask.device != h.device:
        raise ValueError("bloom: h and mask must be 1-D, of one shape, on "
                         "one device")
    if nbits <= 0 or nbits & (nbits - 1):
        raise ValueError(f"bloom: nbits must be a power of two, not {nbits}")
    if bits is not None and (bits.shape != (nbits,)
                             or bits.device != h.device):
        raise ValueError("bloom: bits must be [nbits] on the hashes' device")
    if dev == "cuda" and h.shape[0] >= 1 << 31:
        raise ValueError("the bloom kernel takes at most 2^31 - 1 rows")
    return dev


def bloom_build(h: torch.Tensor, mask: torch.Tensor, nbits: int, off0: int,
                off1: int) -> torch.Tensor:
    """uint8[nbits]: 1 at both positions of every live row's hash."""
    if _check(h, mask, nbits) == "cpu":
        return bloom_build_plain(h, mask, nbits, off0, off1)
    hh, m = _as(h, torch.int64), _as(mask, torch.bool)
    bits = torch.empty(nbits, dtype=torch.uint8, device=hh.device)

    def launch():
        return _lib().spark_bloom_build(
            hh.data_ptr(), m.data_ptr(), hh.shape[0], nbits, off0, off1,
            bits.data_ptr(), _stream(hh))

    _raise_on(_on_device(hh.device, launch), "bloom_build")
    LAUNCHES["bloom_build"] += 1
    return bits


def bloom_probe(bits: torch.Tensor, h: torch.Tensor, mask: torch.Tensor,
                nbits: int, off0: int,
                off1: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(bool[n], int64[1]): the rows live in `mask` whose two positions are
    set in `bits`, and their count."""
    if _check(h, mask, nbits, bits) == "cpu":
        return bloom_probe_plain(bits, h, mask, nbits, off0, off1)
    b = _as(bits, torch.uint8)
    hh, m = _as(h, torch.int64), _as(mask, torch.bool)
    out = torch.empty(hh.shape[0], dtype=torch.bool, device=hh.device)
    live = torch.empty(1, dtype=torch.int64, device=hh.device)

    def launch():
        return _lib().spark_bloom_probe(
            b.data_ptr(), hh.data_ptr(), m.data_ptr(), hh.shape[0], nbits,
            off0, off1, out.data_ptr(), live.data_ptr(), _stream(hh))

    _raise_on(_on_device(hh.device, launch), "bloom_probe")
    LAUNCHES["bloom_probe"] += 1
    return out, live
