"""Probabilistic sketches: BloomFilter and CountMinSketch (the port's numpy
copy of `spark_tpu/utils/sketch.py`).

The backing state is a flat numpy bit array whose probe and insert
positions come from the splitmix64 hash family the device kernels use
(ops/hashing.py), so a filter built on the device (the runtime join
filter's bitset, ops/bloom.py) and one built on the host over the same
hashes set the same positions. `device_bits()` hands the bitset to torch as
int32 words.
"""

from __future__ import annotations

import math

import numpy as np

_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_GOLDEN = 0x9E3779B97F4A7C15


def _mix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over uint64 lanes (matches ops/hashing.mix64)."""
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(_M1)
        x ^= x >> np.uint64(27)
        x *= np.uint64(_M2)
        x ^= x >> np.uint64(31)
    return x


def bloom_position_offsets(k: int) -> tuple:
    """The shared probe-position hash family: position j of hash h is
    mix64(h + (2j+1)*GOLDEN) & (num_bits-1). Returned as SIGNED 64-bit
    offsets so device kernels can add them to int64 hash lanes; host code
    (BloomFilter._positions) uses the same constants mod 2^64 — a filter
    built on device over `hash_columns` output and one built on host via
    put_hashes() are interchangeable."""
    out = []
    for j in range(k):
        off = (2 * j + 1) * _GOLDEN & ((1 << 64) - 1)
        out.append(off - (1 << 64) if off >= (1 << 63) else off)
    return tuple(out)


def _to_u64(values) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        import hashlib

        out = np.empty(len(arr), np.uint64)
        for i, v in enumerate(arr):
            d = hashlib.blake2b(str(v).encode("utf-8"), digest_size=8).digest()
            out[i] = int.from_bytes(d, "little")
        return out
    if arr.dtype.kind == "f":
        arr = np.where(arr == 0, np.zeros_like(arr), arr)
        return arr.astype(np.float64).view(np.uint64)
    return arr.astype(np.int64).view(np.uint64)


class BloomFilter:
    """Blocked bloom filter over a power-of-two bit array.

    k probe positions are derived from one 64-bit hash by mixing with k
    odd constants — one memory word per probe, no byte loops (reference:
    BloomFilterImpl.putLong's double hashing)."""

    def __init__(self, expected_items: int, fpp: float = 0.03,
                 num_bits: int | None = None):
        if num_bits is None:
            n = max(expected_items, 1)
            m = int(-n * math.log(fpp) / (math.log(2) ** 2))
            num_bits = 1 << max(10, (m - 1).bit_length())
        assert num_bits & (num_bits - 1) == 0
        self.num_bits = num_bits
        self.num_hashes = max(1, min(8, int(round(
            num_bits / max(expected_items, 1) * math.log(2)))))
        self.bits = np.zeros(num_bits // 64, dtype=np.uint64)

    # --- hashing ----------------------------------------------------------
    def _positions(self, values_u64: np.ndarray) -> np.ndarray:
        """[n, k] bit positions (raw values mix once into the shared hash
        domain, then the common position family applies)."""
        return self._hash_positions(_mix64_np(values_u64))

    # --- API --------------------------------------------------------------
    def put_hashes(self, hashes) -> None:
        """Insert pre-computed 64-bit hashes (the device `hash_columns`
        domain) — positions match a device-built bitset bit for bit."""
        self._set_bits(self._hash_positions(
            np.asarray(hashes).view(np.uint64)))

    def might_contain_hashes(self, hashes) -> np.ndarray:
        return self._test_bits(self._hash_positions(
            np.asarray(hashes).view(np.uint64)))

    def _set_bits(self, pos: np.ndarray) -> None:
        pos = pos.ravel()
        word = (pos >> np.uint64(6)).astype(np.int64)
        bit = np.uint64(1) << (pos & np.uint64(63))
        np.bitwise_or.at(self.bits, word, bit)

    def _test_bits(self, pos: np.ndarray) -> np.ndarray:
        word = (pos >> np.uint64(6)).astype(np.int64)
        bit = np.uint64(1) << (pos & np.uint64(63))
        return ((self.bits[word] & bit) != 0).all(axis=1)

    def _hash_positions(self, h: np.ndarray) -> np.ndarray:
        pos = np.empty((len(h), self.num_hashes), np.uint64)
        mask = np.uint64(self.num_bits - 1)
        offs = bloom_position_offsets(self.num_hashes)
        for j, off in enumerate(offs):
            with np.errstate(over="ignore"):
                pos[:, j] = _mix64_np(h + np.uint64(off & ((1 << 64) - 1))) \
                    & mask
        return pos

    def put_many(self, values) -> None:
        self._set_bits(self._positions(_to_u64(values)))

    def put(self, value) -> None:
        self.put_many([value])

    def might_contain_many(self, values) -> np.ndarray:
        return self._test_bits(self._positions(_to_u64(values)))

    def might_contain(self, value) -> bool:
        return bool(self.might_contain_many([value])[0])

    def merge(self, other: "BloomFilter") -> "BloomFilter":
        assert self.num_bits == other.num_bits \
            and self.num_hashes == other.num_hashes, "incompatible filters"
        self.bits |= other.bits
        return self

    def device_bits(self, device="cpu"):
        """The bitset as int32[num_bits/32] words (the reference's uint32
        words, bit for bit; torch has no uint32 arithmetic) on `device`."""
        import torch

        return torch.from_numpy(self.bits.view(np.int32).copy()).to(device)

    # --- (de)serialization -------------------------------------------------
    def to_bytes(self) -> bytes:
        head = np.array([self.num_bits, self.num_hashes], np.int64).tobytes()
        return head + self.bits.tobytes()

    @staticmethod
    def from_bytes(data: bytes) -> "BloomFilter":
        head = np.frombuffer(data[:16], np.int64)
        bf = BloomFilter(1, num_bits=int(head[0]))
        bf.num_hashes = int(head[1])
        bf.bits = np.frombuffer(data[16:], np.uint64).copy()
        return bf


class CountMinSketch:
    """Count-min sketch: [depth, width] counters, point updates, min-query
    (reference: CountMinSketch.java — same eps/confidence sizing)."""

    def __init__(self, eps: float = 0.001, confidence: float = 0.99,
                 depth: int | None = None, width: int | None = None):
        self.depth = depth or max(1, int(math.ceil(-math.log(1 - confidence))))
        w = width or int(math.ceil(2.0 / eps))
        self.width = 1 << max(4, (w - 1).bit_length())
        self.table = np.zeros((self.depth, self.width), np.int64)
        self.total = 0

    def _cols(self, values_u64: np.ndarray) -> np.ndarray:
        h = _mix64_np(values_u64)
        cols = np.empty((self.depth, len(h)), np.int64)
        mask = np.uint64(self.width - 1)
        for d in range(self.depth):
            with np.errstate(over="ignore"):
                hd = _mix64_np(h + np.uint64((2 * d + 1) * _GOLDEN & ((1 << 64) - 1)))
            cols[d] = (hd & mask).astype(np.int64)
        return cols

    def add_many(self, values, counts=None) -> None:
        u = _to_u64(values)
        cols = self._cols(u)
        cnt = np.ones(len(u), np.int64) if counts is None \
            else np.asarray(counts, np.int64)
        for d in range(self.depth):
            np.add.at(self.table[d], cols[d], cnt)
        self.total += int(cnt.sum())

    def add(self, value, count: int = 1) -> None:
        self.add_many([value], [count])

    def estimate_count_many(self, values) -> np.ndarray:
        cols = self._cols(_to_u64(values))
        ests = np.stack([self.table[d][cols[d]] for d in range(self.depth)])
        return ests.min(axis=0)

    def estimate_count(self, value) -> int:
        return int(self.estimate_count_many([value])[0])

    def merge(self, other: "CountMinSketch") -> "CountMinSketch":
        assert self.table.shape == other.table.shape, "incompatible sketches"
        self.table += other.table
        self.total += other.total
        return self

    def to_bytes(self) -> bytes:
        head = np.array([self.depth, self.width, self.total], np.int64).tobytes()
        return head + self.table.tobytes()

    @staticmethod
    def from_bytes(data: bytes) -> "CountMinSketch":
        head = np.frombuffer(data[:24], np.int64)
        cms = CountMinSketch(depth=int(head[0]), width=int(head[1]))
        cms.total = int(head[2])
        cms.table = np.frombuffer(data[24:], np.int64).reshape(
            cms.depth, cms.width).copy()
        return cms
