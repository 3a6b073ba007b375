"""The port's numpy copy of the sketches (spark_tpu_torch/utils/sketch.py)
against the JAX package's `spark_tpu/utils/sketch.py`: the same values and
hashes, made from a seed with numpy, into a BloomFilter and a
CountMinSketch of each; their bit arrays, tables, answers and bytes are
equal, the probe-position offsets are the reference's, and a filter put
over device hashes sets the positions the port's bitset kernel's plain
version sets (ops/bloom.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.utils.sketch as J  # noqa: E402
import spark_tpu_torch.utils.sketch as T  # noqa: E402


def _values(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(-1 << 40, 1 << 40, n)
    if kind == "float":
        v = rng.normal(size=n)
        v[:3] = [0.0, -0.0, 1.5]
        return v
    return np.array([f"v{x}" for x in rng.integers(0, 10_000, n)],
                    dtype=object)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_bloom_position_offsets(k):
    assert T.bloom_position_offsets(k) == J.bloom_position_offsets(k)


@pytest.mark.parametrize("kind", ["int", "float", "str"])
@pytest.mark.parametrize("expected,fpp", [(1000, 0.03), (50_000, 0.01)])
def test_bloom_filter_matches_reference(kind, expected, fpp):
    put = _values(kind, expected, 1)
    probe = np.concatenate([put[:200], _values(kind, 2000, 2)])
    t, j = T.BloomFilter(expected, fpp), J.BloomFilter(expected, fpp)
    assert (t.num_bits, t.num_hashes) == (j.num_bits, j.num_hashes)
    t.put_many(put)
    j.put_many(put)
    assert np.array_equal(t.bits, j.bits)
    assert np.array_equal(t.might_contain_many(probe),
                          j.might_contain_many(probe))
    assert t.might_contain_many(put[:200]).all()
    assert t.might_contain(put[0]) == j.might_contain(put[0])
    assert t.to_bytes() == j.to_bytes()
    back = T.BloomFilter.from_bytes(j.to_bytes())
    assert np.array_equal(back.bits, j.bits)
    other_t, other_j = T.BloomFilter(expected, fpp), \
        J.BloomFilter(expected, fpp)
    other_t.put_many(probe)
    other_j.put_many(probe)
    assert np.array_equal(t.merge(other_t).bits, j.merge(other_j).bits)


def test_bloom_hashes_and_device_bits():
    rng = np.random.default_rng(4)
    h = rng.integers(-(1 << 63), (1 << 63) - 1, 5000, dtype=np.int64)
    t, j = T.BloomFilter(1, num_bits=1 << 16), J.BloomFilter(1, num_bits=1 << 16)
    t.num_hashes = j.num_hashes = 2
    t.put_hashes(h)
    j.put_hashes(h)
    assert np.array_equal(t.bits, j.bits)
    assert np.array_equal(t.might_contain_hashes(h[::-1]),
                          j.might_contain_hashes(h[::-1]))
    words = t.device_bits()
    assert words.dtype == torch.int32
    assert np.array_equal(words.numpy().view(np.uint32),
                          np.asarray(j.device_bits()))
    # the bitset kernel's plain version over the same hashes sets the same
    # positions: k = 2 with the shared offsets
    from spark_tpu_torch.ops.bloom import bloom_build_plain

    off0, off1 = T.bloom_position_offsets(2)
    byte_bits = bloom_build_plain(torch.from_numpy(h),
                                  torch.ones(len(h), dtype=torch.bool),
                                  1 << 16, off0, off1).numpy()
    set_pos = np.nonzero(byte_bits)[0]
    word_bits = np.unpackbits(t.bits.view(np.uint8), bitorder="little")
    assert np.array_equal(set_pos, np.nonzero(word_bits)[0])


@pytest.mark.parametrize("kind", ["int", "str"])
def test_count_min_sketch_matches_reference(kind):
    vals = _values(kind, 20_000, 5)
    counts = np.random.default_rng(6).integers(1, 5, len(vals))
    t, j = T.CountMinSketch(0.01, 0.95), J.CountMinSketch(0.01, 0.95)
    t.add_many(vals, counts)
    j.add_many(vals, counts)
    assert np.array_equal(t.table, j.table) and t.total == j.total
    q = vals[:500]
    assert np.array_equal(t.estimate_count_many(q), j.estimate_count_many(q))
    assert t.estimate_count(vals[0]) == j.estimate_count(vals[0])
    assert t.to_bytes() == j.to_bytes()
    back = T.CountMinSketch.from_bytes(t.to_bytes())
    assert np.array_equal(back.table, t.table)
    t2, j2 = T.CountMinSketch(0.01, 0.95), J.CountMinSketch(0.01, 0.95)
    t2.add(vals[1], 7)
    j2.add(vals[1], 7)
    assert np.array_equal(t.merge(t2).table, j.merge(j2).table)
