"""spark_tpu_torch.ops.hashing against spark_tpu.ops.hashing: the splitmix64
column hash and the partition ids must match bit for bit, since they decide
every hash-exchange partition."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from spark_tpu.ops import hashing as JH  # noqa: E402
from spark_tpu_torch.ops import hashing as TH  # noqa: E402

N = 4096
SEEDS = [0, 1, 2]


def _lane(kind: str, rng) -> np.ndarray:
    if kind == "int64":
        return rng.integers(-(2 ** 63), 2 ** 63 - 1, N, dtype=np.int64)
    if kind == "int32":
        return rng.integers(-(2 ** 31), 2 ** 31 - 1, N, dtype=np.int32)
    if kind in ("float64", "float32"):
        x = rng.standard_normal(N) * 1e6
        specials = [0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0]
        x[: len(specials)] = specials
        return x.astype(kind)
    if kind == "bool":
        return rng.random(N) < 0.5
    raise ValueError(kind)


def _both(cols, valids, seed=42):
    j = np.asarray(JH.hash_columns(
        [jnp.asarray(c) for c in cols],
        [None if v is None else jnp.asarray(v) for v in valids], seed=seed))
    t = TH.hash_columns(
        [torch.from_numpy(c) for c in cols],
        [None if v is None else torch.from_numpy(v) for v in valids],
        seed=seed).numpy()
    return j, t


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["int64", "int32", "float64", "float32",
                                  "bool"])
def test_hash_one_column_bit_exact(kind, seed):
    rng = np.random.default_rng(seed)
    col = _lane(kind, rng)
    j, t = _both([col], [None], seed=42 + seed)
    assert j.dtype == t.dtype == np.int64
    assert np.array_equal(j, t)


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_null_lanes_and_multi_column(seed):
    rng = np.random.default_rng(seed)
    cols = [_lane("int64", rng), _lane("float32", rng), _lane("bool", rng),
            _lane("int32", rng)]
    valids = [rng.random(N) < 0.8, None, rng.random(N) < 0.5, None]
    j, t = _both(cols, valids)
    assert np.array_equal(j, t)
    # a null key hashes to its position's tag, whatever the data plane holds
    cols[0] = np.where(valids[0], cols[0], 12345)
    j2, t2 = _both(cols, valids)
    assert np.array_equal(j2, t2) and np.array_equal(t, t2)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("parts", [1, 7, 8, 200])
def test_partition_ids_bit_exact(parts, seed):
    rng = np.random.default_rng(seed)
    h = _lane("int64", rng)
    j = np.asarray(JH.partition_ids(jnp.asarray(h), parts))
    t = TH.partition_ids(torch.from_numpy(h), parts).numpy()
    assert j.dtype == t.dtype == np.int32
    assert np.array_equal(j, t)
    assert t.min() >= 0 and t.max() < parts


def test_negative_zero_hashes_like_zero():
    col = np.array([0.0, -0.0], dtype=np.float64)
    t = TH.hash_columns([torch.from_numpy(col)]).numpy()
    assert t[0] == t[1]
