"""The port's scatter kernels (spark_tpu_torch/ops/scatter_kernels.py)
against the Pallas kernels of spark_tpu/ops/pallas_kernels.py, run as
tests/test_pallas_kernels.py runs them (interpret mode on the CPU). On the
CPU the wrappers take their plain versions; the CUDA kernels are held
against those plain versions in tests/test_torch_cuda.py, which skips
without a card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from spark_tpu.ops import pallas_kernels as PK  # noqa: E402
from spark_tpu_torch.ops import scatter_kernels as SK  # noqa: E402


def _hist_both(pids, mask, parts):
    j = np.asarray(PK.partition_histogram(
        jnp.asarray(pids, jnp.int32), jnp.asarray(mask), parts))
    t = SK.partition_histogram(torch.from_numpy(pids.astype(np.int32)),
                               torch.from_numpy(mask), parts)
    assert t.dtype == torch.int32 and t.shape == (parts,)
    return j, t.numpy()


@pytest.mark.parametrize("cap,parts", [(100, 3), (5000, 37), (8192, 128),
                                       (3000, 200)])
def test_partition_histogram_matches_pallas(cap, parts):
    rng = np.random.default_rng(0)
    pids = rng.integers(0, parts, cap)
    mask = rng.random(cap) < 0.8
    j, t = _hist_both(pids, mask, parts)
    assert np.array_equal(j, t)
    assert np.array_equal(t, np.bincount(pids[mask], minlength=parts))


def test_partition_histogram_all_dead_rows():
    pids = np.zeros(64, np.int64)
    mask = np.zeros(64, bool)
    j, t = _hist_both(pids, mask, 4)
    assert np.array_equal(j, t) and (t == 0).all()


@pytest.mark.parametrize("parts", [100, 128])
def test_partition_histogram_clip_edge(parts):
    # pids < 0 clip to bucket 0; pids >= P clip to the padded last bucket
    # round_up(P, 128) - 1, which lies past P (dropped) unless P is a
    # multiple of 128 (then they count in bucket P - 1), as on the TPU
    rng = np.random.default_rng(3)
    pids = rng.integers(-20, parts + 300, 2000)
    mask = rng.random(2000) < 0.7
    j, t = _hist_both(pids, mask, parts)
    assert np.array_equal(j, t)


def _sum_both(keys, vals, mask, groups):
    j = np.asarray(PK.dense_group_sum_f32(
        jnp.asarray(keys, jnp.int32), jnp.asarray(vals), jnp.asarray(mask),
        groups))
    t = SK.dense_group_sum_f32(torch.from_numpy(keys.astype(np.int32)),
                               torch.from_numpy(vals),
                               torch.from_numpy(mask), groups)
    assert t.dtype == torch.float32 and t.shape == (groups,)
    return j, t.numpy()


def test_dense_group_sum_matches_pallas():
    rng = np.random.default_rng(1)
    cap, groups = 4096, 300
    keys = rng.integers(0, groups, cap)
    vals = rng.random(cap).astype(np.float32)
    mask = rng.random(cap) < 0.9
    j, t = _sum_both(keys, vals, mask, groups)
    exp = np.zeros(groups, np.float64)
    np.add.at(exp, keys[mask], vals[mask])
    # float32 sums in another order: both within 1e-3 of the float64 oracle
    assert np.abs(t - exp).max() < 1e-3
    assert np.abs(t - j).max() < 1e-3


def test_dense_group_sum_non_multiple_block():
    keys = np.arange(10) % 3
    vals = np.ones(10, np.float32)
    mask = np.ones(10, bool)
    j, t = _sum_both(keys, vals, mask, 3)
    assert t.tolist() == j.tolist() == [4.0, 3.0, 3.0]


def test_dense_group_sum_clip_edge():
    rng = np.random.default_rng(4)
    keys = rng.integers(-5, 400, 3000)
    vals = rng.random(3000).astype(np.float32)
    mask = rng.random(3000) < 0.6
    j, t = _sum_both(keys, vals, mask, 200)
    assert np.abs(t - j).max() < 1e-3


def test_wrappers_reject_mismatched_inputs():
    with pytest.raises(ValueError):
        SK.partition_histogram(torch.zeros(8, dtype=torch.int32),
                               torch.ones(4, dtype=torch.bool), 2)
    with pytest.raises(ValueError):
        SK.partition_histogram(torch.zeros(8, dtype=torch.int32),
                               torch.ones(8, dtype=torch.bool,
                                          device="meta"), 2)


def test_cpu_path_launches_no_kernel():
    before = dict(SK.LAUNCHES)
    SK.partition_histogram(torch.zeros(16, dtype=torch.int32),
                           torch.ones(16, dtype=torch.bool), 4)
    assert SK.LAUNCHES == before
