"""The port on the card: the CUDA kernels of
spark_tpu_torch/csrc/scatter_kernels.cu against their plain PyTorch
versions, and the slice's query on CUDA tensors against a numpy oracle.
Every test here needs an NVIDIA GPU and nvcc and skips without a card.
The file imports neither jax nor spark_tpu, so it also runs where only the
port's dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spark_tpu_torch.ops import scatter_kernels as SK  # noqa: E402

pytestmark = pytest.mark.cuda

# the float32 sums' last register-path group count (csrc: kRegBuckets)
# and the kernels' last shared-memory bucket count (kSmemBuckets); one past
# each takes the next path
REG_BUCKETS = 16
SMEM_BUCKETS = 57344
# float32 sums added in another order than index_add_'s: relative 1e-4
# covers the rounding of up to a few hundred thousand float32 adds of
# values in [0, 1) per group
SUM_RTOL = 1e-4


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _on_card(arr, off, dev):
    """`arr` on the card as a view `off` elements into its storage (off > 0
    leaves the data pointer off 16-byte alignment)."""
    full = np.concatenate([np.zeros(off, arr.dtype), arr])
    return torch.from_numpy(full).to(dev)[off:]


def _hist_equal(dev, n, parts, key_hi, live, key_off=0, mask_off=0, seed=8):
    rng = np.random.default_rng(seed)
    k = _on_card(rng.integers(-3, key_hi, n).astype(np.int32), key_off, dev)
    m = _on_card(rng.random(n) < live, mask_off, dev)
    before = SK.LAUNCHES["partition_histogram"]
    got = SK.partition_histogram(k, m, parts)
    assert SK.LAUNCHES["partition_histogram"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, SK.partition_histogram_plain(k, m, parts))


@pytest.mark.parametrize("n,parts,key_hi,live", [
    (1 << 20, 8, 8, 0.7), (1 << 20, 200, 200, 0.7),
    (1 << 20, 1 << 18, 1 << 18, 0.7), (1_000_003, 200, 300, 0.7),
    (4096, 128, 400, 0.7),
    # counts take shared memory from 1 bucket up to SMEM_BUCKETS, global
    # atomics past it
    (1 << 20, 1, 1, 0.7), (1 << 20, REG_BUCKETS, 20, 0.7),
    (1 << 20, REG_BUCKETS + 1, 17, 0.7), (1 << 20, 32, 40, 0.7),
    (1 << 20, 33, 33, 0.7),
    (1 << 20, SMEM_BUCKETS, SMEM_BUCKETS, 0.7),
    (1 << 20, SMEM_BUCKETS + 1, SMEM_BUCKETS + 1, 0.7),
    # the dense aggregate's 2^21-bucket count with no and all rows live
    (1 << 22, 1 << 21, 1 << 20, 0.0), (1 << 22, 1 << 21, 1 << 20, 1.0),
    # fewer rows than one vector pass, and a ragged end
    (15, 8, 8, 0.7), (17, 200, 200, 0.7), (1_000_003, 8, 8, 0.7),
    (1_000_003, 33, 40, 0.9), (1_000_003, 1 << 21, 1 << 20, 0.6)])
def test_histogram_kernel_equals_plain(cuda_device, n, parts, key_hi, live):
    _hist_equal(cuda_device, n, parts, key_hi, live)


@pytest.mark.parametrize("parts", [8, 200, 1 << 21])
@pytest.mark.parametrize("key_off,mask_off", [(1, 1), (1, 0), (0, 3),
                                              (1, 3), (4, 4)])
def test_histogram_misaligned_views(cuda_device, parts, key_off, mask_off):
    # keys[1:] and mask[3:] leave 16-byte (keys) and 4-byte (mask)
    # alignment, alone or together; keys[4:] with mask[4:] keeps both
    _hist_equal(cuda_device, (1 << 20) + 5, parts, min(parts, 1 << 20), 0.8,
                key_off, mask_off)


def _sum_close(dev, n, groups, off=0, seed=9):
    rng = np.random.default_rng(seed)
    k = _on_card(rng.integers(-2, groups + 5, n).astype(np.int32), off, dev)
    v = _on_card(rng.random(n).astype(np.float32), off, dev)
    m = _on_card(rng.random(n) < 0.9, off, dev)
    before = SK.LAUNCHES["dense_group_sum_f32"]
    got = SK.dense_group_sum_f32(k, v, m, groups)
    assert SK.LAUNCHES["dense_group_sum_f32"] == before + 1
    exp = SK.dense_group_sum_f32_plain(k, v, m, groups)
    rel = (got - exp).abs() / exp.abs().clamp_min(1.0)
    assert float(rel.max()) <= SUM_RTOL
    return k, v, m, got


@pytest.mark.parametrize("n,groups,off", [
    (1 << 20, 300, 0), (1 << 20, 1 << 20, 0), (1 << 20, 1, 0),
    (1 << 20, 8, 0), (1 << 20, REG_BUCKETS, 0),
    # registers up to REG_BUCKETS groups, shared memory past it
    (1 << 20, REG_BUCKETS + 1, 0), (1 << 20, 32, 0), (1 << 20, 33, 0),
    (1 << 20, SMEM_BUCKETS, 0), (1 << 20, SMEM_BUCKETS + 1, 0),
    (15, 8, 0), (17, 300, 0), (1_000_003, 8, 0), (1_000_003, 300, 0),
    ((1 << 20) + 3, 8, 1), ((1 << 20) + 3, 300, 1),
    ((1 << 20) + 3, 1 << 20, 1)])
def test_group_sum_kernel_equals_plain(cuda_device, n, groups, off):
    _sum_close(cuda_device, n, groups, off)


@pytest.mark.parametrize("groups", [8, REG_BUCKETS])
def test_register_path_sums_repeat_bit_for_bit(cuda_device, groups):
    # up to REG_BUCKETS groups the sums add in a fixed order (registers,
    # shuffles, then the blocks in index order), so two runs agree exactly
    k, v, m, got = _sum_close(cuda_device, 1 << 22, groups)
    assert torch.equal(got, SK.dense_group_sum_f32(k, v, m, groups))


def test_slice_query_on_the_card(cuda_device):
    import pyarrow as pa

    import spark_tpu_torch.api.functions as F
    from spark_tpu_torch import TorchSession

    rng = np.random.default_rng(42)
    k = rng.integers(0, 5000, 200_000)
    v = rng.integers(0, 1000, 200_000)
    spark = TorchSession("on-card", {"spark.sql.shuffle.partitions": 4,
                                     "spark.tpu.batch.capacity": 1 << 16})
    assert spark.device.type == "cuda"
    df = (spark.createDataFrame(pa.table({"k": k, "v": v}))
          .filter(F.col("v") > 25).withColumn("v2", F.col("v") * 3)
          .repartition(8).groupBy("k")
          .agg(F.sum("v2"), F.count("*"), F.min("v"), F.max("v")))
    parts = df.query_execution.execute()
    assert all(b.row_mask.is_cuda for p in parts for b in p)
    before = SK.LAUNCHES["partition_histogram"]
    out = df.toArrow().sort_by("k")
    # 4 round-robin input tiles + 8 hash-exchange inputs + 8 partial tiles
    # x 1 count + 4 final tiles x 4 distinct weight tensors; the CPU run of
    # this query makes as many calls (tests/test_torch_dense_counts.py)
    assert SK.LAUNCHES["partition_histogram"] - before == 36
    live = v > 25
    cnt = np.bincount(k[live], minlength=5000)
    present = np.nonzero(cnt)[0]
    assert np.array_equal(out.column("k").to_numpy(), present)
    assert np.array_equal(out.column("count(1)").to_numpy(), cnt[present])
    s2 = np.bincount(k[live], weights=v[live] * 3, minlength=5000)
    assert np.array_equal(out.column("sum(v2)").to_numpy(),
                          s2[present].astype(np.int64))
