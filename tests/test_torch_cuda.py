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


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,parts,key_hi", [
    (1 << 20, 8, 8), (1 << 20, 200, 200), (1 << 20, 1 << 18, 1 << 18),
    (1_000_003, 200, 300), (4096, 128, 400)])
def test_histogram_kernel_equals_plain(cuda_device, n, parts, key_hi):
    rng = np.random.default_rng(5)
    k = torch.from_numpy(rng.integers(-3, key_hi, n).astype(np.int32)) \
        .to(cuda_device)
    m = torch.from_numpy(rng.random(n) < 0.7).to(cuda_device)
    before = SK.LAUNCHES["partition_histogram"]
    got = SK.partition_histogram(k, m, parts)
    assert SK.LAUNCHES["partition_histogram"] == before + 1
    assert torch.equal(got, SK.partition_histogram_plain(k, m, parts))


@pytest.mark.parametrize("groups", [300, 1 << 20])
def test_group_sum_kernel_equals_plain(cuda_device, groups):
    rng = np.random.default_rng(6)
    n = 1 << 20
    k = torch.from_numpy(rng.integers(0, groups, n).astype(np.int32)) \
        .to(cuda_device)
    v = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda_device)
    m = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    got = SK.dense_group_sum_f32(k, v, m, groups)
    exp = SK.dense_group_sum_f32_plain(k, v, m, groups)
    # float32 atomics add in a varying order
    assert float(((got - exp).abs() / exp.abs().clamp_min(1.0)).max()) <= 1e-4


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
    assert SK.LAUNCHES["partition_histogram"] > before
    live = v > 25
    cnt = np.bincount(k[live], minlength=5000)
    present = np.nonzero(cnt)[0]
    assert np.array_equal(out.column("k").to_numpy(), present)
    assert np.array_equal(out.column("count(1)").to_numpy(), cnt[present])
    s2 = np.bincount(k[live], weights=v[live] * 3, minlength=5000)
    assert np.array_equal(out.column("sum(v2)").to_numpy(),
                          s2[present].astype(np.int64))
