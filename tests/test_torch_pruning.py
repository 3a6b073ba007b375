"""Scan pruning in the port against the JAX package, case for case with
`tests/test_pruning.py`: static pruning (hive partition directories and
Parquet row-group statistics), IN pruning and dynamic partition pruning
from a join's build side, on and off. Each case runs in a fresh session of
each engine (TpuSession operator-at-a-time, fusion off; TorchSession on
the CPU) over the same files; the results and every `scan.*` metric (rows
read per scan, splits pruned) must be equal. The bloom runtime filter's
case holds its count of filtered rows to the reference's."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import NotPortedError, TorchSession  # noqa: E402

# the port side pinned to the operator tier, as the reference side is:
# these tests hold operator-at-a-time execution (tests/test_torch_fusion.py
# holds the stage tier)
CONF = {"spark.tpu.batch.capacity": 1 << 10,
        "spark.tpu.compile.tier": "operator"}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator"})


@pytest.fixture()
def part_dir(tmp_path):
    """Hive-partitioned fact table: part=0..3, two row groups per file with
    disjoint v ranges."""
    root = tmp_path / "fact"
    rng = np.random.default_rng(3)
    for p in range(4):
        d = root / f"part={p}"
        os.makedirs(d)
        t = pa.table({"v": np.arange(100) + p * 1000,
                      "w": rng.integers(0, 5, 100)})
        pq.write_table(t, d / "f.parquet", row_group_size=50)
    return str(root)


def _scan_metrics(engine, s) -> dict:
    m = s._metrics.snapshot()["counters"] if engine == "jax" \
        else s.metrics
    return {k: v for k, v in m.items() if k.startswith("scan.")}


def _run(part_dir, query, conf=None, dim=None):
    """query in a fresh session of each engine -> {engine: (rows, scan
    metrics)}; both must be equal."""
    out = {}
    for engine in ("jax", "torch"):
        extra = dict(conf or {})
        s = TpuSession("pruning", dict(JAX_CONF, **extra)) \
            if engine == "jax" else \
            TorchSession("pruning", dict(CONF, **extra), device="cpu")
        try:
            s.read.parquet(part_dir).createOrReplaceTempView("fact")
            if dim is not None:
                s.createDataFrame(dim).createOrReplaceTempView("dim")
            rows = s.sql(query).toArrow().to_pylist()
            out[engine] = (rows, _scan_metrics(engine, s))
        finally:
            s.stop()
    assert out["torch"] == out["jax"]
    return out["torch"]


def _rows_read(metrics) -> int:
    return sum(v for k, v in metrics.items() if k.endswith(".rows"))


def test_static_partition_pruning(part_dir):
    rows, m = _run(part_dir, "SELECT count(*) c FROM fact WHERE part = 2")
    assert rows == [{"c": 100}]
    assert _rows_read(m) == 100, m


def test_rowgroup_stats_pruning(part_dir):
    # v >= 3050 lives in the second row group of part=3 only
    rows, m = _run(part_dir, "SELECT count(*) c FROM fact WHERE v >= 3050")
    assert rows == [{"c": 50}]
    assert _rows_read(m) == 50, m


def test_in_predicate_pruning(part_dir):
    rows, m = _run(part_dir,
                   "SELECT count(*) c FROM fact WHERE part IN (0, 3)")
    assert rows == [{"c": 200}]
    assert _rows_read(m) == 200, m


def test_pruning_off_reads_everything(part_dir):
    rows, m = _run(part_dir, "SELECT count(*) c FROM fact WHERE v >= 3050",
                   conf={"spark.sql.parquet.filterPushdown": "false"})
    assert rows == [{"c": 50}]
    assert _rows_read(m) == 400, m


DIM = pa.table({"pk": [1, 3], "name": ["a", "b"]})


def test_dynamic_partition_pruning(part_dir):
    rows, m = _run(part_dir,
                   "SELECT count(*) c FROM fact JOIN dim ON fact.part = "
                   "dim.pk", dim=DIM)
    assert rows == [{"c": 200}]
    assert m["scan.dpp_pruned_splits"] == 2, m
    assert _rows_read(m) == 200, m


def test_dpp_disabled_still_correct(part_dir):
    rows, m = _run(part_dir,
                   "SELECT count(*) c FROM fact JOIN dim ON fact.part = "
                   "dim.pk", dim=DIM,
                   conf={"spark.sql.dynamicPartitionPruning.enabled":
                         "false"})
    assert rows == [{"c": 200}]
    assert m.get("scan.dpp_pruned_splits", 0) == 0, m
    assert _rows_read(m) == 400, m


def test_dpp_over_the_build_threshold_prunes_nothing(part_dir):
    rows, m = _run(part_dir,
                   "SELECT count(*) c FROM fact JOIN dim ON fact.part = "
                   "dim.pk", dim=DIM,
                   conf={"spark.sql.dynamicPartitionPruning.buildThreshold":
                         1})
    assert rows == [{"c": 200}]
    assert m.get("scan.dpp_pruned_splits", 0) == 0, m


def test_dpp_with_string_partitions(tmp_path):
    """A string partition column: the build side's dictionary codes are
    made distinct on the device and decoded to the partition values."""
    root = tmp_path / "sfact"
    for i, p in enumerate(("ca", "ny", "tx", "wa")):
        d = root / f"state={p}"
        os.makedirs(d)
        pq.write_table(pa.table({"v": np.arange(10) + 100 * i}),
                       d / "f.parquet")
    dim = pa.table({"st": ["tx", "ca", "zz"], "w": [1, 2, 3]})
    rows, m = _run(str(root),
                   "SELECT sum(v) s FROM fact JOIN dim ON fact.state = "
                   "dim.st", dim=dim)
    assert rows == [{"s": int(np.arange(10).sum() * 2 + 200 * 10)}]
    assert m["scan.dpp_pruned_splits"] == 2, m


def test_bloom_runtime_filter_is_not_ported(part_dir):
    """The bloom runtime join filter, ported with A7's slice, as the
    reference's test_bloom_runtime_filter_reduces_probe holds it: the
    count equals numpy's and the reference's, and the filter drops most
    probe rows (the same count of them as the reference's)."""
    counts = {}
    for name, make in (("torch", lambda: TorchSession(
            "pruning", dict(CONF), device="cpu")),
            ("jax", lambda: TpuSession("pruning-reference", dict(CONF)))):
        s = make()
        try:
            s.conf.set("spark.tpu.join.runtimeFilter.bloom", "true")
            s.conf.set("spark.sql.dynamicPartitionPruning.enabled", "false")
            rng = np.random.default_rng(5)
            # sparse keys: a dense build takes the direct-address probe,
            # which needs no filter
            fact = pa.table({"k": rng.integers(0, 1000, 4000) * 999_999_937,
                             "v": rng.standard_normal(4000)})
            dim = pa.table({"k": np.arange(0, 10) * 999_999_937,
                            "nm": [str(i) for i in range(10)]})
            s.createDataFrame(fact).createOrReplaceTempView("f")
            s.createDataFrame(dim).createOrReplaceTempView("d")
            out = s.sql("SELECT count(*) c FROM f JOIN d ON f.k = d.k") \
                .toArrow().to_pylist()
            want = int(np.isin(fact["k"].to_numpy(),
                               dim["k"].to_numpy()).sum())
            assert out == [{"c": want}]
            m = s.metrics if name == "torch" \
                else s._metrics.snapshot()["counters"]
            counts[name] = m.get("join.bloom_filtered_rows", 0)
        finally:
            s.stop()
    assert counts["torch"] > 4000 // 2, counts
    assert counts["torch"] == counts["jax"]
