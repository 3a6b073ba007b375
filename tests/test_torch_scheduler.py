"""The port's stage scheduler (spark_tpu_torch/exec/scheduler.py) against
the JAX package's (`tests/test_scheduler.py`'s stage cases): the same
DataFrame queries through TpuSession and TorchSession(device="cpu"), the
stage graphs cut at the same exchanges, the scheduler's results equal to
the reference's and to running the plan tree directly, and the
deterministic stage retry (one retry, then the error)."""

import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as TF  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu.exec.scheduler import (  # noqa: E402
    build_stage_graph as jax_stage_graph,
)
from spark_tpu_torch import TorchSession  # noqa: E402
from spark_tpu_torch.exec.context import ExecContext  # noqa: E402
from spark_tpu_torch.exec.scheduler import (  # noqa: E402
    DAGScheduler, build_stage_graph,
)
from spark_tpu_torch.physical.operators import PhysicalPlan  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401

CONF = {"spark.sql.shuffle.partitions": 4, "spark.tpu.batch.capacity": 1 << 12}
# the reference executes operator-at-a-time (its fused stage tier takes the
# mesh path); its stage graphs are planned at either tier
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator"})


@pytest.fixture(scope="module")
def pair():
    j = TpuSession("scheduler-reference", dict(JAX_CONF))
    t = TorchSession("scheduler", dict(CONF), device="cpu")
    yield j, t
    j.stop()
    t.stop()


def _stage_shapes(stages) -> list:
    """Each stage's root operator and its count of parent stages."""
    return sorted((type(st.root).__name__, len(st.parents)) for st in stages)


def _grouped(spark, F):
    return (spark.range(0, 1000, 1, 4)
            .groupBy((F.col("id") % 7).alias("m"))
            .agg(F.count("*").alias("c")))


def test_stage_graph_cuts_at_exchanges(pair):
    j, t = pair
    result_stage, stages = build_stage_graph(
        _grouped(t, TF).query_execution.physical)
    _, jstages = jax_stage_graph(_grouped(j, JF).query_execution.physical)
    # one shuffle (partial -> final aggregate) + the result stage
    assert len(stages) == 2
    assert result_stage.parents[0] in stages
    assert _stage_shapes(stages) == _stage_shapes(jstages)


def _joined(spark, F):
    a = spark.range(0, 100, 1, 2).withColumn("k", F.col("id") % 10)
    b = spark.range(0, 50, 1, 2).withColumn("k", F.col("id") % 10)
    return a.join(b, on="k")


def test_stage_graph_join(pair):
    j, t = pair
    for s in pair:
        s.conf.set("spark.sql.autoBroadcastJoinThreshold", -1)
    try:
        _, stages = build_stage_graph(_joined(t, TF).query_execution.physical)
        _, jstages = jax_stage_graph(_joined(j, JF).query_execution.physical)
        assert len(stages) == 3  # two shuffle stages + result
        assert _stage_shapes(stages) == _stage_shapes(jstages)
        got = sorted(tuple(r.values())
                     for r in _joined(t, TF).toArrow().to_pylist())
        want = sorted(tuple(r.values())
                      for r in _joined(j, JF).toArrow().to_pylist())
        assert got == want
    finally:
        for s in pair:
            s.conf.unset("spark.sql.autoBroadcastJoinThreshold")


def _ordered_sums(spark, F):
    return (spark.range(0, 5000, 1, 8)
            .groupBy((F.col("id") % 13).alias("m"))
            .agg(F.sum("id").alias("s")).orderBy("m"))


def test_scheduler_results_match_direct(pair):
    j, t = pair
    before = t.metrics.get("scheduler.stages_completed", 0)
    df = _ordered_sums(t, TF)
    out = df.toArrow()
    assert out.to_pydict() == _ordered_sums(j, JF).toArrow().to_pydict()
    d = out.to_pydict()
    assert len(d["m"]) == 13 and sum(d["s"]) == sum(range(5000))
    assert t.metrics["scheduler.stages_completed"] > before
    # the plan tree run directly, without the scheduler, gives the same
    direct = [b for p in df.query_execution.physical.execute(
        t._exec_context()) for b in p]
    from spark_tpu_torch.columnar.arrow import batches_to_table

    assert batches_to_table(direct).to_pydict() == d


class _Flaky(PhysicalPlan):
    child_fields = ()

    def __init__(self, fail_times: int):
        self.calls = 0
        self.fail_times = fail_times

    @property
    def output(self):
        return []

    def execute(self, ctx):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise RuntimeError("transient" if self.fail_times == 1
                               else "permanent")
        return [[]]


def test_stage_retry():
    ctx = ExecContext()
    plan = _Flaky(1)
    assert DAGScheduler(ctx, max_attempts=2).run(plan) == [[]]
    assert plan.calls == 2
    snap = ctx.metrics.snapshot()
    assert snap["scheduler.stage_retries"] == 1
    assert snap["scheduler.stages_completed"] == 1


def test_stage_retry_exhausted():
    plan = _Flaky(10)
    with pytest.raises(RuntimeError, match="permanent"):
        DAGScheduler(ExecContext(), max_attempts=2).run(plan)
    assert plan.calls == 2


def test_whole_program_is_one_stage(pair):
    """A whole-tier program holds no exchange node: one stage."""
    _, t = pair
    t.conf.set("spark.tpu.compile.tier", "whole")
    t.conf.set("spark.tpu.fusion.minRows", 0)
    try:
        df = _grouped(t, TF)
        plan = df.query_execution.physical
        assert type(plan).__name__ == "WholeQueryExec"
        _, stages = build_stage_graph(plan)
        assert len(stages) == 1
        assert sorted(df.toArrow().to_pydict()["c"]) == \
            sorted([143] * 6 + [142])
    finally:
        t.conf.unset("spark.tpu.compile.tier")
        t.conf.unset("spark.tpu.fusion.minRows")


def test_fused_exchange_is_cut(pair):
    """At the stage tier a shuffle that absorbed its pipeline
    (ExchangeFusion) is still a stage boundary, where the reference cuts."""
    j, t = pair
    for s in pair:
        s.conf.set("spark.tpu.compile.tier", "stage")
        s.conf.set("spark.tpu.fusion.minRows", 0)
    j.conf.set("spark.tpu.fusion.enabled", "true")
    try:
        tbl = pa.table({"k": [i % 17 for i in range(3000)],
                        "v": list(range(3000))})

        def q(s, F):
            return (s.createDataFrame(tbl).filter(F.col("v") > 10)
                    .repartition(4, "k").groupBy("k")
                    .agg(F.sum("v").alias("s")))

        plan = q(t, TF).query_execution.physical
        fused = [n for n in plan.iter_nodes()
                 if type(n).__name__ == "ShuffleExchangeExec"
                 and n.pipe_fusion is not None]
        assert fused
        _, stages = build_stage_graph(plan)
        _, jstages = jax_stage_graph(q(j, JF).query_execution.physical)
        assert len(stages) == len(jstages)
        assert any(type(st.root).__name__ == "ShuffleExchangeExec"
                   and st.root.pipe_fusion for st in stages)
        for k, v in JAX_CONF.items():
            j.conf.set(k, v)
        got = sorted(tuple(r.values()) for r in q(t, TF).toArrow().to_pylist())
        want = sorted(tuple(r.values())
                      for r in q(j, JF).toArrow().to_pylist())
        assert got == want
    finally:
        t.conf.unset("spark.tpu.compile.tier")
        for s in pair:
            s.conf.unset("spark.tpu.fusion.minRows")
        for k, v in JAX_CONF.items():
            j.conf.set(k, v)


@pytest.mark.parametrize("threshold", [-1, 10 * 1024 * 1024])
def test_dpp_build_runs_first_across_stages(tmp_path, threshold):
    """Dynamic partition pruning holds across stages: where the join is
    shuffled, the probe side's partitioned scan sits in a stage of its own
    below the probe shuffle, and the scheduler runs the build side's
    stages first and installs the join's split filter before that scan
    runs, as HashJoinExec.execute does inside one stage (the plan tree run
    directly prunes the same splits). Broadcast or shuffled, the rows
    equal the reference's."""
    import os

    import numpy as np
    import pyarrow.parquet as pq

    root = tmp_path / "fact"
    for p in range(6):
        os.makedirs(root / f"part={p}")
        pq.write_table(pa.table({"v": np.arange(50) + 100 * p}),
                       root / f"part={p}" / "f.parquet")
    dim = pa.table({"pk": [1, 4, 9], "w": [10, 40, 90]})
    conf = {"spark.tpu.compile.tier": "operator",
            "spark.sql.autoBroadcastJoinThreshold": threshold}
    query = ("SELECT part, sum(v) s, sum(w) t FROM fact JOIN dim "
             "ON fact.part = dim.pk GROUP BY part")
    rows, pruned = {}, []
    for name, make in (
            ("torch", lambda: TorchSession("dpp-stages", dict(CONF, **conf),
                                           device="cpu")),
            ("jax", lambda: TpuSession("dpp-stages-reference",
                                       dict(JAX_CONF, **conf)))):
        s = make()
        try:
            s.read.parquet(str(root)).createOrReplaceTempView("fact")
            s.createDataFrame(dim).createOrReplaceTempView("dim")
            df = s.sql(query)
            rows[name] = sorted(tuple(r.values())
                                for r in df.toArrow().to_pylist())
            if name == "torch":
                pruned.append(s.metrics.get("scan.dpp_pruned_splits", 0))
                plan = df.query_execution.physical
                if threshold < 0:
                    _, stages = build_stage_graph(plan)
                    assert len(stages) >= 3  # the probe scan's own stage
                plan.execute(s._exec_context())
                pruned.append(s.metrics["scan.dpp_pruned_splits"]
                              - pruned[0])
        finally:
            s.stop()
    assert rows["torch"] == rows["jax"] == [(1, 6225, 500), (4, 21225, 2000)]
    assert pruned[0] == pruned[1] == 4
