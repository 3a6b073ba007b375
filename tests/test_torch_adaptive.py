"""The port's adaptive execution (spark_tpu_torch/physical/adaptive.py,
driven by exec/scheduler.py) against the JAX package's, as
`tests/test_adaptive.py` holds the reference's: the merge plan, a
coalesced aggregate and a coalesced join, full outer never broadcast,
broadcast demotion (and none with adaptive off, and the probe shuffle kept
where an aggregate above relies on the join's partitioning), the skew
split at 4x the median, and TPC-DS files with shuffled joins at scale 0.1
at the stage and operator tiers. Both engines run the same DataFrame or
SQL over the same numpy-seeded tables; the port's `aqe.*` counters equal
the reference's and the results are equal (row order ignored unless the
query sorts)."""

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as TF  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu.physical.adaptive import (  # noqa: E402
    plan_merge_groups as jax_merge_groups,
)
from spark_tpu_torch import TorchSession  # noqa: E402
from spark_tpu_torch.physical.adaptive import plan_merge_groups  # noqa: E402
from tests.test_torch_cuda import tpcds_query  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401

CONF = {"spark.sql.shuffle.partitions": 4, "spark.tpu.batch.capacity": 1 << 12}
# the reference operator-at-a-time over its host shuffle, the path the
# port's exchange follows (its mesh exchange makes one tile a partition)
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator",
                         "spark.tpu.mesh.enabled": "false"})
AQE = ("aqe.partitions_coalesced", "aqe.broadcast_demotions",
       "aqe.probe_shuffles_elided", "aqe.skew_splits")


def _jax_counters(s) -> dict:
    return s._metrics.snapshot()["counters"]


def _aqe(counters: dict) -> dict:
    return {k: counters.get(k, 0) for k in AQE}


def _rows(table, ordered: bool) -> list:
    rows = [tuple(r.values()) for r in table.to_pylist()]
    return rows if ordered else sorted(rows, key=repr)


def both(extra: dict, build, ordered: bool = False):
    """Run `build(session, F)` in fresh sessions of both engines under
    `extra`; returns (port rows, reference rows, port aqe counters,
    reference aqe counters)."""
    j = TpuSession("adaptive-reference", dict(JAX_CONF, **extra))
    t = TorchSession("adaptive", dict(CONF, **extra), device="cpu")
    try:
        want = _rows(build(j, JF).toArrow(), ordered)
        got = _rows(build(t, TF).toArrow(), ordered)
        return got, want, _aqe(t.metrics), _aqe(_jax_counters(j))
    finally:
        j.stop()
        t.stop()


@pytest.mark.parametrize("sizes,advisory", [
    ([1, 1, 1, 10, 1], 3), ([5, 5], 3), ([0, 0, 0], 3),
    ([7, 0, 2, 2, 9, 1, 1, 1], 4)])
def test_plan_merge_groups(sizes, advisory):
    assert plan_merge_groups(sizes, advisory) == \
        jax_merge_groups(sizes, advisory)
    assert plan_merge_groups([1, 1, 1, 10, 1], 3) == [[0, 1, 2], [3], [4]]


BIG_ADVISORY = {"spark.sql.adaptive.advisoryPartitionSizeInBytes": 1 << 30}


def test_coalesced_agg_correct():
    def q(s, F):
        return (s.range(0, 1000, 1, 8).groupBy((F.col("id") % 5).alias("m"))
                .agg(F.count("*").alias("c")).orderBy("m"))

    got, want, aqe, jaqe = both(BIG_ADVISORY, q, ordered=True)
    assert got == want == [(m, 200) for m in range(5)]
    assert aqe["aqe.partitions_coalesced"] > 0
    assert aqe == jaqe


def test_coalesced_join_correct():
    a = pa.table({"k": list(range(50)), "v": list(range(50))})
    b = pa.table({"k": list(range(0, 100, 2)), "w": list(range(50))})

    def q(s, F):
        return s.createDataFrame(a).repartition(4) \
            .join(s.createDataFrame(b).repartition(4), on="k") \
            .agg(F.count("*").alias("c"))

    got, want, aqe, jaqe = both(
        dict(BIG_ADVISORY, **{"spark.sql.autoBroadcastJoinThreshold": -1}),
        q)
    assert got == want == [(25,)]
    assert aqe["aqe.partitions_coalesced"] > 0
    assert aqe == jaqe


def test_full_outer_join_never_broadcast():
    """A replicated build side is unsound for full_outer (unmatched build
    rows would repeat per probe partition): the planner keeps the shuffled
    join however small the right side, and AQE never demotes it."""
    lt = pa.table({"k": [1, 2, 3, 4, 5, 6, 7, 8], "a": [1] * 8})
    rt = pa.table({"k": [1, 9], "b": [100, 900]})

    def q(s, F):
        s.createDataFrame(lt).repartition(4).createOrReplaceTempView("fo_l")
        s.createDataFrame(rt).createOrReplaceTempView("fo_r")
        return s.sql("SELECT b FROM fo_l FULL OUTER JOIN fo_r "
                     "ON fo_l.k = fo_r.k ORDER BY b NULLS LAST")

    got, want, aqe, jaqe = both({}, q, ordered=True)
    assert got == want == [(100,), (900,)] + [(None,)] * 7
    assert aqe["aqe.broadcast_demotions"] == 0
    assert aqe == jaqe


def _demotion_tables(n, keys):
    a = pa.table({"k": keys, "v": list(range(n))})
    b = pa.table({"k": list(range(0, 2 * n, 2)), "w": list(range(n))})
    return a, b


def test_aqe_broadcast_demotion():
    """The planner picks a shuffled join (stats over the threshold); the
    filtered build side's runtime size demotes it to broadcast and skips
    the probe side's shuffle."""
    a, b = _demotion_tables(1000, list(range(1000)))

    def q(s, F):
        s.createDataFrame(a).repartition(4).createOrReplaceTempView("aqe_a")
        s.createDataFrame(b).repartition(4).createOrReplaceTempView("aqe_b")
        return s.sql("SELECT count(*) AS c FROM aqe_a JOIN "
                     "(SELECT k, w FROM aqe_b WHERE w < 3) sb "
                     "ON aqe_a.k = sb.k")

    got, want, aqe, jaqe = both(
        {"spark.sql.autoBroadcastJoinThreshold": 200}, q)
    assert got == want == [(3,)]
    assert aqe["aqe.broadcast_demotions"] >= 1
    assert aqe["aqe.probe_shuffles_elided"] >= 1
    assert aqe == jaqe


def test_aqe_demotion_disabled_when_adaptive_off():
    a, b = _demotion_tables(100, list(range(100)))

    def q(s, F):
        return (s.createDataFrame(a).repartition(4)
                .join(s.createDataFrame(b).filter("w < 3"), on="k")
                .agg(F.count("*").alias("c")))

    got, want, aqe, jaqe = both(
        {"spark.sql.adaptive.enabled": "false",
         "spark.sql.autoBroadcastJoinThreshold": 200}, q)
    assert got == want == [(3,)]
    assert aqe["aqe.broadcast_demotions"] == 0
    assert aqe == jaqe


def test_aqe_demotion_preserves_partitioning_dependent_agg():
    """The probe shuffle stays where an aggregate above the join relies on
    the join's hash partitioning (a per-key aggregate over the join keys):
    results stay right, demoted or not."""
    a, b = _demotion_tables(1000, [1, 2, 3, 4] * 250)

    def q(s, F):
        s.createDataFrame(a).repartition(4).createOrReplaceTempView(
            "aqe_pk_a")
        s.createDataFrame(b).repartition(4).createOrReplaceTempView(
            "aqe_pk_b")
        return s.sql(
            "SELECT aqe_pk_a.k, count(*) c FROM aqe_pk_a JOIN "
            "(SELECT k FROM aqe_pk_b WHERE w < 3) sb "
            "ON aqe_pk_a.k = sb.k GROUP BY aqe_pk_a.k "
            "ORDER BY aqe_pk_a.k")

    got, want, aqe, jaqe = both(
        {"spark.sql.autoBroadcastJoinThreshold": 200}, q, ordered=True)
    assert got == want == [(2, 250), (4, 250)]
    assert aqe == jaqe


@pytest.mark.parametrize("skew_on", [True, False])
def test_skew_split_at_four_times_median(skew_on):
    """A probe partition over 4x the median rows (one hot key) splits into
    pieces that each meet the whole build partition; tiles of 512 rows
    give the hot partition several batches to split."""
    rng = np.random.default_rng(11)
    n = 40_000
    k = np.where(rng.random(n) < 0.6, 7, rng.integers(0, 5000, n))
    a = pa.table({"k": k, "v": rng.integers(0, 100, n)})
    b = pa.table({"k": np.arange(0, 5000), "w": np.arange(5000) % 13})

    def q(s, F):
        return (s.createDataFrame(a).repartition(4)
                .join(s.createDataFrame(b).repartition(4), on="k")
                .groupBy("w").agg(F.sum("v").alias("s"),
                                  F.count("*").alias("c")))

    got, want, aqe, jaqe = both(
        {"spark.sql.autoBroadcastJoinThreshold": -1,
         "spark.tpu.batch.capacity": 512,
         "spark.sql.adaptive.coalescePartitions.enabled": "false",
         "spark.sql.adaptive.skewJoin.enabled": str(skew_on).lower()}, q)
    assert got == want
    assert (aqe["aqe.skew_splits"] > 0) == skew_on
    assert aqe == jaqe


# TPC-DS files at scale 0.1 with their fact tables split into 4 partitions
# (round robin), a 4 KiB broadcast threshold (the larger builds shuffle,
# and filtered ones demote at run time) and a 64 KiB advisory partition
# size (adjacent partitions merge in part). Each of them coalesces, and
# most demote a join and skip its probe shuffle. Left out: files whose
# plans differ where the port merges the partials of an aggregate the
# reference runs in one pass over a demoted join's partitions (q5, q11,
# q13, q46, q50, q64, q68, q77, q80): there the counts of coalesced
# partitions differ, and the reference's results too (ROADMAP.md C).
TPCDS_SHUFFLED = ("q17", "q25", "q29", "q78", "q93", "q24a", "q85", "q49",
                  "q75", "q48")
TPCDS_FACTS = ("store_sales", "store_returns", "catalog_sales",
               "catalog_returns", "web_sales", "web_returns", "inventory")
TPCDS_CONF = {"spark.sql.shuffle.partitions": 4,
              "spark.tpu.batch.capacity": 1 << 10,
              "spark.sql.autoBroadcastJoinThreshold": 1 << 12,
              "spark.sql.adaptive.advisoryPartitionSizeInBytes": 1 << 16}


@pytest.fixture(scope="module")
def tpcds_tables():
    from tests.tpcds.datagen import gen_tpcds_full

    return gen_tpcds_full(scale=0.1)


def _views(session, tables) -> None:
    for name, tb in tables.items():
        df = session.createDataFrame(tb)
        if name in TPCDS_FACTS:
            df = df.repartition(4)
        df.createOrReplaceTempView(name)


@pytest.fixture(scope="module")
def tpcds_reference(tpcds_tables):
    """The reference at its operator tier, each query run once and kept."""
    j = TpuSession("adaptive-tpcds-reference",
                   dict(TPCDS_CONF, **{"spark.tpu.fusion.enabled": "false",
                                       "spark.tpu.compile.tier": "operator",
                                       "spark.tpu.mesh.enabled": "false"}))
    _views(j, tpcds_tables)
    runs: dict = {}

    def run(q):
        if q not in runs:
            before = _aqe(_jax_counters(j))
            out = j.sql(tpcds_query(q)).toArrow()
            after = _aqe(_jax_counters(j))
            runs[q] = (out, {k: after[k] - before[k] for k in AQE})
        return runs[q]

    yield run
    j.stop()


@pytest.fixture(scope="module")
def tpcds_port(tpcds_tables):
    made = {}

    def get(tier):
        if tier not in made:
            t = TorchSession("adaptive-tpcds", dict(
                TPCDS_CONF, **{"spark.tpu.compile.tier": tier,
                               "spark.tpu.fusion.minRows": 0}),
                device="cpu")
            _views(t, tpcds_tables)
            made[tier] = t
        return made[tier]

    yield get
    for t in made.values():
        t.stop()


@pytest.mark.parametrize("tier", ["operator", "stage"])
@pytest.mark.parametrize("q", TPCDS_SHUFFLED)
def test_tpcds_aqe_counters_match_reference(q, tier, tpcds_reference,
                                            tpcds_port):
    """The port's aqe counters over one query file equal the reference's
    (its operator tier: the fused stage tier keeps every exchange and
    join of the operator tier's plan, so the AQE decisions are the same),
    and the results are equal."""
    from tests.test_torch_fusion import _same

    want, jaqe = tpcds_reference(q)
    t = tpcds_port(tier)
    before = _aqe(t.metrics)
    df = t.sql(tpcds_query(q))
    got = df.toArrow()
    after = _aqe(t.metrics)
    aqe = {k: after[k] - before[k] for k in AQE}
    assert aqe == jaqe
    if tier == "stage":
        ops = {type(n).__name__ for n in df.query_execution.physical
               .iter_nodes()}
        assert "WholeQueryExec" not in ops
    _same(got, want, "order by" in tpcds_query(q).lower())


@pytest.mark.parametrize("key", ["spark.tpu.adaptive.runtimeFilter",
                                 "spark.tpu.adaptive.readmission"])
def test_unported_adaptive_switches_raise_when_on(key):
    """The reference's adaptive runtime filter and re-admission (off by
    default there) are not ported: turning one on raises NotPortedError,
    in the session's conf or by conf.set; off is the default's behaviour
    and runs."""
    from spark_tpu_torch import NotPortedError

    with pytest.raises(NotPortedError):
        TorchSession("adaptive-switch", {key: "true"}, device="cpu")
    t = TorchSession("adaptive-switch", {key: "false"}, device="cpu")
    try:
        with pytest.raises(NotPortedError):
            t.conf.set(key, True)
        t.conf.set(key, "false")
        assert t.range(0, 10, 1, 2).count() == 10
    finally:
        t.stop()
