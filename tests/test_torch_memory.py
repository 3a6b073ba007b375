"""The port's device budget (spark_tpu_torch/exec/memory.py) and its two
multi-pass paths, the external range-bucketed sort
(physical/external_sort.py) and the grace hash join
(HashJoinExec._grace_join), against the JAX package's, case for case with
`tests/test_memory.py`: the same queries in TpuSession (operator tier) and
TorchSession(device="cpu") over the same numpy-seeded tables, under a
budget of 512 KiB (tiles of at least 2^14 rows). Results equal the
reference's and numpy's, and the counters `sort.external.passes`,
`sort.external.oversizedBucket` and `join.grace.fragments` equal the
reference's; a TPC-DS file under a capped budget equals its run under the
auto budget."""

from collections import defaultdict

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as TF  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401

CONF = {"spark.sql.shuffle.partitions": 1, "spark.tpu.batch.capacity": 1 << 12,
        "spark.tpu.memory.deviceBudgetBytes": 1 << 19}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator",
                         "spark.tpu.mesh.enabled": "false"})
COUNTERS = ("sort.external.passes", "sort.external.oversizedBucket",
            "join.grace.fragments")


def _counts(m: dict) -> dict:
    return {k: m.get(k, 0) for k in COUNTERS}


def both(build, conf=None, tier="operator"):
    """(port Arrow, reference Arrow, port counters, reference counters) of
    `build(session, F)` in fresh sessions of both engines."""
    extra = dict(conf or {})
    j = TpuSession("memory-reference", dict(JAX_CONF, **extra))
    t = TorchSession("memory", dict(CONF, **extra,
                                    **{"spark.tpu.compile.tier": tier}),
                     device="cpu")
    try:
        want = build(j, JF).toArrow()
        got = build(t, TF).toArrow()
        return (got, want, _counts(t.metrics),
                _counts(j._metrics.snapshot()["counters"]))
    finally:
        j.stop()
        t.stop()


@pytest.mark.parametrize("tier", ["operator", "stage"])
def test_external_sort_ints(tier):
    rng = np.random.default_rng(0)
    vals = rng.integers(-1_000_000, 1_000_000, 100_000)
    got, want, c, jc = both(
        lambda s, F: s.createDataFrame(pa.table({"k": vals})).orderBy("k"),
        tier=tier)
    assert c["sort.external.passes"] > 0, "external sort path did not run"
    assert c == jc
    np.testing.assert_array_equal(got.column("k").to_numpy(), np.sort(vals))
    assert got.to_pylist() == want.to_pylist()


def test_external_sort_desc_with_nulls():
    rng = np.random.default_rng(1)
    n = 80_000
    vals = rng.integers(0, 10_000, n).astype(object)
    vals[rng.random(n) < 0.05] = None
    tbl = pa.table({"k": pa.array(list(vals), pa.int64())})
    got, want, c, jc = both(
        lambda s, F: s.createDataFrame(tbl).orderBy(
            F.col("k").desc_nulls_last()))
    nn = sorted([v for v in vals if v is not None], reverse=True)
    out = got.column("k").to_pylist()
    assert out[:len(nn)] == nn and all(v is None for v in out[len(nn):])
    assert len(out) == n
    assert c["sort.external.passes"] > 0 and c == jc
    assert out == want.column("k").to_pylist()


def test_external_sort_nulls_first_ascending():
    """Nulls sort first in an ascending sort by default: they take the
    first bucket."""
    rng = np.random.default_rng(8)
    n = 60_000
    vals = rng.integers(0, 50_000, n).astype(object)
    vals[rng.random(n) < 0.1] = None
    tbl = pa.table({"k": pa.array(list(vals), pa.int64())})
    got, _, c, _ = both(lambda s, F: s.createDataFrame(tbl).orderBy("k"))
    nn = sorted(v for v in vals if v is not None)
    nulls = n - len(nn)
    out = got.column("k").to_pylist()
    assert out[:nulls] == [None] * nulls and out[nulls:] == nn
    assert c["sort.external.passes"] > 0


def test_external_sort_multikey_ties_across_buckets():
    # the leading key has 7 values: every bucket boundary is a tie, and the
    # secondary order must still hold overall
    rng = np.random.default_rng(2)
    n = 60_000
    k1 = rng.integers(0, 7, n)
    k2 = rng.integers(0, 1_000_000, n)
    tbl = pa.table({"a": k1, "b": k2})
    got, want, c, jc = both(lambda s, F: s.createDataFrame(tbl).orderBy(
        "a", F.col("b").desc()))
    order = np.lexsort((-k2, k1))
    np.testing.assert_array_equal(got.column("a").to_numpy(), k1[order])
    np.testing.assert_array_equal(got.column("b").to_numpy(), k2[order])
    assert c == jc and got.to_pylist() == want.to_pylist()


def test_external_sort_strings():
    rng = np.random.default_rng(3)
    n = 50_000
    pool = [f"s{i:06d}" for i in range(5_000)]
    vals = [pool[i] for i in rng.integers(0, len(pool), n)]
    got, want, c, jc = both(
        lambda s, F: s.createDataFrame(pa.table({"k": vals})).orderBy("k"))
    assert got.column("k").to_pylist() == sorted(vals)
    assert c["sort.external.passes"] > 0 and c == jc
    assert got.to_pylist() == want.to_pylist()


def test_external_sort_buckets_match_reference():
    """The bucket bounds: the same samples and quantiles as the
    reference's, so the same count of buckets over the same rows."""
    from spark_tpu_torch.physical import external_sort as E

    rng = np.random.default_rng(9)
    vals = rng.integers(0, 1 << 40, 100_000)
    t = TorchSession("memory-buckets", dict(CONF), device="cpu")
    seen = []
    orig = E.range_partition_batch

    def spy(batch, kpos, bounds, descending, nulls_first, n):
        seen.append(n)
        return orig(batch, kpos, bounds, descending, nulls_first, n)

    E.range_partition_batch = spy
    try:
        t.createDataFrame(pa.table({"k": vals})).orderBy("k").toArrow()
    finally:
        E.range_partition_batch = orig
        t.stop()
    # 100,000 rows in 25 tiles of 4,096 (102,400 slots) against a tile
    # budget of 2^19 // (10 B * 3) = 17,476 rows: 2 * 6 = 12 buckets asked
    assert E.num_buckets(102_400, (1 << 19) // 30) == 12
    assert set(seen) == {12}
    assert t.metrics["sort.external.buckets"] == 12


def _pairs_oracle(lk, rk):
    rmap = defaultdict(list)
    for i, k in enumerate(rk):
        rmap[int(k)].append(i)
    n = sl = sr = 0
    for i, k in enumerate(lk):
        for j in rmap.get(int(k), ()):
            n += 1
            sl += i
            sr += j
    return n, sl, sr


@pytest.mark.parametrize("tier", ["operator", "stage"])
def test_grace_join_inner_and_outer(tier):
    rng = np.random.default_rng(4)
    n_left, n_right = 30_000, 60_000
    lk = rng.integers(0, 50_000, n_left)
    rk = rng.integers(0, 50_000, n_right)
    lt = pa.table({"k": lk, "lv": np.arange(n_left)})
    rt = pa.table({"k": rk, "rv": np.arange(n_right)})

    def inner(s, F):
        return (s.createDataFrame(lt).join(s.createDataFrame(rt), "k")
                .groupBy().agg(F.count("*").alias("n"),
                               F.sum("lv").alias("sl"),
                               F.sum("rv").alias("sr")))

    got, want, c, jc = both(inner, tier=tier)
    assert c["join.grace.fragments"] > 0, "grace join path did not run"
    assert c == jc
    n, sl, sr = _pairs_oracle(lk, rk)
    assert got.to_pylist() == want.to_pylist() == [
        {"n": n, "sl": sl, "sr": sr}]

    for jt in ("left_outer", "full_outer"):
        def outer(s, F, jt=jt):
            return (s.createDataFrame(lt).join(s.createDataFrame(rt), "k", jt)
                    .groupBy().agg(F.count("*").alias("n"),
                                   F.count("lv").alias("nl"),
                                   F.count("rv").alias("nr")))

        got, want, c, jc = both(outer, tier=tier)
        assert c["join.grace.fragments"] > 0 and c == jc
        unmatched_l = int((~np.isin(lk, rk)).sum())
        unmatched_r = int((~np.isin(rk, lk)).sum())
        extra = unmatched_r if jt == "full_outer" else 0
        assert got.to_pylist() == [{"n": n + unmatched_l + extra,
                                    "nl": n + unmatched_l,
                                    "nr": n + extra}]
        if jt == "left_outer":
            assert got.to_pylist() == want.to_pylist()
        else:
            # the reference's grace full outer join loses unmatched build
            # rows (ROADMAP.md C): the port is held to numpy alone
            assert want.to_pylist()[0]["n"] < got.to_pylist()[0]["n"]


def test_grace_resplit_not_degenerate():
    """Re-hashing a hash-partitioned partition spreads its rows across
    fragments: the grace split's seed differs from the exchange's (else
    h % nfrag is constant within a partition whenever nfrag divides the
    exchange's partition count), and the fragments equal the reference's."""
    from spark_tpu.columnar.batch import ColumnarBatch as JBatch
    from spark_tpu.exec.context import ExecContext as JContext
    from spark_tpu.exec.shuffle import shuffle_hash as jax_shuffle_hash
    from spark_tpu.types import StructField as JField
    from spark_tpu.types import StructType as JStruct
    from spark_tpu.types import int64 as jint64
    from spark_tpu_torch.columnar.batch import ColumnarBatch
    from spark_tpu_torch.exec.context import ExecContext
    from spark_tpu_torch.exec.shuffle import shuffle_hash
    from spark_tpu_torch.physical.operators import GRACE_SEED
    from spark_tpu_torch.types import StructField, StructType, int64

    rng = np.random.default_rng(7)
    keys = rng.integers(0, 1 << 40, 8192).astype(np.int64)
    schema = StructType([StructField("k", int64)])
    ctx = ExecContext()
    parts = shuffle_hash([[ColumnarBatch.from_numpy(schema, [keys])]], [0],
                         8, schema, ctx)
    part = max(parts, key=lambda p: sum(b.num_rows() for b in p))
    frags = shuffle_hash([part], [0], 4, schema, ctx, seed=GRACE_SEED)
    filled = [sum(b.num_rows() for b in f) for f in frags]
    assert sum(1 for n in filled if n > 0) >= 3, filled
    assert max(filled) < sum(filled), "all rows landed in one fragment"

    jschema = JStruct([JField("k", jint64)])
    jctx = JContext()
    jparts = jax_shuffle_hash([[JBatch.from_numpy(jschema, [keys])]], [0], 8,
                              jschema, jctx)
    jpart = max(jparts, key=lambda p: sum(b.num_rows() for b in p))
    jfrags = jax_shuffle_hash([jpart], [0], 4, jschema, jctx,
                              seed=0x9E3779B9)
    assert filled == [sum(b.num_rows() for b in f) for f in jfrags]


def test_grace_join_left_anti():
    rng = np.random.default_rng(5)
    lk = rng.integers(0, 40_000, 20_000)
    rk = rng.integers(0, 40_000, 60_000)
    lt = pa.table({"k": lk})
    rt = pa.table({"k": rk, "rv": np.arange(60_000)})
    got, want, c, jc = both(lambda s, F: s.createDataFrame(lt).join(
        s.createDataFrame(rt), "k", "left_anti"))
    expected = lk[~np.isin(lk, rk)]
    np.testing.assert_array_equal(np.sort(got.column("k").to_numpy()),
                                  np.sort(expected))
    assert c["join.grace.fragments"] > 0 and c == jc
    assert sorted(got.column("k").to_pylist()) == \
        sorted(want.column("k").to_pylist())


def test_grace_join_dense_build_in_fragments():
    """A unique dense build key takes the direct-address build inside each
    fragment, and the keys over the fragments still join exactly."""
    rng = np.random.default_rng(12)
    rk = rng.permutation(60_000)
    lk = rng.integers(0, 70_000, 30_000)
    lt = pa.table({"k": lk, "a": np.arange(30_000)})
    rt = pa.table({"k": rk, "b": np.arange(60_000)})
    t = TorchSession("memory-dense", dict(CONF), device="cpu")
    try:
        out = t.createDataFrame(lt).join(t.createDataFrame(rt), "k") \
            .toArrow()
        m = t.metrics
    finally:
        t.stop()
    assert m["join.grace.fragments"] > 0
    pos = np.empty(60_000, np.int64)
    pos[rk] = np.arange(60_000)
    hit = lk < 60_000
    want = sorted(zip(lk[hit].tolist(), np.arange(30_000)[hit].tolist(),
                      pos[lk[hit]].tolist()))
    assert sorted(tuple(r.values()) for r in out.to_pylist()) == want


def test_budget_resolution_explicit_and_floor():
    from spark_tpu.config import SQLConf as JConf
    from spark_tpu.exec.memory import MemoryManager as JManager
    from spark_tpu.types import StructField as JField
    from spark_tpu.types import StructType as JStruct
    from spark_tpu.types import int64 as jint64
    from spark_tpu_torch.config import SQLConf
    from spark_tpu_torch.exec.memory import MemoryManager, schema_row_bytes
    from spark_tpu_torch.types import StructField, StructType, int64

    schema = StructType([StructField("a", int64), StructField("b", int64)])
    jschema = JStruct([JField("a", jint64), JField("b", jint64)])
    for budget in (str(1 << 30), "1", "0"):
        conf, jconf = SQLConf(), JConf()
        conf.set("spark.tpu.memory.deviceBudgetBytes", budget)
        jconf.set("spark.tpu.memory.deviceBudgetBytes", budget)
        m, jm = MemoryManager(conf), JManager(jconf)
        if budget != "0":
            # the auto budget of the CPU reference is its own fallback
            assert m.device_budget == jm.device_budget
        for amp in (1, 3, 4):
            got = m.tile_rows(schema, amplification=amp)
            if budget != "0":
                assert got == jm.tile_rows(jschema, amplification=amp)
    conf = SQLConf()
    conf.set("spark.tpu.memory.deviceBudgetBytes", str(1 << 30))
    assert MemoryManager(conf).tile_rows(schema, amplification=3) == \
        (1 << 30) // (schema_row_bytes(schema) * 3)
    conf.set("spark.tpu.memory.deviceBudgetBytes", "1")
    # an explicit cap may push below the auto floor, never below 1 << 10
    assert MemoryManager(conf).tile_rows(schema) == 1 << 10
    # auto on the CPU: the reference's fallback of 4 GiB, floored at 2^14
    assert MemoryManager(SQLConf()).device_budget == 4 << 30
    conf.set("spark.tpu.memory.deviceBudgetBytes", "0")
    assert MemoryManager(conf).tile_rows(schema) == \
        (4 << 30) // (schema_row_bytes(schema) * 3)


# files whose sorts and joins meet the same tile capacities in both
# engines on the CPU; in others (q3, q12, q20, q42, q43, q52, q98) the
# port's CPU sorted-segment aggregate compacts a mostly dead input first,
# so its output tile, and the sort's budget decision over it, is smaller
# than the reference's (the card keeps the reference's capacities)
@pytest.mark.parametrize("q", ["q19", "q27", "q68"])
def test_tpcds_queries_under_capped_budget(q):
    """TPC-DS files at scale 0.1 give the same rows with the device budget
    capped low enough (64 KiB) that every join build and the larger sorts
    take their multi-pass paths, as under the auto budget; the capped
    run's counters and rows equal the reference's."""
    from tests.test_torch_cuda import tpcds_query
    from tests.tpcds.datagen import gen_tpcds_full
    from tests.tpcds.oracle import strip_trailing_limit

    tables = _tpcds_tables(gen_tpcds_full)
    sql = strip_trailing_limit(tpcds_query(q))
    results, counters = [], []
    for budget in (0, 1 << 16):
        conf = {"spark.sql.shuffle.partitions": 4,
                "spark.tpu.batch.capacity": 1 << 12,
                "spark.tpu.compile.tier": "operator",
                "spark.tpu.memory.deviceBudgetBytes": budget}
        t = TorchSession("memory-tpcds", dict(conf), device="cpu")
        try:
            for name, tab in tables.items():
                t.createDataFrame(tab).createOrReplaceTempView(name)
            results.append(sorted((tuple(r.values()) for r in
                                   t.sql(sql).toArrow().to_pylist()),
                                  key=repr))
            counters.append(_counts(t.metrics))
        finally:
            t.stop()
    assert results[0] == results[1], f"{q}: capped-budget results differ"
    assert counters[0] == _counts({})
    assert sum(counters[1].values()) > 0
    j = TpuSession("memory-tpcds-reference", dict(
        JAX_CONF, **{"spark.sql.shuffle.partitions": 4,
                     "spark.tpu.memory.deviceBudgetBytes": 1 << 16}))
    try:
        for name, tab in tables.items():
            j.createDataFrame(tab).createOrReplaceTempView(name)
        want = sorted((tuple(r.values())
                       for r in j.sql(sql).toArrow().to_pylist()), key=repr)
        jc = _counts(j._metrics.snapshot()["counters"])
    finally:
        j.stop()
    assert counters[1] == jc
    assert results[1] == want


_TABLES: dict = {}


def _tpcds_tables(gen):
    if not _TABLES:
        _TABLES.update(gen(scale=0.1))
    return _TABLES


def test_tiny_budget_floor_in_session():
    """The module's budget gives tiles of at least 2^14 rows: a sort of
    a partition under that stays one tile."""
    rng = np.random.default_rng(6)
    vals = rng.integers(0, 1000, 10_000)
    got, want, c, jc = both(
        lambda s, F: s.createDataFrame(pa.table({"k": vals})).orderBy("k"))
    assert c == jc == _counts({})
    assert got.to_pylist() == want.to_pylist()

