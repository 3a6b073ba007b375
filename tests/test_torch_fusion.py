"""The stage tier of the port (physical/fusion.py, spark.tpu.fusion.minRows
0) against the JAX package's stage tier (spark.tpu.fusion.enabled=true,
spark.tpu.compile.tier=stage, minRows 0) on the same numpy-seeded tables,
and against the port's own operator tier: every case of
tests/test_fusion.py that applies (cluster mode is not ported). Integers and
strings compare exactly, float sums to relative 1e-12. Plans: the operator
sequences of the chip_smoke legs' queries and of all 103 TPC-DS query files
equal the reference's at the stage tier (planning only)."""

import math
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as TF  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import NotPortedError, TorchSession  # noqa: E402
from spark_tpu_torch.physical.compile import STAGE_CACHE  # noqa: E402
from tests.test_torch_cuda import tpcds_query  # noqa: E402
from tests.test_torch_tpcds_slice import (  # noqa: E402
    _ops, _reference_ops, _renumber,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = {"spark.sql.shuffle.partitions": 4,
        "spark.tpu.batch.capacity": 1 << 12,
        "spark.tpu.fusion.minRows": 0}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "true",
                         "spark.tpu.compile.tier": "stage"})
OPERATOR = {"spark.tpu.compile.tier": "operator"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op pool at one thread while a module of the port's
    CPU tests runs, restored after: their tensors are small, and beside
    the other workers of a parallel run (pytest-xdist) a pool of one
    thread per core oversubscribes the machine, which made such a module
    run 2-9 times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sessions():
    j = TpuSession("fusion-reference", dict(JAX_CONF))
    t = TorchSession("fusion", dict(CONF), device="cpu")
    rng = np.random.default_rng(7)
    n = 5000
    fu = pa.table({"k": rng.integers(0, 13, n),
                   "v": rng.integers(-50, 100, n),
                   "f": rng.random(n),
                   "s": [f"cat{i % 5}" for i in range(n)]})
    dim = pa.table({"dk": np.arange(13, dtype=np.int64),
                    "label": [f"lab{i % 3}" for i in range(13)]})
    rng = np.random.default_rng(11)
    n = 6000
    ex = pa.table({"k": rng.integers(0, 13, n),
                   "v": rng.integers(-50, 100, n),
                   "s": [f"cat{i % 5}" for i in range(n)]})
    for s in (j, t):
        s.createDataFrame(fu).createOrReplaceTempView("fu_t")
        s.createDataFrame(dim).createOrReplaceTempView("fu_dim")
        s.createDataFrame(ex).createOrReplaceTempView("ex_t")
    yield j, t
    j.stop()
    t.stop()


def _rows(table, ordered: bool = False):
    rows = list(zip(*[c.to_pylist() for c in table.columns]))
    return rows if ordered else sorted(rows, key=repr)


def _same(got, want, ordered: bool = False) -> None:
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows, (got.num_rows, want.num_rows)
    for a, b in zip(_rows(got, ordered), _rows(want, ordered)):
        for x, y in zip(a, b):
            if isinstance(y, float) and isinstance(x, float):
                assert x == y or math.isclose(x, y, rel_tol=1e-12) \
                    or (math.isnan(x) and math.isnan(y)), (a, b)
            else:
                assert x == y, (a, b)


def _fused_nodes(df) -> list:
    return [type(n).__name__ for n in df.query_execution.physical.iter_nodes()
            if type(n).__name__.startswith("Fused")
            or getattr(n, "probe_fusion", None) is not None
            or getattr(n, "pipe_fusion", None) is not None]


def _operator(t: TorchSession, build):
    """`build(t)` planned and run at the port's operator tier."""
    t.conf.set("spark.tpu.compile.tier", "operator")
    try:
        return build(t).toArrow()
    finally:
        t.conf.unset("spark.tpu.compile.tier")


def _three_way(sessions, build, ordered: bool = False, fused=True):
    """The port's stage tier against the reference's stage tier and the
    port's operator tier; `fused` asks the port's plan to fuse."""
    j, t = sessions
    df = build(t)
    if fused:
        assert _fused_nodes(df), df.query_execution.physical.tree_string()
    got = df.toArrow()
    _same(got, build(j).toArrow(), ordered)
    _same(got, _operator(t, build), ordered)
    return df


SQL_CASES = {
    "filter_project_agg": (
        "select k, sum(v * 2) sv, count(*) c, min(v) mn, max(v+1) mx, "
        "avg(f) af from fu_t where v > 0 group by k"),
    "ungrouped": ("select count(*) c, sum(v) sv, min(v) mn from fu_t "
                  "where v > 20"),
    "string_keys": ("select s, k, count(*) c, sum(v) sv from fu_t "
                    "where v != 7 group by s, k"),
    "string_key_dense": ("select s, count(*) c, sum(v) sv, avg(f) af "
                         "from fu_t where v > 3 group by s"),
    "join_agg": ("select label, sum(v) sv, count(*) c from fu_t "
                 "join fu_dim on k = dk where v > 10 group by label"),
    "limit": ("select k + v * 100 as key2 from fu_t where v > 95 "
              "order by key2 limit 17"),
}


@pytest.mark.parametrize("name", list(SQL_CASES))
def test_sql_differential(sessions, name):
    text = SQL_CASES[name]
    # the ORDER BY + LIMIT case plans TopK: a sort is no fusion terminal
    _three_way(sessions, lambda s: s.sql(text),
               ordered=name == "limit", fused=name != "limit")


def test_limit_without_sort_fuses(sessions):
    # a bare LIMIT over a filter/project: FusedLimitExec (which rows a
    # limit keeps is the first live ones in scan order on both engines)
    j, t = sessions
    df = _three_way(sessions, lambda s: s.sql(
        "select k * 2 k2, v from fu_t where v > 90 limit 23"), ordered=True)
    assert "FusedLimitExec" in _fused_nodes(df)


def test_probe_fusion_sorted_probe(sessions):
    # a two-key join over a computed probe key: the sorted probe program
    t = sessions[1]
    t.conf.set("spark.sql.autoBroadcastJoinThreshold", 1024)
    try:
        df = _three_way(sessions, lambda s: s.sql(
            "select a.k, a.s, b.v bv, a.v * 2 av2 from ex_t a join "
            "(select k kk, s ss, v from fu_t where v > 90) b "
            "on a.k + 0 = b.kk and a.s = b.ss where a.v < -40"))
    finally:
        t.conf.unset("spark.sql.autoBroadcastJoinThreshold")
    join = next(n for n in df.query_execution.physical.iter_nodes()
                if type(n).__name__ == "HashJoinExec")
    assert join.probe_fusion is not None


@pytest.mark.parametrize("how", ["inner", "left_outer", "left_semi",
                                 "left_anti", "full_outer"])
def test_probe_fusion_join_types(sessions, how):
    # the dense direct-address probe with the probe pipeline in its
    # program (full outer materialises the pipeline first, as the
    # reference does)
    def build(s):
        F = JF if isinstance(s, TpuSession) else TF
        a = s.table("ex_t").filter(F.col("v") > 60) \
            .withColumn("k2", F.col("k") + 1)
        b = s.table("fu_dim")
        return a.join(b, a["k2"] == b["dk"], how)

    _three_way(sessions, build)


def test_tpcds_mini_q3_q7_differential(sessions):
    from tests.tpcds.datagen import gen_tpcds_full

    tables = gen_tpcds_full(scale=0.01)
    j, t = sessions
    for name in ("store_sales", "date_dim", "item"):
        j.createDataFrame(tables[name]).createOrReplaceTempView(name)
        t.createDataFrame(tables[name]).createOrReplaceTempView(name)
    q3 = """
        SELECT dt.d_year, item.i_brand_id AS brand_id,
               SUM(ss_ext_sales_price) AS sum_agg
        FROM date_dim dt, store_sales, item
        WHERE dt.d_date_sk = store_sales.ss_sold_date_sk
          AND store_sales.ss_item_sk = item.i_item_sk
          AND item.i_manufact_id = 28 AND dt.d_moy = 11
        GROUP BY dt.d_year, item.i_brand_id"""
    q7 = """
        SELECT i.i_category, AVG(ss_quantity) AS agg1, COUNT(*) AS cnt
        FROM store_sales ss
        JOIN item i ON ss.ss_item_sk = i.i_item_sk
        JOIN date_dim d ON ss.ss_sold_date_sk = d.d_date_sk
        WHERE d.d_year = 1999
        GROUP BY i.i_category"""
    for q in (q3, q7):
        _three_way(sessions, lambda s, q=q: s.sql(q))


def test_adjacent_computes_collapse(sessions):
    from spark_tpu_torch.physical.operators import ComputeExec

    t = sessions[1]
    rng = np.random.default_rng(6)
    tb = pa.table({"x": rng.integers(0, 100, 500)})
    df = (t.createDataFrame(tb).withColumn("y", TF.col("x") * 2)
          .filter(TF.col("y") > 10).select((TF.col("y") + 1).alias("z")))
    plan = df.query_execution.physical
    for node in plan.iter_nodes():
        if isinstance(node, ComputeExec):
            assert not isinstance(node.child, ComputeExec), \
                plan.tree_string()
    x = tb.column("x").to_numpy()
    assert sorted(df.toArrow().column("z").to_pylist()) == \
        sorted((x[x * 2 > 10] * 2 + 1).tolist())


# --- exchange map-side fusion ------------------------------------------------

def test_exchange_fusion_hash_differential(sessions):
    _three_way(sessions, lambda s: s.sql(
        "select k, v * 2 as v2, s from ex_t where v > 0").repartition(5, "k"))


def test_exchange_fusion_string_hash_differential(sessions):
    _three_way(sessions, lambda s: s.sql(
        "select s, v + 1 as v1 from ex_t where v > 10").repartition(3, "s"))


def test_exchange_fusion_rr_differential(sessions):
    _three_way(sessions, lambda s: s.sql(
        "select k + 1 as k2, v from ex_t where v != 7").repartition(3))


def test_exchange_fusion_range_differential(sessions):
    def build(s):
        F = JF if isinstance(s, TpuSession) else TF
        return (s.range(0, 30000, 1, 3).filter(F.col("id") > 1234)
                .withColumn("y", F.col("id") * 3).orderBy("id"))

    _three_way(sessions, build, ordered=True)


def _exchange(df):
    from spark_tpu_torch.physical.exchange import ShuffleExchangeExec

    return next(n for n in df.query_execution.physical.iter_nodes()
                if isinstance(n, ShuffleExchangeExec))


def test_fused_range_bounds_sample_post_pipeline(sessions):
    """The fused range exchange samples its bounds from the POST-pipeline
    key: a selective filter leaves every reducer a share of the survivors
    (pre-pipeline sampling would put them all in the last one)."""
    t = sessions[1]
    df = (t.range(0, 30000, 1, 3).filter(TF.col("id") >= 27000)
          .withColumn("y", TF.col("id") * 2).orderBy("id"))
    ex = _exchange(df)
    assert ex.pipe_fusion is not None, \
        df.query_execution.physical.tree_string()
    parts = ex.execute(t._exec_context())
    sizes = [sum(b.num_rows() for b in p) for p in parts]
    assert sum(sizes) == 3000
    assert all(s > 0 for s in sizes), sizes
    assert max(sizes) <= 2 * (sum(sizes) / len(sizes)), sizes
    assert df.toArrow().column("id").to_pylist() == list(range(27000, 30000))


def test_fused_range_computed_key_fuses(sessions):
    def build(s):
        F = JF if isinstance(s, TpuSession) else TF
        return (s.range(0, 20000, 1, 3).filter(F.col("id") < 17000)
                .select((F.col("id") * 2 + 1).alias("key2"))
                .orderBy("key2"))

    df = _three_way(sessions, build, ordered=True)
    assert _exchange(df).pipe_fusion is not None


def _delta(t: TorchSession, run) -> dict:
    before = t.launches.snapshot()
    run()
    after = t.launches.snapshot()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def test_exchange_fused_single_dispatch_per_map_batch(sessions):
    t = sessions[1]
    cap, n_batches = 1 << 12, 4
    rng = np.random.default_rng(12)
    tb = pa.table({"k": rng.integers(0, 9, cap * n_batches),
                   "v": rng.integers(0, 100, cap * n_batches)})
    base = t.createDataFrame(tb)

    def q():
        return (base.filter(TF.col("v") > 25)
                .withColumn("v2", TF.col("v") * 3)
                .repartition(5, "k").toArrow())

    q()
    delta = _delta(t, q)
    assert delta == {"fused_shuffle": n_batches}, delta
    t.conf.set("spark.tpu.fusion.exchange", "false")
    try:
        q()
        unfused = _delta(t, q)
    finally:
        t.conf.unset("spark.tpu.fusion.exchange")
    assert unfused == {"pipeline": n_batches, "shuffle_hash": n_batches}, \
        unfused


def test_exchange_fusion_minrows_gate(sessions):
    """Partitions under spark.tpu.fusion.minRows take the unfused kernels
    at run time though the PLAN carries the fused exchange; the gated
    batches are counted."""
    t = sessions[1]
    rng = np.random.default_rng(13)
    tb = pa.table({"k": rng.integers(0, 9, 3000),
                   "v": rng.integers(0, 100, 3000)})
    df = t.createDataFrame(tb)
    t.conf.set("spark.tpu.fusion.minRows", str(1 << 17))
    try:
        def q():
            return df.filter(TF.col("v") > 25).repartition(5, "k").toArrow()

        q()
        gated = t.metrics.get("fusion.min_rows_gated", 0)
        delta = _delta(t, q)
        assert t.metrics.get("fusion.min_rows_gated", 0) == gated + 1
    finally:
        t.conf.set("spark.tpu.fusion.minRows", 0)
    assert delta == {"pipeline": 1, "shuffle_hash": 1}, delta


def test_fused_stage_single_dispatch_per_batch(sessions):
    """A scan -> filter -> project -> partial aggregate stage runs as ONE
    fused program per input batch; the only pipeline left is the
    finishing projection over the buffers."""
    t = sessions[1]
    cap, n_batches = 1 << 12, 4
    rng = np.random.default_rng(3)
    tb = pa.table({"k": rng.integers(0, 8, cap * n_batches),
                   "v": rng.integers(0, 100, cap * n_batches)})
    df = t.createDataFrame(tb)

    def q():
        return (df.filter(TF.col("v") > 25).withColumn("v2", TF.col("v") * 3)
                .groupBy("k").agg(TF.sum("v2").alias("s")).toArrow())

    q()
    delta = _delta(t, q)
    assert delta.get("fused_agg", 0) == n_batches, delta
    assert delta.get("pipeline", 0) <= 1, delta
    assert sum(delta.values()) <= n_batches + 4, delta
    # the operator tier runs a pipeline per batch besides (its aggregate
    # folds the partition's batches in one pass)
    t.conf.set("spark.tpu.compile.tier", "operator")
    try:
        q()
        oracle = _delta(t, q)
    finally:
        t.conf.unset("spark.tpu.compile.tier")
    assert oracle.get("pipeline", 0) == n_batches + 1, oracle
    assert sum(delta.values()) <= sum(oracle.values()), (delta, oracle)


def test_structurally_identical_queries_share_programs(sessions):
    """Two plans of one shape (other attribute ids, other tables) key the
    same programs: the second builds none."""
    t = sessions[1]
    rng = np.random.default_rng(5)

    def q(seed):
        tb = pa.table({"a": rng.integers(0, 9, 2000),
                       "b": rng.integers(0, 50, 2000)})
        return (t.createDataFrame(tb).filter(TF.col("b") > 5).groupBy("a")
                .agg(TF.sum("b").alias("s")).toArrow())

    q(1)
    built = STAGE_CACHE.captures
    hits = STAGE_CACHE.hits
    q(2)
    assert STAGE_CACHE.captures == built
    assert STAGE_CACHE.hits > hits


def test_dense_range_sync_memoized_across_batches(sessions):
    """Repeated runs over cached scan tiles do not re-sync the dense-range
    scalars: one sync per distinct column identity, not one per run."""
    t = sessions[1]
    rng = np.random.default_rng(8)
    tb = pa.table({"k": rng.integers(0, 16, 4000),
                   "v": rng.integers(0, 10, 4000)})
    df = t.createDataFrame(tb)

    def run():
        df.filter(TF.col("v") > 0).groupBy("k") \
            .agg(TF.count("*").alias("c")).toArrow()

    run()
    syncs = t.metrics.get("dense_range.syncs", 0)
    run()
    assert t.metrics.get("dense_range.syncs", 0) == syncs
    assert t.metrics.get("agg.dense_fast_path", 0) > 0


def test_string_minmax_not_ported_in_either_tier(sessions):
    # string MIN/MAX (A3's) runs at both tiers since its slice: the fused
    # aggregate reduces in rank space with the rank luts as program
    # inputs, as the reference's does, equal to the reference and to the
    # operator tier
    _three_way(sessions, lambda s: s.sql(
        "select k, min(s) mn, max(s) mx from ex_t where v > 0 group by k"))


# --- tiers ---------------------------------------------------------------------

def test_auto_resolves_to_stage_with_its_reason(sessions, capsys):
    # an exchange-free plan: the cost model keeps it at the stage tier, with
    # the reference's reason (stage fusion is already one program per
    # batch there)
    j, t = sessions
    text = "select k, sum(v) s from fu_t where v > 1 group by k"
    df = t.sql(text)
    d = df.query_execution.tier_decision
    j.conf.set("spark.tpu.compile.tier", "auto")
    try:
        want = j.sql(text).query_execution.physical._tier_decision
    finally:
        j.conf.set("spark.tpu.compile.tier", "stage")
    assert (d.tier, d.reason) == (want.tier, want.reason) == (
        "stage", "whole-query fallback: no exchange round-trips to "
        "eliminate (single-stage plan — stage fusion already dispatches "
        "once per batch)")
    df.explain()
    out = capsys.readouterr().out
    assert "== Compile Tier ==" in out
    assert "stage (whole-query fallback: no exchange round-trips" in out
    assert "FusedHashAggregate[partial]" in out


@pytest.mark.parametrize("conf,tier", [
    ({"spark.tpu.compile.tier": "stage"}, "stage"),
    ({"spark.tpu.compile.tier": "operator"}, "operator"),
    ({"spark.tpu.fusion.enabled": "false"}, "operator"),
    ({"spark.tpu.fusion.enabled": "false",
      "spark.tpu.compile.tier": "stage"}, "operator"),
])
def test_tier_keys_on_a_live_session(sessions, conf, tier):
    t = sessions[1]
    for k, v in conf.items():
        t.conf.set(k, v)
    try:
        df = t.sql("select k, sum(v) s from fu_t where v > 1 group by k")
        assert df.query_execution.tier_decision.tier == tier
        assert bool(_fused_nodes(df)) == (tier == "stage")
    finally:
        for k in conf:
            t.conf.unset(k)


@pytest.mark.parametrize("tier,module", [
    ("mesh-whole", "physical/mesh_whole.py")])
def test_whole_tiers_raise_not_ported(tier, module):
    t = TorchSession("whole", dict(CONF, **{"spark.tpu.compile.tier": tier}),
                     device="cpu")
    with pytest.raises(NotPortedError, match=module):
        t.range(0, 10).toArrow()


@pytest.mark.parametrize("key", ["spark.tpu.fusion.mesh",
                                 "spark.tpu.memory.budget"])
def test_unported_tier_keys_raise(key):
    with pytest.raises(NotPortedError, match=key):
        TorchSession("keys", {key: "true"}, device="cpu")
    t = TorchSession("keys", dict(CONF), device="cpu")
    with pytest.raises(NotPortedError, match=key):
        t.conf.set(key, "1")


def test_operator_tier_reproduces_the_unfused_plan(sessions):
    from spark_tpu_torch.config import SQLConf
    from spark_tpu_torch.physical.planner import Planner

    t = sessions[1]
    for text in SQL_CASES.values():
        df = t.sql(text)
        plain = Planner(SQLConf(dict(CONF, **OPERATOR))).plan(
            df.query_execution.optimized)
        off = Planner(SQLConf(dict(CONF, **{
            "spark.tpu.fusion.enabled": "false"}))).plan(
            df.query_execution.optimized)
        assert _renumber(plain.tree_string()) == \
            _renumber(off.tree_string())
        assert not any(type(n).__name__.startswith("Fused")
                       for n in plain.iter_nodes())


def test_purity_with_fusion_on():
    code = (
        "import sys, numpy as np, pyarrow as pa\n"
        # jax and the reference absent: importing either raises
        "sys.modules.update({'jax': None, 'spark_tpu': None})\n"
        "from spark_tpu_torch import TorchSession\n"
        "import spark_tpu_torch.api.functions as F\n"
        "s = TorchSession('purity', {'spark.tpu.batch.capacity': 4096,"
        " 'spark.tpu.fusion.minRows': 0}, device='cpu')\n"
        "t = pa.table({'k': np.arange(9000) % 13, 'v': np.arange(9000)})\n"
        "df = (s.createDataFrame(t).filter(F.col('v') > 5)"
        ".withColumn('w', F.col('v') * 2).repartition(3, 'k')"
        ".groupBy('k').agg(F.sum('w')))\n"
        "assert 'FUSED-MAP' in df.query_execution.physical.tree_string()\n"
        "assert df.toArrow().num_rows == 13\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and ("
        "m == 'jax' or m.startswith('jax.') or m == 'spark_tpu'"
        " or m.startswith('spark_tpu.'))]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


# --- plans -------------------------------------------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leg_queries(s, F, Window=None):
    """The chip_smoke legs' DataFrame queries over small tables."""
    rng = np.random.default_rng(42)
    n = 20000
    k, v = rng.integers(0, 5000, n), rng.integers(0, 1000, n)
    main = s.createDataFrame(pa.table({"k": k, "v": v}))
    dsk = np.arange(2415022, 2415022 + 3000)
    sales = s.createDataFrame(pa.table({
        "ss_sold_date_sk": rng.integers(2415022, 2415022 + 3000, n),
        "ss_ext_sales_price": rng.random(n)}))
    dates = s.createDataFrame(pa.table({
        "d_date_sk": dsk, "d_year": 1998 + (dsk - 2415022) // 365}))
    ticket = np.arange(n) // 10
    item = rng.integers(1, 500, n)
    ss = s.createDataFrame(pa.table({
        "ss_ticket_number": ticket, "ss_item_sk": item,
        "ss_store_sk": rng.integers(1, 50, n),
        "ss_net_paid": rng.random(n) * 100}))
    idx = rng.choice(n, n // 10, replace=False)
    sr = s.createDataFrame(pa.table({
        "sr_ticket_number": ticket[idx], "sr_item_sk": item[idx],
        "sr_return_amt": rng.random(len(idx)) * 50}))
    cond = (ss["ss_ticket_number"] == sr["sr_ticket_number"]) & \
        (ss["ss_item_sk"] == sr["sr_item_sk"])
    w = Window.partitionBy("k").orderBy(F.desc("v"))
    return {
        "main": (main.filter(F.col("v") > 25).withColumn("v2", F.col("v") * 3)
                 .repartition(4).groupBy("k")
                 .agg(F.sum("v2"), F.count("*"), F.min("v"), F.max("v"),
                      F.avg("v"))),
        "join": (sales.join(dates, sales["ss_sold_date_sk"]
                            == dates["d_date_sk"])
                 .groupBy("d_year").agg(F.sum("ss_ext_sales_price"))),
        "range_sort": main.repartition(4).orderBy("k", F.desc("v")),
        "topk": main.orderBy(F.desc("v"), "k").limit(100),
        "q78": (ss.repartition(4).join(sr, cond, "left_outer")
                .filter(F.col("sr_ticket_number").isNull())
                .groupBy("ss_store_sk")
                .agg(F.count("*"), F.sum("ss_net_paid"))),
        "window": (main.repartition(4)
                   .select("k", "v", F.row_number().over(w).alias("rn"),
                           F.sum("v").over(w).alias("run_sum"))
                   .filter(F.col("rn") <= 3)),
    }


def test_leg_plans_match_reference_at_stage(sessions):
    """The chip_smoke legs' plans at the default tier, `auto`, with the
    volume floor at 0 (the card's tables are far past it): each plan's
    operator sequence, through a whole program into its inner plan, and
    its tier and reason equal the reference's."""
    from spark_tpu.api.window import Window as JW
    from spark_tpu_torch.api.window import Window as TW
    from tests.test_torch_tpcds_slice import _tier

    j, t = sessions
    conf = {"spark.sql.autoBroadcastJoinThreshold": 1 << 20,
            "spark.tpu.compile.tier": "auto",
            "spark.tpu.compile.whole.minRows": 0}
    for s in (j, t):
        for k, v in conf.items():
            s.conf.set(k, v)
    try:
        want = {n: (_reference_ops(df), _tier(df))
                for n, df in _leg_queries(j, JF, JW).items()}
        got = {n: (_ops(df), _tier(df))
               for n, df in _leg_queries(t, TF, TW).items()}
    finally:
        for k in conf:
            t.conf.unset(k)
        j.conf.unset("spark.sql.autoBroadcastJoinThreshold")
        j.conf.unset("spark.tpu.compile.whole.minRows")
        j.conf.set("spark.tpu.compile.tier", "stage")
    assert got == want
    assert {n: tier for n, ((_, (tier, _))) in got.items()} == {
        "main": "whole", "join": "whole", "range_sort": "whole",
        "topk": "whole", "q78": "whole", "window": "stage"}
    assert any("Fused" in op for ops, _ in got.values() for op in ops)


TPCDS_FILES = tuple(sorted(
    (f[:-4] for f in os.listdir(os.path.join(ROOT, "tests", "tpcds",
                                             "queries"))
     if f.endswith(".sql")),
    key=lambda q: (int("".join(c for c in q[1:] if c.isdigit())), q)))


@pytest.fixture(scope="module")
def tpcds_planners():
    """Both engines over the scale-0.01 tables at the stage tier with
    minRows 0 (the gate's tier on the card). A query's CTEs and scalar
    subqueries run at the operator tier (they are executed while a query
    is planned); the main query is then planned at the stage tier."""
    from tests.tpcds.datagen import gen_tpcds_full

    tables = gen_tpcds_full(scale=0.01)
    conf = dict(CONF, **{"spark.sql.shuffle.partitions": 4})
    j = TpuSession("tpcds-stage-plans", dict(
        conf, **{"spark.tpu.fusion.enabled": "true",
                 "spark.tpu.compile.tier": "operator"}))
    t = TorchSession("tpcds-stage-plans", dict(conf, **OPERATOR),
                     device="cpu")
    for name, tb in tables.items():
        j.createDataFrame(tb).createOrReplaceTempView(name)
        t.createDataFrame(tb).createOrReplaceTempView(name)
    yield j, t
    j.stop()
    t.stop()


def _stage_plan(session, text, ops):
    session.conf.set("spark.tpu.compile.tier", "operator")
    df = session.sql(text)
    df.query_execution.optimized  # noqa: B018 (runs scalar subqueries)
    session.conf.set("spark.tpu.compile.tier", "stage")
    try:
        return ops(df)
    finally:
        session.conf.set("spark.tpu.compile.tier", "operator")


@pytest.mark.parametrize("name", TPCDS_FILES)
def test_tpcds_stage_plans_match_reference(tpcds_planners, name):
    j, t = tpcds_planners
    text = tpcds_query(name)
    want = _stage_plan(j, text, _reference_ops)
    got = _stage_plan(t, text, _ops)
    assert got == want


def test_tpcds_files_are_all_planned():
    assert len(TPCDS_FILES) == 103


# --- every TPC-DS file at the stage tier on the CPU ---------------------------

class _SyncDetector:
    """A torch dispatch mode that records the ops a fused body must not
    run because on the card they read a device value on the host (which
    a CUDA graph capture forbids): `.item()` and the scalar reads of
    `int()`/`bool()`, `nonzero`, boolean-mask indexing, `masked_select`,
    `unique`, `bincount`."""

    SYNCS = ("_local_scalar_dense", "nonzero", "masked_select", "unique",
             "_unique", "_unique2", "unique_dim", "unique_consecutive",
             "isin", "bincount", "repeat_interleave")

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        found = self.found = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.__name__.split(".")[0]
                bool_index = name in ("index", "index_put", "index_put_") \
                    and any(isinstance(i, torch.Tensor)
                            and i.dtype == torch.bool
                            for i in (args[1] if len(args) > 1 else ())
                            if i is not None)
                if name in _SyncDetector.SYNCS or bool_index:
                    found.append(str(func))
                return func(*args, **(kwargs or {}))

        self.mode = Mode


def watch_syncs(monkeypatch) -> list:
    """STAGE_CACHE.run with every fused body (eager on the CPU) watched by
    _SyncDetector; returns the list of (stage, op) found."""
    from spark_tpu_torch.physical.compile import StageCache

    found = []
    orig = StageCache.run

    def run(self, name, key, fn, inputs, device):
        def watched(ins):
            det = _SyncDetector()
            with det.mode():
                out = fn(ins)
            found.extend((name, op) for op in det.found)
            return out

        return orig(self, name, key, watched, inputs, device)

    monkeypatch.setattr(StageCache, "run", run)
    return found


def replay_first(monkeypatch) -> dict:
    """STAGE_CACHE.run as the card runs it: the body built for a key's
    first batch runs every later batch of that key, as a captured graph
    replays what its capture traced with only the inputs new. A key that
    misses a branch some batch's host pass took then gives a wrong result
    on the CPU too. Returns the first bodies, by program key."""
    from spark_tpu_torch.physical.compile import StageCache, program_key
    from spark_tpu_torch.utils.cuda_graph import as_tensors

    first = {}
    orig = StageCache.run

    def run(self, name, key, fn, inputs, device):
        body = first.setdefault(
            program_key(key, as_tensors(inputs), device), fn)
        return orig(self, name, key, body, inputs, device)

    monkeypatch.setattr(StageCache, "run", run)
    return first


@pytest.fixture()
def sync_checked(monkeypatch):
    """`watch_syncs` for one test."""
    yield watch_syncs(monkeypatch)


@pytest.fixture()
def replayed(monkeypatch):
    """`replay_first` for one test."""
    yield replay_first(monkeypatch)


def test_dict_transforms_merging_per_tile_replay_right(sessions, replayed):
    """Two dictionary transforms over two tiles whose dictionaries merge at
    opposite transforms (tile 1: substr(a) maps two values to one; tile 2:
    substr(b) does): each tile's fused program asks for the same luts, so
    the program built for tile 1 computes tile 2 right."""
    t = sessions[1]
    half = 1 << 11
    tb = pa.table({"a": ["ab", "ac"] * half + ["p", "q"] * half,
                   "b": ["x", "y"] * half + ["xa", "xb"] * half,
                   "v": np.arange(4 * half, dtype=np.int64)})
    t.createDataFrame(tb).createOrReplaceTempView("fu_tiles")
    q = ("SELECT substr(a, 1, 1) sa, substr(b, 1, 1) sb, count(*) c, "
         "sum(v) s FROM fu_tiles GROUP BY substr(a, 1, 1), substr(b, 1, 1)")
    before = len(replayed)
    got = t.sql(q).toArrow()
    assert len(replayed) > before  # the fused bodies went through it
    _same(got, _operator(t, lambda s: s.sql(q)))
    lo, hi = np.arange(2 * half), np.arange(2 * half, 4 * half)
    want = {("a", "x"): lo[0::2], ("a", "y"): lo[1::2],
            ("p", "x"): hi[0::2], ("q", "x"): hi[1::2]}
    assert sorted(_rows(got)) == sorted(
        (a, b, len(v), int(v.sum())) for (a, b), v in want.items())


def test_host_pass_asks_for_each_transforms_lut():
    """In the host pass a dictionary transform asks for its lut whether or
    not two of its values merge, so two batches whose dictionaries merge
    at different transforms sign alike and get one program."""
    from spark_tpu_torch.columnar.batch import StringDict
    from spark_tpu_torch.expr.eval import HostCtx, Val
    from spark_tpu_torch.expr.expressions import (
        AttributeReference, Substring, Literal,
    )
    from spark_tpu_torch.types import string

    a = AttributeReference("a", string)
    b = AttributeReference("b", string)
    exprs = [Substring(a, Literal(1), Literal(1)),
             Substring(b, Literal(1), Literal(1))]

    def sign(da, db):
        meta = torch.empty(8, dtype=torch.int32, device="meta")
        ctx = HostCtx({a.expr_id: Val(string, meta, None, StringDict(da)),
                       b.expr_id: Val(string, meta, None, StringDict(db))},
                      8)
        for e in exprs:
            ctx.eval(e)
        return ctx.signature()

    one = sign(["ab", "ac"], ["x", "y"])
    two = sign(["p", "q"], ["xa", "xb"])
    assert len(one) == len(two) == 2
    assert one == two


@pytest.fixture(scope="module")
def tpcds_cpu_tiers():
    """The port on the CPU over the scale-0.01 tables at the stage tier
    with minRows 0 (every tile fused, as the card's gate runs) and at the
    operator tier."""
    from tests.tpcds.datagen import gen_tpcds_full

    tables = gen_tpcds_full(scale=0.01)
    conf = dict(CONF, **{"spark.tpu.batch.capacity": 1 << 10})
    # pinned: at `auto` the inventory queries (1.3M rows here) run whole
    stage = TorchSession("tpcds-stage", dict(conf, **{
        "spark.tpu.compile.tier": "stage"}), device="cpu")
    oper = TorchSession("tpcds-operator", dict(conf, **OPERATOR),
                        device="cpu")
    for name, tb in tables.items():
        stage.createDataFrame(tb).createOrReplaceTempView(name)
        oper.createDataFrame(tb).createOrReplaceTempView(name)
    yield stage, oper
    stage.stop()
    oper.stop()


def test_sync_detector_sees_host_reads(sync_checked):
    det = _SyncDetector()
    x = torch.arange(10)
    with det.mode():
        x[x > 3]
        int(x.sum())
    assert any("index" in op for op in det.found), det.found
    assert any("_local_scalar_dense" in op for op in det.found), det.found


@pytest.mark.parametrize("name", TPCDS_FILES)
def test_tpcds_stage_equals_operator_without_host_reads(
        tpcds_cpu_tiers, sync_checked, replayed, name):
    """Each query file at the stage tier equals the operator tier on the
    CPU (floats to relative 1e-12), with each key's first body run for
    all its batches as a graph replays (`replayed`), and no fused body
    reads a device value on the host (the card's capture would fail
    there)."""
    stage, oper = tpcds_cpu_tiers
    text = tpcds_query(name)
    got = stage.sql(text).toArrow()
    assert not sync_checked, sync_checked[:5]
    ordered = "order by" in text.lower()
    _same(got, oper.sql(text).toArrow(), ordered=False)
    if ordered:
        assert got.num_rows == oper.sql(text).toArrow().num_rows
