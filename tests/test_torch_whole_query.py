"""The whole-query tier of the port (physical/whole_query.py) against the
JAX package's whole tier on the CPU, on the same numpy-seeded tables:
every case of tests/test_whole_query.py that applies (the launch-model
predictions and the obs layer are not ported). Each differential holds the
port at one tier to the reference at the same tier and to the port's
operator tier; integers and strings compare exactly, float sums to relative
1e-12. The tier chooser's decision and reason equal the reference's; a
program that runs out of card memory degrades to the stage tier, and a
failed capture for any other cause raises."""

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as TF  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import NotPortedError, TorchSession  # noqa: E402
from spark_tpu_torch.physical.compile import STAGE_CACHE, StageCache  # noqa: E402,E501
from spark_tpu_torch.utils.cuda_graph import CaptureError  # noqa: E402
from tests.test_torch_fusion import _same  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401
from tests.test_torch_tpcds_slice import _tier as _decision  # noqa: E402

CONF = {"spark.sql.shuffle.partitions": 4,
        "spark.tpu.batch.capacity": 1 << 12,
        "spark.tpu.fusion.minRows": 0}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "true"})
TIER = "spark.tpu.compile.tier"
MIN_ROWS = "spark.tpu.compile.whole.minRows"

Q_AGG = ("select k, sum(v * 2) sv, count(*) c, min(v) mn, max(v+1) mx, "
         "avg(f) af from wq_t where v > 0 group by k")
Q_JOIN_AGG = ("select label, sum(v) sv, count(*) c from wq_t "
              "join wq_dim on k = dk where v > 10 group by label")
Q_STRINGS = ("select s, label, count(*) c, sum(f) sf from wq_t "
             "join wq_dim on k = dk where v < 80 group by s, label")
Q_SEMI = ("select k, s, v from wq_t where k in (select dk from wq_dim "
          "where label = 'lab1') and v > 90")
Q_ANTI = ("select k, count(*) c from wq_t where not exists (select 1 from "
          "wq_dim where dk = k and label <> 'lab2') group by k")
Q_UNION = ("select k, sum(v) s from (select k, v from wq_t where v > 50 "
           "union all select dk k, dk * 10 v from wq_dim) u group by k")
Q3 = """
    SELECT dt.d_year, item.i_brand_id AS brand_id,
           SUM(ss_ext_sales_price) AS sum_agg
    FROM date_dim dt, store_sales, item
    WHERE dt.d_date_sk = store_sales.ss_sold_date_sk
      AND store_sales.ss_item_sk = item.i_item_sk
      AND item.i_manufact_id = 28 AND dt.d_moy = 11
    GROUP BY dt.d_year, item.i_brand_id"""
Q3_SORTED = Q3 + "\n    ORDER BY d_year, brand_id"
# a many-to-many self join: ~1,300 rows a side over 13 keys give ~130,000
# output rows, past the probe flow's 8,192-slot bucket
Q_EXPAND = ("select a.k, count(*) c, sum(b.v) sv from wq_t a join wq_t b "
            "on a.k = b.k where a.v > 60 and b.v > 60 group by a.k")
DIFFERENTIAL = {"agg": Q_AGG, "join_agg": Q_JOIN_AGG, "strings": Q_STRINGS,
                "semi": Q_SEMI, "anti": Q_ANTI, "union": Q_UNION,
                "expand": Q_EXPAND}


@pytest.fixture(scope="module")
def sessions():
    from tests.tpcds.datagen import gen_tpcds_full

    j = TpuSession("whole-reference", dict(JAX_CONF))
    t = TorchSession("whole", dict(CONF), device="cpu")
    rng = np.random.default_rng(11)
    n = 5000
    wq = pa.table({"k": rng.integers(0, 13, n),
                   "v": rng.integers(-50, 100, n),
                   "f": rng.random(n),
                   "s": [f"cat{i % 5}" for i in range(n)]})
    dim = pa.table({"dk": np.arange(13, dtype=np.int64),
                    "label": [f"lab{i % 3}" for i in range(13)]})
    tables = gen_tpcds_full(scale=0.01)
    for s in (j, t):
        s.createDataFrame(wq).createOrReplaceTempView("wq_t")
        s.createDataFrame(dim).createOrReplaceTempView("wq_dim")
        for name in ("store_sales", "date_dim", "item"):
            s.createDataFrame(tables[name]).createOrReplaceTempView(name)
    yield j, t
    j.stop()
    t.stop()


@pytest.fixture()
def tiers(sessions):
    yield sessions
    for s in sessions:
        for k in (TIER, MIN_ROWS, "spark.tpu.fusion.enabled"):
            s.conf.unset(k)


def _set(sessions, key, value):
    for s in sessions:
        s.conf.set(key, value)


def _is_whole(df) -> bool:
    return type(df.query_execution.physical).__name__ == "WholeQueryExec"


def _port_operator(t, text):
    t.conf.set(TIER, "operator")
    try:
        return t.sql(text).toArrow()
    finally:
        t.conf.unset(TIER)


# --- differentials: each tier against the reference at the same tier -------

@pytest.mark.parametrize("tier", ["whole", "stage"])
@pytest.mark.parametrize("name", list(DIFFERENTIAL))
def test_tier_differential(tiers, name, tier):
    j, t = tiers
    text = DIFFERENTIAL[name]
    _set(tiers, TIER, tier)
    df = t.sql(text)
    assert _is_whole(df) == (tier == "whole")
    jd = j.sql(text)
    assert _is_whole(jd) == (tier == "whole")
    got = df.toArrow()
    _same(got, jd.toArrow())
    _same(got, _port_operator(t, text))


def test_tier_differential_repartition_agg(tiers):
    j, t = tiers

    def q(s):
        F = JF if isinstance(s, TpuSession) else TF
        return (s.table("wq_t").repartition(5, "k").groupBy("k")
                .agg(F.count("*").alias("c"), F.sum("v").alias("sv")))

    for tier in ("whole", "stage"):
        _set(tiers, TIER, tier)
        df = q(t)
        assert _is_whole(df) == (tier == "whole")
        got = df.toArrow()
        _same(got, q(j).toArrow())
        t.conf.set(TIER, "operator")
        _same(got, q(t).toArrow())


def test_tier_differential_sorted_q3(tiers):
    """Sorted q3: the broadcast-join spine, the grouped aggregate and the
    range-exchange sort all in one program; the total order holds."""
    j, t = tiers
    for tier in ("whole", "stage"):
        _set(tiers, TIER, tier)
        df = t.sql(Q3_SORTED)
        assert _is_whole(df) == (tier == "whole")
        got = df.toArrow()
        _same(got, j.sql(Q3_SORTED).toArrow(), ordered=True)
        _same(got, _port_operator(t, Q3_SORTED), ordered=True)


# --- one dispatch per step, the capacity retry --------------------------------

def _delta(t, run) -> tuple[dict, dict]:
    m0, l0 = t.metrics, t.launches.snapshot()
    run()
    m1, l1 = t.metrics, t.launches.snapshot()
    return ({k: v - m0.get(k, 0) for k, v in m1.items()
             if v != m0.get(k, 0)},
            {k: v - l0.get(k, 0) for k, v in l1.items()
             if v != l0.get(k, 0)})


def test_whole_tier_single_dispatch_per_step(tiers):
    """q3 at the whole tier is ONE program per step: a warm run makes one
    dispatch, one cache hit and no per-stage dispatch of any kind."""
    t = tiers[1]
    t.conf.set(TIER, "whole")
    t.sql(Q3).toArrow()  # warm
    c0 = STAGE_CACHE.counters()
    metrics, launches = _delta(t, lambda: t.sql(Q3).toArrow())
    c1 = STAGE_CACHE.counters()
    assert launches == {"whole_query": 1}, launches
    assert metrics.get("whole_query.dispatches") == 1, metrics
    assert "whole_query.capacity_retries" not in metrics
    assert c1["stage_cache.hits"] - c0["stage_cache.hits"] == 1
    assert c1["stage_cache.captures"] == c0["stage_cache.captures"]


def test_whole_tier_join_capacity_retry(tiers):
    """A join whose output outgrows its bucket re-runs the program at the
    bumped bucket: a new key (a new program), one dispatch and one cached
    program run per attempt, the retries counted; the result equals the
    reference's."""
    from spark_tpu_torch.physical.whole_query import SETTLED

    j, t = tiers
    _set(tiers, TIER, "whole")
    SETTLED.clear()
    c0 = STAGE_CACHE.counters()
    metrics, launches = _delta(t, lambda: _same(
        t.sql(Q_EXPAND).toArrow(), j.sql(Q_EXPAND).toArrow()))
    retries = metrics.get("whole_query.capacity_retries", 0)
    assert retries >= 1, metrics
    assert metrics["whole_query.dispatches"] == retries + 1
    assert launches == {"whole_query": retries + 1}, launches
    c1 = STAGE_CACHE.counters()
    runs = [c1[k] - c0[k] for k in ("stage_cache.captures",
                                    "stage_cache.hits")]
    assert sum(runs) == retries + 1, runs


def test_next_run_starts_from_the_settled_capacity(tiers):
    """A second run of the same query starts from the capacities the first
    settled on: one dispatch, no retry, the program the first run's last
    attempt ran (a cache hit), the same result."""
    from spark_tpu_torch.physical.whole_query import SETTLED

    t = tiers[1]
    t.conf.set(TIER, "whole")
    SETTLED.clear()
    first = t.sql(Q_EXPAND).toArrow()
    c0 = STAGE_CACHE.counters()
    metrics, launches = _delta(t, lambda: _same(t.sql(Q_EXPAND).toArrow(),
                                                first))
    c1 = STAGE_CACHE.counters()
    assert launches == {"whole_query": 1}, launches
    assert metrics.get("whole_query.dispatches") == 1, metrics
    assert "whole_query.capacity_retries" not in metrics
    assert c1["stage_cache.hits"] - c0["stage_cache.hits"] == 1
    assert c1["stage_cache.captures"] == c0["stage_cache.captures"]


# --- the chooser ----------------------------------------------------------------

def test_tier_fallback_unsupported_operator(tiers):
    """A plan with an operator outside the lowering set (a window, a
    nested-loop join) stays staged at forced whole, with the reason the
    reference gives, and runs there."""
    j, t = tiers
    _set(tiers, TIER, "whole")
    for text in ("select k, v, row_number() over (partition by k order by "
                 "v) rn from wq_t where v > 90",
                 "select count(*) c from wq_t a join wq_dim b "
                 "on a.k < b.dk where a.v > 95"):
        df, jd = t.sql(text), j.sql(text)
        assert not _is_whole(df)
        assert _decision(df)[0] == "stage"
        assert "whole-query fallback: operator" in _decision(df)[1]
        assert _decision(df) == _decision(jd)
        _same(df.toArrow(), jd.toArrow())


@pytest.mark.parametrize("tier", ["auto", "whole"])
def test_fusion_off_never_whole(tiers, tier):
    """spark.tpu.fusion.enabled=false is the operator-at-a-time oracle:
    never a whole program, even forced (the port says `operator` where the
    reference says `stage`; both run operator at a time)."""
    j, t = tiers
    _set(tiers, "spark.tpu.fusion.enabled", "false")
    _set(tiers, TIER, tier)
    _set(tiers, MIN_ROWS, "0")
    df = t.table("wq_t").repartition(5, "k").groupBy("k").agg(
        TF.count("*"))
    assert not _is_whole(df)
    got, want = _decision(df), _decision(j.table("wq_t").repartition(5, "k")
                                         .groupBy("k").agg(JF.count("*")))
    assert got[0] == "operator" and want[0] == "stage"
    assert got[1] == want[1] and "fusion.enabled" in got[1]


def test_auto_tier_volume_floor(tiers):
    """auto keeps small plans on the stage tier (the volume floor) and
    takes whole once the floor admits a plan with exchanges to remove;
    an exchange-free plan always stays staged. Each decision and reason
    equals the reference's."""
    j, t = tiers
    _set(tiers, TIER, "auto")

    def q(s):
        F = JF if isinstance(s, TpuSession) else TF
        return s.table("wq_t").repartition(5, "k").groupBy("k").agg(
            F.count("*"))

    df = q(t)
    assert not _is_whole(df)
    assert "floor" in _decision(df)[1]
    assert _decision(df) == _decision(q(j))
    _set(tiers, MIN_ROWS, "0")
    df = q(t)
    assert _is_whole(df)
    assert _decision(df) == _decision(q(j)) == (
        "whole", "cost model (spark.tpu.compile.tier=auto)")
    df = t.sql(Q_AGG)
    assert not _is_whole(df)
    assert "no exchange round-trips" in _decision(df)[1]
    assert _decision(df) == _decision(j.sql(Q_AGG))


@pytest.mark.parametrize("min_rows", ["0", "131072"])
@pytest.mark.parametrize("name", list(DIFFERENTIAL) + ["q3_sorted"])
def test_auto_decision_matches_reference(tiers, name, min_rows):
    j, t = tiers
    _set(tiers, MIN_ROWS, min_rows)
    text = Q3_SORTED if name == "q3_sorted" else DIFFERENTIAL[name]
    assert _decision(t.sql(text)) == _decision(j.sql(text))


def test_tier_chooser_launches_nothing(tiers):
    """The cost model is host arithmetic over plan metadata: planning at
    any tier runs no torch op and captures nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    t = tiers[1]
    ops = []

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    for tier in ("auto", "whole", "stage", "operator"):
        t.conf.set(TIER, tier)
        t.conf.set(MIN_ROWS, "0")
        df = t.sql(Q_JOIN_AGG)
        c0, l0 = STAGE_CACHE.counters(), t.launches.snapshot()
        with Mode():
            df.query_execution.physical  # noqa: B018 (plans, decides)
        assert not ops, (tier, ops[:5])
        assert STAGE_CACHE.counters() == c0
        assert t.launches.snapshot() == l0


def test_whole_tier_explain_surfaces_decision(tiers, capsys):
    t = tiers[1]
    t.conf.set(TIER, "whole")
    t.sql(Q_AGG).explain()
    out = capsys.readouterr().out
    assert "WholeQuery[ops=3, tier=whole]" in out
    assert "== Compile Tier ==\nwhole (forced by spark.tpu.compile.tier)" \
        in out
    assert "'volume_rows': 5000" in out
    t.conf.set(TIER, "auto")
    t.sql(Q_AGG).explain()
    assert "stage (whole-query fallback: no exchange round-trips" \
        in capsys.readouterr().out


def test_mesh_whole_and_memory_budget_raise():
    t = TorchSession("mesh", dict(CONF, **{TIER: "mesh-whole"}),
                     device="cpu")
    with pytest.raises(NotPortedError, match="physical/mesh_whole.py"):
        t.range(0, 10).toArrow()
    with pytest.raises(NotPortedError, match="spark.tpu.memory.budget"):
        TorchSession("budget", {"spark.tpu.memory.budget": "1024"},
                     device="cpu")


# --- the runtime degrade ----------------------------------------------------------

@pytest.fixture()
def memo_cleared():
    """The settled-capacity memo emptied before and after."""
    from spark_tpu_torch.physical.whole_query import SETTLED

    SETTLED.clear()
    yield SETTLED
    SETTLED.clear()


def _failing_program(monkeypatch, make_error):
    """STAGE_CACHE.run with every whole program raising `make_error()`
    when it runs (inside its capture, on the card)."""
    orig = StageCache.run

    def run(self, name, key, fn, inputs, device):
        if name == "WholeQuery":
            def fn(ins):  # noqa: F811
                raise make_error()
        return orig(self, name, key, fn, inputs, device)

    monkeypatch.setattr(StageCache, "run", run)


def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                       "allocate 2.00 GiB")


def _capture_oom():
    try:
        raise _oom()
    except torch.cuda.OutOfMemoryError as e:
        err = CaptureError("capturing fused stage WholeQuery failed: "
                           "OutOfMemoryError")
        err.__cause__ = e
        return err


@pytest.mark.parametrize("fault", [_oom, _capture_oom])
def test_out_of_memory_degrades_to_stage(tiers, monkeypatch, memo_cleared,
                                         fault):
    """A program that runs out of card memory (inside its capture or
    not) re-executes the plan at the stage tier: the result equals the
    reference's, the counter and the decision's cause are set, and the
    program cache ran the failed program and the fused stages. The next run of the same
    query tries the whole tier again, as the reference's does: it degrades
    again while the fault lasts, and runs as one program once it is gone."""
    j, t = tiers
    _set(tiers, TIER, "whole")
    _failing_program(monkeypatch, fault)
    want = j.sql(Q_JOIN_AGG).toArrow()
    for attempt in range(2):
        df = t.sql(Q_JOIN_AGG)
        c0 = STAGE_CACHE.counters()
        metrics, launches = _delta(t, lambda: _same(df.toArrow(), want))
        assert metrics.get("whole_query.runtime_degraded") == 1, metrics
        assert "whole_query.dispatches" not in metrics
        assert launches.get("whole_query") is None
        cause = df.query_execution.physical.decision.details[
            "runtime_degraded"]
        assert cause.startswith(fault().__class__.__name__)
        runs = [STAGE_CACHE.counters()[k] - c0[k]
                for k in ("stage_cache.captures", "stage_cache.hits")]
        assert sum(runs) == 1 + sum(n for k, n in launches.items()
                                    if k.startswith("fused_")), attempt
    monkeypatch.undo()
    metrics, launches = _delta(t, lambda: _same(
        t.sql(Q_JOIN_AGG).toArrow(), want))
    assert "whole_query.runtime_degraded" not in metrics
    assert launches == {"whole_query": metrics["whole_query.dispatches"]}


def test_capture_error_from_a_host_read_raises(tiers, monkeypatch,
                                               memo_cleared):
    """Only running out of memory degrades: a capture that failed on a
    host read inside the body raises, and nothing runs in its place."""
    t = tiers[1]
    t.conf.set(TIER, "whole")

    def host_read():
        try:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        except RuntimeError as e:
            err = CaptureError("capturing fused stage WholeQuery failed")
            err.__cause__ = e
            return err

    _failing_program(monkeypatch, host_read)
    before = t.metrics.get("whole_query.runtime_degraded", 0)
    with pytest.raises(CaptureError):
        t.sql(Q_JOIN_AGG).toArrow()
    assert t.metrics.get("whole_query.runtime_degraded", 0) == before


def test_is_runtime_fault_classifies():
    from spark_tpu_torch.utils.faults import is_runtime_fault

    assert is_runtime_fault(_oom())
    assert is_runtime_fault(_capture_oom())
    assert not is_runtime_fault(CaptureError("host read"))
    assert not is_runtime_fault(NotPortedError("x"))
    assert not is_runtime_fault(RuntimeError("shape mismatch"))
