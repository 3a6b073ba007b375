"""Window functions of the port's fourth SQL slice against the JAX
reference, in SQL and through the DataFrame API (`Window`, `Column.over`):
every function kind WindowExec plans (row_number, rank, dense_rank,
percent_rank, cume_dist, ntile, lag/lead over integers, strings, decimals
and dates, first/last/nth_value, and sum, count, min, max and avg), over
the whole partition, the running frame with peers, ROWS frames with both
offsets and one side unbounded, and a value RANGE frame on an integral
key; null partition and order keys with NULLS FIRST/LAST, string partition
keys across a UNION, a string CASE as the partition key, decimal averages,
a window over an aggregate, two specs in one SELECT, a named WINDOW, and
no partition keys (one partition, AllTuples). Each statement runs over
`tests/test_torch_cuda.py`'s t3 through TpuSession (operator tier, fusion
off) and TorchSession(device="cpu"): the analysed and optimised plans
print the same trees (ids renumbered), the physical plans hold the same
operator sequence, and the Arrow results are equal exactly (the doubles
are eighths: every sum is exact). What the slice does not port raises
NotPortedError naming it."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu_torch.api.functions as F  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from spark_tpu_torch.api.window import Window  # noqa: E402
from spark_tpu_torch.errors import NotPortedError  # noqa: E402
from tests.test_torch_cuda import WINDOW_CONSTRUCTS  # noqa: E402
from tests.test_torch_cuda import construct_rows as _rows  # noqa: E402
from tests.test_torch_cuda import construct_tables  # noqa: E402
from tests.test_torch_tpcds_slice import _ops  # noqa: E402
from tests.test_torch_tpcds_store import renumber  # noqa: E402

# the port side pinned to the operator tier, as the reference side is:
# these tests hold operator-at-a-time execution (tests/test_torch_fusion.py
# holds the stage tier)
CONF = {"spark.sql.shuffle.partitions": 4,
        "spark.tpu.batch.capacity": 1 << 10,
        "spark.sql.autoBroadcastJoinThreshold": 1024,
        "spark.tpu.compile.tier": "operator"}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator"})
CASES = [n for n in WINDOW_CONSTRUCTS if n.startswith("window")]


@pytest.fixture(scope="module")
def sessions():
    j = TpuSession("windows-reference", dict(JAX_CONF))
    t = TorchSession("windows", dict(CONF), device="cpu")
    for name, tb in construct_tables().items():
        j.createDataFrame(tb).createOrReplaceTempView(name)
        t.createDataFrame(tb).createOrReplaceTempView(name)
    yield j, t
    j.stop()
    t.stop()


def check_pair(jd, td, ordered: bool) -> None:
    for phase in ("analyzed", "optimized"):
        want = getattr(jd.query_execution, phase).tree_string()
        got = getattr(td.query_execution, phase).tree_string()
        assert renumber(got) == renumber(want), phase
    assert _ops(td) == _ops(jd)
    want, got = jd.toArrow(), td.toArrow()
    assert got.schema == want.schema
    assert _rows(got, ordered) == _rows(want, ordered)


@pytest.mark.parametrize("name", CASES)
def test_window_matches_reference(sessions, name):
    j, t = sessions
    text, ordered = WINDOW_CONSTRUCTS[name]
    check_pair(j.sql(text), t.sql(text), ordered)


def test_window_plans_one_node_per_spec(sessions):
    _, t = sessions
    df = t.sql(WINDOW_CONSTRUCTS["window_rows"][0])
    assert _ops(df).count("WindowExec") == 1  # five frames, one spec
    df = t.sql(WINDOW_CONSTRUCTS["window_ranks"][0])
    assert _ops(df).count("WindowExec") == 2
    # no partition keys over a child of several partitions (the union's
    # branches): AllTuples, through the single-partition exchange
    df = t.sql("SELECT c2, rank() OVER (ORDER BY i) r FROM (SELECT c AS c2, "
               "i FROM t3 UNION ALL SELECT c, i FROM t3) u")
    plan = df.query_execution.physical.tree_string()
    assert "Exchange[SinglePartition(1)]" in plan
    assert plan.index("Window[rank]") < plan.index("SinglePartition")


def _dataframe(session, api):
    F_, W_ = api
    df = session.table_t3()
    w = W_.partitionBy("g").orderBy(F_.desc("o"), "k")
    return df.select(
        "k", "g", F_.row_number().over(w).alias("rn"),
        F_.rank().over(w).alias("r"), F_.dense_rank().over(w).alias("dr"),
        F_.percent_rank().over(w).alias("pr"),
        F_.cume_dist().over(w).alias("cd"), F_.ntile(4).over(w).alias("nt"),
        F_.lag("c").over(w).alias("lc"), F_.lead("x", 2).over(w).alias("lx"),
        F_.sum("x").over(w).alias("rs"),
        F_.avg("f").over(W_.partitionBy("g")).alias("af"),
        F_.max("i").over(w.rowsBetween(-2, 0)).alias("mx"),
        F_.min("i").over(w.rowsBetween(Window.unboundedPreceding,
                                       Window.currentRow)).alias("mn"),
        F_.count("*").over(W_.partitionBy("c").orderBy("m")
                           .rangeBetween(-3, 3)).alias("nr"),
        F_.sum("i").over(W_.orderBy("k")).alias("all_rs"))


def test_dataframe_windows_match_reference(sessions):
    """The same windows through both engines' DataFrame APIs."""
    import spark_tpu.api.functions as JF
    from spark_tpu.api.window import Window as JWindow

    j, t = sessions
    for s in (j, t):
        s.table_t3 = lambda s=s: s.createDataFrame(construct_tables()["t3"])
    jd = _dataframe(j, (JF, JWindow))
    td = _dataframe(t, (F, Window))
    check_pair(jd, td, False)


def test_dataframe_top_n_equals_sql(sessions):
    _, t = sessions
    w = Window.partitionBy("g").orderBy(F.desc("o"), "k")
    df = (t.sql("SELECT * FROM t3").select(
        "k", "g", "o", F.row_number().over(w).alias("rn"))
        .filter(F.col("rn") <= 2))
    want = t.sql(WINDOW_CONSTRUCTS["window_top_n"][0]).toArrow()
    assert _rows(df.toArrow(), False) == _rows(want, False)


UNPORTED = {
    "lag_default": ("SELECT lag(o, 1, 0) OVER (PARTITION BY g ORDER BY k) "
                    "FROM t3", "lag with a default value"),
    "string_max": ("SELECT max(c) OVER (PARTITION BY g) FROM t3",
                   "max of a string over a window"),
    "range_two_keys": ("SELECT sum(i) OVER (PARTITION BY g ORDER BY m, k "
                       "RANGE BETWEEN 1 PRECEDING AND CURRENT ROW) FROM t3",
                       "RANGE value frames"),
    "range_nullable": ("SELECT sum(i) OVER (ORDER BY o RANGE BETWEEN 1 "
                       "PRECEDING AND 1 FOLLOWING) FROM t3",
                       "RANGE value frames"),
    "first_value_bounded": ("SELECT first_value(o) OVER (ORDER BY k ROWS "
                            "BETWEEN 1 PRECEDING AND CURRENT ROW) FROM t3",
                            "bounded frame"),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_windows_raise(sessions, name):
    _, t = sessions
    text, what = UNPORTED[name]
    with pytest.raises(NotPortedError) as err:
        t.sql(text).toArrow()
    assert what.lower() in err.value.what.lower()
