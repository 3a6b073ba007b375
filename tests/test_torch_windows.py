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
from tests.test_torch_cuda import LEADS, RANKED, WINDOW_CONSTRUCTS  # noqa: E402,E501
from tests.test_torch_cuda import construct_rows as _rows  # noqa: E402
from tests.test_torch_cuda import construct_tables  # noqa: E402
from tests.test_torch_cuda import minmax_oracle, shift_oracle  # noqa: E402
from tests.test_torch_fusion import replayed  # noqa: E402,F401
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


def check_pair(jd, td, ordered: bool, apart=()) -> None:
    """The two engines' plans and results agree; the columns named in
    `apart` are left out of the result comparison (their caller holds
    them to a plain oracle)."""
    for phase in ("analyzed", "optimized"):
        want = getattr(jd.query_execution, phase).tree_string()
        got = getattr(td.query_execution, phase).tree_string()
        assert renumber(got) == renumber(want), phase
    assert _ops(td) == _ops(jd)
    want, got = jd.toArrow(), td.toArrow()
    assert got.schema == want.schema
    keep = [c for c in want.column_names if c not in apart]
    assert _rows(got.select(keep), ordered) == \
        _rows(want.select(keep), ordered)


@pytest.mark.parametrize("name", CASES)
def test_window_matches_reference(sessions, name):
    """Each case in both engines; its lead columns are held to Spark's
    semantics (`shift_oracle`), and the reference's to lag's; its string
    min/max columns to `minmax_oracle` (the reference's reduce codes,
    C19, pinned below)."""
    j, t = sessions
    text, ordered = WINDOW_CONSTRUCTS[name]
    leads = LEADS.get(name, {})
    ranked = RANKED.get(name, {})
    jd, td = j.sql(text), t.sql(text)
    check_pair(jd, td, ordered, apart=tuple(leads) + tuple(ranked))
    rows = construct_tables()["t3"].to_pylist()
    for col, (arg, off) in leads.items():
        order = [("k", False)]
        assert _by_k(td.toArrow(), col) == \
            shift_oracle(rows, "g", order, arg, off)
        assert _by_k(jd.toArrow(), col) == \
            shift_oracle(rows, "g", order, arg, -off)
    for col, (fn, frame) in ranked.items():
        assert _by_k(td.toArrow(), col) == \
            minmax_oracle(rows, "g", fn, frame), col


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
    check_pair(jd, td, False, apart=("lx",))
    # lead("x", 2): the port to Spark's semantics, the reference computes
    # lag("x", 2) (ROADMAP.md C18)
    rows = construct_tables()["t3"].to_pylist()
    order = [("o", True), ("k", False)]
    lead2 = shift_oracle(rows, "g", order, "x", -2)
    lag2 = shift_oracle(rows, "g", order, "x", 2)
    assert _by_k(td.toArrow(), "lx") == lead2
    assert _by_k(jd.toArrow(), "lx") == lag2


def test_dataframe_top_n_equals_sql(sessions):
    _, t = sessions
    w = Window.partitionBy("g").orderBy(F.desc("o"), "k")
    df = (t.sql("SELECT * FROM t3").select(
        "k", "g", "o", F.row_number().over(w).alias("rn"))
        .filter(F.col("rn") <= 2))
    want = t.sql(WINDOW_CONSTRUCTS["window_top_n"][0]).toArrow()
    assert _rows(df.toArrow(), False) == _rows(want, False)


UNPORTED = {
    # a string max over a window runs since string min/max were ported;
    # a value RANGE frame ordered by the string is still refused, as the
    # reference refuses it
    "string_max": ("SELECT max(c) OVER (PARTITION BY g ORDER BY c RANGE "
                   "BETWEEN 1 PRECEDING AND CURRENT ROW) FROM t3",
                   "RANGE value frames"),
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


# --- lag and lead held to Spark's semantics -------------------------------

def _by_k(table, col) -> dict:
    return dict(zip(table.column("k").to_pylist(),
                    table.column(col).to_pylist()))


# (output column, SQL text, shift_oracle's column, offset, default and
# default column)
SHIFTS = [
    ("a", "lead(x)", ("x", -1)),
    ("b", "lag(x, 1, 0)", ("x", 1, 0)),               # decimal, int default
    ("c", "lead(x, 1, -1)", ("x", -1, -1)),
    ("d", "lead(i, 2)", ("i", -2)),
    ("e", "lag(i, 3, -5)", ("i", 3, -5)),
    ("f", "lead(c, 1, 'none')", ("c", -1, "none")),   # string default
    ("g2", "lag(o, 500)", ("o", 500)),                # past the partition
    ("h", "lead(o, 450, 7)", ("o", -450, 7)),
    ("l", "lead(o, 1, NULL)", ("o", -1)),             # NULL: no default
    ("q", "lag(o, 1, m)", ("o", 1, None, "m")),       # the current row's m
    ("u", "lead(i, 1, o)", ("i", -1, None, "o")),     # a nullable default
    ("r", "lag(dt)", ("dt", 1)),
]


@pytest.fixture(scope="module")
def tier_sessions():
    out = {}
    for tier in ("operator", "stage", "auto"):
        t = TorchSession(f"shift-{tier}", dict(
            CONF, **{"spark.tpu.compile.tier": tier,
                     "spark.tpu.fusion.minRows": 0}), device="cpu")
        t.createDataFrame(construct_tables()["t3"]) \
            .createOrReplaceTempView("t3")
        out[tier] = t
    yield out
    for t in out.values():
        t.stop()


@pytest.mark.parametrize("tier", ["operator", "stage", "auto"])
def test_lead_lag_match_spark_sql(tier_sessions, tier):
    """lag and lead, with and without a default, through SQL over t3's
    partitions (NULL keys among them), NULL values, a decimal column
    with an integer default, a string default, a default read from the
    current row, and offsets past every partition: each column equals
    Spark's semantics (`shift_oracle`)."""
    t = tier_sessions[tier]
    cols = ", ".join(f"{text} OVER w AS {name}" for name, text, _ in SHIFTS)
    df = t.sql(f"SELECT k, {cols} FROM t3 "
               "WINDOW w AS (PARTITION BY g ORDER BY o DESC, k)")
    got = df.toArrow()
    rows = construct_tables()["t3"].to_pylist()
    order = [("o", True), ("k", False)]
    for name, _, args in SHIFTS:
        assert _by_k(got, name) == shift_oracle(rows, "g", order, *args), \
            name
    plan = df.query_execution.physical.tree_string()
    assert "lead" in plan and "lag" in plan


@pytest.mark.parametrize("tier", ["operator", "stage", "auto"])
def test_lead_lag_match_spark_dataframe(tier_sessions, tier):
    """The DataFrame forms (F.lag/F.lead with an offset and a default) over
    several partitions, equal to Spark's semantics; the three-row case of
    the issue's oracle too: lead(v) 20, 30, NULL; lead(v, 2) 30, NULL,
    NULL; lag(v, 1, -1) -1, 10, 20; lead(v, 1, -1) 20, 30, -1."""
    import pyarrow as pa

    t = tier_sessions[tier]
    w = Window.partitionBy("g").orderBy("m", "k")
    got = t.sql("SELECT * FROM t3").select(
        "k", F.lead("x").over(w).alias("a"),
        F.lag("x", 2, 0).over(w).alias("b"),
        F.lead("c", 3, "zz").over(w).alias("c2"),
        F.lag("i", 1, -1).over(w).alias("d")).toArrow()
    rows = construct_tables()["t3"].to_pylist()
    order = [("m", False), ("k", False)]
    assert _by_k(got, "a") == shift_oracle(rows, "g", order, "x", -1)
    assert _by_k(got, "b") == shift_oracle(rows, "g", order, "x", 2, 0)
    assert _by_k(got, "c2") == shift_oracle(rows, "g", order, "c", -3, "zz")
    assert _by_k(got, "d") == shift_oracle(rows, "g", order, "i", 1, -1)
    small = t.createDataFrame(pa.table({"k": [1, 2, 3], "v": [10, 20, 30]}))
    w1 = Window.orderBy("k")
    res = small.select(
        "k", F.lead("v").over(w1).alias("ld"),
        F.lead("v", 2).over(w1).alias("ld2"),
        F.lag("v", 1, -1).over(w1).alias("lg"),
        F.lead("v", 1, -1).over(w1).alias("ldd")).orderBy("k").toArrow()
    assert res.column("ld").to_pylist() == [20, 30, None]
    assert res.column("ld2").to_pylist() == [30, None, None]
    assert res.column("lg").to_pylist() == [-1, 10, 20]
    assert res.column("ldd").to_pylist() == [20, 30, -1]


def test_reference_lead_lag_faults_pinned(sessions):
    """The reference's two faults, pinned as its own: its lead computes lag
    (ROADMAP.md C18) and it drops lag/lead's default (NULL where Spark
    gives the default)."""
    j, _ = sessions
    got = j.sql("SELECT k, lead(i) OVER w AS a, lag(i, 1, -1) OVER w AS b, "
                "lead(i, 1, -1) OVER w AS c FROM t3 "
                "WINDOW w AS (PARTITION BY g ORDER BY m, k)").toArrow()
    rows = construct_tables()["t3"].to_pylist()
    order = [("m", False), ("k", False)]
    lag1 = shift_oracle(rows, "g", order, "i", 1)
    assert _by_k(got, "a") == lag1
    assert _by_k(got, "b") == lag1
    assert _by_k(got, "c") == lag1
    assert lag1 != shift_oracle(rows, "g", order, "i", -1)


# --- string min/max over a window, held to a plain oracle (C19) -----------

# (output column, SQL text, minmax_oracle's function and frame)
STRING_MINMAX = [
    ("a", "min(c) OVER (PARTITION BY g)", ("min", ("partition",))),
    ("b", "max(c) OVER (PARTITION BY g)", ("max", ("partition",))),
    ("c2", "min(c) OVER (PARTITION BY g ORDER BY o)", ("min", ("peers", "o"))),
    ("d", "max(c) OVER (PARTITION BY g ORDER BY o)", ("max", ("peers", "o"))),
    ("e", "min(c) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN 3 PRECEDING "
          "AND 1 FOLLOWING)", ("min", ("rows", "k", -3, 1))),
    ("f", "max(c) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN CURRENT ROW "
          "AND 4 FOLLOWING)", ("max", ("rows", "k", 0, 4))),
    ("h", "min(c) OVER (PARTITION BY g ORDER BY m RANGE BETWEEN 2 PRECEDING "
          "AND 2 FOLLOWING)", ("min", ("range", "m", -2, 2))),
    ("l", "max(c) OVER (PARTITION BY g ORDER BY m RANGE BETWEEN 5 PRECEDING "
          "AND CURRENT ROW)", ("max", ("range", "m", -5, 0))),
    # a one-row frame: NULL wherever c is
    ("n", "min(c) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN CURRENT ROW "
          "AND CURRENT ROW)", ("min", ("rows", "k", 0, 0))),
]


@pytest.mark.parametrize("tier", ["operator", "stage", "auto"])
def test_string_minmax_match_oracle(tier_sessions, replayed, tier):
    """min and max of a nullable string over every frame the port runs
    (the whole partition, running with peers over a key with NULLs and
    ties, ROWS frames, value RANGE frames), in SQL and through F.min and
    F.max over a Window, each equal to the plain oracle: NULLs are
    skipped and an all-NULL frame gives NULL."""
    t = tier_sessions[tier]
    cols = ", ".join(f"{text} AS {name}" for name, text, _ in STRING_MINMAX)
    got = t.sql(f"SELECT k, {cols} FROM t3").toArrow()
    rows = construct_tables()["t3"].to_pylist()
    for name, _, (fn, frame) in STRING_MINMAX:
        want = minmax_oracle(rows, "g", fn, frame)
        assert _by_k(got, name) == want, name
    assert any(v is None for v in _by_k(got, "n").values())
    w = Window.partitionBy("g").orderBy("o")
    df = t.sql("SELECT * FROM t3").select(
        "k", F.min("c").over(w).alias("lo"),
        F.max("c").over(Window.partitionBy("g").orderBy("k")
                        .rowsBetween(-1, 1)).alias("hi"))
    out = df.toArrow()
    assert _by_k(out, "lo") == minmax_oracle(rows, "g", "min",
                                             ("peers", "o"))
    assert _by_k(out, "hi") == minmax_oracle(rows, "g", "max",
                                             ("rows", "k", -1, 1))


def test_reference_string_minmax_fault_pinned(sessions):
    """The reference's min/max of a string over a window reduces the
    dictionary codes, which follow first appearance (ROADMAP.md C19): over
    (g, s) = (1, 'b'), (1, 'a'), (2, 'c') its min(s) OVER (PARTITION BY g)
    is 'b' for group 1 and max(s) OVER (PARTITION BY g ORDER BY s) 'a' on
    the row 'b'; the port gives 'a' and 'b', as Spark does."""
    import pyarrow as pa

    j, t = sessions
    tbl = pa.table({"i": [1, 2, 3], "g": [1, 1, 2], "s": ["b", "a", "c"]})
    q = ("SELECT i, min(s) OVER (PARTITION BY g) mn, max(s) OVER "
         "(PARTITION BY g ORDER BY s) mx FROM c19")
    out = {}
    for name, s in (("reference", j), ("port", t)):
        s.createDataFrame(tbl).createOrReplaceTempView("c19")
        rows = sorted(s.sql(q).toArrow().to_pylist(), key=lambda r: r["i"])
        out[name] = [(r["mn"], r["mx"]) for r in rows]
    assert out["reference"] == [("b", "a"), ("b", "a"), ("c", "c")]
    assert out["port"] == [("a", "b"), ("a", "a"), ("c", "c")]
    # over t3's construct the reference's columns differ from the oracle
    text, _ = WINDOW_CONSTRUCTS["window_string_minmax"]
    got = j.sql(text).toArrow()
    rows = construct_tables()["t3"].to_pylist()
    wrong = [col for col, (fn, frame) in
             RANKED["window_string_minmax"].items()
             if _by_k(got, col) != minmax_oracle(rows, "g", fn, frame)]
    assert wrong, "the reference now agrees with the oracle"
