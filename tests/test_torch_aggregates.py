"""The aggregates of A3 in spark_tpu_torch against the JAX package, on one
seeded table, in SQL and DataFrame form.

  * bit_and, bit_or, bit_xor (the bit kernel's plain twin on the CPU),
    percentile, median, percentile_approx, collect_list, collect_set,
    array_agg, mode, first, any_value, string min and max, corr,
    covar_samp, covar_pop, skewness, kurtosis, and sum/avg(DISTINCT),
    grouped by a dense key, a sparse key, two keys, a string key and a
    nullable key, and ungrouped, over int32, int64, decimal, double, date
    and string columns with NULLs, an all-NULL group and an empty input.
  * The port runs at the operator tier against the reference's operator
    tier; at the stage tier (fusion.minRows 0, each fused body watched for
    host reads and replayed for later batches) against the reference too;
    at forced `whole`, where the reference lowers the plan, against the
    reference. The tier chooser's decision and reason equal the
    reference's for every statement at `auto`.
  * Integers, strings, dates, decimals and percentiles compare exactly; a
    collect's list as a multiset (its order is the input's, unspecified in
    Spark); the float moments to relative 1e-9 (both engines evaluate the
    reference's raw-moment formulas, the sums in different orders). The bit
    ops are also held to a functools.reduce oracle.
  * first/any_value over a string column: the reference drops the
    column's dictionary and raises (ROADMAP.md C17); the port's value is
    held to its group's values.
"""

import functools
import math
import operator

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
from tests.test_torch_fusion import replay_first, watch_syncs  # noqa: E402
from tests.test_torch_tpcds_slice import _tier  # noqa: E402

CONF = {"spark.sql.shuffle.partitions": 3, "spark.tpu.batch.capacity": 1 << 7,
        "spark.tpu.fusion.minRows": 0, "spark.tpu.compile.whole.minRows": 0}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator"})
TIER = "spark.tpu.compile.tier"
RTOL = 1e-9
N = 400

# GROUP BY clause of each grouping (key columns first in the SELECT)
GROUPINGS = {"dense": "g", "sparse": "w", "two": "g, g2", "string": "sk",
             "nullable": "nk", "none": "", "empty": ""}
# the aggregate columns of each statement family; {c} an integral column
MERGEABLE = ("bit_and(i32) ba32, bit_or(i32) bo32, bit_xor(i32) bx32, "
             "bit_and(i64) ba, bit_or(i64) bo, bit_xor(i64) bx, "
             "min(s) smin, max(s) smax, first(i64) f64, "
             "corr(i64, dbl) cr, covar_samp(i64, dbl) cs, "
             "covar_pop(dbl, i32) cp, skewness(dbl) sk3, kurtosis(i64) ku, "
             "count(*) n")
NON_MERGEABLE = ("percentile(i32, 0.9) p32, median(i64) md, "
                 "percentile_approx(dec, 0.25) pd, median(dbl) mdd, "
                 "percentile(dt, 0.5) pdt, collect_list(i64) cl, "
                 "collect_set(s) cs, array_agg(dt) ad, count(*) n")
FAMILIES = {"mergeable": MERGEABLE, "non_mergeable": NON_MERGEABLE,
            "mode": "mode(i32) m32", "mode_string": "mode(s) ms",
            "distinct": "sum(DISTINCT i32) sd, avg(DISTINCT i32) ad",
            "distinct_dec": "sum(DISTINCT dec) sdd, avg(DISTINCT dec) adv"}
FLOAT_COLS = {"cr", "cs", "cp", "sk3", "ku", "ad", "mdd"}
LIST_COLS = {"cl", "cs", "ad"}
# families whose plans the reference lowers at forced whole
WHOLE_FAMILIES = ("mergeable", "distinct")


def table() -> pa.Table:
    """g dense in [0, 8) (group 0's values all NULL), w sparse, g2 a second
    key, sk a string key, nk a nullable key; values with NULLs: int32,
    int64 (negatives), decimal(9,2), double, date, string."""
    rng = np.random.default_rng(15)
    g = rng.integers(0, 8, N)
    null = (g == 0) | (rng.random(N) < 0.15)
    i32 = rng.integers(-2000, 2000, N).astype(np.int32)
    i64 = rng.integers(-(1 << 40), 1 << 40, N)
    # few distinct values, so mode and DISTINCT see ties and repeats
    few = rng.random(N) < 0.5
    i32[few] = rng.integers(-3, 3, int(few.sum()))
    i32[::7] = 5
    dec = rng.integers(-99999, 99999, N)
    dbl = rng.standard_normal(N) * 100
    days = rng.integers(0, 20000, N)
    words = np.array(["pear", "apple", "fig", "kiwi", "date", "lime",
                      "zest", "Apple", "plum", ""])
    s = words[rng.integers(0, len(words), N)]
    nk_null = rng.random(N) < 0.2
    import datetime
    import decimal

    epoch = datetime.date(1970, 1, 1)
    return pa.table({
        "g": g.astype(np.int64),
        "w": (g * 1_000_000_007 + 3).astype(np.int64),
        "g2": rng.integers(0, 3, N).astype(np.int64),
        "sk": pa.array([f"k{v}" for v in g]),
        "nk": pa.array(rng.integers(0, 4, N), pa.int64(), mask=nk_null),
        "i32": pa.array(i32, pa.int32(), mask=null),
        "i64": pa.array(i64, pa.int64(), mask=null),
        "dec": pa.array([decimal.Decimal(int(v)).scaleb(-2) for v in dec],
                        pa.decimal128(9, 2), mask=null),
        "dbl": pa.array(dbl, pa.float64(), mask=null),
        "dt": pa.array([epoch + datetime.timedelta(days=int(d))
                        for d in days], pa.date32(), mask=null),
        "s": pa.array(s.tolist(), pa.string(), mask=null),
    })


def statement(family: str, grouping: str) -> str:
    keys = GROUPINGS[grouping]
    head = f"{keys}, " if keys else ""
    where = " WHERE i64 > 1e18" if grouping == "empty" else ""
    tail = f" GROUP BY {keys}" if keys else ""
    return f"SELECT {head}{FAMILIES[family]} FROM agg{where}{tail}"


# mode and DISTINCT rewrite the plan whatever the column: their second
# column type runs under the dense key alone
CASES = [(f, g) for f in FAMILIES for g in GROUPINGS
         if not (f.startswith(("mode", "distinct"))
                 and g not in ("dense", "string", "none"))
         and not (f in ("mode_string", "distinct_dec") and g != "dense")]


def _norm(v, col: str):
    if col in LIST_COLS and isinstance(v, list):
        return sorted(v, key=repr)
    return v


def _rows(tb: pa.Table) -> list:
    cols = tb.column_names
    rows = [tuple(_norm(v, c) for v, c in zip(r, cols))
            for r in zip(*[c.to_pylist() for c in tb.columns])]
    return sorted(rows, key=repr)


def _same(got: pa.Table, want: pa.Table, label: str) -> None:
    assert got.column_names == want.column_names, label
    assert got.num_rows == want.num_rows, (label, got.num_rows,
                                           want.num_rows)
    for a, b in zip(_rows(got), _rows(want)):
        for x, y, c in zip(a, b, got.column_names):
            if c in FLOAT_COLS and isinstance(x, float) \
                    and isinstance(y, float):
                assert x == y or math.isclose(x, y, rel_tol=RTOL,
                                              abs_tol=1e-9) or (
                    math.isnan(x) and math.isnan(y)), (label, c, a, b)
            else:
                assert x == y, (label, c, a, b)


@pytest.fixture(scope="module")
def engines():
    j = TpuSession("agg-reference", dict(JAX_CONF))
    t = TorchSession("agg", dict(CONF, **{TIER: "operator"}), device="cpu")
    tb = table()
    for s in (j, t):
        s.createDataFrame(tb).createOrReplaceTempView("agg")
    yield j, t
    j.stop()
    t.stop()


@pytest.fixture(scope="module")
def reference(engines):
    j, _ = engines
    return {case: j.sql(statement(*case)).toArrow() for case in CASES}


@pytest.mark.parametrize("family,grouping", CASES)
def test_operator_tier_matches_reference(engines, reference, family,
                                         grouping):
    _, t = engines
    got = t.sql(statement(family, grouping)).toArrow()
    _same(got, reference[(family, grouping)], "operator")


def _at_tier(t, tier: str, text: str):
    t.conf.set(TIER, tier)
    try:
        df = t.sql(text)
        return df, df.toArrow()
    finally:
        t.conf.set(TIER, "operator")


def test_stage_tier_matches_reference(engines, reference, monkeypatch):
    """Every statement at the stage tier: fused bodies replayed for their
    key's later batches and watched for host reads."""
    _, t = engines
    syncs = watch_syncs(monkeypatch)
    bodies = replay_first(monkeypatch)
    for case in CASES:
        _, got = _at_tier(t, "stage", statement(*case))
        _same(got, reference[case], f"stage {case}")
    assert bodies and sorted(set(syncs)) == []


def test_forced_whole_matches_reference(engines, reference):
    """Forced whole runs a whole program where the reference lowers the
    plan (the mergeable aggregates, the DISTINCT rewrite) and stays staged
    with the reference's reason where it does not (percentile, collect)."""
    j, t = engines
    whole = 0
    for case in CASES:
        text = statement(*case)
        df, got = _at_tier(t, "whole", text)
        _same(got, reference[case], f"whole {case}")
        j.conf.set(TIER, "whole")
        j.conf.set("spark.tpu.fusion.enabled", "true")
        try:
            want = _tier(j.sql(text))
        finally:
            j.conf.set(TIER, "operator")
            j.conf.set("spark.tpu.fusion.enabled", "false")
        assert _tier(df) == want, case
        whole += _tier(df)[0] == "whole"
        if case[0] in WHOLE_FAMILIES:
            assert _tier(df)[0] == "whole", case
    assert whole >= len(WHOLE_FAMILIES) * 3


@pytest.mark.parametrize("min_rows", [0, None])
def test_auto_decisions_match_reference(engines, min_rows):
    j, t = engines
    for s in (j, t):
        s.conf.set(TIER, "auto")
        s.conf.set("spark.tpu.fusion.enabled", "true")
        if min_rows is None:
            s.conf.unset("spark.tpu.compile.whole.minRows")
    try:
        for case in CASES:
            text = statement(*case)
            assert _tier(t.sql(text)) == _tier(j.sql(text)), case
    finally:
        for s in (j, t):
            s.conf.set(TIER, "operator")
            s.conf.set("spark.tpu.fusion.enabled", "false")
            s.conf.set("spark.tpu.compile.whole.minRows", 0)
        t.conf.set("spark.tpu.fusion.enabled", "true")


def _py_groups(key: str, col: str) -> dict:
    tb = table()
    out: dict = {}
    for k, v in zip(tb.column(key).to_pylist(), tb.column(col).to_pylist()):
        out.setdefault(k, [])
        if v is not None:
            out[k].append(v)
    return out


@pytest.mark.parametrize("kind", ["and", "or", "xor"])
def test_bit_ops_match_python_reduce(engines, kind):
    _, t = engines
    fn = {"and": operator.and_, "or": operator.or_, "xor": operator.xor}[kind]
    got = t.sql(f"SELECT g, bit_{kind}(i64) b, bit_{kind}(i32) b32 FROM agg "
                "GROUP BY g").toArrow().to_pylist()
    g64, g32 = _py_groups("g", "i64"), _py_groups("g", "i32")
    want = {k: (functools.reduce(fn, g64[k]) if g64[k] else None,
                functools.reduce(fn, g32[k]) if g32[k] else None)
            for k in g64}
    assert {r["g"]: (r["b"], r["b32"]) for r in got} == want
    assert want[0] == (None, None)   # the all-NULL group


def test_dataframe_forms_match_reference(engines):
    j, t = engines

    def build(s, F):
        return s.table("agg").groupBy("sk").agg(
            F.first("i64").alias("f"), F.any_value("g").alias("a"),
            F.median("i64").alias("md"),
            F.percentile_approx("dec", 0.75).alias("pd"),
            F.corr("i64", "dbl").alias("cr"),
            F.covar_samp("i64", "dbl").alias("cs"),
            F.covar_pop("i64", "dbl").alias("cp"),
            F.skewness("dbl").alias("sk3"), F.kurtosis("dbl").alias("ku"),
            F.collect_list("i32").alias("cl"),
            F.collect_set("s").alias("cs2"),
            F.array_agg("dt").alias("ad2"))

    got = build(t, TF).toArrow()
    want = build(j, JF).toArrow()
    global LIST_COLS
    LIST_COLS = LIST_COLS | {"cs2", "ad2"}
    _same(got, want, "dataframe")
    got = t.table("agg").groupBy("g").agg(
        TF.sum_distinct("i32").alias("sd")).toArrow()
    want = j.table("agg").groupBy("g").agg(
        JF.sum_distinct("i32").alias("sd")).toArrow()
    _same(got, want, "sum_distinct")


@pytest.mark.parametrize("tier", ["operator", "stage", "whole"])
@pytest.mark.parametrize("grouped", [True, False])
def test_first_of_a_string_is_a_group_value(engines, tier, grouped):
    """C17: the reference drops a string first's dictionary and fails; the
    port's first and any_value of a string are values of their group."""
    j, t = engines
    text = ("SELECT g, first(s) f, any_value(s) a FROM agg GROUP BY g"
            if grouped else "SELECT first(s) f, any_value(s) a FROM agg")
    with pytest.raises(AttributeError):
        j.sql(text).toArrow()
    _, got = _at_tier(t, tier, text)
    groups = _py_groups("g", "s")
    rows = got.to_pylist()
    assert len(rows) == (len(groups) if grouped else 1)
    for r in rows:
        vals = groups[r["g"]] if grouped else \
            [v for vs in groups.values() for v in vs]
        for c in ("f", "a"):
            assert (r[c] in vals) if vals else r[c] is None, (r, c)


def test_refusals_match_reference(engines):
    """mode beside another aggregate, and DISTINCT over two different
    expressions, are refused by both engines with the same error class."""
    j, t = engines
    for text in ("SELECT g, mode(i32), sum(i64) FROM agg GROUP BY g",
                 "SELECT count(DISTINCT i32), sum(DISTINCT i64) FROM agg",
                 "SELECT bit_and(dbl) FROM agg"):
        errs = []
        for s in (j, t):
            with pytest.raises(Exception) as err:
                s.sql(text).toArrow()
            errs.append(type(err.value).__name__)
        assert errs[0] == errs[1], (text, errs)


def test_collect_of_a_decimal_keeps_its_scale(engines):
    """collect_list and collect_set of a decimal column hold Decimals at
    the column's scale, equal to Python's lists; the reference's collect
    of the same lists fails (a float where Arrow wants a Decimal,
    ROADMAP.md C17)."""
    j, t = engines
    text = ("SELECT g, collect_list(dec) l, collect_set(dec) s FROM agg "
            "GROUP BY g")
    with pytest.raises(pa.ArrowTypeError):
        j.sql(text).toArrow()
    groups = _py_groups("g", "dec")
    for tier in ("operator", "stage"):
        _, got = _at_tier(t, tier, text)
        rows = got.to_pylist()
        assert len(rows) == len(groups)
        for r in rows:
            assert sorted(r["l"]) == sorted(groups[r["g"]])
            assert sorted(r["s"]) == sorted(set(groups[r["g"]]))
