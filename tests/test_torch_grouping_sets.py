"""ROLLUP, CUBE and GROUPING SETS, date arithmetic with INTERVAL literals,
and CASE with string results in the port's fourth SQL slice, against the
JAX reference: grouping() and grouping_id() in the SELECT list (with and
without arguments), in HAVING and ORDER BY through their aliases, a rank
over a ROLLUP; date +/- interval literal of months (clamped to the end of
the month), days, weeks and years, folded interval arithmetic (`interval
1 day * 3`), date +/- integer and integer columns, date_add, date_sub,
datediff and date - date, an interval in a filter's bounds; string CASE
branches from columns, literals and a dictionary transform, a NULL ELSE,
simple CASE, and grouping and ordering by a string CASE. Each statement
runs over `tests/test_torch_cuda.py`'s t3 in both engines (operator tier,
fusion off in the reference), with the plans and results compared as in
`tests/test_torch_windows.py`; `df.rollup` and `df.cube` equal their SQL
forms; month-end clamping is also held to Python's calendar."""

import datetime

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu_torch.api.functions as F  # noqa: E402
from spark_tpu_torch.errors import AnalysisException  # noqa: E402
from tests.test_torch_cuda import WINDOW_CONSTRUCTS  # noqa: E402
from tests.test_torch_cuda import construct_rows as _rows  # noqa: E402
from tests.test_torch_cuda import construct_tables  # noqa: E402
from tests.test_torch_windows import check_pair, sessions  # noqa: E402,F401

CASES = [n for n in WINDOW_CONSTRUCTS if not n.startswith("window")]


@pytest.mark.parametrize("name", CASES)
def test_statement_matches_reference(sessions, name):  # noqa: F811
    j, t = sessions
    text, ordered = WINDOW_CONSTRUCTS[name]
    check_pair(j.sql(text), t.sql(text), ordered)


def test_rollup_is_a_union_of_aggregates(sessions):  # noqa: F811
    _, t = sessions
    plan = t.sql(WINDOW_CONSTRUCTS["rollup"][0]).query_execution
    text = plan.optimized.tree_string()
    assert text.count("Aggregate(") == 3 and "Union" in text
    assert "GroupingSets" not in text


@pytest.mark.parametrize("kind", ["rollup", "cube"])
def test_dataframe_grouping_sets_equal_sql(sessions, kind):  # noqa: F811
    _, t = sessions
    df = getattr(t.createDataFrame(construct_tables()["t3"]), kind)("g", "c") \
        .agg(F.sum("i").alias("s"), F.grouping("g").alias("gg"),
             F.grouping_id().alias("gid"))
    want = t.sql(f"SELECT g, c, sum(i) s, grouping(g) gg, grouping_id() gid "
                 f"FROM t3 GROUP BY {kind.upper()}(g, c)").toArrow()
    assert _rows(df.toArrow(), False) == _rows(want, False)


def test_dataframe_grouping_sets_match_reference(sessions):  # noqa: F811
    import spark_tpu.api.functions as JF

    j, t = sessions
    frames = []
    for s, fn in ((j, JF), (t, F)):
        frames.append(s.createDataFrame(construct_tables()["t3"])
                      .cube("g", "c").agg(fn.avg("x").alias("a"),
                                          fn.grouping_id("c").alias("gid")))
    check_pair(*frames, False)


@pytest.mark.parametrize("text", [
    # grouping() outside the SELECT list is not folded by the reference's
    # ExpandGroupingSets, and an aggregate in HAVING over grouping sets
    # does not resolve there: the port raises as the reference does
    "SELECT g, c, sum(i) s FROM t3 GROUP BY ROLLUP(g, c) "
    "HAVING grouping(c) = 0",
    "SELECT g, c, sum(i) s FROM t3 GROUP BY ROLLUP(g, c) "
    "ORDER BY grouping(c), g, c",
    "SELECT g, sum(i) s FROM t3 GROUP BY ROLLUP(g) HAVING sum(i) > 0",
])
def test_grouping_outside_select_raises_as_reference(  # noqa: F811
        sessions, text):
    j, t = sessions
    errors = []
    for s in (j, t):
        with pytest.raises(Exception) as err:
            s.sql(text).toArrow()
        errors.append(err.value)
    assert isinstance(errors[1], AnalysisException)
    assert str(errors[1]) == str(errors[0])


def _add_months(d: datetime.date, months: int) -> datetime.date:
    import calendar

    total = d.year * 12 + d.month - 1 + months
    y, m = divmod(total, 12)
    return datetime.date(y, m + 1, min(d.day, calendar.monthrange(
        y, m + 1)[1]))


def test_month_arithmetic_clamps_to_month_end(sessions):  # noqa: F811
    _, t = sessions
    rows = t.sql(WINDOW_CONSTRUCTS["month_end"][0]).toArrow().to_pylist()
    assert len(rows) >= 4
    for r in rows:
        assert r["a"] == _add_months(r["dt"], 1)
        assert r["b"] == _add_months(r["dt"], -1)
        assert r["c"] == datetime.date(2000, 2, 29)
        assert r["d"] == datetime.date(2000, 2, 29)


def test_interval_arithmetic_folds(sessions):  # noqa: F811
    _, t = sessions
    df = t.sql("SELECT dt + INTERVAL 1 DAY * 3 - INTERVAL 2 HOURS a, "
               "dt + (INTERVAL 1 MONTH + INTERVAL 2 WEEKS) b, "
               "dt - -INTERVAL 4 DAYS c, dt + INTERVAL 10 DAYS / 4 d FROM t3")
    text = df.query_execution.analyzed.tree_string()
    assert "interval(0mo 3d 0us)" in text
    assert "interval(0mo 0d 7200000000us)" in text
    assert "interval(1mo 14d 0us)" in text
    assert "interval(0mo -4d 0us)" in text
    assert "interval(0mo 2d 43200000000us)" in text
    rows = df.toArrow().to_pylist()
    src = construct_tables()["t3"].column("dt").to_pylist()
    for r, d in zip(rows, src):
        if d is None:
            assert r == {"a": None, "b": None, "c": None, "d": None}
            continue
        # hours move a date by whole days, rounded down (the reference's
        # rule): 3 days less 2 hours is 2 days
        assert r["a"] == d + datetime.timedelta(days=2)
        # the days first, then the months
        assert r["b"] == _add_months(d + datetime.timedelta(days=14), 1)
        assert r["c"] == d + datetime.timedelta(days=4)
        assert r["d"] == d + datetime.timedelta(days=2)
