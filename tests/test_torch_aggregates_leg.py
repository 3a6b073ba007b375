"""chip_smoke.py's `aggregates` leg (AGG_QUERIES: A3's aggregates and
A11's lambdas over the SF10 views) on the CPU at 1% of its scale, over
the tables `chip_smoke.tpcds_data` builds: each statement's result in the
port equals the reference's and the leg's own oracle
(`chip_smoke.aggregates_oracle`, which the card's run is held to), and
its compile-tier decision at `auto` equals the reference's on the same
plan (minRows at its default and at 0).

Where the reference is at fault the statement is held to the oracle
alone: the strings statement's first over a string column (ROADMAP.md
C17) and the map of decimals the lambda_maps statement filters (a decimal
inside a host-built map loses its scale in the reference, C15)."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import chip_smoke as cs  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401
from tests.test_torch_tpcds_slice import _tier  # noqa: E402

SCALE = 0.01
TIER = "spark.tpu.compile.tier"
# statements the reference cannot run: held to the oracle alone
REFERENCE_FAULTS = {"strings": "C17", "lambda_maps": "C15"}


@pytest.fixture(scope="module")
def leg():
    tables, _ = cs.tpcds_data(scale=SCALE)
    j = TpuSession("agg-leg-reference", dict(cs.TPCDS_CONF))
    t = TorchSession("agg-leg", dict(cs.TPCDS_CONF), device="cpu")
    names = ("store_sales", "date_dim", "customer", "store", "item",
             "customer_address")
    for s in (j, t):
        for name in names:
            s.createDataFrame(tables[name]).createOrReplaceTempView(name)
    # the reference cannot collect item_nested's map of decimals (C15):
    # it reads the port's table
    for name, text in cs.TYPES_TABLES.items():
        t.sql(text)
        j.createDataFrame(t.table(name).toArrow()) \
            .createOrReplaceTempView(name)
    yield tables, j, t
    j.stop()
    t.stop()


def _rows(tb) -> list:
    return sorted((tuple(cs._plain(v) for v in r.values())
                   for r in tb.to_pylist()), key=repr)


@pytest.mark.parametrize("name", list(cs.AGG_QUERIES))
def test_leg_statement_matches_reference_and_oracle(leg, name, monkeypatch):
    tables, j, t = leg
    text = cs.AGG_QUERIES[name]
    got = t.sql(text).toArrow()
    failures = []
    monkeypatch.setattr(cs, "fail", failures.append)
    cs.aggregates_check(name, got, cs.aggregates_oracle(name, tables))
    assert failures == []
    if name in REFERENCE_FAULTS:
        return
    want = j.sql(text).toArrow()
    assert got.column_names == want.column_names
    g, w = _rows(got), _rows(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        for x, y in zip(a, b):
            if isinstance(x, float) and isinstance(y, float):
                assert x == pytest.approx(y, rel=cs.AGG_FLOAT_RTOL), (a, b)
            else:
                assert x == y, (a, b)


@pytest.mark.parametrize("min_rows", [None, 0])
def test_leg_decisions_match_reference(leg, min_rows):
    _, j, t = leg
    for s in (j, t):
        s.conf.set(TIER, "auto")
        if min_rows is not None:
            s.conf.set("spark.tpu.compile.whole.minRows", min_rows)
    try:
        for name, text in cs.AGG_QUERIES.items():
            assert _tier(t.sql(text)) == _tier(j.sql(text)), name
    finally:
        for s in (j, t):
            s.conf.unset("spark.tpu.compile.whole.minRows")


@pytest.mark.parametrize("name", cs.AGG_BITS)
def test_leg_bits_statement_at_the_whole_tier(leg, name, monkeypatch):
    """The bits statements at a forced `whole`, as the card's leg also
    runs them (the bit reduce inside a whole program): the plan lowers
    whole and its result equals the oracle."""
    tables, _, t = leg
    t.conf.set(TIER, "whole")
    try:
        df = t.sql(cs.AGG_QUERIES[name])
        assert _tier(df)[0] == "whole"
        got = df.toArrow()
    finally:
        t.conf.unset(TIER)
    failures = []
    monkeypatch.setattr(cs, "fail", failures.append)
    cs.aggregates_check(name, got, cs.aggregates_oracle(name, tables))
    assert failures == []


def test_bits_months_and_or_differ_between_months(leg):
    """bits_months is the leg's bits statement whose AND and OR are not
    the same in every group (a month's date keys share their high bits),
    so a kernel that returned 0 or all ones without reducing fails it."""
    tables, _, _ = leg
    rows = cs.aggregates_oracle("bits_months", tables)
    assert len(rows) > 12
    for col in (2, 3):
        vals = {r[col] for r in rows}
        assert len(vals) > len(rows) // 4 and not vals & {0, -1}
