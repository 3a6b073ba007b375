"""TPC-DS queries of the store channel (store_sales and store_returns with
their dimensions) from SQL text end to end, as
`tests/test_torch_tpcds_slice.py` runs q3, q7 and q19: the query files,
verbatim, through TpuSession (operator tier, fusion off) and
TorchSession(device="cpu").sql over temp views of `tests/tpcds/datagen.py`
at scale 0.1, with 2^10-row tiles and 4 shuffle partitions. Each result
(its trailing LIMIT dropped, as the goldens were made) equals the committed
golden under `tests/tpcds/oracle.py`'s comparison; each result as written
equals the reference's Arrow table exactly (types, values, row order), and
the port's result at the forced whole-query tier equals it too
(`check_whole`); the analysed and optimised plans print the same trees
(expression ids and materialised CTE names renumbered) and the physical
plans hold the same operator sequence; and the plans of both engines at the TPC-DS SF10 row
counts equal `chip_smoke.py`'s `TPCDS_PLAN_OPS`. The queries that return
no rows at this scale also run with literals that select at least 10 rows
(`TPCDS_VARIANTS` of `tests/test_torch_cuda.py`, which runs the same
queries on the card against the CPU).
`tests/test_torch_tpcds_channels.py` does the same for the queries that
read the catalog and web channels, with the helpers defined here."""

import json
import os
import re

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from tests.test_torch_cuda import TPCDS_VARIANTS  # noqa: E402
from tests.test_torch_cuda import tpcds_query as query_text  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401
from tests.test_torch_tpcds_slice import (  # noqa: E402
    CONF, JAX_CONF, _chip_smoke, _ops, _reference_ops, _renumber, _Sized,
    _tier,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "tpcds", "expected")
QUERIES = ("q13", "q34", "q42", "q43", "q46", "q48", "q50", "q52", "q55",
           "q59", "q65", "q68", "q73", "q79", "q93", "q96")


def renumber(text: str) -> str:
    """`_renumber`, with the unique suffix of a materialised CTE's relation
    name (`__cte_mat_<name>_<8 hex digits>`) dropped."""
    return _renumber(re.sub(r"(__cte_mat_\w+?)_[0-9a-f]{8}", r"\1", text))


class TpcdsPair:
    """Both engines over the scale-0.1 tables, each query run once per
    engine and kept (the reference takes seconds a query)."""

    def __init__(self):
        from tests.tpcds.datagen import gen_tpcds_full

        self.tables = gen_tpcds_full(scale=0.1)
        self.jax = TpuSession("tpcds-reference", dict(JAX_CONF))
        self.torch = TorchSession("tpcds", dict(CONF), device="cpu")
        for name, tb in self.tables.items():
            self.jax.createDataFrame(tb).createOrReplaceTempView(name)
            self.torch.createDataFrame(tb).createOrReplaceTempView(name)
        self._runs: dict = {}

    def run(self, engine: str, name: str):
        """(DataFrame, Arrow result) of query `name` on `engine`."""
        key = (engine, name)
        if key not in self._runs:
            df = getattr(self, engine).sql(query_text(name))
            self._runs[key] = (df, df.toArrow())
        return self._runs[key]

    def stop(self):
        self.jax.stop()
        self.torch.stop()


def check_golden(pair: TpcdsPair, name: str) -> None:
    from tests.test_tpcds_full import _norm_rows
    from tests.tpcds.oracle import compare_rows, strip_trailing_limit

    got = pair.torch.sql(strip_trailing_limit(query_text(name))).toArrow()
    golden = json.load(open(os.path.join(GOLDEN_DIR, f"{name}.json")))
    ok, msg = compare_rows(_norm_rows(got),
                           [tuple(r) for r in golden["rows"]])
    assert ok, msg


def check_reference(pair: TpcdsPair, name: str) -> None:
    _, want = pair.run("jax", name)
    _, got = pair.run("torch", name)
    if name.endswith("_variant"):
        assert want.num_rows >= 10
    assert got.schema == want.schema
    assert got.to_pylist() == want.to_pylist()


WHOLE = {"spark.tpu.compile.tier": "whole", "spark.tpu.fusion.minRows": 0}


def check_whole(session, want, name: str, monkeypatch) -> None:
    """Query `name` on the port's `session` at the forced whole-query tier
    (physical/whole_query.py, minRows 0) equal to the reference's result
    `want` at the operator tier, with each program's first body run for
    all its later runs, as a graph replays, and no body reading a device
    value on the host. Integers, strings and ordered output compare
    exactly, float sums to relative 1e-12."""
    from tests.test_torch_fusion import _same, replay_first, watch_syncs

    found = watch_syncs(monkeypatch)
    replay_first(monkeypatch)
    text = query_text(name)
    saved = {k: session.conf.get(k) for k in WHOLE}
    for k, v in WHOLE.items():
        session.conf.set(k, v)
    try:
        df = session.sql(text)
        got = df.toArrow()
    finally:
        for k, v in saved.items():
            session.conf.set(k, v)
    assert not found, found[:5]
    assert got.schema == want.schema
    _same(got, want, ordered="order by" in text.lower())


def check_variant(pair: TpcdsPair, name: str, min_rows: int = 10) -> None:
    """A variant equals the reference's result and is not degenerate: at
    least `min_rows` rows; a one-row aggregate (min_rows 1) holds no NULL
    and no 0."""
    _, want = pair.run("jax", name)
    _, got = pair.run("torch", name)
    assert got.schema == want.schema
    assert got.to_pylist() == want.to_pylist()
    assert want.num_rows >= min_rows
    if min_rows == 1:
        assert all(v is not None and v != 0
                   for v in want.to_pylist()[0].values())


def check_plans(pair: TpcdsPair, name: str) -> None:
    jd, _ = pair.run("jax", name)
    td, _ = pair.run("torch", name)
    for phase in ("analyzed", "optimized"):
        want = getattr(jd.query_execution, phase).tree_string()
        got = getattr(td.query_execution, phase).tree_string()
        assert renumber(got) == renumber(want), phase
    assert _ops(td) == _ops(jd)


class Sf10Planner:
    """Both engines over stand-ins of the scale-0.1 tables that report the
    SF10 row counts of `chip_smoke.TPCDS_ROWS`: the planners read only the
    schema and the row count. A query's CTEs and scalar subqueries run at
    the operator tier over the small tables (they run while it is planned),
    and a CTE the session materialises then stands in at the row count the
    card materialised at SF10 (`chip_smoke.TPCDS_CTE_ROWS`), which the rest
    of the plan's join order, broadcast choices and compile tier read. The
    query itself is planned at the default tier, `auto` (fusion on), as
    the card's tpcds leg runs it."""

    def __init__(self, tables):
        self.cs = _chip_smoke()
        self.sessions = {e: self._session(e, tables) for e in ("jax", "torch")}

    def _session(self, engine, tables):
        cs = self.cs
        if engine == "jax":
            from spark_tpu.api.dataframe import DataFrame
            from spark_tpu.expr.expressions import AttributeReference
            from spark_tpu.plan.logical import LocalRelation
            from spark_tpu.types import from_arrow_type

            session = TpuSession("sf10-plans", dict(
                JAX_CONF, **cs.TPCDS_CONF,
                **{"spark.tpu.fusion.enabled": "true"}))
        else:
            from spark_tpu_torch.api.dataframe import DataFrame
            from spark_tpu_torch.expr.expressions import AttributeReference
            from spark_tpu_torch.plan.logical import LocalRelation
            from spark_tpu_torch.types import from_arrow_type

            session = TorchSession("sf10-plans", dict(cs.TPCDS_CONF),
                                   device="cpu")
        for name, rows in cs.TPCDS_ROWS.items():
            tb = tables[name]
            attrs = [AttributeReference(f.name, from_arrow_type(f.type), True)
                     for f in tb.schema]
            DataFrame(session, LocalRelation(attrs, _Sized(tb, rows))) \
                .createOrReplaceTempView(name)
        return session

    def plan(self, engine: str, name: str):
        """The query's DataFrame, planned at the default tier."""
        session = self.sessions[engine]
        rows = list(self.cs.TPCDS_CTE_ROWS.get(name, {}).values())
        create = session.createDataFrame

        def sized(data, schema=None):
            df = create(data, schema)
            df.plan = df.plan.copy(table=_Sized(df.plan.table, rows.pop(0)))
            return df

        session.createDataFrame = sized  # materialised CTEs come through it
        session.conf.set("spark.tpu.compile.tier", "operator")
        try:
            df = session.sql(query_text(name))
            df.query_execution.optimized  # noqa: B018 (scalar subqueries)
            session.conf.set("spark.tpu.compile.tier", "auto")
            df.query_execution.physical  # noqa: B018
            return df
        finally:
            del session.createDataFrame
            session.conf.set("spark.tpu.compile.tier", "operator")
            assert not rows, "a materialised CTE was not planned"

    def _ops(self, engine: str, name: str) -> tuple:
        df = self.plan(engine, name)
        ops = _reference_ops(df) if engine == "jax" else _ops(df)
        return ops, _tier(df)

    def check(self, name: str) -> None:
        want = self._ops("jax", name)
        got = self._ops("torch", name)
        assert got == want
        assert tuple(got[0]) == self.cs.TPCDS_PLAN_OPS[name]
        assert got[1] == self.cs.TPCDS_TIERS[name]


@pytest.fixture(scope="module")
def pair():
    p = TpcdsPair()
    yield p
    p.stop()


@pytest.fixture(scope="module")
def sf10(pair):
    return Sf10Planner(pair.tables)


@pytest.mark.parametrize("name", QUERIES)
def test_query_matches_golden(pair, name):
    check_golden(pair, name)


@pytest.mark.parametrize("name", QUERIES + tuple(
    f"{q}_variant" for q in QUERIES if q in TPCDS_VARIANTS))
def test_query_matches_reference(pair, name):
    check_reference(pair, name)


@pytest.mark.parametrize("name", QUERIES)
def test_whole_matches_reference(pair, monkeypatch, name):
    check_whole(pair.torch, pair.run("jax", name)[1], name, monkeypatch)


@pytest.mark.parametrize("name", QUERIES)
def test_plans_match_reference(pair, name):
    check_plans(pair, name)


@pytest.mark.parametrize("name", QUERIES)
def test_sf10_plans_match_chip_smoke(sf10, name):
    sf10.check(name)
