"""The compile-tier decision of all 103 TPC-DS query files at `auto`
(physical/whole_query.py's cost model), on the CPU: tier and reason equal
the JAX package's, planned over the scale-0.01 tables with
spark.tpu.compile.whole.minRows 0 and at its default (each query's CTEs and
scalar subqueries run first at the operator tier, as they run while a
query is planned). The files' results at the forced whole tier are held to
the reference's in each TPC-DS slice file (`check_whole` of
tests/test_torch_tpcds_store.py, scale 0.1), to the goldens and to the
port's operator tier in tests/test_torch_tpcds_whole_golden.py."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from tests.test_torch_cuda import tpcds_query  # noqa: E402
from tests.test_torch_fusion import (  # noqa: E402,F401
    TPCDS_FILES, one_torch_thread,
)

CONF = {"spark.sql.shuffle.partitions": 4,
        "spark.tpu.batch.capacity": 1 << 10}
TIER = "spark.tpu.compile.tier"
MIN_ROWS = "spark.tpu.compile.whole.minRows"


@pytest.fixture(scope="module")
def planners():
    """Both engines over the scale-0.01 tables, fusion on, at the
    operator tier until a query's physical plan is asked for."""
    from tests.tpcds.datagen import gen_tpcds_full

    tables = gen_tpcds_full(scale=0.01)
    j = TpuSession("tpcds-whole-plans", dict(
        CONF, **{"spark.tpu.fusion.enabled": "true", TIER: "operator"}))
    t = TorchSession("tpcds-whole-plans", dict(CONF, **{TIER: "operator"}),
                     device="cpu")
    for name, tb in tables.items():
        j.createDataFrame(tb).createOrReplaceTempView(name)
        t.createDataFrame(tb).createOrReplaceTempView(name)
    yield j, t
    j.stop()
    t.stop()


def _decisions(session, text) -> list:
    """(tier, reason) of the query's plan at `auto`, with minRows 0 and
    at its default."""
    session.conf.set(TIER, "operator")
    optimized = session.sql(text).query_execution.optimized
    out = []
    try:
        session.conf.set(TIER, "auto")
        for min_rows in ("0", None):
            if min_rows is None:
                session.conf.unset(MIN_ROWS)
            else:
                session.conf.set(MIN_ROWS, min_rows)
            phys = session._planner().plan(optimized)
            d = getattr(phys, "decision", None) or phys._tier_decision
            out.append((type(phys).__name__ == "WholeQueryExec",
                        d.tier, d.reason))
    finally:
        session.conf.unset(MIN_ROWS)
        session.conf.set(TIER, "operator")
    return out


@pytest.mark.parametrize("name", TPCDS_FILES)
def test_auto_decision_matches_reference(planners, name):
    j, t = planners
    text = tpcds_query(name)
    assert _decisions(t, text) == _decisions(j, text)
