"""TPC-DS queries of the fourth SQL slice that add an INTERVAL to a date
(q21 q32 q37 q40 q72 q82 q92): the interval survives into the optimised
plan and evaluates per row (q72 adds `interval 5 days` to a date column),
over inventory (q21, q37, q72, q82) and the catalog and web channels; held
to their goldens, to the JAX reference's results and plans, and to
`chip_smoke.py`'s SF10 plans exactly as `tests/test_torch_tpcds_store.py`
holds the store-channel queries (q72 is planned at SF10 but not run there:
`chip_smoke.TPCDS_SF10_CUT`). q21, q37, q40 and q82, whose goldens have no
rows at scale 0.1, also run with relaxed literals (`TPCDS_VARIANTS` of
`tests/test_torch_cuda.py`)."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.test_torch_cuda import TPCDS_VARIANTS  # noqa: E402
from tests.test_torch_tpcds_store import (  # noqa: E402,F401
    Sf10Planner, TpcdsPair, check_golden, check_plans, check_reference,
    check_whole, one_torch_thread,
)

QUERIES = ("q21", "q32", "q37", "q40", "q72", "q82", "q92")


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
