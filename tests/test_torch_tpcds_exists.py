"""TPC-DS queries of the third SQL slice with IN (SELECT ...) and EXISTS
predicates: semi and anti joins (q33, q56, q58, q60, q69, q83; q33, q56
and q60 over a UNION ALL of their channels, q58 and q83 comparing a date
column with string literals), and EXISTS or IN under OR, which becomes a
left-outer existence join and a flag (q10, q35, q45). Each is held to its
golden, to the JAX reference's results and plans, and to `chip_smoke.py`'s
SF10 plans exactly as `tests/test_torch_tpcds_store.py` holds the
store-channel queries; those whose golden has no rows at scale 0.1 also
run with relaxed literals (`TPCDS_VARIANTS` of
`tests/test_torch_cuda.py`)."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.test_torch_cuda import TPCDS_VARIANTS  # noqa: E402
from tests.test_torch_tpcds_store import (  # noqa: E402,F401
    Sf10Planner, TpcdsPair, check_golden, check_plans, check_reference,
    check_whole, one_torch_thread,
)

QUERIES = ("q10", "q33", "q35", "q45", "q56", "q58", "q60", "q69", "q83")


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
