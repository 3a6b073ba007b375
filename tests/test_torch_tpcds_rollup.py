"""TPC-DS queries of the fourth SQL slice that group by ROLLUP (q5, q18,
q22, q27, q80): each is a Union of per-set aggregates over the same child,
in both engines, with the keys a set leaves out NULL and grouping() folded
per branch (q27), over the three channels' unions (q5, q80) and over
inventory (q22); held to their goldens, to the JAX reference's results and
plans, and to `chip_smoke.py`'s SF10 plans exactly as
`tests/test_torch_tpcds_store.py` holds the store-channel queries."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.test_torch_tpcds_store import (  # noqa: E402,F401
    Sf10Planner, TpcdsPair, check_golden, check_plans, check_reference,
    check_whole, one_torch_thread,
)

QUERIES = ("q5", "q18", "q22", "q27", "q80")


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


@pytest.mark.parametrize("name", QUERIES)
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
