"""TPC-DS queries of the fifth SQL slice that plan NestedLoopJoinExec:
cross joins of one-row aggregates (q28 q61 q77 q88 q90), the cross join
the count(DISTINCT) rewrite puts between its two aggregates (q16 q94 q95),
and the left semi joins of q16 and q94 on `order_number = order_number AND
warehouse_sk <> warehouse_sk`, which the port enumerates by key. Each is
held to its golden, to the JAX reference's results and plans, and to
`chip_smoke.py`'s SF10 plans exactly as `tests/test_torch_tpcds_store.py`
holds the store-channel queries; the degenerate goldens (a count of 0
with NULL sums, all NULL, mostly zeros) also run with the literals of
`TPCDS_VARIANTS` (`tests/test_torch_cuda.py`), which select rows. The
q16 and q94 variants keep orders shipped from several warehouses and drop
orders shipped from one: the semi join's residual decides both ways."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.test_torch_cuda import TPCDS_VARIANTS, tpcds_query  # noqa: E402
from tests.test_torch_tpcds_store import (  # noqa: E402,F401
    Sf10Planner, TpcdsPair, check_golden, check_plans, check_reference,
    check_variant, check_whole, one_torch_thread,
)

QUERIES = ("q16", "q28", "q61", "q77", "q88", "q90", "q94", "q95")


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


@pytest.mark.parametrize("name", [q for q in QUERIES
                                  if q in TPCDS_VARIANTS])
def test_variant_matches_reference(pair, name):
    # each variant is one row of aggregates
    check_variant(pair, f"{name}_variant", 1)


@pytest.mark.parametrize("name", ["q16", "q94"])
def test_semi_join_residual_keeps_and_drops(pair, name):
    # the variant with EXISTS turned into NOT EXISTS counts the orders the
    # semi join drops (every line from one warehouse); both counts are
    # positive and equal to the reference's
    text = tpcds_query(f"{name}_variant")
    assert text.count("AND EXISTS(SELECT") == 1
    dropped = text.replace("AND EXISTS(SELECT", "AND NOT EXISTS(SELECT")
    want = pair.jax.sql(dropped).toArrow()
    got = pair.torch.sql(dropped).toArrow()
    assert got.to_pylist() == want.to_pylist()
    kept = pair.run("jax", f"{name}_variant")[1]
    assert want.column(0)[0].as_py() > 0
    assert kept.column(0)[0].as_py() > 0


@pytest.mark.parametrize("name", QUERIES)
def test_whole_matches_reference(pair, monkeypatch, name):
    check_whole(pair.torch, pair.run("jax", name)[1], name, monkeypatch)


@pytest.mark.parametrize("name", QUERIES)
def test_plans_match_reference(pair, name):
    check_plans(pair, name)


@pytest.mark.parametrize("name", QUERIES)
def test_sf10_plans_match_chip_smoke(sf10, name):
    sf10.check(name)
