"""TPC-DS queries of the fourth SQL slice that evaluate window functions
(q12 q20 q36 q44 q47 q49 q51 q53 q57 q63 q67 q70 q86 q89 q98): ranks,
running and partition-wide sums and averages (of decimals too) over
aggregates, over ROLLUP unions (q36, q67, q70, q86, whose partitions are
string CASE results) and over two materialised CTE reads (q47, q57), held
to their goldens, to the JAX reference's results and plans, and to
`chip_smoke.py`'s SF10 plans exactly as `tests/test_torch_tpcds_store.py`
holds the store-channel queries. q49, whose golden has no rows at scale
0.1, also runs with relaxed literals (`TPCDS_VARIANTS` of
`tests/test_torch_cuda.py`)."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.test_torch_cuda import TPCDS_VARIANTS  # noqa: E402
from tests.test_torch_tpcds_store import (  # noqa: E402,F401
    Sf10Planner, TpcdsPair, check_golden, check_plans, check_reference,
    check_whole, one_torch_thread,
)

QUERIES = ("q12", "q20", "q36", "q44", "q47", "q49", "q51", "q53", "q57",
           "q63", "q67", "q70", "q86", "q89", "q98")


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


# q49 ends in `ORDER BY 1, 4, 5` over a UNION: the ordinals stay literals
# in both engines (they resolve only over a SELECT list), so the rows come
# in no defined order; its variant's rows are compared as a multiset
UNORDERED = ("q49_variant",)


@pytest.mark.parametrize("name", QUERIES + tuple(
    f"{q}_variant" for q in QUERIES if q in TPCDS_VARIANTS))
def test_query_matches_reference(pair, name):
    if name not in UNORDERED:
        check_reference(pair, name)
        return
    _, want = pair.run("jax", name)
    _, got = pair.run("torch", name)
    assert want.num_rows >= 10
    assert got.schema == want.schema
    keys = [(c, "ascending") for c in want.column_names]
    assert got.sort_by(keys).to_pylist() == want.sort_by(keys).to_pylist()


@pytest.mark.parametrize("name", QUERIES)
def test_whole_matches_reference(pair, monkeypatch, name):
    check_whole(pair.torch, pair.run("jax", name)[1], name, monkeypatch)


@pytest.mark.parametrize("name", QUERIES)
def test_plans_match_reference(pair, name):
    check_plans(pair, name)


@pytest.mark.parametrize("name", QUERIES)
def test_sf10_plans_match_chip_smoke(sf10, name):
    sf10.check(name)
