"""TPC-DS queries of the third SQL slice that combine branches with UNION
[ALL] (q2, q4, q11, q66, q71, q74, q75, q76), and q97, the gate's first
full outer join, held to their goldens, to the JAX reference's results and
plans, and to `chip_smoke.py`'s SF10 plans exactly as
`tests/test_torch_tpcds_store.py` holds the store-channel queries. q75,
whose golden has no rows at scale 0.1, also runs with relaxed literals
(`TPCDS_VARIANTS` of `tests/test_torch_cuda.py`)."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.test_torch_cuda import TPCDS_VARIANTS, same_result  # noqa: E402
from tests.test_torch_tpcds_slice import _chip_smoke  # noqa: E402
from tests.test_torch_tpcds_store import (  # noqa: E402,F401
    Sf10Planner, TpcdsPair, check_golden, check_plans, check_reference,
    check_whole, one_torch_thread,
)

QUERIES = ("q97", "q2", "q4", "q11", "q66", "q71", "q74", "q75", "q76")


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


# q75's variant sums doubles: the port adds in index_add_ order, the
# reference in sorted-segment order, so chip_smoke.py's `same_result`
# holds those columns to relative 1e-12 (ROADMAP.md's rule for float
# aggregates) and the rest exactly. It orders by one integer column with
# ties (37 rows, under its LIMIT): both engines give that column's
# sequence, and the same rows in the order of the other columns.
ORDERED_BY = {"q75_variant": "sales_cnt_diff"}


@pytest.mark.parametrize("name", QUERIES + tuple(
    f"{q}_variant" for q in QUERIES if q in TPCDS_VARIANTS))
def test_query_matches_reference(pair, name):
    if name not in ORDERED_BY:
        check_reference(pair, name)
        return
    order = ORDERED_BY[name]
    _, want = pair.run("jax", name)
    _, got = pair.run("torch", name)
    assert 10 <= want.num_rows < 100
    assert got.column(order).to_pylist() == want.column(order).to_pylist()
    floats = _chip_smoke().FLOAT_SUM_COLUMNS[name.split("_")[0]]

    def rows(table):
        return table.sort_by([(c, "ascending") for c in table.column_names
                              if c not in floats])

    assert same_result(name, rows(got), rows(want))


@pytest.mark.parametrize("name", QUERIES)
def test_whole_matches_reference(pair, monkeypatch, name):
    check_whole(pair.torch, pair.run("jax", name)[1], name, monkeypatch)


@pytest.mark.parametrize("name", QUERIES)
def test_plans_match_reference(pair, name):
    check_plans(pair, name)


@pytest.mark.parametrize("name", QUERIES)
def test_sf10_plans_match_chip_smoke(sf10, name):
    sf10.check(name)
