"""TPC-DS queries of the fifth SQL slice that need one construct each
beyond the earlier slices, or none: stddev_samp over sum/sumsq/count
buffers (q17 q39a q39b), LIKE over a dictionary (q91), concat over two
string columns through a host UDF and PythonEvalExec (q84), and q6, q41
and q54, which the earlier slices already ran. Each is held to its
golden, to the JAX reference's result and plans, and to `chip_smoke.py`'s
SF10 plans exactly as `tests/test_torch_tpcds_store.py` holds the
store-channel queries; those whose goldens are empty at scale 0.1 also
run with the literals of `TPCDS_VARIANTS` (`tests/test_torch_cuda.py`),
which select rows."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.test_torch_cuda import TPCDS_VARIANTS  # noqa: E402
from tests.test_torch_tpcds_store import (  # noqa: E402,F401
    Sf10Planner, TpcdsPair, check_golden, check_plans, check_reference,
    check_variant, check_whole, one_torch_thread,
)

QUERIES = ("q6", "q17", "q39a", "q39b", "q41", "q54", "q84", "q91")
# rows each variant returns at least (q41 keeps the items of one category)
MIN_ROWS = {"q41": 5}


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
    check_variant(pair, f"{name}_variant", MIN_ROWS.get(name, 10))


@pytest.mark.parametrize("name", QUERIES)
def test_whole_matches_reference(pair, monkeypatch, name):
    check_whole(pair.torch, pair.run("jax", name)[1], name, monkeypatch)


@pytest.mark.parametrize("name", QUERIES)
def test_plans_match_reference(pair, name):
    check_plans(pair, name)


@pytest.mark.parametrize("name", QUERIES)
def test_sf10_plans_match_chip_smoke(sf10, name):
    sf10.check(name)
