"""VALUES and JOIN ... USING in the port's SQL (sql/parser.py's
parse_values and UsingJoin, plan/analyzer.py's ResolveUsingJoin) against
the JAX reference: each statement's analysed and optimised plans print
the same trees (expression ids renumbered) and its result is equal,
exactly and in order; a statement the reference refuses raises the same
error class in the port. As in the reference, the right side's USING
column is not kept as a hidden attribute."""

import numpy as np
import pyarrow as pa
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.test_torch_commands import error_of, pair  # noqa: E402,F401
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401
from tests.test_torch_tpcds_slice import _renumber  # noqa: E402

STATEMENTS = {
    "values_query": "VALUES (1, 'a'), (2, 'b'), (3, NULL)",
    "values_types": "VALUES (1, 2.5, DATE '2020-01-01', true, -7L)",
    "values_in_from": "SELECT col1 + 1 AS x, col2 FROM (VALUES (1, 'a'), "
                      "(2, 'b')) ORDER BY x DESC",
    "values_alias": "SELECT v.col1 FROM (VALUES (4), (5)) AS v "
                    "WHERE v.col1 > 4",
    "values_union": "SELECT k FROM ua WHERE k < 2 UNION ALL VALUES (100) "
                    "ORDER BY k",
    "values_join": "SELECT ua.k, v.col2 FROM ua JOIN (VALUES (1, 'one'), "
                   "(2, 'two')) v ON ua.k = v.col1 ORDER BY ua.k, v.col2",
    "values_null_first": "VALUES (NULL), (1)",
    "values_expression": "VALUES (1 + 2, -(3), 2 * 4 - 1)",
    "values_function": "VALUES (upper('x'))",
    "values_not_literal": "VALUES (1), (ua.k)",
    "using_inner": "SELECT * FROM ua JOIN ub USING (k) ORDER BY k, a, b",
    "using_left": "SELECT * FROM ua LEFT JOIN ub USING (k) "
                  "ORDER BY k, a, b",
    "using_right": "SELECT * FROM ua RIGHT OUTER JOIN ub USING (k) "
                   "ORDER BY k, a, b",
    "using_full": "SELECT * FROM ua FULL JOIN ub USING (k) "
                  "ORDER BY k, a, b",
    "using_semi": "SELECT * FROM ua LEFT SEMI JOIN ub USING (k) "
                  "ORDER BY k, a",
    "using_anti": "SELECT * FROM ua LEFT ANTI JOIN ub USING (k) "
                  "ORDER BY k, a",
    "using_two_keys": "SELECT * FROM ua JOIN uc USING (k, g) "
                      "ORDER BY k, g, a, c",
    "using_case": "SELECT K FROM ua JOIN ub USING (K) ORDER BY K",
    "using_qualified_left": "SELECT ua.k, a FROM ua JOIN ub USING (k) "
                            "ORDER BY ua.k, a",
    "using_hidden_right": "SELECT ub.k FROM ua JOIN ub USING (k)",
    "using_aggregate": "SELECT k, count(*) AS n, sum(b) AS s FROM ua "
                       "FULL JOIN ub USING (k) GROUP BY k ORDER BY k",
    "using_chain": "SELECT k, a, b, c FROM ua JOIN ub USING (k) "
                   "JOIN uc USING (k) ORDER BY k, a, b, c",
    "using_self": "SELECT k, ua.a, x.a AS xa FROM ua JOIN ua x USING (k) "
                  "ORDER BY k, ua.a, xa",
    "using_subquery": "SELECT * FROM (SELECT k, a FROM ua WHERE a > 0) q "
                      "JOIN ub USING (k) ORDER BY k, a, b",
    "using_missing": "SELECT * FROM ua JOIN ub USING (nope)",
    "using_ambiguous": "SELECT * FROM (SELECT ua.k, x.k FROM ua JOIN ua x "
                       "ON ua.a = x.a) p JOIN ub USING (k)",
    "using_values": "SELECT * FROM ua JOIN (SELECT col1 AS k FROM "
                    "(VALUES (1), (3))) v USING (k) ORDER BY k, a",
}


@pytest.fixture(scope="module")
def views(pair):
    rng = np.random.default_rng(11)
    tables = {
        "ua": pa.table({"k": pa.array([0, 1, 1, 2, 3, None, 5], pa.int64()),
                        "a": rng.integers(-5, 5, 7),
                        "g": pa.array(["x", "y", "x", "y", "x", "y", None])}),
        "ub": pa.table({"k": pa.array([1, 2, 2, 4, None], pa.int64()),
                        "b": rng.integers(0, 9, 5)}),
        "uc": pa.table({"k": pa.array([1, 1, 3, 5], pa.int64()),
                        "g": ["x", "y", "x", "y"],
                        "c": [1.5, 2.5, 3.5, 4.5]}),
    }
    for _, s, _ in pair.engines():
        for name, tb in tables.items():
            s.createDataFrame(tb).createOrReplaceTempView(name)
    return pair


def _observe(s, text):
    try:
        df = s.sql(text)
        qe = df.query_execution
        return (_renumber(qe.analyzed.tree_string()),
                _renumber(qe.optimized.tree_string()),
                df.toArrow().schema.names, df.toArrow().to_pylist())
    except Exception as e:  # noqa: BLE001 - the class is compared
        return error_of(e)


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_matches_reference(views, name):
    text = STATEMENTS[name]
    want = _observe(views.jax, text)
    got = _observe(views.torch, text)
    assert got == want
    if name in ("using_missing", "using_ambiguous", "using_hidden_right",
                "values_not_literal", "values_function"):
        assert got[0] == "raises", got
    else:
        assert got[0] != "raises", got
