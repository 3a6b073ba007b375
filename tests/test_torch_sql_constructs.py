"""The SQL constructs of the port's second and third SQL slices against
the JAX reference: IN and NOT IN lists (three-valued, with NULL probes and
NULL items, strings by value hash), BETWEEN, searched and simple CASE
(with and without ELSE, one branch dividing by zero off its mask), if,
coalesce, round at .5 ties on decimals and doubles, CTEs (inlined once,
materialised when read twice over a join and an aggregate, one reading
another, one named like a temp view, one read inside a subquery), FROM
subqueries with an aggregate; doubles scaled by literals (bit for bit:
the reference's compiler folds the constant factors); UNION and UNION ALL
over mixed types and string literals, nested, with a filter pushed
through, and SELECT DISTINCT; IN and EXISTS subqueries, correlated and
not, under OR, NOT EXISTS, scalar subqueries (one returning no row is
NULL); concat and upper; and the fifth slice's INTERSECT, EXCEPT, LIKE,
count(DISTINCT), the central moments, nested-loop joins and host UDFs
(concat over two columns, casts to string). Each statement runs over small
numpy-seeded temp
views through TpuSession (operator tier, fusion off) and
TorchSession(device="cpu"): the analysed and optimised plans print the
same trees (ids renumbered), the physical plans hold the same operator
sequence, and the Arrow results are equal exactly. The DataFrame forms
(`isin`, `between`, `when`/`otherwise`, `coalesce`, `round`) equal their
SQL form. Where the reference is wrong or refuses (a scalar subquery of
two rows, a narrowing decimal cast past its precision, upper merging two
values), the port is held to plain oracles; concat_ws over an array raises."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu_torch.api.functions as F  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from spark_tpu_torch.errors import NotPortedError  # noqa: E402
from spark_tpu_torch.errors import UnsupportedOperationError  # noqa: E402
from tests.test_torch_cuda import SQL_CONSTRUCTS as CASES  # noqa: E402
from tests.test_torch_cuda import construct_rows as _rows  # noqa: E402
from tests.test_torch_cuda import construct_tables  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401
from tests.test_torch_tpcds_slice import _ops  # noqa: E402
from tests.test_torch_tpcds_store import renumber  # noqa: E402

# the port side pinned to the operator tier, as the reference side is:
# these tests hold operator-at-a-time execution (tests/test_torch_fusion.py
# holds the stage tier)
CONF = {"spark.sql.shuffle.partitions": 4,
        "spark.tpu.batch.capacity": 1 << 10,
        "spark.sql.autoBroadcastJoinThreshold": 1024,
        "spark.tpu.compile.tier": "operator"}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator"})


@pytest.fixture(scope="module")
def sessions():
    j = TpuSession("constructs-reference", dict(JAX_CONF))
    t = TorchSession("constructs", dict(CONF), device="cpu")
    for name, tb in construct_tables().items():
        j.createDataFrame(tb).createOrReplaceTempView(name)
        t.createDataFrame(tb).createOrReplaceTempView(name)
    yield j, t
    j.stop()
    t.stop()


@pytest.mark.parametrize("name", list(CASES))
def test_construct_matches_reference(sessions, name):
    j, t = sessions
    text, ordered = CASES[name]
    jd, td = j.sql(text), t.sql(text)
    for phase in ("analyzed", "optimized"):
        want = getattr(jd.query_execution, phase).tree_string()
        got = getattr(td.query_execution, phase).tree_string()
        assert renumber(got) == renumber(want), phase
    assert _ops(td) == _ops(jd)
    want, got = jd.toArrow(), td.toArrow()
    assert got.schema == want.schema
    assert _rows(got, ordered) == _rows(want, ordered)


def test_in_is_three_valued(sessions):
    _, t = sessions
    rows = t.sql("SELECT n, n IN (1, NULL) AS a, n NOT IN (1, 2) AS b, "
                 "n IN (1, 2) AS c FROM t").toArrow().to_pylist()
    for r in rows:
        n = r["n"]
        if n is None:
            assert (r["a"], r["b"], r["c"]) == (None, None, None)
        else:
            assert r["a"] is (True if n == 1 else None)
            assert r["b"] is (n not in (1, 2))
            assert r["c"] is (n in (1, 2))


def test_cte_read_twice_runs_once(sessions):
    _, t = sessions
    text = CASES["cte_materialised"][0]
    before = t.metrics.get("cte.materialized", 0)
    df = t.sql(text)
    assert t.metrics.get("cte.materialized", 0) == before + 1
    df.toArrow()
    df.toArrow()
    assert t.metrics.get("cte.materialized", 0) == before + 1
    # read once: inlined, nothing materialised
    t.sql(CASES["cte_inlined"][0]).toArrow()
    assert t.metrics.get("cte.materialized", 0) == before + 1


def test_string_in_needs_literals(sessions):
    _, t = sessions
    with pytest.raises(UnsupportedOperationError) as err:
        t.sql("SELECT k FROM t WHERE s IN ('a', s)").toArrow()
    assert "literals" in str(err.value)


def test_dataframe_forms_match_sql(sessions):
    _, t = sessions
    df = (t.table("t")
          .filter(F.col("n").isin(1, 2, 3) & F.col("d").between(-50, 50))
          .select("k",
                  F.when(F.col("z") > 0, F.col("n") / F.col("z"))
                  .when(F.col("z") == 0, F.lit(-1.0))
                  .otherwise(None).alias("q"),
                  F.coalesce("n", F.lit(0)).alias("c"),
                  F.round("v", 2).alias("r"),
                  F.round(F.col("d"), 1).alias("rd")))
    sql = t.sql("SELECT k, CASE WHEN z > 0 THEN n / z WHEN z = 0 THEN -1.0 "
                "ELSE NULL END AS q, coalesce(n, 0) AS c, round(v, 2) AS r, "
                "round(d, 1) AS rd FROM t "
                "WHERE n IN (1, 2, 3) AND d BETWEEN -50 AND 50")
    want, got = sql.toArrow(), df.toArrow()
    assert want.num_rows > 100
    assert got.schema == want.schema
    assert _rows(got, False) == _rows(want, False)


def test_scalar_subquery_of_two_rows_raises(sessions):
    from spark_tpu_torch.errors import ExecutionError

    _, t = sessions
    with pytest.raises(ExecutionError) as err:
        t.sql("SELECT k, (SELECT k2 FROM t2 WHERE k2 < 6) AS m FROM t") \
            .toArrow()
    assert "more than one row" in str(err.value)


def test_narrowing_decimal_cast_overflows_to_null(sessions):
    # Spark's non-ANSI cast: a value past the target precision is NULL
    # (the reference emits it past the precision: ROADMAP.md section C)
    import decimal

    _, t = sessions
    rows = t.sql("SELECT d, v, CAST(d AS DECIMAL(3,1)) AS a, "
                 "CAST(d AS DECIMAL(2,0)) AS b, CAST(v * 3 AS DECIMAL(2,1)) "
                 "AS c, CAST(-99.96 AS DECIMAL(3,1)) AS e, "
                 "CAST(-9.96 AS DECIMAL(3,1)) AS f, CAST(k AS DECIMAL(5,2)) "
                 "AS g, CAST(n * 30 AS DECIMAL(2,0)) AS h, "
                 "CAST(1000 AS DECIMAL(3,0)) AS i, "
                 "CAST(999 AS DECIMAL(3,0)) AS j, k, n FROM t") \
        .toArrow().to_pylist()

    def fit(x, p, s):
        if x is None:
            return None
        q = x.quantize(decimal.Decimal(1).scaleb(-s),
                       rounding=decimal.ROUND_HALF_UP)
        return None if abs(q.scaleb(s)) >= 10 ** p else q

    nulls = ints = 0
    for r in rows:
        assert r["a"] == fit(r["d"], 3, 1)
        assert r["b"] == fit(r["d"], 2, 0)
        # doubles round half to even, as the reference's rint
        c = round(r["v"] * 3 * 10)
        assert r["c"] == (None if abs(c) >= 100
                          else decimal.Decimal(c).scaleb(-1))
        assert r["e"] is None and r["f"] == decimal.Decimal("-10.0")
        # integers: an int is decimal(10,0), so the same narrowing cast
        assert r["g"] == fit(decimal.Decimal(r["k"]), 5, 2)
        assert r["h"] == (None if r["n"] is None
                          else fit(decimal.Decimal(r["n"] * 30), 2, 0))
        assert r["i"] is None and r["j"] == decimal.Decimal(999)
        nulls += (r["a"] is None and r["d"] is not None) + (r["c"] is None)
        ints += (r["g"] is None) + (r["h"] is None and r["n"] is not None)
    assert nulls > 100 and ints > 100


def test_upper_merges_groups_by_value(sessions):
    # 'ab' and 'AB' are one value after upper: one group, one sort rank
    # (the reference splits the group: ROADMAP.md section C)
    import pyarrow as pa

    _, t = sessions
    words = ["ab", "AB", "Ab", "x", None, "X", "é", "É"]
    tb = pa.table({"s": [words[i % len(words)] for i in range(800)],
                   "k": list(range(800))})
    t.createDataFrame(tb).createOrReplaceTempView("cased")
    got = t.sql("SELECT upper(s) AS u, count(*) AS n, sum(k) AS sk "
                "FROM cased GROUP BY upper(s) ORDER BY u").toArrow()
    want: dict = {}
    for s, k in zip(tb.column("s").to_pylist(), tb.column("k").to_pylist()):
        key = None if s is None else s.upper()
        n, sk = want.get(key, (0, 0))
        want[key] = (n + 1, sk + k)
    assert [(r["u"], r["n"], r["sk"]) for r in got.to_pylist()] == \
        [(u, *want[u]) for u in [None, "AB", "X", "É"]]


def test_concat_of_two_columns_raises(sessions):
    # concat over two columns runs since the fifth SQL slice, as a host UDF
    # (SQL_CONSTRUCTS "concat_columns"), and concat_ws over them since the
    # scalar-function slice; a concat over an array still raises (the
    # reference fails there too)
    _, t = sessions
    with pytest.raises(NotPortedError) as err:
        t.sql("SELECT concat_ws('-', array(s, s)) FROM t").toArrow()
    assert "array<string>" in err.value.what
