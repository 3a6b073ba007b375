"""spark_tpu_torch.expr.expressions against spark_tpu.expr.expressions:
the same expression trees, built from each package's classes, evaluated
through a projection in both engines over the same seeded columns with
extreme values and nulls. Integers, booleans and nulls compare exactly;
floats bit for bit (one division per row, no reordering)."""

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.api.column as JC  # noqa: E402
import spark_tpu.expr.expressions as JE  # noqa: E402
import spark_tpu_torch.api.column as TC  # noqa: E402
import spark_tpu_torch.expr.expressions as TE  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu.types import int64 as j_int64, float64 as j_float64  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from spark_tpu_torch.types import (  # noqa: E402
    float64 as t_float64, int64 as t_int64,
)

N = 3000
I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)


@pytest.fixture(scope="module")
def sessions():
    conf = {"spark.sql.shuffle.partitions": 2,
            "spark.tpu.batch.capacity": 1 << 11}
    j = TpuSession("torch-expr-reference", dict(
        conf, **{"spark.tpu.fusion.enabled": "false",
                 "spark.tpu.compile.tier": "operator"}))
    # the port side pinned to the operator tier, as the reference side is
    t = TorchSession("torch-expr", dict(
        conf, **{"spark.tpu.compile.tier": "operator"}), device="cpu")
    yield j, t
    j.stop()
    t.stop()


def _table():
    rng = np.random.default_rng(21)
    edge64 = np.array([I64.max, I64.min, -1, 0, 1, I64.max // 2 + 1,
                       3037000500, -3037000500], np.int64)
    edge32 = np.array([I32.max, I32.min, -1, 0, 1, 46341, -46341, 2],
                      np.int32)
    a = rng.choice(edge64, N)
    b = rng.choice(edge64, N)
    c = rng.choice(edge32, N)
    d = rng.choice(edge32, N)
    x = rng.standard_normal(N)
    x[:4] = [0.0, -0.0, np.inf, np.nan]
    return pa.table({
        "a": pa.array(a, mask=rng.random(N) < 0.1),
        "b": b, "c": c, "d": pa.array(d, mask=rng.random(N) < 0.1),
        "x": x, "f": pa.array(rng.random(N) < 0.5),
    })


def _attr(E, n):
    return E.UnresolvedAttribute([n])


# name -> builder(E, int64, float64) of an expression over a,b,c,d,x,f
EXPRS = {
    "add": lambda E, i64, f64: E.Add(_attr(E, "a"), _attr(E, "b")),
    "sub": lambda E, i64, f64: E.Subtract(_attr(E, "a"), _attr(E, "b")),
    "mul": lambda E, i64, f64: E.Multiply(_attr(E, "a"), _attr(E, "b")),
    "mul32": lambda E, i64, f64: E.Multiply(_attr(E, "c"), _attr(E, "d")),
    "try_add": lambda E, i64, f64: E.TryAdd(_attr(E, "a"), _attr(E, "b")),
    "try_sub": lambda E, i64, f64: E.TrySubtract(_attr(E, "a"),
                                                _attr(E, "b")),
    "try_mul": lambda E, i64, f64: E.TryMultiply(_attr(E, "a"),
                                                _attr(E, "b")),
    "try_mul32": lambda E, i64, f64: E.TryMultiply(_attr(E, "c"),
                                                  _attr(E, "d")),
    "try_add32": lambda E, i64, f64: E.TryAdd(_attr(E, "c"), _attr(E, "d")),
    "div": lambda E, i64, f64: E.Divide(_attr(E, "c"), _attr(E, "d")),
    "div_float": lambda E, i64, f64: E.Divide(_attr(E, "x"), _attr(E, "a")),
    "mixed_widths": lambda E, i64, f64: E.Add(_attr(E, "c"), _attr(E, "a")),
    "cmp_mixed": lambda E, i64, f64: E.LessThan(_attr(E, "c"), _attr(E, "x")),
    "kleene_and": lambda E, i64, f64: E.And(
        E.GreaterThan(_attr(E, "a"), E.Literal(0)), _attr(E, "f")),
    "kleene_or": lambda E, i64, f64: E.Or(
        E.GreaterThan(_attr(E, "d"), E.Literal(0)),
        E.Not(E.EqualTo(_attr(E, "a"), _attr(E, "b")))),
    "is_null": lambda E, i64, f64: E.And(E.IsNull(_attr(E, "a")),
                                         E.IsNotNull(_attr(E, "d"))),
    "cast_float_int": lambda E, i64, f64: E.Cast(_attr(E, "x"), i64),
    "cast_int_float": lambda E, i64, f64: E.Cast(_attr(E, "c"), f64),
    "null_literal": lambda E, i64, f64: E.Add(_attr(E, "c"),
                                              E.Literal(None, i64)),
}


def _eq(x, y):
    if isinstance(y, float) and isinstance(x, float):
        return (np.isnan(x) and np.isnan(y)) or x == y
    return x == y


@pytest.mark.parametrize("name", list(EXPRS))
def test_expression_matches_reference(sessions, name):
    j, t = sessions
    table = _table()
    build = EXPRS[name]
    jdf = j.createDataFrame(table).select(
        JC.Column(JE.Alias(build(JE, j_int64, j_float64), "r")))
    tdf = t.createDataFrame(table).select(
        TC.Column(TE.Alias(build(TE, t_int64, t_float64), "r")))
    jr = jdf.toArrow()
    tr = tdf.toArrow()
    assert str(tr.schema.types[0]) == str(jr.schema.types[0])
    jv, tv = jr.column(0).to_pylist(), tr.column(0).to_pylist()
    assert len(jv) == len(tv) == N
    bad = [(i, a, b) for i, (a, b) in enumerate(zip(tv, jv))
           if not _eq(a, b)]
    assert not bad, bad[:5]
