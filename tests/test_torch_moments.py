"""stddev_samp, stddev_pop, var_samp and var_pop in the port against the
JAX package, through each aggregate path of HashAggregateExec: the
sorted-segment kernel (a key whose range is too wide for a dense table),
the dense-range scatter (a narrow integral key) and the ungrouped reduce,
over seeded int64, double and decimal columns whose groups hold 0 (all
NULL), 1, 2 and many values. Both engines lower a moment to sum, sumsq
and count buffers and finish it as (sumsq - sum^2/n) / (n - ddof), NULL
where n <= ddof; values compare to relative 1e-12 (the port adds in
index_add_ order, the reference in sorted-segment order), NULLs exactly.
The decimal column's moments are held to a plain oracle over its values:
the reference squares the scaled integers."""

import decimal
import math

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402

# the port side pinned to the operator tier, as the reference side is:
# these tests hold operator-at-a-time execution (tests/test_torch_fusion.py
# holds the stage tier)
CONF = {"spark.sql.shuffle.partitions": 3, "spark.tpu.batch.capacity": 1 << 9,
        "spark.tpu.compile.tier": "operator"}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator"})
MOMENTS = ("stddev_samp", "stddev_pop", "var_samp", "var_pop")
RTOL = 1e-12


def _table():
    # group g holds g % 4 values for g < 40 (0: its rows all NULL), and
    # many past it
    rng = np.random.default_rng(31)
    g = np.concatenate([np.repeat(np.arange(40), 3),
                        rng.integers(40, 60, 1200)])
    n = len(g)
    nth = np.zeros(n, np.int64)
    for key in range(40):
        nth[g == key] = np.arange(3)
    live = (g >= 40) | (nth < g % 4)
    null = ~live | ((g >= 40) & (rng.random(n) < 0.1))
    x = rng.integers(-500, 500, n)
    y = rng.standard_normal(n) * 1e3
    d = rng.integers(-99999, 99999, n)
    return pa.table({
        "g": g, "wide": g * 1_000_000_007,
        "x": pa.array(x, pa.int64(), mask=null),
        "y": pa.array(y, pa.float64(), mask=null),
        "d": pa.array([decimal.Decimal(int(v)).scaleb(-2) for v in d],
                      pa.decimal128(7, 2), mask=null)})


@pytest.fixture(scope="module")
def sessions():
    j = TpuSession("moments-reference", dict(JAX_CONF))
    t = TorchSession("moments", dict(CONF), device="cpu")
    tb = _table()
    for s in (j, t):
        s.createDataFrame(tb).createOrReplaceTempView("m")
    yield j, t
    j.stop()
    t.stop()


def _close(got, want):
    if want is None or got is None:
        return got is None and want is None
    return math.isclose(got, want, rel_tol=RTOL, abs_tol=1e-300)


# path -> (GROUP BY clause, the launch kind it takes)
PATHS = {"sorted_segment": ("GROUP BY wide", "gagg"),
         "dense": ("GROUP BY g", "dagg"),
         "global": ("", "uagg")}


def _oracle(column: str, key: str) -> pa.Table:
    """The moments of a decimal column's values per key, exact (rational)
    until the last rounding: (sumsq - sum^2/n) / (n - ddof)."""
    from fractions import Fraction

    tb = _table()
    keys = tb.column(key).to_pylist() if key != "0" else [0] * tb.num_rows
    groups: dict = {}
    for k, v in zip(keys, tb.column(column).to_pylist()):
        groups.setdefault(k, [])
        if v is not None:
            groups[k].append(Fraction(v))
    rows = []
    for k, xs in groups.items():
        n = len(xs)
        s, q = sum(xs), sum(x * x for x in xs)
        var = {d: float((q - s * s / n) / (n - d)) if n > d else None
               for d in (0, 1)}
        sd = {d: None if v is None else math.sqrt(v)
              for d, v in var.items()}
        rows.append({"key": k, "n": n, "stddev_samp": sd[1],
                     "stddev_pop": sd[0], "var_samp": var[1],
                     "var_pop": var[0]})
    return pa.Table.from_pylist(rows)


@pytest.mark.parametrize("column", ["x", "y", "d"])
@pytest.mark.parametrize("path", list(PATHS))
def test_moments_match_reference(sessions, path, column):
    # the decimal column is held to a plain oracle: the reference squares
    # its scaled integers (ROADMAP.md section C)
    j, t = sessions
    clause, kind = PATHS[path]
    key = clause.split()[-1] if clause else "0"
    text = (f"SELECT {key} AS key, count({column}) AS n, "
            + ", ".join(f"{m}({column}) AS {m}" for m in MOMENTS)
            + f" FROM m {clause}")
    want = _oracle(column, key) if column == "d" else j.sql(text).toArrow()
    before = t.launches.snapshot().get(kind, 0)
    got = t.sql(text).toArrow()
    assert t.launches.snapshot().get(kind, 0) > before
    if column != "d":
        assert got.schema == want.schema
    key_rows = lambda tb: sorted(tb.to_pylist(), key=lambda r: r["key"])  # noqa
    w, g = key_rows(want), key_rows(got)
    assert len(g) == len(w)
    ns = set()
    for a, b in zip(g, w):
        assert a["key"] == b["key"] and a["n"] == b["n"]
        ns.add(b["n"])
        for m in MOMENTS:
            assert _close(a[m], b[m]), (m, a, b)
        # NULL exactly where n <= ddof
        assert (b["stddev_samp"] is None) == (b["n"] <= 1)
        assert (b["var_pop"] is None) == (b["n"] == 0)
    if path != "global":
        assert {0, 1, 2} <= ns


def test_sqrt_is_correctly_rounded():
    # torch's vectorised CPU sqrt misrounds some doubles, CUDA's does not:
    # the port's Sqrt rounds correctly on the CPU, so a standard deviation
    # is the same on both devices to the last bit
    from spark_tpu_torch.expr.eval import EvalCtx, Val
    from spark_tpu_torch.expr.expressions import AttributeReference, Sqrt
    from spark_tpu_torch.types import float64

    rng = np.random.default_rng(3)
    x = rng.random(100_000) * 1e6
    want = np.array([math.sqrt(v) for v in x])
    a = AttributeReference("x", float64)
    ctx = EvalCtx({a.expr_id: Val(float64, torch.from_numpy(x))}, len(x),
                  torch.device("cpu"))
    got = Sqrt(a).eval(ctx).data.numpy()
    assert (got == want).all()
