"""The DataFrame, GroupedData and session methods of the port beyond the
gate (api/dataframe.py, api/na.py, api/stat.py, api/session.py,
api/functions.py) against the JAX reference: the cases of
tests/test_dataframe.py, tests/test_na_pivot.py and tests/test_stats.py
that fall in this slice, each run on both engines by
tests/test_torch_commands.py's `both`, which holds what each case
observes equal: result rows (ordered where the case sorts), the text that
`show`, `printSchema` and `describe` print, and error classes. Float
aggregates of `describe` print the same digits."""

import contextlib
import io

import numpy as np
import pyarrow as pa
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from tests.test_torch_commands import (  # noqa: E402,F401
    CONF, JAX_CONF, both, pair,
)
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401


def _people(o):
    df = o.s.createDataFrame(pa.table({
        "name": ["alice", "bob", "carol", "dave", "eve", None],
        "age": [25, 32, 25, None, 41, 25],
        "dept": ["eng", "sales", "eng", "eng", "hr", "sales"],
        "salary": [100.0, 80.5, 120.0, 95.0, None, 70.0],
    }))
    df.createOrReplaceTempView("people")
    return df


def _nadf(o):
    return o.s.createDataFrame(pa.table({
        "a": pa.array([1, None, 3], pa.int64()),
        "b": pa.array([None, 2.5, 3.5], pa.float64()),
        "s": pa.array(["x", None, "z"]),
    }))


def rows(df):
    return df.toArrow().to_pylist()


def printed(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def case_filter_string_condition(o):
    p = _people(o)
    o.keep(rows(p.filter("age = 25 AND dept = 'eng'").select("name")
                .orderBy("name")))
    o.keep(rows(p.where("salary > 90 OR name IS NULL").orderBy("salary")))
    o.raises(lambda: rows(p.filter("no_col > 1")))


def case_select_expr(o):
    p = _people(o)
    o.keep(rows(p.selectExpr("name", "age * 2 AS a2",
                             "upper(dept) d").orderBy("name")))
    o.keep(rows(p.selectExpr("sum(salary) AS s", "count(*) AS n")))
    o.keep(rows(p.select(o.F.expr("coalesce(age, 0) + 1").alias("e"),
                         o.F.column("dept")).orderBy("e", "dept")))


def case_distinct_and_drop_duplicates(o):
    df = o.s.createDataFrame(pa.table({"a": [1, 1, 2, None, None],
                                       "b": [9, 9, 8, 7, 7]}))
    o.keep(df.dropDuplicates().count())
    o.keep(rows(df.distinct().orderBy("a", "b")))
    o.keep(rows(df.dropDuplicates(["a"]).orderBy("a")))
    o.keep(rows(df.dropDuplicates(["a", "b"]).orderBy("a", "b")))
    o.keep(df.dropDuplicates(["b"]).count())


def case_union(o):
    a = o.s.createDataFrame(pa.table({"x": [1, 2], "y": ["p", "q"]}))
    b = o.s.createDataFrame(pa.table({"x": [3], "y": ["r"]}))
    o.keep(rows(a.union(b).orderBy("x")))
    o.keep(rows(a.unionAll(a).orderBy("x")))
    # positional, as the reference's (which has no unionByName)
    c = o.s.createDataFrame(pa.table({"y": ["s"], "x": [4]}))
    o.attempt(lambda: rows(a.union(c)))


def case_drop_rename_alias(o):
    p = _people(o)
    o.keep(p.withColumnRenamed("age", "renamed").columns)
    o.keep(p.drop("age", "salary").columns)
    o.keep(p.drop("nope").columns)
    a, b = p.alias("a"), p.alias("b")
    o.keep(rows(a.join(b, o.F.col("a.name") == o.F.col("b.name"))
                .select(o.F.col("a.name").alias("n"),
                        o.F.col("b.age").alias("ba")).orderBy("n")))


def case_actions(o):
    p = _people(o).orderBy("name")
    o.keep(p.first())
    o.keep(p.head())
    o.keep(p.head(2))
    o.keep(p.take(3))
    o.keep((p.isEmpty(), p.filter("age > 100").isEmpty()))
    o.keep(p.filter("age > 100").first())


def case_schema(o):
    p = _people(o).withColumn("d", o.F.lit(1.5)).selectExpr(
        "*", "CAST(age AS DECIMAL(9, 2)) AS dec", "DATE '2020-01-01' AS dt")
    o.keep(p.dtypes)
    o.keep([(f.name, f.dataType.simple_string(), f.nullable)
            for f in p.schema])
    o.keep(printed(p.printSchema))


def case_show(o):
    p = _people(o).orderBy("name")
    o.keep(printed(lambda: p.show(3)))
    o.keep(printed(lambda: p.show()))
    long = o.s.createDataFrame(pa.table({"s": ["x" * 30, None]}))
    o.keep(printed(lambda: long.show(truncate=True)))
    o.keep(printed(lambda: long.show(truncate=False)))
    o.keep(printed(lambda: p.filter("age > 100").show()))


def case_describe(o):
    p = _people(o)
    o.keep(rows(p.describe()))
    o.keep(rows(p.describe("age")))
    o.keep(rows(p.summary("salary")))
    o.keep(rows(p.describe("name")))


def case_grouped_shorthand(o):
    p = _people(o)
    for fn in ("sum", "avg", "mean", "min", "max"):
        o.keep(rows(getattr(p.groupBy("dept"), fn)("age", "salary")
                    .orderBy("dept")))
    o.keep(rows(p.groupby("dept").count().orderBy("dept")))


def case_stddev_variance(o):
    df = o.s.createDataFrame(pa.table({
        "g": [1, 1, 1, 2, 2, 2, 2, 2],
        "v": [2.0, 4.0, 4.0, 4.0, 5.0, 5.0, 7.0, 9.0]}))
    F = o.F
    o.keep(rows(df.groupBy("g").agg(
        F.stddev("v").alias("sd"), F.stddev_samp("v").alias("sds"),
        F.stddev_pop("v").alias("sdp"), F.variance("v").alias("va"),
        F.var_samp("v").alias("vs"), F.var_pop("v").alias("vp"))
        .orderBy("g")))


def case_na_drop(o):
    n = _nadf(o)
    o.keep(n.na.drop().count())
    o.keep(n.na.drop(how="all").count())
    o.keep(n.na.drop(subset=["a"]).count())
    o.keep(n.dropna(subset=["a", "b"]).count())


def case_na_fill(o):
    n = _nadf(o)
    o.keep(rows(n.na.fill(0)))
    o.keep(rows(n.na.fill({"s": "missing"})))
    o.keep(rows(n.fillna(1.5, subset=["b"])))
    o.keep(rows(n.na.fill("q")))


def case_na_replace(o):
    n = _nadf(o)
    o.keep(rows(n.na.replace(1, 100, subset=["a"])))
    o.keep(rows(n.na.replace({"x": "X"})))
    o.keep(rows(n.replace(3.5, 0.0)))


def case_pivot(o):
    df = o.s.createDataFrame(pa.table({
        "year": [2020, 2020, 2021, 2021, 2021],
        "quarter": ["q1", "q2", "q1", "q1", "q2"],
        "rev": [10, 20, 30, 40, 50],
    }))
    F = o.F
    o.keep(rows(df.groupBy("year").pivot("quarter").agg(F.sum("rev"))
                .orderBy("year")))
    o.keep(rows(df.groupBy("year").pivot("quarter", ["q2"])
                .agg(F.sum("rev").alias("s"), F.max("rev").alias("m"))
                .orderBy("year")))
    o.keep(rows(df.groupBy("quarter").pivot("year").agg(F.count("*"))
                .orderBy("quarter")))


def case_pivot_explicit_values_and_count(o):
    df = o.s.createDataFrame(pa.table({
        "g": ["a", "a", "b"], "p": ["x", "y", "x"], "v": [1, 2, 3]}))
    o.keep(rows(df.groupBy("g").pivot("p", ["x"])
                .agg(o.F.count("*").alias("n")).orderBy("g")))


def case_unpivot(o):
    df = o.s.createDataFrame(pa.table({
        "id": [1, 2], "m1": [10, 20], "m2": [30, 40]}))
    o.keep(rows(df.unpivot("id", ["m1", "m2"]).orderBy("id", "variable")))
    o.keep(rows(df.melt(["id"], "m2", "var", "val").orderBy("id")))


def case_stat(o):
    rng = np.random.default_rng(3)
    df = o.s.createDataFrame(pa.table({
        "x": rng.integers(0, 50, 400).astype(np.float64),
        "k": rng.integers(0, 4, 400), "c": rng.integers(0, 3, 400)}))
    o.keep(df.stat.approxQuantile("x", [0.0, 0.25, 0.5, 0.9, 1.0], 0.0))
    o.keep(df.stat.approxQuantile(["x", "k"], [0.5], 0.01))
    got = df.stat.freqItems(["k", "c"], 0.3)
    o.keep({k: sorted(v) for k, v in got.items()})
    o.keep(rows(df.stat.crosstab("k", "c")))


def case_create_data_frame(o):
    from importlib import import_module

    types = import_module(type(o.s).__module__.split(".")[0] + ".types")
    schema = types.StructType([
        types.StructField("i", types.int64, True),
        types.StructField("s", types.string, True)])
    o.keep(rows(o.s.createDataFrame([(1, "a"), (2, None)], schema)))
    o.keep(rows(o.s.createDataFrame([(1, "a"), (2, "b")], ["i", "s"])))
    o.keep(rows(o.s.createDataFrame([{"i": 1, "s": "a"},
                                     {"i": 2, "s": None}])))
    o.keep(rows(o.s.createDataFrame({"i": [3, 4]})))
    o.raises(lambda: o.s.createDataFrame([(1, "a")]))
    o.raises(lambda: o.s.createDataFrame([]))


def case_session_surface(o):
    _people(o)
    o.keep(rows(o.s.table("people").filter("age > 30").orderBy("name")))
    o.keep(o.s.version())
    o.raises(lambda: rows(o.s.table("no_such_table")))


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dataframe_method_matches_reference(pair, name):
    both(pair, CASES[name])


def test_create_data_frame_from_pandas(pair):
    pd = pytest.importorskip("pandas")
    frame = pd.DataFrame({"a": [1, 2, 3], "b": ["x", None, "z"]})

    def case(o):
        df = o.s.createDataFrame(frame)
        o.keep(rows(df))
        o.keep(df.toPandas().to_dict("list"))

    both(pair, case)


def test_builder_and_new_session(tmp_path):
    """builder.getOrCreate returns the active session with its conf set;
    newSession shares the warehouse and keeps its own conf and views."""
    seen = {}
    wh = {"spark.sql.warehouse.dir": str(tmp_path / "wh")}
    for name, cls, conf in (("jax", TpuSession, JAX_CONF),
                            ("torch", TorchSession, CONF)):
        kw = {"device": "cpu"} if name == "torch" else {}
        base = cls("b", dict(conf, **wh), **kw)
        try:
            got = cls.builder.appName("x").master("local[3]") \
                .config("spark.sql.shuffle.partitions", 5).getOrCreate()
            assert got is base
            out = [got.conf.get("spark.sql.shuffle.partitions"),
                   got.conf.get("spark.default.parallelism")]
            base.sql("CREATE TABLE nt AS SELECT 1 AS x")
            base.createDataFrame(pa.table({"v": [1]})) \
                .createOrReplaceTempView("base_only")
            child = base.newSession()
            child.sql("SET spark.sql.shuffle.partitions = 2")
            out.append(base.conf.get("spark.sql.shuffle.partitions"))
            out.append(child.sql("SELECT x FROM nt").toArrow().to_pylist())
            child.sql("INSERT INTO nt VALUES (2)")
            out.append(base.sql("SELECT x FROM nt ORDER BY x").toArrow()
                       .to_pylist())
            seen[name] = out
            if name == "torch":
                with pytest.raises(Exception):
                    child.sql("SELECT * FROM base_only").toArrow()
                assert child.device == base.device
        finally:
            base.stop()
    assert seen["torch"] == seen["jax"]
