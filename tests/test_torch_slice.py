"""The port end to end: the same DataFrame queries through TpuSession (the
JAX reference, operator-at-a-time: fusion off, compile tier operator) and
TorchSession(device="cpu"), on the same numpy-seeded Arrow tables, with
2^12-row tiles so every query runs over several tiles. Integers and nulls
compare exactly with row order ignored; floats to relative 1e-12. The
physical plans must hold the same operator sequence."""

import datetime
import math
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as TF  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import NotPortedError, TorchSession  # noqa: E402
from spark_tpu_torch.errors import DeviceUnavailableError  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port side pinned to the operator tier, as the reference side is:
# these tests hold operator-at-a-time execution (tests/test_torch_fusion.py
# holds the stage tier)
CONF = {"spark.sql.shuffle.partitions": 4,
        "spark.tpu.batch.capacity": 1 << 12,
        "spark.tpu.compile.tier": "operator"}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator"})
N = 6000


@pytest.fixture(scope="module")
def sessions():
    j = TpuSession("torch-slice-reference", dict(JAX_CONF))
    t = TorchSession("torch-slice", dict(CONF), device="cpu")
    yield j, t
    j.stop()
    t.stop()


def _table(seed=0, key_hi=500, nulls=False):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, key_hi, N)
    v = rng.integers(0, 1000, N)
    if not nulls:
        return pa.table({"k": k, "v": v})
    return pa.table({
        "k": pa.array(k, mask=rng.random(N) < 0.1),
        "v": pa.array(v, mask=rng.random(N) < 0.15)})


def _main(df, F):
    return (df.filter(F.col("v") > 25).withColumn("v2", F.col("v") * 3)
            .repartition(8).groupBy("k")
            .agg(F.sum("v2"), F.count("*"), F.min("v"), F.max("v"),
                 F.avg("v")))


def _types_table():
    rng = np.random.default_rng(5)
    days = rng.integers(18000, 18040, N).astype("int32")
    return pa.table({
        "d": pa.array(days.astype("datetime64[D]"), pa.date32()),
        "i": pa.array(rng.integers(-50, 50, N), pa.int32()),
        "x": rng.standard_normal(N),
        "f": pa.array(rng.standard_normal(N).astype("float32")),
    })


# name -> (table builder, query builder(df, F))
CASES = {
    "main": (lambda: _table(), _main),
    "nulls": (lambda: _table(1, nulls=True), _main),
    "empty_filter": (lambda: _table(2),
                     lambda df, F: _main(df.filter(F.col("v") > 5000), F)),
    "sparse_keys": (
        lambda: pa.table({
            "k": np.random.default_rng(3).integers(-(2 ** 60), 2 ** 60, N),
            "v": np.random.default_rng(4).integers(0, 1000, N)}),
        _main),
    "two_keys": (
        lambda: _table(6, key_hi=40, nulls=True),
        lambda df, F: (df.withColumn("m", F.col("v") / 100)
                       .groupBy("k", "m")
                       .agg(F.count("v"), F.sum("v"), F.max("v")))),
    "ungrouped": (lambda: _table(7, nulls=True),
                  lambda df, F: df.filter(F.col("v") < 900).agg(
                      F.sum("v"), F.count("*"), F.count("v"), F.min("k"),
                      F.max("k"), F.avg("v"))),
    "hash_repartition": (
        lambda: _table(8),
        lambda df, F: (df.repartition(4, "k").groupBy("k")
                       .agg(F.sum("v"), F.min("v")))),
    "types": (
        _types_table,
        lambda df, F: (df.filter((F.col("x") > -1.0) | F.col("i").isNull())
                       .groupBy("d")
                       .agg(F.sum("x"), F.avg("f"), F.min("i"), F.max("x"),
                            F.count("f")))),
    "float_keys": (
        lambda: pa.table({
            "f": pa.array(np.random.default_rng(10).choice(
                [0.0, -0.0, np.nan, 1.5, -2.25], N), mask=np.arange(N) % 7 == 0),
            "v": np.random.default_rng(12).integers(0, 1000, N)}),
        lambda df, F: df.groupBy("f").agg(F.sum("v"), F.count("*"))),
    "project_only": (
        lambda: _table(9, nulls=True),
        lambda df, F: (df.filter(~(F.col("k") < 10) & F.col("v").isNotNull())
                       .select(F.col("k"), (F.col("v") * 2 + 1).alias("a"),
                               (F.col("v") / (F.col("k") - F.col("k")))
                               .alias("z"),
                               F.col("k").isNull().alias("kn")))),
}


def _rows(table: pa.Table) -> list:
    cols = [c.to_pylist() for c in table.columns]
    rows = list(zip(*cols)) if cols else []

    def one(v):
        if v is None:
            return (2, 0)
        if isinstance(v, float) and math.isnan(v):
            return (1, 0)   # NaN sorts after numbers, before nulls
        return (0, v.toordinal() if isinstance(v, datetime.date) else v)

    def key(r):
        return tuple(one(v) for v in r)

    return sorted(rows, key=key)


def _assert_same(jt: pa.Table, tt: pa.Table):
    assert tt.column_names == jt.column_names
    assert [str(t) for t in tt.schema.types] == \
        [str(t) for t in jt.schema.types]
    jr, tr = _rows(jt), _rows(tt)
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        for x, y in zip(a, b):
            if isinstance(y, float) and x is not None:
                assert math.isclose(x, y, rel_tol=1e-12, abs_tol=1e-9) or \
                    (math.isnan(x) and math.isnan(y)), (a, b)
            else:
                assert x == y, (a, b)


def _both(sessions, name):
    j, t = sessions
    build_table, query = CASES[name]
    table = build_table()
    return (query(j.createDataFrame(table), JF),
            query(t.createDataFrame(table), TF))


@pytest.mark.parametrize("name", list(CASES))
def test_results_match_reference(sessions, name):
    jdf, tdf = _both(sessions, name)
    _assert_same(jdf.toArrow(), tdf.toArrow())


@pytest.mark.parametrize("name", list(CASES))
def test_plan_operator_sequence_matches(sessions, name):
    jdf, tdf = _both(sessions, name)

    def ops(df):
        return [type(n).__name__
                for n in df.query_execution.physical.iter_nodes()]

    assert ops(tdf) == ops(jdf)


def test_main_plan_shape_and_paths(sessions):
    _, t = sessions
    df = _main(t.createDataFrame(_table()), TF)
    plan = df.query_execution.physical.tree_string()
    for part in ("Exchange[UnknownPartitioning(8)]",
                 "Exchange[HashPartitioning(4)]",
                 "HashAggregate[partial]", "HashAggregate[final]"):
        assert part in plan
    before = t.launches.snapshot()
    df.toArrow()
    after = t.launches.snapshot()
    assert after.get("dagg", 0) > before.get("dagg", 0)
    assert after.get("shuffle_rr", 0) > before.get("shuffle_rr", 0)
    assert after.get("shuffle_hash", 0) > before.get("shuffle_hash", 0)


def test_sparse_keys_take_sorted_path(sessions):
    _, t = sessions
    before = t.launches.snapshot().get("gagg", 0)
    _both(sessions, "sparse_keys")[1].toArrow()
    assert t.launches.snapshot().get("gagg", 0) > before


@pytest.mark.parametrize("block_rows", [1 << 10, 1 << 11])
def test_blockwise_fold_matches_reference(block_rows):
    conf = {"spark.sql.shuffle.partitions": 2,
            "spark.tpu.batch.capacity": 1 << 11,
            "spark.tpu.agg.blockRows": block_rows}
    j = TpuSession("torch-slice-fold", dict(
        conf, **{"spark.tpu.fusion.enabled": "false",
                 "spark.tpu.compile.tier": "operator"}))
    # the port side pinned to the operator tier, as the reference side is
    t = TorchSession("torch-slice-fold", dict(
        conf, **{"spark.tpu.compile.tier": "operator"}), device="cpu")
    try:
        table = _table(11, key_hi=3000, nulls=True)
        _assert_same(_main(j.createDataFrame(table), JF).toArrow(),
                     _main(t.createDataFrame(table), TF).toArrow())
        # 2 partitions x (partial + final) without the fold; each
        # multi-tile partition adds a chunk aggregate and a merge
        kinds = t.launches.snapshot()
        assert kinds.get("dagg", 0) + kinds.get("gagg", 0) > 4
    finally:
        j.stop()
        t.stop()


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys, numpy as np, pyarrow as pa\n"
        # jax and the reference absent: importing either raises
        "sys.modules.update({'jax': None, 'spark_tpu': None})\n"
        "import spark_tpu_torch\n"
        "from spark_tpu_torch import TorchSession\n"
        "import spark_tpu_torch.api.functions as F\n"
        "s = TorchSession('purity', {'spark.tpu.batch.capacity': 4096},"
        " device='cpu')\n"
        "rng = np.random.default_rng(0)\n"
        "t = pa.table({'k': rng.integers(0, 50, 9000),"
        " 'v': rng.integers(0, 100, 9000)})\n"
        "df = (s.createDataFrame(t).filter(F.col('v') > 25)"
        ".withColumn('v2', F.col('v') * 3).repartition(8).groupBy('k')"
        ".agg(F.sum('v2'), F.count('*'), F.min('v'), F.max('v'),"
        " F.avg('v')))\n"
        "assert df.toArrow().num_rows == 50\n"
        "d = s.createDataFrame(pa.table({'k': np.arange(50),"
        " 'w': np.arange(50) * 2}))\n"
        "a = s.createDataFrame(t)\n"
        "j = a.join(d, a['k'] == d['k'], 'left_outer')"
        ".repartition(4).orderBy(F.desc('w'), 'v').limit(10)\n"
        "assert j.toArrow().num_rows == 10\n"
        "s.createDataFrame(pa.table({'k': np.arange(50),"
        " 'name': ['n' + str(i % 7) for i in range(50)]}))"
        ".createOrReplaceTempView('dim')\n"
        "a.createOrReplaceTempView('fact')\n"
        "q = s.sql(\"SELECT d.name, sum(f.v) AS total, count(*) AS n \"\n"
        "          \"FROM fact f, dim d WHERE f.k = d.k AND \"\n"
        "          \"substr(d.name, 1, 1) = 'n' GROUP BY d.name \"\n"
        "          \"ORDER BY total DESC LIMIT 3\")\n"
        "assert q.toArrow().num_rows == 3\n"
        "u = s.sql(\"SELECT name, count(*) AS n FROM (SELECT name \"\n"
        "          \"FROM dim UNION ALL SELECT 'x' AS name FROM fact) q \"\n"
        "          \"WHERE name IN (SELECT name FROM dim WHERE k < 9) \"\n"
        "          \"AND (SELECT max(k) FROM dim) > 3 GROUP BY name\")\n"
        "assert u.toArrow().num_rows == 7\n"
        "import spark_tpu_torch.api.window as W\n"
        "w = W.Window.partitionBy('k').orderBy(F.desc('v'))\n"
        "r = a.select('k', F.rank().over(w).alias('r')).filter(F.col('r') < 2)\n"
        "assert r.toArrow().num_rows > 0\n"
        "g = s.sql(\"SELECT name, count(*) n, grouping(name) g, \"\n"
        "          \"CASE WHEN k > 3 THEN name ELSE 'lo' END c FROM dim \"\n"
        "          \"GROUP BY ROLLUP(name, k)\")\n"
        "assert g.toArrow().num_rows > 0\n"
        "x = s.sql(\"SELECT k FROM dim INTERSECT SELECT k FROM fact\")\n"
        "assert x.toArrow().num_rows == 50\n"
        "c = s.sql(\"SELECT count(DISTINCT v) dv, sum(v) sv FROM fact\")\n"
        "assert c.toArrow().to_pylist()[0]['dv'] == 100\n"
        "n = s.sql(\"SELECT count(*) n FROM dim CROSS JOIN dim d2 \"\n"
        "          \"WHERE dim.name LIKE 'n1%'\")\n"
        "assert n.toArrow().to_pylist()[0]['n'] == 7 * 50\n"
        "import os, tempfile\n"
        "import spark_tpu_torch.io.sources, spark_tpu_torch.api.readwriter\n"
        "p = os.path.join(tempfile.mkdtemp(), 'fact')\n"
        "a.write.partitionBy('k').parquet(p)\n"
        "f = s.read.parquet(p)\n"
        "f.createOrReplaceTempView('pfact')\n"
        "pj = s.sql(\"SELECT count(*) n FROM pfact JOIN dim ON pfact.k = \"\n"
        "           \"dim.k WHERE dim.k < 5\")\n"
        "assert pj.toArrow().to_pylist()[0]['n'] == "
        "int((t.column('k').to_numpy() < 5).sum())\n"
        "assert s.metrics['scan.dpp_pruned_splits'] == 45\n"
        "assert s.range(0, 100, 7, 3).count() == 15\n"
        "assert s.sql('SELECT 1 + 1 AS two').toArrow().num_rows == 1\n"
        "import spark_tpu_torch.plan.commands, spark_tpu_torch.plan.stats\n"
        "import spark_tpu_torch.plan.warehouse, spark_tpu_torch.api.na\n"
        "import spark_tpu_torch.api.stat, spark_tpu_torch.sql.scripting\n"
        "import spark_tpu_torch.utils.variant\n"
        "import spark_tpu_torch.columnar.encoding\n"
        "import spark_tpu_torch.columnar.validate\n"
        "s.sql('CREATE TABLE ct AS SELECT k, v FROM fact WHERE k < 10')\n"
        "s.sql('DELETE FROM ct WHERE k = 0')\n"
        "s.sql('INSERT INTO ct VALUES (99, 1)')\n"
        "s.sql('MERGE INTO ct USING (SELECT k, 0 AS v FROM dim) d ON '\n"
        "      'ct.k = d.k WHEN MATCHED THEN UPDATE SET v = d.v')\n"
        "s.sql('ANALYZE TABLE ct COMPUTE STATISTICS')\n"
        "sc = s.sql('BEGIN DECLARE i INT DEFAULT 0; WHILE i < 3 DO '\n"
        "           'SET VARIABLE i = i + 1; END WHILE; SELECT i AS r; END')\n"
        "assert sc.toArrow().to_pylist() == [{'r': 3}]\n"
        "u = s.sql('SELECT * FROM ct JOIN (SELECT col1 AS k FROM '\n"
        "          '(VALUES (99))) w USING (k)')\n"
        "assert u.toArrow().to_pylist() == [{'k': 99, 'v': 1}]\n"
        "s.table('ct').na.fill(0).describe('v').collect()\n"
        "s.createDataFrame(pa.table({'l': pa.array([[1, 2], [3]],"
        " pa.list_(pa.int64())), 'ts': pa.array([0, 86400000001],"
        " pa.timestamp('us'))})).createOrReplaceTempView('nt')\n"
        "e = s.sql(\"SELECT explode(l) x, hour(ts) h, named_struct('a', 1).a"
        " a FROM nt\").toArrow()\n"
        "assert e.num_rows == 3, e\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and ("
        "m == 'jax' or m.startswith('jax.') or m == 'spark_tpu' or "
        "m.startswith('spark_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_no_device_given_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(DeviceUnavailableError):
        TorchSession("no-card")
    with pytest.raises(DeviceUnavailableError):
        TorchSession("no-card", {"spark.torch.device": "cuda"})
    assert TorchSession("cpu-by-conf", {"spark.torch.device": "cpu"}) \
        .device.type == "cpu"


@pytest.mark.parametrize("what", ["sql", "binary_column", "coalesce",
                                  "string_filter", "explicit_schema"])
def test_unported_entry_points_raise_not_ported(sessions, what):
    """The entry points the port refuses raise NotPortedError. Two cases
    run since A6's slice and are held to the reference instead: a
    Repartition without shuffle (CoalescePartitionsExec), over a plain
    scan and over a string condition with a lambda."""
    j, t = sessions
    if what in ("coalesce", "string_filter"):
        from spark_tpu.plan.logical import Repartition as JRepartition
        from spark_tpu_torch.plan.logical import Repartition

        out = []
        for s, rep in ((t, Repartition), (j, JRepartition)):
            df = s.createDataFrame(_table())
            if what == "string_filter":
                kept = df.filter("exists(array(1), x -> x > 0)")
                assert kept.toArrow().num_rows == df.toArrow().num_rows
                df = kept
            out.append(sorted(
                tuple(r.values()) for r in
                df._with(rep(2, False, [], df.plan)).toArrow().to_pylist()))
        assert out[0] == out[1] and len(out[0]) == _table().num_rows
        return
    df = t.createDataFrame(_table())
    with pytest.raises(NotPortedError):
        if what == "sql":
            t.sql("CACHE TABLE t1")
        elif what == "binary_column":
            # binary columns run since the types slice; a decimal past 18
            # digits is still refused at ingest
            import decimal

            t.createDataFrame(pa.table({"b": pa.array(
                [decimal.Decimal(1)], pa.decimal128(30, 2))}))
        else:
            # rows with a schema are ported; a decimal past 18 digits is
            # not
            import decimal

            t.createDataFrame([(decimal.Decimal("12345678901234567890.5"),)],
                              schema=["b"])
