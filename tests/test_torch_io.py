"""The port's file sources and writers (`spark_tpu_torch/io/sources.py`,
`io/avro.py`, `io/commit.py`, `api/readwriter.py`) against the JAX
package's, case for case with `tests/test_io.py`: each engine writes and
reads its own files from the same numpy-seeded tables in its own directory
(TpuSession operator-at-a-time, fusion off; TorchSession on the CPU), and
each also reads the other's files. Results compare exactly (row order
ignored unless the query sorts; no float is summed); the scans' physical
operators and their columns compare too."""

import os
import sqlite3
import sys
import threading

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as TF  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import NotPortedError, TorchSession  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port side pinned to the operator tier, as the reference side is:
# these tests hold operator-at-a-time execution (tests/test_torch_fusion.py
# holds the stage tier)
CONF = {"spark.sql.shuffle.partitions": 4,
        "spark.tpu.batch.capacity": 1 << 12,
        "spark.tpu.compile.tier": "operator"}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator"})


@pytest.fixture(scope="module")
def sessions():
    j = TpuSession("torch-io-reference", dict(JAX_CONF))
    t = TorchSession("torch-io", dict(CONF), device="cpu")
    yield j, t
    j.stop()
    t.stop()


def _engines(sessions):
    j, t = sessions
    return (("jax", j, JF), ("torch", t, TF))


def _rows(table) -> list:
    return sorted(map(str, table.to_pylist()))


def _scans(df) -> list:
    """(operator, columns) of each scan leaf of the physical plan."""
    out = []

    def walk(n):
        if not n.children:
            out.append((type(n).__name__,
                        tuple(a.name for a in n.output)))
        for c in n.children:
            walk(c)

    walk(df.query_execution.physical)
    return out


def _both(sessions, tmp_path, run):
    """run(session, F, directory) for each engine in its own directory;
    the two results must be equal."""
    got = {}
    for name, s, F in _engines(sessions):
        d = tmp_path / name
        d.mkdir()
        got[name] = run(s, F, str(d))
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_parquet_roundtrip(sessions, tmp_path):
    t = pa.table({"a": [1, 2, 3], "s": ["x", "y", "z"]})

    def run(s, F, d):
        s.createDataFrame(t).write.parquet(os.path.join(d, "t.parquet"))
        return s.read.parquet(os.path.join(d, "t.parquet")).orderBy("a") \
            .toArrow().to_pydict()

    assert _both(sessions, tmp_path, run) == \
        {"a": [1, 2, 3], "s": ["x", "y", "z"]}
    # each engine reads the other's file
    j, p = sessions
    assert p.read.parquet(str(tmp_path / "jax" / "t.parquet")) \
        .toArrow().equals(j.read.parquet(
            str(tmp_path / "torch" / "t.parquet")).toArrow())


def test_parquet_partitioned_write_read(sessions, tmp_path):
    t = pa.table({"k": ["a", "a", "b"], "year": [2020, 2021, 2020],
                  "v": [1.0, 2.0, 3.0]})

    def run(s, F, d):
        p = os.path.join(d, "part")
        s.createDataFrame(t).write.partitionBy("k", "year").parquet(p)
        assert os.path.isdir(os.path.join(p, "k=a", "year=2020"))
        back = s.read.parquet(p)
        return (sorted(back.columns),
                back.orderBy("v").toArrow().to_pydict(),
                back.filter(F.col("year") == 2020).count(),
                sorted(os.listdir(p)))

    cols, out, n2020, listing = _both(sessions, tmp_path, run)
    assert cols == ["k", "v", "year"]
    assert out["k"] == ["a", "a", "b"] and out["year"] == [2020, 2021, 2020]
    assert n2020 == 2
    assert "_SUCCESS" in listing


def test_parquet_column_pruning_pushdown(sessions, tmp_path):
    t = pa.table({"a": list(range(100)), "b": list(range(100)),
                  "c": list(range(100))})

    def run(s, F, d):
        p = os.path.join(d, "w.parquet")
        s.createDataFrame(t).write.parquet(p)
        df = s.read.parquet(p).select("a")
        scans = _scans(df)
        return scans, df.count()

    scans, n = _both(sessions, tmp_path, run)
    assert scans == [("ScanExec", ("a",))]
    assert n == 100


def test_csv_roundtrip(sessions, tmp_path):
    t = pa.table({"x": [1, 2], "y": ["p", "q"]})

    def run(s, F, d):
        p = os.path.join(d, "t.csv")
        s.createDataFrame(t).write.csv(p)
        return s.read.csv(p).orderBy("x").toArrow().to_pydict()

    assert _both(sessions, tmp_path, run) == {"x": [1, 2], "y": ["p", "q"]}


def test_csv_options_and_schema(sessions, tmp_path):
    """header off and another separator: the reader's options."""
    def run(s, F, d):
        p = os.path.join(d, "raw.csv")
        with open(p, "w") as f:
            f.write("1;a\n2;b\n3;c\n")
        df = s.read.option("header", "false").option("sep", ";").csv(p)
        return df.columns, _rows(df.toArrow())

    cols, rows = _both(sessions, tmp_path, run)
    assert len(cols) == 2 and len(rows) == 3


def test_json_write_read(sessions, tmp_path):
    def run(s, F, d):
        p = os.path.join(d, "t.json")
        s.createDataFrame(pa.table({"x": [1, 2]})).write.json(p)
        return sorted(s.read.json(p).toArrow().to_pydict()["x"])

    assert _both(sessions, tmp_path, run) == [1, 2]


def test_write_modes(sessions, tmp_path):
    def run(s, F, d):
        from spark_tpu.errors import AnalysisException as JA
        from spark_tpu_torch.errors import AnalysisException as TA

        p = os.path.join(d, "m.parquet")
        df = s.createDataFrame(pa.table({"x": [1]}))
        df.write.parquet(p)
        with pytest.raises((JA, TA)):
            df.write.parquet(p)  # errorifexists
        df.write.mode("ignore").parquet(p)
        s.createDataFrame(pa.table({"x": [9]})).write.mode("overwrite") \
            .parquet(p)
        return s.read.parquet(p).toArrow().to_pydict()["x"]

    assert _both(sessions, tmp_path, run) == [9]


@pytest.mark.parametrize("module", ["spark_tpu.io.commit",
                                    "spark_tpu_torch.io.commit"])
def test_commit_coordinator_exactly_one_winner(tmp_path, module):
    """Eight attempts of one task race the coordinator; exactly one
    commits, the others are denied and leave no files."""
    import importlib

    commit = importlib.import_module(module)
    out = tmp_path / "out"
    out.mkdir()
    proto = commit.FileCommitProtocol(str(out))
    proto.setup_job()
    results = []

    def attempt(tag):
        att = proto.new_task_attempt(task_id=0)
        with open(att.path_for("part-00000.txt"), "w") as f:
            f.write(tag)
        try:
            att.commit()
            results.append(("committed", tag))
        except commit.CommitDeniedError:
            results.append(("denied", tag))

    threads = [threading.Thread(target=attempt, args=(f"a{i}",))
               for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    proto.commit_job()
    assert sum(1 for s, _ in results if s == "committed") == 1
    assert sum(1 for s, _ in results if s == "denied") == 7
    winner = next(tag for s, tag in results if s == "committed")
    assert (out / "part-00000.txt").read_text() == winner
    assert (out / "_SUCCESS").exists()
    assert not (out / "_temporary").exists()


def test_partitioned_write_commits_atomically(sessions, tmp_path):
    t = pa.table({"k": [1, 1, 2, 2, 3], "v": [10.0, 11.0, 20.0, 21.0, 30.0]})

    def run(s, F, d):
        p = os.path.join(d, "part_out")
        s.createDataFrame(t).write.partitionBy("k").parquet(p)
        assert os.path.exists(os.path.join(p, "_SUCCESS"))
        assert not os.path.exists(os.path.join(p, "_temporary"))
        back = s.read.parquet(p).toArrow()
        return sorted(back.column("v").to_pylist()), \
            sorted(back.column("k").to_pylist())

    assert _both(sessions, tmp_path, run) == \
        ([10.0, 11.0, 20.0, 21.0, 30.0], [1, 1, 2, 2, 3])


def test_orc_roundtrip(sessions, tmp_path):
    t = pa.table({"a": [1, 2, 3], "b": ["x", "y", None],
                  "c": [1.5, None, 3.5]})

    def run(s, F, d):
        p = os.path.join(d, "t.orc")
        s.createDataFrame(t).write.orc(p)
        back = s.read.orc(p)
        assert back.toArrow().to_pydict() == t.to_pydict()
        back.createOrReplaceTempView("orc_t")
        q = s.sql("SELECT a FROM orc_t WHERE c > 1")
        return sorted(q.toArrow().column("a").to_pylist()), _scans(q)

    a, scans = _both(sessions, tmp_path, run)
    assert a == [1, 3]
    assert scans == [("ScanExec", ("a", "c"))]


def test_orc_partitioned_write_and_format_load(sessions, tmp_path):
    t = pa.table({"k": ["a", "a", "b"], "v": [1, 2, 3]})

    def run(s, F, d):
        p = os.path.join(d, "orc_parts")
        s.createDataFrame(t).write.partitionBy("k").orc(p)
        assert os.path.exists(os.path.join(p, "_SUCCESS"))
        back = s.read.format("orc").load(p).toArrow()
        return sorted(back.column("v").to_pylist())

    assert _both(sessions, tmp_path, run) == [1, 2, 3]


def _emp_db(d) -> str:
    db = os.path.join(d, "db.sqlite")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE emp (id INTEGER, name TEXT, sal REAL, "
                 "dept INTEGER)")
    conn.executemany("INSERT INTO emp VALUES (?,?,?,?)",
                     [(i, f"e{i}", 100.0 * i, i % 3) for i in range(50)])
    conn.commit()
    conn.close()
    return db


def test_jdbc_read_partitioned(sessions, tmp_path):
    def run(s, F, d):
        db = _emp_db(d)
        df = (s.read.format("jdbc").option("url", f"jdbc:sqlite:{db}")
              .option("dbtable", "emp").option("partitionColumn", "id")
              .option("numPartitions", "4").load())
        n = df.count()
        out = s.createDataFrame(pa.table({"id": [1, 2]})) \
            .join(df, "id").toArrow()
        return n, sorted(out.column("sal").to_pylist())

    assert _both(sessions, tmp_path, run) == (50, [100.0, 200.0])


# query -> the source's last generated SQL must hold this fragment
JDBC_PUSHDOWN = {
    "filter": ("SELECT id, name FROM emp WHERE id < 10 AND name <> 'e3'",
               "WHERE"),
    "aggregate": ("SELECT dept, count(*) n, sum(sal) s, min(id) lo, "
                  "max(id) hi FROM emp GROUP BY dept", "GROUP BY"),
    "filtered_aggregate": ("SELECT dept, count(*) n FROM emp WHERE id >= 20 "
                           "GROUP BY dept", "GROUP BY"),
    "limit": ("SELECT id FROM emp LIMIT 7", "LIMIT"),
}


@pytest.mark.parametrize("case", list(JDBC_PUSHDOWN))
def test_jdbc_pushdown(sessions, tmp_path, case):
    """Filters, whole aggregates and limits run in the database: equal
    results, equal scan operators, and the pushed clause in the SQL the
    source generated."""
    text, fragment = JDBC_PUSHDOWN[case]

    def run(s, F, d):
        db = _emp_db(d)
        df = (s.read.format("jdbc").option("url", f"jdbc:sqlite:{db}")
              .option("dbtable", "emp").load())
        df.createOrReplaceTempView("emp")
        q = s.sql(text)
        rows = q.toArrow()
        scan = q.query_execution.physical
        while scan.children:
            scan = scan.children[0]
        assert fragment in scan.source.last_sql, scan.source.last_sql
        return (rows.num_rows if case == "limit" else _rows(rows)), \
            _scans(q)

    _both(sessions, tmp_path, run)


def test_tpcds_q3_from_orc(sessions, tmp_path):
    """TPC-DS q3 from ORC files equals q3 over the in-memory tables, in
    both engines."""
    sys.path.insert(0, ROOT)
    from tests.tpcds.datagen import _Gen
    from tests.tpcds.oracle import strip_trailing_limit

    g = _Gen(0.1, 17)
    for t in ("date_dim", "time_dim", "item", "customer_address",
              "customer_demographics", "household_demographics",
              "income_band", "customer", "store", "warehouse",
              "ship_mode", "reason", "call_center", "catalog_page",
              "web_site", "web_page", "promotion", "store_sales"):
        getattr(g, t)()
    q3 = strip_trailing_limit(open(os.path.join(
        ROOT, "tests", "tpcds", "queries", "q3.sql")).read())

    def run(s, F, d):
        for n in ("date_dim", "store_sales", "item"):
            s.createDataFrame(g.tables[n]).createOrReplaceTempView(n)
        want = s.sql(q3).toArrow()
        for n in ("date_dim", "store_sales", "item"):
            p = os.path.join(d, f"{n}.orc")
            s.createDataFrame(g.tables[n]).write.orc(p)
            s.read.orc(p).createOrReplaceTempView(n)
        got = s.sql(q3)
        rows = got.toArrow()
        assert rows.num_rows == want.num_rows > 0
        assert _rows(rows) == _rows(want)
        return _rows(rows), sorted(_scans(got))

    rows, scans = _both(sessions, tmp_path, run)
    assert [op for op, _ in scans] == ["ScanExec"] * 3


def test_text_source(sessions, tmp_path):
    def run(s, F, d):
        p = os.path.join(d, "lines.txt")
        with open(p, "w") as f:
            f.write("hello world\nfoo\nbar baz\n")
        df = s.read.text(p)
        lines = df.toArrow().column("value").to_pylist()
        df.createOrReplaceTempView("lines")
        c = s.sql("SELECT count(*) c FROM lines WHERE value LIKE '%o%'") \
            .toArrow().column("c")[0].as_py()
        return lines, c

    assert _both(sessions, tmp_path, run) == \
        (["hello world", "foo", "bar baz"], 2)


def test_avro_roundtrip(sessions, tmp_path):
    rng = np.random.default_rng(4)
    t = pa.table({"i": pa.array(rng.integers(-1000, 1000, 200)),
                  "x": pa.array(rng.standard_normal(200),
                                mask=rng.random(200) < 0.1),
                  "s": pa.array([f"s{v}" for v in rng.integers(0, 9, 200)]),
                  "b": pa.array(rng.random(200) < 0.5)})

    def run(s, F, d):
        p = os.path.join(d, "t.avro")
        s.createDataFrame(t).write.avro(p)
        back = s.read.avro(p)
        agg = back.groupBy("s").agg(F.count("*"), F.max("i")) \
            .orderBy("s").toArrow().to_pylist()
        return back.toArrow().to_pydict(), agg

    full, agg = _both(sessions, tmp_path, run)
    assert full == t.to_pydict() and len(agg) == 9
    # the JAX package's file reads back in the port, and the reverse
    j, p = sessions
    assert p.read.avro(str(tmp_path / "jax" / "t.avro")).toArrow() \
        .to_pydict() == t.to_pydict()
    assert j.read.format("avro").load(str(tmp_path / "torch" / "t.avro")) \
        .toArrow().to_pydict() == t.to_pydict()


def test_xml_source(sessions, tmp_path):
    def run(s, F, d):
        p = os.path.join(d, "t.xml")
        with open(p, "w") as f:
            f.write("<rows><ROW id='1'><name>ann</name><city>x</city></ROW>"
                    "<ROW id='2'><name>bob</name></ROW>"
                    "<ROW id='3'><name>cy</name><city>y</city></ROW></rows>")
        df = s.read.xml(p)
        df.createOrReplaceTempView("people")
        q = s.sql("SELECT name FROM people WHERE city IS NOT NULL")
        return df.columns, _rows(df.toArrow()), _rows(q.toArrow())

    cols, rows, named = _both(sessions, tmp_path, run)
    assert cols == ["_id", "name", "city"] and len(rows) == 3
    assert named == ["{'name': 'ann'}", "{'name': 'cy'}"]


@pytest.mark.parametrize("call", ["saveAsTable", "insertInto"])
def test_warehouse_writes_raise_not_ported(sessions, call):
    """The warehouse writes are ported (plan/warehouse.py; with a warehouse
    in tests/test_torch_commands.py). With none, saveAsTable registers a
    temp view and insertInto raises AnalysisException, in both engines
    alike; neither raises NotPortedError."""
    got = []
    for s in sessions:
        df = s.createDataFrame(pa.table({"x": [1]}))
        if call == "saveAsTable":
            getattr(df.write, call)("tbl_" + call)
            got.append(s.sql("SELECT x FROM tbl_saveAsTable")
                       .toArrow().to_pydict())
        else:
            with pytest.raises(Exception) as err:
                getattr(df.write, call)("tbl_" + call)
            assert not isinstance(err.value, NotPortedError)
            got.append((type(err.value).__name__, str(err.value)))
    assert got[0] == got[1]


def test_unreadable_source_raises(sessions, tmp_path):
    """No files, no scan: the reader raises, in both engines alike."""
    for _, s, _ in _engines(sessions):
        with pytest.raises(FileNotFoundError):
            s.read.parquet(str(tmp_path / "missing"))
