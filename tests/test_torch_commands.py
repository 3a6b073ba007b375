"""The commands and the catalog of the port (plan/commands.py,
plan/catalog.py, plan/warehouse.py, plan/stats.py) against the JAX
reference: the cases of tests/test_commands.py and tests/test_stats.py that
fall in this slice, each run on a TpuSession (operator tier, fusion off)
and a TorchSession(device="cpu") built from the same seeded tables. A case
returns what it observed: each statement's result rows, the tables a
command leaves (read back in order), and for a statement that raises its
error class. Both engines observe the same, exactly. Each statement this
slice leaves out raises NotPortedError naming its ROADMAP.md item.

`both(pair, case)` is shared with the other files of the slice."""

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as TF  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import NotPortedError, TorchSession  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401
from tests.test_torch_tpcds_slice import (  # noqa: E402
    _ops, _reference_ops, _renumber,
)

CONF = {"spark.sql.shuffle.partitions": 4,
        "spark.tpu.batch.capacity": 1 << 10,
        "spark.tpu.compile.tier": "operator"}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false"})


class Pair:
    def __init__(self, conf=None, jax_conf=None):
        self.jax = TpuSession("commands-reference",
                              dict(jax_conf or JAX_CONF))
        self.torch = TorchSession("commands", dict(conf or CONF),
                                  device="cpu")

    def engines(self):
        return (("jax", self.jax, JF), ("torch", self.torch, TF))

    def stop(self):
        self.jax.stop()
        self.torch.stop()


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.stop()


def error_of(e: BaseException) -> tuple:
    return ("raises", type(e).__name__, getattr(e, "error_class", None))


class Observer:
    """What a case saw on one engine: results, tables and errors."""

    def __init__(self, session, F):
        self.s = session
        self.F = F
        self.seen: list = []

    def sql(self, text: str, keep: bool = True):
        """Run a statement; keep its result rows (or its error)."""
        try:
            df = self.s.sql(text)
            rows = None if df is None else df.toArrow().to_pylist()
        except Exception as e:  # noqa: BLE001 - the class is compared
            if isinstance(e, AssertionError):
                raise
            self.seen.append((text, error_of(e)))
            return None
        if keep:
            self.seen.append((text, rows))
        return rows

    def table(self, name: str, order: str):
        """The rows a command left in `name`, in `order`."""
        return self.sql(f"SELECT * FROM {name} ORDER BY {order}")

    def raises(self, fn, what: str | None = None):
        """Call fn; keep the class of the error it must raise (and check
        a NotPortedError names `what`)."""
        try:
            fn()
        except Exception as e:  # noqa: BLE001
            if what is not None and isinstance(e, NotPortedError):
                assert what.lower() in e.what.lower(), e.what
            self.seen.append(error_of(e))
            return e
        raise AssertionError("expected an error")

    def attempt(self, fn):
        """Keep fn()'s value, or the class of the error it raised."""
        try:
            return self.keep(fn())
        except Exception as e:  # noqa: BLE001
            if isinstance(e, AssertionError):
                raise
            self.seen.append(error_of(e))
            return None

    def keep(self, value):
        self.seen.append(value)
        return value


def both(pair, case) -> list:
    """Run case(Observer) on both engines; they must observe the same."""
    seen = {}
    for name, s, F in pair.engines():
        obs = Observer(s, F)
        case(obs)
        seen[name] = obs.seen
    assert seen["torch"] == seen["jax"]
    return seen["torch"]


def _dml_table(o, name="dml_t"):
    o.s.createDataFrame(pa.table({
        "id": [1, 2, 3, 4], "name": ["a", "b", "c", None],
        "amt": pa.array([10, 20, None, 40], pa.int64())})) \
        .createOrReplaceTempView(name)


def case_create_and_drop_view(o):
    o.sql("CREATE OR REPLACE TEMPORARY VIEW v1 AS SELECT 1 AS x")
    o.sql("SELECT x + 1 AS y FROM v1")
    o.sql("DROP VIEW v1")
    o.sql("SELECT * FROM v1")
    o.sql("DROP VIEW IF EXISTS v1")
    o.sql("DROP VIEW v1")


def case_create_table_as(o):
    o.sql("CREATE OR REPLACE TEMPORARY VIEW src AS "
          "SELECT col1 AS x FROM (VALUES (1), (2), (3))")
    o.sql("CREATE TABLE t_mat AS SELECT x * 10 AS y FROM src")
    o.sql("SELECT sum(y) AS s FROM t_mat")
    o.table("t_mat", "y")
    o.sql("DROP TABLE t_mat")
    o.sql("DROP VIEW src")


def case_show_tables_and_describe(o):
    o.sql("CREATE OR REPLACE TEMP VIEW shown AS "
          "SELECT 1 AS a, 'x' AS b, CAST(2.5 AS DECIMAL(5, 2)) AS d, "
          "DATE '2020-01-02' AS dt, 1.5 AS f")
    rows = o.s.sql("SHOW TABLES").toArrow().to_pydict()
    o.keep("shown" in rows["tableName"])
    o.keep((sorted(rows), rows["isTemporary"][0]))
    o.sql("DESCRIBE shown")
    o.sql("DESCRIBE TABLE shown")
    o.sql("DESCRIBE no_such_view")
    o.sql("DROP VIEW shown")


def case_explain(o):
    for stmt in ("EXPLAIN SELECT col1 AS k, count(*) AS n FROM "
                 "(VALUES (1), (2), (1)) GROUP BY col1",
                 "EXPLAIN EXTENDED SELECT 1 AS one",
                 "EXPLAIN FORMATTED SELECT 1 AS one"):
        plan = o.s.sql(stmt).toArrow().column("plan")[0].as_py()
        # the logical part: the port adds its compile tier after the
        # physical plan, whose operator names are each engine's own
        logical = plan.split("== Physical Plan ==")[0]
        o.keep(_renumber(logical))
        o.keep("== Physical Plan ==" in plan)


def case_set_command(o):
    o.sql("SET spark.sql.shuffle.partitions = 6")
    o.keep(o.s.conf.shuffle_partitions)
    o.sql("SET spark.sql.shuffle.partitions")
    o.sql("SET spark.sql.shuffle.partitions = 4")
    o.sql("SET spark.tpu.batch.capacity")
    keys = o.s.sql("SET").toArrow().to_pydict()["key"]
    o.keep("spark.sql.shuffle.partitions" in keys)


def case_count_distinct_sql(o):
    o.sql("CREATE OR REPLACE TEMP VIEW cd AS SELECT col1 AS g, col2 AS x "
          "FROM (VALUES (1, 10), (1, 10), (1, 20), (2, 30))")
    o.sql("SELECT g, count(DISTINCT x) AS c FROM cd GROUP BY g ORDER BY g")
    o.sql("DROP VIEW cd")


def case_update(o):
    _dml_table(o)
    o.sql("UPDATE dml_t SET amt = amt + 100 WHERE id >= 2")
    o.table("dml_t", "id")
    o.sql("UPDATE dml_t SET amt = '7', name = upper(name) WHERE amt > 125")
    o.table("dml_t", "id")
    o.sql("UPDATE dml_t SET amt = 0")
    o.table("dml_t", "id")
    o.sql("UPDATE dml_t SET nope = 1")
    o.sql("UPDATE no_such_t SET amt = 1")


def case_delete(o):
    _dml_table(o)
    o.sql("DELETE FROM dml_t WHERE id = 1")
    o.table("dml_t", "id")
    # NULL on id 3 (amt is NULL): kept, as a false predicate is
    o.sql("DELETE FROM dml_t WHERE amt > 30")
    o.table("dml_t", "id")
    o.sql("DELETE FROM dml_t WHERE name = 'c' OR id IN (2, 9)")
    o.table("dml_t", "id")
    o.sql("DELETE FROM dml_t")
    o.table("dml_t", "id")


@pytest.mark.parametrize("subquery", [
    "SELECT col1 FROM (VALUES (2), (4))",
    "SELECT k FROM del_s JOIN del_d ON k = dk WHERE dv > 0",
    "SELECT k FROM del_s WHERE EXISTS (SELECT 1 FROM del_d WHERE dk = k)"])
def test_delete_with_subquery_held_to_oracle(pair, subquery):
    """DELETE ... WHERE id IN (subquery): the reference's bare Filter
    returns the columns of the joins its subquery rewrites into and its
    rewrite of the table fails (ROADMAP.md C12); the port leaves the rows
    a plain Python oracle keeps."""
    rows = {"id": [1, 2, 3, 4, None], "v": [10, 20, 30, 40, 50]}
    sub = {"k": [2, 4, 7], "dk": [2, 4, 7], "dv": [1, 1, -1]}
    for _, s, _ in pair.engines():
        s.createDataFrame(pa.table(rows)).createOrReplaceTempView("del_t")
        s.createDataFrame(pa.table({"k": sub["k"]})) \
            .createOrReplaceTempView("del_s")
        s.createDataFrame(pa.table({"dk": sub["dk"], "dv": sub["dv"]})) \
            .createOrReplaceTempView("del_d")
    gone = {2, 4}
    want = [{"id": i, "v": v} for i, v in zip(rows["id"], rows["v"])
            if i not in gone]
    stmt = f"DELETE FROM del_t WHERE id IN ({subquery})"
    pair.torch.sql(stmt)
    got = pair.torch.sql("SELECT * FROM del_t ORDER BY v").toArrow()
    assert got.to_pylist() == want
    with pytest.raises(pa.ArrowInvalid):
        pair.jax.sql(stmt)


def case_insert_into_view(o):
    _dml_table(o, "ins_t")
    o.sql("INSERT INTO ins_t VALUES (9, 'z', 90)")
    o.sql("INSERT INTO ins_t SELECT id + 10, name, amt FROM ins_t "
          "WHERE id < 3")
    o.table("ins_t", "id")
    o.sql("INSERT OVERWRITE ins_t SELECT id, name, amt FROM ins_t "
          "WHERE amt IS NULL")
    o.table("ins_t", "id")
    o.s.createDataFrame(pa.table({"a": [1]})).createOrReplaceTempView("lazy")
    o.sql("CREATE OR REPLACE TEMP VIEW lazy_v AS SELECT a FROM lazy")
    o.sql("INSERT INTO lazy_v VALUES (2)")


def case_merge(o):
    _dml_table(o)
    o.s.createDataFrame(pa.table({
        "id": [2, 3, 5], "v": [999, -1, 40]})) \
        .createOrReplaceTempView("dml_src")
    o.sql("""
        MERGE INTO dml_t AS t USING dml_src AS u ON t.id = u.id
        WHEN MATCHED AND u.v < 0 THEN DELETE
        WHEN MATCHED THEN UPDATE SET amt = u.v
        WHEN NOT MATCHED THEN INSERT (id, amt) VALUES (u.id, u.v)""")
    o.table("dml_t", "id")


def case_merge_insert_star(o):
    o.s.createDataFrame(pa.table({"k": [1], "v": [5]})) \
        .createOrReplaceTempView("ms_t")
    o.s.createDataFrame(pa.table({"k": [1, 2], "v": [50, 20]})) \
        .createOrReplaceTempView("ms_s")
    o.sql("""
        MERGE INTO ms_t USING ms_s ON ms_t.k = ms_s.k
        WHEN MATCHED THEN UPDATE SET v = ms_s.v
        WHEN NOT MATCHED THEN INSERT *""")
    o.table("ms_t", "k")


def case_merge_cardinality_violation(o):
    o.s.createDataFrame(pa.table({"k": [1, 2], "v": [10, 20]})) \
        .createOrReplaceTempView("mcv_t")
    o.s.createDataFrame(pa.table({"k": [1, 1], "v": [5, 6]})) \
        .createOrReplaceTempView("mcv_s")
    o.sql("""
        MERGE INTO mcv_t AS t USING mcv_s AS s ON t.k = s.k
        WHEN MATCHED THEN UPDATE SET v = s.v""")
    o.table("mcv_t", "k")


def case_merge_insert_only_multi_match(o):
    o.s.createDataFrame(pa.table({"k": [1], "v": [10]})) \
        .createOrReplaceTempView("mio_t")
    o.s.createDataFrame(pa.table({"k": [1, 1, 2], "v": [5, 6, 7]})) \
        .createOrReplaceTempView("mio_s")
    o.sql("""
        MERGE INTO mio_t AS t USING mio_s AS s ON t.k = s.k
        WHEN NOT MATCHED THEN INSERT *""")
    o.table("mio_t", "k, v")


def case_merge_conditions(o):
    rng = np.random.default_rng(5)
    n = 300
    o.s.createDataFrame(pa.table({
        "k": np.arange(n), "v": rng.integers(0, 100, n),
        "s": [f"s{i % 7}" for i in range(n)]})) \
        .createOrReplaceTempView("mc_t")
    src_k = rng.choice(np.arange(-50, n + 50), 120, replace=False)
    o.s.createDataFrame(pa.table({
        "k": src_k, "w": rng.integers(-20, 100, 120)})) \
        .createOrReplaceTempView("mc_s")
    o.sql("""
        MERGE INTO mc_t t USING mc_s s ON t.k = s.k
        WHEN MATCHED AND s.w < 0 THEN DELETE
        WHEN MATCHED AND s.w > 50 THEN UPDATE SET v = s.w, s = 'hi'
        WHEN MATCHED THEN UPDATE SET v = t.v + s.w
        WHEN NOT MATCHED AND s.w > 10 THEN INSERT (k, v) VALUES (s.k, s.w)
        WHEN NOT MATCHED THEN INSERT (k, s) VALUES (s.k, 'new')""")
    o.table("mc_t", "k")


def case_show_functions_and_catalog_api(o):
    o.sql("SHOW FUNCTIONS LIKE 'SUM|COUNT*|UPPER'")
    fns = o.s.sql("SHOW FUNCTIONS").toArrow().column("function").to_pylist()
    o.keep(("sum" in fns, "count" in fns, len(fns) > 150))
    cat = o.s.catalog
    o.keep([cat.functionExists(n) for n in ("crc32", "COUNT", "no_such")])
    o.s.createDataFrame(pa.table({"a": [1], "s": ["x"]})) \
        .createOrReplaceTempView("cat_t")
    o.keep(cat.listColumns("cat_t"))
    o.keep((cat.tableExists("cat_t"), cat.tableExists("cat_none")))
    o.keep("cat_t" in cat.listTables())
    o.keep(cat.dropTempView("cat_t"))
    o.keep((cat.dropTempView("cat_t"), cat.tableExists("cat_t")))
    o.keep(cat.listFunctions("upper|lower"))


def case_variables(o):
    o.sql("DECLARE VARIABLE dv INT DEFAULT 3")
    o.sql("SELECT dv * 2 AS v")
    o.sql("SET VARIABLE dv = dv + 4")
    o.sql("SELECT dv AS v")
    o.sql("DECLARE dv INT DEFAULT 9")
    o.sql("DECLARE OR REPLACE VARIABLE dv STRING DEFAULT 'x'")
    o.sql("SELECT dv AS v")
    o.sql("SET VARIABLE undeclared_v = 1")
    o.sql("DECLARE VARIABLE nv BIGINT")
    o.sql("SELECT nv IS NULL AS v")
    o.sql("DROP TEMPORARY VARIABLE dv")
    o.sql("DROP TEMPORARY VARIABLE nv")
    o.sql("DROP TEMPORARY VARIABLE dv")
    o.sql("DROP TEMPORARY VARIABLE IF EXISTS dv")
    o.sql("SELECT dv AS v")


def case_recursive_view(o):
    o.s.createDataFrame(pa.table({"a": [1]})) \
        .createOrReplaceTempView("rv_base")
    o.sql("CREATE OR REPLACE TEMP VIEW rv_v AS SELECT * FROM rv_base")
    o.sql("CREATE OR REPLACE TEMP VIEW rv_v AS SELECT * FROM rv_v")
    o.sql("CREATE OR REPLACE TEMP VIEW rv_v AS "
          "SELECT * FROM rv_base WHERE a IN (SELECT a FROM rv_v)")
    o.sql("SELECT * FROM rv_v")


def case_analyze_table(o):
    t = pa.table({"k": [1, 2, 2, 3, None], "s": ["a", "b", "b", "c", "c"]})
    o.s.createDataFrame(t).createOrReplaceTempView("stats_t")
    o.sql("ANALYZE TABLE stats_t COMPUTE STATISTICS FOR ALL COLUMNS")
    o.sql("ANALYZE TABLE stats_t COMPUTE STATISTICS FOR COLUMNS k")
    o.sql("ANALYZE TABLE stats_t COMPUTE STATISTICS")
    st = o.s._table_stats["stats_t"]
    o.keep((st.row_count, sorted(
        (k, (c.distinct_count, c.min, c.max, c.null_count))
        for k, c in st.col_stats.items())))


def case_estimates(o):
    n = 1000
    o.s.createDataFrame(pa.table({"x": np.arange(n), "k": np.arange(n) % 10})) \
        .createOrReplaceTempView("est_t")
    o.s.createDataFrame(pa.table({"fk": np.arange(1000) % 50,
                                  "v": np.ones(1000)})) \
        .createOrReplaceTempView("est_fact")
    o.s.createDataFrame(pa.table({"pk": np.arange(50)})) \
        .createOrReplaceTempView("est_dim")
    est = __import__(type(o.s).__module__.split(".")[0] + ".plan.stats",
                     fromlist=["estimate"]).estimate
    queries = ("SELECT * FROM est_t WHERE x < 100",
               "SELECT * FROM est_t WHERE k = 3 OR x >= 990",
               "SELECT * FROM est_t WHERE k IN (1, 2) AND x IS NOT NULL",
               "SELECT * FROM est_fact JOIN est_dim ON fk = pk",
               "SELECT fk, count(*) FROM est_fact GROUP BY fk",
               "SELECT DISTINCT k FROM est_t",
               "SELECT x FROM est_t UNION ALL SELECT fk FROM est_fact")
    for analyzed in (False, True):
        if analyzed:
            for t in ("est_t", "est_fact", "est_dim"):
                o.sql(f"ANALYZE TABLE {t} COMPUTE STATISTICS "
                      "FOR ALL COLUMNS")
        for q in queries:
            o.keep(est(o.s.sql(q).query_execution.analyzed).row_count)


def _cbo_tables(s):
    """The reference's case (tests/test_stats.py): the id join first with
    or without statistics. And a chain whose order ANALYZE changes: by
    rows alone a_c (1,000 x 50) is the cheaper first pair, by ndv a_b
    (1,000 x 100 / 100)."""
    rng = np.random.default_rng(0)
    n = 2000
    tables = {
        "cbo_fact": {"id": np.arange(n), "tag": rng.integers(0, 3, n)},
        "cbo_ids": {"id2": np.arange(n), "w": rng.random(n)},
        "cbo_tags": {"tag2": np.repeat(np.arange(3), 500),
                     "label": ["t"] * 1500},
        "cbo_a": {"x": np.arange(1000) % 100, "y": np.arange(1000) % 2},
        "cbo_b": {"x2": np.arange(100)},
        "cbo_c": {"y2": np.arange(50) % 2},
    }
    for name, cols in tables.items():
        s.createDataFrame(pa.table(cols)).createOrReplaceTempView(name)
    return list(tables)


CBO_QUERIES = {
    "reference": ("SELECT count(*) AS c FROM cbo_fact, cbo_ids, cbo_tags "
                  "WHERE id = id2 AND tag = tag2", 2000 * 500),
    "ndv": ("SELECT count(*) AS c FROM cbo_a, cbo_b, cbo_c "
            "WHERE x = x2 AND y = y2", 1000 * 25),
}


@pytest.mark.parametrize("query", list(CBO_QUERIES))
def test_analyze_reorders_joins_as_reference(pair, query):
    """A three-table join before and after ANALYZE TABLE of its tables:
    both engines' optimised trees print the same, their physical plans
    hold the same operator sequence, and the counts agree. The ndv chain
    changes its order with the statistics."""
    text, count = CBO_QUERIES[query]
    plans = {}
    for name, s, F in pair.engines():
        names = _cbo_tables(s)
        before = s.sql(text)
        before.query_execution.physical  # planned before the statistics
        for t in names:
            s.sql(f"ANALYZE TABLE {t} COMPUTE STATISTICS FOR ALL COLUMNS")
        after = s.sql(text)
        ops = _reference_ops if name == "jax" else _ops
        plans[name] = [
            (_renumber(df.query_execution.optimized.tree_string()), ops(df),
             df.toArrow().to_pylist()) for df in (before, after)]
        joins = [ln for ln in plans[name][1][0].splitlines() if "Join" in ln]
        if query == "reference":
            assert "id" in joins[-1] and "tag2" not in joins[-1]
        else:
            assert "x2" in joins[-1] and "y2" not in joins[-1]
    assert plans["torch"] == plans["jax"]
    assert plans["torch"][1][2] == [{"c": count}]
    if query == "ndv":
        assert plans["torch"][0][0] != plans["torch"][1][0]


def case_warehouse_catalog_errors(o):
    o.sql("CREATE TABLE wh_dup AS SELECT 1 AS x")
    o.sql("DROP TABLE wh_dup")
    o.sql("DROP TABLE wh_dup")
    o.sql("DROP TABLE IF EXISTS wh_dup")
    o.sql("SELECT * FROM wh_dup")


def case_parse_errors(o):
    for stmt in ("CREATE VIEW", "DROP SOMETHING x", "SHOW FUNCTIONS LIKE 1",
                 "MERGE INTO t USING s ON t.k = s.k WHEN MATCHED THEN "
                 "INSERT *", "VALUES (1), (1 + k)", "DELETE t",
                 "ANALYZE TABLE t COMPUTE"):
        o.sql(stmt)


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_command_matches_reference(pair, name):
    both(pair, CASES[name])


def test_warehouse_tables_and_insert(tmp_path):
    """CREATE TABLE ... AS, INSERT INTO and INSERT OVERWRITE into a
    warehouse, a second session over the same directory, DROP TABLE."""
    def case(o):
        o.sql("CREATE TABLE managed AS SELECT col1 AS x FROM "
              "(VALUES (1), (2))")
        o.keep("managed" in o.s.sql("SHOW TABLES").toArrow()
               .to_pydict()["tableName"])
        o.sql("SELECT sum(x) AS s FROM managed")
        o.sql("CREATE TABLE managed AS SELECT 5 AS x")
        o.sql("INSERT INTO managed VALUES (10)")
        o.sql("SELECT sum(x) AS s FROM managed")
        o.sql("INSERT INTO managed VALUES (10, 11)")
        o.sql("UPDATE managed SET x = x * 2 WHERE x < 10")
        o.table("managed", "x")
        o.sql("DELETE FROM managed WHERE x = 4")
        o.table("managed", "x")
        o.sql("INSERT OVERWRITE managed VALUES (7)")
        o.table("managed", "x")
        o.sql("CREATE OR REPLACE TABLE managed AS SELECT 8 AS x")
        o.table("managed", "x")
        o.sql("DESCRIBE managed")

    run_warehouse(tmp_path, case)


def test_save_as_table_api(tmp_path):
    def case(o):
        df = o.s.createDataFrame(pa.table({"a": [1, 2],
                                           "b": ["x", None]}))
        df.write.saveAsTable("t_api")
        df.write.insertInto("t_api")
        o.sql("SELECT count(*) AS c FROM t_api")
        o.raises(lambda: df.write.saveAsTable("t_api"))
        df.write.mode("overwrite").saveAsTable("t_api")
        df.write.mode("append").saveAsTable("t_api")
        o.table("t_api", "a, b")
        o.raises(lambda: df.write.insertInto("t_none"))
        o.keep(o.s.catalog.listTables())

    run_warehouse(tmp_path, case)


def run_warehouse(tmp_path, case):
    """case(Observer) per engine over a warehouse of its own, then a
    second session of the engine over the same directory reads it."""
    seen = {}
    for name, cls, F, conf in (("jax", TpuSession, JF, JAX_CONF),
                               ("torch", TorchSession, TF, CONF)):
        wh = {"spark.sql.warehouse.dir": str(tmp_path / name)}
        kw = {"device": "cpu"} if name == "torch" else {}
        s = cls("wh", dict(conf, **wh), **kw)
        try:
            o = Observer(s, F)
            case(o)
            s2 = cls("wh2", dict(conf, **wh), **kw)
            o2 = Observer(s2, F)
            for t in s2.catalog.listTables():
                o2.sql(f"SELECT * FROM {t}")
            s2.stop()
            o.sql("DROP TABLE IF EXISTS managed")
            o.sql("SELECT * FROM managed")
            seen[name] = o.seen + o2.seen
        finally:
            s.stop()
    assert seen["torch"] == seen["jax"]


def test_scan_cache_keeps_one_entry_after_inserts(pair):
    """Ten INSERT INTOs replace the view's table ten times; each replaced
    table's ingested tiles leave the session's scan cache with it."""
    import gc

    t = pair.torch
    t.createDataFrame(pa.table({"k": np.arange(100)})) \
        .createOrReplaceTempView("sc_ins")
    t._scan_cache.clear()
    for i in range(10):
        t.sql(f"INSERT INTO sc_ins VALUES ({1000 + i})")
        assert t.sql("SELECT count(*) AS c FROM sc_ins").toArrow() \
            .to_pylist() == [{"c": 101 + i}]
    gc.collect()
    live = [e for e in t._scan_cache.values() if e[0]() is not None]
    assert len(t._scan_cache) == len(live) == 1


def test_replaced_view_releases_tiles(pair):
    """A view replaced through the catalog lets its table's tiles go even
    while the caller still holds the Arrow table; a table another view
    still reads keeps them."""
    t = pair.torch
    tb = pa.table({"k": np.arange(50)})
    t.createDataFrame(tb).createOrReplaceTempView("rel_a")
    t.createDataFrame(tb).createOrReplaceTempView("rel_b")
    t.sql("SELECT sum(k) AS s FROM rel_a").toArrow()
    assert id(tb) in t._scan_cache
    t.sql("CREATE OR REPLACE TEMP VIEW rel_a AS SELECT 1 AS k")
    assert id(tb) in t._scan_cache      # rel_b still reads it
    t.sql("DROP VIEW rel_b")
    assert id(tb) not in t._scan_cache
    t.createDataFrame(tb).createOrReplaceTempView("rel_b")
    assert t.sql("SELECT sum(k) AS s FROM rel_b").toArrow().to_pylist() \
        == [{"s": 1225}]


# statement -> what its NotPortedError names
NOT_PORTED_SQL = {
    "CACHE TABLE np_t": "CACHE TABLE",
    "UNCACHE TABLE np_t": "UNCACHE TABLE",
    "EXPLAIN ANALYZE SELECT 1 AS one": "EXPLAIN ANALYZE",
    "SELECT * FROM range(3)": "table-valued function",
    "SELECT * FROM np_t TABLESAMPLE (50 PERCENT)": "TABLESAMPLE",
    "SELECT /*+ POOL(x) */ 1 AS one": "hints",
    "SET spark.tpu.memory.budget = 10": "spark.tpu.memory.budget",
    # first (A3) and the lambdas (A11) run since their slice: None, the
    # statement gives the reference's rows
    "SELECT first(k) AS f FROM np_t": None,
    "SELECT transform(array(1), x -> x) AS t": None,
}


def _np_frame(t):
    return t.createDataFrame(pa.table({"k": [1, 2], "g": [1, 1]}))


# DataFrame / catalog call -> what its NotPortedError names
NOT_PORTED_CALLS = {
    "sample": (lambda t, df: df.sample(0.5), "sample"),
    "cache": (lambda t, df: df.cache(), "cache"),
    "persist": (lambda t, df: df.persist(), "cache"),
    "unpersist": (lambda t, df: df.unpersist(), "unpersist"),
    "mapInPandas": (lambda t, df: df.mapInPandas(None, None),
                    "mapInPandas"),
    "applyInPandas": (lambda t, df: df.groupBy("g").applyInPandas(None),
                      "applyInPandas"),
    "withWatermark": (lambda t, df: df.withWatermark("k", "1 second"),
                      "streaming"),
    "writeStream": (lambda t, df: df.writeStream, "streaming"),
    "isStreaming": (lambda t, df: df.isStreaming, "streaming"),
    "sampleBy": (lambda t, df: df.stat.sampleBy("g", {1: 0.5}), "sampleBy"),
    "cacheTable": (lambda t, df: t.catalog.cacheTable("np_t"),
                   "cacheTable"),
    "uncacheTable": (lambda t, df: t.catalog.uncacheTable("np_t"),
                     "uncacheTable"),
}


@pytest.mark.parametrize("stmt", list(NOT_PORTED_SQL))
def test_unported_statement_raises(pair, stmt):
    t = pair.torch
    _np_frame(t).createOrReplaceTempView("np_t")
    if NOT_PORTED_SQL[stmt] is None:
        _np_frame(pair.jax).createOrReplaceTempView("np_t")
        assert t.sql(stmt).toArrow().to_pylist() == \
            pair.jax.sql(stmt).toArrow().to_pylist()
        return
    with pytest.raises(NotPortedError) as err:
        df = t.sql(stmt)
        if df is not None:
            df.toArrow()
    assert NOT_PORTED_SQL[stmt].lower() in err.value.what.lower()
    item = err.value.what
    assert any(f"A{n}" in item for n in range(1, 20)) or \
        stmt.startswith(("SELECT", "SET")), item


def _stat_frame(s):
    import numpy as np

    rng = np.random.default_rng(17)
    x = rng.normal(size=500)
    return s.createDataFrame(pa.table({
        "x": x, "y": 0.5 * x + rng.normal(size=500),
        "k": rng.integers(0, 40, 500),
        "n": pa.array(rng.normal(size=500), mask=rng.random(500) < 0.2)}))


# DataFrame calls ported with A6 (coalesce) and A3 (stat.corr, stat.cov):
# call -> its value on one engine's frame
PORTED_CALLS = {
    "corr": lambda df: df.stat.corr("x", "y"),
    "corr_int": lambda df: df.stat.corr("k", "x"),
    "corr_nulls": lambda df: df.stat.corr("x", "n"),
    "cov": lambda df: df.stat.cov("x", "y"),
    "cov_int": lambda df: df.stat.cov("k", "y"),
    "coalesce_1": lambda df: sorted(
        tuple(r.values()) for r in df.repartition(4).coalesce(1)
        .toArrow().to_pylist()),
    "coalesce_3": lambda df: sorted(
        tuple(r.values()) for r in df.repartition(8, "k").coalesce(3)
        .groupBy("k").count().toArrow().to_pylist()),
    "coalesce_wider": lambda df: df.repartition(2).coalesce(6)
    .toArrow().num_rows,
}


@pytest.mark.parametrize("call", list(PORTED_CALLS))
def test_ported_call_matches_reference(pair, call):
    """stat.corr/cov (one corr or covar_samp aggregate) and coalesce(n)
    (CoalescePartitionsExec) equal the reference's: floats to relative
    1e-12, rows exactly; a coalesce keeps every row."""
    import math

    fn = PORTED_CALLS[call]
    got = fn(_stat_frame(pair.torch))
    want = fn(_stat_frame(pair.jax))
    if isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-12), (got, want)
    else:
        assert got == want
    if call.startswith("coalesce"):
        df = _stat_frame(pair.torch).repartition(4).coalesce(2)
        parts = df.query_execution.execute()
        assert len(parts) == 2
        assert sum(b.num_rows() for p in parts for b in p) == 500


@pytest.mark.parametrize("call", list(NOT_PORTED_CALLS))
def test_unported_call_raises(pair, call):
    t = pair.torch
    _np_frame(t).createOrReplaceTempView("np_t")
    fn, what = NOT_PORTED_CALLS[call]
    with pytest.raises(NotPortedError) as err:
        fn(t, _np_frame(t))
    assert what.lower() in err.value.what.lower()
    assert any(f"A{n}" in err.value.what for n in range(1, 20))
