"""A11's collections over A1's nested types in spark_tpu_torch against the
JAX package: arrays, maps and structs as dictionary-encoded columns, the
functions over them (luts over the dictionary's entries, transforms of
it, host constructors), subscripts and struct fields, and explode() as
GenerateExec.

  * Every case of tests/test_complex_types.py and tests/test_generate.py
    runs in both engines and the port's result equals the reference's
    (the array column of its collect_list too, since A3's slice).
  * The nested statements run at the port's operator tier against the
    reference, and at the stage tier (fused bodies watched for host reads
    and replayed) and the forced whole tier against the port's own
    operator tier (`tests/test_torch_types.py`'s harness).
  * A struct key groups and joins across tiles and partitions whose
    dictionaries differ (a key's hash is its canonical value's), held to
    the reference and to Python.
  * A decimal inside a struct or map built by a host constructor keeps
    its value (ROADMAP.md C15; the reference reads it as a float), held
    to Python.
  * `chip_smoke.py`'s types leg at scale 0.1: each statement's tier and
    reason at `auto` equal the reference's, and its result at the port's
    three tiers equals the leg's numpy oracle (`chip_smoke.types_oracle`).
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as TF  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401
from tests.test_torch_types import check_case, run_cases  # noqa: E402

CONF = {"spark.sql.shuffle.partitions": 4}


def nested_table() -> pa.Table:
    """tests/test_complex_types.py's `nested` fixture."""
    return pa.table({
        "id": [1, 2, 3],
        "person": pa.array(
            [{"name": "ann", "age": 31}, {"name": "bob", "age": 25}, None],
            pa.struct([("name", pa.string()), ("age", pa.int64())])),
        "tags": pa.array([[("x", 1), ("y", 2)], [("x", 9)], []],
                         pa.map_(pa.string(), pa.int64())),
    })


def _lines():
    return pa.table({"id": [1, 2, 3],
                     "line": ["the quick brown fox", "the lazy dog", "the"]})


def _ev():
    import datetime as dt

    return pa.table({
        "id": [1, 2],
        "ev": pa.array(
            [{"d": dt.date(2020, 1, 5), "ts": dt.datetime(2020, 1, 5, 12)},
             {"d": dt.date(2021, 3, 1), "ts": dt.datetime(2021, 3, 1, 8)}],
            pa.struct([("d", pa.date32()), ("ts", pa.timestamp("us"))])),
    })


def _views(s):
    s.createDataFrame(nested_table()).createOrReplaceTempView("ct_nested")
    s.createDataFrame(_lines()).createOrReplaceTempView("lines")
    s.createDataFrame(pa.table({"line": ["a b", None, "c"]})) \
        .createOrReplaceTempView("nl")
    s.createDataFrame(pa.table({"s": ["a,b;c", "x"]})) \
        .createOrReplaceTempView("rx")
    s.createDataFrame(_ev()).createOrReplaceTempView("ct_ev")
    s.createDataFrame(pa.table({"k": ["a", "a", "b"], "v": [1, 2, 3]})) \
        .createOrReplaceTempView("cl")
    s.createDataFrame(pa.table({"k": ["a", "b"], "l": pa.array(
        [[1, 2], [3]], pa.list_(pa.int64()))})).createOrReplaceTempView("cl2")


# the SQL of tests/test_complex_types.py and tests/test_generate.py
REFERENCE_SQL = {
    "struct_field_access_sql": "SELECT id, person.name, person.age FROM "
                               "ct_nested ORDER BY id",
    "struct_in_predicate": "SELECT id FROM ct_nested WHERE person.age > 28",
    "struct_groupby": "SELECT person.name AS nm, count(*) n FROM ct_nested "
                      "GROUP BY person.name ORDER BY nm NULLS FIRST",
    "named_struct_ctor": "SELECT named_struct('x', id, 'y', id * 2) ns "
                         "FROM ct_nested ORDER BY id",
    "struct_ctor": "SELECT struct(id, person.name) st FROM ct_nested "
                   "ORDER BY id LIMIT 1",
    "map_access": "SELECT id, tags['x'] x, element_at(tags, 'y') y "
                  "FROM ct_nested ORDER BY id",
    "map_functions": "SELECT map_keys(tags) mk, map_values(tags) mv, "
                     "size(tags) sz, map_contains_key(tags, 'y') hy "
                     "FROM ct_nested ORDER BY id",
    "map_ctor_roundtrip": "SELECT map('a', id, 'b', id + 1) m FROM "
                          "ct_nested ORDER BY id",
    "explode_map_keys": "SELECT id, explode(map_keys(tags)) k FROM "
                        "ct_nested ORDER BY id, k",
    "order_by_hidden_struct_field": "SELECT id FROM ct_nested ORDER BY "
                                    "person.age NULLS LAST, id",
    "struct_date_timestamp_fields": "SELECT id, ev.d, year(ev.d) y, "
                                    "hour(ev.ts) h FROM ct_ev ORDER BY id",
    "sql_wordcount": "SELECT word, count(*) AS n FROM (SELECT explode("
                     "split(line, ' ')) AS word FROM lines) GROUP BY word "
                     "ORDER BY n DESC, word",
    "explode_with_nulls": "SELECT explode(split(line, ' ')) AS w FROM nl",
    "explode_filter": "SELECT w FROM (SELECT explode(split(line, ' ')) AS w "
                      "FROM nl) WHERE w <> 'b'",
    "split_regex_delimiter": "SELECT explode(split(s, '[,;]')) AS p FROM rx",
    "explode_array_column": "SELECT k, explode(l) AS e FROM cl2 "
                            "ORDER BY k, e",
}


@pytest.fixture(scope="module")
def engines():
    j = TpuSession("nested-reference", dict(CONF))
    t = TorchSession("nested", dict(CONF), device="cpu")
    for s in (j, t):
        _views(s)
    yield j, t
    j.stop()
    t.stop()


def _table_rows(tb):
    return [tuple(r.values()) for r in tb.to_pylist()]


@pytest.mark.parametrize("name", list(REFERENCE_SQL))
def test_reference_case_matches(engines, name):
    j, t = engines
    text = REFERENCE_SQL[name]
    want = _table_rows(j.sql(text).toArrow())
    got = _table_rows(t.sql(text).toArrow())
    if "ORDER BY" not in text:
        want, got = sorted(want, key=repr), sorted(got, key=repr)
    assert got == want


def test_explode_of_collect_list_is_a3(engines):
    """test_generate.py's array column comes from collect_list, an A3
    aggregate the port runs since its slice: the port's rows equal the
    reference's, and those of the Arrow array column above
    (`explode_array_column`)."""
    j, t = engines
    text = ("SELECT k, explode(l) AS e FROM (SELECT k, collect_list(v) AS l "
            "FROM cl GROUP BY k) ORDER BY k, e")
    want = _table_rows(j.sql(text).toArrow())
    assert want == \
        _table_rows(t.sql(REFERENCE_SQL["explode_array_column"]).toArrow())
    assert _table_rows(t.sql(text).toArrow()) == want


def _df_case(F, s, name):
    nested = s.table("ct_nested")
    lines = s.table("lines")
    if name == "getField":
        return nested.select(nested["id"], nested["person"].getField("age")
                             .alias("a")).orderBy("id")
    if name == "getItem":
        return nested.select(F.col("tags")["x"].alias("x"))
    if name == "explode_keeps_other_columns":
        return lines.select(lines["id"], F.explode(F.split(lines["line"],
                                                           " ")).alias("w"))
    if name == "shuffle_roundtrip":
        return nested.repartition(3).select("id", "person").orderBy("id")
    raise KeyError(name)


@pytest.mark.parametrize("name", ["getField", "getItem",
                                  "explode_keeps_other_columns",
                                  "shuffle_roundtrip"])
def test_reference_dataframe_case_matches(engines, name):
    j, t = engines
    want = _table_rows(_df_case(JF, j, name).toArrow())
    got = _table_rows(_df_case(TF, t, name).toArrow())
    assert sorted(got, key=repr) == sorted(want, key=repr)


def test_nonliteral_map_key_raises_in_both(engines):
    from spark_tpu.errors import AnalysisException as JAE
    from spark_tpu_torch.errors import AnalysisException as TAE

    j, t = engines
    with pytest.raises(JAE, match="literal key"):
        j.sql("SELECT tags[id] FROM ct_nested").toArrow()
    with pytest.raises(TAE, match="literal key"):
        t.sql("SELECT tags[id] FROM ct_nested").toArrow()


def test_map_key_order_insensitive_groupby(engines):
    """{'x':1,'y':2} and {'y':2,'x':1} are one map value."""
    j, t = engines
    t1 = pa.table({"m": pa.array([[("x", 1), ("y", 2)]],
                                 pa.map_(pa.string(), pa.int64()))})
    t2 = pa.table({"m": pa.array([[("y", 2), ("x", 1)]],
                                 pa.map_(pa.string(), pa.int64()))})
    outs = []
    for s, F in ((j, JF), (t, TF)):
        df = s.createDataFrame(t1).union(s.createDataFrame(t2))
        outs.append(df.groupBy("m").agg(F.count("*").alias("n")).toArrow()
                    .to_pydict())
    assert outs[1]["n"] == outs[0]["n"] == [2]
    assert sorted(outs[1]["m"][0]) == [("x", 1), ("y", 2)]


# --- the nested statements at the three tiers --------------------------------

def _nested_tables() -> dict:
    rng = np.random.default_rng(31)
    n = 1500
    words = ["a", "b", "cc", "d e", "", None]
    st = pa.struct([("k", pa.int64()), ("w", pa.string())])
    return {"nt": pa.table({
        "id": np.arange(n, dtype=np.int64),
        "arr": pa.array([None if rng.random() < 0.08 else
                         [int(v) for v in rng.integers(-3, 9,
                                                       rng.integers(0, 5))]
                         for _ in range(n)], pa.list_(pa.int64())),
        "st": pa.array([None if rng.random() < 0.08 else
                        {"k": int(rng.integers(0, 6)),
                         "w": words[int(rng.integers(0, len(words)))]}
                        for _ in range(n)], st),
        "mp": pa.array([[(k, int(rng.integers(-5, 5))) for k in "pqr"
                         if rng.random() < 0.6] for _ in range(n)],
                       pa.map_(pa.string(), pa.int64())),
        "line": pa.array([" ".join(str(w) for w in rng.choice(
            ["x", "y", "zz", "w"], rng.integers(1, 4))) for _ in range(n)],
            mask=rng.random(n) < 0.05),
    })}


NESTED_CASES = {
    "luts": "SELECT id, size(arr) a, element_at(arr, 2) b, arr[1] c, "
            "array_contains(arr, 3) d, array_max(arr) e, st.k f, st.w g, "
            "mp['p'] h, map_contains_key(mp, 'q') i, "
            "array_position(arr, 0) j FROM nt",
    "transforms": "SELECT id, sort_array(array_compact(arr)) a, "
                  "array_distinct(arr) b, slice(arr, 1, 2) c, "
                  "map_keys(mp) d, array_sort(arr) e, "
                  "array_join(split(line, ' '), '-') f FROM nt",
    "group_struct": "SELECT st, count(*) n, sum(id) si FROM nt GROUP BY st",
    "group_array": "SELECT arr, count(*) n FROM nt GROUP BY arr",
    "group_field": "SELECT st.k k, count(*) n, max(size(arr)) m FROM nt "
                   "GROUP BY st.k",
    "filter_field": "SELECT id FROM nt WHERE st.k > 2 AND size(arr) >= 2",
    "explode": "SELECT id, explode(arr) e FROM nt",
    "explode_split": "SELECT w, count(*) n FROM (SELECT explode(split("
                     "line, ' ')) w FROM nt) x GROUP BY w",
    "ctor": "SELECT id, named_struct('i', id, 'k', st.k) a, "
            "array(id, size(arr)) b FROM nt",
    "order_struct_field": "SELECT id, st.w FROM nt ORDER BY st.k NULLS "
                          "FIRST, id LIMIT 40",
}


@pytest.fixture(scope="module")
def tier_results():
    return run_cases(NESTED_CASES, _nested_tables, {"order_struct_field"})


@pytest.mark.parametrize("name", list(NESTED_CASES))
def test_nested_case_at_every_tier(tier_results, name):
    check_case(tier_results, name)


def test_nested_fused_bodies_read_nothing_on_the_host(tier_results):
    assert tier_results["replayed"] > 0
    assert tier_results["syncs"] == []


# --- keys across dictionaries and partitions ---------------------------------

def test_struct_key_across_partitions_with_different_dictionaries():
    """Two sources whose struct dictionaries hold the same values in other
    orders, read in tiles of 1,024 rows and spread over 4 partitions: each
    key is one group and joins as one key, equal to the reference and to
    Python."""
    rng = np.random.default_rng(9)
    st = pa.struct([("a", pa.int64()), ("b", pa.string())])
    a = rng.integers(0, 40, 5000)
    b = rng.integers(0, 3, 5000)
    vals = [{"a": int(x), "b": "xyz"[y]} for x, y in zip(a, b)]
    t1 = pa.table({"s": pa.array(vals, st), "v": np.arange(5000)})
    t2 = pa.table({"s": pa.array(vals[::-1], st), "v": np.arange(5000)})
    conf = dict(CONF, **{"spark.tpu.batch.capacity": 1 << 10})
    outs = []
    for S, F in ((TpuSession, JF), (TorchSession, TF)):
        s = S("keys", conf) if S is TpuSession else S("keys", conf,
                                                       device="cpu")
        d1, d2 = s.createDataFrame(t1), s.createDataFrame(t2)
        g = d1.union(d2).repartition(4).groupBy("s").agg(
            F.count("*").alias("n"), F.sum("v").alias("sv")).toArrow()
        d1.createOrReplaceTempView("k1")
        d2.createOrReplaceTempView("k2")
        jn = s.sql("SELECT count(*) c FROM (SELECT DISTINCT s FROM k1) x "
                   "JOIN k2 ON x.s = k2.s").toArrow().to_pylist()
        outs.append((sorted(_table_rows(g), key=repr), jn))
        s.stop()
    want: dict = {}
    for tb in (t1, t2):
        for sv, v in zip(tb.column("s").to_pylist(),
                         tb.column("v").to_pylist()):
            key = tuple(sv.items())
            n, tot = want.get(key, (0, 0))
            want[key] = (n + 1, tot + v)
    got = {tuple(r[0].items()): (r[1], r[2]) for r in outs[1][0]}
    assert got == want
    assert outs[1] == outs[0]
    assert outs[1][1] == [{"c": 5000}]


def test_decimal_inside_a_host_built_map_keeps_its_value():
    """C15: named_struct() and map() run on the host, where a decimal
    argument arrives as a float; the port stores the Decimal its type
    says, so a field or value reads back exactly and the column collects.
    The reference keeps the float: 119.90 reads back as 1.19 and the map
    does not collect (held to Python here)."""
    t = TorchSession("c15", dict(CONF), device="cpu")
    t.createDataFrame(pa.table({"c": ["Music", "Books"], "p": pa.array(
        [decimal.Decimal("119.90"), decimal.Decimal("3.10")],
        pa.decimal128(7, 2))})).createOrReplaceTempView("pr")
    got = t.sql("SELECT map(c, p)['Music'] v, named_struct('p', p).p w, "
                "map(c, p) m FROM pr").toArrow().to_pylist()
    t.stop()
    assert got == [
        {"v": decimal.Decimal("119.90"), "w": decimal.Decimal("119.90"),
         "m": [("Music", decimal.Decimal("119.90"))]},
        {"v": None, "w": decimal.Decimal("3.10"),
         "m": [("Books", decimal.Decimal("3.10"))]}]


# --- chip_smoke.py's types leg at scale 0.1 ----------------------------------

TIER = "spark.tpu.compile.tier"
LEG_TABLES = ("store_sales", "date_dim", "time_dim", "customer_address",
              "item")


@pytest.fixture(scope="module")
def leg():
    import chip_smoke as cs

    tables, _ = cs.tpcds_data(scale=0.1)
    tables = {n: tables[n] for n in LEG_TABLES}
    j = TpuSession("types-leg", dict(cs.TPCDS_CONF, **{
        "spark.tpu.fusion.enabled": "true", TIER: "operator"}))
    t = TorchSession("types-leg", dict(cs.TPCDS_CONF, **{TIER: "operator"}),
                     device="cpu")
    for s in (j, t):
        for name, tb in tables.items():
            s.createDataFrame(tb).createOrReplaceTempView(name)
    # the reference's CTAS of item_nested fails on its decimal map values
    # (C15): it reads the port's table
    for name, text in cs.TYPES_TABLES.items():
        t.sql(text)
        j.createDataFrame(t.table(name).toArrow()) \
            .createOrReplaceTempView(name)
    yield cs, tables, j, t
    j.stop()
    t.stop()


def _leg_decision(session, text):
    session.conf.set(TIER, "operator")
    optimized = session.sql(text).query_execution.optimized
    try:
        session.conf.set(TIER, "auto")
        phys = session._planner().plan(optimized)
        d = getattr(phys, "decision", None) or phys._tier_decision
        return type(phys).__name__ == "WholeQueryExec", d.tier, d.reason
    finally:
        session.conf.set(TIER, "operator")


@pytest.mark.parametrize("name", ["events", "events_window", "words",
                                  "word_arrays", "structs", "item_nested"])
def test_types_leg_statement(leg, name):
    """The leg's statement: its `auto` tier and reason equal the
    reference's, and its result at the operator, stage and forced whole
    tiers equals the leg's numpy oracle."""
    cs, tables, j, t = leg
    text = cs.TYPES_QUERIES[name]
    assert _leg_decision(t, text) == _leg_decision(j, text)
    want = cs.types_oracle(name, tables)
    failures = []
    saved = cs.fail
    cs.fail = failures.append
    try:
        for tier in ("operator", "stage", "whole"):
            t.conf.set(TIER, tier)
            cs.types_check(name, t.sql(text).toArrow(), want)
    finally:
        cs.fail = saved
        t.conf.set(TIER, "operator")
    assert not failures, failures[:3]


def test_create_from_rows_and_pandas_and_show(engines, capsys):
    """createDataFrame from rows and from pandas holding timestamps,
    lists, dicts and bytes reads what Arrow infers, in both engines; show
    renders them as the reference does."""
    import datetime as dt

    pd = pytest.importorskip("pandas")
    j, t = engines
    rows = [{"ts": dt.datetime(1969, 7, 20, 20, 17, 40), "l": [1, 2],
             "m": {"a": 1}, "b": b"\x00x"},
            {"ts": None, "l": [], "m": {}, "b": None}]
    frame = pd.DataFrame({"ts": pd.to_datetime(["2020-01-01 12:00:01",
                                                "1950-06-01 00:00:00"]),
                          "l": [[1.5], [2.5, None]]})
    for data in (rows, frame):
        want = j.createDataFrame(data).toArrow().to_pylist()
        got = t.createDataFrame(data).toArrow().to_pylist()
        assert got == want
    j.createDataFrame(rows).show()
    shown_ref = capsys.readouterr().out
    t.createDataFrame(rows).show()
    assert capsys.readouterr().out == shown_ref


def test_sort_array_places_null_elements_where_the_reference_raises():
    """C16: sort_array over an array that holds NULL elements puts them
    first when ascending and last when descending, held to Python; the
    reference's sorted() compares None with the values and raises."""
    t = pa.table({"ws": pa.array([["b", None, "a"], None, [], [None],
                                  ["c", "a"]], pa.list_(pa.string())),
                  "xs": pa.array([[3, None, 1], None, [], [None], [2, -2]],
                                 pa.list_(pa.int64()))})
    s = TorchSession("c16", dict(CONF), device="cpu")
    s.createDataFrame(t).createOrReplaceTempView("a")
    got = s.sql("SELECT sort_array(ws) wa, sort_array(ws, false) wd, "
                "sort_array(xs) xa, sort_array(xs, false) xd FROM a") \
        .toArrow().to_pylist()
    s.stop()

    def plain(lst, asc):
        if lst is None:
            return None
        vals = sorted((v for v in lst if v is not None), reverse=not asc)
        nulls = [None] * (len(lst) - len(vals))
        return nulls + vals if asc else vals + nulls

    assert got == [{"wa": plain(w, True), "wd": plain(w, False),
                    "xa": plain(x, True), "xd": plain(x, False)}
                   for w, x in zip(t.column("ws").to_pylist(),
                                   t.column("xs").to_pylist())]
    assert got[0] == {"wa": [None, "a", "b"], "wd": ["b", "a", None],
                      "xa": [None, 1, 3], "xd": [3, 1, None]}
    j = TpuSession("c16", dict(CONF))
    try:
        j.createDataFrame(t).createOrReplaceTempView("a")
        with pytest.raises(TypeError):
            j.sql("SELECT sort_array(ws) wa FROM a").toArrow()
    finally:
        j.stop()
