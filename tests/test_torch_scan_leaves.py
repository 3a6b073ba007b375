"""The scan leaves of the port against the JAX package: spark.range
(RangeExec), SELECT without FROM (OneRowRelation), and TPC-DS q3, q7 and
q19 read from Parquet files (ScanExec over ParquetSource) written by
`chip_smoke.tpcds_parquet`, the generator of the card's parquet leg, at a
small scale. Each engine reads the same files (TpuSession
operator-at-a-time, fusion off; TorchSession on the CPU):

  * the analysed and optimised trees print the same (expression ids
    renumbered) and the physical plans hold the same operator sequence;
  * planned at the card's row counts, `chip_smoke.PARQUET_ROWS` (each
    source reports them as its estimate), both engines plan the card's
    `PARQUET_PLAN_OPS`, each scan reading the columns of
    `PARQUET_SCAN_COLS`. There the port merges the partials of an aggregate
    the reference plans as one pass over a split input (a shuffled join
    over one-split scans); the reference is right there only while AQE
    coalesces the join's partitions back into one, which the last test
    shows;
  * results equal the reference's and the generator's numpy oracle
    exactly (integers, strings, decimals; q7's avg of an integer is one
    float64 division in each engine and in numpy);
  * the DPP query of the card's leg over a small date-partitioned table,
    whose date_dim the port's partitioned writer wrote: the reference marks
    the scan as a DPP target, both prune the same splits and read the same
    rows, and the static partition and row-group predicates read exactly
    the rows the oracle expects."""

import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as TF  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401
from tests.test_torch_tpcds_slice import (  # noqa: E402
    _chip_smoke, _ops, _reference_ops, _renumber,
)

# the port side pinned to the operator tier, as the reference side is:
# these tests hold operator-at-a-time execution (tests/test_torch_fusion.py
# holds the stage tier)
CONF = {"spark.sql.shuffle.partitions": 4,
        "spark.tpu.batch.capacity": 1 << 12,
        "spark.tpu.compile.tier": "operator"}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator"})
SCALE = 0.002           # 57,601 store_sales lines
CHUNK = 15_000          # store_sales lines per file: 4 files
ROW_GROUP = 1 << 15
DPP_ROWS = 200_000


def _sessions(conf=None, sized_conf=False, stage=False):
    """(reference, port) sessions at the operator tier, or both at the
    stage tier where `stage` (sized: the card's parquet leg, whose DPP
    path runs pinned to the stage tier)."""
    cs = _chip_smoke()
    base = dict(cs.PARQUET_CONF if stage else cs.TPCDS_CONF) if sized_conf \
        else dict(CONF)
    base.update(conf or {})
    tier = {"spark.tpu.fusion.enabled": "true",
            "spark.tpu.compile.tier": "stage"} if stage \
        else {"spark.tpu.fusion.enabled": "false",
              "spark.tpu.compile.tier": "operator"}
    j = TpuSession("scan-leaves-reference", dict(base, **tier))
    t = TorchSession("scan-leaves", dict(
        base, **{"spark.tpu.compile.tier": tier["spark.tpu.compile.tier"]}),
        device="cpu")
    return j, t


@pytest.fixture(scope="module")
def sessions():
    j, t = _sessions()
    yield j, t
    j.stop()
    t.stop()


@pytest.fixture(scope="module")
def parquet(tmp_path_factory):
    cs = _chip_smoke()
    d = str(tmp_path_factory.mktemp("tpcds_parquet"))
    oracle = cs.tpcds_parquet(d, scale=SCALE, chunk=CHUNK,
                              row_group=ROW_GROUP, dpp_rows=DPP_ROWS)
    return cs, d, oracle


# --------------------------------------------------------------------------
# spark.range
# --------------------------------------------------------------------------

RANGES = {
    "positive": (0, 1000, 7, 3),
    "negative": (10, -200, -3, 4),
    "empty": (5, 5, 1, 2),
    "backwards_empty": (5, 0, 1, 2),
    "one_arg": (1234, None, 1, None),
    "default_partitions": (3, 10_000, 1, None),
    "more_partitions_than_rows": (0, 5, 1, 8),
    "multi_tile": (-50_000, 50_000, 3, 2),
}


@pytest.mark.parametrize("case", list(RANGES))
def test_range(sessions, case):
    start, end, step, parts = RANGES[case]
    got = {}
    for s in sessions:
        df = s.range(start, end, step, parts) if end is not None \
            else s.range(start)
        got[type(s).__name__] = (df.toArrow().column("id").to_pylist(),
                                 _ops(df))
    ids, ops = got["TorchSession"]
    assert got["TorchSession"] == got["TpuSession"]
    want = list(range(start, end, step)) if end is not None \
        else list(range(start))
    assert ids == want
    assert ops == ["RangeExec"]
    t = sessions[1]
    df = t.range(start, end, step, parts) if end is not None \
        else t.range(start)
    assert df.query_execution.physical.output_partitioning() \
        .num_partitions == (parts or 8)


@pytest.mark.parametrize("case", ["positive", "negative", "multi_tile",
                                  "empty"])
def test_range_aggregates_match_closed_forms(sessions, case):
    start, end, step, parts = RANGES[case]
    out = []
    for s, F in zip(sessions, (JF, TF)):
        df = s.range(start, end, step, parts).agg(
            F.sum("id").alias("s"), F.count("*").alias("n"),
            F.min("id").alias("lo"), F.max("id").alias("hi"))
        out.append(df.toArrow().to_pylist())
    assert out[1] == out[0]
    ids = list(range(start, end, step))
    assert out[1] == [{"s": sum(ids) if ids else None, "n": len(ids),
                       "lo": min(ids, default=None),
                       "hi": max(ids, default=None)}]


def test_range_joins_and_filters(sessions):
    out = []
    for s, F in zip(sessions, (JF, TF)):
        a = s.range(0, 3000, 1, 4)
        b = s.range(0, 3000, 3, 2).withColumn("w", F.col("id") * 2)
        df = a.join(b, "id").filter(F.col("w") > 100).groupBy() \
            .agg(F.count("*").alias("n"), F.sum("w").alias("sw"))
        out.append(df.toArrow().to_pylist())
    kept = [2 * i for i in range(0, 3000, 3) if 2 * i > 100]
    assert out[1] == out[0] == [{"n": len(kept), "sw": sum(kept)}]


# --------------------------------------------------------------------------
# SELECT without FROM
# --------------------------------------------------------------------------

NO_FROM = {
    "literals": "SELECT 1 + 1 AS two, 'x' AS s",
    "arithmetic": "SELECT 2 * 3 - 1 AS five, 7 / 2 AS half, -4 AS neg",
    "case": "SELECT CASE WHEN 1 < 2 THEN 'yes' ELSE 'no' END AS c",
    "date": "SELECT DATE '2000-03-01' + INTERVAL 1 DAY AS d",
    "where_false": "SELECT 1 AS one WHERE 1 = 0",
    "union": "SELECT 1 AS a UNION ALL SELECT 2 AS a",
    "in_subquery": "SELECT k FROM t WHERE k IN (SELECT 3 AS x)",
}


@pytest.mark.parametrize("case", list(NO_FROM))
def test_select_without_from(sessions, case):
    out = []
    for s in sessions:
        s.createDataFrame(pa.table({"k": [1, 2, 3, 3]})) \
            .createOrReplaceTempView("t")
        df = s.sql(NO_FROM[case])
        out.append((df.toArrow().to_pylist(),
                    _renumber(df.query_execution.optimized.tree_string())))
    assert out[1] == out[0]
    if case == "literals":
        assert out[1][0] == [{"two": 2, "s": "x"}]
    if case == "where_false":
        assert out[1][0] == []


# --------------------------------------------------------------------------
# TPC-DS q3, q7 and q19 from Parquet
# --------------------------------------------------------------------------

def _views(session, cs, d, sized: bool) -> None:
    for name in cs.PARQUET_ROWS:
        df = session.read.parquet(os.path.join(d, name))
        if sized:
            df.plan.source.estimated_rows = cs.PARQUET_ROWS[name]
        df.createOrReplaceTempView(name)


def _scan_cols(df) -> list:
    out = []
    df.query_execution.physical.foreach(
        lambda n: out.append((n.name, tuple(a.name for a in n.attrs)))
        if type(n).__name__ == "ScanExec" else None)
    return sorted(out)


def _no_limit(cs, q: str) -> str:
    return re.sub(r"LIMIT\s+100\s*$", "", cs.tpcds_text(q).strip())


@pytest.fixture(scope="module")
def parquet_pairs(parquet):
    cs, d, _ = parquet
    pairs = {}
    for sized in (False, True, "stage"):
        j, t = _sessions(sized_conf=bool(sized), stage=sized == "stage")
        _views(j, cs, d, bool(sized))
        _views(t, cs, d, bool(sized))
        pairs[sized] = (j, t)
    yield pairs
    for j, t in pairs.values():
        j.stop()
        t.stop()


@pytest.mark.parametrize("q", ["q3", "q7", "q19"])
def test_parquet_plans_match_reference(parquet, parquet_pairs, q):
    cs, _, _ = parquet
    j, t = parquet_pairs[False]
    jd, td = j.sql(cs.tpcds_text(q)), t.sql(cs.tpcds_text(q))
    for phase in ("analyzed", "optimized"):
        assert _renumber(getattr(td.query_execution, phase).tree_string()) \
            == _renumber(getattr(jd.query_execution, phase).tree_string())
    assert _ops(td) == _reference_ops(jd)
    assert _scan_cols(td) == _scan_cols(jd)


@pytest.mark.parametrize("q", ["q3", "q7", "q19"])
def test_parquet_card_plans_match_chip_smoke(parquet, parquet_pairs, q):
    # the card's parquet leg runs at the default tier, `auto`, whose whole
    # programs hold this stage plan inside: both engines plan it at the
    # stage tier
    cs, d, _ = parquet
    j, t = parquet_pairs["stage"]
    jd, td = j.sql(cs.tpcds_text(q)), t.sql(cs.tpcds_text(q))
    assert _ops(td) == _reference_ops(jd)
    assert tuple(_ops(td)) == cs.PARQUET_PLAN_OPS[q]
    assert _scan_cols(td) == _scan_cols(jd) == sorted(
        cs.PARQUET_SCAN_COLS[q])


@pytest.mark.parametrize("q", ["q3", "q7", "q19"])
@pytest.mark.parametrize("sized", [False, True])
def test_parquet_results_match_reference_and_oracle(parquet, parquet_pairs,
                                                    q, sized):
    cs, _, oracle = parquet
    j, t = parquet_pairs[sized]
    text = _no_limit(cs, q)
    got = cs.tpcds_rows(q, t.sql(text).toArrow())
    assert sorted(got) == sorted(tuple(r) for r in oracle[q])
    assert len(got) > 0
    if not sized:
        # at the card's plan the reference's one-pass aggregate is right
        # only while AQE coalesces (see the last test)
        assert sorted(cs.tpcds_rows(q, j.sql(text).toArrow())) == \
            sorted(got)
    # with LIMIT: the first 100 in ORDER BY order
    top = cs.tpcds_rows(q, t.sql(cs.tpcds_text(q)).toArrow())
    key = cs.PARQUET_ORACLE_KEYS[q]
    assert [key(r) for r in top] == sorted(key(tuple(r))
                                           for r in oracle[q])[:100]


def test_parquet_split_counts_and_rows_read(parquet):
    """One partition per split: a split is a run of a file's row groups of
    up to 128 MiB, so each of the fact table's small files is one, and
    each dimension is one; each scan reads every row of its table (no
    predicate prunes here)."""
    cs, d, oracle = parquet
    s = TorchSession("splits", dict(CONF), device="cpu")
    try:
        _views(s, cs, d, False)
        df = s.sql(cs.tpcds_text("q7"))
        scans = {}
        df.query_execution.physical.foreach(
            lambda n: scans.__setitem__(n.name, n)
            if type(n).__name__ == "ScanExec" else None)
        files = os.listdir(os.path.join(d, "store_sales"))
        assert len(files) == oracle["store_sales_files"] == 4
        assert {n: p.output_partitioning().num_partitions
                for n, p in scans.items()} == {
            "store_sales": 4, "date_dim": 1, "item": 1,
            "customer_demographics": 1, "promotion": 1}
        df.toArrow()
        # d_year = 2000 prunes date_dim's row groups (the table is in date
        # order): only the group that holds 2000 is read
        days = np.datetime64("1900-01-02") + np.arange(
            oracle["rows"]["date_dim"])
        years = days.astype("datetime64[Y]").astype(np.int64) + 1970
        groups = np.arange(len(years)) // ROW_GROUP
        want = dict(oracle["rows"], date_dim=int(np.isin(
            groups, np.unique(groups[years == 2000])).sum()))
        for n in scans:
            assert s.metrics[f"scan.{n}.rows"] == want[n], n
        assert want["date_dim"] < oracle["rows"]["date_dim"]
    finally:
        s.stop()


# --------------------------------------------------------------------------
# dynamic partition pruning and static pruning
# --------------------------------------------------------------------------



def _dpp_views(s, cs, d, date_dim_dir):
    s.read.parquet(os.path.join(d, "dpp", "store_sales")) \
        .createOrReplaceTempView("store_sales")
    s.read.parquet(os.path.join(d, "dpp", "store_sales_sorted.parquet")) \
        .createOrReplaceTempView("store_sales_sorted")
    s.read.parquet(date_dim_dir).createOrReplaceTempView("date_dim")


def _metrics(s) -> dict:
    m = s._metrics.snapshot()["counters"] if isinstance(s, TpuSession) \
        else s.metrics
    return dict(m)


def _delta(after, before) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k.startswith("scan.") and v != before.get(k, 0)}


@pytest.fixture(scope="module")
def dpp(parquet, tmp_path_factory):
    """The port writes date_dim partitioned by d_year; it reads back equal
    to the generator's file."""
    cs, d, oracle = parquet
    out = str(tmp_path_factory.mktemp("dpp") / "date_dim")
    t = TorchSession("dpp-writer", dict(CONF), device="cpu")
    t.read.parquet(os.path.join(d, "date_dim")).write.partitionBy("d_year") \
        .parquet(out)
    back = t.read.parquet(out).toArrow()
    t.stop()
    src = pq.read_table(os.path.join(d, "date_dim"))
    assert back.select(src.column_names).sort_by("d_date_sk").equals(
        src.sort_by("d_date_sk"))
    assert len(os.listdir(out)) == 201 + 1      # 1900-2100 and _SUCCESS
    return cs, d, oracle, out


def _dpp_run(dpp, query, conf=None):
    cs, d, oracle, dd = dpp
    j, t = _sessions(conf)
    out = {}
    try:
        for s in (j, t):
            _dpp_views(s, cs, d, dd)
            df = s.sql(query)
            before = _metrics(s)
            raw = df.toArrow().to_pylist()
            out[type(s).__name__] = (sorted(map(str, raw)),
                                     _delta(_metrics(s), before), df, raw)
    finally:
        j.stop()
        t.stop()
    (jr, jm, jd, _), (tr, tm, td, raw) = out["TpuSession"], \
        out["TorchSession"]
    assert tr == jr and tm == jm
    return tr, tm, td, jd, raw


@pytest.fixture(scope="module")
def dpp_on(dpp):
    return _dpp_run(dpp, dpp[0].DPP_QUERY)


def test_dpp_plan_and_pruning(dpp, dpp_on):
    cs, _, oracle, _ = dpp
    rows, m, td, jd, _ = dpp_on
    assert _ops(td) == _ops(jd)
    # the card's DPP path runs pinned to the stage tier (a whole program
    # would prune nothing, in the reference too): both engines plan the
    # query at the stage tier there
    j, t = _sessions(stage=True)
    try:
        for s in (j, t):
            _dpp_views(s, cs, dpp[1], dpp[3])
        assert _ops(t.sql(cs.DPP_QUERY)) == _ops(j.sql(cs.DPP_QUERY)) \
            == list(cs.DPP_PLAN_OPS)
    finally:
        j.stop()
        t.stop()
    marks = []
    for df in (jd, td):
        df.query_execution.physical.foreach(
            lambda n: marks.append(len(n.dpp_targets))
            if type(n).__name__ == "HashJoinExec" else None)
    assert marks == [1, 1]
    splits = oracle["dpp_dates"] + 1
    assert m["scan.dpp_pruned_splits"] == splits - \
        oracle["dpp_november_dates"]
    assert m["scan.store_sales.rows"] == oracle["dpp_rows"]


def test_dpp_result_equals_oracle(dpp, dpp_on):
    cs, _, oracle, _ = dpp
    got = sorted((r["d_year"], cs._dec(r["s"])) for r in dpp_on[4])
    assert got == sorted(tuple(r) for r in oracle["dpp"])
    assert len(got) == 5        # 1998-2002


def test_dpp_disabled_same_answer(dpp, dpp_on):
    cs, _, oracle, _ = dpp
    off, m_off, _, _, _ = _dpp_run(
        dpp, cs.DPP_QUERY,
        conf={"spark.sql.dynamicPartitionPruning.enabled": "false"})
    assert off == dpp_on[0]
    assert m_off.get("scan.dpp_pruned_splits", 0) == 0
    assert m_off["scan.store_sales.rows"] == DPP_ROWS


def test_static_partition_predicate_reads_the_range(dpp):
    _, _, oracle, _ = dpp
    a, b = oracle["between"]
    rows, m, _, _, _ = _dpp_run(
        dpp, f"SELECT count(*) c FROM store_sales WHERE ss_sold_date_sk "
             f"BETWEEN {a} AND {b}")
    assert rows == [str({"c": oracle["between_rows"]})]
    assert m["scan.store_sales.rows"] == oracle["between_rows"]


def test_rowgroup_predicate_reads_the_row_groups(dpp):
    _, _, oracle, _ = dpp
    key = oracle["rowgroup_key"]
    rows, m, _, _, _ = _dpp_run(
        dpp, f"SELECT count(*) c FROM store_sales_sorted WHERE "
             f"ss_sold_date_sk >= {key}")
    assert rows == [str({"c": oracle["rowgroup_match"]})]
    assert m["scan.store_sales_sorted.parquet.rows"] == \
        oracle["rowgroup_rows"] < DPP_ROWS


def test_one_pass_aggregate_over_a_split_input(parquet):
    """Why the card's plans merge partials: planned at its row counts,
    q7's aggregate reads a shuffled join over one-split scans. With AQE off
    (on the card the join's partitions are too large to coalesce into one
    and its store_sales build too large to turn into a broadcast), the
    reference's one pass returns a group once per partition that holds it;
    the port's merge returns the oracle's rows."""
    cs, d, oracle = parquet
    j, t = _sessions({"spark.sql.adaptive.enabled": "false"},
                     sized_conf=True)
    try:
        _views(j, cs, d, True)
        _views(t, cs, d, True)
        text = _no_limit(cs, "q7")
        want = sorted(tuple(r) for r in oracle["q7"])
        assert sorted(cs.tpcds_rows("q7", t.sql(text).toArrow())) == want
        ref = cs.tpcds_rows("q7", j.sql(text).toArrow())
        assert len(ref) > len(want)
        assert sorted(set(r[0] for r in ref)) == sorted(r[0] for r in want)
    finally:
        j.stop()
        t.stop()
