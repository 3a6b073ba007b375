"""Joins, sorts and limits end to end: the same DataFrame queries through
TpuSession (the JAX reference, operator-at-a-time: fusion off, compile tier
operator) and TorchSession(device="cpu"), on the same numpy-seeded Arrow
tables of about 6000 rows, with 2^12-row tiles and 4 shuffle partitions.
The first five cases are the chip smoke test's legs at a small size. An
ORDER BY result compares row by row in order; any other compares with row
order ignored. Integers and nulls compare exactly, floats to relative
1e-12. The physical plans must hold the same operator sequence."""

import math

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

# the port side pinned to the operator tier, as the reference side is:
# these tests hold operator-at-a-time execution (tests/test_torch_fusion.py
# holds the stage tier)
CONF = {"spark.sql.shuffle.partitions": 4,
        "spark.tpu.batch.capacity": 1 << 12,
        "spark.tpu.compile.tier": "operator"}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator"})
# a build side of a few hundred rows would be broadcast; this threshold
# keeps the q78 shape's join shuffled, as its full size is
SHUFFLED = {"spark.sql.autoBroadcastJoinThreshold": 1024}
N = 6000
DATE0 = 2450816
DATES = 73049


@pytest.fixture(scope="module")
def sessions():
    made = {}

    def get(extra=()):
        key = tuple(sorted(dict(extra).items()))
        if key not in made:
            made[key] = (TpuSession("join-sort-reference",
                                    dict(JAX_CONF, **dict(extra))),
                         TorchSession("join-sort", dict(CONF, **dict(extra)),
                                      device="cpu"))
        return made[key]

    yield get
    for j, t in made.values():
        j.stop()
        t.stop()


def _store_sales(seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({
        "ss_sold_date_sk": rng.integers(DATE0, DATE0 + DATES, N),
        "ss_ext_sales_price": rng.random(N)})


def _date_dim():
    sk = np.arange(DATE0, DATE0 + DATES)
    return pa.table({"d_date_sk": sk, "d_year": 1998 + (sk - DATE0) // 365})


def _main(seed=42, nulls=False):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 500, N)
    v = rng.integers(0, 1000, N)
    if not nulls:
        return pa.table({"k": k, "v": v})
    return pa.table({"k": pa.array(rng.integers(-1000, 1000, N),
                                   mask=rng.random(N) < 0.1),
                     "v": pa.array(v, mask=rng.random(N) < 0.05)})


def _q78_tables(seed=11):
    rng = np.random.default_rng(seed)
    ticket = np.arange(N) // 10
    item = rng.integers(1, 300, N)
    sales = pa.table({"ss_ticket_number": ticket, "ss_item_sk": item,
                      "ss_store_sk": rng.integers(1, 11, N),
                      "ss_net_paid": rng.random(N) * 100})
    idx = rng.choice(N, N // 10, replace=False)
    returns = pa.table({"sr_ticket_number": ticket[idx],
                        "sr_item_sk": item[idx],
                        "sr_return_amt": rng.random(N // 10) * 50})
    return sales, returns


def _join_leg(s, F):
    f = s.createDataFrame(_store_sales())
    d = s.createDataFrame(_date_dim())
    return (f.join(d, f["ss_sold_date_sk"] == d["d_date_sk"])
            .groupBy("d_year").agg(F.sum("ss_ext_sales_price")))


def _q78(s, F):
    sales, returns = _q78_tables()
    a, r = s.createDataFrame(sales), s.createDataFrame(returns)
    cond = (a["ss_ticket_number"] == r["sr_ticket_number"]) & \
        (a["ss_item_sk"] == r["sr_item_sk"])
    return (a.repartition(4).join(r, cond, "left_outer")
            .filter(F.col("sr_ticket_number").isNull())
            .groupBy("ss_store_sk").agg(F.count("*"), F.sum("ss_net_paid")))


def _keyed(seed, key_hi, nulls=False, dup=True):
    """(left, right) tables sharing key column k: the right's keys repeat
    unless dup is False (then k is unique and dense)."""
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, key_hi, N)
    rk = rng.integers(0, key_hi, 900) if dup else rng.permutation(key_hi)
    left = {"k": pa.array(lk, mask=(rng.random(N) < 0.05) if nulls
                          else None),
            "a": rng.integers(0, 100, N)}
    right = {"k": pa.array(rk, mask=(rng.random(len(rk)) < 0.05) if nulls
                           else None),
             "b": rng.random(len(rk))}
    return pa.table(left), pa.table(right)


def _two(seed, key_hi, how, nulls=False, dup=True, on=None):
    def q(s, F):
        lt, rt = _keyed(seed, key_hi, nulls, dup)
        l, r = s.createDataFrame(lt), s.createDataFrame(rt)
        return l.join(r, on if on is not None else l["k"] == r["k"], how)
    return q


# name -> (query(session, functions), ordered result, extra conf)
CASES = {
    # the chip smoke test's legs
    "join_leg": (_join_leg, False, {}),
    "sort_leg": (lambda s, F: s.createDataFrame(_main()).orderBy("k"),
                 True, {}),
    "range_sort": (lambda s, F: s.createDataFrame(_main()).repartition(8)
                   .orderBy("k", F.desc("v")), True, {}),
    "topk": (lambda s, F: s.createDataFrame(_main())
             .orderBy(F.desc("v"), "k").limit(100), True, {}),
    "q78": (_q78, False, SHUFFLED),
    # broadcast build of the q78 shape: two keys, the sorted probe
    "q78_broadcast": (_q78, False, {}),
    # joins
    "inner_dup_keys": (_two(1, 300, "inner"), False, SHUFFLED),
    "inner_dense_unique": (_two(2, 900, "inner", dup=False), False,
                           SHUFFLED),
    "inner_null_keys": (_two(3, 300, "inner", nulls=True), False, {}),
    "left_outer_nulls": (_two(4, 600, "left_outer", nulls=True), False,
                         SHUFFLED),
    "right_outer": (_two(5, 600, "right_outer", nulls=True), False, {}),
    # sparse keys: the reference's full-outer extension fits its output
    # capacity here (see test_full_outer_extension_past_build_capacity)
    "full_outer": (_two(6, 20000, "full_outer", nulls=True), False, {}),
    "left_semi": (_two(8, 600, "left_semi", nulls=True), False, {}),
    "left_anti": (_two(9, 600, "left_anti", nulls=True), False, {}),
    "left_anti_dense": (_two(10, 900, "left_anti", dup=False), False,
                        SHUFFLED),
    "using_k": (_two(11, 300, "inner", on=["k"]), False, {}),
    "left_outer_using": (_two(12, 600, "left_outer", on="k"), False, {}),
    # sorts and limits
    "range_nulls_asc": (lambda s, F: s.createDataFrame(_main(1, True))
                        .repartition(4).orderBy("k", "v"), True, {}),
    "range_nulls_asc_last": (lambda s, F: s.createDataFrame(_main(1, True))
                             .repartition(4)
                             .orderBy(F.col("k").asc_nulls_last(), "v"),
                             True, {}),
    "range_nulls_desc": (lambda s, F: s.createDataFrame(_main(1, True))
                         .repartition(4).orderBy(F.desc("k"), "v"),
                         True, {}),
    "range_nulls_desc_first": (lambda s, F: s.createDataFrame(
        _main(1, True)).repartition(4)
        .orderBy(F.col("k").desc_nulls_first(), F.col("v").desc()),
        True, {}),
    "float_keys": (lambda s, F: s.createDataFrame(pa.table({
        "f": pa.array(np.random.default_rng(2).choice(
            [0.0, -0.0, np.nan, 1.5, -2.25, np.inf, -np.inf], N),
            mask=np.arange(N) % 7 == 0),
        "i": np.arange(N)})).orderBy(F.desc("f"), "i"), True, {}),
    "sort_ascending_list": (lambda s, F: s.createDataFrame(_main(5))
                            .orderBy("v", "k", ascending=[False, True]),
                            True, {}),
    "sort_within_partitions": (lambda s, F: s.createDataFrame(_main(6))
                               .sortWithinPartitions(F.desc("v"), "k"),
                               True, {}),
    "limit": (lambda s, F: s.createDataFrame(_main(7)).filter(
        F.col("v") > 500).limit(37), True, {}),
    "offset": (lambda s, F: s.createDataFrame(_main(8)).orderBy("v", "k")
               .offset(5900), True, {}),
    "topk_offset": (lambda s, F: s.createDataFrame(_main(9))
                    .orderBy("v", "k").offset(10).limit(20), True, {}),
    "join_then_sort": (lambda s, F: _two(13, 300, "inner")(s, F)
                       .orderBy("a", "b"), True, {}),
}


def _cell(v):
    if v is None:
        return (2, 0)
    if isinstance(v, float) and math.isnan(v):
        return (1, 0)
    return (0, v)


def _rows(table: pa.Table, ordered: bool) -> list:
    rows = list(zip(*[c.to_pylist() for c in table.columns]))
    return rows if ordered else sorted(
        rows, key=lambda r: tuple(_cell(v) for v in r))


def _assert_same(jt: pa.Table, tt: pa.Table, ordered: bool):
    assert tt.column_names == jt.column_names
    assert [str(t) for t in tt.schema.types] == \
        [str(t) for t in jt.schema.types]
    jr, tr = _rows(jt, ordered), _rows(tt, ordered)
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        for x, y in zip(a, b):
            if isinstance(y, float) and x is not None:
                assert math.isclose(x, y, rel_tol=1e-12, abs_tol=1e-9) or \
                    (math.isnan(x) and math.isnan(y)), (a, b)
            else:
                assert x == y, (a, b)


def _both(sessions, name):
    query, _, extra = CASES[name]
    j, t = sessions(extra)
    return query(j, JF), query(t, TF)


@pytest.mark.parametrize("name", list(CASES))
def test_results_match_reference(sessions, name):
    jdf, tdf = _both(sessions, name)
    _assert_same(jdf.toArrow(), tdf.toArrow(), CASES[name][1])


@pytest.mark.parametrize("name", list(CASES))
def test_plan_operator_sequence_matches(sessions, name):
    jdf, tdf = _both(sessions, name)

    def ops(df):
        return [type(n).__name__
                for n in df.query_execution.physical.iter_nodes()]

    assert ops(tdf) == ops(jdf)


def _plan_and_run(sessions, name):
    _, t = sessions(CASES[name][2])
    df = CASES[name][0](t, TF)
    before_m, before_l = t.metrics, t.launches.snapshot()
    df.toArrow()
    after_m, after_l = t.metrics, t.launches.snapshot()

    def grew(d0, d1, k):
        return d1.get(k, 0) > d0.get(k, 0)

    return (df.query_execution.physical.tree_string(),
            lambda k: grew(before_m, after_m, k),
            lambda k: grew(before_l, after_l, k))


def test_leg_plans_and_paths(sessions):
    plan, metric, launch = _plan_and_run(sessions, "join_leg")
    assert "BroadcastExchange" in plan
    assert "BroadcastHashJoin[inner]" in plan
    assert "isnotnull" in plan
    assert metric("join.dense_fast_path") and launch("djoin_probe")

    plan, metric, launch = _plan_and_run(sessions, "q78")
    assert "ShuffledHashJoin[left_outer]" in plan
    assert plan.count("Exchange[HashPartitioning(4)]") == 3
    assert metric("join.sorted_probe") and launch("join_build")
    assert not metric("join.dense_fast_path")

    plan, _, launch = _plan_and_run(sessions, "range_sort")
    assert "Exchange[RangePartitioning(4)]" in plan
    assert launch("shuffle_range") and launch("sort")

    plan, _, launch = _plan_and_run(sessions, "topk")
    assert "LimitExec(is_global=True" in plan
    assert "LimitExec(is_global=False" in plan
    assert "Exchange[SinglePartition(1)]" in plan
    assert "RangePartitioning" not in plan

    plan, _, _ = _plan_and_run(sessions, "sort_leg")
    assert plan.startswith("Sort[") and "Exchange" not in plan


def test_duplicate_build_keys_leave_the_dense_path(sessions):
    _, metric, launch = _plan_and_run(sessions, "inner_dup_keys")
    assert launch("join_probe") and not metric("join.dense_fast_path")
    _, metric, launch = _plan_and_run(sessions, "inner_dense_unique")
    assert metric("join.dense_fast_path") and not launch("join_probe")


def test_capacity_retry_matches_reference(sessions):
    # every probe row matches 40 build rows: the expansion outgrows the
    # probe tile's capacity and retries at the bucket of `needed`
    rng = np.random.default_rng(21)
    lt = pa.table({"k": rng.integers(0, 10, 3000), "a": np.arange(3000)})
    rt = pa.table({"k": np.repeat(np.arange(10), 40),
                   "b": np.arange(400)})
    j, t = sessions(SHUFFLED)
    out = []
    for s, F in ((j, JF), (t, TF)):
        l, r = s.createDataFrame(lt), s.createDataFrame(rt)
        out.append(l.join(r, l["k"] == r["k"]).toArrow())
    assert out[1].num_rows == 3000 * 40
    _assert_same(out[0], out[1], False)
    assert t.metrics.get("join.capacity_retry", 0) > 0


@pytest.mark.parametrize("dup", [True, False])
def test_full_outer_extension_past_build_capacity(sessions, dup):
    # each build key matches about 7-10 probe rows, so the anti join that
    # finds unmatched build rows expands past the build tile's capacity and
    # retries (the JAX package stops at the build capacity and drops the
    # unmatched build rows past it: ROADMAP.md section C); held against a
    # plain count
    _, t = sessions({})
    lt, rt = _keyed(6, 600 if dup else 900, nulls=dup, dup=dup)
    l, r = t.createDataFrame(lt), t.createDataFrame(rt)
    got = l.join(r, l["k"] == r["k"], "full_outer").toArrow()
    lk = [x for x in lt.column("k").to_pylist()]
    rk = [x for x in rt.column("k").to_pylist()]
    lc = {x: lk.count(x) for x in set(lk) if x is not None}
    rc = {x: rk.count(x) for x in set(rk) if x is not None}
    matched = sum(rc.get(x, 0) for x in lk if x is not None)
    left_only = sum(1 for x in lk if x is None or x not in rc)
    right_only = sum(1 for x in rk if x is None or x not in lc)
    assert got.num_rows == matched + left_only + right_only
    right_keys = got.column(2).to_pylist()
    assert sum(1 for x in got.column(0).to_pylist() if x is None) - \
        sum(1 for x in lk if x is None) == right_only
    assert sorted((x for x in right_keys if x is not None)) == sorted(
        [x for x in lk if x is not None and x in rc for _ in range(rc[x])]
        + [x for x in rk if x is not None and x not in lc])


def _nested_loop_join(what, l, r, F):
    if what == "cross":
        return l.crossJoin(r.filter(F.col("b") < 0.02))
    if what == "non_equi":
        return l.join(r, l["k"] < r["k"])
    if what == "outer_residual":
        return l.join(r, (l["k"] == r["k"]) & (l["a"] > r["b"] * 100),
                      "left_outer")
    return l.join(l, "k")  # self_join: the condition reads one side


@pytest.mark.parametrize("what", ["cross", "non_equi", "outer_residual",
                                  "self_join"])
def test_nested_loop_joins_match_reference(sessions, what):
    # the joins of test_unported_joins_raise_not_ported's first slices run
    # since the fifth SQL slice, as NestedLoopJoinExec
    j, t = sessions()
    lt, rt = _keyed(0, 50)
    lt, rt = lt.slice(0, 400), rt.slice(0, 200)
    out = []
    for s, F in ((j, JF), (t, TF)):
        l, r = s.createDataFrame(lt), s.createDataFrame(rt)
        df = _nested_loop_join(what, l, r, F)
        ops = [type(n).__name__
               for n in df.query_execution.physical.iter_nodes()]
        assert "NestedLoopJoinExec" in ops
        out.append(df.toArrow())
    assert out[0].num_rows > 0
    _assert_same(out[0], out[1], False)


# joins the port still refuses (the first four ran before the fifth SQL
# slice brought NestedLoopJoinExec: test_nested_loop_joins_match_reference).
# Two cases run since A7's slice brought the runtime join filters and are
# held to the reference: a left outer join under the bloom filter (which
# applies only to inner and semi joins, so it passes untouched) and an
# inner join under the min-max range filter.
@pytest.mark.parametrize("what", ["cross", "non_equi", "outer_residual",
                                  "self_join", "runtime_filter"])
def test_unported_joins_raise_not_ported(what):
    t = TorchSession("not-ported", dict(CONF), device="cpu")
    lt, rt = _keyed(0, 50)
    l, r = t.createDataFrame(lt), t.createDataFrame(rt)
    if what in ("outer_residual", "runtime_filter"):
        key, jt = (("spark.tpu.join.runtimeFilter.bloom", "left_outer")
                   if what == "outer_residual"
                   else ("spark.tpu.join.runtimeFilter", "inner"))
        extra = {key: "true", "spark.tpu.join.runtimeFilter.minCapacity": 1}
        j = TpuSession("not-ported-reference", dict(JAX_CONF, **extra))
        for k, v in extra.items():
            t.conf.set(k, v)
        jl, jr = j.createDataFrame(lt), j.createDataFrame(rt)
        want = jl.join(jr, jl["k"] == jr["k"], jt).toArrow()
        got = l.join(r, l["k"] == r["k"], jt).toArrow()
        assert got.num_rows > 0
        _assert_same(want, got, False)
        j.stop()
        t.stop()
        return
    with pytest.raises(NotPortedError):
        if what == "cross":
            # full outer joins take no NestedLoopJoinExec
            l.join(r, l["k"] < r["k"], "full_outer").toArrow()
        elif what == "non_equi":
            l.join(r, (l["k"] == r["k"]) & (l["a"] > r["b"]),
                   "full_outer").toArrow()
        else:
            l.join(l, l["k"] < l["a"], "full_outer").toArrow()
    t.stop()
