"""Encoded execution in the port (`spark_tpu_torch/columnar/encoding.py`)
against the JAX reference: the RunInfo harvest (`column_runs`, the Arrow
ingest's per-tile runs), the sorted-run layout (`ops/grouping.
group_rows_presorted`, whose CPU twin is the run-layout kernel's plain
version), the sorted-run aggregate (`HashAggregateExec._try_run_sorted`:
the reference's cases of tests/test_encoded_exec.py and
tests/test_whole_query.py run in both engines with the same launch kinds
and equal results), spark.tpu.encoding.enabled=false taking the sorted
path, and the dense-range memo seeded at ingest (a cold dense decision
over an ingested tile reads nothing from the device). Every input is made
from a numpy seed; every comparison is exact."""

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as F  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu.columnar.arrow import table_to_batches as jax_batches  # noqa: E402,E501
from spark_tpu.columnar.encoding import column_runs as jax_runs  # noqa: E402
from spark_tpu.ops.grouping import group_rows_presorted as jax_presorted  # noqa: E402,E501
from spark_tpu.physical.compile import GLOBAL_KERNEL_CACHE as KC  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from spark_tpu_torch.columnar.arrow import table_to_batches  # noqa: E402
from spark_tpu_torch.columnar.encoding import column_runs  # noqa: E402
from spark_tpu_torch.ops import scatter_kernels as SK  # noqa: E402
from spark_tpu_torch.ops.grouping import group_rows_presorted  # noqa: E402
from spark_tpu_torch.physical.operators import dense_range_stats  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401

CONF = {"spark.sql.shuffle.partitions": 4, "spark.tpu.batch.capacity": 1 << 12}
# the reference's enc_spark fixture: fusion on, every tile fused
ENC = dict(CONF, **{"spark.tpu.fusion.enabled": "true",
                    "spark.tpu.fusion.minRows": "0"})


def _runs_cases():
    rng = np.random.default_rng(3)
    return {
        "empty": np.zeros(0, np.int64),
        "one_row": np.array([7], np.int64),
        "sorted": np.sort(rng.integers(0, 50, 500)),
        "unsorted": rng.integers(0, 50, 500),
        "negative": np.sort(rng.integers(-1000, 0, 300)),
        "int32": np.sort(rng.integers(0, 9, 200)).astype(np.int32),
        "one_run": np.full(64, 5, np.int64),
        "float": rng.random(10),
    }


def _ref_fields(info):
    """The reference RunInfo's fields that the port keeps (its run count
    has no reader in the port)."""
    return None if info is None else (info.is_sorted, info.first, info.last)


@pytest.mark.parametrize("name", list(_runs_cases()))
def test_column_runs_matches_reference(name):
    arr = _runs_cases()[name]
    for n in (len(arr), len(arr) // 2):
        assert column_runs(arr, n) == _ref_fields(jax_runs(arr, n))


def _ingest_table(n, seed=5):
    rng = np.random.default_rng(seed)
    sk = np.cumsum(rng.integers(0, 3, n))
    return pa.table({
        "sk": sk,                                       # sorted, runs
        "us": rng.integers(0, 9, n),                    # unsorted
        "i32": pa.array(np.sort(rng.integers(-5, 5, n)).astype(np.int32)),
        "nul": pa.array(sk, mask=rng.random(n) < 0.1),  # validity: no runs
        "s": [f"c{x}" for x in rng.integers(0, 6, n)],  # codes: no runs
        "f": rng.random(n),                             # float: no runs
        "dt": pa.array(np.sort(rng.integers(0, 900, n)).astype(np.int32),
                       pa.date32()),
    })


@pytest.mark.parametrize("rows_per_batch", [1000, 1 << 12])
def test_ingested_tiles_carry_reference_runs(rows_per_batch):
    tbl = _ingest_table(3000)
    port = list(table_to_batches(tbl, rows_per_batch))
    ref = list(jax_batches(tbl, rows_per_batch))
    assert len(port) == len(ref)
    for pb, rb in zip(port, ref):
        for pc, rc, name in zip(pb.columns, rb.columns, tbl.column_names):
            assert pc.runs == _ref_fields(rc.runs), name
    assert port[0].columns[0].runs.is_sorted
    assert not port[0].columns[1].runs.is_sorted


def _presorted_cases():
    """(key, row mask) pairs: sorted runs of 1-20 rows with masked rows
    inside them, runs whose rows are all masked, padding past the live
    prefix, unsorted keys, one run, and nothing live."""
    rng = np.random.default_rng(17)
    out = {}
    n = 1 << 12
    lens = rng.integers(1, 21, n)
    runs = np.repeat(np.cumsum(rng.integers(1, 50, n)), lens)[:n]
    out["runs_masked_inside"] = (runs, rng.random(n) < 0.7)
    dead = rng.random(n) < 0.5
    m = rng.random(n) < 0.8
    m[np.isin(runs, np.unique(runs)[::3])] = False      # whole runs masked
    out["all_masked_runs"] = (runs, m & ~(dead & (runs % 5 == 0)))
    pad = runs.copy()
    pad[3000:] = 0                                       # padding rows
    pm = np.zeros(n, bool)
    pm[:3000] = rng.random(3000) < 0.9
    out["padding"] = (pad, pm)
    out["unsorted"] = (rng.integers(0, 4, n), rng.random(n) < 0.6)
    out["one_run"] = (np.full(n, 3), rng.random(n) < 0.5)
    out["none_live"] = (runs, np.zeros(n, bool))
    out["int32"] = (runs.astype(np.int32), rng.random(n) < 0.5)
    out["negative"] = (runs - 10_000, rng.random(n) < 0.5)
    return out


@pytest.mark.parametrize("name", list(_presorted_cases()))
def test_group_rows_presorted_twin_matches_reference(name):
    key, mask = _presorted_cases()[name]
    got = group_rows_presorted(torch.from_numpy(key), torch.from_numpy(mask))
    want = jax_presorted(jnp.asarray(key), jnp.asarray(mask))
    for field in ("perm", "seg_ids", "start_flag", "active", "num_groups"):
        g = getattr(got, field).numpy()
        w = np.asarray(getattr(want, field))
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), field
    # the wrapper's CPU path is the plain twin
    start, seg, groups = SK.run_layout(torch.from_numpy(key),
                                       torch.from_numpy(mask))
    assert torch.equal(start, got.start_flag)
    assert torch.equal(seg, got.seg_ids) and int(groups) == int(got.num_groups)


# --- the sorted-run aggregate in both engines ------------------------------

def _kinds_ref(run):
    before = dict(KC.launches_by_kind)
    out = run()
    return out, {k: v - before.get(k, 0)
                 for k, v in KC.launches_by_kind.items()
                 if v != before.get(k, 0)}


def _kinds_port(session, run):
    before = session.launches.snapshot()
    m0 = session.metrics.get("agg.run_sorted_fast_path", 0)
    out = run()
    kinds = {k: v - before.get(k, 0)
             for k, v in session.launches.snapshot().items()
             if v != before.get(k, 0)}
    fast = session.metrics.get("agg.run_sorted_fast_path", 0) - m0
    assert fast == kinds.get("ragg", 0)
    return out, kinds


def _rows(table, by):
    return sorted(table.to_pylist(), key=lambda r: tuple(r[c] for c in by))


@pytest.fixture()
def pair():
    j = TpuSession("encoding-reference", dict(ENC))
    t = TorchSession("encoding", dict(ENC), device="cpu")
    yield j, t
    j.stop()
    t.stop()


def _sorted_table(seed, n=3000):
    rng = np.random.default_rng(seed)
    # sorted, span about 100k, over 4 x 4096: the dense path declines
    return pa.table({"sk": np.cumsum(rng.integers(5, 60, n)).astype(np.int64),
                     "v": rng.integers(0, 50, n)})


def test_sorted_run_agg_differential(pair):
    """tests/test_encoded_exec.py:178 in both engines, encoded and decoded:
    the sorted-run aggregate with count and sum equals the sorted path's
    result and the reference's."""
    j, t = pair
    tbl = _sorted_table(29)
    for s in (j, t):
        s.createDataFrame(tbl).createOrReplaceTempView("enc_sorted")
    q = "select sk, count(*) c, sum(v) sv from enc_sorted group by sk"
    out = {}
    for enabled in ("true", "false"):
        for s in (j, t):
            s.conf.set("spark.tpu.encoding.enabled", enabled)
        want, jk = _kinds_ref(lambda: j.sql(q).toArrow())
        got, tk = _kinds_port(t, lambda: t.sql(q).toArrow())
        assert jk.get("ragg", 0) == tk.get("ragg", 0) == \
            (1 if enabled == "true" else 0)
        assert _rows(got, ["sk"]) == _rows(want, ["sk"])
        out[enabled] = _rows(got, ["sk"])
    assert out["true"] == out["false"]


def test_sorted_run_agg_kind_and_exact(pair):
    """tests/test_encoded_exec.py:221: one ragg dispatch, no sorted
    (gagg) and no dense (dagg) aggregate, in both engines."""
    j, t = pair
    tbl = _sorted_table(37)
    want, jk = _kinds_ref(lambda: j.createDataFrame(tbl).groupBy("sk")
                          .agg(JF.count("*").alias("c")).toArrow())
    got, tk = _kinds_port(t, lambda: t.createDataFrame(tbl).groupBy("sk")
                          .agg(F.count("*").alias("c")).toArrow())
    for kinds in (jk, tk):
        assert kinds.get("ragg", 0) == 1, kinds
        assert kinds.get("gagg", 0) == 0, kinds
        assert kinds.get("dagg", 0) == 0, kinds
    assert _rows(got, ["sk"]) == _rows(want, ["sk"])


def test_ragg_fires_through_filter_pipeline():
    """tests/test_whole_query.py:478: a sorted sparse key through a filter
    and projection (pass-through outputs keep the ingest RunInfo) takes
    ragg under the default fusion gate, in both engines, and equals the
    decoded result."""
    j = TpuSession("pipeline-reference", dict(CONF))
    t = TorchSession("pipeline", dict(CONF), device="cpu")
    n = 3000
    k = np.sort(np.random.default_rng(5).integers(0, 10 ** 9, n))
    v = np.arange(n, dtype=np.int64)
    for s in (j, t):
        s.createDataFrame(pa.table({"k": k, "v": v})) \
            .createOrReplaceTempView("wq_sorted")
    q = ("select k, sum(v) sv, count(*) c from wq_sorted "
         "where v > 100 group by k")
    want, jk = _kinds_ref(lambda: j.sql(q).toArrow())
    got, tk = _kinds_port(t, lambda: t.sql(q).toArrow())
    assert jk.get("ragg", 0) == tk.get("ragg", 0) == 1, (jk, tk)
    assert tk.get("gagg", 0) == 0 and tk.get("dagg", 0) == 0
    assert _rows(got, ["k"]) == _rows(want, ["k"])
    # an aliased pass-through key keeps it too; a computed key does not
    alias = t.sql("select kk, count(*) c from (select k as kk, v from "
                  "wq_sorted where v > 100) q group by kk")
    _, ak = _kinds_port(t, alias.toArrow)
    assert ak.get("ragg", 0) == 1, ak
    computed = t.sql("select k2, count(*) c from (select k + 1 as k2, v "
                     "from wq_sorted where v > 100) q group by k2")
    cgot, ck = _kinds_port(t, computed.toArrow)
    assert ck.get("ragg", 0) == 0 and ck.get("gagg", 0) == 1, ck
    assert [r["k2"] - 1 for r in _rows(cgot, ["k2"])] == \
        [r["k"] for r in _rows(got, ["k"])]
    t.conf.set("spark.tpu.encoding.enabled", "false")
    decoded, dk = _kinds_port(t, lambda: t.sql(q).toArrow())
    assert dk.get("ragg", 0) == 0 and dk.get("gagg", 0) == 1, dk
    assert _rows(decoded, ["k"]) == _rows(got, ["k"])
    j.stop()
    t.stop()


@pytest.mark.parametrize("ops", ["sums", "extremes", "bits"])
def test_run_sorted_ops_match_sorted_path(ops):
    """Every buffer op the sorted-run path reduces (sum, count, avg, min,
    max, the bit kernel's and/or/xor, a string min and first) over tiles
    of 1,024 rows with nulls in the values, each tile's partial taking
    ragg, equal to the same session's sorted path
    (spark.tpu.encoding.enabled=false)."""
    rng = np.random.default_rng(41)
    n = 5000
    sk = np.cumsum(rng.integers(0, 40, n))
    tbl = pa.table({"sk": sk,
                    "v": pa.array(rng.integers(-50, 50, n),
                                  mask=rng.random(n) < 0.1),
                    "s": [f"w{x}" for x in rng.integers(0, 30, n)]})
    cols = {"sums": "sum(v) a, count(v) b, avg(v) c, count(*) d",
            "extremes": "min(v) a, max(v) b, min(s) c, max(s) d, "
                        "first(s) e",
            "bits": "bit_and(v) a, bit_or(v) b, bit_xor(v) c"}[ops]
    # blockRows of one tile: each ingested tile is one partial chunk (a
    # concatenation of several is a new plane, with no runs)
    t = TorchSession("ops", {"spark.tpu.batch.capacity": 1 << 10,
                             "spark.tpu.agg.blockRows": 1 << 10,
                             "spark.tpu.compile.tier": "operator",
                             "spark.sql.shuffle.partitions": 4},
                     device="cpu")
    t.createDataFrame(tbl).createOrReplaceTempView("r")
    q = f"select sk, {cols} from r where v is null or v > -40 group by sk"
    got, kinds = _kinds_port(t, lambda: t.sql(q).toArrow())
    assert kinds.get("ragg", 0) == 5, kinds   # one per ingested tile
    t.conf.set("spark.tpu.encoding.enabled", "false")
    want, dk = _kinds_port(t, lambda: t.sql(q).toArrow())
    assert dk.get("ragg", 0) == 0
    assert _rows(got, ["sk"]) == _rows(want, ["sk"])
    t.stop()


def test_ingest_seeds_range_memo():
    """tests/test_encoded_exec.py:276, widened: over freshly ingested
    tiles, the dense decision of a dictionary column gives its code span
    and of an integral column (nullable, sorted, unsorted, int32, date,
    decimal, all NULL) its live range, as the reference's does, and none
    reads the device (0 dense_range.syncs)."""
    from spark_tpu.physical.operators import (
        dense_range_stats as jax_range,
    )

    import datetime
    import decimal

    day = datetime.date(2000, 1, 1)
    tbl = pa.table({"c": ["a", "b", "a", "c", None, "b"],
                    "k": pa.array([5, -3, 9, None, 4, 2], pa.int64()),
                    "d": np.array([7, 7, 8, 8, 9, 10], np.int64),
                    "u": np.array([3, -8, 0, 12, 5, 5], np.int32),
                    "dt": pa.array([day, None, day.replace(day=9), None,
                                    day.replace(month=3), day], pa.date32()),
                    "x": pa.array([decimal.Decimal("1.25"), None,
                                   decimal.Decimal("-7.50"), None,
                                   decimal.Decimal("0.05"), None],
                                  pa.decimal128(7, 2)),
                    "n": pa.array([None] * 6, pa.int64())})
    t = TorchSession("memo", dict(CONF), device="cpu")
    j = TpuSession("memo-reference", dict(CONF))
    ports = t.createDataFrame(tbl).query_execution.execute()
    refs = j.createDataFrame(tbl).query_execution.execute()
    for pp, rp in zip(ports, refs):
        for pb, rb in zip(pp, rp):
            for i, name in enumerate(tbl.column_names):
                got = dense_range_stats(pb.columns[i], pb.row_mask,
                                        t._metrics)
                want = jax_range(rb.columns[i], rb.row_mask, rb.capacity)
                if want[2]:
                    assert got == tuple(want), name
                else:  # no live row: the bounds are no one's
                    assert not got[2], name
            assert dense_range_stats(pb.columns[2], pb.row_mask)[:2] == \
                (7, 10)
    assert t.metrics.get("dense_range.syncs", 0) == 0
    # a mask no ingest made (a filter's) is read once
    pb = ports[0][0]
    dense_range_stats(pb.columns[2], pb.row_mask.clone(), t._metrics)
    assert t.metrics.get("dense_range.syncs", 0) == 1
    t.stop()
    j.stop()
