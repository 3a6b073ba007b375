"""The port's runtime join filters (HashJoinExec._range_filter_probe and
_bloom_filter_probe; the bloom bitset's kernel in ops/bloom.py) against
the JAX package's, as `tests/test_sql.py`'s runtime-filter case and
`tests/test_pruning.py`'s bloom case hold the reference's: the same
queries in TpuSession (operator tier) and TorchSession(device="cpu") with
the filters off, the range filter on and the bloom filter on, over
integral, decimal and string keys, inner and semi joins, a left outer join
(which no filter touches), the minimum capacity, and TPC-DS q3. Results
equal each other and the reference's; the port's
`join.bloom_filtered_rows` and `join.runtime_filter_compactions` equal the
reference's; and the bloom bitset's plain version equals the reference's
jitted build bit for bit."""

import decimal

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401

CONF = {"spark.sql.shuffle.partitions": 4, "spark.tpu.batch.capacity": 1 << 12,
        "spark.tpu.compile.tier": "operator"}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.mesh.enabled": "false"})
RANGE = {"spark.tpu.join.runtimeFilter": "true",
         "spark.tpu.join.runtimeFilter.minCapacity": 1}
BLOOM = {"spark.tpu.join.runtimeFilter.bloom": "true"}
MODES = {"off": {}, "range": RANGE, "bloom": BLOOM,
         "both": dict(RANGE, **BLOOM)}
COUNTERS = ("join.bloom_filtered_rows", "join.runtime_filter_compactions")


def _tables(kind: str, seed: int = 3):
    """(fact, dim) with a sparse key over a wide span, so the build takes
    the sorted probe (a dense span takes the direct-address probe, which
    no filter precedes)."""
    rng = np.random.default_rng(seed)
    n = 6000
    fk = rng.integers(0, 3_000_000, n)
    dk = 1000 + 99991 * np.arange(30)
    fk[: n // 10] = rng.choice(dk, n // 10)  # some rows match
    if kind == "decimal":
        def conv(a):
            return pa.array([decimal.Decimal(int(x)) / 100 for x in a],
                            pa.decimal128(12, 2))
    elif kind == "string":
        def conv(a):
            return pa.array([f"key-{x}" for x in a])
    else:
        def conv(a):
            return pa.array(a, pa.int64())
    fact = pa.table({"k": conv(fk), "v": rng.random(n)})
    dim = pa.table({"k2": conv(dk), "w": np.arange(30.0)})
    return fact, dim


QUERIES = {
    "inner": "SELECT count(*) AS c, sum(w) AS s FROM rf_f JOIN rf_d "
             "ON k = k2",
    "semi": "SELECT count(*) AS c FROM rf_f WHERE k IN (SELECT k2 FROM rf_d)",
    "left_outer": "SELECT count(*) AS c, count(w) AS m FROM rf_f LEFT JOIN "
                  "rf_d ON k = k2",
    "rows": "SELECT k, v, w FROM rf_f JOIN rf_d ON k = k2",
}


def _run(session, counters, sql: str):
    before = counters()
    out = session.sql(sql).toArrow()
    after = counters()
    rows = sorted((tuple(r.values()) for r in out.to_pylist()), key=repr)
    return rows, {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}


@pytest.fixture(scope="module")
def engines():
    made = {}

    def get(kind: str, mode: str):
        key = (kind, mode)
        if key not in made:
            fact, dim = _tables(kind)
            j = TpuSession("rf-reference", dict(JAX_CONF, **MODES[mode]))
            t = TorchSession("rf", dict(CONF, **MODES[mode]), device="cpu")
            for s in (j, t):
                s.createDataFrame(fact).createOrReplaceTempView("rf_f")
                s.createDataFrame(dim).createOrReplaceTempView("rf_d")
            made[key] = (j, t)
        return made[key]

    yield get
    for j, t in made.values():
        j.stop()
        t.stop()


@pytest.mark.parametrize("query", list(QUERIES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["integral", "decimal", "string"])
def test_filters_match_reference_and_off(engines, kind, mode, query):
    j, t = engines(kind, mode)
    sql = QUERIES[query]
    got, counts = _run(t, lambda: t.metrics, sql)
    want, jcounts = _run(j, lambda: j._metrics.snapshot()["counters"], sql)
    assert got == want
    assert counts == jcounts
    _, off = engines(kind, "off")
    assert got == _run(off, lambda: off.metrics, sql)[0]
    bloom_on = mode in ("bloom", "both")
    if query in ("inner", "semi", "rows") and bloom_on:
        assert counts["join.bloom_filtered_rows"] > 0
    if query == "left_outer" or not bloom_on:
        assert counts["join.bloom_filtered_rows"] == 0


def test_range_filter_prunes_and_compacts(engines):
    """The range filter drops the probe rows outside the build keys' span
    (counted by the port as join.range_filtered_rows) and compacts a tile
    it cut to a sixteenth, as the reference does."""
    j, t = engines("integral", "range")
    before = dict(t.metrics)
    _run(t, lambda: t.metrics, QUERIES["inner"])
    pruned = t.metrics.get("join.range_filtered_rows", 0) - \
        before.get("join.range_filtered_rows", 0)
    fact, dim = _tables("integral")
    fk = fact["k"].to_numpy()
    dk = dim["k2"].to_numpy()
    assert pruned == int(((fk < dk.min()) | (fk > dk.max())).sum())


def test_min_capacity_skips_small_batches():
    """Probe batches under spark.tpu.join.runtimeFilter.minCapacity pass
    the range filter unfiltered: at the default (1 << 20) a 4,096-row tile
    is not filtered, and nothing is counted."""
    fact, dim = _tables("integral")
    out = []
    for cap in (1, 1 << 20):
        conf = dict(CONF, **{"spark.tpu.join.runtimeFilter": "true",
                             "spark.tpu.join.runtimeFilter.minCapacity": cap})
        t = TorchSession("rf-min", conf, device="cpu")
        j = TpuSession("rf-min-reference", dict(JAX_CONF, **conf))
        try:
            for s in (t, j):
                s.createDataFrame(fact).createOrReplaceTempView("rf_f")
                s.createDataFrame(dim).createOrReplaceTempView("rf_d")
            got, c = _run(t, lambda: t.metrics, QUERIES["inner"])
            want, jc = _run(j, lambda: j._metrics.snapshot()["counters"],
                            QUERIES["inner"])
            assert got == want and c == jc
            out.append((got, t.metrics.get("join.range_filtered_rows", 0)))
        finally:
            t.stop()
            j.stop()
    assert out[0][0] == out[1][0]
    assert out[0][1] > 0 and out[1][1] == 0


@pytest.mark.parametrize("kind", ["integral", "string"])
def test_bloom_bits_equal_reference_build(kind, monkeypatch):
    """The port's bitset (ops/bloom.py's plain version on the CPU) equals
    the reference's jitted bloom build bit for bit, over the same build
    batch: the reference keeps its bits in the build batch's stats."""
    import spark_tpu.physical.operators as JO
    import spark_tpu_torch.ops.bloom as B

    fact, dim = _tables(kind)
    stats: list = []
    orig_stats = JO._batch_stats_cache

    def keep_stats(batch):
        d = orig_stats(batch)
        stats.append(d)
        return d

    monkeypatch.setattr(JO, "_batch_stats_cache", keep_stats)
    bits: list = []
    orig_build = B.bloom_build

    def keep_bits(*a):
        out = orig_build(*a)
        bits.append(out)
        return out

    monkeypatch.setattr(B, "bloom_build", keep_bits)
    j = TpuSession("rf-bits-reference", dict(JAX_CONF, **BLOOM))
    t = TorchSession("rf-bits", dict(CONF, **BLOOM), device="cpu")
    try:
        for s in (t, j):
            s.createDataFrame(fact).createOrReplaceTempView("rf_f")
            s.createDataFrame(dim).createOrReplaceTempView("rf_d")
            s.sql(QUERIES["inner"]).toArrow()
    finally:
        j.stop()
        t.stop()
    want = [np.asarray(v) for d in stats for k, v in d.items()
            if isinstance(k, tuple) and k and k[0] == "bloom_bits"]
    assert len(bits) == 1 and len(want) == 1
    got = bits[0].numpy() != 0
    assert got.shape == want[0].shape
    assert np.array_equal(got, want[0].astype(bool))
    assert 0 < got.sum() <= 60


def test_tpcds_q3_with_filters():
    """TPC-DS q3 at scale 0.1 with both filters on equals the filters off
    and the reference's, and the bloom counters equal the reference's."""
    from tests.test_torch_cuda import tpcds_query
    from tests.tpcds.datagen import gen_tpcds_full

    tables = gen_tpcds_full(scale=0.1)
    sql = tpcds_query("q3")
    extra = dict(MODES["both"], **{"spark.sql.autoBroadcastJoinThreshold": -1})
    results = []
    for mode in ({}, extra):
        t = TorchSession("rf-q3", dict(CONF, **mode), device="cpu")
        try:
            for name, tb in tables.items():
                t.createDataFrame(tb).createOrReplaceTempView(name)
            results.append(_run(t, lambda: t.metrics, sql))
        finally:
            t.stop()
    j = TpuSession("rf-q3-reference", dict(JAX_CONF, **extra))
    try:
        for name, tb in tables.items():
            j.createDataFrame(tb).createOrReplaceTempView(name)
        want, jc = _run(j, lambda: j._metrics.snapshot()["counters"], sql)
    finally:
        j.stop()
    assert results[0][0] == results[1][0] == want
    assert results[1][1] == jc
