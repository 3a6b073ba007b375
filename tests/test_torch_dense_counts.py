"""The port's dense aggregate counts through the histogram kernel once per
distinct weight tensor of a tile, in partial and in final mode: the row
mask's count (`present`) serves every op whose weights are the row mask,
and ops sharing a validity tensor share its count. The module attribute
`partition_histogram` of ops/grouping.py, physical/operators.py and
ops/partition.py is wrapped with a call counter; the results must still
equal the JAX package's, and the card test's query must make the number
of histogram calls that tests/test_torch_cuda.py expects of the kernel."""

import math

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as TF  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from spark_tpu_torch.ops import grouping as TG  # noqa: E402
from spark_tpu_torch.ops import partition as TP  # noqa: E402
from spark_tpu_torch.physical import operators as TO  # noqa: E402

CONF = {"spark.sql.shuffle.partitions": 4,
        "spark.tpu.batch.capacity": 1 << 12}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator"})
N = 6000
# tests/test_torch_cuda.py's slice query launches the histogram kernel
# this many times: 4 round-robin input tiles + 8 hash-exchange inputs + 8
# partial tiles x 1 (the row mask) + 4 final tiles x 4 (the row mask and
# the validities of sum, min and max)
CARD_QUERY_HISTOGRAMS = 36


@pytest.fixture()
def counted(monkeypatch):
    """(calls by module, [(ops, distinct weight tensors, calls)] per dense
    aggregate tile)."""
    calls = {"grouping": 0, "operators": 0, "partition": 0}
    tiles = []

    for name, mod in (("grouping", TG), ("operators", TO),
                      ("partition", TP)):
        def counter(*args, _name=name, _fn=mod.partition_histogram,
                    **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(mod, "partition_histogram", counter)

    dense = TO._dense_group_kernel

    def tile(ops, cap, out_cap, key, key_valid, kmin, val_datas, val_valids,
             row_mask):
        before = calls["grouping"] + calls["operators"]
        out = dense(ops, cap, out_cap, key, key_valid, kmin, val_datas,
                    val_valids, row_mask)
        weights = 1 + len({id(v) for v in val_valids if v is not None})
        tiles.append((ops, weights,
                      calls["grouping"] + calls["operators"] - before))
        return out

    monkeypatch.setattr(TO, "_dense_group_kernel", tile)
    return calls, tiles


def _table(nulls: bool):
    rng = np.random.default_rng(3)
    k = rng.integers(0, 500, N)
    v = rng.integers(0, 1000, N)
    if not nulls:
        return pa.table({"k": k, "v": v})
    return pa.table({"k": pa.array(k, mask=rng.random(N) < 0.1),
                     "v": pa.array(v, mask=rng.random(N) < 0.15)})


def _query(df, F):
    return (df.filter(F.col("v") > 25).withColumn("v2", F.col("v") * 3)
            .repartition(8).groupBy("k")
            .agg(F.sum("v2"), F.count("*"), F.min("v"), F.max("v"),
                 F.avg("v")))


def _rows(table: pa.Table) -> list:
    cols = [c.to_pylist() for c in table.columns]
    return sorted(zip(*cols), key=lambda r: (r[0] is None, r[0] or 0))


@pytest.mark.parametrize("nulls", [False, True])
def test_dense_tile_counts_once_per_weight_tensor(counted, nulls):
    calls, tiles = counted
    table = _table(nulls)
    j = TpuSession("dense-counts-reference", dict(JAX_CONF))
    t = TorchSession("dense-counts", dict(CONF), device="cpu")
    try:
        jt = _query(j.createDataFrame(table), JF).toArrow()
        tt = _query(t.createDataFrame(table), TF).toArrow()
    finally:
        j.stop()
        t.stop()
    partial = [x for x in tiles if "countstar" in x[0]]
    final = [x for x in tiles if "countstar" not in x[0]]
    assert partial and final
    for ops, weights, made in tiles:
        assert made == weights, ops
    if not nulls:
        # v has no nulls: every partial op weighs rows by the row mask
        assert all(made == 1 for _, _, made in partial)
    # final buffers carry validities: the row mask plus those of sum(v2),
    # min, max and avg's sum
    assert all(made == 5 for _, _, made in final)
    assert calls["grouping"] + calls["operators"] == \
        sum(w for _, w, _ in tiles)

    assert tt.column_names == jt.column_names
    assert len(tt) == len(jt)
    for a, b in zip(_rows(tt), _rows(jt)):
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert math.isclose(x, y, rel_tol=1e-12), (a, b)
            else:
                assert x == y, (a, b)


def test_card_query_histogram_calls(counted):
    calls, _ = counted
    rng = np.random.default_rng(42)
    k = rng.integers(0, 5000, 200_000)
    v = rng.integers(0, 1000, 200_000)
    spark = TorchSession("dense-counts-card-query",
                         {"spark.sql.shuffle.partitions": 4,
                          "spark.tpu.batch.capacity": 1 << 16},
                         device="cpu")
    try:
        (spark.createDataFrame(pa.table({"k": k, "v": v}))
         .filter(TF.col("v") > 25).withColumn("v2", TF.col("v") * 3)
         .repartition(8).groupBy("k")
         .agg(TF.sum("v2"), TF.count("*"), TF.min("v"), TF.max("v"))
         .toArrow())
    finally:
        spark.stop()
    assert sum(calls.values()) == CARD_QUERY_HISTOGRAMS
