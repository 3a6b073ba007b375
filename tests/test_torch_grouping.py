"""spark_tpu_torch.ops.grouping and ops.partition against their JAX twins,
on the same tiles: a JAX ColumnarBatch is built from seeded numpy data and
the port's ColumnarBatch.from_numpy takes its planes (np.asarray of each
data, validity and mask array)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from spark_tpu.columnar import ops as JO  # noqa: E402
from spark_tpu.columnar.batch import ColumnarBatch as JBatch  # noqa: E402
from spark_tpu.ops import grouping as JG  # noqa: E402
from spark_tpu.ops import partition as JP  # noqa: E402
from spark_tpu.types import (  # noqa: E402
    StructField as JField, StructType as JStruct, float64 as jf64,
    int64 as ji64,
)
from spark_tpu_torch.columnar import ops as TO  # noqa: E402
from spark_tpu_torch.columnar.batch import ColumnarBatch as TBatch  # noqa: E402
from spark_tpu_torch.ops import grouping as TG  # noqa: E402
from spark_tpu_torch.ops import partition as TP  # noqa: E402
from spark_tpu_torch.types import (  # noqa: E402
    StructField as TField, StructType as TStruct, float64 as tf64,
    int64 as ti64,
)

CAP = 2048
N = 1500


def _tiles(seed: int, key_hi: int = 50, nulls: bool = True):
    """(jax batch, port batch) over the same planes: k1, k2 int64 keys,
    x int64 and y float64 values; some nulls; some rows masked off."""
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(0, key_hi, N), rng.integers(-3, 3, N),
              rng.integers(-1000, 1000, N), rng.standard_normal(N)]
    valids = [rng.random(N) < 0.9 if nulls else None, None,
              rng.random(N) < 0.8 if nulls else None, None]
    jschema = JStruct([JField("k1", ji64), JField("k2", ji64),
                       JField("x", ji64), JField("y", jf64)])
    jb = JBatch.from_numpy(jschema, arrays, validities=valids, capacity=CAP)
    # drop some live rows, as a filter would
    keep = rng.random(CAP) < 0.85
    jmask = jnp.asarray(np.asarray(jb.row_mask) & keep)
    jb = JBatch(jschema, jb.columns, jmask)
    tschema = TStruct([TField("k1", ti64), TField("k2", ti64),
                       TField("x", ti64), TField("y", tf64)])
    tb = TBatch.from_numpy(
        tschema, [np.asarray(c.data) for c in jb.columns],
        validities=[None if c.validity is None else np.asarray(c.validity)
                    for c in jb.columns],
        row_mask=np.asarray(jb.row_mask))
    return jb, tb


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_from_numpy_takes_jax_planes():
    jb, tb = _tiles(0)
    assert tb.capacity == jb.capacity == CAP
    assert np.array_equal(_np(tb.row_mask), np.asarray(jb.row_mask))
    assert tb.num_rows() == int(np.asarray(jb.row_mask).sum())
    for jc, tc in zip(jb.columns, tb.columns):
        assert np.array_equal(_np(tc.data), np.asarray(jc.data))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("nkeys", [1, 2])
def test_group_rows_matches(seed, nkeys):
    jb, tb = _tiles(seed)
    jl = JG.group_rows([c.data for c in jb.columns[:nkeys]],
                       [c.validity for c in jb.columns[:nkeys]], jb.row_mask)
    tl = TG.group_rows([c.data for c in tb.columns[:nkeys]],
                       [c.validity for c in tb.columns[:nkeys]], tb.row_mask)
    for f in ("perm", "seg_ids", "start_flag", "active"):
        assert np.array_equal(_np(getattr(tl, f)), np.asarray(getattr(jl, f))), f
    assert int(tl.num_groups) == int(jl.num_groups)


OPS = ("sum", "count", "countstar", "min", "max", "first")


def _vals(batch, ops):
    x, y = batch.columns[2], batch.columns[3]
    datas, valids = [], []
    for i, op in enumerate(ops):
        c = x if i % 2 == 0 else y
        datas.append(c.data)
        valids.append(c.validity)
    return datas, valids


def _assert_bufs(tbufs, jbufs, live):
    for (td, tv), (jd, jv) in zip(tbufs, jbufs):
        td, jd = _np(td), np.asarray(jd)
        assert (tv is None) == (jv is None)
        if jd.dtype.kind == "f":
            np.testing.assert_allclose(td[live], jd[live], rtol=1e-12)
        else:
            assert np.array_equal(td, jd)
        if tv is not None:
            assert np.array_equal(_np(tv), np.asarray(jv))


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_group_ops_matches(seed):
    jb, tb = _tiles(seed)
    jl = JG.group_rows([jb.columns[0].data], [jb.columns[0].validity],
                       jb.row_mask)
    tl = TG.group_rows([tb.columns[0].data], [tb.columns[0].validity],
                       tb.row_mask)
    jd, jv = _vals(jb, OPS)
    td, tv = _vals(tb, OPS)
    jbufs = JG.apply_group_ops(jl, OPS, jd, jv)
    tbufs = TG.apply_group_ops(tl, OPS, td, tv)
    live = np.asarray(JG.group_output_mask(jl))
    assert np.array_equal(_np(TG.group_output_mask(tl)), live)
    _assert_bufs(tbufs, jbufs, live)
    jk = JG.scatter_group_keys(jl, jb.columns[0].data, jb.columns[0].validity)
    tk = TG.scatter_group_keys(tl, tb.columns[0].data, tb.columns[0].validity)
    assert np.array_equal(_np(tk[0]), np.asarray(jk[0]))
    assert np.array_equal(_np(tk[1]), np.asarray(jk[1]))


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_dense_ops_matches(seed):
    jb, tb = _tiles(seed, key_hi=300)
    out_cap = 512
    kd = np.asarray(jb.columns[0].data)
    kv = np.asarray(jb.columns[0].validity)
    mask = np.asarray(jb.row_mask)
    seg = np.where(kv & mask, kd, out_cap - 1).astype(np.int32)
    jd, jv = _vals(jb, OPS)
    td, tv = _vals(tb, OPS)
    jbufs = JG.apply_dense_ops(jnp.asarray(seg), out_cap, CAP, OPS, jd, jv,
                               jb.row_mask)
    tbufs = TG.apply_dense_ops(torch.from_numpy(seg), out_cap, CAP, OPS, td,
                               tv, tb.row_mask)
    _assert_bufs(tbufs, jbufs, np.ones(out_cap, bool))


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_global_ops_matches(seed):
    jb, tb = _tiles(seed)
    jd, jv = _vals(jb, OPS)
    td, tv = _vals(tb, OPS)
    jouts = JG.apply_global_ops(OPS, jd, jv, jb.row_mask)
    touts = TG.apply_global_ops(OPS, td, tv, tb.row_mask)
    for (t, th), (j, jh) in zip(touts, jouts):
        assert np.allclose(float(t), float(j), rtol=1e-12)
        assert (th is None) == (jh is None)
        if th is not None:
            assert bool(th) == bool(jh)


@pytest.mark.parametrize("parts", [4, 8, 200])
def test_hash_partition_matches(parts):
    jb, tb = _tiles(2)
    keys = [0, 1]
    jr = JP.hash_partition([jb.columns[i].data for i in keys],
                           [jb.columns[i].validity for i in keys],
                           jb.row_mask, parts, seed=42)
    tr = TP.hash_partition([tb.columns[i].data for i in keys],
                           [tb.columns[i].validity for i in keys],
                           tb.row_mask, parts, seed=42)
    assert np.array_equal(_np(tr.perm), np.asarray(jr.perm))
    assert np.array_equal(_np(tr.pids), np.asarray(jr.pids))
    assert np.array_equal(_np(tr.counts), np.asarray(jr.counts))
    assert tr.counts.dtype == torch.int64


@pytest.mark.parametrize("parts,start", [(8, 0), (8, 5), (3, 7)])
def test_round_robin_partition_matches(parts, start):
    jb, tb = _tiles(3)
    jr = JP.round_robin_partition(jb.row_mask, parts, start)
    tr = TP.round_robin_partition(tb.row_mask, parts, start)
    assert np.array_equal(_np(tr.perm), np.asarray(jr.perm))
    assert np.array_equal(_np(tr.counts), np.asarray(jr.counts))
    live = int(np.asarray(jb.row_mask).sum())
    assert np.array_equal(_np(tr.pids)[:live], np.asarray(jr.pids)[:live])


def _assert_batches_equal(tb, jb):
    assert tb.capacity == jb.capacity
    assert np.array_equal(_np(tb.row_mask), np.asarray(jb.row_mask))
    for tc, jc in zip(tb.columns, jb.columns):
        assert np.array_equal(_np(tc.data), np.asarray(jc.data))
        assert (tc.validity is None) == (jc.validity is None)
        if tc.validity is not None:
            assert np.array_equal(_np(tc.validity), np.asarray(jc.validity))


def test_concat_and_compact_batches_match():
    (j0, t0), (j1, t1) = _tiles(4), _tiles(5, nulls=False)
    jc = JO.concat_batches([j0, j1])
    tc = TO.concat_batches([t0, t1])
    _assert_batches_equal(tc, jc)
    assert tc.capacity == 4096
    jk, tk = JO.compact_batch(jc), TO.compact_batch(tc)
    _assert_batches_equal(tk, jk)
    assert tk.num_rows() == jk.num_rows()
