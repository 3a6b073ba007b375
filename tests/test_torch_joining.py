"""The port's equi-join kernels against the JAX package's on the same
numpy-seeded inputs: `build_index` and `probe_join` for inner, left_outer,
left_semi and left_anti, with duplicate and null keys, two-key joins whose
hash collides on purpose (a weak hash patched into both modules, so only
the true-key comparison keeps the pairs apart), and an output capacity the
expansion outgrows (`needed`). Then the dense direct-address build and probe
against the searchsorted probe, and its fallback on duplicate keys. Indices
and masks compare exactly over the live output rows."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from spark_tpu.ops import joining as JJ  # noqa: E402
from spark_tpu_torch.columnar.batch import ColumnarBatch  # noqa: E402
from spark_tpu_torch.exec.context import ExecContext  # noqa: E402
from spark_tpu_torch.expr.expressions import AttributeReference  # noqa
from spark_tpu_torch.ops import joining as TJ  # noqa: E402
from spark_tpu_torch.physical.operators import HashJoinExec  # noqa: E402
from spark_tpu_torch.types import StructField, StructType, int64  # noqa

JOIN_TYPES = ["inner", "left_outer", "left_semi", "left_anti"]
BCAP, PCAP = 1024, 2048


def _side(rng, cap, n_live, key_hi, nkeys, nulls):
    keys = [rng.integers(0, key_hi, cap) for _ in range(nkeys)]
    valids = [(rng.random(cap) > 0.1) if nulls else None
              for _ in range(nkeys)]
    mask = np.arange(cap) < n_live
    return keys, valids, mask


def _run(jt, bside, pside, out_cap):
    (bk, bv, bm), (pk, pv, pm) = bside, pside
    j = lambda xs: [None if x is None else jnp.asarray(x) for x in xs]  # noqa
    t = lambda xs: [None if x is None else torch.from_numpy(x)  # noqa
                    for x in xs]
    jb = JJ.build_index(j(bk), j(bv), jnp.asarray(bm))
    tb = TJ.build_index(t(bk), t(bv), torch.from_numpy(bm))
    np.testing.assert_array_equal(tb.sorted_hash.numpy(),
                                  np.asarray(jb.sorted_hash))
    np.testing.assert_array_equal(tb.perm.numpy(), np.asarray(jb.perm))
    jr = JJ.probe_join(jb, j(bk), j(bv), j(pk), j(pv), jnp.asarray(pm),
                       out_cap, jt)
    tr = TJ.probe_join(tb, t(bk), t(bv), t(pk), t(pv), torch.from_numpy(pm),
                       out_cap, jt)
    assert int(tr.needed) == int(jr.needed)
    live = np.asarray(jr.out_mask)
    np.testing.assert_array_equal(tr.out_mask.numpy(), live)
    np.testing.assert_array_equal(tr.probe_idx.numpy()[live],
                                  np.asarray(jr.probe_idx)[live])
    np.testing.assert_array_equal(tr.matched.numpy()[live],
                                  np.asarray(jr.matched)[live])
    matched = live & np.asarray(jr.matched)
    np.testing.assert_array_equal(tr.build_idx.numpy()[matched],
                                  np.asarray(jr.build_idx)[matched])
    return tr


@pytest.mark.parametrize("jt", JOIN_TYPES)
@pytest.mark.parametrize("nkeys,key_hi,nulls", [
    (1, 300, False),    # duplicate build keys
    (1, 300, True),     # and null keys on both sides
    (1, 5000, False),   # mostly unmatched
    (2, 12, True),      # two keys
])
def test_probe_matches_reference(jt, nkeys, key_hi, nulls):
    rng = np.random.default_rng(nkeys * 1000 + key_hi + nulls)
    bside = _side(rng, BCAP, 900, key_hi, nkeys, nulls)
    pside = _side(rng, PCAP, 2000, key_hi, nkeys, nulls)
    r = _run(jt, bside, pside, 1 << 14)
    assert int(r.needed) <= 1 << 14


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_needed_reports_overflow(jt):
    # ~7 matches per probe row: the expansion wants more than 2048 rows
    rng = np.random.default_rng(5)
    bside = _side(rng, BCAP, 1000, 150, 1, False)
    pside = _side(rng, PCAP, 2000, 150, 1, False)
    r = _run(jt, bside, pside, PCAP)
    assert int(r.needed) > PCAP


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_hash_collisions_are_verified(monkeypatch, jt):
    # a hash of the key sum: (1, 4) and (2, 3) collide, so every probe
    # range holds foreign rows that only the true-key gathers reject
    from spark_tpu.ops import joining as jmod
    from spark_tpu_torch.ops import joining as tmod

    def weak_j(cols, valids=None, seed=42):
        return sum(c.astype(jnp.int64) for c in cols) % 5

    def weak_t(cols, valids=None, seed=42):
        return sum(c.to(torch.int64) for c in cols) % 5

    monkeypatch.setattr(jmod, "hash_columns", weak_j)
    monkeypatch.setattr(tmod, "hash_columns", weak_t)
    rng = np.random.default_rng(6)
    bside = _side(rng, BCAP, 200, 6, 2, False)
    pside = _side(rng, PCAP, 300, 6, 2, False)
    r = _run(jt, bside, pside, 1 << 16)
    if jt == "inner":
        (bk, _, bm), (pk, _, pm) = bside, pside
        pairs = {}
        for i in np.nonzero(bm)[0]:
            key = (bk[0][i], bk[1][i])
            pairs[key] = pairs.get(key, 0) + 1
        exp = sum(pairs.get((pk[0][i], pk[1][i]), 0)
                  for i in np.nonzero(pm)[0])
        assert int(r.out_mask.sum()) == exp


def _dense_join(jt, build_keys, probe_keys, probe_valid=None):
    """(dense result batch or None, sorted-probe result batch) of one
    HashJoinExec over a one-key build (key k, payload b) and probe (key k,
    payload a)."""
    ctx = ExecContext()
    lk, la = AttributeReference("k", int64), AttributeReference("a", int64)
    rk, rb = AttributeReference("k", int64), AttributeReference("b", int64)
    node = HashJoinExec([lk], [rk], jt, _Leaf([lk, la]), _Leaf([rk, rb]))

    def batch(attrs, keys, valid):
        schema = StructType([StructField(a.name, a.dtype) for a in attrs])
        return ColumnarBatch.from_numpy(
            schema, [keys, np.arange(len(keys))], [valid, None])

    build = batch([rk, rb], build_keys, None)
    probe = batch([lk, la], probe_keys, probe_valid)
    bkeys = [build.columns[0]]
    dense = node._try_dense_build(build, bkeys, ctx)
    dense_out = None if dense is None else node._dense_probe_batch(
        probe, build, dense, {lk.expr_id: 0, la.expr_id: 1}, ctx)
    bindex = TJ.build_index([build.columns[0].data],
                            [None], build.row_mask)
    sorted_out = node._probe_batch(probe, build, bindex,
                                   [build.columns[0].data], [None],
                                   {lk.expr_id: 0, la.expr_id: 1}, ctx)
    return dense_out, sorted_out


class _Leaf(HashJoinExec.__mro__[1]):   # a PhysicalPlan with fixed output
    child_fields = ()

    def __init__(self, attrs):
        self.attrs = attrs

    @property
    def output(self):
        return self.attrs


def _rows(b):
    t = b.to_arrow()
    return sorted(zip(*[c.to_pylist() for c in t.columns]),
                  key=lambda r: tuple((x is None, x or 0) for x in r))


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_dense_build_and_probe_match_the_sorted_probe(jt):
    rng = np.random.default_rng(12)
    build_keys = rng.permutation(np.arange(5000, 5900))
    probe_keys = rng.integers(4800, 6100, 3000)
    probe_valid = rng.random(3000) > 0.1
    dense, sorted_ = _dense_join(jt, build_keys, probe_keys, probe_valid)
    assert dense is not None
    assert _rows(dense) == _rows(sorted_)


def test_dense_build_falls_back_on_duplicate_keys():
    rng = np.random.default_rng(13)
    build_keys = np.concatenate([np.arange(900), [17]])
    probe_keys = rng.integers(0, 900, 2000)
    dense, sorted_ = _dense_join("inner", build_keys, probe_keys)
    assert dense is None
    # every probe row matches once, and those with key 17 twice
    assert sorted_.num_rows() == 2000 + int((probe_keys == 17).sum())


def test_device_memo_hits_once_and_drops_dead_entries():
    """The dense build's memo: one compute per source tensor, and an entry
    whose source tensor died leaves the memo at the next call instead of
    waiting for LRU eviction."""
    import gc

    import torch

    from spark_tpu_torch.utils import device_memo as DM

    calls = []

    def memo(t):
        return DM.memo_device_scalars(("test_memo",), (t, None),
                                      lambda: calls.append(1) or len(calls))

    a = torch.arange(8)
    assert memo(a) == 1 and memo(a) == 1 and len(calls) == 1

    def ours():
        return [k for k in DM._MEMO if k[0] == ("test_memo",)]

    for _ in range(50):
        memo(torch.arange(8))
    gc.collect()
    memo(a)     # the next call drops the entries of the dead tensors
    assert len(ours()) == 1 and memo(a) == 1
    del a
    gc.collect()
    memo(torch.arange(3))
    assert len(ours()) == 1


@pytest.mark.parametrize("weak", [False, True])
@pytest.mark.parametrize("jt", ["left_semi", "left_anti"])
def test_dedup_build_keeps_semi_and_anti_results(monkeypatch, jt, weak):
    # one build row per key (hash order) answers a semi or anti join as
    # the whole build does, with a smaller expansion; with a weak hash the
    # keys of a hash interleave and some duplicates stay
    if weak:
        monkeypatch.setattr(TJ, "hash_columns", lambda cols, valids=None,
                            seed=42: sum(c.to(torch.int64) for c in cols) % 5)
    rng = np.random.default_rng(14)
    (bk, bv, bm), (pk, pv, pm) = (_side(rng, BCAP, 900, 12, 2, True),
                                  _side(rng, PCAP, 2000, 12, 2, True))
    t = lambda xs: [None if x is None else torch.from_numpy(x)  # noqa
                    for x in xs]
    full = TJ.build_index(t(bk), t(bv), torch.from_numpy(bm))
    dedup = TJ.dedup_build(full, t(bk), t(bv))
    kept = int((dedup.sorted_hash != TJ.I64_MAX).sum())
    assert kept < int((full.sorted_hash != TJ.I64_MAX).sum())
    outs = []
    for b in (full, dedup):
        args = (b, t(bk), t(bv), t(pk), t(pv), torch.from_numpy(pm))
        need = int(TJ.probe_join(*args, 1 << 10, jt).needed)
        outs.append(TJ.probe_join(*args, max(need, 1 << 10), jt))
    assert int(outs[1].needed) < int(outs[0].needed)
    rows = [sorted(r.probe_idx[r.out_mask].tolist()) for r in outs]
    assert rows[0] == rows[1]
