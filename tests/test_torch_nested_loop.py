"""The port's NestedLoopJoinExec against the JAX package's, and its two
enumerations against each other: `cross_join` and `expand_pairs` against
the reference's `cross_join` on the same numpy-seeded masks; then SQL over
seeded views with duplicate keys, NULL keys on both sides and sides that
a filter empties at run time, for each join type the operator takes
(inner and cross: all pairs; left_semi, left_anti and left_outer with an
equality plus a residual: candidates by key, or all pairs with
`NestedLoopJoinExec.key_pairs` patched to find no key). Results compare
exactly and in order (both enumerations keep the reference's probe-major
pair order); the key enumeration forms fewer pairs than all pairs, and no
tile passes spark.tpu.batch.capacity x NESTED_LOOP_TILE_FACTOR."""

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from spark_tpu import TpuSession  # noqa: E402
from spark_tpu.ops import joining as JJ  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from spark_tpu_torch.config import NESTED_LOOP_TILE_FACTOR  # noqa: E402
from spark_tpu_torch.ops import joining as TJ  # noqa: E402
from spark_tpu_torch.physical.operators import NestedLoopJoinExec  # noqa
from tests.test_torch_tpcds_slice import _ops, _renumber  # noqa: E402

CAP = 1 << 8
# the port side pinned to the operator tier, as the reference side is:
# these tests hold operator-at-a-time execution (tests/test_torch_fusion.py
# holds the stage tier)
CONF = {"spark.sql.shuffle.partitions": 3, "spark.tpu.batch.capacity": CAP,
        "spark.sql.autoBroadcastJoinThreshold": 1 << 20,
        "spark.tpu.compile.tier": "operator"}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator"})


@pytest.mark.parametrize("pcap,bcap,p_live,b_live,out_cap", [
    (16, 8, 0.6, 0.5, 128), (16, 8, 0.6, 0.5, 32), (8, 16, 0.0, 0.7, 16),
    (8, 16, 0.9, 0.0, 16), (33, 5, 1.0, 1.0, 256)])
def test_cross_join_matches_reference(pcap, bcap, p_live, b_live, out_cap):
    rng = np.random.default_rng(pcap * 31 + bcap)
    pm = rng.random(pcap) < p_live
    bm = rng.random(bcap) < b_live
    jr = JJ.cross_join(jnp.asarray(pm), jnp.asarray(bm), out_cap)
    tr = TJ.cross_join(torch.from_numpy(pm), torch.from_numpy(bm), out_cap)
    assert int(tr.needed) == int(jr.needed) == int(pm.sum()) * int(bm.sum())
    live = np.asarray(jr.out_mask)
    np.testing.assert_array_equal(tr.out_mask.numpy(), live)
    np.testing.assert_array_equal(tr.probe_idx.numpy()[live],
                                  np.asarray(jr.probe_idx)[live])
    np.testing.assert_array_equal(tr.build_idx.numpy()[live],
                                  np.asarray(jr.build_idx)[live])


def test_expand_pairs_tiles_concatenate_to_the_whole():
    # the pair sequence cut into tiles of 7 equals the sequence in one tile
    rng = np.random.default_rng(5)
    counts = torch.from_numpy(rng.integers(0, 5, 20))
    starts = torch.from_numpy(rng.integers(0, 10, 20))
    order = torch.from_numpy(rng.permutation(16))
    offsets = torch.cumsum(counts, 0)
    total = int(offsets[-1])
    whole = TJ.expand_pairs(offsets, counts, starts, order, 0, total)
    assert bool(whole[2].all())
    parts = [TJ.expand_pairs(offsets, counts, starts, order, f, 7)
             for f in range(0, total, 7)]
    for i in range(2):
        got = torch.cat([p[i][p[2]] for p in parts])
        assert torch.equal(got, whole[i])
    want = [(i, int(order[min(int(starts[i]) + w, 15)]))
            for i in range(20) for w in range(int(counts[i]))]
    assert list(zip(whole[0].tolist(), whole[1].tolist())) == want


def _tables():
    rng = np.random.default_rng(23)
    n1, n2 = 300, 120

    def keys(n, hi, null_frac):
        k = rng.integers(0, hi, n)
        return pa.array(k, pa.int64(), mask=rng.random(n) < null_frac)

    return {
        "l": pa.table({"k": keys(n1, 40, 0.1), "v": rng.integers(0, 9, n1),
                       "s": pa.array(rng.choice(["a", "b", "c"], n1))}),
        "r": pa.table({"k2": keys(n2, 50, 0.15), "w": rng.integers(0, 9, n2),
                       "t": pa.array(rng.choice(["b", "c", "d"], n2))}),
    }


@pytest.fixture(scope="module")
def sessions():
    out = {"jax": TpuSession("nlj-reference", dict(JAX_CONF)),
           "torch": TorchSession("nlj", dict(CONF), device="cpu")}
    for name, tb in _tables().items():
        for s in out.values():
            s.createDataFrame(tb).createOrReplaceTempView(name)
    yield out
    for s in out.values():
        s.stop()


# join type -> (statement over {l} and {r}, the enumeration by key applies)
STATEMENTS = {
    "inner": ("SELECT l.k, l.v, r.k2, r.w FROM {l} l JOIN {r} r "
              "ON l.k < r.k2 AND l.v = 3", False),
    "cross": ("SELECT l.v, r.w, r.t FROM {l} l CROSS JOIN {r} r "
              "WHERE l.k = 7", False),
    "left_semi": ("SELECT k, v, s FROM {l} l WHERE EXISTS (SELECT * FROM "
                  "{r} r WHERE r.k2 = l.k AND r.w <> l.v)", True),
    "left_anti": ("SELECT k, v, s FROM {l} l WHERE NOT EXISTS (SELECT * "
                  "FROM {r} r WHERE r.k2 = l.k AND r.w <> l.v)", True),
    "left_outer": ("SELECT l.k, l.v, r.k2, r.w, r.t FROM {l} l LEFT JOIN "
                   "{r} r ON l.k = r.k2 AND r.w > l.v", True),
}
# a side a filter empties at run time
EMPTY_L = "(SELECT k, v, s FROM l WHERE v > 100)"
EMPTY_R = "(SELECT k2, w, t FROM r WHERE w > 100)"
SIDES = {"both": ("l", "r"), "empty_left": (EMPTY_L, "r"),
         "empty_right": ("l", EMPTY_R)}


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("jt", list(STATEMENTS))
def test_enumerations_match_reference(sessions, monkeypatch, jt, side):
    text, by_key = STATEMENTS[jt]
    lt, rt = SIDES[side]
    text = text.format(l=lt, r=rt)
    jd = sessions["jax"].sql(text)
    want = jd.toArrow()
    s = sessions["torch"]
    for mode in ("keys", "all"):
        if mode == "all":
            monkeypatch.setattr(NestedLoopJoinExec, "key_pairs",
                                lambda self: [])
        before = s.metrics
        td = s.sql(text)
        assert "NestedLoopJoinExec" in _ops(td)
        assert _ops(td) == _ops(jd)
        for phase in ("analyzed", "optimized"):
            assert _renumber(getattr(td.query_execution, phase)
                             .tree_string()) == \
                _renumber(getattr(jd.query_execution, phase).tree_string())
        got = td.toArrow()
        assert got.schema == want.schema
        assert got.to_pylist() == want.to_pylist(), mode
        after = s.metrics
        grew = {k: after.get(k, 0) - before.get(k, 0)
                for k in ("nlj.pairs_all", "nlj.pairs_formed")}
        assert after.get("nlj.max_tile", 0) <= CAP * NESTED_LOOP_TILE_FACTOR
        if mode == "keys" and by_key and side == "both":
            assert grew["nlj.pairs_formed"] < grew["nlj.pairs_all"]
        elif mode == "all" or not by_key:
            assert grew["nlj.pairs_formed"] == grew["nlj.pairs_all"]
    if side == "both":
        assert want.num_rows > 0
