"""The bit kernel's plain twin and the percentile ops of
spark_tpu_torch/ops/grouping.py against spark_tpu/ops/grouping.py.

`bitplane_reduce` (bit_and, bit_or, bit_xor per segment) is the
reference's XLA-lowered loop the hand-written kernel
`scatter_kernels.segment_bits` replaces on the card; on the CPU the
wrapper takes its plain version, the reference's bit-plane reduce, which
must agree bit for bit: seeded int64 values with negatives, int32 values
(sign extension), masked rows, masked rows whose segment ids lie outside
[0, num_segments), empty segments and an all-masked input. The kernel is
held against this plain version on the card in tests/test_torch_cuda.py.
`group_percentile` and `masked_percentile` (the lower nearest rank of one
sort) are held to the reference's on the same inputs."""

import functools
import operator

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from spark_tpu.ops import grouping as JG  # noqa: E402
from spark_tpu_torch.ops import grouping as TG  # noqa: E402
from spark_tpu_torch.ops import scatter_kernels as SK  # noqa: E402

KINDS = ("and", "or", "xor")


def _inputs(seed: int, n: int, segs: int, live: float, dtype=np.int64,
            stray: bool = True):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    vals = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    vals[: n // 4] = rng.integers(-5, 5, n // 4)
    mask = rng.random(n) < live
    seg = rng.integers(0, segs, n).astype(np.int32)
    if stray:
        # masked rows may carry any id: the reference drops them
        off = ~mask & (rng.random(n) < 0.5)
        seg[off] = rng.choice([-7, segs, segs + 100], int(off.sum()))
    return vals, mask, seg


def _both(vals, mask, seg, segs, kind):
    j_out, j_has = JG.bitplane_reduce(jnp.asarray(vals), jnp.asarray(mask),
                                      jnp.asarray(seg), segs, kind)
    t_out, t_has = TG.bitplane_reduce(torch.from_numpy(vals),
                                      torch.from_numpy(mask),
                                      torch.from_numpy(seg), segs, kind)
    assert t_out.dtype == torch.int64 and t_out.shape == (segs,)
    return (np.asarray(j_out), np.asarray(j_has)), (t_out.numpy(),
                                                    t_has.numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,segs,live", [(1000, 1, 0.58), (5000, 8, 0.58),
                                         (4000, 1024, 0.9),
                                         (3000, 5000, 0.3)])
def test_bitplane_reduce_matches_reference(kind, n, segs, live):
    vals, mask, seg = _inputs(n + segs, n, segs, live)
    (jo, jh), (to, th) = _both(vals, mask, seg, segs, kind)
    assert np.array_equal(jo, to) and np.array_equal(jh, th)
    fn = {"and": operator.and_, "or": operator.or_,
          "xor": operator.xor}[kind]
    for s in range(min(segs, 16)):
        rows = [int(v) for v, m, g in zip(vals, mask, seg) if m and g == s]
        want = functools.reduce(fn, rows) if rows else 0
        assert int(to[s]) == want and bool(th[s]) == bool(rows)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype,negative", [(np.int64, False),
                                            (np.int32, False),
                                            (np.int64, True)])
def test_bitplane_reduce_low_entropy_values(kind, dtype, negative):
    """chip_smoke.py's card inputs (`bit_values`: a base per segment with
    a few bits flipped): the plain version equals the reference, and AND
    and OR differ from segment to segment, so the card's checks would see
    a kernel that returned 0 or all ones without reducing."""
    import chip_smoke as cs

    rng = np.random.default_rng(23)
    segs, n = 8, 40_000
    seg = rng.integers(0, segs, n).astype(np.int32)
    vals = cs.bit_values(rng, seg, segs, dtype, negative)
    mask = rng.random(n) < 0.58
    (jo, jh), (to, th) = _both(vals, mask, seg, segs, kind)
    assert np.array_equal(jo, to) and np.array_equal(jh, th)
    assert len(set(to.tolist())) == segs
    assert 0 not in to and -1 not in to
    if negative:
        assert (vals < 0).all()


@pytest.mark.parametrize("kind", KINDS)
def test_bitplane_reduce_int32_sign_extends(kind):
    vals, mask, seg = _inputs(5, 2000, 7, 0.7, dtype=np.int32)
    zero = seg == 0
    vals[zero] = -np.abs(vals[zero] // 2) - 1   # segment 0 all negative
    (jo, jh), (to, th) = _both(vals, mask, seg, 7, kind)
    assert np.array_equal(jo, to) and np.array_equal(jh, th)
    assert (to < 0).any()


@pytest.mark.parametrize("kind", KINDS)
def test_bitplane_reduce_all_masked(kind):
    vals, _, seg = _inputs(9, 500, 4, 0.0)
    mask = np.zeros(500, bool)
    (jo, jh), (to, th) = _both(vals, mask, seg, 4, kind)
    assert np.array_equal(jo, to) and (to == 0).all() and not th.any()


def test_segment_bits_plain_is_the_wrappers_cpu_path():
    vals, mask, seg = _inputs(4, 3000, 33, 0.6)
    v, m, g = (torch.from_numpy(x) for x in (vals, mask, seg))
    cnt = SK.partition_histogram(g, m, 33)
    before = dict(SK.LAUNCHES)
    for kind in KINDS:
        assert torch.equal(SK.segment_bits(v, m, g, 33, kind, cnt),
                           SK.segment_bits_plain(v, m, g, 33, kind))
    assert SK.LAUNCHES == before   # no kernel on the CPU
    with pytest.raises(ValueError):
        SK.segment_bits(v, m, g, 33, "nand", cnt)


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 1.0])
def test_group_percentile_matches_reference(q):
    rng = np.random.default_rng(int(q * 100))
    n = 3000
    k1 = rng.integers(0, 20, n)
    k2 = rng.integers(0, 3, n)
    k2v = rng.random(n) < 0.9
    vals = rng.integers(-1000, 1000, n)
    valid = rng.random(n) < 0.8
    mask = rng.random(n) < 0.85
    jv, jh = JG.group_percentile(
        [jnp.asarray(k1), jnp.asarray(k2)], [None, jnp.asarray(k2v)],
        jnp.asarray(vals), jnp.asarray(valid), jnp.asarray(mask), q)
    t = torch.from_numpy
    tv, th = TG.group_percentile([t(k1), t(k2)], [None, t(k2v)], t(vals),
                                 t(valid), t(mask), q)
    jh = np.asarray(jh)
    assert np.array_equal(jh, th.numpy())
    assert np.array_equal(np.asarray(jv)[jh], tv.numpy()[jh])
    # the groups come out in group_rows' order
    lay = TG.group_rows([t(k1), t(k2)], [None, t(k2v)], t(mask))
    assert int(lay.num_groups) == int(np.asarray(
        JG.group_rows([jnp.asarray(k1), jnp.asarray(k2)],
                      [None, jnp.asarray(k2v)],
                      jnp.asarray(mask)).num_groups))


@pytest.mark.parametrize("q", [0.0, 0.5, 0.75, 1.0])
@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_masked_percentile_matches_reference(q, dtype):
    rng = np.random.default_rng(7)
    vals = (rng.standard_normal(777) * 50).astype(dtype)
    valid = rng.random(777) < 0.7
    mask = rng.random(777) < 0.9
    jv, jh = JG.masked_percentile(jnp.asarray(vals), jnp.asarray(mask),
                                  jnp.asarray(valid), q)
    tv, th = TG.masked_percentile(torch.from_numpy(vals),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(valid), q)
    assert bool(jh) == bool(th) and float(jv) == float(tv)
    none = np.zeros(777, bool)
    _, th0 = TG.masked_percentile(torch.from_numpy(vals),
                                  torch.from_numpy(none), None, q)
    assert not bool(th0)
