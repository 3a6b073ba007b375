"""The port's window kernels (`spark_tpu_torch/ops/window.py`) against the
JAX package's (`spark_tpu/ops/window.py`), one function at a time, on the
same numpy-seeded inputs: `build_layout`'s fields (chained stable torch.sort
passes against one multi-operand lax.sort) over nullable partition keys,
order keys of several types in both directions and null placements, and
inactive rows; the rank family; the aggregates over the whole partition,
the running frame with peers, ROWS frames with both offsets and one side
unbounded, and value RANGE frames; lag/lead, first/last/nth_value; and
`scatter_back`. Integers, masks and decimal (int64) sums compare exactly;
float64 sums and averages to relative 1e-12, of the largest prefix sum
where the kernel subtracts two prefix sums (the cumulative sums may add in
another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from spark_tpu.ops import sorting as JS  # noqa: E402
from spark_tpu.ops import window as JW  # noqa: E402
from spark_tpu_torch.ops import sorting as TS  # noqa: E402
from spark_tpu_torch.ops import window as TW  # noqa: E402

CAP = 2048


def _case(seed: int, order_kind: str):
    rng = np.random.default_rng(seed)
    part = rng.integers(0, 37, CAP).astype(np.int64)
    part_valid = rng.random(CAP) > 0.05
    if order_kind == "float64":
        order = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5,
                                     -2.25, 7.0]), CAP)
    elif order_kind == "int32":
        order = rng.integers(-20, 20, CAP).astype(np.int32)
    else:  # a date-like integral key with few ties
        order = rng.integers(18000, 18400, CAP).astype(np.int32)
    order_valid = rng.random(CAP) > 0.1
    mask = rng.random(CAP) > 0.15
    values = {"int64": rng.integers(-1000, 1000, CAP),
              "float64": np.round(rng.normal(0, 100, CAP), 3),
              "int32": rng.integers(0, 50, CAP).astype(np.int32)}
    value_valid = rng.random(CAP) > 0.1
    return part, part_valid, order, order_valid, mask, values, value_valid


CASES = [(seed, kind, asc, nf) for seed, kind in ((1, "int32"),
                                                  (2, "float64"), (3, "date"))
         for asc in (True, False) for nf in (None, True, False)]


def _layouts(seed, kind, asc, nf, part_nullable=True, with_order=True):
    part, pv, order, ov, mask, values, vv = _case(seed, kind)
    spec = (asc, nf)
    okeys = [order] if with_order else []
    ovalid = [ov] if with_order else []
    jl = JW.build_layout(
        [jnp.asarray(part)], [jnp.asarray(pv) if part_nullable else None],
        [jnp.asarray(k) for k in okeys], [jnp.asarray(v) for v in ovalid],
        [JS.SortKeySpec(*spec)] * len(okeys), jnp.asarray(mask))
    tl = TW.build_layout(
        [torch.from_numpy(part)],
        [torch.from_numpy(pv) if part_nullable else None],
        [torch.from_numpy(k) for k in okeys],
        [torch.from_numpy(v) for v in ovalid],
        [TS.SortKeySpec(*spec)] * len(okeys), torch.from_numpy(mask))
    return jl, tl, values, vv, order


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(j, t, valid_j=None, valid_t=None, rel=None, scale=None):
    """Equal values (where valid, when a validity is given) and validity;
    with `rel`, within rel * |value| or, where the kernel subtracts two
    prefix sums, rel * `scale` (the largest prefix)."""
    j, t = _np(j), _np(t)
    if valid_j is not None or valid_t is not None:
        vj = np.ones(len(j), bool) if valid_j is None else _np(valid_j)
        vt = np.ones(len(t), bool) if valid_t is None else _np(valid_t)
        assert np.array_equal(vj, vt)
        j, t = j[vj], t[vt]
    if rel is None:
        assert np.array_equal(j.astype(np.float64) if j.dtype.kind == "f"
                              else j, t.astype(np.float64)
                              if t.dtype.kind == "f" else t)
        return
    np.testing.assert_allclose(t, j, rtol=rel,
                               atol=0 if scale is None else rel * scale)


@pytest.mark.parametrize("seed,kind,asc,nf", CASES)
def test_build_layout_fields(seed, kind, asc, nf):
    jl, tl, *_ = _layouts(seed, kind, asc, nf)
    for field in TW.WindowLayout._fields:
        assert np.array_equal(_np(getattr(jl, field)).astype(np.int64),
                              _np(getattr(tl, field)).astype(np.int64)), field


def test_build_layout_without_keys():
    """No order keys, and a partition key without a validity plane."""
    jl, tl, *_ = _layouts(4, "int32", True, None, part_nullable=False,
                          with_order=False)
    for field in TW.WindowLayout._fields:
        assert np.array_equal(_np(getattr(jl, field)).astype(np.int64),
                              _np(getattr(tl, field)).astype(np.int64)), field


@pytest.mark.parametrize("fn", ["w_row_number", "w_rank", "w_dense_rank",
                                "w_percent_rank", "w_cume_dist", "ntile"])
@pytest.mark.parametrize("seed,kind,asc,nf", CASES[::4])
def test_rank_family(fn, seed, kind, asc, nf):
    jl, tl, *_ = _layouts(seed, kind, asc, nf)
    if fn == "ntile":
        _same(JW.w_ntile(jl, 4), TW.w_ntile(tl, 4))
        return
    j, t = getattr(JW, fn)(jl), getattr(TW, fn)(tl)
    assert str(_np(j).dtype) == str(_np(t).dtype)
    _same(j, t)


AGGS = ["sum", "count", "min", "max", "avg"]


def _prefix_scale(v, frame="rows"):
    """The largest running sum over the tile: the frame kernels subtract
    two prefix sums of the whole sorted tile (the reference's formula), so
    a float64 result is exact to the ulps of that sum, not of itself."""
    return None if frame == "unbounded" else float(np.abs(v).sum())


def _rel(vkind, agg):
    return 1e-12 if vkind == "float64" and agg in ("sum", "avg") else None


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("vkind", ["int64", "float64"])
@pytest.mark.parametrize("frame", ["unbounded", "running"])
def test_whole_and_running_frames(agg, vkind, frame):
    for seed, kind, asc, nf in CASES[::5]:
        jl, tl, values, vv, _ = _layouts(seed, kind, asc, nf)
        v = values[vkind]
        jfn = getattr(JW, f"w_agg_{frame}")
        tfn = getattr(TW, f"w_agg_{frame}")
        jd, jv = jfn(jl, jnp.asarray(v), jnp.asarray(vv), agg)
        td, tv = tfn(tl, torch.from_numpy(v), torch.from_numpy(vv), agg)
        _same(jd, td, jv, tv, _rel(vkind, agg), _prefix_scale(v, frame))


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("lo,hi", [(-2, 0), (-1, 3), (None, 0), (0, None),
                                   (2, 5), (-4, -1)])
def test_rows_frames(agg, lo, hi):
    for seed, kind, asc, nf in CASES[1::6]:
        jl, tl, values, vv, _ = _layouts(seed, kind, asc, nf)
        for vkind in ("int64", "float64"):
            v = values[vkind]
            jd, jv = JW.w_agg_rows(jl, jnp.asarray(v), jnp.asarray(vv), agg,
                                   lo, hi)
            td, tv = TW.w_agg_rows(tl, torch.from_numpy(v),
                                   torch.from_numpy(vv), agg, lo, hi)
            _same(jd, td, jv, tv, _rel(vkind, agg), _prefix_scale(v))


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("lo,hi", [(-30, 0), (-5, 10), (None, 3), (0, None)])
def test_value_range_frames(agg, lo, hi):
    """RANGE over one ascending integral key with no nulls, as WindowExec
    bands it (kmin and band from the live rows)."""
    rng = np.random.default_rng(9)
    part = rng.integers(0, 11, CAP).astype(np.int64)
    order = rng.integers(0, 200, CAP).astype(np.int32)
    mask = rng.random(CAP) > 0.1
    v = rng.integers(-50, 50, CAP)
    vv = rng.random(CAP) > 0.1
    kmin = int(order[mask].min())
    span = int(order[mask].max()) - kmin + 1 + 2 * (abs(lo or 0) +
                                                   abs(hi or 0) + 1)
    band = 1 << max(3, (span - 1).bit_length())
    spec = [JS.SortKeySpec(True, None)]
    jl = JW.build_layout([jnp.asarray(part)], [None], [jnp.asarray(order)],
                         [None], spec, jnp.asarray(mask))
    tl = TW.build_layout([torch.from_numpy(part)], [None],
                         [torch.from_numpy(order)], [None],
                         [TS.SortKeySpec(True, None)], torch.from_numpy(mask))
    jd, jv = JW.w_agg_value_range(jl, jnp.asarray(order), jnp.asarray(v),
                                  jnp.asarray(vv), agg, lo, hi, kmin, band)
    td, tv = TW.w_agg_value_range(tl, torch.from_numpy(order),
                                  torch.from_numpy(v), torch.from_numpy(vv),
                                  agg, lo, hi, kmin, band)
    _same(jd, td, jv, tv)


@pytest.mark.parametrize("offset", [1, 2, -1, -3])
def test_shift(offset):
    for seed, kind, asc, nf in CASES[::3]:
        jl, tl, values, vv, _ = _layouts(seed, kind, asc, nf)
        v = values["int32"]
        for valid in (None, vv):
            jd, jv = JW.w_shift(jl, jnp.asarray(v), None if valid is None
                                else jnp.asarray(valid), offset)
            td, tv = TW.w_shift(tl, torch.from_numpy(v), None
                                if valid is None else torch.from_numpy(valid),
                                offset)
            _same(jd, td, jv, tv)


@pytest.mark.parametrize("offset", [1, 2, -1, -3])
def test_shift_default(offset):
    """The default of lag/lead (values in the layout's sorted order) against
    the reference's op, which takes one too: a row whose source lies
    outside its partition gets the default, a NULL source stays NULL; and
    the default's own NULLs (which the reference's op does not take)."""
    rng = np.random.default_rng(31)
    for seed, kind, asc, nf in CASES[1::3]:
        jl, tl, values, vv, _ = _layouts(seed, kind, asc, nf)
        v = values["int32"]
        dflt = rng.integers(-100, 100, CAP).astype(np.int32)
        for valid in (None, vv):
            jd, jv = JW.w_shift(jl, jnp.asarray(v), None if valid is None
                                else jnp.asarray(valid), offset,
                                default_data=jnp.asarray(dflt))
            td, tv = TW.w_shift(tl, torch.from_numpy(v), None
                                if valid is None else torch.from_numpy(valid),
                                offset, torch.from_numpy(dflt))
            _same(jd, td, jv, tv)
        dv = rng.random(CAP) < 0.7
        _, plain_v = TW.w_shift(tl, torch.from_numpy(v),
                                torch.from_numpy(vv), offset)
        td, tv = TW.w_shift(tl, torch.from_numpy(v), torch.from_numpy(vv),
                            offset, torch.from_numpy(dflt),
                            torch.from_numpy(dv))
        outside = ~((tl.pos - offset >= tl.seg_start) &
                    (tl.pos - offset <= tl.seg_start + tl.seg_size - 1))
        assert torch.equal(tv[outside], torch.from_numpy(dv)[outside])
        assert torch.equal(td[outside], torch.from_numpy(dflt)[outside])
        assert torch.equal(tv[~outside], plain_v[~outside])


@pytest.mark.parametrize("fn", ["first", "last", "last_whole", "nth",
                                "nth_whole"])
def test_value_functions(fn):
    for seed, kind, asc, nf in CASES[::3]:
        jl, tl, values, vv, _ = _layouts(seed, kind, asc, nf)
        v = values["int64"]
        for valid in (None, vv):
            jv_in = None if valid is None else jnp.asarray(valid)
            tv_in = None if valid is None else torch.from_numpy(valid)
            if fn == "first":
                j = JW.w_first_value(jl, jnp.asarray(v), jv_in)
                t = TW.w_first_value(tl, torch.from_numpy(v), tv_in)
            elif fn.startswith("last"):
                whole = fn.endswith("whole")
                j = JW.w_last_value(jl, jnp.asarray(v), jv_in, whole)
                t = TW.w_last_value(tl, torch.from_numpy(v), tv_in, whole)
            else:
                whole = fn.endswith("whole")
                j = JW.w_nth_value(jl, jnp.asarray(v), jv_in, 3, whole)
                t = TW.w_nth_value(tl, torch.from_numpy(v), tv_in, 3, whole)
            _same(j[0], t[0], j[1], t[1])


def test_scatter_back():
    jl, tl, values, vv, _ = _layouts(5, "int32", False, True)
    rn_j, rn_t = JW.w_row_number(jl), TW.w_row_number(tl)
    jd, jv = JW.scatter_back(jl, rn_j, jnp.asarray(vv))
    td, tv = TW.scatter_back(tl, rn_t, torch.from_numpy(vv))
    _same(jd, td)
    _same(jv, tv)
    jd, jv = JW.scatter_back(jl, rn_j)
    td, tv = TW.scatter_back(tl, rn_t)
    assert jv is None and tv is None
    _same(jd, td)
