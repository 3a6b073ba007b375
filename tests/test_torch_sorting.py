"""The port's sort, limit and range-partition kernels against the JAX
package's on the same numpy-seeded inputs: `sort_permutation` (chained
stable torch.sort passes against one multi-operand lax.sort) over every
ported key type, both directions, both null placements, several keys and
inactive rows; `limit_mask`; and `range_partition`. Permutations, masks,
partition ids and counts compare exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from spark_tpu.ops import partition as JP  # noqa: E402
from spark_tpu.ops import sorting as JS  # noqa: E402
from spark_tpu_torch.ops import partition as TP  # noqa: E402
from spark_tpu_torch.ops import sorting as TS  # noqa: E402

CAP = 4096


def _keys(kind: str, rng):
    if kind == "int64":
        return rng.integers(-(2 ** 62), 2 ** 62, CAP)
    if kind == "int64_few":
        return rng.integers(-3, 4, CAP)
    if kind == "int32":
        return rng.integers(-50, 50, CAP).astype(np.int32)
    if kind == "int16":
        return rng.integers(-300, 300, CAP).astype(np.int16)
    if kind == "int8":
        return rng.integers(-128, 128, CAP).astype(np.int8)
    if kind == "date":
        return rng.integers(18000, 18040, CAP).astype(np.int32)
    if kind == "bool":
        # Column.sort_keys() of a boolean column
        return (rng.random(CAP) < 0.5).astype(np.int32)
    special = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5,
                        -2.25, 1e-300])
    if kind == "float64":
        return rng.choice(special, CAP)
    if kind == "float32":
        return rng.choice(special, CAP).astype(np.float32)
    raise ValueError(kind)


def _perms(keys, valids, specs, mask):
    jperm = JS.sort_permutation(
        [jnp.asarray(k) for k in keys],
        [None if v is None else jnp.asarray(v) for v in valids],
        [JS.SortKeySpec(*s) for s in specs], jnp.asarray(mask))
    tperm = TS.sort_permutation(
        [torch.from_numpy(k) for k in keys],
        [None if v is None else torch.from_numpy(v) for v in valids],
        [TS.SortKeySpec(*s) for s in specs], torch.from_numpy(mask))
    assert tperm.dtype == torch.int64
    return np.asarray(jperm).astype(np.int64), tperm.numpy()


KINDS = ["int64", "int64_few", "int32", "int16", "int8", "date", "bool",
         "float64", "float32"]
SPECS = [(True, None), (False, None), (True, False), (False, True)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("nulls", [False, True])
def test_single_key_permutation_matches(kind, spec, nulls):
    rng = np.random.default_rng(KINDS.index(kind) * 10 + SPECS.index(spec))
    key = _keys(kind, rng)
    valid = (rng.random(CAP) > 0.1) if nulls else None
    mask = rng.random(CAP) < 0.9
    jperm, tperm = _perms([key], [valid], [spec], mask)
    np.testing.assert_array_equal(tperm, jperm)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multi_key_permutation_matches(seed):
    rng = np.random.default_rng(100 + seed)
    keys = [_keys("int64_few", rng), _keys("float64", rng),
            _keys("date", rng)]
    valids = [rng.random(CAP) > 0.2, None, rng.random(CAP) > 0.3]
    specs = [(True, None), (False, None), (False, True)]
    mask = rng.random(CAP) < 0.8
    jperm, tperm = _perms(keys, valids, specs, mask)
    np.testing.assert_array_equal(tperm, jperm)


@pytest.mark.parametrize("live", [0.0, 1.0])
def test_all_or_no_rows_live(live):
    rng = np.random.default_rng(7)
    mask = np.full(CAP, bool(live))
    jperm, tperm = _perms([_keys("int32", rng)], [rng.random(CAP) > 0.5],
                          [(False, None)], mask)
    np.testing.assert_array_equal(tperm, jperm)


def test_signed_zeros_keep_input_order():
    # -0.0 and 0.0 compare equal: a stable sort keeps their input order
    key = np.array([0.0, -0.0, 0.0, -0.0, -1.0] * 4)
    mask = np.ones(key.shape[0], dtype=bool)
    for asc in (True, False):
        perm = TS.sort_permutation([torch.from_numpy(key)], [None],
                                   [TS.SortKeySpec(asc)],
                                   torch.from_numpy(mask)).numpy()
        zeros = [i for i in perm if key[i] == 0]
        assert zeros == sorted(zeros)


@pytest.mark.parametrize("n,offset", [(0, 0), (1, 0), (100, 0),
                                      (CAP, 0), (50, 30), (10, CAP)])
def test_limit_mask_matches(n, offset):
    rng = np.random.default_rng(n + offset)
    mask = rng.random(CAP) < 0.6
    got = TS.limit_mask(torch.from_numpy(mask), n, offset).numpy()
    if offset == 0:
        exp = np.asarray(JS.limit_mask(jnp.asarray(mask), n))
    else:   # the reference's LimitExec kernel
        rank = np.cumsum(mask)
        exp = mask & (rank > offset) & (rank <= offset + n)
    np.testing.assert_array_equal(got, exp)


def _range_case(kind, parts, desc, seed):
    rng = np.random.default_rng(seed)
    keys = _keys(kind, rng)
    floating = keys.dtype.kind == "f"
    live = np.unique(keys[~np.isnan(keys)] if floating else keys)
    qs = [int(round(i * (len(live) - 1) / parts)) for i in range(1, parts)]
    bounds = np.unique(live[qs]).astype(np.float64 if floating
                                        else np.int64)
    mask = rng.random(CAP) < 0.9
    return keys, bounds, mask


@pytest.mark.parametrize("kind", ["int64", "int32", "date", "float64"])
@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("desc", [False, True])
def test_range_partition_matches(kind, parts, desc):
    keys, bounds, mask = _range_case(kind, parts, desc, parts)
    if keys.dtype.kind == "f":
        # NaN is the greatest key: the reference's sampled bounds hold it
        # as a value; the port reads NaN keys as +inf
        keys = np.where(np.isnan(keys), np.inf, keys)
    jr = JP.range_partition(jnp.asarray(keys).astype(bounds.dtype),
                            jnp.asarray(bounds), jnp.asarray(mask), parts,
                            desc)
    tr = TP.range_partition(torch.from_numpy(keys), torch.from_numpy(bounds),
                            torch.from_numpy(mask), parts, desc)
    np.testing.assert_array_equal(tr.perm.numpy(), np.asarray(jr.perm))
    np.testing.assert_array_equal(tr.pids.numpy(), np.asarray(jr.pids))
    np.testing.assert_array_equal(tr.counts.numpy(), np.asarray(jr.counts))


@pytest.mark.parametrize("desc,nulls_first", [(False, True), (False, False),
                                              (True, False), (True, True)])
def test_range_partition_routes_null_keys(desc, nulls_first):
    # null keys go to the partition where they sort: the first when nulls
    # come first, else the last; the reference routes a row by its data
    # plane, so a null row's data is set to a key that lands there
    keys, bounds, mask = _range_case("int64", 4, desc, 9)
    rng = np.random.default_rng(10)
    valid = rng.random(CAP) > 0.1
    lands_first = nulls_first != desc   # before the flip for DESC
    placeholder = np.iinfo(np.int64).min if lands_first \
        else np.iinfo(np.int64).max
    jkeys = np.where(valid, keys, placeholder)
    jr = JP.range_partition(jnp.asarray(jkeys), jnp.asarray(bounds),
                            jnp.asarray(mask), 4, desc)
    tr = TP.range_partition(torch.from_numpy(keys), torch.from_numpy(bounds),
                            torch.from_numpy(mask), 4, desc,
                            torch.from_numpy(valid), nulls_first)
    np.testing.assert_array_equal(tr.perm.numpy(), np.asarray(jr.perm))
    np.testing.assert_array_equal(tr.counts.numpy(), np.asarray(jr.counts))
    null_pids = tr.pids.numpy()[np.isin(tr.perm.numpy(),
                                        np.nonzero(~valid & mask)[0])]
    assert set(null_pids.tolist()) == {0 if nulls_first else 3}
