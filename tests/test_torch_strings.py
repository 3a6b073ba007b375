"""String (dictionary) and decimal columns of the port against the JAX
reference, on the same numpy-seeded inputs: dictionary value hashes, ranks,
merges and recodes; string equality and ORDER BY key domains and the
partition ids of string keys, bit for bit; Arrow ingest (codes, dictionary
order, decimal scaling) and collect, with nulls, empty and non-ASCII
strings, duplicates and negative decimals; and concatenations of tiles with
different dictionaries. Every comparison is exact."""

import decimal

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from spark_tpu.columnar import arrow as RA  # noqa: E402
from spark_tpu.columnar import batch as RB  # noqa: E402
from spark_tpu.columnar import ops as RO  # noqa: E402
from spark_tpu.ops import hashing as RH  # noqa: E402
from spark_tpu.types import string as ref_string  # noqa: E402
from spark_tpu_torch.columnar import arrow as TA  # noqa: E402
from spark_tpu_torch.columnar import batch as TB  # noqa: E402
from spark_tpu_torch.columnar import ops as TO  # noqa: E402
from spark_tpu_torch.ops import hashing as TH  # noqa: E402
from spark_tpu_torch.types import string  # noqa: E402

ALPHABET = list("abcxyz 019") + ["é", "ß", "✓", "日本", "😀"]


def _words(seed: int, n: int) -> list:
    """Seeded strings of 0 to 70 characters (both sides of the hash's
    8-, 4- and 32-byte steps) with duplicates and empty strings."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.choice([0, 1, 3, 4, 7, 8, 15, 31, 32, 33, 64, 70]))
        out.append("".join(ALPHABET[i]
                           for i in rng.integers(0, len(ALPHABET), k)))
    return out + out[: n // 5]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dictionary_hashes_and_ranks_match_reference(seed):
    words = _words(seed, 400)
    ref, port = RB.StringDict(words), TB.StringDict(words)
    assert np.array_equal(port.hashes, ref.hashes)
    assert np.array_equal(port.ranks, ref.ranks)
    assert np.array_equal(port.device_rank_to_code("cpu").numpy(),
                          np.asarray(ref.device_rank_to_code()))
    assert np.array_equal(TB.hash_strings(words),
                          np.asarray(ref.hashes))


@pytest.mark.parametrize("seed", [3, 4])
def test_merged_dictionaries_match_reference(seed):
    a, b = _words(seed, 150), _words(seed + 10, 120)
    dicts_r = [RB.StringDict(a), RB.StringDict(b), RB.StringDict([])]
    dicts_t = [TB.StringDict(a), TB.StringDict(b), TB.StringDict([])]
    mr, lr = RB.merge_string_dicts(dicts_r)
    mt, lt = TB.merge_string_dicts(dicts_t)
    assert mt.values == mr.values
    for x, y in zip(lt, lr):
        assert np.array_equal(x, y)
    md, ra, rb = TB.StringDict.merged(dicts_t[0], dicts_t[1])
    mdr, rar, rbr = RB.StringDict.merged(dicts_r[0], dicts_r[1])
    assert md.values == mdr.values
    assert np.array_equal(ra, rar) and np.array_equal(rb, rbr)


def _string_columns(seed: int):
    """(reference columns, port columns): three string columns with their
    own dictionaries and codes, one of them past its dictionary (dead
    rows may hold any code)."""
    rng = np.random.default_rng(seed)
    ref_cols, port_cols = [], []
    for i in range(3):
        words = list(dict.fromkeys(_words(seed * 7 + i, 60)))
        codes = rng.integers(0, len(words) + (3 if i == 2 else 0),
                             1024).astype(np.int32)
        ref_cols.append(RB.Column(ref_string, jnp.asarray(codes), None,
                                  RB.StringDict(words)))
        port_cols.append(TB.Column(string, torch.from_numpy(codes), None,
                                   TB.StringDict(words)))
    return ref_cols, port_cols


@pytest.mark.parametrize("seed", [5, 6])
def test_unify_string_columns_matches_reference(seed):
    ref_cols, port_cols = _string_columns(seed)
    mr, cr = RO.unify_string_columns(ref_cols)
    mt, ct = TO.unify_string_columns(port_cols)
    assert mt.values == mr.values
    for x, y in zip(ct, cr):
        assert np.array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("seed", [7, 8])
def test_string_key_domains_match_reference(seed):
    ref_cols, port_cols = _string_columns(seed)
    for r, t in zip(ref_cols, port_cols):
        assert np.array_equal(t.eq_keys().numpy(), np.asarray(r.eq_keys()))
        assert np.array_equal(t.sort_keys().numpy(),
                              np.asarray(r.sort_keys()))


@pytest.mark.parametrize("num_partitions", [4, 8, 200])
def test_string_partition_ids_match_reference(num_partitions):
    ref_cols, port_cols = _string_columns(9)
    rng = np.random.default_rng(10)
    ints = rng.integers(-50, 50, 1024)
    valid = rng.random(1024) < 0.9
    rh = RH.hash_columns([ref_cols[0].eq_keys(), jnp.asarray(ints),
                          ref_cols[1].eq_keys()],
                         [None, jnp.asarray(valid), None])
    th = TH.hash_columns([port_cols[0].eq_keys(), torch.from_numpy(ints),
                          port_cols[1].eq_keys()],
                         [None, torch.from_numpy(valid), None])
    assert np.array_equal(th.numpy(), np.asarray(rh))
    assert np.array_equal(
        TH.partition_ids(th, num_partitions).numpy(),
        np.asarray(RH.partition_ids(rh, num_partitions)))


def _mixed_table(seed: int, n: int = 3000) -> pa.Table:
    rng = np.random.default_rng(seed)
    words = _words(seed, 50)
    unscaled = rng.integers(-10**7, 10**7, n)
    return pa.table({
        "s": pa.array([words[i] for i in rng.integers(0, len(words), n)],
                      mask=rng.random(n) < 0.1),
        "d": pa.array([decimal.Decimal(int(x)).scaleb(-3) for x in unscaled],
                      pa.decimal128(11, 3), mask=rng.random(n) < 0.05),
        "ls": pa.array([words[i] for i in rng.integers(0, len(words), n)],
                       pa.large_string()),
    })


@pytest.mark.parametrize("seed", [11, 12])
def test_ingest_matches_reference(seed):
    table = _mixed_table(seed)
    rb = RA.record_batch_to_columnar(table, capacity=4096)
    tb = TA.record_batch_to_columnar(table, TA.schema_from_arrow(table.schema),
                                     4096, "cpu")
    for r, t in zip(rb.columns, tb.columns):
        assert np.array_equal(t.data.numpy(), np.asarray(r.data))
        assert np.array_equal(t.validity is None, r.validity is None)
        if r.validity is not None:
            assert np.array_equal(t.validity.numpy(), np.asarray(r.validity))
        if r.dictionary is not None:
            assert t.dictionary.values == r.dictionary.values


@pytest.mark.parametrize("rows_per_batch", [1000, 4096])
def test_round_trip_through_ingest_and_collect(rows_per_batch):
    table = _mixed_table(13)
    batches = list(TA.table_to_batches(table, rows_per_batch))
    back = TA.batches_to_table(batches)
    want = table.cast(pa.schema([("s", pa.string()),
                                 ("d", pa.decimal128(11, 3)),
                                 ("ls", pa.string())]))
    assert back.schema == want.schema
    assert back.to_pylist() == want.to_pylist()


def test_concat_of_tiles_with_different_dictionaries():
    table = _mixed_table(14)
    batches = list(TA.table_to_batches(table, 700))
    assert len({id(b.columns[0].dictionary) for b in batches}) > 1
    merged = TO.concat_batches(batches)
    assert merged.to_arrow().to_pylist() == \
        TA.batches_to_table(batches).to_pylist()
    # one dictionary per column after the concatenation: ranks compare
    ranks = merged.columns[0].sort_keys()[merged.row_mask]
    codes = merged.columns[0].data[merged.row_mask]
    values = merged.columns[0].dictionary.values
    by_rank = sorted(zip(ranks.tolist(), codes.tolist()))
    assert [values[c] for _, c in by_rank] == \
        sorted(values[c] for c in codes.tolist())
