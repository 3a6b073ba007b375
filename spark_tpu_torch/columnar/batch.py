"""Columnar batch substrate: fixed-capacity device tiles (counterpart of
`spark_tpu/columnar/batch.py`).

Every batch has a power-of-two `capacity`; live rows are marked by a bool
`row_mask` tensor, so filters never change tensor shapes. A column is a
tensor in its type's device dtype plus an optional bool validity plane.
String columns are dictionary-encoded: int32 codes on the device, the UTF-8
values on the host in a `StringDict`, whose value hashes (the equality
domain) and lexicographic ranks (the ORDER BY domain) cross to the device
once per dictionary. Binary, array, map and struct columns are encoded the
same way, their dictionaries holding `bytes`, lists and dicts: an entry's
hash is the string hash of its canonical form (`canon_value`, where a map's
items are sorted, so two insertion orders are one key), and its rank
orders lists element by element and structs field by field. Decimal
columns are int64 scaled by 10^scale; timestamps int64 microseconds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ..types import (
    ArrayType, BinaryType, BooleanType, DateType, DecimalType, MapType,
    NullType, StringType, StructType, TimestampType, dict_encoded,
    to_arrow_type,
)

__all__ = ["StringDict", "Column", "ColumnarBatch", "bucket_capacity",
           "EMPTY_DICT", "hash_strings", "merge_string_dicts",
           "canon_value", "encode_values", "empty_entry"]


def bucket_capacity(n: int, minimum: int = 1 << 10) -> int:
    """Round a row count up to a power-of-two capacity bucket (1024 floor),
    the same buckets the JAX package uses."""
    cap = minimum
    while cap < n:
        cap <<= 1
    return cap


# ---------------------------------------------------------------------------
# Value hashes: the reference's 64-bit string hash (native/sparktpu_native.cpp
# hash_bytes64, xxhash64-style mixing), bit for bit, vectorised over the
# strings of one byte length at a time
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1
_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)
_P4 = np.uint64(0x85EBCA77C2B2AE63)
_P5 = np.uint64(0x27D4EB2F165667C5)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _word(buf: np.ndarray, pos: int, width: int) -> np.ndarray:
    """Little-endian unsigned words of `width` bytes at byte `pos` of
    each row of `buf` (uint8 [k, L]), as uint64."""
    w = np.ascontiguousarray(buf[:, pos:pos + width])
    return w.view("<u8" if width == 8 else "<u4")[:, 0].astype(np.uint64)


def _hash_rows(buf: np.ndarray) -> np.ndarray:
    """hash_bytes64 of each row of `buf`: k strings of one byte length L."""
    k, n = buf.shape
    p = 0
    if n >= 32:
        v = [np.full(k, (int(_P1) + int(_P2)) & _MASK64, np.uint64),
             np.full(k, _P2, np.uint64), np.zeros(k, np.uint64),
             np.full(k, (-int(_P1)) & _MASK64, np.uint64)]
        while p + 32 <= n:
            for j in range(4):
                v[j] = _rotl(v[j] + _word(buf, p + 8 * j, 8) * _P2, 31) * _P1
            p += 32
        h = _rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + \
            _rotl(v[3], 18)
    else:
        h = np.full(k, _P5, np.uint64)
    h = h + np.uint64(n)
    while p + 8 <= n:
        h ^= _rotl(_word(buf, p, 8) * _P2, 31) * _P1
        h = _rotl(h, 27) * _P1 + _P4
        p += 8
    if p + 4 <= n:
        h ^= _word(buf, p, 4) * _P1
        h = _rotl(h, 23) * _P2 + _P3
        p += 4
    while p < n:
        h ^= buf[:, p].astype(np.uint64) * _P5
        h = _rotl(h, 11) * _P1
        p += 1
    h ^= h >> np.uint64(33)
    h *= _P2
    h ^= h >> np.uint64(29)
    h *= _P3
    h ^= h >> np.uint64(32)
    return h


def canon_value(v):
    """The hashable canonical form of a dictionary entry (the reference's
    `canon_value`): a dict's items sorted by key, since a map has no order
    (two insertion orders are one map; a struct's fields have one order,
    so sorting them is harmless), a list as a tuple."""
    if isinstance(v, dict):
        return tuple(sorted((k, canon_value(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple, np.ndarray)):
        return tuple(canon_value(x) for x in v)
    if isinstance(v, np.generic):
        # a host UDF's numpy scalar hashes as the Python value it equals
        return v.item()
    return v


def encode_values(values, codes: np.ndarray | None = None):
    """Dictionary-encode a sequence of Python values by canonical form
    (None takes code 0; the caller keeps the validity). Returns (unique
    values in first-occurrence order, int32 codes)."""
    if codes is None:
        codes = np.zeros(len(values), np.int32)
    uniq: list = []
    index: dict = {}
    for i, v in enumerate(values):
        if v is None:
            continue
        k = canon_value(v)
        j = index.get(k)
        if j is None:
            j = index[k] = len(uniq)
            uniq.append(v)
        codes[i] = j
    return uniq, codes


def empty_entry(dt):
    """The placeholder entry of an empty dictionary of type `dt`."""
    if isinstance(dt, ArrayType):
        return []
    if isinstance(dt, (MapType, StructType)):
        return {}
    if isinstance(dt, BinaryType):
        return b""
    return ""


def _entry_bytes(v) -> bytes:
    """The bytes an entry hashes: a string's UTF-8, a blob as it is, a
    nested value's canonical form's repr."""
    if isinstance(v, str):
        return v.encode("utf-8")
    if isinstance(v, bytes):
        return v
    return repr(canon_value(v)).encode("utf-8", "surrogatepass")


def _order_key(v):
    """A key that orders nested entries: None first, lists element by
    element (Python's list order), dicts by their items in order (a
    struct's fields in schema order)."""
    if v is None:
        return (0,)
    if isinstance(v, dict):
        return (1, tuple((k, _order_key(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return (1, tuple(_order_key(x) for x in v))
    return (1, v)


def hash_strings(values: Sequence) -> np.ndarray:
    """int64 hash of each string's UTF-8 bytes, equal to the reference's
    `spark_tpu/utils/native.py` hash_strings bit for bit. O(total bytes)
    numpy work, grouped by byte length. A `bytes` entry hashes its bytes,
    a nested entry its canonical form (`_entry_bytes`)."""
    enc = [_entry_bytes(v) for v in values]
    out = np.empty(len(enc), np.uint64)
    lens = np.fromiter((len(e) for e in enc), np.int64, len(enc))
    for n in np.unique(lens):
        idx = np.nonzero(lens == n)[0]
        blob = b"".join(enc[i] for i in idx)
        buf = np.frombuffer(blob, np.uint8).reshape(len(idx), int(n))
        out[idx] = _hash_rows(buf)
    return out.view(np.int64)


class StringDict:
    """Host-side dictionary of a string column: its unique UTF-8 values
    (or `bytes`, lists and dicts for binary, array, map and struct
    columns).

    Derivatives, each computed once per dictionary (O(|dictionary|), never
    O(rows)):
      * hashes: int64 value hash per entry, the equality domain that lets
        columns with different dictionaries compare (joins, group-by,
        exchanges, `=`/`<>`);
      * ranks: int32 lexicographic rank per entry, the ORDER BY domain;
      * their device copies, one per device.
    """

    __slots__ = ("values", "_index", "_hashes", "_ranks", "_device",
                 "_transforms", "_merges")

    def __init__(self, values: Sequence[str]):
        self.values: list[str] = list(values)
        self._index: dict[str, int] | None = None
        self._hashes: np.ndarray | None = None
        self._ranks: np.ndarray | None = None
        self._device: dict = {}  # (kind, device) -> tensor
        self._transforms: dict = {}  # transform key -> (dict, lut | None)
        self._merges: list = []  # [(dictionaries, merge result)], newest last

    def __len__(self) -> int:
        return len(self.values)

    @property
    def nested(self) -> bool:
        """True where the entries are lists or dicts."""
        return bool(self.values) and isinstance(self.values[0],
                                                (list, dict, tuple))

    @property
    def index(self) -> dict:
        """Entry -> code, keyed by canonical form (`canon_value`)."""
        if self._index is None:
            self._index = {canon_value(v): i
                           for i, v in enumerate(self.values)}
        return self._index

    @property
    def hashes(self) -> np.ndarray:
        if self._hashes is None:
            self._hashes = hash_strings(self.values)
        return self._hashes

    @property
    def ranks(self) -> np.ndarray:
        if self._ranks is None:
            if self.nested:
                order = np.array(sorted(range(len(self.values)), key=lambda
                                        i: _order_key(self.values[i])),
                                 dtype=np.int64)
            else:
                order = np.argsort(_object_array(self.values),
                                   kind="stable")
            r = np.empty(len(self.values), dtype=np.int32)
            r[order] = np.arange(len(self.values), dtype=np.int32)
            self._ranks = r
        return self._ranks

    def _on(self, kind: str, device, make) -> torch.Tensor:
        key = (kind, str(device))
        t = self._device.get(key)
        if t is None:
            t = self._device[key] = torch.from_numpy(make()).to(device)
        return t

    def device_hashes(self, device) -> torch.Tensor:
        """The value hashes on `device`; an empty dictionary has one
        padding entry, so a clamped code always indexes in range."""
        return self._on("hashes", device, lambda: self.hashes
                        if len(self.values) else np.zeros(1, np.int64))

    def device_ranks(self, device) -> torch.Tensor:
        return self._on("ranks", device, lambda: self.ranks
                        if len(self.values) else np.zeros(1, np.int32))

    def device_hash_lut(self) -> np.ndarray:
        """The value hashes padded to a bucketed length (a power of two,
        8 at least, the last entry repeated), so a fused program's key does
        not change with every dictionary size (reference:
        `spark_tpu/columnar/batch.py` StringDict.device_hash_lut). Fused
        string hash keys and fused probes over strings read it as an input
        of their program."""
        from ..expr.eval import pad_pow2

        return pad_pow2(self.hashes if len(self.values)
                        else np.zeros(1, np.int64))

    def rank_luts(self) -> tuple[np.ndarray, np.ndarray]:
        """(code -> rank, rank -> code), int32, one padding entry each in
        an empty dictionary: a min/max over the column reduces ranks and
        maps the winner back to its code."""
        r = self.ranks if len(self.values) else np.zeros(1, np.int32)
        inv = np.empty(len(r), dtype=np.int32)
        inv[r] = np.arange(len(r), dtype=np.int32)
        return r, inv

    def device_rank_to_code(self, device) -> torch.Tensor:
        """Inverse of ranks: rank -> dictionary code."""
        return self._on("rank_to_code", device, lambda: self.rank_luts()[1])

    def map_values(self, fn) -> "StringDict":
        """Apply a host string -> string function to every entry: how
        substr and the other dictionary transforms run in O(|dictionary|)."""
        return StringDict([fn(v) for v in self.values])

    def transformed(self, key: str, fn):
        """(StringDict of fn over the values with duplicates removed, None
        or the int32 recode lut (numpy) when fn mapped two values to one),
        memoised per `key`: a dictionary transforms once however many
        batches share it."""
        hit = self._transforms.get(key)
        if hit is None:
            mapped = self.map_values(fn)
            uniq, (lut,) = merge_string_dicts([mapped])
            if len(uniq) == len(mapped):
                hit = (mapped, None)
            else:
                hit = (StringDict(uniq.values), lut)
            self._transforms[key] = hit
        return hit

    @staticmethod
    def merged(a: "StringDict", b: "StringDict"):
        """Union two dictionaries; returns (merged, recode_a, recode_b) where
        recode_x maps old codes -> merged codes."""
        md, (ra, rb) = merge_string_dicts([a, b])
        return md, ra, rb


def _object_array(values) -> np.ndarray:
    """A 1-D object array of `values` (np.array would make equal-length
    lists 2-D)."""
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


_MERGES_KEPT = 8


def merge_string_dicts(dicts: Sequence[StringDict]):
    """Union several dictionaries in first-occurrence order (the order of
    the reference's native merge); returns (merged StringDict, [int32
    recode array per dictionary]). An empty dictionary's recode is one 0
    entry, so a clamped code always indexes in range. The last few merges
    are memoised on the first dictionary, by the identity of the inputs:
    tiles cached in the session merge once however often a query runs."""
    memo = dicts[0]._merges if dicts else []
    for key, hit in memo:
        if len(key) == len(dicts) and all(a is b for a, b in zip(key, dicts)):
            return hit
    merged: list = []
    idx: dict = {}
    recodes = []
    for d in dicts:
        lut = np.zeros(max(len(d.values), 1), dtype=np.int32)
        # nested entries merge by canonical form (a map's two insertion
        # orders are one entry); strings and blobs by value
        key = canon_value if d.nested else (lambda v: v)
        for i, v in enumerate(d.values):
            k = key(v)
            j = idx.get(k)
            if j is None:
                j = idx[k] = len(merged)
                merged.append(v)
            lut[i] = j
        recodes.append(lut)
    hit = (StringDict(merged), recodes)
    if dicts:
        memo.append((tuple(dicts), hit))
        del memo[:-_MERGES_KEPT]
    return hit


EMPTY_DICT = StringDict([])


def _take_codes(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut[codes] with the codes clamped into the lut: padding and dead
    rows may hold any code, and an index out of range is a device assert
    on the card. A gather (`torch.take`), also for a literal's 0-dim codes,
    which plain indexing would read on the host."""
    return torch.take(lut, codes.clamp(0, lut.shape[0] - 1).to(torch.int64))


def harvest_runs(dtype, pad: np.ndarray, n: int):
    """The RunInfo of a host plane's first `n` rows, harvested at ingest
    under the reference's conditions: a signed integral plane, not
    dictionary-encoded, and the harvest switch on (the caller checks that
    there is no validity plane). None otherwise."""
    from .encoding import column_runs, runs_harvest_enabled

    if pad.dtype.kind != "i" or dict_encoded(dtype) or \
            not runs_harvest_enabled():
        return None
    return column_runs(pad, n)


@dataclass(frozen=True)
class Column:
    """One column of a batch: device data + optional validity plane.

    data: tensor [capacity] in dtype.device_dtype
    validity: bool tensor [capacity] or None (= no nulls)
    dictionary: the StringDict of a dictionary-encoded column (string,
        binary, array, map, struct; codes index it)
    runs: the host-side RunInfo (columnar/encoding.py) harvested at ingest
        from an integral plane with no validity; it describes `data`, so a
        column built over a new plane starts with None, and only an
        operator that passes this data through row for row (a mask-only
        filter, a pass-through projection) keeps it
    """

    dtype: Any
    data: torch.Tensor
    validity: torch.Tensor | None = None
    dictionary: StringDict | None = None
    runs: Any = None

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, StringType)

    def eq_keys(self) -> torch.Tensor:
        """Tensor usable as an equality key (group-by, join, exchange
        hashing). Dictionary-encoded columns map codes to 64-bit value
        hashes, so columns with different dictionaries compare correctly
        (a nested entry's hash is its canonical form's)."""
        if dict_encoded(self.dtype):
            sd = self.dictionary or EMPTY_DICT
            return _take_codes(sd.device_hashes(self.data.device), self.data)
        if isinstance(self.dtype, BooleanType):
            return self.data.to(torch.int32)
        return self.data

    def sort_keys(self) -> torch.Tensor:
        """Tensor whose numeric order is SQL ORDER BY order (strings by
        dictionary rank; booleans as int32: the card's sort takes no bool
        keys)."""
        if dict_encoded(self.dtype):
            sd = self.dictionary or EMPTY_DICT
            return _take_codes(sd.device_ranks(self.data.device), self.data)
        if isinstance(self.dtype, BooleanType):
            return self.data.to(torch.int32)
        return self.data


class ColumnarBatch:
    """A fixed-capacity tile of rows. `num_rows` is the host-known live
    count when available (None after a device-side filter until counted)."""

    __slots__ = ("schema", "columns", "row_mask", "_num_rows")

    def __init__(self, schema: StructType, columns: Sequence[Column],
                 row_mask: torch.Tensor, num_rows: int | None = None):
        if len(schema.fields) != len(columns):
            raise ValueError(f"{len(schema.fields)} fields, "
                             f"{len(columns)} columns")
        self.schema = schema
        self.columns = list(columns)
        self.row_mask = row_mask
        self._num_rows = num_rows

    @property
    def capacity(self) -> int:
        return int(self.row_mask.shape[0])

    @property
    def device(self) -> torch.device:
        return self.row_mask.device

    def num_rows(self) -> int:
        """Live row count; syncs with the device if unknown."""
        if self._num_rows is None:
            self._num_rows = int(self.row_mask.sum().item())
        return self._num_rows

    # --- construction ------------------------------------------------------
    @staticmethod
    def from_numpy(schema: StructType, arrays: Sequence[np.ndarray],
                   validities: Sequence[np.ndarray | None] | None = None,
                   capacity: int | None = None,
                   device: torch.device | str = "cpu",
                   row_mask: np.ndarray | None = None) -> "ColumnarBatch":
        """Build a tile from host planes. Without `row_mask` the first n
        rows are live; with it (e.g. the planes of a JAX batch, taken with
        np.asarray) the mask is used as given. String columns get the empty
        dictionary (their codes index nothing)."""
        n = int(arrays[0].shape[0]) if arrays else 0
        if row_mask is not None:
            n = int(row_mask.shape[0])
        cap = capacity or bucket_capacity(max(n, 1))
        validities = validities or [None] * len(arrays)
        cols = []
        for f, arr, v in zip(schema.fields, arrays, validities):
            pad = np.zeros(cap, dtype=f.dataType.numpy_dtype)
            pad[:n] = np.asarray(arr, dtype=f.dataType.numpy_dtype)[:cap]
            vv = None
            if v is not None:
                vm = np.zeros(cap, dtype=bool)
                vm[:n] = np.asarray(v, dtype=bool)[:cap]
                vv = torch.from_numpy(vm).to(device)
            runs = None
            if v is None and row_mask is None:
                runs = harvest_runs(f.dataType, pad, min(n, cap))
            cols.append(Column(f.dataType, torch.from_numpy(pad).to(device),
                               vv, EMPTY_DICT if dict_encoded(f.dataType)
                               else None, runs))
        mask = np.zeros(cap, dtype=bool)
        if row_mask is not None:
            mask[:n] = np.asarray(row_mask, dtype=bool)[:cap]
            nrows = int(mask.sum())
        else:
            mask[:n] = True
            nrows = n
        return ColumnarBatch(schema, cols, torch.from_numpy(mask).to(device),
                             num_rows=nrows)

    @staticmethod
    def empty(schema: StructType, device: torch.device | str = "cpu",
              capacity: int = 1 << 10) -> "ColumnarBatch":
        return ColumnarBatch.from_numpy(
            schema, [np.zeros(0, dtype=f.dataType.numpy_dtype)
                     for f in schema.fields],
            capacity=capacity, device=device)

    # --- host materialization ---------------------------------------------
    def to_arrow(self):
        import pyarrow as pa

        # select the live rows on the device, so only they cross to the host
        sel = torch.nonzero(self.row_mask).squeeze(1)
        arrays = []
        for f, c in zip(self.schema.fields, self.columns):
            at = to_arrow_type(f.dataType)
            if isinstance(f.dataType, NullType):
                arrays.append(pa.nulls(int(sel.shape[0])))
                continue
            data = c.data[sel].cpu().numpy()
            mask = None
            if c.validity is not None:
                mask = ~c.validity[sel].cpu().numpy()
            if isinstance(f.dataType, StringType):
                # decode through the dictionary on the host: a dictionary
                # array over the live codes, cast to plain strings
                sd = c.dictionary or EMPTY_DICT
                codes = np.clip(data, 0, max(len(sd) - 1, 0)).astype(np.int32)
                values = pa.array(sd.values or [empty_entry(f.dataType)],
                                  type=at)
                arrays.append(pa.DictionaryArray.from_arrays(
                    pa.array(codes, mask=mask), values).cast(at))
                continue
            if dict_encoded(f.dataType):
                arrays.append(nested_array(c.dictionary or EMPTY_DICT,
                                           data, mask, f.dataType, at))
                continue
            if isinstance(f.dataType, DecimalType):
                arrays.append(decimal_array(data, mask, at))
                continue
            if isinstance(f.dataType, DateType):
                data = data.astype(np.int32)
            elif isinstance(f.dataType, TimestampType):
                data = data.astype(np.int64)
            arrays.append(pa.array(data, type=at, mask=mask))
        return pa.table(arrays, names=self.schema.names)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"ColumnarBatch(cap={self.capacity}, rows={self._num_rows}, "
                f"schema={self.schema.simple_string()})")


def nested_array(sd: StringDict, codes: np.ndarray,
                 null_mask: np.ndarray | None, dt, at):
    """An Arrow array of an array, map or struct column: its dictionary's
    entries, each converted once, taken by the live codes (a map entry as
    its list of items, as Arrow takes maps)."""
    import pyarrow as pa

    values = sd.values or [empty_entry(dt)]
    if isinstance(dt, MapType):
        values = [list(v.items()) if isinstance(v, dict) else v
                  for v in values]
    entries = pa.array(values, type=at)
    idx = np.clip(codes, 0, len(values) - 1).astype(np.int32)
    return entries.take(pa.array(idx, mask=null_mask))


def decimal_array(unscaled: np.ndarray, null_mask: np.ndarray | None, at):
    """A decimal128 Arrow array from int64 unscaled values, exact and
    vectorised: each value sign-extended into a 16-byte little-endian
    word."""
    import pyarrow as pa

    v = np.ascontiguousarray(unscaled, dtype=np.int64)
    words = np.empty((len(v), 2), dtype=np.int64)
    words[:, 0] = v
    words[:, 1] = v >> 63
    validity = None
    if null_mask is not None and null_mask.any():
        validity = pa.py_buffer(np.packbits(~null_mask, bitorder="little"))
    return pa.Array.from_buffers(at, len(v),
                                 [validity, pa.py_buffer(words.tobytes())])
