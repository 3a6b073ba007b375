"""Arrow <-> ColumnarBatch interchange (counterpart of
`spark_tpu/columnar/arrow.py`): Arrow slices are dictionary-encoded, padded
to a capacity bucket and copied to the session's device; collect
concatenates each tile's live rows back into one table.

Strings are dictionary-encoded per slice by `pyarrow.compute.
dictionary_encode`, as the reference does, so codes and dictionary order
match it (a null takes code 0 and validity false); binary columns the same
way, their dictionaries holding `bytes`. Array, map and struct columns
dictionary-encode their Python values (`to_pylist`; a map becomes a dict)
by canonical form (`encode_values`). Decimals become int64 scaled by
10^scale through the reference's float64 path, vectorised. A timestamp of
any unit or zone is cast to timestamp[us] (a zone's wall clock is dropped:
the value is its UTC instant, as the reference reads it)."""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..types import (
    ArrayType, BooleanType, DataType, DateType, DecimalType, MapType,
    StringType, StructField, StructType, TimestampType, from_arrow_type,
)
from ..utils.device_memo import seed_dense_range_memo
from .batch import (
    Column, ColumnarBatch, StringDict, bucket_capacity, empty_entry,
    encode_values, harvest_runs,
)

__all__ = ["schema_from_arrow", "table_to_batches", "batches_to_table",
           "record_batch_to_columnar"]


def schema_from_arrow(aschema: pa.Schema) -> StructType:
    return StructType([
        StructField(f.name, from_arrow_type(f.type), f.nullable)
        for f in aschema
    ])


def _chunked_to_numpy(arr: pa.ChunkedArray | pa.Array, dt: DataType):
    """-> (data ndarray in the type's host dtype, validity ndarray | None,
    StringDict | None)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    validity = None
    if arr.null_count:
        validity = np.asarray(arr.is_valid())
    if isinstance(dt, StringType):
        darr = arr if pa.types.is_dictionary(arr.type) \
            else pc.dictionary_encode(arr)
        if isinstance(darr, pa.ChunkedArray):
            darr = darr.combine_chunks()
        codes = np.asarray(darr.indices.fill_null(0)).astype(np.int32)
        values = darr.dictionary.to_pylist()
        return codes, validity, StringDict(
            [v if v is not None else empty_entry(dt) for v in values])
    if isinstance(dt, (ArrayType, MapType, StructType)):
        vals = arr.to_pylist()
        if isinstance(dt, MapType):
            # Arrow gives a map as its list of (key, value) pairs
            vals = [dict(v) if v is not None else None for v in vals]
        uniq, codes = encode_values(vals)
        return codes, validity, StringDict(uniq or [empty_entry(dt)])
    if isinstance(dt, DecimalType):
        # the reference's conversion: float64 times 10^scale, rounded to
        # the nearest integer (exact for decimals of up to 15 digits)
        scaled = pc.multiply(pc.cast(arr, pa.float64()), 10.0 ** dt.scale)
        data = np.rint(np.asarray(scaled.fill_null(0))).astype(np.int64)
        return data, validity, None
    if isinstance(dt, DateType):
        data = np.asarray(arr.fill_null(0)).astype("datetime64[D]") \
            .astype(np.int32)
    elif isinstance(dt, TimestampType):
        a = pc.cast(arr, pa.timestamp("us"))
        data = np.asarray(a.fill_null(0)).astype("datetime64[us]") \
            .astype(np.int64)
    elif isinstance(dt, BooleanType):
        data = np.asarray(arr.fill_null(False)).astype(bool)
    else:
        data = np.asarray(arr.fill_null(0)).astype(dt.numpy_dtype)
    return data, validity, None


def _live_range(data: np.ndarray, validity, runs) -> tuple:
    """(min, max, any_live) of an integral host plane's live rows: the
    ends of a sorted column's runs, else one null-aware pass of Arrow's
    min_max over the plane itself, its validity packed as Arrow's bitmap
    (no copy of the valid values)."""
    if runs is not None and runs.is_sorted:
        return runs.first, runs.last, True
    bits = None if validity is None else pa.py_buffer(
        np.packbits(validity, bitorder="little"))
    mm = pc.min_max(pa.Array.from_buffers(
        pa.from_numpy_dtype(data.dtype), len(data),
        [bits, pa.py_buffer(np.ascontiguousarray(data))]))
    lo = mm["min"].as_py()
    return (0, 0, False) if lo is None else (lo, mm["max"].as_py(), True)


def record_batch_to_columnar(rb: pa.RecordBatch | pa.Table,
                             schema: StructType, capacity: int,
                             device: torch.device | str,
                             num_rows: int | None = None) -> ColumnarBatch:
    """Ingest one Arrow slice into a device tile of `capacity` rows.

    While each plane is still host numpy, an integral column with no
    validity plane gets its RunInfo (`harvest_runs`, as the reference's
    ingest), and the dense-range memo is seeded for the tile's tensors:
    an integral column's live (min, max, any_live), a dictionary column's
    code span (0, len(dict) - 1, any_live), so a dense decision over the
    tile reads nothing from the device."""
    n = num_rows if num_rows is not None else rb.num_rows
    cols, ranges = [], {}
    for i, f in enumerate(schema.fields):
        data, validity, sd = _chunked_to_numpy(rb.column(i), f.dataType)
        pad = np.zeros(capacity, dtype=f.dataType.numpy_dtype)
        pad[:n] = data[:capacity]
        v, runs = None, None
        if validity is not None:
            vm = np.zeros(capacity, dtype=bool)
            vm[:n] = validity[:capacity]
            v = torch.from_numpy(vm).to(device)
        else:
            runs = harvest_runs(f.dataType, pad, min(n, capacity))
        cols.append(Column(f.dataType, torch.from_numpy(pad).to(device), v,
                           sd, runs))
        if sd is not None:
            ranges[i] = (0, max(len(sd) - 1, 0), n > 0 and (
                validity is None or bool(validity[:n].any())))
        elif pad.dtype.kind == "i":
            ranges[i] = _live_range(data[:capacity], None if validity is None
                                    else validity[:capacity], runs)
    mask = torch.zeros(capacity, dtype=torch.bool, device=device)
    mask[:n] = True
    for i, rng in ranges.items():
        seed_dense_range_memo(cols[i], mask, rng)
    return ColumnarBatch(schema, cols, mask, num_rows=n)


def table_to_batches(table: pa.Table, rows_per_batch: int,
                     schema: StructType | None = None,
                     device: torch.device | str = "cpu"
                     ) -> Iterator[ColumnarBatch]:
    """Slice an Arrow table into fixed-capacity ColumnarBatches."""
    if schema is None:
        schema = schema_from_arrow(table.schema)
    n = table.num_rows
    if n == 0:
        yield ColumnarBatch.empty(schema, device)
        return
    for start in range(0, n, rows_per_batch):
        chunk_rows = min(rows_per_batch, n - start)
        # size the tile to the DATA (power-of-two bucket), not the maximum
        yield record_batch_to_columnar(
            table.slice(start, rows_per_batch), schema,
            bucket_capacity(chunk_rows), device, num_rows=chunk_rows)


def batches_to_table(batches: Iterable[ColumnarBatch]) -> pa.Table:
    tables = [b.to_arrow() for b in batches]
    if not tables:
        raise ValueError("no batches")
    # an all-empty result keeps one empty table for its schema
    return pa.concat_tables([t for t in tables if t.num_rows] or tables[:1])
