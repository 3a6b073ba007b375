"""Batch-level structural operations: concat, gather, compact (counterpart
of `spark_tpu/columnar/ops.py`). All planes stay on the batch's device;
dictionaries stay on the host and follow their codes: a gather keeps the
column's dictionary, a concatenation unifies the parts' dictionaries and
recodes the codes on the device."""

from __future__ import annotations

from typing import Sequence

import torch

from ..types import StructType, dict_encoded
from .batch import (
    EMPTY_DICT, Column, ColumnarBatch, StringDict, _take_codes,
    bucket_capacity, merge_string_dicts,
)


def unify_string_columns(cols: Sequence[Column]
                         ) -> tuple[StringDict, list[torch.Tensor]]:
    """Merge the dictionaries of string columns; returns (merged dict,
    per-column recoded code tensors). Columns sharing one dictionary object
    (the parts of one scan tile, the outputs of one exchange) skip the
    merge; otherwise the merge is O(sum of the dictionaries) on the host
    and one gather per column on the device."""
    dicts = [c.dictionary or EMPTY_DICT for c in cols]
    if all(d is dicts[0] for d in dicts):
        return dicts[0], [c.data for c in cols]
    merged, luts = merge_string_dicts(dicts)
    recoded = []
    for c, lut in zip(cols, luts):
        lut_d = torch.from_numpy(lut).to(c.data.device)
        recoded.append(_take_codes(lut_d, c.data))
    return merged, recoded


def _pad(t: torch.Tensor, cap: int) -> torch.Tensor:
    if t.shape[0] >= cap:
        return t
    return torch.cat([t, torch.zeros(cap - t.shape[0], dtype=t.dtype,
                                     device=t.device)])


def concat_batches(batches: Sequence[ColumnarBatch],
                   schema: StructType | None = None) -> ColumnarBatch:
    """Concatenate batches (same schema) into one larger-capacity batch."""
    if not batches:
        raise ValueError("concat_batches needs at least one batch")
    if len(batches) == 1:
        return batches[0]
    schema = schema or batches[0].schema
    cap = bucket_capacity(sum(b.capacity for b in batches))
    cols: list[Column] = []
    for i, f in enumerate(schema.fields):
        parts = [b.columns[i] for b in batches]
        sd = None
        datas = [p.data for p in parts]
        if dict_encoded(f.dataType):
            sd, datas = unify_string_columns(parts)
        data = _pad(torch.cat(datas), cap)
        validity = None
        if any(p.validity is not None for p in parts):
            vs = [p.validity if p.validity is not None
                  else torch.ones(p.data.shape[0], dtype=torch.bool,
                                  device=p.data.device) for p in parts]
            validity = _pad(torch.cat(vs), cap)
        cols.append(Column(f.dataType, data, validity, sd))
    mask = _pad(torch.cat([b.row_mask for b in batches]), cap)
    nrows = None
    if all(b._num_rows is not None for b in batches):
        nrows = sum(b._num_rows for b in batches)
    return ColumnarBatch(schema, cols, mask, num_rows=nrows)


def gather_batch(batch: ColumnarBatch, indices: torch.Tensor,
                 out_mask: torch.Tensor,
                 schema: StructType | None = None,
                 extra_invalid: torch.Tensor | None = None) -> ColumnarBatch:
    """Row-gather a batch by device `indices` (every index in range) with
    live-row `out_mask`. `extra_invalid`: bool[out_cap] marking rows whose
    gathered values must read as NULL (outer-join null extension)."""
    schema = schema or batch.schema
    cols = []
    for f, c in zip(schema.fields, batch.columns):
        validity = None if c.validity is None else c.validity[indices]
        if extra_invalid is not None:
            validity = ~extra_invalid if validity is None \
                else validity & ~extra_invalid
        cols.append(Column(f.dataType, c.data[indices], validity,
                           c.dictionary))
    return ColumnarBatch(schema, cols, out_mask, num_rows=None)


def compact_batch(batch: ColumnarBatch, target_capacity: int | None = None
                  ) -> ColumnarBatch:
    """Drop dead rows: move live rows to the front and cut to a smaller
    capacity bucket. Syncs the live count to the host."""
    n = batch.num_rows()
    cap = target_capacity or bucket_capacity(max(n, 1))
    if cap >= batch.capacity:
        return batch
    perm = torch.sort((~batch.row_mask).to(torch.int8), stable=True)[1][:cap]
    mask = torch.arange(cap, device=batch.device) < n
    out = gather_batch(batch, perm, mask)
    out._num_rows = n
    return out
