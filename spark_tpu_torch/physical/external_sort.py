"""External (memory-bounded) sort: range-bucket multi-pass (the port's copy
of `spark_tpu/physical/external_sort.py`).

A sort partition over the device budget (exec/memory.py) is range-bucketed
by its leading sort key with the range exchange's own device path
(exec/shuffle.range_partition_batch: the bucket ids, a stable group by
bucket and the histogram kernel's counts), into per-bucket device buffers,
and each bucket, which fits the budget, is sorted on its own by the full
multi-key sort. Equal leading keys always share a bucket (a search among
sampled bounds), so bucket order times in-bucket order is the total order,
and there is no merge pass.

The bounds are quantiles of host samples of the leading key (at most 4,096
live non-null keys of each tile, memoised per tile), numeric or string.
Null leading keys go to the first or the last bucket as they sort, NaN
sorts as the greatest value, as in the in-tile sort, and a bucket that
still exceeds the budget (a skewed leading key) is sorted whole and
counted as `sort.external.oversizedBucket`. Each call counts one
`sort.external.passes`. The reference's host buffers and their spilling
are not ported: the buckets stay on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar.batch import EMPTY_DICT, ColumnarBatch, bucket_capacity
from ..exec.shuffle import _OutBuffer, _slice_into, range_partition_batch
from ..types import StringType
from ..utils.device_memo import memo_device_scalars

_SAMPLE_PER_BATCH = 4096
_MAX_BUCKETS = 1 << 10


def _live_rows(b: ColumnarBatch, col) -> torch.Tensor:
    m = b.row_mask if col.validity is None else b.row_mask & col.validity
    return torch.nonzero(m).squeeze(1)


def _batch_numeric_samples(b: ColumnarBatch, kpos: int) -> np.ndarray:
    """Leading-sort-key samples of one batch (live, non-null, not NaN),
    memoised per device-tensor identity. Treat the array as immutable."""
    col = b.columns[kpos]

    def compute():
        keys = col.sort_keys()[_live_rows(b, col)].cpu().numpy()
        if keys.dtype.kind == "f":
            keys = keys[~np.isnan(keys)]
        return keys[:_SAMPLE_PER_BATCH]

    return memo_device_scalars(("extsort_sample", kpos),
                               (col.data, col.validity, b.row_mask), compute)


def _sample_numeric_bounds(part, kpos: int, num_buckets: int):
    """Quantile bounds in the sort-key domain from per-batch samples."""
    samples = [_batch_numeric_samples(b, kpos) for b in part]
    allv = np.concatenate(samples) if samples else np.zeros(0)
    if allv.size == 0:
        return None
    s = np.sort(allv)
    qs = (np.arange(1, num_buckets) * len(s)) // num_buckets
    return np.unique(s[qs])


def _batch_string_samples(b: ColumnarBatch, kpos: int) -> tuple:
    """Live non-null string samples of one batch, memoised like the
    numeric ones."""
    col = b.columns[kpos]

    def compute():
        codes = col.data[_live_rows(b, col)[:_SAMPLE_PER_BATCH]]
        values = (col.dictionary or EMPTY_DICT).values
        return tuple(values[c] for c in codes.tolist())

    return memo_device_scalars(("extsort_sample_str", kpos),
                               (col.data, col.validity, b.row_mask), compute)


def _sample_string_bounds(part, kpos: int, num_buckets: int):
    samples: list = []
    for b in part:
        samples.extend(_batch_string_samples(b, kpos))
    if not samples:
        return None
    s = sorted(samples)
    qs = (np.arange(1, num_buckets) * len(s)) // num_buckets
    return sorted(set(s[q] for q in qs))


def num_buckets(total_capacity: int, budget_rows: int) -> int:
    """Buckets asked for: twice the tiles the budget needs, at least 4."""
    return min(_MAX_BUCKETS,
               2 * max(2, -(-total_capacity // max(budget_rows, 1))))


def external_sort(part, orders, schema, child_output, ctx,
                  budget_rows: int, sort_single) -> list:
    """Sort one partition whose total capacity exceeds `budget_rows`.
    Returns the sorted batches in bucket order; `sort_single(batches) ->
    ColumnarBatch` is the in-budget single-tile sort (SortExec's)."""
    nb = num_buckets(sum(b.capacity for b in part), budget_rows)
    first = orders[0]
    kpos = next(i for i, a in enumerate(child_output)
                if a.expr_id == first.child.expr_id)
    string_key = isinstance(schema.fields[kpos].dataType, StringType)
    bounds = (_sample_string_bounds(part, kpos, nb) if string_key
              else _sample_numeric_bounds(part, kpos, nb))
    if bounds is None or len(bounds) == 0:
        # an all-null or empty leading key: one bucket, the plain sort
        return [sort_single(part)]
    B = len(bounds) + 1
    ctx.metrics.peak("sort.external.buckets", B)
    dev_bounds = bounds if string_key \
        else torch.as_tensor(bounds, device=ctx.device)
    bufs = [_OutBuffer(schema) for _ in range(B)]
    for batch in part:
        gathered, counts = range_partition_batch(
            batch, kpos, dev_bounds, not first.ascending,
            first.nulls_first_effective, B)
        ctx.launches.add("extsort_bucket")
        _slice_into(bufs, gathered, counts)

    ctx.memory.count("sort.external.passes")
    tile = bucket_capacity(max(budget_rows, 1))
    out = []
    for buf in bufs:
        if buf.rows == 0:
            continue
        if buf.rows > budget_rows:
            ctx.memory.count("sort.external.oversizedBucket")
        out.append(sort_single(buf.build(tile, ctx.device)))
    if not out:
        out.append(ColumnarBatch.empty(schema, ctx.device))
    return out
