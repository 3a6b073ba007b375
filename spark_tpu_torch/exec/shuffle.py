"""Shuffle: redistribute rows across partitions (counterpart of
`spark_tpu/exec/shuffle.py`, the device path of the hash, round-robin
and range exchanges).

Partition ids are computed on the device for a whole batch, rows are
grouped by pid with one stable sort, and the grouped columns are sliced into
per-reducer buffers. The JAX package pulls the grouped columns to the host
for slicing; here they stay on the device: one gather per column, the
per-partition counts (from the histogram kernel) cross to the host, and
each reducer's slices are concatenated into tiles on the device. A string
column's slices carry their map batch's dictionary; a reducer tile unifies
the dictionaries of its slices (one host merge per distinct set, a device
recode per slice). A string range key maps each dictionary value to its
partition on the host (a search among the sampled bounds), and the codes
take that lut on the device. The same per-batch paths serve the external
sort's bucketing (physical/external_sort.py) and the grace join's
fragmenting (`shuffle_hash` with its own seed). Not ported: spilling the
reducer buffers to disk (they stay on the device) and the map-side column
stats that seed the JAX package's dense-range memo and its adaptive
runtime filter.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..columnar.batch import (
    EMPTY_DICT, Column, ColumnarBatch, _take_codes, bucket_capacity,
)
from ..columnar.ops import unify_string_columns
from ..exec.context import ExecContext
from ..types import StructType, dict_encoded

Partition = list


class _OutBuffer:
    """Accumulates device row slices for one reducer partition."""

    def __init__(self, schema: StructType):
        self.schema = schema
        # per append: [(data, validity, dictionary), ...]
        self.chunks: list[list] = []
        self._chunk_rows: list[int] = []

    @property
    def rows(self) -> int:
        return sum(self._chunk_rows)

    def append(self, cols: list, n: int):
        if not n:
            return
        self.chunks.append(cols)
        self._chunk_rows.append(n)

    def _build_tile(self, chunks: list[list], device) -> ColumnarBatch:
        """Merge a group of chunks into one device tile."""
        n = sum(c[0][0].shape[0] for c in chunks) if chunks else 0
        cap = bucket_capacity(max(n, 1))
        cols = []
        for i, f in enumerate(self.schema.fields):
            data = torch.zeros(cap, dtype=f.dataType.device_dtype,
                               device=device)
            sd = None
            datas = [c[i][0] for c in chunks]
            if dict_encoded(f.dataType):
                sd, datas = unify_string_columns(
                    [Column(f.dataType, c[i][0], None, c[i][2])
                     for c in chunks])
            if n:
                data[:n] = torch.cat(datas)
            validity = None
            if any(c[i][1] is not None for c in chunks):
                validity = torch.zeros(cap, dtype=torch.bool, device=device)
                validity[:n] = torch.cat([
                    c[i][1] if c[i][1] is not None
                    else torch.ones(c[i][0].shape[0], dtype=torch.bool,
                                    device=device) for c in chunks])
            cols.append(Column(f.dataType, data, validity, sd))
        mask = torch.arange(cap, device=device) < n
        return ColumnarBatch(self.schema, cols, mask, num_rows=n)

    def build(self, tile_capacity: int, device) -> Partition:
        """Rebuild tiles of at most `tile_capacity` rows, split at exact
        tile boundaries."""
        if not self.chunks:
            return [ColumnarBatch.empty(self.schema, device)]
        batches: Partition = []
        pend: list[list] = []
        pend_rows = 0
        for chunk, n in zip(self.chunks, self._chunk_rows):
            off = 0
            while n - off > 0:
                take = min(n - off, tile_capacity - pend_rows)
                if off == 0 and take == n:
                    pend.append(chunk)
                else:
                    pend.append([
                        (d[off:off + take],
                         None if v is None else v[off:off + take], sd)
                        for d, v, sd in chunk])
                pend_rows += take
                off += take
                if pend_rows >= tile_capacity:
                    batches.append(self._build_tile(pend, device))
                    pend, pend_rows = [], 0
        if pend or not batches:
            batches.append(self._build_tile(pend, device))
        return batches


def _pull_sorted(batch: ColumnarBatch, perm: torch.Tensor,
                 counts: torch.Tensor) -> tuple[list, list[int]]:
    """Gather columns by perm on the device; counts cross to the host."""
    host_counts = counts.tolist()
    live = perm[: sum(host_counts)]
    gathered = []
    for c in batch.columns:
        gathered.append((c.data[live],
                         None if c.validity is None else c.validity[live],
                         c.dictionary))
    return gathered, host_counts


def hash_partition_batch(batch: ColumnarBatch, key_positions: Sequence[int],
                         num_out: int, seed: int) -> tuple[list, list[int]]:
    """Partition ONE batch by key hash; returns the pid-grouped columns +
    per-partition counts."""
    from ..ops.partition import hash_partition

    keys = [batch.columns[i] for i in key_positions]
    pr = hash_partition([c.eq_keys() for c in keys],
                        [c.validity for c in keys], batch.row_mask,
                        num_out, seed=seed)
    return _pull_sorted(batch, pr.perm, pr.counts)


def rr_partition_batch(batch: ColumnarBatch, num_out: int,
                       start: int) -> tuple[list, list[int]]:
    """Round-robin-partition one batch; `start` is the running live-row
    offset of the exchange."""
    from ..ops.partition import round_robin_partition

    pr = round_robin_partition(batch.row_mask, num_out, start % num_out)
    return _pull_sorted(batch, pr.perm, pr.counts)


def range_partition_batch(batch: ColumnarBatch, key_position: int,
                          bounds: torch.Tensor | list, descending: bool,
                          nulls_first: bool,
                          num_out: int) -> tuple[list, list[int]]:
    """Range-partition one batch against sampled bounds: a tensor of
    numeric bounds, or the sorted string bounds of a string key."""
    from ..ops.partition import _group_by_pid, range_partition

    col = batch.columns[key_position]
    if not col.is_string:
        pr = range_partition(col.sort_keys(), bounds, batch.row_mask,
                             num_out, descending, col.validity, nulls_first)
        return _pull_sorted(batch, pr.perm, pr.counts)
    # each dictionary value's partition on the host, the codes' on the
    # device
    values = (col.dictionary or EMPTY_DICT).values or [""]
    lut = np.searchsorted(np.array(bounds, dtype=object),
                          np.array(values, dtype=object),
                          side="right").astype(np.int32)
    if descending:
        lut = (num_out - 1) - lut
    pids = _take_codes(torch.from_numpy(lut).to(col.data.device), col.data)
    if col.validity is not None:
        null_pid = 0 if nulls_first else num_out - 1
        pids = torch.where(col.validity, pids,
                           torch.full_like(pids, null_pid))
    pr = _group_by_pid(pids, batch.row_mask, num_out)
    return _pull_sorted(batch, pr.perm, pr.counts)


def shuffle_hash(partitions: list[Partition], key_positions: Sequence[int],
                 num_out: int, schema: StructType, ctx: ExecContext,
                 seed: int = 42) -> list[Partition]:
    bufs = [_OutBuffer(schema) for _ in range(num_out)]
    for part in partitions:
        for batch in part:
            gathered, counts = hash_partition_batch(
                batch, key_positions, num_out, seed)
            ctx.launches.add("shuffle_hash")
            _slice_into(bufs, gathered, counts)
    return _finish(bufs, ctx)


def shuffle_round_robin(partitions: list[Partition], num_out: int,
                        schema: StructType, ctx: ExecContext) -> list[Partition]:
    bufs = [_OutBuffer(schema) for _ in range(num_out)]
    start = 0
    for part in partitions:
        for batch in part:
            gathered, counts = rr_partition_batch(batch, num_out, start)
            ctx.launches.add("shuffle_rr")
            _slice_into(bufs, gathered, counts)
            start += sum(counts)
    return _finish(bufs, ctx)


def shuffle_range(partitions: list[Partition], key_position: int,
                  bounds, descending: bool, nulls_first: bool, num_out: int,
                  schema: StructType, ctx: ExecContext) -> list[Partition]:
    """Range shuffle for a global sort. `bounds` is a host array of
    boundary values in the sort-key domain."""
    bufs = [_OutBuffer(schema) for _ in range(num_out)]
    b = bounds if isinstance(bounds, list) \
        else torch.as_tensor(bounds, device=ctx.device)
    for part in partitions:
        for batch in part:
            gathered, counts = range_partition_batch(
                batch, key_position, b, descending, nulls_first, num_out)
            ctx.launches.add("shuffle_range")
            _slice_into(bufs, gathered, counts)
    return _finish(bufs, ctx)


def shuffle_fused(partitions: list[Partition], writer, num_out: int,
                  schema: StructType, ctx: ExecContext) -> list[Partition]:
    """Fused exchange map side: `writer` (physical/fusion.ExchangeFusion
    bound to a partitioning) runs ONE program per input batch (pipeline +
    partition ids + pid-grouped gather) and this loop slices its output
    straight into the reduce buffers once the counts cross to the host: no
    intermediate materialized batch between the stage pipeline and the
    shuffle write. Partitions under spark.tpu.fusion.minRows take the
    unfused kernels instead (pipeline + shuffle kind), as the other fused
    operators' size gate does."""
    from ..config import FUSION_MIN_ROWS

    bufs = [_OutBuffer(schema) for _ in range(num_out)]
    min_rows = int(ctx.conf.get(FUSION_MIN_ROWS))
    start = 0  # running live-row offset (round-robin positioning)
    for part in partitions:
        fused = sum(b.capacity for b in part) >= min_rows
        if not fused:
            ctx.metrics.add("fusion.min_rows_gated", len(part))
        for batch in part:
            if fused:
                gathered, counts = writer.partition_batch(batch, start, ctx)
            else:
                gathered, counts = writer.partition_unfused(batch, start,
                                                            ctx)
            _slice_into(bufs, gathered, counts)
            start += sum(counts)
    return _finish(bufs, ctx)


def gather_single(partitions: list[Partition]) -> list[Partition]:
    """AllTuples: concatenate every partition into one."""
    merged: Partition = []
    for p in partitions:
        merged.extend(p)
    return [merged]


def _slice_into(bufs: list[_OutBuffer], gathered: list, counts: list[int]):
    lo = 0
    for p, n in enumerate(counts):
        hi = lo + n
        if n:
            bufs[p].append([(d[lo:hi], None if v is None else v[lo:hi], sd)
                            for d, v, sd in gathered], n)
        lo = hi


def _finish(bufs: list[_OutBuffer], ctx: ExecContext) -> list[Partition]:
    return [b.build(ctx.conf.batch_capacity, ctx.device) for b in bufs]
