"""Physical operators (counterpart of `spark_tpu/physical/operators.py`):
the scans (`ScanExec` over an `io/sources.py` source, one partition per
split; `LocalTableScanExec`; `RangeExec`), the fused filter+project
`ComputeExec`,
`HashAggregateExec` in partial and final mode with its three kernels —
ungrouped, sorted-segment and dense-range (over an integral key's range or
a string key's dictionary codes) — `SortExec` (the external sort past the
device budget), `LimitExec`, `HashJoinExec` (broadcast or shuffled; a
dense direct-address build or the hash-sorted build with a searchsorted
probe; the grace join past the device budget; the range and bloom runtime
filters; dynamic partition pruning of probe-side scans from the build
side's distinct keys), `NestedLoopJoinExec` (cross joins and non-equi
conditions over a broadcast build side), `UnionExec` and
`CoalescePartitionsExec`. The final aggregate, the sort and the shuffled
join merge small exchange partitions first (physical/adaptive.py).
`execute()` returns a list of partitions, each a list of device
ColumnarBatches; blocking operators concatenate their partition's batches
and run one kernel per chunk.
"""

from __future__ import annotations

import re
import weakref
from typing import Sequence

import torch

from ..columnar.batch import (
    EMPTY_DICT, Column, ColumnarBatch, _take_codes, bucket_capacity,
)
from ..columnar.ops import compact_batch, concat_batches, gather_batch
from ..config import AGG_BLOCK_ROWS, ENCODING_ENABLED
from ..errors import ExecutionError, NotPortedError
from ..exec.context import ExecContext
from ..expr.expressions import (
    Alias, AttributeReference, Expression, SortOrder,
)
from ..ops import grouping as G
from ..ops import joining as J
from ..ops.scatter_kernels import partition_histogram
from ..ops.sorting import SortKeySpec, limit_mask, sort_permutation
from ..plan.tree import TreeNode
from ..types import (
    DateType, DecimalType, IntegralType, StringType, StructField,
    StructType, dict_encoded,
)
from ..utils.device_memo import DENSE_RANGE_KIND, memo_device_scalars
from .aggregates import PARTIAL_TO_MERGE, AggSpec
from .compile import ExprPipeline
from .partitioning import (
    AllTuples, BroadcastDistribution, ClusteredDistribution, Distribution,
    HashPartitioning, Partitioning, RangePartitioning, SinglePartition,
    UnknownPartitioning, UnspecifiedDistribution,
)

Partition = list  # list[ColumnarBatch]

# the grace join's fragmenting hash seed (distinct from the exchange's 42)
GRACE_SEED = 0x9E3779B9


def attrs_schema(attrs: Sequence[AttributeReference]) -> StructType:
    return StructType([StructField(a.name, a.dtype, a.nullable) for a in attrs])


class PhysicalPlan(TreeNode):
    """Base physical operator."""

    @property
    def output(self) -> list[AttributeReference]:
        raise NotImplementedError

    def output_partitioning(self) -> Partitioning:
        ch = self.children
        if ch:
            return ch[0].output_partitioning()
        return UnknownPartitioning(1)

    def required_child_distribution(self) -> list[Distribution]:
        return [UnspecifiedDistribution() for _ in self.children]

    def execute(self, ctx: ExecContext) -> list[Partition]:
        raise NotImplementedError

    def schema(self) -> StructType:
        return attrs_schema(self.output)


# ---------------------------------------------------------------------------
# Scan
# ---------------------------------------------------------------------------

class ScanExec(PhysicalPlan):
    """Columnar scan over a DataSource (role of FileSourceScanExec): one
    partition per split, each split's Arrow table ingested into device
    tiles. A split that the runtime split filter (dynamic partition
    pruning, installed by a join before this scan runs) proves empty reads
    as one empty batch, so the partition count stays stable. Tiles are
    cached only for a source that sets `cache_device_batches`: a file
    source decodes its splits on every run."""

    child_fields = ()

    def __init__(self, source, attrs: list[AttributeReference],
                 name: str = ""):
        self.source = source
        self.attrs = attrs
        self.name = name
        # (partition column name, allowed values)
        self.runtime_split_filter = None

    @property
    def output(self):
        return self.attrs

    def output_partitioning(self):
        return UnknownPartitioning(self.source.num_partitions())

    def _split_pruned(self, i: int) -> bool:
        if self.runtime_split_filter is None:
            return False
        from ..io.sources import UNKNOWN_PARTITION_VALUE

        col, allowed = self.runtime_split_filter
        pv = self.source.split_partition_value(i, col)
        if pv is UNKNOWN_PARTITION_VALUE:
            return False  # conservative: not derivable from the layout
        return pv is None or pv not in allowed  # a null never equals a key

    def execute(self, ctx: ExecContext) -> list[Partition]:
        from ..columnar.arrow import table_to_batches

        cols = [a.name for a in self.attrs]
        cap = ctx.conf.batch_capacity
        cache = getattr(self.source, "_device_cache", None)
        if cache is None and getattr(self.source, "cache_device_batches",
                                     False):
            cache = self.source._device_cache = {}
        schema = attrs_schema(self.attrs)
        out: list[Partition] = []
        for i in range(self.source.num_partitions()):
            if self._split_pruned(i):
                ctx.metrics.add("scan.dpp_pruned_splits")
                out.append([ColumnarBatch.empty(schema, ctx.device)])
                continue
            key = (i, tuple(cols), cap, str(ctx.device))
            if cache is not None and key in cache:
                out.append(cache[key])
                continue
            table = self.source.read_partition(i, cols)
            batches = list(table_to_batches(table, cap, schema, ctx.device))
            ctx.metrics.add(f"scan.{self.name}.rows", table.num_rows)
            if cache is not None:
                cache[key] = batches
            out.append(batches)
        return out

    def simple_string(self):
        return f"Scan[{self.name}]({', '.join(a.name for a in self.attrs)})"


def _evict_scan_entry(cache: dict, tid: int):
    """A weakref callback that drops `cache[tid]` if it is still the entry
    of the table that died (a new table may have taken its id since)."""
    def evict(ref) -> None:
        entry = cache.get(tid)
        if entry is not None and entry[0] is ref:
            del cache[tid]

    return evict


class LocalTableScanExec(PhysicalPlan):
    child_fields = ()

    def __init__(self, attrs: list[AttributeReference], table):
        self.attrs = attrs
        self.table = table  # pyarrow.Table

    @property
    def output(self):
        return self.attrs

    def output_partitioning(self):
        return SinglePartition()

    def execute(self, ctx: ExecContext) -> list[Partition]:
        from ..columnar.arrow import table_to_batches

        # ingested tiles are cached per table in the session, keyed by id
        # with a weakref check (ids recycle after GC, so a hit must prove
        # the entry still belongs to THIS table); the weakref's callback
        # evicts the entry, and its tiles, when the table dies: a DML
        # command or a replaced view leaves the old table to die
        tid = id(self.table)
        entry = ctx.scan_cache.get(tid)
        if entry is None or entry[0]() is not self.table:
            entry = (weakref.ref(self.table,
                                 _evict_scan_entry(ctx.scan_cache, tid)), {})
            ctx.scan_cache[tid] = entry
        names = tuple(a.name for a in self.attrs)
        key = (names, ctx.conf.batch_capacity, str(ctx.device))
        hit = entry[1].get(key)
        if hit is None:
            tbl = self.table.select(list(names)) if self.table.num_columns \
                else self.table
            hit = list(table_to_batches(tbl, ctx.conf.batch_capacity,
                                        attrs_schema(self.attrs), ctx.device))
            entry[1][key] = hit
        return [hit]

    def simple_string(self):
        return f"LocalTableScanExec({', '.join(a.name for a in self.attrs)})"


class RangeExec(PhysicalPlan):
    """spark.range: `id` = start + i * step for i in [0, total), split
    evenly into num_partitions partitions of tiles of at most
    spark.tpu.batch.capacity rows, each made on the session's device."""

    child_fields = ()

    def __init__(self, start: int, end: int, step: int, num_partitions: int,
                 attr: AttributeReference):
        self.start = start
        self.end = end
        self.step = step
        self.num_partitions = max(1, num_partitions)
        self.attr = attr

    @property
    def output(self):
        return [self.attr]

    def output_partitioning(self):
        return UnknownPartitioning(self.num_partitions)

    def execute(self, ctx: ExecContext) -> list[Partition]:
        if self.step > 0:
            total = max(0, -(-(self.end - self.start) // self.step))
        else:
            total = max(0, -(-(self.start - self.end) // -self.step))
        per = -(-total // self.num_partitions)
        schema = attrs_schema([self.attr])
        tile = ctx.conf.batch_capacity
        parts: list[Partition] = []
        for p in range(self.num_partitions):
            lo = min(p * per, total)
            hi = min(lo + per, total)
            batches = []
            for s in range(lo, hi, tile):
                n = min(s + tile, hi) - s
                idx = torch.arange(bucket_capacity(n), dtype=torch.int64,
                                   device=ctx.device)
                data = self.start + (s + idx) * self.step
                batches.append(ColumnarBatch(
                    schema, [Column(self.attr.dtype, data, None, None)],
                    idx < n, num_rows=n))
            parts.append(batches or [ColumnarBatch.empty(schema,
                                                         ctx.device)])
        return parts

    def simple_string(self):
        return (f"Range({self.start}, {self.end}, step={self.step}, "
                f"splits={self.num_partitions})")


# ---------------------------------------------------------------------------
# Compute (fused filter+project)
# ---------------------------------------------------------------------------

class ComputeExec(PhysicalPlan):
    """Fused conjunctive filters + projections, one pass per batch."""

    child_fields = ("child",)

    def __init__(self, filters: Sequence[Expression],
                 outputs: Sequence[Expression], child: PhysicalPlan):
        self.filters = list(filters)
        self.outputs = list(outputs)  # Alias | AttributeReference
        self.child = child
        self._pipeline: ExprPipeline | None = None

    @property
    def output(self):
        return [e.to_attribute() if isinstance(e, Alias) else e
                for e in self.outputs]

    def output_partitioning(self):
        p = self.child.output_partitioning()
        if isinstance(p, (HashPartitioning, RangePartitioning)):
            out_ids = {a.expr_id for a in self.output}
            exprs = p.exprs if isinstance(p, HashPartitioning) else \
                [o.child for o in p.orders]
            for e in exprs:
                if not (e.references() <= out_ids):
                    return UnknownPartitioning(p.num_partitions)
        return p

    def _get_pipeline(self) -> ExprPipeline:
        if self._pipeline is None:
            self._pipeline = ExprPipeline(
                self.child.output, self.filters, self.outputs,
                attrs_schema(self.output))
        return self._pipeline

    def execute(self, ctx: ExecContext) -> list[Partition]:
        parts = self.child.execute(ctx)
        if not self.filters:
            # pure column reorder/prune: share the child's tensors
            pos = {a.expr_id: i for i, a in enumerate(self.child.output)}
            if all(isinstance(e, AttributeReference) and e.expr_id in pos
                   for e in self.outputs):
                schema = attrs_schema(self.output)
                idx = [pos[e.expr_id] for e in self.outputs]
                return [[ColumnarBatch(schema, [b.columns[i] for i in idx],
                                       b.row_mask, num_rows=b._num_rows)
                         for b in part] for part in parts]
        pipe = self._get_pipeline()
        return [[pipe.run(b, ctx.launches) for b in part] for part in parts]

    def simple_string(self):
        f = " AND ".join(x.simple_string() for x in self.filters)
        o = ", ".join(x.simple_string() for x in self.outputs)
        s = f"Compute[{o}]"
        if f:
            s += f" WHERE {f}"
        return s


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------

def dense_range_stats(kc: Column, row_mask: torch.Tensor, metrics=None):
    """(kmin, kmax, any_live) of an integral key column under `row_mask`:
    the dense fast-path decision, one reduction and one host sync, memoized
    per (data, validity, mask) identity (utils/device_memo.py) so cached
    scan tiles and a broadcast build sync once, not once per batch or per
    run. `metrics` counts the syncs as `dense_range.syncs`."""
    def compute():
        if metrics is not None:
            metrics.add("dense_range.syncs")
        m = row_mask if kc.validity is None else row_mask & kc.validity
        k = kc.data.to(torch.int64)
        big = torch.iinfo(torch.int64).max
        small = torch.iinfo(torch.int64).min
        stats = torch.stack([
            torch.where(m, k, torch.full_like(k, big)).min(),
            torch.where(m, k, torch.full_like(k, small)).max(),
            m.any().to(torch.int64)]).tolist()
        return int(stats[0]), int(stats[1]), bool(stats[2])

    return memo_device_scalars(DENSE_RANGE_KIND,
                               (kc.data, kc.validity, row_mask), compute)


def _group_kernel(ops: tuple[str, ...], key_eqs, key_outs, key_valids,
                  val_datas, val_valids, row_mask):
    """Sorted-segment grouped aggregation."""
    layout = G.group_rows(key_eqs, key_valids, row_mask)
    out_keys = [G.scatter_group_keys(layout, ko, kv)
                for ko, kv in zip(key_outs, key_valids)]
    bufs = G.apply_group_ops(layout, ops, val_datas, val_valids)
    return out_keys, bufs, G.group_output_mask(layout), layout


def _run_group_kernel(ops: tuple[str, ...], key, val_datas, val_valids,
                      row_mask):
    """Sorted-run grouped aggregation: the key column is already sorted
    (its ingest RunInfo), so groups come from run boundaries
    (`G.group_rows_presorted`, the run-layout kernel on the card) and the
    grouping sort is skipped."""
    layout = G.group_rows_presorted(key, row_mask)
    out_key, _ = G.scatter_group_keys(layout, key, None)
    bufs = G.apply_group_ops(layout, ops, val_datas, val_valids)
    return out_key, bufs, G.group_output_mask(layout)


def _dense_group_kernel(ops: tuple[str, ...], cap: int, out_cap: int,
                        key, key_valid, kmin: int, val_datas, val_valids,
                        row_mask):
    """Dense-range fast path: a single integral key whose value range fits
    a capacity bucket aggregates by DIRECT scatter keyed by `key - kmin`
    (`kmin` an int, or a 0-dim device tensor inside a fused program),
    with no sort. NULL keys and inactive rows park in the last slot,
    out_cap - 1; its `present` count and every count buffer go through the
    histogram kernel, once per distinct weight tensor (`present` is also
    the count of every op whose weights are the row mask)."""
    seg = key.to(torch.int64) - kmin
    parked = torch.full_like(seg, out_cap - 1)
    if key_valid is not None:
        seg = torch.where(key_valid, seg, parked)
    seg = torch.where(row_mask, seg, parked).to(torch.int32)

    present = partition_histogram(seg, row_mask, out_cap)
    bufs = G.apply_dense_ops(seg, out_cap, cap, ops, val_datas, val_valids,
                             row_mask, present)

    dev = row_mask.device
    out_keys = kmin + torch.arange(out_cap, dtype=torch.int64, device=dev)
    out_mask = present > 0
    # the parking slot is a real group only for actual null keys
    null_rows = (row_mask & ~key_valid).any() if key_valid is not None \
        else torch.zeros((), dtype=torch.bool, device=dev)
    # slice fills and device copies: no host scalar crosses, so the body
    # can sit inside a captured graph
    out_mask[out_cap - 1:].copy_(null_rows.reshape(1))
    key_validity = torch.ones(out_cap, dtype=torch.bool, device=dev)
    key_validity[out_cap - 1:].fill_(False)
    return out_keys, key_validity, bufs, out_mask


def _ungrouped_kernel(ops: tuple[str, ...], val_datas, val_valids, row_mask,
                      out_cap: int = 8):
    outs = G.apply_global_ops(ops, val_datas, val_valids, row_mask)
    dev = row_mask.device
    datas, valids = [], []
    for d, v in outs:
        arr = torch.zeros(out_cap, dtype=d.dtype, device=dev)
        arr[:1].copy_(d.reshape(1))
        datas.append(arr)
        if v is None:
            valids.append(None)
        else:
            varr = torch.zeros(out_cap, dtype=torch.bool, device=dev)
            varr[:1].copy_(v.reshape(1))
            valids.append(varr)
    mask = torch.zeros(out_cap, dtype=torch.bool, device=dev)
    mask[:1].fill_(True)
    return datas, valids, mask


class _AggSide:
    """What an aggregate chunk's buffers need beyond the device reduce
    (HashAggregateExec._values): percentile and collect columns, the
    dictionaries of rank-space min/max and of first, and the collects'
    finished columns."""

    def __init__(self):
        self.percentiles: dict = {}   # buffer index -> (column, q)
        self.collects: dict = {}      # buffer index -> (column, dedupe)
        self.ranks: dict = {}         # buffer index -> StringDict
        self.dicts: dict = {}         # buffer index -> StringDict | None
        self.collect_cols: dict = {}  # buffer index -> Column


def _ungrouped_percentile(batch: ColumnarBatch, pc: Column, q: float,
                          out_cap: int):
    v, has = G.masked_percentile(pc.data, batch.row_mask, pc.validity, q)
    dev = batch.device
    arr = torch.zeros(out_cap, dtype=v.dtype, device=dev)
    arr[:1].copy_(v.reshape(1))
    hv = torch.zeros(out_cap, dtype=torch.bool, device=dev)
    hv[:1].copy_(has.reshape(1))
    return arr, hv


def _collected(vals, dedupe: bool, dtype) -> list:
    """One group's list: its values in row order, each in the form Arrow's
    ingest gives the element type; collect_set keeps the first of equal
    values (equal after that form too)."""
    from .python_eval import conform

    et = dtype.element_type
    out = [conform(v, et) for v in vals if v is not None]
    return list(dict.fromkeys(out)) if dedupe else out


def _list_column(out_dtype, lists: list, rows, cap: int, device) -> Column:
    """An ArrayType column of `lists` at output rows `rows`, dictionary
    encoded by canonical form, as the port's nested columns are."""
    import numpy as np

    from ..columnar.batch import StringDict, encode_values

    values, codes = encode_values(lists)
    data = np.zeros(cap, np.int32)
    data[rows] = codes
    return Column(out_dtype, torch.from_numpy(data).to(device), None,
                  StringDict(values or [[]]))


def _collect_column(vc: Column, rows: torch.Tensor, gid: torch.Tensor,
                    num_groups: int, dedupe: bool, out_cap: int,
                    out_dtype) -> Column:
    """The lists of a collect: `rows` (the live rows, ordered by group and
    in input order within one) and their group ids `gid` in [0,
    num_groups), on the batch's device. NULL values drop; collect_set
    keeps the first row of each (group, value), found on the device (equal
    codes of a dictionary column, or equal values). Only the kept rows'
    values cross to the host, where each group's list is built."""
    from .python_eval import host_values

    if vc.validity is not None:
        ok = vc.validity[rows]
        rows, gid = rows[ok], gid[ok]
    if dedupe and rows.numel():
        if dict_encoded(vc.dtype):
            code = vc.data[rows].to(torch.int64)
        else:
            _, code = torch.unique(vc.data[rows], return_inverse=True)
        _, inv = torch.unique(gid * (int(code.max()) + 1) + code,
                              return_inverse=True)
        pos = torch.arange(inv.shape[0], device=inv.device)
        first = torch.full((int(inv.max()) + 1,), inv.shape[0],
                           dtype=torch.int64, device=inv.device)
        first.scatter_reduce_(0, inv, pos, "amin")
        keep, _ = torch.sort(first)
        rows, gid = rows[keep], gid[keep]
    vals = host_values(vc, rows)
    ends = torch.bincount(gid, minlength=num_groups).cumsum(0).tolist()
    starts = [0] + ends[:-1]
    lists = [_collected(vals[lo:hi], dedupe, out_dtype)
             for lo, hi in zip(starts, ends)]
    return _list_column(out_dtype, lists, list(range(num_groups)), out_cap,
                        rows.device)


def _ungrouped_collect(batch: ColumnarBatch, vc: Column, dedupe: bool,
                       out_cap: int, out_dtype) -> Column:
    """collect_list/set with no grouping: one list over all valid rows
    (list order = input row order; the reference leaves it unspecified)."""
    rows = torch.nonzero(batch.row_mask).squeeze(1)
    return _collect_column(vc, rows, torch.zeros_like(rows), 1, dedupe,
                           out_cap, out_dtype)


def _group_collect(batch: ColumnarBatch, layout, vc: Column, dedupe: bool,
                   out_dtype) -> Column:
    """Grouped collect over the device kernel's group layout: its sorted
    live rows are grouped and, the sort being stable, in input order
    within a group; group g is output row g."""
    live = layout.active
    rows, gid = layout.perm[live], layout.seg_ids[live]
    return _collect_column(vc, rows, gid, int(layout.num_groups), dedupe,
                           batch.capacity, out_dtype)


class HashAggregateExec(PhysicalPlan):
    """Grouped aggregation (role of the reference's HashAggregateExec).

    mode 'partial': values come from spec.input_expr attributes.
    mode 'final':   values are the buffer attrs; ops are merge ops.
    Output (both modes): grouping attrs ++ flattened buffer attrs."""

    child_fields = ("child",)

    def __init__(self, grouping: Sequence[AttributeReference],
                 specs: Sequence[AggSpec], mode: str, child: PhysicalPlan):
        if mode not in ("partial", "final"):
            raise ValueError(mode)
        self.grouping = list(grouping)
        self.specs = list(specs)
        self.mode = mode
        self.child = child
        # a partial pass the planner took as the whole aggregate (its input
        # was one partition when it was planned)
        self.single_pass = False

    @property
    def output(self):
        out = list(self.grouping)
        for s in self.specs:
            out.extend(s.buffer_attrs)
        return out

    def required_child_distribution(self):
        if self.mode == "partial":
            return [UnspecifiedDistribution()]
        if not self.grouping:
            return [AllTuples()]
        return [ClusteredDistribution(list(self.grouping))]

    def output_partitioning(self):
        return self.child.output_partitioning()

    def _plan_values(self):
        """(op, input attr, param) per buffer column."""
        out = []
        for s in self.specs:
            for i, op in enumerate(s.ops):
                if self.mode == "partial":
                    out.append((op, s.input_expr if op != "countstar"
                                else None, s.param))
                else:
                    out.append((PARTIAL_TO_MERGE[op], s.buffer_attrs[i],
                                s.param))
        return out

    def execute(self, ctx: ExecContext) -> list[Partition]:
        from .adaptive import coalesce_after_exchange

        parts = self.child.execute(ctx)
        if self.mode == "final":
            parts = coalesce_after_exchange(self.child, parts, ctx,
                                            self.child.output)
        return [[self._aggregate_partition(part, ctx)] for part in parts]

    def _aggregate_partition(self, part: Partition, ctx) -> ColumnarBatch:
        """Partitions larger than the blockwise threshold fold chunk by
        chunk: partial-aggregate each chunk, then merge the partials with
        final-mode ops."""
        max_rows = int(ctx.conf.get(AGG_BLOCK_ROWS))
        if len(part) > 1 and sum(b.capacity for b in part) > max_rows \
                and self.grouping and all(s.mergeable for s in self.specs):
            acc: list[ColumnarBatch] = []
            chunk: list[ColumnarBatch] = []
            cap_sum = 0
            for b in part:
                chunk.append(b)
                cap_sum += b.capacity
                if cap_sum >= max_rows:
                    acc.append(self._aggregate_chunk(chunk, ctx))
                    chunk, cap_sum = [], 0
            if chunk:
                acc.append(self._aggregate_chunk(chunk, ctx))
            merger = HashAggregateExec(self.grouping, self.specs, "final",
                                       _SchemaOnly(self.output))
            return merger._aggregate_chunk(acc, ctx)
        return self._aggregate_chunk(part, ctx)

    def _values(self, batch: ColumnarBatch):
        """(ops, value datas, value validities, side) of the buffer columns.
        A percentile or a collect takes a placeholder "first" op, its value
        column kept in side.percentiles / side.collects (they reduce apart
        and replace the placeholder); a min/max over a dictionary-encoded
        column reduces the entries' ranks (side.ranks: the winning rank maps
        back to a code), and a first over one keeps its dictionary
        (side.dicts)."""
        pos = {a.expr_id: i for i, a in enumerate(self.child.output)}
        side = _AggSide()
        ops, val_datas, val_valids = [], [], []
        for bi, (op, attr, param) in enumerate(self._plan_values()):
            if attr is None:
                ops.append(op)
                val_datas.append(batch.row_mask)  # dummy (countstar)
                val_valids.append(None)
                continue
            c = batch.columns[pos[attr.expr_id]]
            if op == "percentile":
                side.percentiles[bi] = (c, param)
                op = "first"
            elif op == "collect":
                side.collects[bi] = (c, param >= 0.5)
                op = "first"
            if op in ("min", "max") and dict_encoded(c.dtype):
                val_datas.append(c.sort_keys())
                side.ranks[bi] = c.dictionary or EMPTY_DICT
            else:
                val_datas.append(c.data)
                if dict_encoded(c.dtype):
                    side.dicts[bi] = c.dictionary
            ops.append(op)
            val_valids.append(c.validity)
        return tuple(ops), val_datas, val_valids, side

    def _aggregate_chunk(self, part: Partition, ctx) -> ColumnarBatch:
        batch = concat_batches(part, attrs_schema(self.child.output))
        pos = {a.expr_id: i for i, a in enumerate(self.child.output)}
        ops, val_datas, val_valids, side = self._values(batch)
        out_schema = attrs_schema(self.output)

        if not self.grouping:
            datas, valids, mask = _ungrouped_kernel(
                ops, val_datas, val_valids, batch.row_mask)
            ctx.launches.add("uagg")
            for bi, (pc, q) in side.percentiles.items():
                datas[bi], valids[bi] = _ungrouped_percentile(
                    batch, pc, q, datas[bi].shape[0])
            for bi, (vc, dedupe) in side.collects.items():
                side.collect_cols[bi] = _ungrouped_collect(
                    batch, vc, dedupe, datas[bi].shape[0],
                    out_schema.fields[bi].dataType)
            cols = [self._finish_buffer(bi, d, v, f, side)
                    for bi, (f, d, v) in enumerate(
                        zip(out_schema.fields, datas, valids))]
            return ColumnarBatch(out_schema, cols, mask, num_rows=1)

        key_cols = [batch.columns[pos[g.expr_id]] for g in self.grouping]
        if not side.percentiles and not side.collects:
            dense = self._try_dense(batch, key_cols, ops, val_datas,
                                    val_valids, out_schema, ctx, side)
            if dense is not None:
                return dense
            rle = self._try_run_sorted(batch, key_cols, ops, val_datas,
                                       val_valids, out_schema, ctx, side)
            if rle is not None:
                return rle

        if batch.device.type == "cpu":
            # the CPU's sorts and gathers cost every slot of the tile, and
            # a join's output tiles concatenated over their partition are
            # mostly dead slots: the sorted-segment kernel runs over the
            # live rows, moved to the front in order, where that cuts the
            # width by 4 or more (the result is the same; the card path
            # keeps its launches)
            compact = compact_batch(batch) \
                if bucket_capacity(batch.num_rows()) * 4 <= batch.capacity \
                else batch
            if compact is not batch:
                batch = compact
                key_cols = [batch.columns[pos[g.expr_id]]
                            for g in self.grouping]
                ops, val_datas, val_valids, side = self._values(batch)
        key_eqs = [c.eq_keys() for c in key_cols]
        key_valids = [c.validity for c in key_cols]
        out_keys, bufs, out_mask, layout = _group_kernel(
            ops, key_eqs, [c.data for c in key_cols], key_valids, val_datas,
            val_valids, batch.row_mask)
        ctx.launches.add("gagg")
        for bi, (pc, q) in side.percentiles.items():
            bufs[bi] = G.group_percentile(key_eqs, key_valids, pc.data,
                                          pc.validity, batch.row_mask, q)
        for bi, (vc, dedupe) in side.collects.items():
            side.collect_cols[bi] = _group_collect(
                batch, layout, vc, dedupe,
                out_schema.fields[len(key_cols) + bi].dataType)
        # a string key takes its group's first code and the dictionary
        cols = [Column(f.dataType, kd, kv, kc.dictionary)
                for (kd, kv), kc, f in
                zip(out_keys, key_cols, out_schema.fields[: len(key_cols)])]
        cols += [self._finish_buffer(bi, bd, bv, f, side)
                 for bi, ((bd, bv), f) in enumerate(
                     zip(bufs, out_schema.fields[len(key_cols):]))]
        return ColumnarBatch(out_schema, cols, out_mask, num_rows=None)

    @staticmethod
    def _finish_buffer(bi: int, bd, bv, f: StructField,
                       side: "_AggSide") -> Column:
        """Buffer `bi` as an output column: a collect's host-built column;
        a rank-space min/max mapped back to its dictionary's codes; a first
        over a dictionary-encoded column with that dictionary (the
        reference drops it, ROADMAP.md C17); else cast to the field's
        device dtype."""
        if bi in side.collect_cols:
            return side.collect_cols[bi]
        if bi in side.ranks:
            sd = side.ranks[bi]
            codes = _take_codes(sd.device_rank_to_code(bd.device), bd)
            return Column(f.dataType, codes.to(torch.int32), bv, sd)
        want = f.dataType.device_dtype
        if bd.dtype != want:
            bd = bd.to(want)
        return Column(f.dataType, bd, bv, side.dicts.get(bi))

    def _try_dense(self, batch: ColumnarBatch, key_cols, ops, val_datas,
                   val_valids, out_schema, ctx, side):
        """Dense-range fast path dispatch: a single integral key whose value
        span fits a capacity bucket (the host syncs two scalars to decide),
        or a single string key: its int32 codes are a dense domain
        [0, len(dictionary)) known on the host, so the decision syncs
        nothing and the dictionary decodes the output keys (gated by
        spark.tpu.encoding.enabled, as in the reference)."""
        if len(key_cols) != 1:
            return None
        kc = key_cols[0]
        cap = batch.capacity
        key_dict = None
        if kc.is_string:
            if not ctx.conf.get(ENCODING_ENABLED):
                return None
            key_dict = kc.dictionary or EMPTY_DICT
            kmin, span = 0, len(key_dict)
            if span + 1 > min(4 * cap, 1 << 23):
                return None  # a mega-dictionary: the sort path takes it
            ctx.metrics.add("agg.dict_code_fast_path")
        elif isinstance(kc.dtype, (IntegralType, DateType)):
            kmin, kmax, any_live = dense_range_stats(kc, batch.row_mask,
                                                     ctx.metrics)
            if not any_live:
                return None
            span = kmax - kmin + 1
            if span + 1 > min(4 * cap, 1 << 23):
                return None  # sparse keys — sort path handles it
        else:
            return None
        out_cap = bucket_capacity(span + 1)
        out_keys, key_validity, bufs, out_mask = _dense_group_kernel(
            ops, cap, out_cap, kc.data, kc.validity, kmin, val_datas,
            val_valids, batch.row_mask)
        ctx.launches.add("dagg")
        ctx.metrics.add("agg.dense_fast_path")
        kf = out_schema.fields[0]
        kv = key_validity if kc.validity is not None else None
        cols = [Column(kf.dataType, out_keys.to(kf.dataType.device_dtype), kv,
                       key_dict)]
        cols += [self._finish_buffer(bi, bd, bv, f, side)
                 for bi, ((bd, bv), f) in enumerate(
                     zip(bufs, out_schema.fields[1:]))]
        return ColumnarBatch(out_schema, cols, out_mask, num_rows=None)

    def _try_run_sorted(self, batch: ColumnarBatch, key_cols, ops,
                        val_datas, val_valids, out_schema, ctx, side):
        """Sorted-run path, tried where the dense path declined (a sparse
        span): a single integral key whose ingest RunInfo says its rows are
        sorted, with no validity plane, reduces per run boundary, with no
        grouping sort and no dense table (the reference's
        `_try_run_sorted`; spark.tpu.encoding.enabled, read from this
        session's conf, turns it off). The decision reads metadata only."""
        if len(key_cols) != 1:
            return None
        kc = key_cols[0]
        if kc.runs is None or not kc.runs.is_sorted or \
                kc.validity is not None or \
                not ctx.conf.get(ENCODING_ENABLED):
            return None
        out_key, bufs, out_mask = _run_group_kernel(
            ops, kc.data, val_datas, val_valids, batch.row_mask)
        ctx.launches.add("ragg")
        ctx.metrics.add("agg.run_sorted_fast_path")
        cols = [Column(out_schema.fields[0].dataType, out_key, None,
                       kc.dictionary)]
        cols += [self._finish_buffer(bi, bd, bv, f, side)
                 for bi, ((bd, bv), f) in enumerate(
                     zip(bufs, out_schema.fields[1:]))]
        return ColumnarBatch(out_schema, cols, out_mask, num_rows=None)

    def simple_string(self):
        g = ", ".join(a.name for a in self.grouping)
        fns = ", ".join(type(s.func).__name__ for s in self.specs)
        return f"HashAggregate[{self.mode}](keys=[{g}], fns=[{fns}])"


# ---------------------------------------------------------------------------
# Sort / Limit
# ---------------------------------------------------------------------------

class SortExec(PhysicalPlan):
    """In-partition sort: a partition within the device budget
    (exec/memory.py) concatenates into one tile and sorts there; a larger
    one takes the external range-bucketed sort (physical/external_sort.py).
    Orders are over child output attributes (the planner pre-projects
    complex keys). A global sort (`is_global`) gets a range exchange below
    it from EnsureRequirements when its child has more than one
    partition; AQE merges that exchange's small adjacent partitions."""

    child_fields = ("child",)

    def __init__(self, orders: Sequence[SortOrder], child: PhysicalPlan,
                 is_global: bool = False):
        self.orders = list(orders)
        self.child = child
        self.is_global = is_global
        for o in self.orders:
            if not isinstance(o.child, AttributeReference):
                raise ValueError("the planner binds sort keys to attributes")

    @property
    def output(self):
        return self.child.output

    def execute(self, ctx: ExecContext) -> list[Partition]:
        from .adaptive import coalesce_after_exchange

        parts = coalesce_after_exchange(self.child, self.child.execute(ctx),
                                        ctx, self.child.output)
        return [self._sort_partition(p, ctx) if p else [] for p in parts]

    def _sort_partition(self, part: Partition, ctx) -> Partition:
        """Budget dispatch: a partition that fits the device budget sorts
        as one tile; a larger one takes the external multi-pass."""
        schema = attrs_schema(self.child.output)
        budget = ctx.memory.tile_rows(schema, amplification=3)
        if sum(b.capacity for b in part) <= budget:
            return [self._sort_single(part, ctx)]
        from .external_sort import external_sort

        return external_sort(part, self.orders, schema, self.child.output,
                             ctx, budget,
                             lambda p: self._sort_single(p, ctx))

    def _sort_single(self, part: Partition, ctx) -> ColumnarBatch:
        batch = concat_batches(part, attrs_schema(self.child.output))
        pos = {a.expr_id: i for i, a in enumerate(self.child.output)}
        keys, valids, specs = [], [], []
        for o in self.orders:
            c = batch.columns[pos[o.child.expr_id]]
            keys.append(c.sort_keys())
            valids.append(c.validity)
            specs.append(SortKeySpec(o.ascending, o.nulls_first))
        perm = sort_permutation(keys, valids, specs, batch.row_mask)
        ctx.launches.add("sort")
        out = gather_batch(batch, perm, batch.row_mask[perm])
        out._num_rows = batch._num_rows
        return out

    def simple_string(self):
        o = ", ".join(
            f"{x.child.simple_string()} {'ASC' if x.ascending else 'DESC'}"
            for x in self.orders)
        return f"Sort[{o}]"


class LimitExec(PhysicalPlan):
    """Keep the first n live rows (after `offset`) per partition
    (LocalLimit); with a single child partition this is GlobalLimit."""

    child_fields = ("child",)

    def __init__(self, n: int, child: PhysicalPlan, offset: int = 0,
                 is_global: bool = False):
        self.n = n
        self.offset = offset
        self.is_global = is_global
        self.child = child

    @property
    def output(self):
        return self.child.output

    def required_child_distribution(self):
        return [AllTuples()] if self.is_global else [UnspecifiedDistribution()]

    def execute(self, ctx: ExecContext) -> list[Partition]:
        return [self._limit_partition(part, ctx)
                for part in self.child.execute(ctx)]

    def _limit_partition(self, part: Partition, ctx) -> Partition:
        if not part:
            return []
        batch = concat_batches(part, attrs_schema(self.output))
        keep = limit_mask(batch.row_mask, self.n, self.offset)
        ctx.launches.add("limit")
        limited = ColumnarBatch(batch.schema, batch.columns, keep,
                                num_rows=None)
        # a local limit leaves <= n live rows in a full-capacity tile;
        # compact so the gather exchange and the sort above touch only the
        # kept rows (the TakeOrderedAndProject shrink)
        if not self.is_global and self.n * 4 <= batch.capacity:
            limited = compact_batch(limited)
        return [limited]


# ---------------------------------------------------------------------------
# Joins
# ---------------------------------------------------------------------------

class HashJoinExec(PhysicalPlan):
    """Equi-join (role of ShuffledHashJoinExec / BroadcastHashJoinExec).
    The right side is the build side; the planner flips right joins into
    left joins over swapped children. A build with one dense, unique
    integral key takes a direct-address table and a one-gather probe;
    any other takes the hash-sorted build and the searchsorted probe."""

    child_fields = ("left", "right")

    def __init__(self, left_keys: Sequence[AttributeReference],
                 right_keys: Sequence[AttributeReference], join_type: str,
                 left: PhysicalPlan, right: PhysicalPlan,
                 is_broadcast: bool = False):
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        # inner / left_outer / left_semi / left_anti / full_outer
        self.join_type = join_type
        self.left = left
        self.right = right
        self.is_broadcast = is_broadcast
        # [(ScanExec, key index)] marked by the planner: probe-side scans
        # whose hive-partition column is a join key. The build side runs
        # first and its distinct keys prune their splits (DPP)
        self.dpp_targets: list = []
        # whole-stage fusion splice (physical/fusion.py fuse_stages): when
        # a filter/project pipeline fed the probe side, its (filters,
        # outputs) run inside the probe's program and `left` is the
        # pipeline's child; probe_attrs are the pipeline's output
        # attributes, the join's probe-side schema from the outside
        self.probe_fusion: tuple | None = None
        self.probe_attrs: list | None = None
        self._probe_pipe_cache = None

    @property
    def _left_attrs(self) -> list:
        """Probe-side output attributes as consumers see them (after the
        fused pipeline when one is spliced in)."""
        return self.probe_attrs if self.probe_fusion is not None \
            else self.left.output

    def _probe_pipeline(self):
        """(ExprPipeline, structural key) of the spliced probe pipeline."""
        if self._probe_pipe_cache is None:
            from .compile import struct_key

            filters, outputs = self.probe_fusion
            self._probe_pipe_cache = (
                ExprPipeline(self.left.output, filters, outputs,
                             attrs_schema(self.probe_attrs)),
                struct_key(self.left.output, filters, outputs))
        return self._probe_pipe_cache

    @property
    def output(self):
        if self.join_type in ("left_semi", "left_anti"):
            return self._left_attrs
        lo, ro = self._left_attrs, self.right.output
        if self.join_type in ("left_outer", "full_outer"):
            ro = [a.with_nullability(True) for a in ro]
        if self.join_type == "full_outer":
            lo = [a.with_nullability(True) for a in lo]
        return lo + ro

    def required_child_distribution(self):
        if self.is_broadcast:
            return [UnspecifiedDistribution(), BroadcastDistribution()]
        return [ClusteredDistribution(list(self.left_keys)),
                ClusteredDistribution(list(self.right_keys))]

    def output_partitioning(self):
        return self.left.output_partitioning()

    def execute(self, ctx: ExecContext) -> list[Partition]:
        from ..config import BLOOM_JOIN_FILTER, MINMAX_JOIN_FILTER
        from .adaptive import coalesce_join_inputs, split_skewed_join_inputs

        if self.dpp_targets:
            right_parts = self.right.execute(ctx)
            self._install_dpp_filters(right_parts, ctx)
            left_parts = self.left.execute(ctx)
        else:
            left_parts = self.left.execute(ctx)
            right_parts = self.right.execute(ctx)
        if self.is_broadcast:
            # the broadcast exchange made one partition: every probe
            # partition reads it
            right_parts = [right_parts[0] for _ in left_parts]
        else:
            left_parts, right_parts = coalesce_join_inputs(
                self.left, self.right, left_parts, right_parts, ctx,
                self.left.output, self.right.output)
            left_parts, right_parts = split_skewed_join_inputs(
                left_parts, right_parts, ctx, self.join_type)
        if len(left_parts) != len(right_parts):
            raise ExecutionError(
                f"join children partition counts differ: "
                f"{len(left_parts)} vs {len(right_parts)}")
        fused = self.probe_fusion is not None
        if fused and (self.join_type == "full_outer"
                      or ctx.conf.get(MINMAX_JOIN_FILTER)
                      or ctx.conf.get(BLOOM_JOIN_FILTER)):
            # the unmatched-build pass and the runtime filters read the
            # probe keys outside the probe program: materialize the
            # pipeline up front
            pipe = self._probe_pipeline()[0]
            left_parts = [[pipe.run(b, ctx.launches) for b in p]
                          for p in left_parts]
            fused = False
        lschema = attrs_schema(self.left.output if fused
                               else self._left_attrs)
        rschema = attrs_schema(self.right.output)
        return [self._join_partition(lp, rp, lschema, rschema, ctx, fused)
                for lp, rp in zip(left_parts, right_parts)]

    def _install_dpp_filters(self, right_parts, ctx) -> None:
        """The build side's distinct key values become runtime split
        filters on the marked probe scans (the reference's PartitionPruning
        with the materialised build side as the value source). The keys
        are made distinct on the device; only they come to the host."""
        from ..config import DPP_BUILD_THRESHOLD

        max_rows = int(ctx.conf.get(DPP_BUILD_THRESHOLD))
        total = sum(b.num_rows() for p in right_parts for b in p)
        rpos = {a.expr_id: i for i, a in enumerate(self.right.output)}
        values_by_key: dict[int, set] = {}
        for scan, key_idx in self.dpp_targets:
            if total > max_rows:
                scan.runtime_split_filter = None
                continue
            values = values_by_key.get(key_idx)
            if values is None:
                ci = rpos[self.right_keys[key_idx].expr_id]
                values = values_by_key[key_idx] = _distinct_key_values(
                    [b.columns[ci] for p in right_parts for b in p],
                    [b.row_mask for p in right_parts for b in p])
            col_name = scan.attrs[self._dpp_attr_index(scan, key_idx)].name
            scan.runtime_split_filter = (col_name, values)

    def _dpp_attr_index(self, scan, key_idx: int) -> int:
        target = self.left_keys[key_idx].expr_id
        for i, a in enumerate(scan.attrs):
            if a.expr_id == target:
                return i
        raise KeyError(target)

    def _join_partition(self, lp: Partition, rp: Partition, lschema,
                        rschema, ctx, fused: bool = False,
                        _depth: int = 0) -> Partition:
        # the grace hash join: a build side over the device budget
        # (exec/memory.py) is hash-fragmented with its probe side and each
        # fragment joins on its own; one level deep, since re-hashing with
        # the same function cannot split further
        if rp and _depth == 0:
            budget = ctx.memory.tile_rows(rschema, amplification=4)
            build_cap = sum(b.capacity for b in rp)
            if build_cap > budget:
                if fused:
                    # fragments split by the computed key columns
                    pipe = self._probe_pipeline()[0]
                    lp = [pipe.run(b, ctx.launches) for b in lp]
                    lschema = attrs_schema(self._left_attrs)
                    fused = False
                return self._grace_join(lp, rp, lschema, rschema, ctx,
                                        budget, build_cap)
        build = concat_batches(rp, rschema) if rp \
            else ColumnarBatch.empty(rschema, ctx.device)
        rpos = {a.expr_id: i for i, a in enumerate(self.right.output)}
        lpos = {a.expr_id: i for i, a in enumerate(self._left_attrs)}
        bkeys = [build.columns[rpos[k.expr_id]] for k in self.right_keys]

        dense = self._try_dense_build(build, bkeys, ctx)
        if dense is not None:
            probes = lp or [ColumnarBatch.empty(lschema, ctx.device)]
            out = [self._dense_probe_batch(pb, build, dense, lpos, ctx,
                                           fused)
                   for pb in probes]
        else:
            bkey_eqs = [c.eq_keys() for c in bkeys]
            bkey_valids = [c.validity for c in bkeys]
            lp = self._runtime_filters(lp, build, bkeys, bkey_eqs,
                                       bkey_valids, lpos, ctx)
            probes = lp or [ColumnarBatch.empty(lschema, ctx.device)]
            bindex = J.build_index(bkey_eqs, bkey_valids, build.row_mask)
            if self.join_type in ("left_semi", "left_anti"):
                bindex = J.dedup_build(bindex, bkey_eqs, bkey_valids)
            ctx.launches.add("join_build")
            out = [self._probe_batch(pb, build, bindex, bkey_eqs,
                                     bkey_valids, lpos, ctx, fused)
                   for pb in probes]
        if self.join_type == "full_outer":
            out.append(self._unmatched_build_rows(lp, build, lschema, ctx))
        return out

    def _grace_join(self, lp: Partition, rp: Partition, lschema, rschema,
                    ctx, budget_rows: int, build_cap: int) -> Partition:
        """Fragment both sides by a hash of the join key and join fragment
        by fragment. Equal keys share a fragment, so every join type
        distributes over the fragments (full_outer's unmatched build rows
        come from each fragment against its own probe rows)."""
        from ..exec import shuffle as S

        nfrag = -(-build_cap // max(budget_rows, 1))
        nfrag = min(256, 1 << max(1, (nfrag - 1).bit_length()))
        rpos = {a.expr_id: i for i, a in enumerate(self.right.output)}
        lpos = {a.expr_id: i for i, a in enumerate(self._left_attrs)}
        rk = [rpos[k.expr_id] for k in self.right_keys]
        lk = [lpos[k.expr_id] for k in self.left_keys]
        # a seed of its own: the inputs are already hash-partitioned on
        # these keys with the exchange's seed, which would send a whole
        # partition to one fragment
        r_frags = S.shuffle_hash([rp], rk, nfrag, rschema, ctx,
                                 seed=GRACE_SEED)
        l_frags = S.shuffle_hash([lp], lk, nfrag, lschema, ctx,
                                 seed=GRACE_SEED)
        ctx.memory.count("join.grace.fragments", nfrag)
        out: Partition = []
        for lf, rf in zip(l_frags, r_frags):
            out.extend(self._join_partition(lf, rf, lschema, rschema, ctx,
                                            _depth=1))
        return out

    def _runtime_filters(self, lp: Partition, build: ColumnarBatch, bkeys,
                         bkey_eqs, bkey_valids, lpos, ctx) -> Partition:
        """The probe batches after the runtime join filters an inner or
        semi join takes on its sorted-probe path: the min-max range of a
        single integral, date or decimal key
        (spark.tpu.join.runtimeFilter), then the bloom bitset of the build
        keys' hashes (spark.tpu.join.runtimeFilter.bloom)."""
        from ..config import BLOOM_JOIN_FILTER, MINMAX_JOIN_FILTER

        if self.join_type not in ("inner", "left_semi") or not lp:
            return lp
        if len(bkeys) == 1 and isinstance(
                bkeys[0].dtype, (IntegralType, DateType, DecimalType)) \
                and ctx.conf.get(MINMAX_JOIN_FILTER):
            lp = self._range_filter_probe(lp, build, bkeys[0], lpos, ctx)
        if ctx.conf.get(BLOOM_JOIN_FILTER):
            lp = self._bloom_filter_probe(lp, build, bkeys, bkey_eqs,
                                          bkey_valids, lpos, ctx)
        return lp

    @staticmethod
    def _filtered(pb: ColumnarBatch, nm: torch.Tensor, live: int,
                  ctx) -> ColumnarBatch:
        """`pb` under its filtered mask, compacted to a smaller capacity
        bucket where the filter kept at most a sixteenth."""
        nb = ColumnarBatch(pb.schema, pb.columns, nm, num_rows=live)
        if bucket_capacity(max(live, 1)) <= pb.capacity // 16:
            nb = compact_batch(nb)
            ctx.metrics.add("join.runtime_filter_compactions")
        return nb

    def _range_filter_probe(self, lp: Partition, build: ColumnarBatch,
                            bc: Column, lpos, ctx) -> Partition:
        """Runtime min-max join filter: probe rows outside the build keys'
        range cannot match an inner or semi join, so they drop before the
        sort-probe. Probe batches under
        spark.tpu.join.runtimeFilter.minCapacity pass unfiltered. Counts
        the rows dropped as `join.range_filtered_rows`."""
        from ..config import JOIN_RF_MIN_CAPACITY

        blive = build.row_mask if bc.validity is None \
            else build.row_mask & bc.validity
        bk = bc.data.to(torch.int64)
        bmin = torch.where(blive, bk, torch.iinfo(torch.int64).max).min()
        bmax = torch.where(blive, bk, torch.iinfo(torch.int64).min).max()
        min_cap = int(ctx.conf.get(JOIN_RF_MIN_CAPACITY))
        out = []
        for pb in lp:
            if pb.capacity < min_cap:
                out.append(pb)  # a small batch: the sort-probe is cheap
                continue
            pc = pb.columns[lpos[self.left_keys[0].expr_id]]
            k = pc.data.to(torch.int64)
            keep = (k >= bmin) & (k <= bmax)
            if pc.validity is not None:
                keep = keep & pc.validity
            nm = pb.row_mask & keep
            live = int(nm.sum())
            ctx.metrics.add("join.range_filtered_rows",
                            pb.num_rows() - live)
            out.append(self._filtered(pb, nm, live, ctx))
        return out

    def _bloom_filter_probe(self, lp: Partition, build: ColumnarBatch, bkeys,
                            bkey_eqs, bkey_valids, lpos, ctx) -> Partition:
        """Runtime bloom join filter: a bitset of the build keys' hashes
        (two positions a key, at least 8 bits a build slot) drops probe
        rows that cannot match an inner or semi join before the
        sort-probe, for any key arity and type. The bitset is built once
        per build batch (memoised by its tensors: a broadcast build
        probed from every partition builds it once); the hand-written
        kernel (ops/bloom.py) builds and probes it. Counts the rows
        dropped as `join.bloom_filtered_rows`."""
        from ..ops.bloom import bloom_build, bloom_probe
        from ..ops.hashing import hash_columns
        from ..utils.sketch import bloom_position_offsets

        nbits = min(1 << 24, bucket_capacity(max(build.capacity, 1) * 8))
        off0, off1 = bloom_position_offsets(2)
        bits = memo_device_scalars(
            ("bloom_bits", nbits, tuple(k.expr_id for k in self.right_keys)),
            (build.row_mask, *[c.data for c in bkeys],
             *[c.validity for c in bkeys]),
            lambda: bloom_build(hash_columns(bkey_eqs, list(bkey_valids)),
                                build.row_mask, nbits, off0, off1))
        out = []
        for pb in lp:
            pkeys = [pb.columns[lpos[k.expr_id]] for k in self.left_keys]
            h = hash_columns([c.eq_keys() for c in pkeys],
                             [c.validity for c in pkeys])
            nm, live = bloom_probe(bits, h, pb.row_mask, nbits, off0, off1)
            before = pb.num_rows()
            live = int(live)
            ctx.metrics.add("join.bloom_filtered_rows", before - live)
            out.append(self._filtered(pb, nm, live, ctx))
        return out

    @staticmethod
    def _probe(bindex, bkey_eqs, bkey_valids, pkeys, pmask, jt: str,
               ctx) -> J.JoinResult:
        """The searchsorted probe at an output capacity of the probe tile's
        bucket, retried at the bucket of `needed` when the expansion did not
        fit (one host read of `needed` per try)."""
        out_cap = max(pmask.shape[0], 1 << 10)
        while True:
            r = J.probe_join(bindex, bkey_eqs, bkey_valids,
                             [c.eq_keys() for c in pkeys],
                             [c.validity for c in pkeys], pmask, out_cap, jt)
            ctx.launches.add("join_probe")
            needed = int(r.needed)
            if needed <= out_cap:
                return r
            out_cap = bucket_capacity(needed)
            ctx.metrics.add("join.capacity_retry")

    def _probe_batch(self, pb: ColumnarBatch, build: ColumnarBatch, bindex,
                     bkey_eqs, bkey_valids, lpos, ctx,
                     fused: bool = False) -> ColumnarBatch:
        jt = self.join_type if self.join_type != "full_outer" \
            else "left_outer"
        if fused:
            pb, r = self._fused_probe(pb, bindex, bkey_eqs, bkey_valids,
                                      ctx, jt)
        else:
            pkeys = [pb.columns[lpos[k.expr_id]] for k in self.left_keys]
            r = self._probe(bindex, bkey_eqs, bkey_valids, pkeys,
                            pb.row_mask, jt, ctx)
        ctx.metrics.add("join.sorted_probe")
        probe_out = gather_batch(pb, r.probe_idx, r.out_mask)
        if self.join_type in ("left_semi", "left_anti"):
            return probe_out
        build_out = gather_batch(build, r.build_idx, r.out_mask,
                                 extra_invalid=~r.matched)
        return ColumnarBatch(attrs_schema(self.output),
                             probe_out.columns + build_out.columns,
                             r.out_mask, num_rows=None)

    def _fused_probe(self, pb: ColumnarBatch, bindex, bkey_eqs, bkey_valids,
                     ctx, jt: str):
        """Whole-stage fused probe: the probe-side pipeline runs INSIDE
        the probe's program: one program computes the projected columns,
        derives the join keys and probes the build index (the consume
        splice of the reference's codegen'd BroadcastHashJoinExec). The
        capacity retry reads `needed` after each replay, as the unfused
        probe does after each launch. Returns the COMPUTED probe batch
        and the probe result; the caller's gathers read the computed
        columns."""
        from .compile import (
            STAGE_CACHE, FusedPipe, key_eqs, pipeline_columns,
            pipeline_host_pass, pipeline_signature, stage_inputs,
            string_key_luts,
        )

        filters, outputs = self.probe_fusion
        skey = self._probe_pipeline()[1]
        cap = pb.capacity
        hctx, host_outs, aux = pipeline_host_pass(self.left.output, filters,
                                                  outputs, pb)
        pipe = FusedPipe(self.left.output, filters, outputs, pb, aux)
        attrs = self.probe_attrs
        opos = {a.expr_id: i for i, a in enumerate(attrs)}
        kidx = tuple(opos[k.expr_id] for k in self.left_keys)
        lut_pos, luts = string_key_luts(kidx, attrs, host_outs)
        nb, no = len(bkey_eqs), len(outputs)
        extra = ([bindex.sorted_hash, bindex.perm] + list(bkey_eqs)
                 + list(bkey_valids) + luts)
        out_cap = max(cap, 1 << 10)
        while True:
            def body(ins, oc=out_cap):
                od, ov, mask, ops_in = pipe.run(ins)
                bi = J.BuildSide(ops_in[0], ops_in[1])
                beqs, bvs = ops_in[2:2 + nb], ops_in[2 + nb:2 + 2 * nb]
                peqs = key_eqs(od, kidx, attrs,
                               dict(zip(lut_pos, ops_in[2 + 2 * nb:])))
                r = J.probe_join(bi, beqs, bvs, peqs,
                                 [ov[i] for i in kidx], mask, oc, jt)
                return list(r) + od + ov + [mask]

            out = STAGE_CACHE.run(
                f"FusedProbe[{jt}]",
                ("fused_probe", jt, skey, cap, out_cap, kidx,
                 pipeline_signature(pb), hctx.signature()),
                body, stage_inputs(pb, aux, extra), pb.device)
            ctx.launches.add("fused_probe")
            r = J.JoinResult(*out[:5])
            needed = int(r.needed)
            if needed <= out_cap:
                break
            out_cap = bucket_capacity(needed)
            ctx.metrics.add("join.capacity_retry")
        pschema = attrs_schema(attrs)
        cols = pipeline_columns(pschema.fields, host_outs, out[5:5 + no],
                                out[5 + no:5 + 2 * no])
        return ColumnarBatch(pschema, cols, out[5 + 2 * no],
                             num_rows=None), r

    def _try_dense_build(self, build: ColumnarBatch, bkeys, ctx):
        """Dense unique-key build (TPC-DS dimension tables: dense integral
        primary keys): the 'hash table' is a direct-address row index and
        the probe a single gather — no sort, no searchsorted, no expansion.
        None when the key is multi-column, non-integral, sparse or
        duplicated. The key range and the duplicate verdict are host reads,
        memoized per build tensor identity so a broadcast build probed from
        every partition reads them once."""
        if len(bkeys) != 1:
            return None
        kc = bkeys[0]
        if not isinstance(kc.dtype, (IntegralType, DateType)):
            return None
        cap = build.capacity
        ident = (kc.data, kc.validity, build.row_mask)
        kmin, kmax, any_live = dense_range_stats(kc, build.row_mask,
                                                 ctx.metrics)
        if not any_live:
            return None
        span = kmax - kmin + 1
        if span > min(8 * cap, 1 << 23):
            return None
        tcap = bucket_capacity(span)
        m = build.row_mask if kc.validity is None \
            else build.row_mask & kc.validity
        # dead rows and null keys take slot tcap, one past the table: the
        # scatter drops it from a padded buffer (an index out of range is a
        # device assert on the card) and the histogram drops it as >= P
        slot = torch.where(m, kc.data.to(torch.int64) - kmin,
                           torch.full((), tcap, dtype=torch.int64,
                                      device=m.device))
        rowidx = torch.zeros(tcap + 1, dtype=torch.int64, device=m.device)
        rowidx.scatter_(0, slot, torch.arange(cap, device=m.device))
        present = partition_histogram(slot.to(torch.int32), m, tcap)
        maxc = memo_device_scalars(("djoin_maxc", tcap), ident,
                                   lambda: int(present.max()))
        if maxc > 1:
            return None  # duplicate build keys: the sorted-probe path
        ctx.launches.add("djoin_build")
        ctx.metrics.add("join.dense_fast_path")
        return {"rowidx": rowidx[:tcap], "present": present, "kmin": kmin,
                "tcap": tcap}

    def _dense_probe_batch(self, pb: ColumnarBatch, build: ColumnarBatch,
                           dense, lpos, ctx,
                           fused: bool = False) -> ColumnarBatch:
        tcap = dense["tcap"]
        jt = self.join_type if self.join_type != "full_outer" \
            else "left_outer"
        if fused:
            pb, bidx, matched, out_mask = self._fused_dense_probe(
                pb, dense, ctx, jt)
        else:
            kc = pb.columns[lpos[self.left_keys[0].expr_id]]
            bidx, matched, out_mask = _dense_probe_body(
                kc.data, kc.validity, pb.row_mask, dense["rowidx"],
                dense["present"], dense["kmin"], tcap, jt)
            ctx.launches.add("djoin_probe")
        if self.join_type in ("left_semi", "left_anti"):
            return ColumnarBatch(pb.schema, pb.columns, out_mask,
                                 num_rows=None)
        build_out = gather_batch(build, bidx, out_mask,
                                 extra_invalid=~matched)
        return ColumnarBatch(attrs_schema(self.output),
                             pb.columns + build_out.columns, out_mask,
                             num_rows=None)

    def _fused_dense_probe(self, pb: ColumnarBatch, dense, ctx, jt: str):
        """The dense direct-address probe with the probe-side pipeline in
        its program. Returns (computed probe batch, build row index,
        matched, out_mask)."""
        import numpy as np

        from .compile import (
            STAGE_CACHE, FusedPipe, pipeline_columns, pipeline_host_pass,
            pipeline_signature, stage_inputs,
        )

        filters, outputs = self.probe_fusion
        skey = self._probe_pipeline()[1]
        cap, tcap = pb.capacity, dense["tcap"]
        hctx, host_outs, aux = pipeline_host_pass(self.left.output, filters,
                                                  outputs, pb)
        pipe = FusedPipe(self.left.output, filters, outputs, pb, aux)
        ki = next(i for i, a in enumerate(self.probe_attrs)
                  if a.expr_id == self.left_keys[0].expr_id)
        no = len(outputs)

        def body(ins):
            od, ov, mask, (rowidx, present, kmin) = pipe.run(ins)
            return list(_dense_probe_body(od[ki], ov[ki], mask, rowidx,
                                          present, kmin, tcap, jt)) \
                + od + ov

        out = STAGE_CACHE.run(
            f"FusedDenseProbe[{jt}]",
            ("fused_djoin_probe", jt, skey, cap, tcap, ki,
             pipeline_signature(pb), hctx.signature()),
            body, stage_inputs(pb, aux, [
                dense["rowidx"], dense["present"],
                np.array(dense["kmin"], dtype=np.int64)]), pb.device)
        ctx.launches.add("fused_djoin_probe")
        bidx, matched, out_mask = out[:3]
        pschema = attrs_schema(self.probe_attrs)
        cols = pipeline_columns(pschema.fields, host_outs, out[3:3 + no],
                                out[3 + no:3 + 2 * no])
        return (ColumnarBatch(pschema, cols, out_mask, num_rows=None),
                bidx, matched, out_mask)

    def _unmatched_build_rows(self, lp: Partition, build: ColumnarBatch,
                              lschema, ctx) -> ColumnarBatch:
        """full_outer's extension: the build rows no probe row matches (an
        anti join of the build side against the partition's probe keys),
        with null probe columns."""
        probe_all = concat_batches(lp, lschema) if lp \
            else ColumnarBatch.empty(lschema, ctx.device)
        lpos = {a.expr_id: i for i, a in enumerate(self._left_attrs)}
        rpos = {a.expr_id: i for i, a in enumerate(self.right.output)}
        pkeys = [probe_all.columns[lpos[k.expr_id]] for k in self.left_keys]
        bkeys = [build.columns[rpos[k.expr_id]] for k in self.right_keys]
        pkey_eqs = [c.eq_keys() for c in pkeys]
        pkey_valids = [c.validity for c in pkeys]
        pi = J.build_index(pkey_eqs, pkey_valids, probe_all.row_mask)
        ctx.launches.add("join_build")
        # the swap: the build side probes the probe side's index
        r = self._probe(pi, pkey_eqs, pkey_valids, bkeys, build.row_mask,
                        "left_anti", ctx)
        build_rows = gather_batch(build, r.probe_idx, r.out_mask)
        schema = attrs_schema(self.output)
        oc = r.out_mask.shape[0]
        left_cols = [
            Column(f.dataType,
                   torch.zeros(oc, dtype=f.dataType.device_dtype,
                               device=ctx.device),
                   torch.zeros(oc, dtype=torch.bool, device=ctx.device))
            for f in schema.fields[:len(self._left_attrs)]]
        return ColumnarBatch(schema, left_cols + build_rows.columns,
                             r.out_mask, num_rows=None)

    def simple_string(self):
        k = ", ".join(f"{l.name}={r.name}"
                      for l, r in zip(self.left_keys, self.right_keys))
        b = "Broadcast" if self.is_broadcast else "Shuffled"
        s = f"{b}HashJoin[{self.join_type}]({k})"
        if self.probe_fusion is not None:
            filters, outputs = self.probe_fusion
            o = ", ".join(x.simple_string() for x in outputs)
            s += f" FUSED-PROBE[{o}]"
            if filters:
                s += " WHERE " + " AND ".join(x.simple_string()
                                              for x in filters)
        return s


def _dense_probe_body(key, key_valid, pmask, rowidx, present, kmin,
                      tcap: int, jt: str):
    """The dense direct-address probe: (build row index, matched,
    out_mask) per probe row. `kmin` is an int, or a 0-dim device tensor
    inside a fused program."""
    k = key.to(torch.int64) - kmin
    slot = k.clamp(0, tcap - 1)
    usable = pmask & (k >= 0) & (k < tcap)
    if key_valid is not None:
        usable = usable & key_valid
    matched = usable & (present[slot] > 0)
    bidx = rowidx[slot]
    if jt in ("inner", "left_semi"):
        out_mask = matched
    elif jt == "left_outer":
        out_mask = pmask
    else:  # left_anti
        out_mask = pmask & ~matched
    return bidx, matched, out_mask


def _distinct_key_values(cols: list[Column], masks: list) -> set:
    """The distinct non-null values of a key column over several tiles as
    host values comparable with a hive partition value (a partition column
    is int64, float64 or string)."""
    if cols and cols[0].is_string:
        out = set()
        for c, m in zip(cols, masks):
            live = m if c.validity is None else m & c.validity
            codes = torch.unique(c.data[live]).tolist()
            out.update(c.dictionary.values[i] for i in codes)
        return out
    live = [c.data[m if c.validity is None else m & c.validity]
            for c, m in zip(cols, masks)]
    return set(torch.unique(torch.cat(live)).tolist()) if live else set()


class NestedLoopJoinExec(PhysicalPlan):
    """Pairs + optional condition (role of BroadcastNestedLoopJoinExec /
    CartesianProductExec): inner, cross, left_semi, left_anti and
    left_outer. The build side (right) is broadcast.

    Pairs are formed probe-major, in tiles of at most
    spark.tpu.batch.capacity x NESTED_LOOP_TILE_FACTOR rows, and the
    condition is evaluated over each tile. Two enumerations give the same
    surviving pairs in the same order:
      * all pairs, the reference's: every live probe row with every live
        build row (cross joins; conditions with no left = right equality,
        such as the null-aware NOT IN's `k = k2 OR (k = k2) IS NULL`);
      * candidates by key, when a conjunct is an equality of a left and
        a right expression of one type (`key_pairs`): only the pairs in
        the probe key's range of the key-hash-sorted build. A pair outside
        it has unequal or NULL keys, so that conjunct and the AND are not
        true; within a range the build rows keep their order (the sort is
        stable), as in the reference's compacted build.
    Semi and anti joins fold the surviving pairs back onto their probe rows
    (a count per probe row, the histogram kernel); left outer adds a
    null-extended batch of the probe rows no pair matched."""

    child_fields = ("left", "right")

    def __init__(self, condition: Expression | None, join_type: str,
                 left: PhysicalPlan, right: PhysicalPlan):
        if join_type not in ("inner", "cross", "left_semi", "left_anti",
                             "left_outer"):
            raise NotPortedError(f"nested-loop {join_type} join")
        self.condition = condition
        self.join_type = join_type
        self.left = left
        self.right = right

    @property
    def output(self):
        if self.join_type in ("left_semi", "left_anti"):
            return list(self.left.output)
        return self.left.output + self.right.output

    def required_child_distribution(self):
        return [UnspecifiedDistribution(), BroadcastDistribution()]

    def key_pairs(self) -> list:
        """(left expr, right expr) of each conjunct `l = r` whose sides
        come one from each child and share a type."""
        from ..expr.expressions import EqualTo
        from ..plan.optimizer import split_conjuncts

        if self.condition is None:
            return []
        lids = {a.expr_id for a in self.left.output}
        rids = {a.expr_id for a in self.right.output}
        out = []
        for c in split_conjuncts(self.condition):
            if not isinstance(c, EqualTo) or c.left.dtype != c.right.dtype:
                continue
            lr, rr = c.left.references(), c.right.references()
            if lr and rr and lr <= lids and rr <= rids:
                out.append((c.left, c.right))
            elif lr and rr and lr <= rids and rr <= lids:
                out.append((c.right, c.left))
        return out

    @staticmethod
    def _key_eqs(exprs, attrs, batch: ColumnarBatch):
        """Equality-domain tensors and validities of `exprs` over `batch`."""
        keys = [Alias(e, f"__nlk{i}") for i, e in enumerate(exprs)]
        cols = ExprPipeline(attrs, [], keys, attrs_schema(
            [k.to_attribute() for k in keys])).run(batch).columns
        return [c.eq_keys() for c in cols], [c.validity for c in cols]

    def execute(self, ctx: ExecContext) -> list[Partition]:
        from ..config import NESTED_LOOP_TILE_FACTOR

        left_parts = self.left.execute(ctx)
        build = self.right.execute(ctx)[0]
        rschema = attrs_schema(self.right.output)
        lschema = attrs_schema(self.left.output)
        bbatch = concat_batches(build, rschema) if build \
            else ColumnarBatch.empty(rschema, ctx.device)
        pair_attrs = list(self.left.output) + list(self.right.output)
        pair_schema = attrs_schema(pair_attrs)
        cond_pipe = None
        if self.condition is not None:
            cond_pipe = ExprPipeline(pair_attrs, [self.condition],
                                     pair_attrs, pair_schema)
        tile = ctx.conf.batch_capacity * NESTED_LOOP_TILE_FACTOR
        nb = bbatch.num_rows()
        keys = self.key_pairs()
        if keys:
            bkey_eqs, bkey_valids = self._key_eqs(
                [r for _, r in keys], self.right.output, bbatch)
            bindex = J.build_index(bkey_eqs, bkey_valids, bbatch.row_mask)
            ctx.launches.add("join_build")
        out = []
        for part in left_parts:
            obatches: list = []
            for pb in (part or [ColumnarBatch.empty(lschema, ctx.device)]):
                if keys:
                    pkey_eqs, pkey_valids = self._key_eqs(
                        [l for l, _ in keys], self.left.output, pb)
                    starts, counts = J.match_ranges(
                        bindex, pkey_eqs, pkey_valids, pb.row_mask)
                    order = bindex.perm
                else:
                    counts, starts, order = J.all_pairs(pb.row_mask,
                                                        bbatch.row_mask)
                self._pairs(pb, bbatch, starts, counts, order, tile,
                            pair_schema, cond_pipe, obatches, ctx)
                ctx.metrics.add("nlj.pairs_all", pb.num_rows() * nb)
            out.append(obatches)
        return out

    def simple_string(self):
        cond = "" if self.condition is None \
            else re.sub(r"#\d+", "", self.condition.simple_string())
        return f"NestedLoopJoin[{self.join_type}]({cond})"

    def _pairs(self, pb: ColumnarBatch, bbatch: ColumnarBatch, starts,
               counts, order, tile: int, pair_schema, cond_pipe,
               obatches: list, ctx) -> None:
        """Form one probe batch's pairs tile by tile, apply the condition,
        and append what the join type emits to `obatches`."""
        offsets = torch.cumsum(counts, 0)
        total = int(offsets[-1])
        ctx.metrics.add("nlj.pairs_formed", total)
        fold = self.join_type in ("left_semi", "left_anti", "left_outer")
        matched = torch.zeros(pb.capacity, dtype=torch.int32,
                              device=pb.device)
        # one tile at least: a join with no pairs still emits an (empty)
        # batch, as the reference's does
        for first in range(0, max(total, 1), tile):
            cap = bucket_capacity(min(total - first, tile))
            ctx.metrics.peak("nlj.max_tile", cap)
            src, bidx, live = J.expand_pairs(offsets, counts, starts, order,
                                             first, cap)
            live = live & pb.row_mask[src]
            joined = ColumnarBatch(
                pair_schema,
                gather_batch(pb, src, live).columns
                + gather_batch(bbatch, bidx, live).columns,
                live, num_rows=None)
            if cond_pipe is not None:
                joined = cond_pipe.run(joined)
            ctx.launches.add("nlj_pairs")
            if fold:
                # a probe row matches iff ANY surviving pair points at it
                matched += partition_histogram(
                    src.to(torch.int32), joined.row_mask, pb.capacity)
            if self.join_type not in ("left_semi", "left_anti"):
                obatches.append(joined)
        if self.join_type in ("left_semi", "left_anti"):
            keep = pb.row_mask & ((matched > 0)
                                  if self.join_type == "left_semi"
                                  else (matched == 0))
            obatches.append(ColumnarBatch(pb.schema, pb.columns, keep,
                                          num_rows=None))
        elif self.join_type == "left_outer":
            # null-extend the unmatched probe rows as a second batch
            null_cols = [
                Column(f.dataType,
                       torch.zeros(pb.capacity,
                                   dtype=f.dataType.device_dtype,
                                   device=pb.device),
                       torch.zeros(pb.capacity, dtype=torch.bool,
                                   device=pb.device),
                       EMPTY_DICT if isinstance(f.dataType, StringType)
                       else None)
                for f in attrs_schema(self.right.output).fields]
            obatches.append(ColumnarBatch(
                pair_schema, list(pb.columns) + null_cols,
                pb.row_mask & (matched == 0), num_rows=None))


# ---------------------------------------------------------------------------
# Union
# ---------------------------------------------------------------------------

class UnionExec(PhysicalPlan):
    """UNION ALL: every child's partitions in turn, each batch rewrapped
    under the union's schema. Columns keep their branch's tensors and
    dictionaries: a string column's branches hold different dictionaries,
    and the operators that combine batches (exchange, aggregate, sort,
    join build) unify them as they concatenate."""

    child_fields = ("children_plans",)

    def __init__(self, children_plans: Sequence[PhysicalPlan],
                 attrs: list[AttributeReference]):
        self.children_plans = list(children_plans)
        self.attrs = attrs

    @property
    def output(self):
        return self.attrs

    def output_partitioning(self):
        return UnknownPartitioning(sum(
            c.output_partitioning().num_partitions
            for c in self.children_plans))

    def execute(self, ctx: ExecContext) -> list[Partition]:
        schema = attrs_schema(self.attrs)
        out: list[Partition] = []
        for c in self.children_plans:
            for part in c.execute(ctx):
                out.append([ColumnarBatch(schema, b.columns, b.row_mask,
                                          b._num_rows) for b in part])
        return out


class CoalescePartitionsExec(PhysicalPlan):
    """Narrow the child's partitions to at most `num_partitions` with no
    shuffle (`df.coalesce`): partition i joins output i mod n."""

    child_fields = ("child",)

    def __init__(self, num_partitions: int, child: PhysicalPlan):
        self.num_partitions = max(1, num_partitions)
        self.child = child

    @property
    def output(self):
        return self.child.output

    def output_partitioning(self):
        if self.num_partitions == 1:
            return SinglePartition()
        return UnknownPartitioning(self.num_partitions)

    def execute(self, ctx: ExecContext) -> list[Partition]:
        parts = self.child.execute(ctx)
        out: list[Partition] = [
            [] for _ in range(min(self.num_partitions, max(len(parts), 1)))]
        for i, p in enumerate(parts):
            out[i % len(out)].extend(p)
        return out

    def simple_string(self):
        return f"CoalescePartitions({self.num_partitions})"


class _SchemaOnly(PhysicalPlan):
    """Placeholder child carrying only an output schema (blockwise-agg
    merge step)."""

    child_fields = ()

    def __init__(self, attrs):
        self.attrs = list(attrs)

    @property
    def output(self):
        return self.attrs

    def execute(self, ctx):
        raise NotPortedError("executing a schema-only placeholder")
