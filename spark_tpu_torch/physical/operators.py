"""Physical operators (counterpart of `spark_tpu/physical/operators.py`):
the local table scan, the fused filter+project `ComputeExec`, and
`HashAggregateExec` in partial and final mode with its three kernels —
ungrouped, sorted-segment and dense-range. `execute()` returns a list of
partitions, each a list of device ColumnarBatches; blocking operators
concatenate their partition's batches and run one kernel per chunk.
"""

from __future__ import annotations

import weakref
from typing import Sequence

import torch

from ..columnar.batch import Column, ColumnarBatch, bucket_capacity
from ..columnar.ops import concat_batches
from ..config import AGG_BLOCK_ROWS
from ..errors import NotPortedError
from ..exec.context import ExecContext
from ..expr.expressions import Alias, AttributeReference, Expression
from ..ops import grouping as G
from ..ops.scatter_kernels import partition_histogram
from ..plan.tree import TreeNode
from ..types import DateType, IntegralType, StructField, StructType
from .aggregates import PARTIAL_TO_MERGE, AggSpec
from .compile import ExprPipeline
from .partitioning import (
    AllTuples, ClusteredDistribution, Distribution, HashPartitioning,
    Partitioning, RangePartitioning, SinglePartition, UnknownPartitioning,
    UnspecifiedDistribution,
)

Partition = list  # list[ColumnarBatch]


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

        # ingested tiles are cached per table in the session (keyed by
        # id with a weakref check: ids recycle after GC, so a hit must
        # prove the entry still belongs to THIS table)
        tid = id(self.table)
        entry = ctx.scan_cache.get(tid)
        if entry is None or entry[0]() is not self.table:
            entry = (weakref.ref(self.table), {})
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

def dense_range_stats(kc: Column, row_mask: torch.Tensor):
    """(kmin, kmax, any_live) of an integral key column under `row_mask`:
    the dense fast-path decision, one reduction and one host sync per tile."""
    m = row_mask if kc.validity is None else row_mask & kc.validity
    k = kc.data.to(torch.int64)
    big = torch.iinfo(torch.int64).max
    small = torch.iinfo(torch.int64).min
    stats = torch.stack([
        torch.where(m, k, torch.full_like(k, big)).min(),
        torch.where(m, k, torch.full_like(k, small)).max(),
        m.any().to(torch.int64)]).tolist()
    return int(stats[0]), int(stats[1]), bool(stats[2])


def _group_kernel(ops: tuple[str, ...], key_eqs, key_outs, key_valids,
                  val_datas, val_valids, row_mask):
    """Sorted-segment grouped aggregation."""
    layout = G.group_rows(key_eqs, key_valids, row_mask)
    out_keys = [G.scatter_group_keys(layout, ko, kv)
                for ko, kv in zip(key_outs, key_valids)]
    bufs = G.apply_group_ops(layout, ops, val_datas, val_valids)
    return out_keys, bufs, G.group_output_mask(layout)


def _dense_group_kernel(ops: tuple[str, ...], cap: int, out_cap: int,
                        key, key_valid, kmin: int, val_datas, val_valids,
                        row_mask):
    """Dense-range fast path: a single integral key whose value range fits
    a capacity bucket aggregates by DIRECT scatter keyed by `key - kmin`,
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
    out_mask[out_cap - 1] = null_rows
    key_validity = torch.ones(out_cap, dtype=torch.bool, device=dev)
    key_validity[out_cap - 1] = False
    return out_keys, key_validity, bufs, out_mask


def _ungrouped_kernel(ops: tuple[str, ...], val_datas, val_valids, row_mask,
                      out_cap: int = 8):
    outs = G.apply_global_ops(ops, val_datas, val_valids, row_mask)
    dev = row_mask.device
    datas, valids = [], []
    for d, v in outs:
        arr = torch.zeros(out_cap, dtype=d.dtype, device=dev)
        arr[0] = d
        datas.append(arr)
        if v is None:
            valids.append(None)
        else:
            varr = torch.zeros(out_cap, dtype=torch.bool, device=dev)
            varr[0] = v
            valids.append(varr)
    mask = torch.zeros(out_cap, dtype=torch.bool, device=dev)
    mask[0] = True
    return datas, valids, mask


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
        """(op, input attr) per buffer column."""
        out = []
        for s in self.specs:
            for i, op in enumerate(s.ops):
                if self.mode == "partial":
                    out.append((op, s.input_expr if op != "countstar"
                                else None))
                else:
                    out.append((PARTIAL_TO_MERGE[op], s.buffer_attrs[i]))
        return out

    def execute(self, ctx: ExecContext) -> list[Partition]:
        # AQE partition coalescing is not ported: each partition of the
        # exchange aggregates on its own (results do not depend on it)
        parts = self.child.execute(ctx)
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

    def _aggregate_chunk(self, part: Partition, ctx) -> ColumnarBatch:
        batch = concat_batches(part, attrs_schema(self.child.output))
        pos = {a.expr_id: i for i, a in enumerate(self.child.output)}
        vals = self._plan_values()
        ops = tuple(op for op, _ in vals)
        val_datas, val_valids = [], []
        for _, attr in vals:
            if attr is None:
                val_datas.append(batch.row_mask)  # dummy (countstar)
                val_valids.append(None)
                continue
            c = batch.columns[pos[attr.expr_id]]
            val_datas.append(c.data)
            val_valids.append(c.validity)
        out_schema = attrs_schema(self.output)

        if not self.grouping:
            datas, valids, mask = _ungrouped_kernel(
                ops, val_datas, val_valids, batch.row_mask)
            ctx.launches.add("uagg")
            cols = [self._finish_buffer(d, v, f) for f, d, v in
                    zip(out_schema.fields, datas, valids)]
            return ColumnarBatch(out_schema, cols, mask, num_rows=1)

        key_cols = [batch.columns[pos[g.expr_id]] for g in self.grouping]
        dense = self._try_dense(batch, key_cols, ops, val_datas, val_valids,
                                out_schema, ctx)
        if dense is not None:
            return dense

        out_keys, bufs, out_mask = _group_kernel(
            ops, [c.eq_keys() for c in key_cols], [c.data for c in key_cols],
            [c.validity for c in key_cols], val_datas, val_valids,
            batch.row_mask)
        ctx.launches.add("gagg")
        cols = [Column(f.dataType, kd, kv) for (kd, kv), f in
                zip(out_keys, out_schema.fields[: len(key_cols)])]
        cols += [self._finish_buffer(bd, bv, f) for (bd, bv), f in
                 zip(bufs, out_schema.fields[len(key_cols):])]
        return ColumnarBatch(out_schema, cols, out_mask, num_rows=None)

    @staticmethod
    def _finish_buffer(bd, bv, f: StructField) -> Column:
        want = f.dataType.device_dtype
        if bd.dtype != want:
            bd = bd.to(want)
        return Column(f.dataType, bd, bv)

    def _try_dense(self, batch: ColumnarBatch, key_cols, ops, val_datas,
                   val_valids, out_schema, ctx):
        """Dense-range fast path dispatch: single integral key whose value
        span fits a capacity bucket (the host syncs two scalars to decide)."""
        if len(key_cols) != 1:
            return None
        kc = key_cols[0]
        if not isinstance(kc.dtype, (IntegralType, DateType)):
            return None
        cap = batch.capacity
        kmin, kmax, any_live = dense_range_stats(kc, batch.row_mask)
        if not any_live:
            return None
        span = kmax - kmin + 1
        if span + 1 > min(4 * cap, 1 << 23):
            return None  # sparse keys — sort path handles it
        out_cap = bucket_capacity(span + 1)
        out_keys, key_validity, bufs, out_mask = _dense_group_kernel(
            ops, cap, out_cap, kc.data, kc.validity, kmin, val_datas,
            val_valids, batch.row_mask)
        ctx.launches.add("dagg")
        ctx.metrics.add("agg.dense_fast_path")
        kf = out_schema.fields[0]
        kv = key_validity if kc.validity is not None else None
        cols = [Column(kf.dataType, out_keys.to(kf.dataType.device_dtype), kv)]
        cols += [self._finish_buffer(bd, bv, f)
                 for (bd, bv), f in zip(bufs, out_schema.fields[1:])]
        return ColumnarBatch(out_schema, cols, out_mask, num_rows=None)

    def simple_string(self):
        g = ", ".join(a.name for a in self.grouping)
        fns = ", ".join(type(s.func).__name__ for s in self.specs)
        return f"HashAggregate[{self.mode}](keys=[{g}], fns=[{fns}])"


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
