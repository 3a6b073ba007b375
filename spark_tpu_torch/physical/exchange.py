"""Exchange operators (counterpart of `spark_tpu/physical/exchange.py`):
`ShuffleExchangeExec` for hash, round-robin, range and single-partition
distributions, and `BroadcastExchangeExec`, which concatenates the build
side into one batch that every probe partition reads. Under the stage tier
a shuffle exchange may absorb the filter/project pipeline below it
(`pipe_fusion`, physical/fusion.ExchangeFusion): one program per map batch
runs the pipeline, the partition ids and the pid-grouped gather. The mesh
variant and the adaptive runtime filter's pruning are not ported."""

from __future__ import annotations

import numpy as np
import torch

from ..columnar.batch import EMPTY_DICT, ColumnarBatch
from ..columnar.ops import concat_batches
from ..errors import NotPortedError
from ..exec import shuffle as S
from ..exec.context import ExecContext
from ..expr.expressions import AttributeReference
from ..types import DecimalType, FractionalType, StringType
from ..utils.device_memo import memo_device_scalars
from .operators import PhysicalPlan, attrs_schema
from .partitioning import (
    BroadcastPartitioning, HashPartitioning, Partitioning, RangePartitioning,
    SinglePartition, UnknownPartitioning,
)


class ShuffleExchangeExec(PhysicalPlan):
    child_fields = ("child",)

    def __init__(self, partitioning: Partitioning, child: PhysicalPlan):
        self.partitioning = partitioning
        self.child = child
        # set by fuse_stages (physical/fusion.py): (filters, outputs) of
        # the producing pipeline run inside the map program
        self.pipe_fusion: tuple | None = None
        self.pipe_attrs: list | None = None

    @property
    def output(self):
        if self.pipe_attrs is not None:
            return self.pipe_attrs
        return self.child.output

    def output_partitioning(self):
        return self.partitioning

    def _fusion(self):
        """A fresh ExchangeFusion per execute (it carries the
        partitioning binding); the captured programs live in
        compile.STAGE_CACHE, so rebuilding the binder captures nothing."""
        from .fusion import ExchangeFusion

        filters, outputs = self.pipe_fusion
        return ExchangeFusion(filters, outputs, self.child.output)

    def execute(self, ctx: ExecContext) -> list:
        parts = self.child.execute(ctx)
        schema = attrs_schema(self.output)
        p = self.partitioning
        fusion = self._fusion() if self.pipe_fusion is not None else None
        if isinstance(p, SinglePartition):
            return S.gather_single(parts)
        if isinstance(p, HashPartitioning):
            pos = {a.expr_id: i for i, a in enumerate(self.output)}
            key_positions = []
            for e in p.exprs:
                if not isinstance(e, AttributeReference):
                    raise ValueError("exchange keys must be attributes "
                                     "(planner contract)")
                key_positions.append(pos[e.expr_id])
            if fusion is not None:
                return S.shuffle_fused(
                    parts, fusion.bind_hash(key_positions, p.num_partitions),
                    p.num_partitions, schema, ctx)
            return S.shuffle_hash(parts, key_positions, p.num_partitions,
                                  schema, ctx)
        if isinstance(p, RangePartitioning):
            return self._range_shuffle(parts, p, schema, ctx, fusion)
        if isinstance(p, UnknownPartitioning):
            if fusion is not None:
                return S.shuffle_fused(parts, fusion.bind_rr(p.num_partitions),
                                       p.num_partitions, schema, ctx)
            return S.shuffle_round_robin(parts, p.num_partitions, schema, ctx)
        raise NotPortedError(f"exchange for {type(p).__name__}")

    def _range_shuffle(self, parts, p: RangePartitioning, schema, ctx,
                       fusion=None):
        """Partition by the FIRST sort key against bounds sampled from the
        first two tiles of each input partition; rows with equal first keys
        land in one partition, so each partition's sort finishes the
        order. Fused, the bounds sample the POST-pipeline key: the pipeline
        is materialized for at most three tiles of each partition (first,
        middle, last), so a selective filter does not skew the partitions
        and a computed key fuses too."""
        order = p.orders[0]
        pos = {a.expr_id: i for i, a in enumerate(self.output)}
        if not isinstance(order.child, AttributeReference):
            raise ValueError("range keys must be attributes (planner "
                             "contract)")
        kpos = pos[order.child.expr_id]
        if fusion is not None:
            def picks(part):
                return list(part) if len(part) <= 3 \
                    else [part[0], part[len(part) // 2], part[-1]]

            sample_parts = [[fusion.run_pipeline(b) for b in picks(part)]
                            for part in parts]
            bounds = _sample_bounds(sample_parts, kpos, schema,
                                    p.num_partitions, all_batches=True)
            if bounds is None or len(bounds) == 0:
                return S.gather_single(
                    [[fusion.run_pipeline(b, ctx.launches) for b in part]
                     for part in parts])
            return S.shuffle_fused(
                parts, fusion.bind_range(kpos, bounds, not order.ascending,
                                         order.nulls_first_effective,
                                         p.num_partitions),
                p.num_partitions, schema, ctx)
        bounds = _sample_bounds(parts, kpos, schema, p.num_partitions)
        if bounds is None or len(bounds) == 0:
            return S.gather_single(parts)
        return S.shuffle_range(parts, kpos, bounds, not order.ascending,
                               order.nulls_first_effective,
                               p.num_partitions, schema, ctx)

    def simple_string(self):
        s = (f"Exchange[{type(self.partitioning).__name__}"
             f"({self.partitioning.num_partitions})]")
        if self.pipe_fusion is not None:
            filters, outputs = self.pipe_fusion
            o = ", ".join(x.simple_string() for x in outputs)
            s += f" FUSED-MAP[{o}]"
            if filters:
                s += " WHERE " + " AND ".join(x.simple_string()
                                              for x in filters)
        return s


def _batch_key_samples(batch: ColumnarBatch, kpos: int, f,
                       per_part_sample: int) -> tuple:
    """The non-null keys among the first `per_part_sample` live rows of one
    batch, as an immutable tuple. The device-to-host pull is memoized per
    (data, validity, mask) identity, so device-cached scan tiles sync once."""
    col = batch.columns[kpos]

    def compute():
        live = torch.nonzero(batch.row_mask).squeeze(1)[:per_part_sample]
        data = col.data[live]
        if col.validity is not None:
            data = data[col.validity[live]]
        keys = data.cpu().numpy().tolist()
        if col.is_string:  # the values, through the batch's dictionary
            values = (col.dictionary or EMPTY_DICT).values
            return tuple(values[k] for k in keys)
        return tuple(keys)

    return memo_device_scalars(
        ("range_sample", kpos, per_part_sample, f.dataType.simple_string()),
        (col.data, col.validity, batch.row_mask), compute)


def _sample_bounds(parts, kpos: int, schema, num_out: int,
                   per_part_sample: int = 4096, all_batches: bool = False):
    """Sample the sort key to derive range bounds (the reference's
    RangePartitioner sampling): up to `per_part_sample` keys of the first
    two tiles (every tile where `all_batches`) of every partition, the
    distinct values sorted, and num_out - 1 evenly spaced quantiles, as
    float64 (NaN as +inf), int64 or a sorted list of strings."""
    f = schema.fields[kpos]
    samples = []
    for part in parts:
        for batch in (part if all_batches else part[:2]):
            samples.extend(_batch_key_samples(batch, kpos, f,
                                              per_part_sample))
    if not samples:
        return None
    if isinstance(f.dataType, StringType):
        s = sorted(set(samples))
        if len(s) <= 1:
            return None
        return sorted({s[int(round(i * (len(s) - 1) / num_out))]
                       for i in range(1, num_out)})
    # decimals sample their scaled int64 values
    floating = isinstance(f.dataType, FractionalType) and \
        not isinstance(f.dataType, DecimalType)
    s = np.unique(np.asarray(samples,
                             dtype=np.float64 if floating else np.int64))
    if len(s) <= 1:
        return None
    qs = [int(round(i * (len(s) - 1) / num_out)) for i in range(1, num_out)]
    bounds = np.unique(s[qs])
    if floating:
        bounds = np.where(np.isnan(bounds), np.inf, bounds)
    return bounds


class BroadcastExchangeExec(PhysicalPlan):
    child_fields = ("child",)

    def __init__(self, child: PhysicalPlan):
        self.child = child

    @property
    def output(self):
        return self.child.output

    def output_partitioning(self):
        return BroadcastPartitioning()

    def execute(self, ctx: ExecContext) -> list:
        parts = self.child.execute(ctx)
        merged = [b for p in parts for b in p]
        schema = attrs_schema(self.output)
        if not merged:
            return [[ColumnarBatch.empty(schema, ctx.device)]]
        batch = concat_batches(merged, schema)
        ctx.metrics.add("broadcast.rows", batch.num_rows())
        return [[batch]]

    def simple_string(self):
        return "BroadcastExchange"
