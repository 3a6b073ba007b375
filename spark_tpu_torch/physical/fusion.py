"""Whole-stage fusion: one program per batch per stage (counterpart of
`spark_tpu/physical/fusion.py`).

Role of the reference's WholeStageCodegen (sqlx/WholeStageCodegenExec.scala:
673 doCodeGen + CollapseCodegenStages): the filter/project pipeline body
(physical/compile.trace_pipeline) runs inside the terminal operator's body
(partial hash aggregate, hash-join probe, limit mask, shuffle write), and
the whole stage's consume side is ONE program per (structure, input
signature, capacity), held by physical/compile.STAGE_CACHE. On the card
that program is a CUDA graph captured once and replayed per batch (the
counterpart of one `jax.jit` dispatch); on the CPU it runs eagerly.

`fuse_stages` runs after stage-boundary insertion (exchanges are already
placed), so each rewrite stays inside one exchange-free chain:

  * ComputeExec(ComputeExec)              -> one ComputeExec (the
    substitution is shared with the planner's construction-time fusion)
  * HashAggregateExec[partial](ComputeExec) -> FusedAggregateExec
  * LimitExec(ComputeExec)                -> FusedLimitExec
  * HashJoinExec(left=ComputeExec)        -> probe pipeline spliced into the
    probe (operators.HashJoinExec probe_fusion)
  * ShuffleExchangeExec(ComputeExec)      -> pipeline + partition ids +
    pid-grouped gather in one map program (ExchangeFusion)

A fused program takes its batch's columns, masks and lookup tables as
inputs, and device scalars (the dense aggregate's key minimum, the
round-robin offset) too, so a new tile range or offset replays the same
graph. The unfused operator-at-a-time path stays intact behind
spark.tpu.fusion.enabled=false / spark.tpu.compile.tier=operator as the
differential-testing oracle, and partitions under spark.tpu.fusion.minRows
take it at run time. The adaptive runtime filter in a fused exchange is
not ported (the reference's `bind_runtime_filter`); a join under the
runtime join filters runs its probe pipeline unfused. A min/max over a
string column reduces in rank space inside the fused aggregate: its rank
luts ride as program inputs, and bit_and/bit_or/bit_xor run the
hand-written bit kernel in the program.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..columnar.batch import (
    EMPTY_DICT, ColumnarBatch, _take_codes, bucket_capacity,
)
from ..config import (
    ENCODING_ENABLED, FUSION_DENSE_KEYS, FUSION_EXCHANGE, FUSION_MIN_ROWS,
    SQLConf,
)
from ..errors import NotPortedError
from ..expr.expressions import Alias, AttributeReference, Expression
from ..types import (
    BooleanType, DateType, IntegralType, StringType, dict_encoded,
)
from .aggregates import PARTIAL_TO_MERGE
from .compile import (
    STAGE_CACHE, ExprPipeline, FusedPipe, key_eqs, pipeline_columns,
    pipeline_host_pass, pipeline_signature, stage_inputs, string_key_luts,
    struct_key,
)
from .operators import (
    ComputeExec, HashAggregateExec, HashJoinExec, LimitExec, PhysicalPlan,
    _AggSide, _SchemaOnly, _dense_group_kernel, _ungrouped_kernel, attrs_schema,
    dense_range_stats,
)

__all__ = ["FusedAggregateExec", "FusedLimitExec", "ExchangeFusion",
           "fuse_stages", "collapse_computes", "merge_into_compute"]

FUSABLE_OPS = frozenset(PARTIAL_TO_MERGE)


# ---------------------------------------------------------------------------
# ComputeExec collapsing (shared with the planner's construction-time path)
# ---------------------------------------------------------------------------

def merge_into_compute(filters: Sequence[Expression],
                       outputs: Sequence[Expression],
                       child: ComputeExec) -> ComputeExec:
    """Fuse a filter/project layer into an existing ComputeExec child by
    substituting the child's output expressions (the CollapseCodegenStages
    analog; all expressions are deterministic, so inlining is sound)."""
    from ..plan.optimizer import substitute_attrs

    m: dict[int, Expression] = {}
    for e in child.outputs:
        if isinstance(e, Alias):
            m[e.expr_id] = e.child
        elif isinstance(e, AttributeReference):
            m[e.expr_id] = e
    new_filters = [substitute_attrs(f, m) for f in filters]
    new_outputs: list[Expression] = []
    for o in outputs:
        if isinstance(o, Alias):
            new_outputs.append(
                Alias(substitute_attrs(o.child, m), o.name, o.expr_id))
            continue
        sub = m.get(o.expr_id)
        if sub is None or (isinstance(sub, AttributeReference)
                           and sub.expr_id == o.expr_id):
            new_outputs.append(o)
        else:
            new_outputs.append(Alias(sub, o.name, o.expr_id))
    return ComputeExec(child.filters + new_filters, new_outputs, child.child)


def collapse_computes(plan: PhysicalPlan) -> PhysicalPlan:
    """Collapse adjacent ComputeExec nodes anywhere in the physical tree:
    a ComputeExec over a ComputeExec would run two passes per batch."""

    def rule(node):
        if isinstance(node, ComputeExec) and isinstance(node.child,
                                                        ComputeExec):
            return merge_into_compute(node.filters, node.outputs, node.child)
        return node

    return plan.transform_up(rule)


# ---------------------------------------------------------------------------
# Shared fused-program plumbing
# ---------------------------------------------------------------------------

def _pipe_attrs(outputs: Sequence[Expression]) -> list[AttributeReference]:
    return [o.to_attribute() if isinstance(o, Alias) else o for o in outputs]


def _compute_nontrivial(c: ComputeExec) -> bool:
    """A pure column reorder/prune runs nothing: nothing to fuse."""
    return bool(c.filters) or any(not isinstance(o, AttributeReference)
                                  for o in c.outputs)


# ---------------------------------------------------------------------------
# FusedAggregateExec
# ---------------------------------------------------------------------------

class FusedAggregateExec(HashAggregateExec):
    """Partial hash aggregate with its feeding filter/project pipeline in
    the same program: per input batch, ONE program filters, projects and
    partially aggregates (dense-range scatter, sorted-segment, or
    whole-tile reduce). Per-batch partials then merge with the associative
    final-mode ops. The dense-range decision is memoized per column
    identity, so cached scan tiles sync it once."""

    child_fields = ("child",)

    def __init__(self, grouping, specs, filters, outputs, child):
        super().__init__(grouping, specs, "partial", child)
        self.filters = list(filters)
        self.pipe_outputs = list(outputs)
        self.pipe_attrs = _pipe_attrs(self.pipe_outputs)
        self._unfused_cache = None
        self._struct_key = struct_key(child.output, self.filters,
                                      self.pipe_outputs)

    def execute(self, ctx) -> list:
        parts = self.child.execute(ctx)
        return [[self._fused_partition(part, ctx)] for part in parts]

    def _unfused(self):
        """Operator-at-a-time path for partitions under
        spark.tpu.fusion.minRows."""
        if self._unfused_cache is None:
            pipe = ExprPipeline(self.child.output, self.filters,
                                self.pipe_outputs,
                                attrs_schema(self.pipe_attrs))
            inner = HashAggregateExec(self.grouping, self.specs, "partial",
                                      _SchemaOnly(self.pipe_attrs))
            self._unfused_cache = (pipe, inner)
        return self._unfused_cache

    def _fused_partition(self, part, ctx) -> ColumnarBatch:
        if not part:
            part = [ColumnarBatch.empty(attrs_schema(self.child.output),
                                        ctx.device)]
        if sum(b.capacity for b in part) < int(ctx.conf.get(FUSION_MIN_ROWS)):
            ctx.metrics.add("fusion.min_rows_gated", len(part))
            pipe, inner = self._unfused()
            return inner._aggregate_partition(
                [pipe.run(b, ctx.launches) for b in part], ctx)
        partials = [self._fused_batch(b, ctx) for b in part]
        if len(partials) == 1:
            return partials[0]
        merger = HashAggregateExec(self.grouping, self.specs, "final",
                                   _SchemaOnly(self.output))
        return merger._aggregate_partition(partials, ctx)

    def _fused_batch(self, batch: ColumnarBatch, ctx) -> ColumnarBatch:
        cap = batch.capacity
        hctx, host_outs, aux = pipeline_host_pass(
            self.child.output, self.filters, self.pipe_outputs, batch)
        pipe = FusedPipe(self.child.output, self.filters,
                         self.pipe_outputs, batch, aux)
        opos = {a.expr_id: i for i, a in enumerate(self.pipe_attrs)}
        vals = self._plan_values()
        ops = tuple(op for op, _, _ in vals)
        val_idx = tuple(opos[attr.expr_id] if attr is not None else -1
                        for _, attr, _ in vals)
        key_idx = tuple(opos[g.expr_id] for g in self.grouping)
        out_schema = attrs_schema(self.output)
        nv = len(ops)
        # a min/max over a dictionary-encoded column reduces in rank space
        # inside the program: its code -> rank and rank -> code luts ride
        # as inputs of every batch (so a replay reads this batch's), and
        # their positions enter the key; a first keeps its dictionary
        side = _AggSide()
        smm_idx = []
        for bi, (op, attr, _) in enumerate(vals):
            if attr is None or not dict_encoded(attr.dtype):
                continue
            sd = host_outs[val_idx[bi]].sdict
            if op in ("min", "max"):
                smm_idx.append(bi)
                sd = sd or EMPTY_DICT
            side.dicts[bi] = sd
        smm_luts = [lut for bi in smm_idx
                    for lut in side.dicts[bi].rank_luts()]
        smm_pos = {bi: 2 * j for j, bi in enumerate(smm_idx)}
        base_key = (self._struct_key, ops, val_idx, key_idx, cap,
                    tuple(smm_idx), pipeline_signature(batch),
                    hctx.signature())

        def pipe_vals(od, ov, mask, luts):
            vd = []
            for bi, i in enumerate(val_idx):
                d = od[i] if i >= 0 else mask
                if bi in smm_pos:
                    d = _take_codes(luts[smm_pos[bi]], d)
                vd.append(d)
            return vd, [ov[i] if i >= 0 else None for i in val_idx]

        def rank_to_code(bufs, luts):
            """The winning ranks of the rank-space buffers back to codes
            (an empty group's clamps harmlessly: its validity is False)."""
            return [(_take_codes(luts[smm_pos[bi] + 1], d), v)
                    if bi in smm_pos else (d, v)
                    for bi, (d, v) in enumerate(bufs)]

        def finish(bufs_d, bufs_v, fields):
            return [self._finish_buffer(bi, d, v, f, side)
                    for bi, (d, v, f) in enumerate(
                        zip(bufs_d, bufs_v, fields))]

        # ---- ungrouped -------------------------------------------------
        if not self.grouping:
            def body(ins):
                od, ov, mask, luts = pipe.run(ins)
                vd, vv = pipe_vals(od, ov, mask, luts)
                datas, valids, m = _ungrouped_kernel(ops, vd, vv, mask)
                bufs = rank_to_code(list(zip(datas, valids)), luts)
                return [d for d, _ in bufs] + [v for _, v in bufs] + [m]

            out = STAGE_CACHE.run("FusedHashAggregate[ungrouped]",
                                  ("fused_agg", "u") + base_key, body,
                                  stage_inputs(batch, aux, smm_luts),
                                  batch.device)
            ctx.launches.add("fused_agg")
            cols = finish(out[:nv], out[nv:2 * nv], out_schema.fields)
            return ColumnarBatch(out_schema, cols, out[2 * nv], num_rows=1)

        # ---- grouped: dense-range direct scatter -----------------------
        dense = self._dense_decision(batch, key_idx, host_outs, ctx)
        if dense is not None:
            kmin, out_cap, has_kv, key_dict = dense
            kpos = key_idx[0]
            kf = out_schema.fields[0]

            def body(ins):
                od, ov, mask, (kmin_t, *luts) = pipe.run(ins)
                vd, vv = pipe_vals(od, ov, mask, luts)
                keys, key_validity, bufs, out_mask = _dense_group_kernel(
                    ops, cap, out_cap, od[kpos], ov[kpos], kmin_t, vd, vv,
                    mask)
                bufs = rank_to_code(bufs, luts)
                return ([keys, key_validity, out_mask]
                        + [d for d, _ in bufs] + [v for _, v in bufs])

            out = STAGE_CACHE.run(
                "FusedHashAggregate[dense]",
                ("fused_agg", "d", out_cap) + base_key, body,
                stage_inputs(batch, aux, [np.array(kmin, dtype=np.int64)]
                             + smm_luts),
                batch.device)
            ctx.launches.add("fused_agg")
            ctx.metrics.add("agg.dense_fast_path")
            keys, key_validity, out_mask = out[:3]
            cols = [_key_column(kf, keys, key_validity if has_kv else None,
                                key_dict)]
            cols += finish(out[3:3 + nv], out[3 + nv:3 + 2 * nv],
                           out_schema.fields[1:])
            return ColumnarBatch(out_schema, cols, out_mask, num_rows=None)

        # ---- grouped: sorted-segment -----------------------------------
        from ..ops import grouping as G

        lut_pos, luts = string_key_luts(key_idx, self.pipe_attrs,
                                        host_outs)
        nk = len(key_idx)

        nl = len(luts)

        def body(ins):
            od, ov, mask, extra = pipe.run(ins)
            kl, rl = extra[:nl], extra[nl:]
            eqs = key_eqs(od, key_idx, self.pipe_attrs,
                          dict(zip(lut_pos, kl)))
            kvs = [ov[i] for i in key_idx]
            layout = G.group_rows(eqs, kvs, mask)
            keys = [G.scatter_group_keys(layout, od[i], ov[i])
                    for i in key_idx]
            vd, vv = pipe_vals(od, ov, mask, rl)
            bufs = rank_to_code(G.apply_group_ops(layout, ops, vd, vv), rl)
            return ([d for d, _ in keys] + [v for _, v in keys]
                    + [d for d, _ in bufs] + [v for _, v in bufs]
                    + [G.group_output_mask(layout)])

        out = STAGE_CACHE.run("FusedHashAggregate[sorted]",
                              ("fused_agg", "g") + base_key, body,
                              stage_inputs(batch, aux, luts + smm_luts),
                              batch.device)
        ctx.launches.add("fused_agg")
        cols = []
        for j, (ki, f) in enumerate(zip(key_idx, out_schema.fields[:nk])):
            sdict = host_outs[ki].sdict if dict_encoded(f.dataType) else None
            cols.append(_key_column(f, out[j], out[nk + j], sdict))
        b0 = 2 * nk
        cols += finish(out[b0:b0 + nv], out[b0 + nv:b0 + 2 * nv],
                       out_schema.fields[nk:])
        return ColumnarBatch(out_schema, cols, out[b0 + 2 * nv],
                             num_rows=None)

    def _dense_decision(self, batch: ColumnarBatch, key_idx, host_outs, ctx):
        """(kmin, out_cap, key_has_validity, key dictionary) for the
        dense-range body, or None. A single string key is always a dense
        candidate: its int32 codes span [0, len(dictionary)), known from
        the host pass (compressed execution). A single pass-through
        integral key is one when its value range, measured under the
        PRE-filter row mask (a superset of the post-filter range, so the
        table stays sound, merely rarely wider) and memoized per column
        identity, fits a capacity bucket."""
        if len(key_idx) != 1 or not ctx.conf.get(FUSION_DENSE_KEYS):
            return None
        cap = batch.capacity
        kpos = key_idx[0]
        if isinstance(self.pipe_attrs[kpos].dtype, StringType):
            if not ctx.conf.get(ENCODING_ENABLED):
                return None
            sd = host_outs[kpos].sdict or EMPTY_DICT
            if len(sd) + 1 > min(4 * cap, 1 << 23):
                return None  # a mega-dictionary: the sort path takes it
            ctx.metrics.add("agg.dict_code_fast_path")
            return (0, bucket_capacity(len(sd) + 1),
                    host_outs[kpos].validity is not None, sd)
        kexpr = self.pipe_outputs[kpos]
        if not isinstance(kexpr, AttributeReference):
            return None
        in_pos = next((i for i, a in enumerate(self.child.output)
                       if a.expr_id == kexpr.expr_id), None)
        if in_pos is None:
            return None
        kc = batch.columns[in_pos]
        if not isinstance(kc.dtype, (IntegralType, DateType)):
            return None
        kmin, kmax, any_live = dense_range_stats(kc, batch.row_mask)
        if not any_live:
            return None
        span = kmax - kmin + 1
        if span + 1 > min(4 * cap, 1 << 23):
            return None  # sparse keys: the sort path handles it
        return kmin, bucket_capacity(span + 1), kc.validity is not None, None

    def simple_string(self):
        g = ", ".join(a.name for a in self.grouping)
        fns = ", ".join(type(s.func).__name__ for s in self.specs)
        f = " AND ".join(x.simple_string() for x in self.filters)
        s = f"FusedHashAggregate[partial](keys=[{g}], fns=[{fns}])"
        if f:
            s += f" WHERE {f}"
        return s


def _key_column(f, data, validity, sdict):
    from ..columnar.batch import Column

    want = f.dataType.device_dtype
    return Column(f.dataType, data if data.dtype == want else data.to(want),
                  validity, sdict)


# ---------------------------------------------------------------------------
# FusedLimitExec
# ---------------------------------------------------------------------------

class FusedLimitExec(LimitExec):
    """Limit with its feeding filter/project pipeline in the limit's
    program: one program per partition computes the pipeline, ranks live
    rows (cumsum) and masks the rows past the limit."""

    child_fields = ("child",)

    def __init__(self, n, filters, outputs, child, offset: int = 0,
                 is_global: bool = False):
        super().__init__(n, child, offset=offset, is_global=is_global)
        self.filters = list(filters)
        self.pipe_outputs = list(outputs)
        self.pipe_attrs = _pipe_attrs(self.pipe_outputs)
        self._unfused_cache = None
        self._struct_key = struct_key(child.output, self.filters,
                                      self.pipe_outputs)

    @property
    def output(self):
        return self.pipe_attrs

    def execute(self, ctx) -> list:
        return [self._fused_partition(part, ctx)
                for part in self.child.execute(ctx)]

    def _unfused(self):
        """Operator-at-a-time path under spark.tpu.fusion.minRows."""
        if self._unfused_cache is None:
            pipe = ExprPipeline(self.child.output, self.filters,
                                self.pipe_outputs,
                                attrs_schema(self.pipe_attrs))
            inner = LimitExec(self.n, _SchemaOnly(self.pipe_attrs),
                              offset=self.offset, is_global=self.is_global)
            self._unfused_cache = (pipe, inner)
        return self._unfused_cache

    def _fused_partition(self, part, ctx) -> list:
        from ..columnar.ops import compact_batch, concat_batches
        from ..ops.sorting import limit_mask

        if not part:
            return []
        if sum(b.capacity for b in part) < int(ctx.conf.get(FUSION_MIN_ROWS)):
            ctx.metrics.add("fusion.min_rows_gated", len(part))
            pipe, inner = self._unfused()
            return inner._limit_partition(
                [pipe.run(b, ctx.launches) for b in part], ctx)
        batch = concat_batches(part, attrs_schema(self.child.output))
        cap = batch.capacity
        hctx, host_outs, aux = pipeline_host_pass(
            self.child.output, self.filters, self.pipe_outputs, batch)
        pipe = FusedPipe(self.child.output, self.filters,
                         self.pipe_outputs, batch, aux)
        n, offset, no = self.n, self.offset, len(self.pipe_outputs)

        def body(ins):
            od, ov, mask, _ = pipe.run(ins)
            return od + ov + [limit_mask(mask, n, offset)]

        out = STAGE_CACHE.run(
            f"FusedLimit[n={n}]",
            ("fused_limit", self._struct_key, cap, n, offset,
             pipeline_signature(batch), hctx.signature()),
            body, stage_inputs(batch, aux, []), batch.device)
        ctx.launches.add("fused_limit")
        schema = attrs_schema(self.output)
        cols = pipeline_columns(schema.fields, host_outs, out[:no],
                                out[no:2 * no])
        limited = ColumnarBatch(schema, cols, out[2 * no], num_rows=None)
        if not self.is_global and self.n * 4 <= cap:
            limited = compact_batch(limited)
        return [limited]

    def simple_string(self):
        o = ", ".join(x.simple_string() for x in self.pipe_outputs)
        f = " AND ".join(x.simple_string() for x in self.filters)
        s = f"FusedLimit[n={self.n}]({o})"
        if f:
            s += f" WHERE {f}"
        return s


# ---------------------------------------------------------------------------
# ExchangeFusion: shuffle writes consume straight from the fused stage
# ---------------------------------------------------------------------------

class ExchangeFusion:
    """The map side of a shuffle exchange fused with its producing
    pipeline: per input batch, ONE program filters, projects, computes the
    partition id of every live row (hash / range / round-robin), groups
    rows by pid (a stable sort; the per-partition counts from the
    hand-written histogram kernel) and gathers the pipeline OUTPUT columns
    into pid order. The shuffle write (exec/shuffle.shuffle_fused) slices
    them into the reduce buffers after the counts cross to the host. The
    round-robin running offset and the range bounds are program inputs,
    so the program's key does not depend on them."""

    def __init__(self, filters: Sequence[Expression],
                 outputs: Sequence[Expression], input_attrs):
        self.filters = list(filters)
        self.pipe_outputs = list(outputs)
        self.pipe_attrs = _pipe_attrs(self.pipe_outputs)
        self.input_attrs = list(input_attrs)
        self._pipe_cache = None
        self._struct_key = struct_key(self.input_attrs, self.filters,
                                      self.pipe_outputs)
        self._mode = None
        self._num_out = None
        self._key_idx = ()
        self._seed = 42
        self._descending = False
        self._nulls_first = True
        self._bounds = None
        self._range_pos = None

    # -- partitioning binding (one ExchangeFusion serves one execute) ------
    def bind_hash(self, key_positions, num_out: int, seed: int = 42):
        self._mode, self._num_out = "h", num_out
        self._key_idx, self._seed = tuple(key_positions), seed
        return self

    def bind_rr(self, num_out: int):
        self._mode, self._num_out = "rr", num_out
        return self

    def bind_range(self, key_position: int, bounds, descending: bool,
                   nulls_first: bool, num_out: int):
        self._mode, self._num_out = "rg", num_out
        self._range_pos = key_position
        self._descending = descending
        self._nulls_first = nulls_first
        self._bounds = np.asarray(bounds)
        return self

    def bind_runtime_filter(self, rf: dict):
        raise NotPortedError("the runtime join filter in a fused exchange "
                             "(physical/adaptive.py)")

    # -- unfused path (spark.tpu.fusion.minRows gate) ----------------------
    def _pipeline(self) -> ExprPipeline:
        if self._pipe_cache is None:
            self._pipe_cache = ExprPipeline(
                self.input_attrs, self.filters, self.pipe_outputs,
                attrs_schema(self.pipe_attrs))
        return self._pipe_cache

    def run_pipeline(self, batch: ColumnarBatch,
                     counters=None) -> ColumnarBatch:
        """Materialize the pipeline only (range sampling, size gate)."""
        return self._pipeline().run(batch, counters)

    def partition_unfused(self, batch: ColumnarBatch, start: int, ctx):
        """The operator-at-a-time kernels for undersized partitions: one
        pipeline pass + one partitioning pass per batch."""
        from ..exec import shuffle as S

        b = self.run_pipeline(batch, ctx.launches)
        if self._mode == "h":
            ctx.launches.add("shuffle_hash")
            return S.hash_partition_batch(b, self._key_idx, self._num_out,
                                          self._seed)
        if self._mode == "rr":
            ctx.launches.add("shuffle_rr")
            return S.rr_partition_batch(b, self._num_out, start)
        ctx.launches.add("shuffle_range")
        return S.range_partition_batch(
            b, self._range_pos,
            torch.as_tensor(self._bounds, device=b.device),
            self._descending, self._nulls_first, self._num_out)

    # -- the fused program -------------------------------------------------
    def partition_batch(self, batch: ColumnarBatch, start: int, ctx):
        """One program: (pid-grouped live columns, per-partition counts)."""
        from ..ops import partition as P

        cap = batch.capacity
        num_out = self._num_out
        hctx, host_outs, aux = pipeline_host_pass(
            self.input_attrs, self.filters, self.pipe_outputs, batch)
        pipe = FusedPipe(self.input_attrs, self.filters, self.pipe_outputs,
                         batch, aux)
        mode, seed = self._mode, self._seed
        key_idx, rpos = self._key_idx, self._range_pos
        descending, nulls_first = self._descending, self._nulls_first
        attrs = self.pipe_attrs
        lut_pos, luts = string_key_luts(key_idx, attrs, host_outs)
        if mode == "h":
            extra = luts
        elif mode == "rr":
            extra = [np.array(start % num_out, dtype=np.int64)]
        else:
            extra = [self._bounds]
        no = len(self.pipe_outputs)

        def body(ins):
            od, ov, mask, ops_in = pipe.run(ins)
            if mode == "h":
                eqs = key_eqs(od, key_idx, attrs, dict(zip(lut_pos, ops_in)))
                pr = P.hash_partition(eqs, [ov[i] for i in key_idx], mask,
                                      num_out, seed=seed)
            elif mode == "rr":
                pr = P.round_robin_partition(mask, num_out, ops_in[0])
            else:
                keys = od[rpos]
                if isinstance(attrs[rpos].dtype, BooleanType):
                    keys = keys.to(torch.int32)
                pr = P.range_partition(keys, ops_in[0], mask, num_out,
                                       descending, ov[rpos], nulls_first)
            return ([d[pr.perm] for d in od]
                    + [None if v is None else v[pr.perm] for v in ov]
                    + [pr.counts])

        out = STAGE_CACHE.run(
            f"FusedShuffle[{mode}]",
            ("fused_shuffle", mode, self._struct_key, cap, num_out, key_idx,
             seed, descending, nulls_first, rpos,
             pipeline_signature(batch), hctx.signature()),
            body, stage_inputs(batch, aux, extra), batch.device)
        ctx.launches.add("fused_shuffle")
        counts = out[2 * no].tolist()
        live = sum(counts)
        fields = attrs_schema(self.pipe_attrs).fields
        gathered = []
        for i, f in enumerate(fields):
            sdict = host_outs[i].sdict if dict_encoded(f.dataType) else None
            v = out[no + i]
            gathered.append((out[i][:live], None if v is None else v[:live],
                             sdict))
        return gathered, counts


# ---------------------------------------------------------------------------
# FuseStages planner rule
# ---------------------------------------------------------------------------

def _aggregate_fusable(agg: HashAggregateExec, compute: ComputeExec) -> bool:
    if not _compute_nontrivial(compute):
        return False
    if not all(s.mergeable for s in agg.specs):
        return False
    out_ids = {a.expr_id for a in compute.output}
    if any(g.expr_id not in out_ids for g in agg.grouping):
        return False
    for op, attr, _param in agg._plan_values():
        # string min/max fuses too: it reduces in rank space with its
        # rank luts as program inputs
        if op not in FUSABLE_OPS:
            return False
        if attr is not None and attr.expr_id not in out_ids:
            return False
    return True


def _exchange_fusable(exch, compute: ComputeExec, conf: SQLConf) -> bool:
    from .partitioning import (
        HashPartitioning, RangePartitioning, UnknownPartitioning,
    )

    if not conf.get(FUSION_EXCHANGE):
        return False
    if not _compute_nontrivial(compute):
        return False
    p = exch.partitioning
    out_by_id = {a.expr_id: a for a in compute.output}
    if isinstance(p, HashPartitioning):
        for e in p.exprs:
            if not isinstance(e, AttributeReference):
                return False
            a = out_by_id.get(e.expr_id)
            if a is None:
                return False
            if isinstance(a.dtype, StringType):
                # string keys hash through padded dictionary-hash luts
                # inside the program (compressed execution)
                if not conf.get(ENCODING_ENABLED):
                    return False
            elif dict_encoded(a.dtype):
                return False
        return True
    if isinstance(p, UnknownPartitioning):
        return True  # round-robin: no keys; the offset is an input
    if isinstance(p, RangePartitioning):
        if len(p.orders) != 1:
            return False
        oc = p.orders[0].child
        if not isinstance(oc, AttributeReference):
            return False
        a = out_by_id.get(oc.expr_id)
        if a is None or isinstance(a.dtype, StringType) \
                or dict_encoded(a.dtype):
            # string pids ride a host rank->pid lut per dictionary
            return False
        # computed sort keys fuse too: bounds sample the POST-pipeline key
        return True
    return False  # SinglePartition gathers without kernels


def _probe_fusable(join: HashJoinExec, compute: ComputeExec,
                   conf: SQLConf) -> bool:
    if not _compute_nontrivial(compute):
        return False
    out_by_id = {a.expr_id: a for a in compute.output}
    for k in join.left_keys:
        a = out_by_id.get(k.expr_id)
        if a is None:
            return False
        if isinstance(a.dtype, StringType):
            # string probe keys hash through the padded dictionary-hash
            # lut inside the probe program (compressed execution)
            if not conf.get(ENCODING_ENABLED):
                return False
        elif dict_encoded(a.dtype):
            return False
    return True


def fuse_stages(plan: PhysicalPlan, conf: SQLConf) -> PhysicalPlan:
    """Collapse each maximal exchange-free chain of fusable operators into
    whole-stage fused operators (run by the planner after
    EnsureRequirements: the CollapseCodegenStages slot in the reference's
    preparation rules)."""
    from .exchange import ShuffleExchangeExec

    plan = collapse_computes(plan)

    def rule(node):
        if isinstance(node, HashAggregateExec) \
                and not isinstance(node, FusedAggregateExec) \
                and node.mode == "partial" \
                and isinstance(node.child, ComputeExec) \
                and _aggregate_fusable(node, node.child):
            c = node.child
            fused = FusedAggregateExec(node.grouping, node.specs, c.filters,
                                       c.outputs, c.child)
            fused.single_pass = node.single_pass
            return fused
        if isinstance(node, LimitExec) \
                and not isinstance(node, FusedLimitExec) \
                and isinstance(node.child, ComputeExec) \
                and _compute_nontrivial(node.child):
            c = node.child
            return FusedLimitExec(node.n, c.filters, c.outputs, c.child,
                                  offset=node.offset,
                                  is_global=node.is_global)
        if isinstance(node, HashJoinExec) and node.probe_fusion is None \
                and isinstance(node.left, ComputeExec) \
                and _probe_fusable(node, node.left, conf):
            c = node.left
            node.probe_fusion = (list(c.filters), list(c.outputs))
            node.probe_attrs = list(c.output)
            node.left = c.child
            return node
        if isinstance(node, ShuffleExchangeExec) \
                and node.pipe_fusion is None \
                and isinstance(node.child, ComputeExec) \
                and _exchange_fusable(node, node.child, conf):
            c = node.child
            node.pipe_fusion = (list(c.filters), list(c.outputs))
            node.pipe_attrs = list(c.output)
            node.child = c.child
            return node
        return node

    return plan.transform_up(rule)
