"""WindowExec (counterpart of `spark_tpu/physical/window.py`).

Each partition (hash-clustered by the window's partition keys, or a single
partition when it has none) concatenates into one tile; frame evaluation is
the sort/segment layout of `ops/window.py`, and results scatter back to the
input row order, so the operator keeps its child's order as the reference's
does. The reference's AQE coalescing of small partitions is not ported:
each partition runs on its own.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..columnar.batch import (
    EMPTY_DICT, Column, ColumnarBatch, _take_codes, bucket_capacity,
    merge_string_dicts,
)
from ..columnar.ops import compact_batch, concat_batches
from ..errors import NotPortedError
from ..exec.context import ExecContext
from ..expr.eval import EvalCtx, Val
from ..expr.expressions import (
    Alias, AttributeReference, Average, Count, Max, Min, SortOrder, Sum,
)
from ..expr.window import (
    CumeDist, DenseRank, FirstValue, Lag, LastValue, Lead, NthValue, NTile,
    PercentRank, Rank, RowNumber, WindowExpression,
)
from ..ops import window as W
from ..ops.sorting import SortKeySpec
from ..types import (
    DateType, DecimalType, IntegralType, dict_encoded,
)
from .compile import broadcast_to_cap
from .operators import PhysicalPlan, attrs_schema
from .partitioning import AllTuples, ClusteredDistribution

_AGGS = {Sum: "sum", Count: "count", Min: "min", Max: "max", Average: "avg"}


class WindowExec(PhysicalPlan):
    """window_exprs: Alias(WindowExpression) whose function arguments,
    partition keys and order keys the planner bound to child attributes."""

    child_fields = ("child",)

    def __init__(self, window_exprs: Sequence[Alias],
                 partition_keys: Sequence[AttributeReference],
                 order_keys: Sequence[SortOrder], child: PhysicalPlan):
        self.window_exprs = list(window_exprs)
        self.partition_keys = list(partition_keys)
        self.order_keys = list(order_keys)
        self.child = child

    @property
    def output(self):
        return self.child.output + [a.to_attribute()
                                    for a in self.window_exprs]

    def required_child_distribution(self):
        if not self.partition_keys:
            return [AllTuples()]
        return [ClusteredDistribution(list(self.partition_keys))]

    def output_partitioning(self):
        return self.child.output_partitioning()

    def _plans(self):
        """(kind, param, argument) per window expression."""
        out = []
        has_order = bool(self.order_keys)
        for al in self.window_exprs:
            w: WindowExpression = al.child
            f = w.function
            if isinstance(f, RowNumber):
                out.append(("row_number", None, None))
            elif isinstance(f, Rank):
                out.append(("rank", None, None))
            elif isinstance(f, DenseRank):
                out.append(("dense_rank", None, None))
            elif isinstance(f, PercentRank):
                out.append(("percent_rank", None, None))
            elif isinstance(f, CumeDist):
                out.append(("cume_dist", None, None))
            elif isinstance(f, NTile):
                out.append(("ntile", f.n, None))
            elif isinstance(f, Lag):  # and Lead, its subclass
                # the default: an expression over the child's columns,
                # cast to the function's type by the planner, or None
                off = -f.offset if isinstance(f, Lead) else f.offset
                out.append(("shift", (off, f.default), f.child))
            elif isinstance(f, (NthValue, FirstValue)):
                # default frame: running to the current peers; explicit
                # UNBOUNDED..UNBOUNDED: the whole partition
                frame = w.frame
                if frame is None:
                    scope = "peers"
                elif (frame[1], frame[2]) == (None, None):
                    scope = "partition"
                else:
                    raise NotPortedError(f"{type(f).__name__} over a "
                                         "bounded frame")
                if isinstance(f, NthValue):
                    out.append(("nth_value", (f.n, scope), f.child))
                elif isinstance(f, LastValue):  # a FirstValue subclass
                    out.append(("last_value", scope, f.child))
                else:
                    out.append(("first_value", scope, f.child))
            elif type(f) in _AGGS:
                kind = _AGGS[type(f)]
                frame = w.frame
                if frame is None:
                    mode = "running" if has_order else "unbounded"
                    out.append((f"agg_{mode}_{kind}", None, f.child))
                    continue
                ftype, lo, hi = frame
                if (lo, hi) == (None, None):
                    out.append((f"agg_unbounded_{kind}", None, f.child))
                elif ftype == "vrange":
                    if len(self.order_keys) != 1:
                        raise NotPortedError("RANGE value frames over more "
                                             "than one ORDER BY key")
                    out.append((f"agg_vrange_{kind}", (lo, hi), f.child))
                else:
                    out.append((f"agg_rows_{kind}", (lo, hi), f.child))
            else:
                raise NotPortedError(f"window function {type(f).__name__}")
        return out

    def execute(self, ctx: ExecContext):
        from .adaptive import coalesce_after_exchange

        parts = coalesce_after_exchange(self.child, self.child.execute(ctx),
                                        ctx, self.child.output)
        return [[self._run_partition(p, ctx)] if p else [] for p in parts]

    def _run_partition(self, part, ctx) -> ColumnarBatch:
        batch = concat_batches(part, attrs_schema(self.child.output))
        # a partition gathered from an exchange holds mostly dead slots:
        # the layout's sorts and scans run over the live rows only
        if bucket_capacity(max(batch.num_rows(), 1)) < batch.capacity:
            batch = compact_batch(batch)
        pos = {a.expr_id: i for i, a in enumerate(self.child.output)}
        cap = batch.capacity
        pcols = [batch.columns[pos[k.expr_id]] for k in self.partition_keys]
        ocols = [batch.columns[pos[o.child.expr_id]]
                 for o in self.order_keys]
        ospecs = [SortKeySpec(o.ascending, o.nulls_first)
                  for o in self.order_keys]
        plans = self._plans()
        kmin, band = self._band(plans, ocols, ospecs, batch) \
            if any(k.startswith("agg_vrange_") for k, _, _ in plans) \
            else (0, 0)

        lo = W.build_layout([c.eq_keys() for c in pcols],
                            [c.validity for c in pcols],
                            [c.sort_keys() for c in ocols],
                            [c.validity for c in ocols], ospecs,
                            batch.row_mask)
        ones = torch.ones(cap, dtype=torch.int32, device=batch.device)
        new_cols = list(batch.columns)
        for (kind, param, arg), al in zip(plans, self.window_exprs):
            vc = None if arg is None else batch.columns[pos[arg.expr_id]]
            vd, vv = (vc.data, vc.validity) if vc is not None else (ones, None)
            # shift and the value functions over strings keep the source
            # dictionary (shift merges its default's into it)
            sdict = vc.dictionary if vc is not None else None
            if kind == "shift":
                off, dflt = param
                sv, svalid, sdict = self._shift(
                    lo, off, vc, None if dflt is None else
                    self._evaluate(dflt, batch))
            elif kind.endswith(("_min", "_max")) and \
                    dict_encoded(vc.dtype):
                # a dictionary-encoded min/max reduces the entries' ranks
                # (codes follow first appearance, not order: C19) and
                # maps the winning rank back to its code
                sd = vc.dictionary or EMPTY_DICT
                sv, svalid = self._compute(lo, kind, param, vc.sort_keys(),
                                           vv, ocols, kmin, band)
                sv = _take_codes(sd.device_rank_to_code(sv.device), sv)
            else:
                sv, svalid = self._compute(lo, kind, param, vd, vv, ocols,
                                           kmin, band)
            d, v = W.scatter_back(lo, sv, svalid)
            dt = al.child.dtype
            fn = al.child.function
            if isinstance(dt, DecimalType) and isinstance(fn, Average) and \
                    isinstance(fn.child.dtype, DecimalType):
                # the kernel's avg is sum / count in the INPUT scale; the
                # result carries a wider scale (avg of decimal(p, s) is
                # decimal(p+4, s+4)): scaled, then rounded half to even
                scale = dt.scale - fn.child.dtype.scale
                d = torch.round(d * (10.0 ** scale))
            if d.dtype != dt.device_dtype:
                d = d.to(dt.device_dtype)
            if not dict_encoded(dt):
                sdict = None
            new_cols.append(Column(dt, d, v, sdict))
        ctx.launches.add("window")
        return ColumnarBatch(attrs_schema(self.output), new_cols,
                             batch.row_mask, batch._num_rows)

    def _evaluate(self, expr, batch) -> Column:
        """expr over the batch's rows (a literal broadcast to them)."""
        cap = batch.capacity
        val = EvalCtx({a.expr_id: Val(a.dtype, c.data, c.validity,
                                      c.dictionary)
                       for a, c in zip(self.child.output, batch.columns)},
                      cap, batch.device).eval(expr)
        return Column(val.dtype, broadcast_to_cap(val.data, cap),
                      broadcast_to_cap(val.validity, cap), val.sdict)

    @staticmethod
    def _shift(lo, offset, vc, dc):
        """lag/lead of column vc: (sorted data, validity, dictionary). A
        row whose source lies outside its partition takes the default
        column dc's value for that row (None: NULL); a dictionary-encoded
        value and default are recoded into one merged dictionary."""
        vd, sdict = vc.data, vc.dictionary
        if dc is None:
            return (*W.w_shift(lo, vd, vc.validity, offset), sdict)
        dd = dc.data
        if dict_encoded(vc.dtype):
            sdict, luts = merge_string_dicts([vc.dictionary or EMPTY_DICT,
                                              dc.dictionary or EMPTY_DICT])
            vd, dd = (_take_codes(torch.from_numpy(lut).to(c.device), c)
                      for lut, c in zip(luts, (vd, dd)))
        dv = None if dc.validity is None else dc.validity[lo.perm]
        return (*W.w_shift(lo, vd, vc.validity, offset, dd[lo.perm], dv),
                sdict)

    @staticmethod
    def _compute(lo, kind, param, vd, vv, ocols, kmin, band):
        if kind == "row_number":
            return W.w_row_number(lo), None
        if kind == "rank":
            return W.w_rank(lo), None
        if kind == "dense_rank":
            return W.w_dense_rank(lo), None
        if kind == "percent_rank":
            return W.w_percent_rank(lo), None
        if kind == "cume_dist":
            return W.w_cume_dist(lo), None
        if kind == "ntile":
            return W.w_ntile(lo, param), None
        if kind == "first_value":
            return W.w_first_value(lo, vd, vv)
        if kind == "last_value":
            return W.w_last_value(lo, vd, vv, whole=param == "partition")
        if kind == "nth_value":
            return W.w_nth_value(lo, vd, vv, param[0],
                                 whole=param[1] == "partition")
        agg = kind.split("_")[-1]
        if kind.startswith("agg_vrange_"):
            return W.w_agg_value_range(lo, ocols[0].sort_keys(), vd, vv, agg,
                                       param[0], param[1], kmin, band)
        if kind.startswith("agg_rows_"):
            return W.w_agg_rows(lo, vd, vv, agg, param[0], param[1])
        if kind.startswith("agg_running_"):
            return W.w_agg_running(lo, vd, vv, agg)
        return W.w_agg_unbounded(lo, vd, vv, agg)

    @staticmethod
    def _band(plans, ocols, ospecs, batch):
        """(kmin, band) of a value-RANGE frame: the single integral order
        key banded per partition (one host sync for its min and max)."""
        oc = ocols[0]
        if not isinstance(oc.dtype, (IntegralType, DateType)) or \
                oc.validity is not None:
            raise NotPortedError("RANGE value frames over a nullable or "
                                 "non-integral ORDER BY key")
        if not ospecs[0].ascending:
            raise NotPortedError("RANGE value frames over a descending "
                                 "ORDER BY")
        k = oc.data.to(torch.int64)
        m = batch.row_mask
        kmin, kmax = (int(x) for x in torch.stack([
            torch.where(m, k, torch.full_like(k, torch.iinfo(torch.int64).max)
                        ).min(),
            torch.where(m, k, torch.full_like(k, torch.iinfo(torch.int64).min)
                        ).max()]).tolist())
        offs = [p for kind, p, _ in plans if kind.startswith("agg_vrange_")]
        max_off = max(abs(p[0] or 0) for p in offs) + \
            max(abs(p[1] or 0) for p in offs) + 1
        span = max(kmax - kmin + 1 + 2 * max_off, 8)
        band = 1
        while band < span:
            band <<= 1
        if batch.capacity * band >= (1 << 62):
            raise NotPortedError("RANGE frame key span too large to band")
        return kmin, band

    def simple_string(self):
        fns = ", ".join(a.child.function.sql_name()
                        for a in self.window_exprs)
        return f"Window[{fns}]"
