"""Filter/project pipelines and operator launch counters (counterpart of
`spark_tpu/physical/compile.py`).

The JAX package traces each pipeline into one jitted program cached by
structure. PyTorch runs eagerly, so there is nothing to compile or cache:
`ExprPipeline` evaluates the expressions on each batch's tensors. What the
port keeps from `KernelCache` is the bookkeeping: `LaunchCounters` counts
operator dispatches by kind ("pipeline", "dagg", "gagg", ...), one per
batch, so a run can show which paths it took.
"""

from __future__ import annotations

import collections
import threading
from typing import Sequence

import torch

from ..columnar.batch import Column, ColumnarBatch
from ..expr.eval import EvalCtx, Val
from ..expr.expressions import AttributeReference, Expression
from ..types import StructType

__all__ = ["LaunchCounters", "ExprPipeline", "broadcast_to_cap"]


class LaunchCounters:
    """Operator dispatches by kind (plain integers behind one lock)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.by_kind: collections.Counter = collections.Counter()

    def add(self, kind: str) -> None:
        with self._lock:
            self.by_kind[kind] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.by_kind)


def broadcast_to_cap(x: torch.Tensor | None, cap: int) -> torch.Tensor | None:
    if x is None:
        return None
    if x.dim() == 0:
        return x.expand(cap).clone()
    return x


class ExprPipeline:
    """`filters` (conjunctive predicates) and `outputs` (named expressions)
    over a fixed input attribute list, applied to one batch at a time."""

    def __init__(self, input_attrs: Sequence[AttributeReference],
                 filters: Sequence[Expression],
                 outputs: Sequence[Expression],
                 out_schema: StructType):
        self.input_attrs = list(input_attrs)
        self.filters = list(filters)
        self.outputs = list(outputs)
        self.out_schema = out_schema

    def run(self, batch: ColumnarBatch,
            counters: LaunchCounters | None = None) -> ColumnarBatch:
        cap = batch.capacity
        inputs = {a.expr_id: Val(a.dtype, c.data, c.validity, c.dictionary)
                  for a, c in zip(self.input_attrs, batch.columns)}
        ctx = EvalCtx(inputs, cap, batch.device)
        mask = batch.row_mask
        for f in self.filters:
            fv = ctx.eval(f)
            pd = fv.data if fv.validity is None else fv.data & fv.validity
            mask = mask & broadcast_to_cap(pd, cap)
        cols = []
        for f, o in zip(self.out_schema.fields, self.outputs):
            ov = ctx.eval(o)
            cols.append(Column(f.dataType, broadcast_to_cap(ov.data, cap),
                               broadcast_to_cap(ov.validity, cap),
                               ov.sdict))
        if counters is not None:
            counters.add("pipeline")
        return ColumnarBatch(self.out_schema, cols, mask, num_rows=None)
