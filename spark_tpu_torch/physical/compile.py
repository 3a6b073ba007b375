"""Filter/project pipelines, fused-stage plumbing and the stage cache
(counterpart of `spark_tpu/physical/compile.py`).

The operator tier evaluates each pipeline eagerly (`ExprPipeline`), one
batch at a time. The stage tier (physical/fusion.py) runs a whole stage's
consume side as ONE program per batch, in two passes as the reference does:
`pipeline_host_pass` harvests each output's metadata and the lookup tables
the expressions read (over meta tensors: no row is computed), and
`trace_pipeline` computes the pipeline from the batch's tensors and those
tables inside the stage's body. `canonical_key` keys a body by structure
(attribute ids replaced by input positions; literals are part of the key,
so they may be baked into a program).

`StageCache` is the counterpart of `KernelCache`: on the card it holds one
captured CUDA graph per (stage structure, input signature, capacity),
bounded in count (`max_size`) and in the card memory its graphs hold
(`max_bytes`), and replays it once per batch (utils/cuda_graph.py); on the
CPU the body runs eagerly. A whole-query program (physical/whole_query.py)
is one entry too, keyed by ("whole_query", its builder's key) and its
inputs, replayed once per query step; its joins' `needed` scalars are
outputs of the program, read on the host after the replay. Its counters
are captures, hits, replays, pool resets and programs too large to keep,
with the capture time and the graph memory. `LaunchCounters` counts
operator dispatches by kind ("pipeline", "dagg", "fused_agg", ...), one
per batch.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Sequence

import torch

from ..columnar.batch import EMPTY_DICT, Column, ColumnarBatch, _take_codes
from ..expr.eval import EvalCtx, HostCtx, TraceCtx, Val
from ..expr.expressions import (
    Alias, AttributeReference, Expression, Literal, SortOrder,
)
from ..types import (
    BooleanType, DataType, StringType, StructType, dict_encoded,
)

__all__ = ["LaunchCounters", "ExprPipeline", "broadcast_to_cap",
           "canonical_key", "bind_inputs", "pipeline_host_pass",
           "pipeline_signature", "pipeline_columns", "trace_pipeline",
           "struct_key", "stage_inputs", "FusedPipe", "key_eqs",
           "string_key_luts", "program_key", "StageCache", "STAGE_CACHE"]


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


# ---------------------------------------------------------------------------
# Structural canonicalization
# ---------------------------------------------------------------------------

def canonical_key(e: Expression, id_to_pos: dict[int, int]) -> tuple:
    """Hashable structural key with attribute ids replaced by input positions
    (so two queries with identical shapes share programs)."""
    if isinstance(e, AttributeReference):
        return ("attr", id_to_pos.get(e.expr_id, -1), str(e.dtype))
    if isinstance(e, Alias):
        return ("alias", canonical_key(e.child, id_to_pos))
    if isinstance(e, Literal):
        return ("lit", e.value if not isinstance(e.value, (list, dict))
                else str(e.value), str(e.dtype))
    if isinstance(e, SortOrder):
        return ("sort", canonical_key(e.child, id_to_pos), e.ascending,
                e.nulls_first)
    data = []
    for k, v in sorted(e.__dict__.items()):
        if k in e.child_fields or k.startswith("_") \
                or isinstance(v, Expression):
            continue
        if isinstance(v, (list, tuple)) and any(isinstance(x, Expression)
                                                for x in v):
            continue
        if isinstance(v, DataType):
            v = str(v)
        try:
            hash(v)
        except TypeError:
            v = str(v)
        data.append((k, v))
    return (type(e).__name__, tuple(data),
            tuple(canonical_key(c, id_to_pos) for c in e.children
                  if isinstance(c, Expression)))


def bind_inputs(input_attrs: Sequence[AttributeReference]) -> dict[int, int]:
    return {a.expr_id: i for i, a in enumerate(input_attrs)}


# ---------------------------------------------------------------------------
# The two passes of a fused pipeline
# ---------------------------------------------------------------------------

def pipeline_host_pass(input_attrs: Sequence[AttributeReference],
                       filters: Sequence[Expression],
                       outputs: Sequence[Expression],
                       batch: ColumnarBatch):
    """Per-batch host shadow pass of a fused pipeline: each output's
    metadata (dtype, validity presence, dictionary) and the lookup tables
    the expressions read, without touching row data. Returns (hctx,
    host_outs, aux numpy arrays)."""
    cap = batch.capacity
    inputs = {}
    for a, c in zip(input_attrs, batch.columns):
        inputs[a.expr_id] = Val(
            a.dtype, torch.empty(cap, dtype=c.data.dtype, device="meta"),
            None if c.validity is None
            else torch.empty(cap, dtype=torch.bool, device="meta"),
            c.dictionary)
    hctx = HostCtx(inputs, cap)
    host_outs, _ = _eval_pipeline(
        hctx, filters, outputs,
        torch.empty(cap, dtype=torch.bool, device="meta"), cap)
    return hctx, host_outs, list(hctx.aux_arrays)


def pipeline_signature(batch: ColumnarBatch) -> tuple:
    """Input dtype/validity signature: part of every fused program's key."""
    return tuple((str(c.data.dtype), c.validity is not None)
                 for c in batch.columns)


def pipeline_columns(fields, host_outs, out_datas, out_valids) -> list:
    """Rebuild output Columns from a fused program's results, attaching
    each dict-encoded column's host dictionary."""
    cols = []
    for f, hv, d, v in zip(fields, host_outs, out_datas, out_valids):
        sdict = hv.sdict if dict_encoded(f.dataType) else None
        cols.append(Column(f.dataType, d, v, sdict))
    return cols


def trace_pipeline(input_attrs: Sequence[AttributeReference],
                   filters: Sequence[Expression],
                   outputs: Sequence[Expression],
                   datas, valids, row_mask, aux, cap: int, dicts):
    """The filter+project pipeline body inside a fused program: the
    shared consume-side prelude each fused stage runs before its terminal
    operator's consume code (the produce/consume splice of the reference's
    WholeStageCodegen). Every lut comes from `aux`, in the order the host
    pass harvested them; the input dictionaries (`dicts`, the host pass's)
    only steer the expressions down the branches the host pass took.
    Returns (out_datas, out_valids, out_mask) at capacity."""
    inputs = {a.expr_id: Val(a.dtype, d, v, sd)
              for a, d, v, sd in zip(input_attrs, datas, valids, dicts)}
    vals, mask = _eval_pipeline(TraceCtx(inputs, cap, row_mask.device, aux),
                                filters, outputs, row_mask, cap)
    return ([broadcast_to_cap(v.data, cap) for v in vals],
            [broadcast_to_cap(v.validity, cap) for v in vals], mask)


def _eval_pipeline(ctx: EvalCtx, filters, outputs, row_mask, cap: int):
    """(output Vals, row mask after the conjunctive filters) of one pass:
    the loop the eager pipeline and the fused programs share."""
    mask = row_mask
    for f in filters:
        fv = ctx.eval(f)
        pd = fv.data if fv.validity is None else fv.data & fv.validity
        mask = mask & broadcast_to_cap(pd, cap)
    return [ctx.eval(o) for o in outputs], mask


def struct_key(input_attrs, filters, outputs) -> tuple:
    """A fused pipeline's structural key over its input positions."""
    id_to_pos = bind_inputs(input_attrs)
    return (tuple(canonical_key(f, id_to_pos) for f in filters),
            tuple(canonical_key(o, id_to_pos) for o in outputs))


def stage_inputs(batch: ColumnarBatch, aux: list, extra: list) -> list:
    """A fused program's flat inputs: the batch's datas, its validities,
    its row mask, the host pass's luts, then the stage's own operands."""
    return ([c.data for c in batch.columns]
            + [c.validity for c in batch.columns]
            + [batch.row_mask] + list(aux) + list(extra))


class FusedPipe:
    """The pipeline half of a fused body: unpacks the flat inputs and runs
    `trace_pipeline` over them. Built per batch from its host pass."""

    def __init__(self, input_attrs, filters, outputs, batch, aux):
        self.input_attrs = input_attrs
        self.filters = filters
        self.outputs = outputs
        self.cap = batch.capacity
        self.n = len(batch.columns)
        self.n_aux = len(aux)
        self.dicts = [c.dictionary for c in batch.columns]

    def run(self, ins: list):
        """(out_datas, out_valids, mask, the stage's own operands)."""
        n, a = self.n, self.n_aux
        datas, valids, row_mask = ins[:n], ins[n:2 * n], ins[2 * n]
        aux = ins[2 * n + 1: 2 * n + 1 + a]
        od, ov, mask = trace_pipeline(self.input_attrs, self.filters,
                                      self.outputs, datas, valids, row_mask,
                                      aux, self.cap, self.dicts)
        return od, ov, mask, ins[2 * n + 1 + a:]


def key_eqs(out_datas, idx, attrs, luts: dict):
    """Equality-domain keys of pipeline outputs `idx`: a string's codes
    through its padded hash lut (`luts[i]`), a boolean as int32."""
    eqs = []
    for i in idx:
        kd = out_datas[i]
        if i in luts:
            kd = _take_codes(luts[i], kd)
        elif isinstance(attrs[i].dtype, BooleanType):
            kd = kd.to(torch.int32)
        eqs.append(kd)
    return eqs


def string_key_luts(idx, attrs, host_outs) -> tuple[list, list]:
    """(positions, padded hash luts) of the string keys among `idx`."""
    pos = [i for i in idx if isinstance(attrs[i].dtype, StringType)]
    return pos, [(host_outs[i].sdict or EMPTY_DICT).device_hash_lut()
                 for i in pos]


# ---------------------------------------------------------------------------
# The stage cache
# ---------------------------------------------------------------------------

def program_key(key: tuple, inputs: Sequence, device: torch.device) -> tuple:
    """A fused program's full key: the device type, the stage's own key
    and each input's shape and dtype (`inputs` as tensors)."""
    return (device.type, key,
            tuple(None if x is None else (tuple(x.shape), str(x.dtype))
                  for x in inputs))


class StageCache:
    """Fused programs keyed by structure (`program_key`). On a CUDA device
    each entry is a captured graph (utils/cuda_graph.py), replayed once
    per batch; on the CPU the body runs eagerly and the cache keeps only
    the keys it has seen, so `captures` counts the programs built there, as
    the reference's misses do. Bounded LRU in count (`max_size`, the
    reference KernelCache's bound) and in the card memory its graphs hold
    (`max_bytes`; by default a quarter of the card's memory, 20 GB on an
    80 GB card: a fused probe over a 2^25-row SF10 tile holds about 2 GB
    of outputs and intermediates, and SF10 q19's fused probes held 10.85
    GB on an H100).

    The graphs of a device share one memory pool, which gives no block back
    to the card while it lives: the memory held is the pool's growth over
    its captures plus the entries' static input buffers. After a capture
    that takes it past `max_bytes`, every other graph and the pool are
    dropped and the new program is captured again alone, into a fresh pool;
    the dropped programs are captured again when next needed. So the bound
    holds after every capture, but for a single program larger than it,
    which is then kept alone until `release_oversize` drops it: a
    whole-query program over SF10 tables can hold a third of the card, so
    the whole tier drops it after its run (counted as `oversize`), and its
    next run captures it anew."""

    def __init__(self, max_size: int = 1024, max_bytes: int | None = None):
        self.max_size = max_size
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self._pools: dict = {}   # device index -> [pool, keeper, grown bytes]
        self.captures = 0
        self.hits = 0
        self.replays = 0
        self.resets = 0
        self.oversize = 0
        self.capture_ms = 0.0
        self.graph_bytes = 0

    def counters(self) -> dict:
        with self._lock:
            return {
                "stage_cache.entries": len(self._entries),
                "stage_cache.captures": self.captures,
                "stage_cache.hits": self.hits,
                "stage_cache.replays": self.replays,
                "stage_cache.resets": self.resets,
                "stage_cache.oversize": self.oversize,
                "stage_cache.capture_ms": self.capture_ms,
                "stage_cache.graph_bytes": self.graph_bytes,
                "stage_cache.held_bytes": self._held(),
            }

    def clear(self) -> None:
        """Drop every captured graph and its memory pool."""
        with self._lock:
            self._entries.clear()
            self._pools.clear()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def run(self, name: str, key: tuple, fn: Callable[[list], list],
            inputs: Sequence, device: torch.device) -> list:
        """One fused program over `inputs` (tensors on `device`, numpy
        lookup tables, or None): `fn(inputs)` eagerly on the CPU; on the
        card the cached graph of (key, input signature), captured on a
        miss, replayed. Returns the outputs, fresh tensors."""
        from ..utils import cuda_graph as CG

        inputs = CG.as_tensors(inputs)
        full_key = program_key(key, inputs, device)
        with self._lock:
            prog = self._entries.get(full_key, False)
            if full_key in self._entries:
                self.hits += 1
                self._entries.move_to_end(full_key)
            elif device.type == "cpu":
                self.captures += 1
                self._entries[full_key] = None
                self._trim()
        if device.type == "cpu":
            return list(fn(inputs))
        if prog is False:
            prog = self._capture(name, full_key, fn, inputs, device)
        with self._lock:
            self.replays += 1
        return prog.replay(inputs)

    def release_oversize(self, device: torch.device) -> bool:
        """Drop every graph and the pool where they hold more than the
        bound (a single program larger than it, kept alone); True where
        that happened."""
        if device.type != "cuda":
            return False
        with self._lock:
            over = self._held() > self._limit(device)
            if over:
                self.oversize += 1
        if over:
            self.clear()
        return over

    def _limit(self, device: torch.device) -> int:
        return self.max_bytes if self.max_bytes is not None else \
            torch.cuda.get_device_properties(device).total_memory // 4

    def _capture(self, name, full_key, fn, inputs, device):
        from ..utils import cuda_graph as CG

        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        dev = torch.device("cuda", idx)
        while True:
            pool = self._pools.get(idx)
            if pool is None:
                pool = self._pools[idx] = [*CG.new_pool(dev), 0]
            try:
                prog = CG.capture(name, fn, inputs, dev, pool[0])
            except CG.CaptureError:
                # the failed capture left its pool unusable
                self._pools.pop(idx, None)
                raise
            limit = self._limit(dev)
            with self._lock:
                pool[2] += prog.pool_bytes
                self.captures += 1
                self.capture_ms += prog.capture_ms
                self.graph_bytes += prog.graph_bytes
                self._entries[full_key] = prog
                self._trim()
                over = self._held() > limit \
                    and len(self._entries) > 1
            if not over:
                return prog
            del prog
            self.clear()
            with self._lock:
                self.resets += 1

    def _trim(self) -> None:
        while len(self._entries) > self.max_size:
            self._entries.popitem(last=False)

    def _held(self) -> int:
        """Card memory the graphs hold: their pools' growth and the live
        entries' static inputs (caller holds the lock)."""
        return sum(p[2] for p in self._pools.values()) + sum(
            e.static_bytes for e in self._entries.values() if e is not None)


STAGE_CACHE = StageCache()


# ---------------------------------------------------------------------------
# ExprPipeline: the operator tier's filter/project
# ---------------------------------------------------------------------------

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
        # each output's input column where it passes one through (bare or
        # aliased): it carries the same values row for row, and a filter
        # only masks rows, so it keeps that column's RunInfo (the
        # reference's `_propagate_runs`); None for a computed output
        pos = {a.expr_id: i for i, a in enumerate(self.input_attrs)}
        targets = [o.child if isinstance(o, Alias) else o for o in outputs]
        self._passed = [pos.get(t.expr_id)
                        if isinstance(t, AttributeReference) else None
                        for t in targets]

    def run(self, batch: ColumnarBatch,
            counters: LaunchCounters | None = None) -> ColumnarBatch:
        cap = batch.capacity
        inputs = {a.expr_id: Val(a.dtype, c.data, c.validity, c.dictionary)
                  for a, c in zip(self.input_attrs, batch.columns)}
        vals, mask = _eval_pipeline(EvalCtx(inputs, cap, batch.device),
                                    self.filters, self.outputs,
                                    batch.row_mask, cap)
        cols = [Column(f.dataType, broadcast_to_cap(ov.data, cap),
                       broadcast_to_cap(ov.validity, cap), ov.sdict,
                       None if i is None else batch.columns[i].runs)
                for f, ov, i in zip(self.out_schema.fields, vals,
                                    self._passed)]
        if counters is not None:
            counters.add("pipeline")
        return ColumnarBatch(self.out_schema, cols, mask, num_rows=None)
