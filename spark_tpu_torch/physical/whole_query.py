"""Whole-QUERY compilation: a plan whose leaves are resident runs as ONE
program per query step (counterpart of `spark_tpu/physical/whole_query.py`).

Stage fusion (physical/fusion.py) runs each exchange-free chain as one
program per batch; the exchanges between stages still materialise their
partitions on the host's schedule. When plan-time statistics show the
whole query's working set is resident, the same tracing machinery that
builds the per-stage bodies can compose EVERY stage into one program per
(plan structure, input signatures, capacities), held by
physical/compile.STAGE_CACHE: on the card a CUDA graph captured once and
replayed, on the CPU an eager run.

  * exchanges lower to in-program GATHERS: on one device a hash, range or
    round-robin redistribution moves no data, it only re-partitions rows
    the next operator re-groups or re-sorts anyway, so the lowering
    concatenates the flow and lets the consumer do the grouping;
  * aggregates always take the sorted-segment layout (static shapes: the
    output tile has the input capacity), so a whole program calls neither
    hand-written kernel; the value-dependent dense paths stay per-stage
    optimisations;
  * joins run the sorted probe in the program (a semi or anti join over a
    build deduplicated by key, as the port's operator does); output
    capacity overflow comes back as a per-join `needed` scalar, an output
    of the program read on the host after the replay: a bumped bucket is
    a new key, a new capture and a new replay;
  * intermediate stage outputs never materialise as ColumnarBatches.

The tier choice (`spark.tpu.compile.tier` = auto | whole | stage |
operator) is the reference's cost model: `auto` picks `whole` for a plan
that has an exchange to eliminate, whose operators all lower, whose leaf
rows are known (in-memory tables, ranges, Parquet footers) and whose
volume reaches spark.tpu.compile.whole.minRows scaled by program depth.
Any failed check falls back to `stage` with the reason on the plan. A
program that runs out of card memory at run time (also inside its
capture) degrades to the stage tier and re-executes the plan there.

Not ported: the mesh tier (physical/mesh_whole.py), the warm-start seeds
of join capacities and build-key spans (exec/persist_cache.py: without a
seed the dense-probe variant and its guard retry are never reached, so
they are left out) and the memory-budget pre-flight.
"""

from __future__ import annotations

import gc
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..columnar.batch import (
    EMPTY_DICT, Column, ColumnarBatch, StringDict, _take_codes,
    bucket_capacity, merge_string_dicts,
)
from ..errors import ExecutionError, NotPortedError
from ..expr.expressions import Alias, AttributeReference
from ..types import BooleanType, StringType, dict_encoded
from ..utils.faults import is_runtime_fault
from .compile import (
    STAGE_CACHE, bind_inputs, canonical_key, pipeline_host_pass,
    trace_pipeline,
)
from .operators import PhysicalPlan, attrs_schema

__all__ = ["WholeQueryExec", "TierDecision", "choose_tier",
           "apply_compile_tier", "supported_whole_query", "plan_nodes",
           "is_runtime_fault"]

# the reference's retry budget; a chain of n joins may need n retries
# (each attempt settles at least the first join that overflowed, whose
# truncated output hid what the joins above it need), so a plan with more
# joins gets one attempt per join and one more
_MAX_PROGRAM_RETRIES = 8


class _ProgramMemo:
    """The join output capacities a program's last run settled on, by the
    device type and the key of its first attempt (its structure and leaf
    signatures at the default capacities), bounded LRU. The next run of
    the same query starts from them: on the card a retry ladder is a
    capture per rung. A port-only divergence: the reference starts every
    process from the default capacities unless its warm-start manifest
    (exec/persist_cache.py, not ported) seeds them."""

    def __init__(self, max_size: int = 1024):
        self.max_size = max_size
        self._entries: "OrderedDict[tuple, list]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: tuple) -> Optional[list]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
            return None if hit is None else list(hit)

    def put(self, key: tuple, caps: list) -> None:
        with self._lock:
            self._entries[key] = list(caps)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_size:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


SETTLED = _ProgramMemo()


# ---------------------------------------------------------------------------
# tier decision
# ---------------------------------------------------------------------------

@dataclass
class TierDecision:
    """Outcome of the compile-tier cost model, stashed on the plan so
    `explain` can show it."""

    tier: str                 # "whole" | "stage" | "operator"
    reason: str               # human-readable why (incl. fallback cause)
    details: dict = field(default_factory=dict)


def _scan_table(node):
    """The backing Arrow table of an in-memory ScanExec, or None for an
    external source: in-memory scans have exact plan-time statistics."""
    import pyarrow as pa

    t = getattr(getattr(node, "source", None), "table", None)
    return t if isinstance(t, pa.Table) else None


def _external_scan_rows(node) -> Optional[int]:
    """Plan-time row count of an external scan from file-format
    statistics (io/sources.ParquetSource.plan_time_rows: footer row-group
    counts, no data read). None where a format has none."""
    fn = getattr(getattr(node, "source", None), "plan_time_rows", None)
    if fn is None:
        return None
    try:
        r = fn()
    except Exception:
        return None
    return None if r is None else int(r)


def _leaf_rows(node) -> Optional[int]:
    from . import operators as O

    if isinstance(node, O.LocalTableScanExec):
        return int(node.table.num_rows)
    if isinstance(node, O.ScanExec):
        t = _scan_table(node)
        if t is None:
            return _external_scan_rows(node)
        return int(t.num_rows)
    if isinstance(node, O.RangeExec):
        step = node.step
        if step > 0:
            return max(0, -(-(node.end - node.start) // step))
        return max(0, -(-(node.start - node.end) // -step))
    return None


def plan_nodes(plan):
    """Every node of the plan, through a WholeQueryExec into its inner
    plan (which is no child of it: the program is one operator)."""
    inner = plan.plan if isinstance(plan, WholeQueryExec) else plan
    return inner.iter_nodes()


def supported_whole_query(plan, conf) -> tuple[bool, str]:
    """Structural admission: every operator of the plan must have a
    whole-query lowering. Returns (ok, reason-if-not)."""
    from ..config import ADAPTIVE_PARQUET_STATS
    from . import operators as O
    from .exchange import BroadcastExchangeExec, ShuffleExchangeExec
    from .fusion import FUSABLE_OPS

    for node in plan_nodes(plan):
        if isinstance(node, (O.LocalTableScanExec, O.RangeExec)):
            continue
        if isinstance(node, O.ScanExec):
            if _scan_table(node) is None:
                stats_ok = (bool(conf.get(ADAPTIVE_PARQUET_STATS))
                            and _external_scan_rows(node) is not None)
                if not stats_ok:
                    return False, (f"scan [{node.name}] reads an external "
                                   "source (no plan-time statistics)")
            continue
        if isinstance(node, (O.ComputeExec, O.LimitExec, O.SortExec,
                             O.UnionExec, BroadcastExchangeExec,
                             ShuffleExchangeExec)):
            continue
        if isinstance(node, O.HashAggregateExec):
            bad = [op for op, _, _ in node._plan_values()
                   if op not in FUSABLE_OPS]
            if bad:
                return False, (f"aggregate op {bad[0]} needs host-side "
                               "finishing (no in-program lowering)")
            for g in node.grouping:
                if dict_encoded(g.dtype) and not isinstance(g.dtype,
                                                            StringType):
                    return False, (f"grouping key {g.name} is a nested "
                                   "dictionary type (codes are not a "
                                   "canonical group domain)")
            continue
        if isinstance(node, O.HashJoinExec):
            if node.join_type == "full_outer":
                return False, ("full_outer join runs eager host-side "
                               "passes (no in-program lowering)")
            for k in list(node.left_keys) + list(node.right_keys):
                if dict_encoded(k.dtype) and not isinstance(k.dtype,
                                                            StringType):
                    return False, (f"join key {k.name} is a nested "
                                   "dictionary type")
            continue
        return False, (f"operator {type(node).__name__} has no "
                       "whole-query lowering")
    return True, ""


def _estimate_resident_bytes(plan, conf) -> Optional[int]:
    """Cheap upper bound of the whole program's engine bytes: every
    lowered operator's output tile (capacity x row bytes) plus the leaf
    input planes, all live inside ONE program. Host arithmetic over plan
    metadata (the chooser launches nothing)."""
    from ..exec.memory import schema_row_bytes
    from . import operators as O
    from .exchange import BroadcastExchangeExec, ShuffleExchangeExec
    from .fusion import FusedAggregateExec

    tile = int(conf.batch_capacity)
    memo: dict[int, Optional[int]] = {}

    def cap_of(node) -> Optional[int]:
        if id(node) not in memo:
            memo[id(node)] = _cap_of(node)
        return memo[id(node)]

    def _cap_of(node) -> Optional[int]:
        rows = _leaf_rows(node)
        if rows is not None:
            # tiling mirror: per-tile buckets, then the gathered concat
            total = 0
            n = rows
            while n > 0:
                total += bucket_capacity(min(tile, n))
                n -= tile
            return bucket_capacity(max(total, 1))
        kids = [cap_of(c) for c in node.children]
        if any(k is None for k in kids):
            return None
        if isinstance(node, O.HashAggregateExec) and not node.grouping:
            return 8
        if isinstance(node, O.HashJoinExec):
            return max(kids[0], 1 << 10)
        if isinstance(node, O.UnionExec):
            return bucket_capacity(sum(kids))
        if isinstance(node, (ShuffleExchangeExec, BroadcastExchangeExec)):
            return kids[0]
        return kids[0] if kids else None

    total = 0
    for node in plan_nodes(plan):
        cap = cap_of(node)
        if cap is None:
            return None
        try:
            rb = schema_row_bytes(attrs_schema(node.output))
        except Exception:
            rb = 16
        total += cap * rb
        if isinstance(node, FusedAggregateExec):
            # the traced pipeline's projected planes are live too
            total += cap * 16
    return total


def _avg_compile_ms() -> float:
    """Per-program capture cost from the stage cache (its capture time
    over its captures), 50 ms at least and before any capture."""
    avg = STAGE_CACHE.capture_ms / max(STAGE_CACHE.captures, 1)
    return max(avg, 50.0)


def choose_tier(plan, conf) -> TierDecision:
    """The three-tier cost model of the reference (module docstring),
    without its mesh and cluster branches. With fusion off the port plans
    `operator` where the reference says `stage`: both run operator at a
    time, the port says so."""
    from ..config import (
        COMPILE_TIER, FUSION_ENABLED, MEMORY_BUDGET, WHOLE_MIN_ROWS,
    )

    pref = str(conf.get(COMPILE_TIER)).lower()
    if pref == "mesh-whole":
        raise NotPortedError("spark.tpu.compile.tier=mesh-whole: the mesh "
                             "whole-query tier (physical/mesh_whole.py)")
    if pref not in ("auto", "whole", "stage", "operator"):
        raise ValueError(f"spark.tpu.compile.tier: unknown tier {pref!r}")
    if pref == "operator":
        return TierDecision("operator", "forced by spark.tpu.compile.tier")
    if not conf.get(FUSION_ENABLED):
        return TierDecision(
            "operator", "whole-query fallback: spark.tpu.fusion.enabled="
            "false (operator-at-a-time differential oracle)")
    if pref == "stage":
        return TierDecision("stage", "forced by spark.tpu.compile.tier")
    forced = pref == "whole"
    base = "forced by spark.tpu.compile.tier" if forced \
        else "cost model (spark.tpu.compile.tier=auto)"
    if not forced:
        # cheap disqualifier first: a plan with no exchange is already
        # one program per batch under stage fusion
        from .exchange import BroadcastExchangeExec, ShuffleExchangeExec

        n_exch = sum(1 for x in plan_nodes(plan)
                     if isinstance(x, (ShuffleExchangeExec,
                                       BroadcastExchangeExec)))
        if n_exch == 0:
            return TierDecision(
                "stage", "whole-query fallback: no exchange round-trips "
                "to eliminate (single-stage plan — stage fusion already "
                "dispatches once per batch)", {"exchanges": 0})
    ok, why = supported_whole_query(plan, conf)
    if not ok:
        return TierDecision("stage", f"whole-query fallback: {why}")
    rows = []
    n_ops = 0
    for node in plan_nodes(plan):
        n_ops += 1
        r = _leaf_rows(node)
        if r is not None:
            rows.append(r)
        elif not node.children:
            return TierDecision(
                "stage", "whole-query fallback: leaf statistics "
                f"unknown ({type(node).__name__} row count untraced)")
    volume = sum(rows)
    details = {"volume_rows": volume, "lowered_ops": n_ops,
               "est_compile_ms": round(_avg_compile_ms() * n_ops, 1)}
    est = _estimate_resident_bytes(plan, conf)
    if est is not None:
        details["est_resident_bytes"] = est
    budget = int(conf.get(MEMORY_BUDGET))
    if budget > 0 and est is not None and est > budget:
        # the reference tries its mesh tier here first (not ported)
        return TierDecision(
            "stage", "whole-query fallback: predicted fully-resident "
            f"working set ~{est / (1 << 20):.1f} MiB exceeds "
            f"spark.tpu.memory.budget ({budget / (1 << 20):.1f} MiB)",
            details)
    if not forced:
        floor = int(conf.get(WHOLE_MIN_ROWS))
        floor *= max(1, -(-n_ops // 8))
        details["volume_floor"] = floor
        if volume < floor:
            return TierDecision(
                "stage", "whole-query fallback: batch volume "
                f"{volume} rows under the compile-amortization floor "
                f"({floor}; spark.tpu.compile.whole.minRows scaled by "
                "program depth)", details)
    return TierDecision("whole", base, details)


def apply_compile_tier(plan, conf):
    """Planner hook, run last: wrap the plan for the whole tier, or stash
    the decision (with its fallback reason) on the plan for `explain`."""
    decision = choose_tier(plan, conf)
    if decision.tier == "whole":
        plan = WholeQueryExec(plan, decision)
    plan._tier_decision = decision
    return plan


# ---------------------------------------------------------------------------
# program builder
# ---------------------------------------------------------------------------

class _MCol(NamedTuple):
    """Host-side metadata of one column of a flow: its SQL type, its data
    plane's torch dtype, whether it has a validity plane, its dictionary.
    Intermediate flows never materialise; their metadata comes from the
    producing operator's host pass."""

    dtype: object
    torch_dtype: torch.dtype
    valid: bool
    sdict: Optional[StringDict]


class _MetaColumn:
    """Column-shaped view of an _MCol for pipeline_host_pass, which reads
    the data's dtype, the validity's presence and the dictionary."""

    __slots__ = ("data", "validity", "dictionary")

    def __init__(self, m: _MCol):
        self.data = torch.empty(0, dtype=m.torch_dtype, device="meta")
        self.validity = True if m.valid else None
        self.dictionary = m.sdict


class _MetaBatch:
    __slots__ = ("columns", "capacity")

    def __init__(self, metas: Sequence[_MCol], cap: int):
        self.columns = [_MetaColumn(m) for m in metas]
        self.capacity = cap


class _Lowered(NamedTuple):
    metas: list            # list[_MCol] per output column
    cap: int               # static tile capacity of this flow
    emit: Callable         # emit(args, needed) -> (datas, valids, mask)


def _pad(a: torch.Tensor, cap: int, fill) -> torch.Tensor:
    n = a.shape[0]
    if n >= cap:
        return a
    return torch.cat([a, torch.full((cap - n,), fill, dtype=a.dtype,
                                    device=a.device)])


def _cat(chunks: list) -> torch.Tensor:
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks)


def _meta_sig(metas) -> tuple:
    return tuple((str(m.torch_dtype), m.valid) for m in metas)


class _ProgramBuilder:
    """Lowers an admitted physical plan into one program.

    Host pass (per execute): the leaves execute (device-cached ingest),
    dictionaries merge, the pipelines' luts are harvested, and every
    operator adds a structural fragment to the key. The device pass (the
    program, run by STAGE_CACHE) composes the SAME bodies the per-stage
    path uses: trace_pipeline, ops.grouping, ops.joining, ops.sorting."""

    def __init__(self, ctx, join_caps: list, leaves: dict):
        self.ctx = ctx
        self.args: list = []           # program inputs, in arg-index order
        self.key: list = []            # cache-key fragments
        self.join_caps = join_caps     # per-join output capacities (shared
        # across the retry loop: a bumped bucket re-enters here)
        self.leaves = leaves           # id(leaf) -> its batches (retries
        # reuse what the first attempt ingested)
        self._join_seq = 0

    # -- plumbing ----------------------------------------------------------
    def arg(self, arr) -> int:
        self.args.append(arr)
        return len(self.args) - 1

    # -- dispatch ----------------------------------------------------------
    def lower(self, node) -> _Lowered:
        from . import operators as O
        from .exchange import BroadcastExchangeExec, ShuffleExchangeExec
        from .fusion import FusedAggregateExec, FusedLimitExec

        if isinstance(node, (O.LocalTableScanExec, O.RangeExec,
                             O.ScanExec)):
            return self._lower_leaf(node)
        if isinstance(node, FusedAggregateExec):
            low = self.lower(node.child)
            low = self._lower_pipe(node.filters, node.pipe_outputs,
                                   node.child.output, node.pipe_attrs, low)
            return self._lower_agg(node, node.pipe_attrs, low)
        if isinstance(node, O.HashAggregateExec):
            low = self.lower(node.child)
            return self._lower_agg(node, node.child.output, low)
        if isinstance(node, FusedLimitExec):
            low = self.lower(node.child)
            low = self._lower_pipe(node.filters, node.pipe_outputs,
                                   node.child.output, node.pipe_attrs, low)
            return self._lower_limit(node, low)
        if isinstance(node, O.LimitExec):
            low = self.lower(node.child)
            return self._lower_limit(node, low)
        if isinstance(node, O.SortExec):
            low = self.lower(node.child)
            return self._lower_sort(node, low)
        if isinstance(node, O.HashJoinExec):
            return self._lower_join(node)
        if isinstance(node, O.ComputeExec):
            low = self.lower(node.child)
            attrs = [o.to_attribute() if isinstance(o, Alias) else o
                     for o in node.outputs]
            return self._lower_pipe(node.filters, node.outputs,
                                    node.child.output, attrs, low)
        if isinstance(node, ShuffleExchangeExec):
            low = self.lower(node.child)
            if node.pipe_fusion is not None:
                filters, outputs = node.pipe_fusion
                low = self._lower_pipe(filters, outputs, node.child.output,
                                       node.pipe_attrs, low)
            self.key.append(("xgather",))
            return low
        if isinstance(node, BroadcastExchangeExec):
            return self.lower(node.child)
        if isinstance(node, O.UnionExec):
            lows = [self.lower(c) for c in node.children_plans]
            return self._lower_union(node, lows)
        raise ExecutionError(            # admission guarantees this
            f"whole-query lowering missing for {type(node).__name__}")

    # -- leaves ------------------------------------------------------------
    def _lower_leaf(self, node) -> _Lowered:
        batches = self.leaves.get(id(node))
        if batches is None:
            parts = node.execute(self.ctx)
            batches = self.leaves[id(node)] = [b for p in parts for b in p]
        if not batches:
            # all-empty partitions: one empty batch keeps the concat and
            # pad lowering uniform
            batches = [ColumnarBatch.empty(attrs_schema(node.output),
                                           self.ctx.device)]
        fields = attrs_schema(node.output).fields
        caps = [b.capacity for b in batches]
        cap = bucket_capacity(max(sum(caps), 1))
        col_args = []      # per col: list[(data_idx, valid_idx|None)]
        luts = []          # per col: list[lut arg idx]|None
        metas = []
        for i, f in enumerate(fields):
            cols = [b.columns[i] for b in batches]
            merged = None
            lut_idx = None
            if dict_encoded(f.dataType):
                dicts = [c.dictionary or EMPTY_DICT for c in cols]
                if all(d is dicts[0] for d in dicts):
                    merged = dicts[0]
                else:
                    merged, lut_list = merge_string_dicts(dicts)
                    lut_idx = [self.arg(lt) for lt in lut_list]
            entry = [(self.arg(c.data), None if c.validity is None
                      else self.arg(c.validity)) for c in cols]
            col_args.append(entry)
            luts.append(lut_idx)
            metas.append(_MCol(f.dataType, cols[0].data.dtype,
                               any(c.validity is not None for c in cols),
                               merged))
        mask_idx = [self.arg(b.row_mask) for b in batches]
        self.key.append((
            "leaf", tuple(caps),
            tuple((str(c.data.dtype), c.validity is not None)
                  for b in batches for c in b.columns),
            tuple(None if li is None else len(li) for li in luts)))

        def emit(args, needed):
            datas, valids = [], []
            for ci, m in enumerate(metas):
                chunks = []
                for bi, (di, _vi) in enumerate(col_args[ci]):
                    d = args[di]
                    if luts[ci] is not None:
                        d = _take_codes(args[luts[ci][bi]], d).to(d.dtype)
                    chunks.append(d)
                datas.append(_pad(_cat(chunks), cap, 0))
                if m.valid:
                    vchunks = [
                        args[vi] if vi is not None else torch.ones(
                            caps[bi], dtype=torch.bool,
                            device=args[di].device)
                        for bi, (di, vi) in enumerate(col_args[ci])]
                    valids.append(_pad(_cat(vchunks), cap, False))
                else:
                    valids.append(None)
            mask = _pad(_cat([args[i] for i in mask_idx]), cap, False)
            return datas, valids, mask

        return _Lowered(metas, cap, emit)

    # -- filter/project pipelines ------------------------------------------
    def _lower_pipe(self, filters, outputs, input_attrs, out_attrs,
                    low: _Lowered) -> _Lowered:
        if not filters and all(isinstance(o, AttributeReference)
                               for o in outputs):
            # pure column selection: reorder the flow, no device work
            pos = {a.expr_id: i for i, a in enumerate(input_attrs)}
            sel = tuple(pos[o.expr_id] for o in outputs)
            metas = [low.metas[i] for i in sel]
            self.key.append(("reorder", sel))

            def emit(args, needed, _low=low):
                d, v, m = _low.emit(args, needed)
                return [d[i] for i in sel], [v[i] for i in sel], m

            return _Lowered(metas, low.cap, emit)
        cap = low.cap
        hctx, host_outs, aux = pipeline_host_pass(
            input_attrs, filters, outputs, _MetaBatch(low.metas, cap))
        aux_idx = [self.arg(a) for a in aux]
        id_to_pos = bind_inputs(input_attrs)
        self.key.append((
            "pipe",
            tuple(canonical_key(f, id_to_pos) for f in filters),
            tuple(canonical_key(o, id_to_pos) for o in outputs),
            _meta_sig(low.metas), hctx.signature()))
        metas = [_MCol(a.dtype, hv.data.dtype, hv.validity is not None,
                       hv.sdict if dict_encoded(a.dtype) else None)
                 for a, hv in zip(out_attrs, host_outs)]
        in_attrs, flt, outs = list(input_attrs), list(filters), list(outputs)
        dicts = [m.sdict for m in low.metas]

        def emit(args, needed, _low=low):
            d, v, m = _low.emit(args, needed)
            return trace_pipeline(in_attrs, flt, outs, d, v, m,
                                  [args[i] for i in aux_idx], cap, dicts)

        return _Lowered(metas, cap, emit)

    # -- equality and order domains ----------------------------------------
    def _eq_lut(self, mc: _MCol) -> Optional[int]:
        """The arg index of a string column's padded value-hash lut (the
        equality domain across dictionaries), else None."""
        if isinstance(mc.dtype, StringType) or dict_encoded(mc.dtype):
            return self.arg((mc.sdict or EMPTY_DICT).device_hash_lut())
        return None

    @staticmethod
    def _eqs(d, v, idx, luts, metas, args):
        eqs, valids = [], []
        for j, i in enumerate(idx):
            kd = d[i]
            if luts[j] is not None:
                kd = _take_codes(args[luts[j]], kd)
            elif isinstance(metas[i].dtype, BooleanType):
                kd = kd.to(torch.int32)
            eqs.append(kd)
            valids.append(v[i])
        return eqs, valids

    # -- aggregation -------------------------------------------------------
    def _lower_agg(self, node, in_attrs, low: _Lowered) -> _Lowered:
        from ..ops import grouping as G

        pos = {a.expr_id: i for i, a in enumerate(in_attrs)}
        out_fields = attrs_schema(node.output).fields
        vals = node._plan_values()
        ops = tuple(op for op, _, _ in vals)
        val_idx = tuple(pos[attr.expr_id] if attr is not None else -1
                        for _, attr, _ in vals)
        key_idx = tuple(pos[g.expr_id] for g in node.grouping)
        nk = len(key_idx)
        # a min/max over a dictionary-encoded column reduces in rank space
        # (as the fused aggregate does): code -> rank lut in, the winning
        # rank -> code lut out, both program arguments
        smm = {}
        for bi, (op, attr, _p) in enumerate(vals):
            if op in ("min", "max") and attr is not None \
                    and dict_encoded(attr.dtype):
                sd = low.metas[val_idx[bi]].sdict or EMPTY_DICT
                ranks, inv = sd.rank_luts()
                smm[bi] = (self.arg(ranks), self.arg(inv), len(sd))
        buf_metas = []
        for bi, (op, _attr, _p) in enumerate(vals):
            f = out_fields[nk + bi]
            sdict = None
            if dict_encoded(f.dataType) and val_idx[bi] >= 0:
                sdict = low.metas[val_idx[bi]].sdict
            buf_metas.append(_MCol(f.dataType, f.dataType.device_dtype,
                                   op not in ("count", "countstar"), sdict))
        key_luts = [self._eq_lut(low.metas[i]) for i in key_idx]
        self.key.append(("agg", node.mode, ops, key_idx, val_idx,
                         tuple(x is not None for x in key_luts),
                         tuple((bi, n) for bi, (_r, _i, n)
                               in sorted(smm.items()))))

        def pipe_vals(d, v, m, args):
            vd = []
            for bi, i in enumerate(val_idx):
                dd = d[i] if i >= 0 else m
                if bi in smm:
                    dd = _take_codes(args[smm[bi][0]], dd)
                vd.append(dd)
            return vd, [v[i] if i >= 0 else None for i in val_idx]

        def finish(bufs, args):
            out = []
            for bi, (bd, bv) in enumerate(bufs):
                if bi in smm:
                    bd = _take_codes(args[smm[bi][1]], bd)
                want = out_fields[nk + bi].dataType.device_dtype
                out.append((bd if bd.dtype == want else bd.to(want), bv))
            return out

        if not node.grouping:
            from .operators import _ungrouped_kernel

            def emit(args, needed, _low=low):
                d, v, m = _low.emit(args, needed)
                vd, vv = pipe_vals(d, v, m, args)
                datas, valids, mask = _ungrouped_kernel(ops, vd, vv, m)
                outs = finish(list(zip(datas, valids)), args)
                return [x for x, _ in outs], [y for _, y in outs], mask

            return _Lowered(buf_metas, 8, emit)

        key_metas = [_MCol(out_fields[j].dataType,
                           out_fields[j].dataType.device_dtype,
                           low.metas[i].valid, low.metas[i].sdict)
                     for j, i in enumerate(key_idx)]

        def emit(args, needed, _low=low):
            d, v, m = _low.emit(args, needed)
            eqs, kvs = self._eqs(d, v, key_idx, key_luts, _low.metas, args)
            layout = G.group_rows(eqs, kvs, m)
            out_keys = []
            for j, i in enumerate(key_idx):
                kd, kv = G.scatter_group_keys(layout, d[i], v[i])
                want = key_metas[j].torch_dtype
                out_keys.append((kd if kd.dtype == want else kd.to(want),
                                 kv))
            vd, vv = pipe_vals(d, v, m, args)
            bufs = finish(G.apply_group_ops(layout, ops, vd, vv), args)
            datas = [kd for kd, _ in out_keys] + [bd for bd, _ in bufs]
            valids = [kv for _, kv in out_keys] + [bv for _, bv in bufs]
            return datas, valids, G.group_output_mask(layout)

        return _Lowered(key_metas + buf_metas, low.cap, emit)

    # -- limit / sort ------------------------------------------------------
    def _lower_limit(self, node, low: _Lowered) -> _Lowered:
        from ..ops.sorting import limit_mask

        n, offset = node.n, node.offset
        self.key.append(("limit", n, offset))

        def emit(args, needed, _low=low):
            d, v, m = _low.emit(args, needed)
            return d, v, limit_mask(m, n, offset)

        return _Lowered(low.metas, low.cap, emit)

    def _lower_sort(self, node, low: _Lowered) -> _Lowered:
        from ..ops.sorting import SortKeySpec, sort_permutation

        pos = {a.expr_id: i for i, a in enumerate(node.child.output)}
        kidx, specs, rank_idx = [], [], []
        for o in node.orders:
            i = pos[o.child.expr_id]
            kidx.append(i)
            specs.append(SortKeySpec(o.ascending, o.nulls_first))
            mc = low.metas[i]
            if dict_encoded(mc.dtype):
                sd = mc.sdict or EMPTY_DICT
                rank_idx.append(self.arg(
                    sd.ranks if len(sd) else np.zeros(1, np.int32)))
            else:
                rank_idx.append(None)
        self.key.append(("sort", tuple(kidx),
                         tuple((s.ascending, s.nulls_first)
                               for s in specs),
                         tuple(r is not None for r in rank_idx)))

        def emit(args, needed, _low=low):
            d, v, m = _low.emit(args, needed)
            keys, kvalids = [], []
            for j, i in enumerate(kidx):
                kd = d[i]
                if rank_idx[j] is not None:
                    kd = _take_codes(args[rank_idx[j]], kd)
                elif isinstance(_low.metas[i].dtype, BooleanType):
                    kd = kd.to(torch.int32)
                keys.append(kd)
                kvalids.append(v[i])
            perm = sort_permutation(keys, kvalids, specs, m)
            return ([x[perm] for x in d],
                    [None if x is None else x[perm] for x in v], m[perm])

        return _Lowered(low.metas, low.cap, emit)

    # -- joins -------------------------------------------------------------
    def _lower_join(self, node) -> _Lowered:
        probe = self.lower(node.left)
        if node.probe_fusion is not None:
            filters, outputs = node.probe_fusion
            probe = self._lower_pipe(filters, outputs, node.left.output,
                                     node.probe_attrs, probe)
        build = self.lower(node.right)
        return self._join_tail(node, probe, build)

    def _join_tail(self, node, probe: _Lowered,
                   build: _Lowered) -> _Lowered:
        from ..ops import joining as J

        jt = node.join_type
        lpos = {a.expr_id: i for i, a in enumerate(node._left_attrs)}
        rpos = {a.expr_id: i for i, a in enumerate(node.right.output)}
        lk = tuple(lpos[k.expr_id] for k in node.left_keys)
        rk = tuple(rpos[k.expr_id] for k in node.right_keys)
        lk_luts = [self._eq_lut(probe.metas[i]) for i in lk]
        rk_luts = [self._eq_lut(build.metas[i]) for i in rk]
        join_id = self._join_seq
        self._join_seq += 1
        if join_id >= len(self.join_caps):
            self.join_caps.append(max(probe.cap, 1 << 10))
        out_cap = self.join_caps[join_id]
        self.key.append(("join", jt, lk, rk, out_cap,
                         tuple(x is not None for x in lk_luts),
                         tuple(x is not None for x in rk_luts)))
        semi_anti = jt in ("left_semi", "left_anti")
        metas = list(probe.metas)
        if not semi_anti:
            metas += [m._replace(valid=True) for m in build.metas]

        def emit(args, needed, _probe=probe, _build=build):
            pd, pv, pm = _probe.emit(args, needed)
            bd, bv, bm = _build.emit(args, needed)
            beqs, bvalids = self._eqs(bd, bv, rk, rk_luts, _build.metas,
                                      args)
            peqs, pvalids = self._eqs(pd, pv, lk, lk_luts, _probe.metas,
                                      args)
            bindex = J.build_index(beqs, bvalids, bm)
            if semi_anti:
                # one build row per key answers whether a match exists
                bindex = J.dedup_build(bindex, beqs, bvalids)
            r = J.probe_join(bindex, beqs, bvalids, peqs, pvalids, pm,
                             out_cap, jt)
            needed.append(r.needed)
            datas = [x[r.probe_idx] for x in pd]
            valids = [None if x is None else x[r.probe_idx] for x in pv]
            if semi_anti:
                return datas, valids, r.out_mask
            for x, xv in zip(bd, bv):
                datas.append(x[r.build_idx])
                valids.append(r.matched if xv is None
                              else xv[r.build_idx] & r.matched)
            return datas, valids, r.out_mask

        return _Lowered(metas, out_cap, emit)

    # -- union -------------------------------------------------------------
    def _lower_union(self, node, lows: list) -> _Lowered:
        fields = attrs_schema(node.output).fields
        total = sum(lw.cap for lw in lows)
        cap = bucket_capacity(total)
        luts, metas = [], []
        for ci, f in enumerate(fields):
            merged = None
            lut_idx = None
            if dict_encoded(f.dataType):
                dicts = [lw.metas[ci].sdict or EMPTY_DICT for lw in lows]
                if all(d is dicts[0] for d in dicts):
                    merged = dicts[0]
                else:
                    merged, lut_list = merge_string_dicts(dicts)
                    lut_idx = [self.arg(lt) for lt in lut_list]
            luts.append(lut_idx)
            metas.append(_MCol(f.dataType, lows[0].metas[ci].torch_dtype,
                               any(lw.metas[ci].valid for lw in lows),
                               merged))
        self.key.append(("union", tuple(lw.cap for lw in lows),
                         tuple(None if li is None else len(li)
                               for li in luts)))

        def emit(args, needed):
            outs = [lw.emit(args, needed) for lw in lows]
            datas, valids = [], []
            for ci, mc in enumerate(metas):
                chunks = []
                for li, (d, _v, _m) in enumerate(outs):
                    dd = d[ci]
                    if luts[ci] is not None:
                        dd = _take_codes(args[luts[ci][li]], dd) \
                            .to(dd.dtype)
                    chunks.append(dd)
                datas.append(_pad(_cat(chunks), cap, 0))
                if mc.valid:
                    valids.append(_pad(_cat([
                        v[ci] if v[ci] is not None else torch.ones(
                            lows[li].cap, dtype=torch.bool,
                            device=d[ci].device)
                        for li, (d, v, _m) in enumerate(outs)]), cap, False))
                else:
                    valids.append(None)
            mask = _pad(_cat([m for _d, _v, m in outs]), cap, False)
            return datas, valids, mask

        return _Lowered(metas, cap, emit)


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

class WholeQueryExec(PhysicalPlan):
    """The whole query as ONE program per step.

    The inner plan is no child (child_fields = ()): the program is one
    operator, with no exchange between stages. Leaf scans execute as
    usual (device-cached); everything above them runs in one program,
    held by STAGE_CACHE under ("whole_query", the builder's key) and the
    inputs' shapes: on the card a CUDA graph captured once and replayed.
    A join whose output outgrew its capacity bumps the bucket: a new key,
    a new capture and a new replay (counted as
    `whole_query.capacity_retries`; every attempt counts in
    `whole_query.dispatches`); the next run of the same query starts from
    the capacities this one settled on (SETTLED). A program larger than
    the cache's memory bound is dropped after its run. A program that runs
    out of card memory degrades to the stage tier
    (`whole_query.runtime_degraded`); its next run tries the whole tier
    again, as the reference's does."""

    child_fields = ()

    def __init__(self, plan, decision: TierDecision):
        self.plan = plan
        self.decision = decision

    @property
    def output(self):
        return self.plan.output

    def output_partitioning(self):
        from .partitioning import SinglePartition

        return SinglePartition()

    def simple_string(self):
        n = sum(1 for _ in self.plan.iter_nodes())
        return (f"WholeQuery[ops={n}, tier=whole] "
                f"({self.decision.reason[:60]})")

    def tree_string(self, depth: int = 0) -> str:
        pad = "  " * depth
        head = pad + ("+- " if depth else "") + self.simple_string()
        return head + "\n" + self.plan.tree_string(depth + 1)

    def execute(self, ctx) -> list:
        try:
            return self._execute_whole(ctx)
        except Exception as e:
            if not is_runtime_fault(e):
                raise
            reason = f"{type(e).__name__}: {str(e)[:200]}"
        # outside the handler, so the fault's frames (and the tensors
        # they hold) are gone before the memory is given back; the stage
        # tier needs the card's memory the graphs hold too
        gc.collect()
        if ctx.device.type == "cuda":
            STAGE_CACHE.clear()
        return self._degrade_to_stage(ctx, reason)

    def _degrade_to_stage(self, ctx, reason: str) -> list:
        """The program failed at run time: re-execute the inner plan (the
        stage tier's, fused) operator by operator, stage by stage."""
        self.decision.details["runtime_degraded"] = reason
        ctx.metrics.add("whole_query.runtime_degraded")
        return self.plan.execute(ctx)

    def _execute_whole(self, ctx) -> list:
        join_caps: list[int] = []
        leaves: dict = {}
        first_key = None
        budget = _MAX_PROGRAM_RETRIES
        attempt = -1
        while attempt + 1 < budget:
            attempt += 1
            b = _ProgramBuilder(ctx, join_caps, leaves)
            root = b.lower(self.plan)
            if first_key is None:
                first_key = (ctx.device.type,) + tuple(b.key)
                settled = SETTLED.get(first_key)
                if settled is not None and settled != join_caps:
                    # start from the capacities the last run settled on
                    join_caps[:] = settled
                    b = _ProgramBuilder(ctx, join_caps, leaves)
                    root = b.lower(self.plan)
                budget = max(budget, len(join_caps) + 1)
            n = len(root.metas)

            def program(args, _root=root):
                needed: list = []
                datas, valids, mask = _root.emit(args, needed)
                return list(datas) + list(valids) + [mask] + needed

            out = STAGE_CACHE.run("WholeQuery", ("whole_query", tuple(b.key)),
                                  program, b.args, ctx.device)
            ctx.launches.add("whole_query")
            # the program's ONE capacity verdict: the joins' `needed`
            # scalars cross to the host after the replay
            needed = torch.stack(out[2 * n + 1:]).tolist() \
                if len(out) > 2 * n + 1 else []
            bumped = False
            for i, nd in enumerate(needed):
                if nd > join_caps[i]:
                    join_caps[i] = bucket_capacity(nd)
                    bumped = True
            if bumped:
                continue
            if attempt:
                ctx.metrics.add("whole_query.capacity_retries", attempt)
            ctx.metrics.add("whole_query.dispatches", attempt + 1)
            SETTLED.put(first_key, join_caps)
            STAGE_CACHE.release_oversize(ctx.device)
            schema = attrs_schema(self.output)
            cols = [Column(f.dataType, d, v,
                           m.sdict if dict_encoded(f.dataType) else None)
                    for f, d, v, m in zip(schema.fields, out[:n],
                                          out[n:2 * n], root.metas)]
            return [[ColumnarBatch(schema, cols, out[2 * n],
                                   num_rows=None)]]
        raise ExecutionError(
            "whole-query program exceeded its capacity-retry budget "
            f"({budget})")
