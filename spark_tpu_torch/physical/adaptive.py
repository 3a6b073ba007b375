"""Adaptive execution (the port's copy of `spark_tpu/physical/adaptive.py`,
the part on the reference's default path): runtime partition coalescing,
skew splitting and broadcast demotion.

Exchanges run eagerly and their reducer tiles know their rows on the host,
so a blocking consumer (final aggregate, sort, window, shuffled join)
merges undersized ADJACENT reducer outputs before it runs: hash
clustering and range order survive, since only neighbours merge. A
shuffled join coordinates one merge plan across both inputs, then splits
probe partitions over 4x the median rows (the build partition is read by
each piece). Between stages, `replan_stages` demotes a shuffled join
whose materialised build side is under the broadcast threshold to a
broadcast join and, where no operator above relies on the join's
partitioning, skips the probe side's shuffle that has not run yet. The
counters are the reference's: `aqe.partitions_coalesced`,
`aqe.skew_splits`, `aqe.broadcast_demotions` and
`aqe.probe_shuffles_elided`.

Not ported (A6, off by default in the reference): the adaptive runtime
filter (`install_runtime_filters`) and stage-boundary re-admission
(`maybe_readmit`); their keys raise when set to true (config.py).
"""

from __future__ import annotations

from typing import Sequence

from ..config import (
    ADAPTIVE_ENABLED, ADVISORY_PARTITION_BYTES, COALESCE_PARTITIONS_ENABLED,
    SKEW_JOIN_ENABLED,
)
from ..exec.context import ExecContext


def _partition_rows(part) -> int:
    return sum(b.num_rows() for b in part)


def _row_width(schema_attrs) -> int:
    w = 0
    for a in schema_attrs:
        w += max(int(a.dtype.device_dtype.itemsize), 4)
    return max(w, 8)


def plan_merge_groups(sizes: Sequence[int],
                      advisory_rows: int) -> list[list[int]]:
    """Group consecutive partition indices so each group reaches the
    advisory size (the last group may be small)."""
    groups: list[list[int]] = []
    cur: list[int] = []
    acc = 0
    for i, s in enumerate(sizes):
        cur.append(i)
        acc += s
        if acc >= advisory_rows:
            groups.append(cur)
            cur = []
            acc = 0
    if cur:
        groups.append(cur)
    return groups


def apply_merge_groups(parts: list, groups: list[list[int]]) -> list:
    return [[b for i in g for b in parts[i]] for g in groups]


def aqe_replanning_enabled(ctx: ExecContext) -> bool:
    return bool(ctx.conf.get(ADAPTIVE_ENABLED))


def _elide_safe(root, join) -> bool:
    """The probe shuffle may be skipped only if no operator between the
    stage root and the join relies on the join's output partitioning: an
    ancestor whose required distribution the planner satisfied without
    an exchange would merge wrong after the elision."""
    from .partitioning import UnspecifiedDistribution

    def walk(node) -> bool | None:
        # True if the join is below and the path is safe, None if the join
        # is not in this subtree
        if node is join:
            return True
        for i, c in enumerate(node.children):
            sub = walk(c)
            if sub is None:
                continue
            if not sub:
                return False
            reqs = node.required_child_distribution()
            req = reqs[i] if i < len(reqs) else None
            if req is not None and \
                    not isinstance(req, UnspecifiedDistribution):
                return False
            return True
        return None

    return walk(root) is True


def _pre_shuffle(exchange):
    """What a skipped shuffle exchange fed its consumer: its child, with
    the filter/project pipeline the stage tier fused into its map side
    (ExchangeFusion) put back as a ComputeExec."""
    if exchange.pipe_fusion is None:
        return exchange.child
    from .operators import ComputeExec

    filters, outputs = exchange.pipe_fusion
    return ComputeExec(filters, outputs, exchange.child)


def replan_stages(stages, done: set, ctx: ExecContext) -> None:
    """Re-optimize not-yet-run stages with observed parent-stage sizes: a
    shuffled hash join whose materialized build side is under the
    broadcast threshold demotes to a broadcast join; if the probe-side
    shuffle has not run and nothing above needs it, its pre-shuffle
    subtree inlines into the join."""
    from ..config import AUTO_BROADCAST_THRESHOLD
    from ..exec.scheduler import _StageOutput
    from .exchange import BroadcastExchangeExec, ShuffleExchangeExec
    from .operators import HashJoinExec
    from .planner import Planner

    threshold = int(ctx.conf.get(AUTO_BROADCAST_THRESHOLD))
    if threshold < 0:
        return
    broadcastable = Planner._BROADCAST_RIGHT_TYPES

    for st in stages:
        if st.stage_id in done:
            continue

        def rw(node, _root=st.root):
            if not (isinstance(node, HashJoinExec)
                    and not node.is_broadcast):
                return node
            if node.join_type not in broadcastable:
                return node
            r = node.right
            if not (isinstance(r, _StageOutput)
                    and r.stage.stage_id in done
                    and r.stage.result is not None):
                return node
            rows = sum(b.num_rows() for p in r.stage.result for b in p)
            if rows * _row_width(r.output) > threshold:
                return node
            new_right = BroadcastExchangeExec(r)
            new_left = node.left
            if isinstance(new_left, _StageOutput) \
                    and new_left.stage.stage_id not in done \
                    and isinstance(new_left.stage.root,
                                   ShuffleExchangeExec) \
                    and _elide_safe(_root, node):
                # probe-side shuffle not run and no longer required
                new_left = _pre_shuffle(new_left.stage.root)
                ctx.metrics.add("aqe.probe_shuffles_elided")
            ctx.metrics.add("aqe.broadcast_demotions")
            return node.copy(left=new_left, right=new_right,
                             is_broadcast=True)

        new_root = st.root.transform_up(rw)
        if new_root is not st.root:
            st.root = new_root


def _effective_child(plan_child):
    """See through scheduler stage boundaries to the exchange that
    produced the partitions."""
    from ..exec.scheduler import _StageOutput

    if isinstance(plan_child, _StageOutput):
        return plan_child.stage.root
    return plan_child


def _is_shuffle_output(plan_child) -> bool:
    from .exchange import ShuffleExchangeExec

    return isinstance(plan_child, ShuffleExchangeExec)


def coalesce_after_exchange(plan_child, parts: list, ctx: ExecContext,
                            output_attrs) -> list:
    """Coalesce a single exchange's output for a blocking consumer."""
    plan_child = _effective_child(plan_child)
    if not _is_shuffle_output(plan_child):
        return parts
    if not (ctx.conf.get(ADAPTIVE_ENABLED)
            and ctx.conf.get(COALESCE_PARTITIONS_ENABLED)):
        return parts
    if len(parts) <= 1:
        return parts
    advisory = int(ctx.conf.get(ADVISORY_PARTITION_BYTES)) // \
        _row_width(output_attrs)
    sizes = [_partition_rows(p) for p in parts]
    if sum(sizes) == 0:
        return [[b for p in parts for b in p]]
    groups = plan_merge_groups(sizes, advisory)
    if len(groups) == len(parts):
        return parts
    ctx.metrics.add("aqe.partitions_coalesced", len(parts) - len(groups))
    return apply_merge_groups(parts, groups)


def coalesce_join_inputs(left_child, right_child, left_parts: list,
                         right_parts: list, ctx: ExecContext,
                         left_attrs, right_attrs):
    """Coordinated coalescing for co-partitioned join inputs."""
    left_child = _effective_child(left_child)
    right_child = _effective_child(right_child)
    if not (_is_shuffle_output(left_child)
            and _is_shuffle_output(right_child)):
        return left_parts, right_parts
    if not (ctx.conf.get(ADAPTIVE_ENABLED)
            and ctx.conf.get(COALESCE_PARTITIONS_ENABLED)):
        return left_parts, right_parts
    if len(left_parts) != len(right_parts) or len(left_parts) <= 1:
        return left_parts, right_parts
    advisory = int(ctx.conf.get(ADVISORY_PARTITION_BYTES)) // max(
        _row_width(left_attrs), _row_width(right_attrs))
    sizes = [max(_partition_rows(lp), _partition_rows(rp))
             for lp, rp in zip(left_parts, right_parts)]
    groups = plan_merge_groups(sizes, advisory)
    if len(groups) == len(left_parts):
        return left_parts, right_parts
    ctx.metrics.add("aqe.partitions_coalesced",
                    len(left_parts) - len(groups))
    return (apply_merge_groups(left_parts, groups),
            apply_merge_groups(right_parts, groups))


def split_skewed_join_inputs(left_parts: list, right_parts: list,
                             ctx: ExecContext, join_type: str,
                             skew_factor: float = 4.0):
    """Split skewed PROBE-side partitions, repeating the build side: for
    inner and left joins every probe row still meets its whole build
    partition."""
    if not ctx.conf.get(SKEW_JOIN_ENABLED):
        return left_parts, right_parts
    if join_type not in ("inner", "left_outer", "left_semi", "left_anti"):
        return left_parts, right_parts
    sizes = [_partition_rows(p) for p in left_parts]
    nonzero = sorted(s for s in sizes if s) or [0]
    median = nonzero[len(nonzero) // 2]
    if median == 0:
        return left_parts, right_parts
    threshold = max(median * skew_factor, 1)
    out_l, out_r = [], []
    split_any = False
    for lp, rp, s in zip(left_parts, right_parts, sizes):
        if s > threshold and len(lp) > 1:
            k = min(len(lp), max(2, int(s // threshold) + 1))
            per = -(-len(lp) // k)
            for start in range(0, len(lp), per):
                out_l.append(lp[start:start + per])
                out_r.append(rp)
                split_any = True
        else:
            out_l.append(lp)
            out_r.append(rp)
    if split_any:
        ctx.metrics.add("aqe.skew_splits", len(out_l) - len(left_parts))
    return out_l, out_r
