"""Physical planner: LogicalPlan -> PhysicalPlan (counterpart of
`spark_tpu/physical/planner.py`).

Convert, insert exchanges where a child's partitioning does not satisfy its
parent's required distribution (EnsureRequirements), collapse adjacent
ComputeExecs, then, unless the tier is `operator` (fusion on, tier `auto`,
`whole` or `stage`), fuse each exchange-free chain into whole-stage
operators (physical/fusion.py fuse_stages), mark dynamic partition pruning,
and last make the compile-tier decision (physical/whole_query.py
apply_compile_tier): the plan is wrapped into one whole-query program or
left staged, and the decision rides the plan root as `_tier_decision` for
`explain`. With
`spark.tpu.fusion.enabled=false` or `spark.tpu.compile.tier=operator` the
plan is operator at a time, the differential oracle. Contracts kept from
the JAX planner:
  * exchange and grouping keys are always bound to attributes (complex keys
    get pre-projected via ComputeExec);
  * aggregates are planned partial -> (exchange) -> final with a finishing
    ComputeExec over the buffers (one pass over one partition; where an
    exchange added below then splits that input by other keys, the port
    merges the partials, which the JAX planner does not);
  * right outer joins are flipped to left joins over swapped children; a
    build side whose estimated bytes fit spark.sql.autoBroadcastJoinThreshold
    is broadcast; cross joins, joins with no equi key and semi/anti/outer
    joins with a non-equi residual are NestedLoopJoinExecs over a broadcast
    right side;
  * ORDER BY + LIMIT plans as TopK: a local sort and limit per partition, a
    gather, then a final sort and limit;
  * a data source's scan takes what it can of the plan above it: the
    filter conjuncts a SupportsPushDownFilters source accepts, split and
    row-group pruning by a Parquet source's partition values and
    statistics (the filter stays), a whole aggregate or a per-partition
    limit where the source supports them; and a hash join whose probe
    side scans a hive-partitioned source on a join key runs its build
    side first and prunes the scan's splits (dynamic partition pruning).
"""

from __future__ import annotations

from typing import Sequence

from ..config import (
    AUTO_BROADCAST_THRESHOLD, DPP_ENABLED, DSV2_AGG_PUSHDOWN,
    DSV2_FILTER_PUSHDOWN, PARQUET_FILTER_PUSHDOWN, SQLConf,
)
from ..errors import NotPortedError
from ..expr.expressions import (
    AggregateFunction, Alias, AttributeReference, Cast, EqualTo, Expression,
    Literal, SortOrder,
)
from ..expr.window import Lag, WindowExpression
from ..plan import logical as L
from ..plan.optimizer import join_conjuncts, split_conjuncts
from ..plan.tree import next_id
from .aggregates import AggSpec, lower_aggregate_function
from .exchange import BroadcastExchangeExec, ShuffleExchangeExec
from .fusion import collapse_computes, fuse_stages, merge_into_compute
from .operators import (
    CoalescePartitionsExec, ComputeExec, HashAggregateExec, HashJoinExec,
    LimitExec,
    LocalTableScanExec, NestedLoopJoinExec, PhysicalPlan, RangeExec,
    ScanExec, SortExec, UnionExec,
)
from .window import WindowExec
from .partitioning import (
    AllTuples, BroadcastDistribution, ClusteredDistribution,
    HashPartitioning, OrderedDistribution, RangePartitioning,
    SinglePartition, UnknownPartitioning,
)


def _shift_default(f: Lag) -> Expression | None:
    """lag/lead's default as WindowExec evaluates it for the current row
    (over the child's columns): cast to the function's type, or None for
    no default or a NULL one."""
    d = f.default
    if d is None or (isinstance(d, Literal) and d.value is None):
        return None
    return d if d.dtype == f.dtype else Cast(d, f.dtype)


def _row_width(attrs: Sequence[AttributeReference]) -> int:
    """Estimated bytes per row (the reference's, kept as is)."""
    w = 0
    for a in attrs:
        w += max(int(a.dtype.device_dtype.itemsize), 4)
    return max(w, 8)


class Planner:
    def __init__(self, conf: SQLConf):
        self.conf = conf

    def plan(self, plan: L.LogicalPlan) -> PhysicalPlan:
        from ..config import COMPILE_TIER, FUSION_ENABLED
        from .whole_query import apply_compile_tier

        p = self._convert(plan)
        p = self._ensure_requirements(p)
        # whole-stage fusion after stage boundaries exist (the
        # CollapseCodegenStages slot); the operator tier is the
        # operator-at-a-time oracle. Adjacent-ComputeExec collapsing is an
        # invariant, not a mode.
        p = collapse_computes(p)
        tier_pref = str(self.conf.get(COMPILE_TIER)).lower()
        if self.conf.get(FUSION_ENABLED) and tier_pref != "operator":
            p = fuse_stages(p, self.conf)
        self._inject_dpp(p)
        # the compile-tier cost model (physical/whole_query.py): wrap the
        # plan into ONE whole-query program, or stash the decision with
        # its fallback reason for explain
        return apply_compile_tier(p, self.conf)

    # ------------------------------------------------------------------
    def _inject_dpp(self, plan: PhysicalPlan) -> None:
        """Mark probe-side scans whose hive-partition column is a join key,
        so the join runs its build side first and prunes whole splits
        (reference: sqlx/dynamicpruning/PartitionPruning.scala)."""
        if not self.conf.get(DPP_ENABLED):
            return

        def scans_under(n, acc):
            """Pruning-safe descent only: an output row of these operators
            carries its source row's partition column unchanged.
            Limit/Window/Sort/Aggregate stop the walk: pruning below them
            would change which rows they keep."""
            if isinstance(n, ScanExec):
                acc.append(n)
            elif isinstance(n, (ComputeExec, UnionExec, ShuffleExchangeExec,
                                BroadcastExchangeExec)):
                for c in n.children:
                    scans_under(c, acc)
            elif isinstance(n, HashJoinExec):
                scans_under(n.left, acc)

        def walk(n):
            for c in n.children:
                walk(c)
            if isinstance(n, HashJoinExec) \
                    and n.join_type in ("inner", "left_semi"):
                acc: list = []
                scans_under(n.left, acc)
                for scan in acc:
                    pk = getattr(scan.source, "_part_keys", None)
                    if not pk or not hasattr(scan.source,
                                             "split_partition_value"):
                        continue
                    by_id = {a.expr_id: a.name for a in scan.attrs}
                    for ki, lk in enumerate(n.left_keys):
                        if by_id.get(lk.expr_id) in pk:
                            n.dpp_targets.append((scan, ki))

        walk(plan)

    # ------------------------------------------------------------------
    def _convert(self, node: L.LogicalPlan) -> PhysicalPlan:
        if isinstance(node, L.LogicalRelation):
            return ScanExec(node.source, list(node.attrs), node.name)
        if isinstance(node, L.LocalRelation):
            return LocalTableScanExec(list(node.attrs), node.table)
        if isinstance(node, L.OneRowRelation):
            import pyarrow as pa

            return LocalTableScanExec(
                [], pa.table({"__one": pa.array([1], pa.int32())}).select([]))
        if isinstance(node, L.RangeRelation):
            return RangeExec(node.start, node.end, node.step,
                             node.num_partitions, node.attr)
        if isinstance(node, L.SubqueryAlias):
            return self._convert(node.child)
        if isinstance(node, L.Project):
            child = self._convert(node.child)
            return self._fuse_compute([], node.project_list, child)
        if isinstance(node, L.Filter):
            return self._plan_filter(node)
        if isinstance(node, L.Aggregate):
            return self._plan_aggregate(node)
        if isinstance(node, L.Sort):
            return self._plan_sort(node)
        if isinstance(node, (L.Limit, L.Offset)):
            return self._plan_limit(node)
        if isinstance(node, L.Join):
            return self._plan_join(node)
        if isinstance(node, L.Union):
            return UnionExec([self._convert(c) for c in node.children_plans],
                             list(node.output))
        if isinstance(node, L.Distinct):
            # the optimizer rewrites it; a safety net
            out = node.child.output
            return self._plan_aggregate(
                L.Aggregate(list(out), list(out), node.child))
        if isinstance(node, L.PythonEval):
            from .python_eval import PythonEvalExec

            return PythonEvalExec(node.udf_aliases,
                                  self._convert(node.child))
        if isinstance(node, L.Generate):
            from .generate import GenerateExec

            return GenerateExec(node.generator, node.element_attr,
                                self._convert(node.child))
        if isinstance(node, L.Window):
            return self._plan_window(node)
        if isinstance(node, L.Repartition):
            child = self._convert(node.child)
            n = node.num_partitions or self.conf.shuffle_partitions
            if not node.shuffle:
                return CoalescePartitionsExec(n, child)
            if node.partition_exprs:
                keys, child = self._bind_keys(list(node.partition_exprs),
                                              child, "__repart")
                return ShuffleExchangeExec(HashPartitioning(keys, n), child)
            return ShuffleExchangeExec(UnknownPartitioning(n), child)
        raise NotPortedError(f"physical plan for {type(node).__name__}")

    def _plan_filter(self, node: L.Filter) -> PhysicalPlan:
        from ..io.sources import SupportsPushDownFilters

        conjuncts = split_conjuncts(node.condition)
        inner = node.child
        while isinstance(inner, L.SubqueryAlias):
            inner = inner.child
        outputs = list(node.child.output)
        if isinstance(inner, L.LogicalRelation) \
                and isinstance(inner.source, SupportsPushDownFilters) \
                and self.conf.get(DSV2_FILTER_PUSHDOWN):
            # the source takes the conjuncts it can translate and returns
            # those it could not apply; the engine keeps those and the
            # untranslatable ones
            mapped = _source_predicates_mapped(conjuncts, inner.attrs)
            if mapped:
                src2, residual = inner.source.push_filters(
                    [d for _, d in mapped])
                consumed = {id(c) for c, d in mapped if d not in residual}
                kept = [c for c in conjuncts if id(c) not in consumed]
                child = ScanExec(src2, list(inner.attrs), inner.name)
                return self._fuse_compute(kept, outputs, child)
        if isinstance(inner, L.LogicalRelation) \
                and hasattr(inner.source, "pruned") \
                and self.conf.get(PARQUET_FILTER_PUSHDOWN):
            preds = _source_predicates(conjuncts, inner.attrs)
            if preds:
                # split and row-group pruning by partition values and
                # statistics; the filter stays (pruning is conservative)
                child = ScanExec(inner.source.pruned(preds),
                                 list(inner.attrs), inner.name)
                return self._fuse_compute(conjuncts, outputs, child)
        child = self._convert(node.child)
        return self._fuse_compute(conjuncts, outputs, child)

    def _plan_window(self, node: L.Window) -> PhysicalPlan:
        child = self._convert(node.child)
        pkeys, child = self._bind_keys(list(node.partition_spec), child,
                                       "__wpart")
        okeys, child = self._bind_keys([o.child for o in node.order_spec],
                                       child, "__word")
        orders = [SortOrder(k, o.ascending, o.nulls_first)
                  for k, o in zip(okeys, node.order_spec)]
        arg_exprs = [al.child.function.child for al in node.window_exprs
                     if getattr(al.child.function, "child", None) is not None]
        arg_attrs, child = self._bind_keys(arg_exprs, child, "__warg")
        arg_map = dict(zip((id(e) for e in arg_exprs), arg_attrs))
        new_wexprs = []
        for al in node.window_exprs:
            w = al.child
            f = w.function
            if getattr(f, "child", None) is not None:
                f = f.copy(child=arg_map[id(f.child)])
            if isinstance(f, Lag):
                f = f.copy(default=_shift_default(f))
            nw = WindowExpression(f, list(pkeys), list(orders), w.frame)
            new_wexprs.append(Alias(nw, al.name, al.expr_id))
        wexec = WindowExec(new_wexprs, pkeys, orders, child)
        want = list(node.output)
        if [a.expr_id for a in wexec.output] != [a.expr_id for a in want]:
            return ComputeExec([], want, wexec)
        return wexec

    def _fuse_compute(self, filters: list[Expression],
                      outputs: list[Expression],
                      child: PhysicalPlan) -> PhysicalPlan:
        if isinstance(child, ComputeExec):
            return merge_into_compute(filters, outputs, child)
        return ComputeExec(filters, outputs, child)

    def _bind_keys(self, exprs: list[Expression], child: PhysicalPlan,
                   prefix: str):
        """Ensure exprs are attributes of child output; project complex ones."""
        child_ids = {a.expr_id for a in child.output}
        keys: list[AttributeReference] = []
        extra: list[Alias] = []
        for i, e in enumerate(exprs):
            if isinstance(e, AttributeReference) and e.expr_id in child_ids:
                keys.append(e)
            elif isinstance(e, Alias):
                extra.append(e)
                keys.append(e.to_attribute())
            else:
                al = Alias(e, f"{prefix}_{i}")
                extra.append(al)
                keys.append(al.to_attribute())
        if extra:
            child = self._fuse_compute([], list(child.output) + extra, child)
        return keys, child

    # ------------------------------------------------------------------
    def _plan_aggregate(self, node: L.Aggregate) -> PhysicalPlan:
        pushed = self._try_push_aggregate(node)
        if pushed is not None:
            return pushed
        child = self._convert(node.child)
        group_keys, child = self._bind_keys(list(node.grouping_exprs), child,
                                            "__group")
        group_map = list(zip(node.grouping_exprs, group_keys))

        funcs: list[AggregateFunction] = []
        for e in node.aggregate_exprs:
            for n in e.iter_nodes():
                if isinstance(n, AggregateFunction) and \
                        not any(n.semantic_equals(f) for f in funcs):
                    funcs.append(n)

        arg_exprs = [f.child for f in funcs if f.child is not None]
        arg_attrs, child = self._bind_keys(arg_exprs, child, "__aggarg")
        arg_map = dict(zip((id(e) for e in arg_exprs), arg_attrs))

        specs: list[AggSpec] = []
        func_to_spec = []
        for i, f in enumerate(funcs):
            bound = f.copy(child=arg_map[id(f.child)]) \
                if f.child is not None else f
            spec = lower_aggregate_function(bound, f"__agg{i}", next_id())
            specs.append(spec)
            func_to_spec.append((f, spec))

        if any(not s.mergeable for s in specs) and \
                child.output_partitioning().num_partitions != 1:
            # non-mergeable aggregates (percentile, collect): gather first,
            # aggregate once (no partial/final split)
            child = ShuffleExchangeExec(SinglePartition(), child)
        partial = HashAggregateExec(group_keys, specs, "partial", child)
        if child.output_partitioning().num_partitions == 1:
            # single upstream partition: the partial pass is already complete
            final: PhysicalPlan = partial
            partial.single_pass = True
        else:
            final = HashAggregateExec(group_keys, specs, "final", partial)
        outputs = [self._finish_expr(e, func_to_spec, group_map)
                   for e in node.aggregate_exprs]
        return ComputeExec([], outputs, final)

    def _fully_pushed_filter_scan(self, plan):
        """(relation, pushed source) where `plan` is a Filter over a
        pushdown-capable relation that accepts every conjunct with no
        residual; else None (the aggregate and limit pushdowns compose on
        it)."""
        from ..io.sources import SupportsPushDownFilters

        node = plan
        while isinstance(node, L.SubqueryAlias):
            node = node.child
        if not isinstance(node, L.Filter) \
                or not self.conf.get(DSV2_FILTER_PUSHDOWN):
            return None
        inner = node.child
        while isinstance(inner, L.SubqueryAlias):
            inner = inner.child
        if not isinstance(inner, L.LogicalRelation) or \
                not isinstance(inner.source, SupportsPushDownFilters):
            return None
        conjs = split_conjuncts(node.condition)
        mapped = _source_predicates_mapped(conjs, inner.attrs)
        if len(mapped) != len(conjs):
            return None
        src2, residual = inner.source.push_filters([d for _, d in mapped])
        if residual:
            return None
        return inner, src2

    def _try_push_aggregate(self, node: L.Aggregate):
        """An aggregate over a bare scan (or a fully pushed filter over
        one) whose groupings are plain columns and whose aggregates are
        count/sum/min/max/avg of plain columns runs in a
        SupportsPushDownAggregation source; the node becomes a scan of
        the aggregated result."""
        from ..expr.expressions import Average, Count, Max, Min, Sum
        from ..io.sources import SupportsPushDownAggregation

        inner = node.child
        while isinstance(inner, L.SubqueryAlias):
            inner = inner.child
        filter_src = None
        if isinstance(inner, L.Filter):
            pushed = self._fully_pushed_filter_scan(inner)
            if pushed is not None:
                inner, filter_src = pushed
        if not isinstance(inner, L.LogicalRelation) or \
                not isinstance(inner.source, SupportsPushDownAggregation) \
                or not self.conf.get(DSV2_AGG_PUSHDOWN):
            return None
        names = {a.expr_id: a.name for a in inner.attrs}
        if not all(isinstance(g, AttributeReference) and g.expr_id in names
                   for g in node.grouping_exprs):
            return None
        fn_of = {Count: "count", Sum: "sum", Min: "min", Max: "max",
                 Average: "avg"}
        groupings = [names[g.expr_id] for g in node.grouping_exprs]
        aggs, out_attrs = [], []
        for e in node.aggregate_exprs:
            if isinstance(e, AttributeReference) and any(
                    e.expr_id == g.expr_id for g in node.grouping_exprs):
                out_attrs.append(e)
                continue
            if not (isinstance(e, Alias) and type(e.child) in fn_of):
                return None
            f = e.child
            if getattr(f, "distinct", False):
                return None
            if f.child is None:
                col = None
            elif isinstance(f.child, AttributeReference) and \
                    f.child.expr_id in names:
                col = names[f.child.expr_id]
            else:
                return None
            aggs.append((fn_of[type(f)], col, e.name))
            out_attrs.append(e.to_attribute())
        if not aggs:
            return None
        base = filter_src if filter_src is not None else inner.source
        src2 = base.push_aggregation(groupings, aggs)
        if src2 is None:
            return None
        return ScanExec(src2, out_attrs, f"{inner.name}:agg")

    def _finish_expr(self, e: Expression, func_to_spec, group_map):
        def replace(x: Expression) -> Expression:
            for g, attr in group_map:
                gc = g.child if isinstance(g, Alias) else g
                if x.semantic_equals(g) or x.semantic_equals(gc):
                    return attr
            for f, spec in func_to_spec:
                if x.semantic_equals(f):
                    return spec.result_alias.child
            return x

        if isinstance(e, Alias):
            return Alias(e.child.transform_down(replace), e.name, e.expr_id)
        # analysis leaves only Aliases and grouping attributes here
        for g, attr in group_map:
            if e.semantic_equals(g):
                return e if e.expr_id == attr.expr_id else Alias(
                    attr, e.name, e.expr_id)
        return e

    # ------------------------------------------------------------------
    def _plan_sort(self, node: L.Sort) -> PhysicalPlan:
        child = self._convert(node.child)
        keys, child = self._bind_keys([o.child for o in node.orders], child,
                                      "__sort")
        orders = [SortOrder(k, o.ascending, o.nulls_first)
                  for k, o in zip(keys, node.orders)]
        sort = SortExec(orders, child, is_global=node.is_global)
        # drop helper columns if any were added
        if len(child.output) != len(node.output):
            return ComputeExec([], list(node.output), sort)
        return sort

    def _plan_limit(self, node) -> PhysicalPlan:
        if isinstance(node, L.Offset):
            child = self._convert(node.child)
            return LimitExec(1 << 62, child, offset=node.n, is_global=True)
        inner = node.child
        offset = 0
        if isinstance(inner, L.Offset):
            offset = inner.n
            inner = inner.child
        # TopK: ORDER BY + LIMIT -> per-partition sort+limit, gather, final
        # sort+limit (the reference's TakeOrderedAndProjectExec): no range
        # exchange and no global sort
        if isinstance(inner, L.Sort) and inner.is_global and all(
                isinstance(o.child, AttributeReference)
                for o in inner.orders):
            child = self._convert(inner.child)
            child_ids = {a.expr_id for a in child.output}
            if all(o.child.expr_id in child_ids for o in inner.orders):
                orders = [SortOrder(o.child, o.ascending, o.nulls_first)
                          for o in inner.orders]
                local = LimitExec(node.n + offset, SortExec(orders, child))
                gathered = ShuffleExchangeExec(SinglePartition(), local)
                return LimitExec(node.n, SortExec(orders, gathered),
                                 offset=offset, is_global=True)
        # a source that supports it applies the per-partition limit; the
        # engine's limit stays above it as the global cut (over a fully
        # pushed filter too: WHERE ... LIMIT n)
        from ..io.sources import SupportsPushDownLimit

        scan_like, pushed_filters = inner, None
        while isinstance(scan_like, L.SubqueryAlias):
            scan_like = scan_like.child
        if isinstance(scan_like, L.Filter):
            pushed = self._fully_pushed_filter_scan(scan_like)
            if pushed is not None:
                scan_like, pushed_filters = pushed
        if isinstance(scan_like, L.LogicalRelation):
            base_src = pushed_filters or scan_like.source
            if isinstance(base_src, SupportsPushDownLimit):
                pushed = base_src.push_limit(node.n + offset)
                if pushed is not None:
                    child = ScanExec(pushed, list(scan_like.attrs),
                                     scan_like.name)
                    local = LimitExec(node.n + offset, child,
                                      is_global=False)
                    return LimitExec(node.n, local, offset=offset,
                                     is_global=True)
        child = self._convert(inner)
        local = LimitExec(node.n + offset, child, is_global=False)
        return LimitExec(node.n, local, offset=offset, is_global=True)

    # ------------------------------------------------------------------
    def _plan_join(self, node: L.Join) -> PhysicalPlan:
        jt = node.join_type
        left_l, right_l = node.left, node.right
        # flip right joins: the build side is always the right one
        if jt == "right_outer":
            left_l, right_l = right_l, left_l
            jt = "left_outer"
        left = self._convert(left_l)
        right = self._convert(right_l)

        # split the condition into equi keys and a residual
        equi: list[tuple[Expression, Expression]] = []
        residual: list[Expression] = []
        if node.condition is not None:
            lids = {a.expr_id for a in left_l.output}
            rids = {a.expr_id for a in right_l.output}
            for c in split_conjuncts(node.condition):
                if isinstance(c, EqualTo):
                    lr, rr = c.left.references(), c.right.references()
                    if lr and rr and lr <= lids and rr <= rids:
                        equi.append((c.left, c.right))
                        continue
                    if lr and rr and lr <= rids and rr <= lids:
                        equi.append((c.right, c.left))
                        continue
                residual.append(c)
        if not equi:
            if jt in ("inner", "cross"):
                nl = NestedLoopJoinExec(
                    join_conjuncts(residual) if residual else None,
                    "cross" if jt == "cross" and not residual else "inner",
                    left, right)
                return self._restore_order(nl, node)
            if jt in ("left_semi", "left_anti", "left_outer"):
                # e.g. the null-aware NOT IN: "eq OR eq IS NULL" is not an
                # equi conjunct; any-match semantics need the pair fold,
                # not a hash probe
                nl = NestedLoopJoinExec(
                    join_conjuncts(residual) if residual else None,
                    jt, left, right)
                return self._restore_order(nl, node)
            raise NotPortedError(f"non-equi {jt} join")
        if residual and jt in ("left_semi", "left_anti", "left_outer"):
            # a residual on top of a semi/anti/outer hash join is not a
            # post-filter: match existence is decided over the whole
            # condition before null extension
            nl = NestedLoopJoinExec(node.condition, jt, left, right)
            return self._restore_order(nl, node)
        if residual and jt != "inner":
            raise NotPortedError(f"{jt} join with a non-equi residual")

        lkeys, left = self._bind_keys([lk for lk, _ in equi], left, "__jkl")
        rkeys, right = self._bind_keys([rk for _, rk in equi], right,
                                       "__jkr")
        join = HashJoinExec(lkeys, rkeys, jt, left, right,
                            is_broadcast=self._can_broadcast(right_l, jt))
        out: PhysicalPlan = join
        if residual:
            out = self._fuse_compute(residual, list(join.output), join)
        # drop helper key columns, restore the logical column order
        want = list(node.output)
        if [a.expr_id for a in out.output] != [a.expr_id for a in want]:
            out = self._fuse_compute([], want, out) \
                if not isinstance(out, ComputeExec) \
                else ComputeExec(out.filters, want, out.child)
        return out

    @staticmethod
    def _restore_order(plan: PhysicalPlan, node: L.Join) -> PhysicalPlan:
        """The logical column order over a flipped join."""
        want = list(node.output)
        if [a.expr_id for a in plan.output] != [a.expr_id for a in want]:
            return ComputeExec([], want, plan)
        return plan

    # join types where a replicated RIGHT build side is sound: full_outer
    # is not one (unmatched build rows would be emitted once per probe
    # partition)
    _BROADCAST_RIGHT_TYPES = frozenset(
        ("inner", "cross", "left_outer", "left_semi", "left_anti"))

    def _can_broadcast(self, right_logical: L.LogicalPlan, jt: str) -> bool:
        if jt not in self._BROADCAST_RIGHT_TYPES:
            return False
        rows = right_logical.stats_rows()
        if rows is None:
            return False
        width = _row_width(right_logical.output)
        return rows * width <= int(self.conf.get(AUTO_BROADCAST_THRESHOLD))

    # ------------------------------------------------------------------
    # EnsureRequirements
    # ------------------------------------------------------------------
    def _ensure_requirements(self, plan: PhysicalPlan) -> PhysicalPlan:
        plan = plan.map_children(lambda c: self._ensure_requirements(c))
        children = plan.children
        if not children:
            return plan
        n_shuffle = self.conf.shuffle_partitions
        new_children = list(children)
        changed = False
        reqs = plan.required_child_distribution()
        if isinstance(plan, HashJoinExec) and not plan.is_broadcast:
            # both sides hash-partitioned alike, or both re-shuffled
            (l, r), (lreq, rreq) = children, reqs
            lp, rp = l.output_partitioning(), r.output_partitioning()
            if not (lp.satisfies(lreq) and rp.satisfies(rreq)
                    and lp.num_partitions == rp.num_partitions):
                new_children[0] = ShuffleExchangeExec(
                    HashPartitioning(list(plan.left_keys), n_shuffle), l)
                new_children[1] = ShuffleExchangeExec(
                    HashPartitioning(list(plan.right_keys), n_shuffle), r)
                changed = True
        else:
            for i, (child, req) in enumerate(zip(children, reqs)):
                if child.output_partitioning().satisfies(req):
                    continue
                if isinstance(req, BroadcastDistribution):
                    new_children[i] = BroadcastExchangeExec(child)
                elif isinstance(req, AllTuples):
                    new_children[i] = ShuffleExchangeExec(SinglePartition(),
                                                          child)
                elif isinstance(req, ClusteredDistribution):
                    keys = [e for e in req.exprs
                            if isinstance(e, AttributeReference)]
                    new_children[i] = ShuffleExchangeExec(
                        HashPartitioning(keys, n_shuffle), child)
                elif isinstance(req, OrderedDistribution):
                    new_children[i] = ShuffleExchangeExec(
                        RangePartitioning(req.orders, n_shuffle), child)
                else:
                    raise NotPortedError(
                        f"exchange for {type(req).__name__}")
                changed = True
        # a global sort needs range partitioning
        if isinstance(plan, SortExec) and plan.is_global:
            child = new_children[0]
            p = child.output_partitioning()
            if not p.satisfies(OrderedDistribution(plan.orders)) \
                    and p.num_partitions > 1:
                new_children[0] = ShuffleExchangeExec(
                    RangePartitioning(plan.orders, n_shuffle), child)
                changed = True
        out = plan.with_new_children(new_children) if changed else plan
        if isinstance(out, HashAggregateExec) and out.single_pass and \
                not out.child.output_partitioning().satisfies(
                    ClusteredDistribution(list(out.grouping))
                    if out.grouping else AllTuples()):
            # planned as one pass over one partition, but an exchange added
            # below (a shuffled join over one-split scans) splits its input
            # by other keys: a group may now arise in several partitions,
            # so their partials merge in a final aggregate. The JAX planner
            # keeps the one pass and is right only where AQE coalesces the
            # join's partitions into one (spark_tpu/physical/adaptive.py
            # coalesce_join_inputs)
            if not all(s.mergeable for s in out.specs):
                # a percentile or collect has no merge: gather its input
                return out.with_new_children(
                    [ShuffleExchangeExec(SinglePartition(), out.child)])
            partial = out.copy(single_pass=False)
            dist = HashPartitioning(list(partial.grouping), n_shuffle) \
                if partial.grouping else SinglePartition()
            return HashAggregateExec(partial.grouping, partial.specs, "final",
                                     ShuffleExchangeExec(dist, partial))
        return out


def _source_predicates_mapped(conjuncts, attrs) -> list:
    """(conjunct, descriptor) pairs of the conjuncts that translate to a
    source predicate, so the planner can tell which ones a source
    consumed."""
    out = []
    for c in conjuncts:
        descs = _source_predicates([c], attrs)
        if len(descs) == 1:
            out.append((c, descs[0]))
    return out


def _source_predicates(conjuncts, attrs) -> list:
    """(col, op, value) predicates a DataSource can prune with: comparisons
    of an attribute with a literal, and IN over literals (reference:
    DataSourceStrategy.translateFilter)."""
    from ..expr.expressions import (
        GreaterThan, GreaterThanOrEqual, In, LessThan, LessThanOrEqual,
        Literal,
    )

    names = {a.expr_id: a.name for a in attrs}
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
    ops = {EqualTo: "=", LessThan: "<", LessThanOrEqual: "<=",
           GreaterThan: ">", GreaterThanOrEqual: ">="}
    preds = []
    for c in conjuncts:
        op = ops.get(type(c))
        if op is not None:
            l, r = c.left, c.right
            if isinstance(r, AttributeReference) and isinstance(l, Literal):
                l, r, op = r, l, flip[op]
            if isinstance(l, AttributeReference) and isinstance(r, Literal) \
                    and r.value is not None and l.expr_id in names:
                preds.append((names[l.expr_id], op, r.value))
        elif isinstance(c, In) and isinstance(c.child, AttributeReference) \
                and c.child.expr_id in names \
                and all(isinstance(i, Literal) for i in c.items):
            vals = [i.value for i in c.items if i.value is not None]
            if vals:
                preds.append((names[c.child.expr_id], "in", vals))
    return preds
