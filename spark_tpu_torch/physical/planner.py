"""Physical planner: LogicalPlan -> PhysicalPlan (counterpart of
`spark_tpu/physical/planner.py`).

The port plans operator at a time, as the JAX package does with
`spark.tpu.fusion.enabled=false` and `spark.tpu.compile.tier=operator`:
convert, insert exchanges where a child's partitioning does not satisfy its
parent's required distribution (EnsureRequirements), then collapse adjacent
ComputeExecs. Contracts kept from the JAX planner:
  * exchange and grouping keys are always bound to attributes (complex keys
    get pre-projected via ComputeExec);
  * aggregates are planned partial -> (exchange) -> final with a finishing
    ComputeExec over the buffers;
  * right outer joins are flipped to left joins over swapped children; a
    build side whose estimated bytes fit spark.sql.autoBroadcastJoinThreshold
    is broadcast; cross joins, joins with no equi key and semi/anti/outer
    joins with a non-equi residual are NestedLoopJoinExecs over a broadcast
    right side;
  * ORDER BY + LIMIT plans as TopK: a local sort and limit per partition, a
    gather, then a final sort and limit.
"""

from __future__ import annotations

from typing import Sequence

from ..config import AUTO_BROADCAST_THRESHOLD, SQLConf
from ..errors import NotPortedError
from ..expr.expressions import (
    AggregateFunction, Alias, AttributeReference, EqualTo, Expression,
    SortOrder,
)
from ..expr.window import WindowExpression
from ..plan import logical as L
from ..plan.optimizer import join_conjuncts, split_conjuncts, substitute_attrs
from ..plan.tree import next_id
from .aggregates import AggSpec, lower_aggregate_function
from .exchange import BroadcastExchangeExec, ShuffleExchangeExec
from .operators import (
    ComputeExec, HashAggregateExec, HashJoinExec, LimitExec,
    LocalTableScanExec, NestedLoopJoinExec, PhysicalPlan, SortExec,
    UnionExec,
)
from .window import WindowExec
from .partitioning import (
    AllTuples, BroadcastDistribution, ClusteredDistribution,
    HashPartitioning, OrderedDistribution, RangePartitioning,
    SinglePartition, UnknownPartitioning,
)


def _row_width(attrs: Sequence[AttributeReference]) -> int:
    """Estimated bytes per row (the reference's, kept as is)."""
    w = 0
    for a in attrs:
        w += max(int(a.dtype.device_dtype.itemsize), 4)
    return max(w, 8)


def merge_into_compute(filters, outputs, child: ComputeExec) -> ComputeExec:
    """Fuse a filter/project layer into an existing ComputeExec child by
    substituting the child's output expressions (copy of
    `spark_tpu/physical/fusion.py` merge_into_compute)."""
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
    """Collapse adjacent ComputeExec nodes anywhere in the physical tree
    (copy of `spark_tpu/physical/fusion.py` collapse_computes)."""

    def rule(node):
        if isinstance(node, ComputeExec) and isinstance(node.child,
                                                        ComputeExec):
            return merge_into_compute(node.filters, node.outputs, node.child)
        return node

    return plan.transform_up(rule)


class Planner:
    def __init__(self, conf: SQLConf):
        self.conf = conf

    def plan(self, plan: L.LogicalPlan) -> PhysicalPlan:
        p = self._convert(plan)
        p = self._ensure_requirements(p)
        return collapse_computes(p)

    # ------------------------------------------------------------------
    def _convert(self, node: L.LogicalPlan) -> PhysicalPlan:
        if isinstance(node, L.LocalRelation):
            return LocalTableScanExec(list(node.attrs), node.table)
        if isinstance(node, L.SubqueryAlias):
            return self._convert(node.child)
        if isinstance(node, L.Project):
            child = self._convert(node.child)
            return self._fuse_compute([], node.project_list, child)
        if isinstance(node, L.Filter):
            child = self._convert(node.child)
            return self._fuse_compute(split_conjuncts(node.condition),
                                      list(node.child.output), child)
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
        if isinstance(node, L.Window):
            return self._plan_window(node)
        if isinstance(node, L.Repartition):
            child = self._convert(node.child)
            n = node.num_partitions or self.conf.shuffle_partitions
            if not node.shuffle:
                raise NotPortedError("coalesce (CoalescePartitionsExec)")
            if node.partition_exprs:
                keys, child = self._bind_keys(list(node.partition_exprs),
                                              child, "__repart")
                return ShuffleExchangeExec(HashPartitioning(keys, n), child)
            return ShuffleExchangeExec(UnknownPartitioning(n), child)
        raise NotPortedError(f"physical plan for {type(node).__name__}")

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

        partial = HashAggregateExec(group_keys, specs, "partial", child)
        if child.output_partitioning().num_partitions == 1:
            # single upstream partition: the partial pass is already complete
            final: PhysicalPlan = partial
        else:
            final = HashAggregateExec(group_keys, specs, "final", partial)
        outputs = [self._finish_expr(e, func_to_spec, group_map)
                   for e in node.aggregate_exprs]
        return ComputeExec([], outputs, final)

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
        return plan.with_new_children(new_children) if changed else plan
