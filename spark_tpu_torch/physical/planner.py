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
    ComputeExec over the buffers.
"""

from __future__ import annotations

from ..config import SQLConf
from ..errors import NotPortedError
from ..expr.expressions import (
    AggregateFunction, Alias, AttributeReference, Expression,
)
from ..plan import logical as L
from ..plan.optimizer import split_conjuncts, substitute_attrs
from ..plan.tree import next_id
from .aggregates import AggSpec, lower_aggregate_function
from .exchange import ShuffleExchangeExec
from .operators import (
    ComputeExec, HashAggregateExec, LocalTableScanExec, PhysicalPlan,
)
from .partitioning import (
    AllTuples, ClusteredDistribution, HashPartitioning, SinglePartition,
    UnknownPartitioning,
)


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
        if isinstance(node, L.Project):
            child = self._convert(node.child)
            return self._fuse_compute([], node.project_list, child)
        if isinstance(node, L.Filter):
            child = self._convert(node.child)
            return self._fuse_compute(split_conjuncts(node.condition),
                                      list(node.child.output), child)
        if isinstance(node, L.Aggregate):
            return self._plan_aggregate(node)
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
        for i, (child, req) in enumerate(
                zip(children, plan.required_child_distribution())):
            if child.output_partitioning().satisfies(req):
                continue
            if isinstance(req, AllTuples):
                new_children[i] = ShuffleExchangeExec(SinglePartition(), child)
            elif isinstance(req, ClusteredDistribution):
                keys = [e for e in req.exprs
                        if isinstance(e, AttributeReference)]
                new_children[i] = ShuffleExchangeExec(
                    HashPartitioning(keys, n_shuffle), child)
            else:
                raise NotPortedError(f"exchange for {type(req).__name__}")
            changed = True
        return plan.with_new_children(new_children) if changed else plan
