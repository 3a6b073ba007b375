"""Analyzer: resolves relations, columns, functions and subqueries, names
unnamed outputs, coerces decimal arithmetic and widens set-operation
branches
(counterpart of `spark_tpu/plan/analyzer.py`, the rules the port's
DataFrame and SQL slices need, in the reference's batch order):
ResolveRelations, DeduplicateRelations, ResolveReferences (qualified names,
star expansion, function and window resolution), ResolveGroupByAlias,
ResolveSubqueries (a subquery's plan resolves in its own scope, and a name
it cannot resolve there binds to the outer query: a correlation),
GlobalAggregates, ResolveAggsInSortHaving, ResolveSortHiddenRefs,
ResolveUsingJoin (JOIN ... USING), ResolveSessionVariables (a name no
column resolves reads a declared session variable),
ExtractWindowFromAggregate and ExtractWindowExpressions (window functions
move into Window nodes, one per spec), FoldIntervalArithmetic,
ResolveAliases, CoerceDecimalArithmetic, WidenSetOperationTypes and
CheckAnalysis. Numeric coercion happens where each expression evaluates
(common_type casts; a date meets a timestamp as a timestamp), as in the
JAX package. A dotted name whose prefix is a struct column resolves to its
field accesses (`_resolve_struct_path`), and ExtractGenerators moves an
explode() out of a SELECT into a Generate node."""

from __future__ import annotations

import difflib
from typing import Sequence

from ..errors import AnalysisException, UnresolvedColumnError
from ..expr.expressions import (
    Add, AggregateFunction, Alias, And, AttributeReference, Average, Cast,
    Coalesce, Count, Divide, EqualTo, Explode, Expression, GetStructField,
    Grouping, GroupingID, IntervalLiteral, Literal, Max, Min, Multiply,
    SortOrder, Split, Subtract, Sum, UnaryMinus, UnresolvedAttribute,
    UnresolvedFunction, UnresolvedStar, cast_if,
)
from ..expr.registry import build_function
from ..expr.window import UnresolvedWindowExpression, WindowExpression
from ..types import DecimalType, StructType, common_type
from .catalog import Catalog
from .logical import (
    Aggregate, Except, Filter, Generate, GroupingSets, Intersect, Join,
    LocalRelation,
    LogicalPlan, LogicalRelation, Project, RangeRelation, Sort,
    SubqueryAlias, Union, UnresolvedRelation, UsingJoin, Window,
)
from .tree import Batch, FixedPoint, Once, Rule, RuleExecutor


def _resolve_name(name_parts: tuple[str, ...],
                  attrs: Sequence[AttributeReference],
                  case_sensitive: bool) -> AttributeReference | None:
    def norm(s: str) -> str:
        return s if case_sensitive else s.lower()

    # qualified references must suffix-match the attribute's qualifier
    matches = []
    for a in attrs:
        if norm(a.name) == norm(name_parts[-1]):
            quals = tuple(norm(q) for q in name_parts[:-1])
            if quals:
                aq = tuple(norm(q) for q in a.qualifier)
                if len(aq) < len(quals) or aq[-len(quals):] != quals:
                    continue
            matches.append(a)
    if len(matches) == 1:
        return matches[0]
    if len(matches) > 1:
        # ambiguous unless they are the same attribute id
        if len({m.expr_id for m in matches}) == 1:
            return matches[0]
        raise AnalysisException(
            f"Reference `{'.'.join(name_parts)}` is ambiguous",
            error_class="AMBIGUOUS_REFERENCE")
    return None


class ResolveRelations(Rule):
    def __init__(self, catalog: Catalog):
        self.catalog = catalog

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        def rule(node):
            if isinstance(node, UnresolvedRelation):
                resolved = self.catalog.lookup(node.name_parts)
                # the attribute instances are shared; a relation joined to
                # itself is re-instanced by DeduplicateRelations
                return SubqueryAlias(node.name_parts[-1], resolved)
            return node

        return plan.transform_up(rule)


class DeduplicateRelations(Rule):
    """Re-instance attribute ids on the right side of a self-join
    (reference: Analyzer DeduplicateRelations)."""

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        def rule(node):
            if isinstance(node, (Join, UsingJoin)):
                try:
                    left_ids = {a.expr_id for a in node.left.output}
                    right_ids = {a.expr_id for a in node.right.output}
                except AnalysisException:
                    return node  # children await alias resolution
                overlap = left_ids & right_ids
                if overlap:
                    mapping: dict[int, AttributeReference] = {}
                    return node.copy(
                        right=_remap_plan(node.right, mapping, overlap))
            return node

        return plan.transform_up(rule)


def _remap_plan(plan: LogicalPlan, mapping: dict[int, AttributeReference],
                overlap: set[int]) -> LogicalPlan:
    """Copy a subtree giving fresh expr_ids to the attributes in `overlap`
    (one new id per old id for the whole subtree) and to the aliases that
    produce them."""

    def remap_expr(e: Expression) -> Expression:
        if isinstance(e, AttributeReference) and e.expr_id in mapping:
            return mapping[e.expr_id]
        if isinstance(e, Alias) and e.expr_id in overlap:
            na = mapping.get(e.expr_id)
            if na is None:
                new = Alias(e.child, e.name)    # fresh expr_id
                mapping[e.expr_id] = new.to_attribute()
                return new
            return Alias(e.child, e.name, expr_id=na.expr_id)
        return e

    def go(node: LogicalPlan) -> LogicalPlan:
        node = node.map_children(go)
        if isinstance(node, (LocalRelation, LogicalRelation)):
            new_attrs, changed = [], False
            for a in node.attrs:
                if a.expr_id in overlap:
                    # one new instance per old id for the whole subtree: a
                    # relation in several union branches keeps one id
                    na = mapping.get(a.expr_id)
                    if na is None:
                        na = mapping[a.expr_id] = a.new_instance()
                    new_attrs.append(na)
                    changed = True
                else:
                    new_attrs.append(a)
            if changed:
                node = node.copy(attrs=new_attrs)
        elif isinstance(node, RangeRelation) and \
                node.attr.expr_id in overlap:
            na = mapping.get(node.attr.expr_id)
            if na is None:
                na = mapping[node.attr.expr_id] = node.attr.new_instance()
            node = node.copy(attr=na)
        return node.transform_expressions(remap_expr)

    return go(plan)


def _resolve_struct_path(name_parts, attrs, case_sensitive):
    """a.b.c where a prefix resolves to a struct column: the remaining
    parts as field accesses (the reference's `_resolve_struct_path`)."""
    def norm(s):
        return s if case_sensitive else s.lower()

    for k in range(len(name_parts) - 1, 0, -1):
        base = _resolve_name(name_parts[:k], attrs, case_sensitive)
        if base is None or not isinstance(base.dtype, StructType):
            continue
        out = base
        for p in name_parts[k:]:
            dt = out.dtype
            actual = next((f.name for f in dt.fields
                           if norm(f.name) == norm(p)), None) \
                if isinstance(dt, StructType) else None
            if actual is None:
                out = None
                break
            out = GetStructField(out, actual)
        if out is not None:
            return out
    return None


class ResolveReferences(Rule):
    def __init__(self, case_sensitive: bool = False):
        self.case_sensitive = case_sensitive

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        cs = self.case_sensitive
        # (node, verdict) per id: holding the node pins its id for the pass
        _dedup_memo: dict[int, tuple[LogicalPlan, bool]] = {}

        def _awaits_dedup(n: LogicalPlan) -> bool:
            """True when a descendant self-join still has overlapping ids:
            resolving an expression above it would bind both sides to one
            id."""
            hit = _dedup_memo.get(id(n))
            if hit is not None and hit[0] is n:
                return hit[1]
            out = any(_awaits_dedup(c) for c in n.children)
            if not out and isinstance(n, Join):
                try:
                    lids = {a.expr_id for a in n.left.output}
                    rids = {a.expr_id for a in n.right.output}
                    out = bool(lids & rids)
                except AnalysisException:
                    out = False
            _dedup_memo[id(n)] = (n, out)
            return out

        def rule(node: LogicalPlan):
            if not all(c.resolved for c in node.children):
                return node
            try:
                inputs = node.input_attrs()
            except AnalysisException:
                return node  # child awaits ResolveAliases
            if _awaits_dedup(node):
                return node

            if isinstance(node, (Project, Aggregate)):
                lst = node.project_list if isinstance(node, Project) \
                    else node.aggregate_exprs
                if any(isinstance(e, UnresolvedStar) for e in lst):
                    expanded: list[Expression] = []
                    for e in lst:
                        if not isinstance(e, UnresolvedStar):
                            expanded.append(e)
                        elif e.target is None:
                            expanded.extend(inputs)
                        else:
                            t = e.target if cs else e.target.lower()
                            hits = [a for a in inputs
                                    if t in tuple(q if cs else q.lower()
                                                  for q in a.qualifier)]
                            if not hits:
                                raise AnalysisException(
                                    f"cannot resolve {e.target}.*")
                            expanded.extend(hits)
                    if isinstance(node, Project):
                        return node.copy(project_list=expanded)
                    return node.copy(aggregate_exprs=expanded)

            def resolve_expr(e: Expression) -> Expression:
                if isinstance(e, UnresolvedAttribute):
                    a = _resolve_name(e.name_parts, inputs, cs)
                    if a is not None:
                        return a
                    nested = _resolve_struct_path(e.name_parts, inputs, cs)
                    return e if nested is None else nested
                if isinstance(e, UnresolvedFunction):
                    if all(c.resolved or isinstance(c, UnresolvedStar)
                           for c in e.args):
                        return build_function(e.fname, e.args, e.distinct)
                    return e
                if isinstance(e, UnresolvedWindowExpression):
                    if e.function.resolved and \
                            all(p.resolved for p in e.partition_spec) and \
                            all(o.resolved for o in e.order_spec):
                        return WindowExpression(e.function, e.partition_spec,
                                                e.order_spec, e.frame)
                return e

            # Sort/Filter over an Aggregate may reference aggregate outputs
            # or grouping child columns: ResolveAggsInSortHaving
            return node.transform_expressions(resolve_expr)

        return plan.transform_up(rule)


class ResolveAliases(Rule):
    """Wrap top-level unnamed project/aggregate expressions in Aliases."""

    def apply(self, plan):
        def rule(node):
            if isinstance(node, Project):
                if node.expressions_resolved and any(
                        not isinstance(e, (Alias, AttributeReference, UnresolvedStar))
                        for e in node.project_list):
                    return node.copy(project_list=[_auto_alias(e)
                                                   for e in node.project_list])
            if isinstance(node, (Aggregate, GroupingSets)):
                if node.expressions_resolved and any(
                        not isinstance(e, (Alias, AttributeReference, UnresolvedStar))
                        for e in node.aggregate_exprs):
                    return node.copy(aggregate_exprs=[_auto_alias(e)
                                                      for e in node.aggregate_exprs])
            return node

        return plan.transform_up(rule)


def _auto_alias(e: Expression) -> Expression:
    if isinstance(e, (Alias, AttributeReference, UnresolvedStar)):
        return e
    return Alias(e, _pretty_name(e))


def _pretty_name(e: Expression) -> str:
    if isinstance(e, GetStructField):
        return e.field_name  # `a.b` names its output `b`, as the reference
    if isinstance(e, Sum):
        return f"sum({_pretty_name(e.child)})"
    if isinstance(e, Count):
        return f"count({_pretty_name(e.child) if e.child else '1'})"
    if isinstance(e, Min):
        return f"min({_pretty_name(e.child)})"
    if isinstance(e, Max):
        return f"max({_pretty_name(e.child)})"
    if isinstance(e, Average):
        return f"avg({_pretty_name(e.child)})"
    if isinstance(e, (AttributeReference, UnresolvedAttribute)):
        return e.name
    if isinstance(e, Literal):
        return str(e.value)
    if isinstance(e, Cast):
        return _pretty_name(e.child)
    sym = getattr(e, "symbol", None)
    if sym is not None and hasattr(e, "left") and hasattr(e, "right"):
        return f"({_pretty_name(e.left)} {sym} {_pretty_name(e.right)})"
    kids = [c for c in e.children if c is not None]
    if kids:
        return (f"{e.sql_name()}"
                f"({', '.join(_pretty_name(c) for c in kids)})")
    return e.simple_string()


def _contains_agg(e: Expression) -> bool:
    if isinstance(e, AggregateFunction):
        return True
    return any(_contains_agg(c) for c in e.children
               if isinstance(c, Expression))


class ResolveGroupByAlias(Rule):
    """GROUP BY may reference a SELECT-list alias: a grouping expression
    that stays unresolved against the child's columns resolves to the
    aliased select expression, provided that is not an aggregate."""

    def __init__(self, case_sensitive: bool = False):
        self.cs = case_sensitive

    def apply(self, plan):
        def rule(node):
            if not isinstance(node, (Aggregate, GroupingSets)):
                return node
            if all(g.resolved for g in node.grouping_exprs):
                return node
            aliases = {}
            for e in node.aggregate_exprs:
                if isinstance(e, Alias) and e.child.resolved and \
                        not _contains_agg(e.child):
                    key = e.name if self.cs else e.name.lower()
                    aliases.setdefault(key, e.child)

            def fix(g):
                if isinstance(g, UnresolvedAttribute) and \
                        len(g.name_parts) == 1:
                    key = g.name_parts[0] if self.cs \
                        else g.name_parts[0].lower()
                    sub = aliases.get(key)
                    if sub is not None:
                        return sub
                return g

            new_groups = [fix(g) for g in node.grouping_exprs]
            if all(a is b for a, b in zip(new_groups, node.grouping_exprs)):
                return node
            return node.copy(grouping_exprs=new_groups)

        return plan.transform_up(rule)


class GlobalAggregates(Rule):
    """A Project whose list holds an aggregate function (outside any window
    expression) becomes a global Aggregate with no grouping."""

    def apply(self, plan):
        def has_plain_agg(e) -> bool:
            if isinstance(e, (WindowExpression, UnresolvedWindowExpression)):
                return False  # window aggregates aggregate per row
            if isinstance(e, AggregateFunction):
                return True
            return any(has_plain_agg(c) for c in e.children
                       if isinstance(c, Expression))

        def rule(node):
            if isinstance(node, Project) and \
                    any(has_plain_agg(e) for e in node.project_list):
                return Aggregate([], list(node.project_list), node.child)
            return node

        return plan.transform_up(rule)


class ResolveAggsInSortHaving(Rule):
    """Resolve HAVING filters and ORDER BY over an Aggregate: references to
    aggregate results resolve to output attrs; bare aggregate functions get
    pulled into the aggregate (reference: ResolveAggregateFunctions)."""

    def __init__(self, case_sensitive: bool = False):
        self.cs = case_sensitive

    def apply(self, plan):
        def rule(node):
            tgt = _skip_alias(node.child) \
                if isinstance(node, (Filter, Sort)) else None
            if isinstance(node, Sort) and isinstance(tgt, Filter) and \
                    isinstance(_skip_alias(tgt.child), Aggregate):
                # ORDER BY over HAVING over Aggregate: resolve the sort
                # keys against the aggregate below the filter
                tgt = _skip_alias(tgt.child)
            if not (isinstance(node, (Filter, Sort))
                    and isinstance(tgt, Aggregate)):
                return node
            agg = tgt
            if not agg.resolved:
                return node
            if any(not isinstance(e, (Alias, AttributeReference))
                   for e in agg.aggregate_exprs):
                return node  # wait for ResolveAliases
            out_attrs = agg.output
            extra: list[Alias] = []

            def resolve(e: Expression) -> Expression:
                if isinstance(e, UnresolvedAttribute):
                    a = _resolve_name(e.name_parts, out_attrs, self.cs)
                    if a is not None:
                        return a
                    a = _resolve_name(e.name_parts, agg.child.output, self.cs)
                    if a is not None:
                        return a
                    # a struct path over the aggregate's child (ORDER BY
                    # s.a where s.a is a grouping expression) binds to the
                    # matching aggregate output
                    nested = _resolve_struct_path(
                        e.name_parts, agg.child.output, self.cs)
                    if nested is None:
                        return e
                    for ae in agg.aggregate_exprs:
                        if isinstance(ae, Alias) and \
                                ae.child.semantic_equals(nested):
                            return ae.to_attribute()
                    return nested
                if isinstance(e, UnresolvedFunction):
                    if all(c.resolved or isinstance(c, UnresolvedStar)
                           for c in e.args):
                        f = build_function(e.fname, e.args, e.distinct)
                        if isinstance(f, AggregateFunction):
                            return match_agg(f)
                        return f
                    return e
                # an aggregate already built by function resolution (e.g.
                # count(*)) still binds to the aggregate's output or is
                # pulled into it
                if isinstance(e, AggregateFunction) and e.resolved:
                    return match_agg(e)
                return e

            def match_agg(f: Expression) -> Expression:
                for ae in agg.aggregate_exprs:
                    if isinstance(ae, Alias) and ae.child.semantic_equals(f):
                        return ae.to_attribute()
                al = Alias(f, _pretty_name(f))
                extra.append(al)
                return al.to_attribute()

            # resolve against the agg child FIRST for aggregate arguments
            def resolve_inner_attrs(e):
                if isinstance(e, UnresolvedAttribute):
                    a = _resolve_name(e.name_parts, agg.child.output, self.cs)
                    if a is not None:
                        return a
                return e

            if isinstance(node, Filter):
                cond = node.condition.transform_up(resolve_inner_attrs)
                cond = cond.transform_up(resolve)
                if extra:
                    new_agg = agg.copy(
                        aggregate_exprs=agg.aggregate_exprs + extra)
                    child = _replace_agg(node.child, new_agg)
                    return Project(list(out_attrs), Filter(cond, child))
                if cond is not node.condition:
                    return node.copy(condition=cond)
                return node
            orders = []
            changed = False
            for o in node.orders:
                c = o.child.transform_up(resolve_inner_attrs)
                c = c.transform_up(resolve)
                # a whole order expression equal to a select-list item
                # binds to that output
                for ae in agg.aggregate_exprs:
                    if isinstance(ae, Alias) and not isinstance(
                            c, AttributeReference) and \
                            ae.child.semantic_equals(c):
                        c = ae.to_attribute()
                        break
                if c is not o.child:
                    changed = True
                    orders.append(SortOrder(c, o.ascending, o.nulls_first))
                else:
                    orders.append(o)
            if extra:
                new_agg = agg.copy(
                    aggregate_exprs=agg.aggregate_exprs + extra)
                child = _replace_agg(node.child, new_agg)
                return Project(list(out_attrs),
                               Sort(orders, node.is_global, child))
            if changed:
                return node.copy(orders=orders)
            return node

        return plan.transform_up(rule)


def _skip_alias(p: LogicalPlan) -> LogicalPlan:
    while isinstance(p, SubqueryAlias):
        p = p.child
    return p


def _replace_agg(p: LogicalPlan, new_agg: Aggregate) -> LogicalPlan:
    if isinstance(p, (SubqueryAlias, Filter)):
        return p.copy(child=_replace_agg(p.child, new_agg))
    return new_agg


class ResolveSortHiddenRefs(Rule):
    """ORDER BY may reference columns of the FROM clause that are not in the
    SELECT list (reference: Analyzer ResolveMissingReferences): resolve them
    against the project's child and re-project afterwards."""

    def __init__(self, case_sensitive: bool = False):
        self.cs = case_sensitive

    def apply(self, plan):
        def rule(node):
            if not (isinstance(node, Sort) and isinstance(node.child, Project)
                    and node.child.resolved):
                return node
            proj = node.child
            try:
                outputs = proj.output
                hidden = proj.child.output
            except AnalysisException:
                return node
            missing: list[AttributeReference] = []
            changed = [False]

            def resolve(e):
                if isinstance(e, UnresolvedAttribute):
                    a = _resolve_name(e.name_parts, outputs, self.cs)
                    if a is not None:
                        changed[0] = True
                        return a
                    a = _resolve_name(e.name_parts, hidden, self.cs)
                    if a is not None:
                        changed[0] = True
                        if all(x.expr_id != a.expr_id for x in missing) and \
                                all(x.expr_id != a.expr_id for x in outputs):
                            missing.append(a)
                        return a
                    nested = _resolve_struct_path(e.name_parts, hidden,
                                                  self.cs)
                    if nested is not None:
                        # a sort on a hidden struct field carries the base
                        # struct column through the inner project
                        changed[0] = True
                        base = nested
                        while not isinstance(base, AttributeReference):
                            base = base.child
                        if all(x.expr_id != base.expr_id
                               for x in missing) and \
                                all(x.expr_id != base.expr_id
                                    for x in outputs):
                            missing.append(base)
                        return nested
                return e

            new_orders = [SortOrder(o.child.transform_up(resolve),
                                    o.ascending, o.nulls_first)
                          for o in node.orders]
            if missing:
                inner = Project(list(proj.project_list) + missing, proj.child)
                return Project(list(outputs),
                               Sort(new_orders, node.is_global, inner))
            if changed[0]:
                return node.copy(orders=new_orders)
            return node

        return plan.transform_up(rule)


class _ResolveRelationsDedup(Rule):
    """ResolveRelations for subquery scopes: re-instances attributes that
    collide with the outer scope's ids."""

    def __init__(self, catalog: Catalog, outer_ids: set[int]):
        self.catalog = catalog
        self.outer_ids = set(outer_ids)

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        def rule(node):
            if isinstance(node, UnresolvedRelation):
                resolved = self.catalog.lookup(node.name_parts)
                # a view's body may hold unaliased union-branch literals
                # (`... UNION ALL SELECT 1, 20`): alias them before reading
                # its output, as the main path's ResolveAliases would
                resolved = ResolveAliases().apply(resolved)
                overlap = {a.expr_id for a in resolved.output} & \
                    self.outer_ids
                if overlap:
                    mapping: dict[int, AttributeReference] = {}
                    resolved = _remap_plan(resolved, mapping, overlap)
                return SubqueryAlias(node.name_parts[-1], resolved)
            return node

        return plan.transform_up(rule)


class ResolveSubqueries(Rule):
    """Resolve subquery plans; references left unresolved in a subquery's
    own scope resolve against the outer scope (correlation)."""

    def __init__(self, analyzer: "Analyzer"):
        self.analyzer = analyzer

    def apply(self, plan):
        from .subquery import SubqueryExpression

        an = self.analyzer

        def rule(node):
            if not all(c.resolved for c in node.children):
                return node
            try:
                outer = node.input_attrs()
            except AnalysisException:
                return node

            def needs_alias(p):
                # `x IN (SELECT 1)`: the plan is resolved, but its bare
                # project output still needs the alias pass
                for n in p.iter_nodes():
                    if isinstance(n, Project):
                        exprs = n.project_list
                    elif isinstance(n, (Aggregate, GroupingSets)):
                        exprs = n.aggregate_exprs
                    else:
                        continue
                    if any(not isinstance(ex, (Alias, AttributeReference,
                                               UnresolvedStar))
                           and ex.resolved for ex in exprs):
                        return True
                return False

            def fix(e):
                if isinstance(e, SubqueryExpression) and \
                        (not e.plan.resolved or needs_alias(e.plan)):
                    return e.copy(plan=an.execute_subquery(e.plan, outer))
                return e

            return node.transform_expressions(fix)

        return plan.transform_up(rule)


class ResolveSessionVariables(Rule):
    """A single-part name that no column resolved reads a declared session
    variable and becomes its literal value: a column wins over a variable
    (the reference's resolution order)."""

    def __init__(self, catalog: Catalog):
        self.catalog = catalog

    def apply(self, plan):
        variables = self.catalog.variables
        if not variables:
            return plan

        def fix(e):
            if isinstance(e, UnresolvedAttribute) and \
                    len(e.name_parts) == 1:
                hit = variables.get(e.name_parts[0].lower())
                if hit is not None:
                    return hit
            return e

        def rule(node):
            # only where the children are resolved: a column of the same
            # name must win first
            if all(c.resolved for c in node.children):
                return node.map_expressions(
                    lambda ex: ex.transform_up(fix))
            return node

        return plan.transform_up(rule)


class ResolveUsingJoin(Rule):
    """JOIN USING (c1, ...) -> an equi Join and a projection emitting each
    using column once: inner and left take the left side's column,
    right_outer the right's, full_outer coalesces both; semi and anti keep
    the left output. As in the reference, and unlike Spark, the dropped
    right-side key is not kept as a hidden attribute, so `r.k` after
    USING (k) does not resolve."""

    def __init__(self, case_sensitive: bool = False):
        self.cs = case_sensitive

    def apply(self, plan):
        def find(attrs, name):
            matches = [a for a in attrs
                       if a.name == name or (
                           not self.cs
                           and a.name.lower() == name.lower())]
            if len({a.expr_id for a in matches}) > 1:
                raise AnalysisException(
                    f"USING column `{name}` is ambiguous",
                    error_class="AMBIGUOUS_REFERENCE")
            if not matches:
                raise AnalysisException(
                    f"USING column {name} not found among "
                    f"[{', '.join(a.name for a in attrs)}]")
            return matches[0]

        def rule(node):
            if not isinstance(node, UsingJoin) or \
                    not (node.left.resolved and node.right.resolved):
                return node
            try:
                lout = node.left.output
                rout = node.right.output
            except AnalysisException:
                return node     # children await alias resolution
            lats = [find(lout, c) for c in node.using_cols]
            rats = [find(rout, c) for c in node.using_cols]
            cond = None
            for la, ra in zip(lats, rats):
                c = EqualTo(la, ra)
                cond = c if cond is None else And(cond, c)
            joined = Join(node.left, node.right, node.join_type, cond)
            jt = joined.join_type
            if jt in ("left_semi", "left_anti"):
                return joined
            # the join's output attributes: a null-padded side's are
            # nullable there
            by_id = {a.expr_id: a for a in joined.output}
            jl = [by_id[a.expr_id] for a in lats]
            jr = [by_id[a.expr_id] for a in rats]
            if jt == "right_outer":
                keys: list[Expression] = list(jr)
            elif jt == "full_outer":
                keys = [Alias(Coalesce([la, ra]), la.name)
                        for la, ra in zip(jl, jr)]
            else:
                keys = list(jl)
            drop = {a.expr_id for a in lats} | {a.expr_id for a in rats}
            rest = [by_id[a.expr_id] for a in node.left.output
                    if a.expr_id not in drop] + \
                   [by_id[a.expr_id] for a in node.right.output
                    if a.expr_id not in drop]
            return Project(keys + rest, joined)

        return plan.transform_up(rule)


class ExtractGenerators(Rule):
    """A Project holding explode() -> a Project over Generate (the
    reference's ExtractGenerators): one generator per SELECT; a computed
    source (explode(map_keys(m))) binds to a column first, so Generate
    sees an attribute, a literal, or split() of one."""

    def apply(self, plan):
        def rule(node):
            if not isinstance(node, Project) or not node.expressions_resolved:
                return node
            gens = [e for pe in node.project_list
                    for e in pe.iter_nodes() if isinstance(e, Explode)]
            if not gens:
                return node
            if len(gens) > 1:
                raise AnalysisException(
                    "only one generator per SELECT is supported")
            gen = gens[0]
            elem = AttributeReference("col", gen.dtype, True)

            def replace(e):
                return elem if e is gen else e

            new_list = []
            for e in node.project_list:
                if isinstance(e, Alias):
                    new_list.append(Alias(e.child.transform_up(replace),
                                          e.name, e.expr_id))
                else:
                    new_list.append(e.transform_up(replace))
            src = gen.child
            child_plan = node.child
            simple = isinstance(src, (AttributeReference, Literal)) or (
                isinstance(src, Split)
                and isinstance(src.child, (AttributeReference, Literal)))
            if not simple:
                bound = Alias(src, "__gen_src")
                child_plan = Project(list(node.child.output) + [bound],
                                     node.child)
                src = bound.to_attribute()
            return Project(new_list, Generate(src, elem, child_plan))

        return plan.transform_up(rule)


class ExtractWindowFromAggregate(Rule):
    """Window functions in a grouped SELECT evaluate over the grouped rows:
    Aggregate(g, outs with windows) -> Project(outs', Aggregate(g, aggs)),
    after which ExtractWindowExpressions applies to the Project."""

    def apply(self, plan):
        def rule(node):
            if not isinstance(node, (Aggregate, GroupingSets)) or \
                    not node.expressions_resolved:
                return node
            if not any(isinstance(x, WindowExpression)
                       for e in node.aggregate_exprs
                       for x in e.iter_nodes()):
                return node

            # every aggregate function, those inside window specs too,
            # computes in the inner aggregate, but a window function's head
            # itself: `sum(sum(x)) OVER (...)` aggregates sum(x) inside,
            # then windows over the grouped rows (q12, q20, q98)
            funcs: list[Expression] = []

            def collect(e: Expression):
                if isinstance(e, WindowExpression):
                    for c in e.function.children:
                        collect(c)
                    for p in e.partition_spec:
                        collect(p)
                    for o in e.order_spec:
                        collect(o)
                    return
                if isinstance(e, (AggregateFunction, Grouping, GroupingID)):
                    if not any(e.semantic_equals(f) for f in funcs):
                        funcs.append(e)
                    return
                for c in e.children:
                    collect(c)

            for e in node.aggregate_exprs:
                collect(e)

            g_aliases: list[tuple[Expression, AttributeReference]] = []
            inner_outs: list[Expression] = []
            for i, g in enumerate(node.grouping_exprs):
                if isinstance(g, AttributeReference):
                    inner_outs.append(g)
                    g_aliases.append((g, g))
                else:
                    al = Alias(g, f"_wg{i}")
                    inner_outs.append(al)
                    g_aliases.append((g, al.to_attribute()))
            f_aliases = [Alias(f, f"_wa{i}") for i, f in enumerate(funcs)]
            inner = node.copy(aggregate_exprs=inner_outs + f_aliases)

            def fix(x: Expression) -> Expression:
                if isinstance(x, (AggregateFunction, Grouping, GroupingID)):
                    for f, al in zip(funcs, f_aliases):
                        if x.semantic_equals(f):
                            return al.to_attribute()
                for g, a in g_aliases:
                    if x.semantic_equals(g):
                        return a
                return x

            outs = []
            for e in node.aggregate_exprs:
                if isinstance(e, Alias):
                    outs.append(Alias(e.child.transform_up(fix), e.name,
                                      e.expr_id))
                elif isinstance(e, AttributeReference):
                    outs.append(fix(e))
                else:
                    outs.append(e.transform_up(fix))
            return Project(outs, inner)

        return plan.transform_up(rule)


class ExtractWindowExpressions(Rule):
    """Pull WindowExpressions out of projections into Window operators.
    Expressions sharing a (partition, order) spec evaluate in one Window
    node; distinct specs chain."""

    def apply(self, plan):
        def rule(node):
            if not isinstance(node, Project) or not node.expressions_resolved:
                return node
            if not any(isinstance(x, WindowExpression)
                       for e in node.project_list for x in e.iter_nodes()):
                return node

            collected: list[Alias] = []

            def extract(x: Expression) -> Expression:
                if isinstance(x, WindowExpression):
                    al = Alias(x, f"_we{len(collected)}")
                    collected.append(al)
                    return al.to_attribute()
                return x

            new_list: list[Expression] = []
            for e in node.project_list:
                if isinstance(e, Alias):
                    if isinstance(e.child, WindowExpression):
                        collected.append(e)
                        new_list.append(e.to_attribute())
                        continue
                    new_list.append(
                        Alias(e.child.transform_up(extract), e.name,
                              e.expr_id))
                else:
                    new_list.append(e.transform_up(extract))

            groups: dict = {}
            order: list = []
            for al in collected:
                sig = al.child.spec_signature()
                if sig not in groups:
                    groups[sig] = []
                    order.append(sig)
                groups[sig].append(al)

            child = node.child
            for sig in order:
                exprs = groups[sig]
                w0 = exprs[0].child
                child = Window(exprs, list(w0.partition_spec),
                               list(w0.order_spec), child)
            return Project(new_list, child)

        return plan.transform_up(rule)


class FoldIntervalArithmetic(Rule):
    """Interval-interval and interval-number arithmetic folds to one
    IntervalLiteral: interval values are born as literals, so the algebra
    closes at analysis time and date +/- sees a single interval."""

    def apply(self, plan):
        def num(e):
            return e.value if isinstance(e, Literal) and \
                isinstance(e.value, (int, float)) and \
                not isinstance(e.value, bool) else None

        def fold(e):
            if isinstance(e, UnaryMinus) and isinstance(e.child,
                                                        IntervalLiteral):
                return e.child.negated()
            if isinstance(e, (Add, Subtract)) and \
                    isinstance(e.left, IntervalLiteral) and \
                    isinstance(e.right, IntervalLiteral):
                r = e.right if isinstance(e, Add) else e.right.negated()
                return IntervalLiteral(e.left.months + r.months,
                                       e.left.days + r.days,
                                       e.left.micros + r.micros)
            if isinstance(e, Multiply):
                iv, n = (e.left, num(e.right)) \
                    if isinstance(e.left, IntervalLiteral) \
                    else (e.right, num(e.left))
                if isinstance(iv, IntervalLiteral) and n is not None:
                    return IntervalLiteral(int(iv.months * n),
                                           int(iv.days * n),
                                           int(iv.micros * n))
            if isinstance(e, Divide) and isinstance(e.left, IntervalLiteral):
                n = num(e.right)
                if n:
                    # day fractions spill into micros; calendar months
                    # stay integral
                    days_f = e.left.days / n
                    days = int(days_f)
                    micros = int(e.left.micros / n
                                 + (days_f - days) * 86_400_000_000)
                    return IntervalLiteral(int(e.left.months / n), days,
                                           micros)
            return e

        def rule(node):
            return node.transform_expressions(
                lambda x: x.transform_up(fold))

        return plan.transform_up(rule)


class CoerceDecimalArithmetic(Rule):
    """Align decimal scales in Add/Subtract (the device value is a scaled
    int64, so both sides must share the scale)."""

    def apply(self, plan):
        def fix(e: Expression) -> Expression:
            if isinstance(e, (Add, Subtract)) and e.left.resolved \
                    and e.right.resolved \
                    and not isinstance(e.left, IntervalLiteral) \
                    and not isinstance(e.right, IntervalLiteral):
                lt, rt = e.left.dtype, e.right.dtype
                if isinstance(lt, DecimalType) and isinstance(rt, DecimalType) \
                        and lt.scale != rt.scale:
                    ct = common_type(lt, rt)
                    return type(e)(cast_if(e.left, ct), cast_if(e.right, ct))
            return e

        def rule(node):
            if node.expressions_resolved:
                return node.transform_expressions(fix)
            return node

        return plan.transform_up(rule)


class WidenSetOperationTypes(Rule):
    """Positionally coerce Union/Intersect/Except branches to common types
    (a branch whose
    column type differs gets a casting Project; the first branch keeps its
    output ids, which name the union's output)."""

    def apply(self, plan):
        def widen(children: list[LogicalPlan]) -> list[LogicalPlan] | None:
            outs = [c.output for c in children]
            n = len(outs[0])
            if any(len(o) != n for o in outs):
                raise AnalysisException(
                    "set operation branches have different column counts",
                    error_class="NUM_COLUMNS_MISMATCH")
            targets = []
            for i in range(n):
                t = outs[0][i].dtype
                for o in outs[1:]:
                    ct = common_type(t, o[i].dtype)
                    if ct is None:
                        raise AnalysisException(
                            f"incompatible set-op column types: "
                            f"{t.simple_string()} vs "
                            f"{o[i].dtype.simple_string()}")
                    t = ct
                targets.append(t)
            changed = False
            new_children = []
            for ci, (c, o) in enumerate(zip(children, outs)):
                if all(a.dtype == t for a, t in zip(o, targets)):
                    new_children.append(c)
                    continue
                projs: list[Expression] = []
                for a, t in zip(o, targets):
                    if a.dtype == t:
                        projs.append(a)
                    else:
                        keep = a.expr_id if ci == 0 else None
                        projs.append(Alias(cast_if(a, t), a.name,
                                           expr_id=keep))
                new_children.append(Project(projs, c))
                changed = True
            return new_children if changed else None

        def rule(node):
            if isinstance(node, Union) and node.resolved:
                nc = widen(node.children_plans)
                if nc is not None:
                    return Union(nc)
            if isinstance(node, (Intersect, Except)) and node.resolved:
                nc = widen([node.left, node.right])
                if nc is not None:
                    return node.copy(left=nc[0], right=nc[1])
            return node

        return plan.transform_up(rule)


class CheckAnalysis(Rule):
    def apply(self, plan):
        from .subquery import ScalarSubquery, SubqueryExpression

        def check(node):
            for e in node.expressions():
                for sub in e.iter_nodes():
                    if isinstance(sub, SubqueryExpression):
                        if isinstance(sub, ScalarSubquery) and \
                                len(sub.plan.output) != 1:
                            raise AnalysisException(
                                "scalar subquery must return one column")
                        self.apply(sub.plan)
                        continue
                    if isinstance(sub, UnresolvedAttribute):
                        cands = [a.name for a in node.input_attrs()]
                        close = difflib.get_close_matches(sub.name, cands, 3)
                        raise UnresolvedColumnError(sub.name, close or cands[:5])
                    if isinstance(sub, UnresolvedFunction):
                        raise AnalysisException(
                            f"unresolved function {sub.fname}")
                    if isinstance(sub, UnresolvedStar):
                        raise AnalysisException("unexpected * in expression")
            if isinstance(node, UnresolvedRelation):
                raise AnalysisException(f"unresolved relation {node.name}")
            if isinstance(node, Aggregate) and node.resolved:
                grouping_ids = {g.expr_id for g in node.grouping_exprs
                                if isinstance(g, AttributeReference)}
                for e in node.aggregate_exprs:
                    _check_agg_expr(e, grouping_ids, node)
            return None

        plan.foreach(check)
        return plan


def _check_agg_expr(e: Expression, grouping_ids: set[int], agg: Aggregate):
    def matches_grouping(x: Expression) -> bool:
        for g in agg.grouping_exprs:
            gc = g.child if isinstance(g, Alias) else g
            if x.semantic_equals(g) or x.semantic_equals(gc):
                return True
        return False

    def ok(x: Expression, inside_agg: bool) -> bool:
        if not inside_agg and matches_grouping(x):
            return True
        if isinstance(x, AggregateFunction):
            return all(ok(c, True) for c in x.children)
        if isinstance(x, AttributeReference) and not inside_agg:
            if x.expr_id not in grouping_ids:
                raise AnalysisException(
                    f"column {x.name} is neither grouped nor aggregated",
                    error_class="MISSING_AGGREGATION")
            return True
        return all(ok(c, inside_agg) for c in x.children)

    ok(e.child if isinstance(e, Alias) else e, False)


class Analyzer(RuleExecutor):
    def __init__(self, catalog: Catalog | None = None,
                 case_sensitive: bool = False):
        super().__init__()
        self.catalog = catalog if catalog is not None else Catalog()
        self.case_sensitive = case_sensitive

    def batches(self):
        cs = self.case_sensitive
        return [
            Batch("Resolution", FixedPoint(50), [
                ResolveRelations(self.catalog),
                DeduplicateRelations(),
                ResolveUsingJoin(cs),
                ResolveReferences(cs),
                ResolveGroupByAlias(cs),
                ResolveSubqueries(self),
                GlobalAggregates(),
                ResolveAggsInSortHaving(cs),
                ResolveSortHiddenRefs(cs),
                # after the HAVING/ORDER rules: a column reachable through
                # the aggregate's child must win over a session variable
                ResolveSessionVariables(self.catalog),
                ExtractGenerators(),
                ExtractWindowFromAggregate(),
                ExtractWindowExpressions(),
                FoldIntervalArithmetic(),
                ResolveAliases(),
            ]),
            Batch("Coercion", FixedPoint(10), [
                CoerceDecimalArithmetic(),
                WidenSetOperationTypes(),
            ]),
            Batch("Check", Once(), [CheckAnalysis()]),
        ]

    def execute_subquery(self, plan: LogicalPlan,
                         outer: Sequence[AttributeReference]) -> LogicalPlan:
        """Resolve a subquery plan; column references it cannot resolve in
        its own scope resolve against the outer scope (correlation).
        Relations resolved inside the subquery get fresh attribute ids
        where they collide with the outer scope's."""
        cs = self.case_sensitive
        outer_ids = {a.expr_id for a in outer}
        rules = [
            _ResolveRelationsDedup(self.catalog, outer_ids),
            DeduplicateRelations(),
            ResolveReferences(cs),
            ResolveGroupByAlias(cs),
            # no ResolveSessionVariables: inside a subquery a bare name
            # resolves to an inner column, then an outer one (a
            # correlation), then a variable (node_fix below)
            ResolveSubqueries(self),
            GlobalAggregates(),
            ResolveAggsInSortHaving(cs),
            ResolveSortHiddenRefs(cs),
            ExtractGenerators(),
            ExtractWindowFromAggregate(),
            ExtractWindowExpressions(),
            ResolveAliases(),
        ]
        cur = plan
        for _ in range(50):
            before = cur
            for rule in rules:
                cur = rule(cur)

            # leftovers: the inner scope first (SQL shadowing), then the
            # outer scope (correlation)
            def node_fix(n):
                if not all(c.resolved for c in n.children):
                    return n
                try:
                    inputs = n.input_attrs()
                except AnalysisException:
                    return n

                def fix(e):
                    if isinstance(e, UnresolvedAttribute):
                        a = _resolve_name(e.name_parts, inputs, cs)
                        if a is not None:
                            return a
                        a = _resolve_name(e.name_parts, outer, cs)
                        if a is not None:
                            return a
                        if len(e.name_parts) == 1:
                            hit = self.catalog.variables.get(
                                e.name_parts[0].lower())
                            if hit is not None:
                                return hit
                    return e

                return n.transform_expressions(fix)

            cur = cur.transform_up(node_fix)
            if cur.fast_equals(before):
                break
        return CoerceDecimalArithmetic()(cur)
