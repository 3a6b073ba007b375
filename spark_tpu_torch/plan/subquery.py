"""Subquery expressions and decorrelation (counterpart of
`spark_tpu/plan/subquery.py`): the expressions ScalarSubquery, InSubquery
and Exists, and the optimizer rewrites that turn them into joins:
RewritePredicateSubquery (IN/EXISTS conjuncts of a filter -> left
semi/anti joins; IN/EXISTS under OR -> a left-outer existence join and a
flag), RewriteExistenceSubquery (IN/EXISTS as a value
-> the same existence join) and RewriteCorrelatedScalarSubquery (an
equality-correlated aggregate -> a left-outer join against the aggregate
regrouped by the correlation keys). An uncorrelated scalar subquery runs
once before the query and becomes a literal
(`exec/query_execution.py`). A null-aware NOT IN over nullable sides yields
an anti join with an `OR ... IS NULL` residual, an uncorrelated EXISTS a
semi join on a constant, and a correlation by a predicate other than
equality a join with a non-equi condition: the planner makes each a
NestedLoopJoinExec.
"""

from __future__ import annotations

from typing import Sequence

from ..errors import UnsupportedOperationError
from ..expr.expressions import (
    Alias, And, AttributeReference, EqualTo, Expression, IsNotNull, IsNull,
    Literal, Not, Or,
)
from .logical import Aggregate, Filter, Join, Limit, LogicalPlan, Project
from .tree import Rule

__all__ = ["ScalarSubquery", "InSubquery", "Exists",
           "RewritePredicateSubquery", "split_correlation"]


class SubqueryExpression(Expression):
    child_fields = ()

    def __init__(self, plan: LogicalPlan):
        self.plan = plan

    @property
    def resolved(self):
        # plan resolution happens in the analyzer rule ResolveSubqueries
        return self.plan.resolved

    def _data_args(self):
        return (("plan_id", id(self.plan)),)


class ScalarSubquery(SubqueryExpression):
    """(SELECT single_value ...) used as an expression."""

    @property
    def dtype(self):
        return self.plan.output[0].dtype

    @property
    def nullable(self):
        return True

    def simple_string(self):
        return "scalar-subquery(...)"


class InSubquery(SubqueryExpression):
    """x IN (SELECT col ...)"""

    def __init__(self, value: Expression, plan: LogicalPlan):
        self.value = value
        self.plan = plan

    child_fields = ("value",)

    @property
    def dtype(self):
        from ..types import boolean

        return boolean

    def simple_string(self):
        return f"{self.value.simple_string()} IN (subquery)"


class Exists(SubqueryExpression):
    @property
    def dtype(self):
        from ..types import boolean

        return boolean

    @property
    def nullable(self):
        return False

    def simple_string(self):
        return "EXISTS(subquery)"


def iter_plans(plan: LogicalPlan):
    """The plan, then the plans of its subquery expressions, nested ones
    too (depth first)."""
    yield plan
    for node in plan.iter_nodes():
        for e in node.expressions():
            for x in e.iter_nodes():
                if isinstance(x, SubqueryExpression):
                    yield from iter_plans(x.plan)


def map_subquery_plans(node: LogicalPlan, fn) -> LogicalPlan:
    """`node` with `fn` applied to the plan of each subquery expression
    among its own expressions (`fn` recurses for nested ones)."""
    def fix(ex):
        if isinstance(ex, SubqueryExpression):
            p = fn(ex.plan)
            if p is not ex.plan:
                return ex.copy(plan=p)
        return ex

    return node.map_expressions(lambda e: e.transform_up(fix))


# ---------------------------------------------------------------------------
# Correlation analysis
# ---------------------------------------------------------------------------

def split_correlation(subplan: LogicalPlan, outer_ids: set[int],
                      with_residuals: bool = False):
    """Pull correlated predicates out of the subquery (the reference's
    pullOutCorrelatedPredicates). Returns
    (decorrelated_plan, [(outer_expr, inner_attr)], residuals, ok):
    `outer = inner` conjuncts become join pairs; with_residuals=True also
    pulls arbitrary correlated conjuncts (e.g. `outer.w <> inner.w`, the
    TPC-DS q16/q94 shape) to be re-applied as join-condition residuals."""
    from .optimizer import join_conjuncts, split_conjuncts

    from .logical import Union

    pairs: list[tuple[Expression, Expression]] = []
    residuals: list[Expression] = []
    failed = [False]

    def _sensitive(n: LogicalPlan) -> bool:
        return isinstance(n, (Aggregate, Limit, Union)) or (
            isinstance(n, Join) and n.join_type not in ("inner", "cross"))

    def go(node: LogicalPlan, crossed: bool) -> LogicalPlan:
        # `crossed`: a row-count-sensitive operator lies between this node
        # and the subquery root. A residual stripped from below one would
        # re-apply at the join AFTER that operator changed what it sees
        # (an Aggregate aggregating rows the residual should have
        # excluded, a Limit selecting from unfiltered input, ...) — only
        # sound when crossed is False.
        child_crossed = crossed or _sensitive(node)
        node = node.map_children(lambda c: go(c, child_crossed))
        if isinstance(node, Filter):
            keep = []
            for c in split_conjuncts(node.condition):
                refs = c.references()
                outer_refs = refs & outer_ids
                if not outer_refs:
                    keep.append(c)
                    continue
                if isinstance(c, EqualTo):
                    lr = c.left.references()
                    rr = c.right.references()
                    if lr <= outer_ids and not (rr & outer_ids):
                        pairs.append((c.left, c.right))
                        continue
                    if rr <= outer_ids and not (lr & outer_ids):
                        pairs.append((c.right, c.left))
                        continue
                if with_residuals and not crossed:
                    residuals.append(c)
                    continue
                failed[0] = True
                keep.append(c)
            cond = join_conjuncts(keep)
            if cond is None:
                return node.child
            if len(keep) != len(split_conjuncts(node.condition)):
                return Filter(cond, node.child)
        return node

    out = go(subplan, False)
    # any remaining outer references → unsupported correlation
    for n in out.iter_nodes():
        for e in n.expressions():
            if e.references() & outer_ids:
                failed[0] = True
    return out, pairs, residuals, not failed[0]


# ---------------------------------------------------------------------------
# Predicate subquery rewrite (Filter conditions only, like the reference)
# ---------------------------------------------------------------------------

class RewritePredicateSubquery(Rule):
    """EXISTS/IN in WHERE → left_semi / left_anti joins
    (reference: sqlcat/optimizer/subquery.scala RewritePredicateSubquery)."""

    def apply(self, plan):
        from .optimizer import join_conjuncts, split_conjuncts

        def rule(node):
            if not isinstance(node, Filter):
                return node
            has_sub = any(isinstance(x, (InSubquery, Exists))
                          for x in node.condition.iter_nodes())
            if not has_sub:
                return node

            outer_ids = {a.expr_id for a in node.child.output}
            base = node.child
            kept: list[Expression] = []
            for conj in split_conjuncts(node.condition):
                base, handled = self._rewrite_one(conj, base, outer_ids)
                if not handled:
                    kept.append(conj)
            if kept:
                # EXISTS/IN under OR (not a top-level conjunct): lower each
                # to an existence-join boolean flag (reference plans these
                # as ExistenceJoin) — the TPC-DS q10/q35 shape
                # `exists(...) and (exists(...) or exists(...))`
                new_kept = []
                for conj in kept:
                    while True:
                        target = next(
                            (x for x in conj.iter_nodes()
                             if isinstance(x, (InSubquery, Exists))), None)
                        if target is None:
                            break
                        base, rep = _existence_flag(target, base, outer_ids)

                        def replace(x, _t=target, _r=rep):
                            return _r if x is _t else x

                        conj = conj.transform_up(replace)
                    new_kept.append(conj)
                return Filter(join_conjuncts(new_kept), base)
            return base

        return plan.transform_up(rule)

    def _rewrite_one(self, conj: Expression, base: LogicalPlan,
                     outer_ids: set[int]):
        neg = False
        e = conj
        if isinstance(e, Not):
            inner = e.child
            if isinstance(inner, (InSubquery, Exists)):
                neg = True
                e = inner
        if isinstance(e, InSubquery):
            sub, pairs, residuals, ok = split_correlation(
                e.plan, outer_ids, with_residuals=True)
            if not ok:
                raise UnsupportedOperationError(
                    "unsupported correlated IN subquery")
            sub, pairs, residuals = _refresh_lowered(sub, pairs, residuals)
            value_attr = sub.output[0]
            sub = _expose_correlation_keys(sub, pairs, residuals,
                                           outer_ids)
            eq: Expression = EqualTo(e.value, value_attr)
            if neg and (e.value.nullable or value_attr.nullable):
                # null-aware anti join (reference: subquery.scala
                # RewritePredicateSubquery null-aware path): a NULL on
                # either side makes NOT IN unknown, so "eq OR eq IS NULL"
                # counts as a match and the row is anti-filtered
                eq = Or(eq, IsNull(eq))
            cond: Expression = eq
            for outer_e, inner_e in pairs:
                cond = And(cond, EqualTo(outer_e, inner_e))
            for r in residuals:
                cond = And(cond, r)
            jt = "left_anti" if neg else "left_semi"
            return Join(base, sub, jt, cond), True
        if isinstance(e, Exists):
            sub, pairs, residuals, ok = split_correlation(
                e.plan, outer_ids, with_residuals=True)
            if not ok:
                raise UnsupportedOperationError(
                    "unsupported correlated EXISTS subquery")
            sub, pairs, residuals = _refresh_lowered(sub, pairs, residuals)
            if pairs or residuals:
                sub = _expose_correlation_keys(sub, pairs, residuals,
                                               outer_ids)
                cond = None
                for outer_e, inner_e in pairs:
                    c = EqualTo(outer_e, inner_e)
                    cond = c if cond is None else And(cond, c)
                for r in residuals:
                    cond = r if cond is None else And(cond, r)
            else:
                # uncorrelated EXISTS: constant-key semi join
                one = Alias(Literal(1), "__one")
                sub = Project([one], sub)
                cond = EqualTo(Literal(1), sub.output[0])
            jt = "left_anti" if neg else "left_semi"
            return Join(base, sub, jt, cond), True
        return base, False


def _refresh_lowered(sub, pairs, residuals):
    """Fresh ids for a subquery plan about to be spliced as a join side
    (the same view lowered twice in one WHERE — or shared with the outer
    query — must not alias already-spliced ids; see _fresh_plan).
    Correlation pairs keep their OUTER side; inner sides and residuals
    remap to the fresh ids. Residuals' outer references are untouched
    (they are not produced by `sub`, so never in the mapping)."""
    fm: dict = {}
    sub = _fresh_plan(sub, fm)

    def remap(e):
        return e.transform_up(
            lambda x: fm.get(x.expr_id, x)
            if isinstance(x, AttributeReference) else x)

    pairs = [(oe, remap(ie)) for oe, ie in pairs]
    residuals = [remap(r) for r in residuals]
    return sub, pairs, residuals


def _expose_correlation_keys(
        sub: LogicalPlan,
        pairs: Sequence[tuple[Expression, Expression]],
        residuals: Sequence[Expression] = (),
        outer_ids: set[int] | None = None) -> LogicalPlan:
    """Rewrite the decorrelated subplan so the inner key attributes appear
    in its output. An aggregate regains them as GROUPING keys (turning a
    per-outer-row aggregate into a grouped one — the decorrelation core);
    a projection just widens. Residual predicates' inner attributes are
    exposed the same way."""
    keys: list[AttributeReference] = []
    for _, ie in pairs:
        if not isinstance(ie, AttributeReference):
            raise UnsupportedOperationError(
                "correlated predicate must compare to a plain subquery column")
        keys.append(ie)
    for r in residuals:
        for x in r.iter_nodes():
            if isinstance(x, AttributeReference) and \
                    (outer_ids is None or x.expr_id not in outer_ids) and \
                    not any(x.expr_id == k.expr_id for k in keys):
                keys.append(x)
    out_ids = {a.expr_id for a in sub.output}
    missing = [k for k in keys if k.expr_id not in out_ids]
    if not missing:
        return sub
    if isinstance(sub, Aggregate):
        child_ids = {a.expr_id for a in sub.child.output}
        if all(k.expr_id in child_ids for k in missing):
            return Aggregate(
                list(sub.grouping_exprs) + missing,
                list(missing) + list(sub.aggregate_exprs),
                sub.child)
    if isinstance(sub, Project):
        child_ids = {a.expr_id for a in sub.child.output}
        if all(k.expr_id in child_ids for k in missing):
            return Project(list(sub.project_list) + missing, sub.child)
    raise UnsupportedOperationError(
        "correlated key is not reachable from the subquery output")


def _fresh_plan(plan: LogicalPlan, mapping: dict | None = None):
    """Deep-copy a RESOLVED plan with fresh expression ids everywhere —
    relations re-instanced, aliases re-minted, references remapped — so
    the copy can coexist with the original in one tree (or be embedded
    as an independent subquery) without id collisions."""
    from ..expr.expressions import Alias as _Alias
    from .logical import LocalRelation, LogicalRelation, RangeRelation

    mapping = {} if mapping is None else mapping

    def fix_expr(e):
        if isinstance(e, SubqueryExpression):
            return e.copy(plan=_fresh_plan(e.plan, mapping))
        if isinstance(e, _Alias):
            na = _Alias(e.child, e.name)  # new expr_id
            mapping[e.expr_id] = na.to_attribute()
            return na
        if isinstance(e, AttributeReference) and e.expr_id in mapping:
            return mapping[e.expr_id]
        return e

    def go(node):
        node = node.map_children(go)
        if isinstance(node, (LogicalRelation, LocalRelation)):
            new_attrs = []
            for a in node.attrs:
                na = mapping.get(a.expr_id)
                if na is None:
                    na = a.new_instance()
                    mapping[a.expr_id] = na
                new_attrs.append(na)
            node = node.copy(attrs=new_attrs)
        elif isinstance(node, RangeRelation):
            na = mapping.get(node.attr.expr_id)
            if na is None:  # one fresh id per old id (union-branch shape)
                na = node.attr.new_instance()
                mapping[node.attr.expr_id] = na
            node = node.copy(attr=na)
        return node.map_expressions(lambda ex: ex.transform_up(fix_expr))

    return go(plan)


def _existence_flag(target, child: LogicalPlan, outer_ids: set[int]):
    """Lower one IN/EXISTS expression to a left_outer "existence join"
    producing a boolean flag over `child` (reference: sqlcat
    ExistenceJoin). Returns (joined_plan, replacement_expression).
    Both uncorrelated AND equality-correlated IN carry full three-valued
    null semantics: unmatched + (NULL probe over a non-empty set, or a
    NULL among the set's values) → NULL, matching the reference's
    null-aware join (sqlcat/optimizer/subquery.scala)."""
    sub, pairs, _res, ok = split_correlation(target.plan, outer_ids)
    if not ok:
        raise UnsupportedOperationError(
            "unsupported correlated subquery in value position")
    # fresh ids for the spliced subtree: the same view lowered twice in
    # one SELECT (or appearing in both the outer query and the subquery)
    # must not alias the ids the previous lowering already spliced in
    sub, pairs, _ = _refresh_lowered(sub, pairs, [])
    flag = Alias(Literal(True), "__exists")
    cond = None
    null_case = None  # three-valued IN: unmatched + nulls present → NULL
    corr_probe = None  # correlated IN: per-key has-null probe join
    if isinstance(target, InSubquery):
        from ..expr.expressions import CaseWhen, Max

        value_attr = sub.output[0]
        if not pairs:
            # x IN (sub) with no match is NULL — not false — when x is
            # NULL or the subquery contains a NULL (reference: In's
            # null semantics). The has-null probe is an uncorrelated
            # scalar subquery over the SAME plan; it materializes in its
            # own QueryExecution so sharing the subtree is safe.
            hn_map: dict = {}
            sub_copy = _fresh_plan(sub, hn_map)
            hn_value = hn_map.get(value_attr.expr_id, value_attr)
            # one probe, three states: NULL = subquery empty, 1 = has a
            # NULL value, 0 = non-empty all non-null. IN over an EMPTY
            # set is false even for a NULL probe (reference In.eval).
            probe = ScalarSubquery(Aggregate([], [Alias(Max(CaseWhen(
                [(IsNull(hn_value), Literal(1))], Literal(0))),
                "__has_null")], sub_copy))
            null_case = Or(EqualTo(probe, Literal(1)),
                           And(IsNull(target.value), IsNotNull(probe)))
        else:
            # CORRELATED x IN (subq): same three states, but per
            # correlation key — a grouped left_outer probe join whose
            # has-null column is NULL when this outer row's set is
            # empty, 1 when it contains a NULL, 0 otherwise (the
            # reference's null-aware ExistenceJoin semantics,
            # sqlcat/optimizer/subquery.scala)
            hn_map = {}
            sub_copy = _fresh_plan(sub, hn_map)
            hn_value = hn_map.get(value_attr.expr_id, value_attr)
            ie_copies = []
            pairs_copy = []
            for oe, ie in pairs:
                ic = hn_map.get(ie.expr_id, ie)
                ie_copies.append(ic)
                pairs_copy.append((oe, ic))
            sub_copy = _expose_correlation_keys(sub_copy, pairs_copy)
            hn_alias = Alias(Max(CaseWhen(
                [(IsNull(hn_value), Literal(1))], Literal(0))),
                "__has_null")
            probe_plan = Aggregate(list(ie_copies),
                                   list(ie_copies) + [hn_alias], sub_copy)
            cond2 = None
            for oe, ic in pairs_copy:
                c = EqualTo(oe, ic)
                cond2 = c if cond2 is None else And(cond2, c)
            corr_probe = (probe_plan, cond2, probe_plan.output[-1])
        sub = _expose_correlation_keys(sub, pairs)
        keys = [value_attr] + [ie for _, ie in pairs]
        dsub = Aggregate(list(keys), list(keys) + [flag], sub)
        cond = EqualTo(target.value, value_attr)
        for outer_e, ie in pairs:
            cond = And(cond, EqualTo(outer_e, ie))
    elif pairs:
        sub = _expose_correlation_keys(sub, pairs)
        keys = [ie for _, ie in pairs]
        dsub = Aggregate(list(keys), list(keys) + [flag], sub)
        for outer_e, ie in pairs:
            c = EqualTo(outer_e, ie)
            cond = c if cond is None else And(cond, c)
    else:
        # uncorrelated EXISTS: 0/1-row flag relation, cross-style
        # left_outer (condition-less nested loop)
        dsub = Project([flag], Limit(1, sub))
    flag_attr = dsub.output[-1]
    joined = Join(child, dsub, "left_outer", cond)
    if corr_probe is not None:
        probe_plan, cond2, hn_attr = corr_probe
        joined = Join(joined, probe_plan, "left_outer", cond2)
        null_case = Or(EqualTo(hn_attr, Literal(1)),
                       And(IsNull(target.value), IsNotNull(hn_attr)))
    rep = IsNotNull(flag_attr)
    if null_case is not None:
        from ..expr.expressions import CaseWhen
        from ..types import boolean

        rep = CaseWhen([(rep, Literal(True)),
                        (null_case, Literal(None, boolean))],
                       Literal(False))
    return joined, rep


class RewriteExistenceSubquery(Rule):
    """IN/EXISTS used as a VALUE (inside a projection) → existence join
    (reference: sqlcat ExistenceJoin planned by RewritePredicateSubquery
    when the predicate is not a top-level Filter conjunct)."""

    def apply(self, plan):
        def rule(node):
            if not isinstance(node, Project):
                return node
            target = None
            for e in node.project_list:
                for x in e.iter_nodes():
                    if isinstance(x, (InSubquery, Exists)):
                        target = x
                        break
                if target is not None:
                    break
            if target is None:
                return node
            outer_ids = {a.expr_id for a in node.child.output}
            joined, rep = _existence_flag(target, node.child, outer_ids)

            def replace(x: Expression) -> Expression:
                return rep if x is target else x

            new_node = node.map_expressions(
                lambda e: e.transform_up(replace))
            return new_node.copy(child=joined)

        return plan.transform_up(rule)


class RewriteCorrelatedScalarSubquery(Rule):
    """Equality-correlated scalar subqueries with a top aggregate →
    left_outer join against the grouped aggregate (reference:
    sqlcat/optimizer/subquery.scala RewriteCorrelatedScalarSubquery —
    the TPC-DS q1/q6 shape:
    `x > (SELECT avg(y) FROM t WHERE t.k = outer.k)`)."""

    def apply(self, plan):
        def rule(node):
            if not isinstance(node, (Filter, Project)):
                return node
            subs = [x for e in node.expressions()
                    for x in e.iter_nodes()
                    if isinstance(x, ScalarSubquery)]
            corr = None
            outer_ids = {a.expr_id for a in node.child.output} \
                if node.children else set()
            for s in subs:
                if any(e2.references() & outer_ids
                       for n2 in s.plan.iter_nodes()
                       for e2 in n2.expressions()):
                    corr = s
                    break
            if corr is None:
                return node

            sub, pairs, _res, ok = split_correlation(corr.plan, outer_ids)
            if not ok or not pairs:
                raise UnsupportedOperationError(
                    "unsupported correlated scalar subquery (only equality "
                    "correlation is supported)")
            if not isinstance(sub, Aggregate) or sub.grouping_exprs:
                raise UnsupportedOperationError(
                    "correlated scalar subquery must be a simple aggregate")
            inner_keys: list[AttributeReference] = []
            for _, ie in pairs:
                if not isinstance(ie, AttributeReference):
                    raise UnsupportedOperationError(
                        "correlated key must be a plain column")
                inner_keys.append(ie)
            # regroup the aggregate by the correlation keys
            regrouped = Aggregate(
                list(inner_keys),
                list(inner_keys) + list(sub.aggregate_exprs),
                sub.child)
            value_attr = regrouped.output[len(inner_keys)]

            cond = None
            for (outer_e, _), ik in zip(pairs, inner_keys):
                c = EqualTo(outer_e, ik)
                cond = c if cond is None else And(cond, c)
            joined = Join(node.child, regrouped, "left_outer", cond)

            def replace(x: Expression) -> Expression:
                if x is corr:
                    return value_attr
                return x

            new_node = node.map_expressions(
                lambda e: e.transform_up(replace))
            new_node = new_node.copy(child=joined)
            if isinstance(new_node, Project):
                return new_node
            # the join widened a Filter's schema; restore the original output
            return Project(list(node.output), new_node)

        return plan.transform_up(rule)


