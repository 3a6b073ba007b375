"""Query execution pipeline (counterpart of
`spark_tpu/exec/query_execution.py`, the subset that plans, executes and
collects): analyzed -> optimized -> physical -> execute (through the stage
scheduler, exec/scheduler.py) -> Arrow. The
optimized plan's uncorrelated scalar subqueries run first, once each, and
become literals. The compile-tier decision (`TierDecision`, `choose_tier`)
lives in physical/whole_query.py, as in the reference; the planner makes it
last and stashes it on the plan's root, and `explain_string` shows it
beside the plans."""

from __future__ import annotations

from functools import cached_property

import pyarrow as pa

from ..physical.operators import PhysicalPlan, attrs_schema
from ..physical.whole_query import TierDecision, choose_tier  # noqa: F401
from ..plan.logical import LogicalPlan


class QueryExecution:
    def __init__(self, session, logical: LogicalPlan):
        self.session = session
        self.logical = logical

    @cached_property
    def analyzed(self) -> LogicalPlan:
        return self.session._analyzer.execute(self.logical)

    @cached_property
    def optimized(self) -> LogicalPlan:
        plan = self.session._optimizer.execute(self.analyzed)
        return self._materialize_scalar_subqueries(plan)

    def _materialize_scalar_subqueries(self, plan: LogicalPlan
                                       ) -> LogicalPlan:
        """Run each remaining (uncorrelated) scalar subquery once, collect
        it and substitute a literal: NULL for no row, an error for more
        than one."""
        from ..errors import ExecutionError
        from ..expr.expressions import Literal
        from ..plan.subquery import ScalarSubquery

        if not any(isinstance(x, ScalarSubquery)
                   for n in plan.iter_nodes()
                   for e in n.expressions()
                   for x in e.iter_nodes()):
            return plan

        def fix_expr(e):
            if isinstance(e, ScalarSubquery):
                table = QueryExecution(self.session, e.plan).to_arrow()
                self.session._metrics.add("subquery.scalar")
                if table.num_rows > 1:
                    raise ExecutionError(
                        "scalar subquery returned more than one row")
                value = table.column(0)[0].as_py() if table.num_rows \
                    else None
                return Literal(value, e.dtype)
            return e

        return plan.transform_up(
            lambda node: node.transform_expressions(fix_expr))

    @cached_property
    def physical(self) -> PhysicalPlan:
        return self.session._planner().plan(self.optimized)

    @property
    def tier_decision(self) -> TierDecision:
        return self.physical._tier_decision

    def explain_string(self, mode: str = "formatted") -> str:
        from ..errors import NotPortedError

        if mode not in ("formatted", "simple", "extended"):
            raise NotPortedError(f"explain mode {mode!r}")
        d = self.tier_decision
        parts = [
            "== Analyzed Logical Plan ==", self.analyzed.tree_string(),
            "== Optimized Logical Plan ==", self.optimized.tree_string(),
            "== Physical Plan ==", self.physical.tree_string(),
            "== Compile Tier ==", f"{d.tier} ({d.reason})",
        ]
        if d.details:
            parts.append(f"details: {d.details}")
        if mode == "simple":
            parts = parts[4:]
        return "\n".join(parts)

    def execute(self) -> list:
        """Run the physical plan through the stage scheduler (cut at the
        exchanges, adaptive re-planning between stages); returns
        partitions of device batches."""
        from .scheduler import DAGScheduler

        return DAGScheduler(self.session._exec_context()).run(self.physical)

    def to_arrow(self) -> pa.Table:
        from ..columnar.arrow import batches_to_table
        from ..columnar.batch import ColumnarBatch

        batches = [b for p in self.execute() for b in p]
        if not batches:
            batches = [ColumnarBatch.empty(attrs_schema(self.physical.output),
                                           self.session.device)]
        return batches_to_table(batches)
