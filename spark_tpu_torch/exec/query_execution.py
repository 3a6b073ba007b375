"""Query execution pipeline (counterpart of
`spark_tpu/exec/query_execution.py`, the subset that plans, executes and
collects): analyzed -> optimized -> physical -> execute -> Arrow."""

from __future__ import annotations

from functools import cached_property

import pyarrow as pa

from ..physical.operators import PhysicalPlan, attrs_schema
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
        return self.session._optimizer.execute(self.analyzed)

    @cached_property
    def physical(self) -> PhysicalPlan:
        return self.session._planner().plan(self.optimized)

    def execute(self) -> list:
        """Run the physical plan; returns partitions of device batches."""
        return self.physical.execute(self.session._exec_context())

    def to_arrow(self) -> pa.Table:
        from ..columnar.arrow import batches_to_table
        from ..columnar.batch import ColumnarBatch

        batches = [b for p in self.execute() for b in p]
        if not batches:
            batches = [ColumnarBatch.empty(attrs_schema(self.physical.output),
                                           self.session.device)]
        return batches_to_table(batches)
