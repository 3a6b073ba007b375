"""Exchange operator (counterpart of `spark_tpu/physical/exchange.py`):
`ShuffleExchangeExec` for hash, round-robin and single-partition
distributions. Range partitioning, broadcast and the fused, mesh and
runtime-filter variants are not ported."""

from __future__ import annotations

from ..errors import NotPortedError
from ..exec import shuffle as S
from ..exec.context import ExecContext
from ..expr.expressions import AttributeReference
from .operators import PhysicalPlan, attrs_schema
from .partitioning import (
    HashPartitioning, Partitioning, SinglePartition, UnknownPartitioning,
)


class ShuffleExchangeExec(PhysicalPlan):
    child_fields = ("child",)

    def __init__(self, partitioning: Partitioning, child: PhysicalPlan):
        self.partitioning = partitioning
        self.child = child

    @property
    def output(self):
        return self.child.output

    def output_partitioning(self):
        return self.partitioning

    def execute(self, ctx: ExecContext) -> list:
        parts = self.child.execute(ctx)
        schema = attrs_schema(self.output)
        p = self.partitioning
        if isinstance(p, SinglePartition):
            return S.gather_single(parts)
        if isinstance(p, HashPartitioning):
            pos = {a.expr_id: i for i, a in enumerate(self.output)}
            key_positions = []
            for e in p.exprs:
                if not isinstance(e, AttributeReference):
                    raise ValueError("exchange keys must be attributes "
                                     "(planner contract)")
                key_positions.append(pos[e.expr_id])
            return S.shuffle_hash(parts, key_positions, p.num_partitions,
                                  schema, ctx)
        if isinstance(p, UnknownPartitioning):
            return S.shuffle_round_robin(parts, p.num_partitions, schema, ctx)
        raise NotPortedError(f"exchange for {type(p).__name__}")

    def simple_string(self):
        return (f"Exchange[{type(self.partitioning).__name__}"
                f"({self.partitioning.num_partitions})]")
