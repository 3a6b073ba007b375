"""Physical partitioning/distribution model (the port's copy of
`spark_tpu/physical/partitioning.py`).

Role of the reference's Distribution/Partitioning contract
(sqlcat/plans/physical/partitioning.scala:39 Distribution, :318
HashPartitioning, :720 RangePartitioning) consumed by EnsureRequirements
(sqlx/exchange/EnsureRequirements.scala:51).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..expr.expressions import Expression


# --- distributions (requirements) ------------------------------------------

class Distribution:
    pass


@dataclass(frozen=True)
class UnspecifiedDistribution(Distribution):
    pass


@dataclass(frozen=True)
class AllTuples(Distribution):
    """Everything in a single partition."""


class ClusteredDistribution(Distribution):
    def __init__(self, exprs: Sequence[Expression]):
        self.exprs = list(exprs)


class OrderedDistribution(Distribution):
    def __init__(self, orders: Sequence):
        self.orders = list(orders)


@dataclass(frozen=True)
class BroadcastDistribution(Distribution):
    """The whole relation replicated to every consumer partition."""


# --- partitionings (what an operator produces) ------------------------------

class Partitioning:
    num_partitions: int = 1

    def satisfies(self, d: Distribution) -> bool:
        if isinstance(d, UnspecifiedDistribution):
            return True
        if isinstance(d, AllTuples):
            return self.num_partitions == 1
        return False


@dataclass
class UnknownPartitioning(Partitioning):
    num_partitions: int = 1


@dataclass
class SinglePartition(Partitioning):
    num_partitions: int = 1

    def satisfies(self, d: Distribution) -> bool:
        if isinstance(d, BroadcastDistribution):
            return False
        return True  # one partition satisfies any non-broadcast distribution


class HashPartitioning(Partitioning):
    def __init__(self, exprs: Sequence[Expression], num_partitions: int):
        self.exprs = list(exprs)
        self.num_partitions = num_partitions

    def satisfies(self, d: Distribution) -> bool:
        if isinstance(d, UnspecifiedDistribution):
            return True
        if isinstance(d, ClusteredDistribution):
            # our hash exprs must be a subset of the required clustering:
            # equal rows then land in the same partition
            return all(any(h.semantic_equals(c) for c in d.exprs)
                       for h in self.exprs) and len(self.exprs) > 0
        return False


class RangePartitioning(Partitioning):
    def __init__(self, orders: Sequence, num_partitions: int):
        self.orders = list(orders)
        self.num_partitions = num_partitions

    def satisfies(self, d: Distribution) -> bool:
        if isinstance(d, UnspecifiedDistribution):
            return True
        if isinstance(d, OrderedDistribution):
            if len(d.orders) > len(self.orders):
                return False
            return all(
                o.child.semantic_equals(m.child) and o.ascending == m.ascending
                for o, m in zip(d.orders, self.orders))
        if isinstance(d, ClusteredDistribution):
            return all(any(o.child.semantic_equals(c) for c in d.exprs)
                       for o in self.orders)
        return False


@dataclass
class BroadcastPartitioning(Partitioning):
    num_partitions: int = 1

    def satisfies(self, d: Distribution) -> bool:
        return isinstance(d, (BroadcastDistribution, UnspecifiedDistribution))
