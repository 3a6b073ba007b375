"""Window expressions (the port's copy of `spark_tpu/expr/window.py`).

The ranking and offset functions, and `WindowExpression`, which wraps one
of them or an aggregate function with its partition keys, order keys and
frame. `WindowExec` (`physical/window.py`) evaluates them over the
sort/segment layout of `ops/window.py`.
"""

from __future__ import annotations

from typing import Sequence

from ..errors import UnsupportedOperationError
from ..types import DataType, float64, int32
from .expressions import (
    AggregateFunction, Expression, Literal, SortOrder,
)

__all__ = ["WindowFunction", "RowNumber", "Rank", "DenseRank", "PercentRank",
           "CumeDist", "NTile", "Lag", "Lead", "FirstValue", "LastValue",
           "NthValue", "UnresolvedWindowExpression", "WindowExpression"]


class WindowFunction(Expression):
    child_fields = ()

    @property
    def nullable(self):
        return False


class RowNumber(WindowFunction):
    @property
    def dtype(self):
        return int32


class Rank(WindowFunction):
    @property
    def dtype(self):
        return int32


class DenseRank(WindowFunction):
    @property
    def dtype(self):
        return int32


class PercentRank(WindowFunction):
    @property
    def dtype(self):
        return float64


class CumeDist(WindowFunction):
    @property
    def dtype(self):
        return float64


class NTile(WindowFunction):
    def __init__(self, n: Expression):
        if not isinstance(n, Literal):
            raise UnsupportedOperationError("ntile(n) needs a literal")
        self.n = int(n.value)

    @property
    def dtype(self):
        return int32


class Lag(WindowFunction):
    child_fields = ("child", "default")

    def __init__(self, child: Expression, offset: Expression | int = 1,
                 default: Expression | None = None):
        self.child = child
        self.offset = int(offset.value) if isinstance(offset, Literal) \
            else int(offset)
        self.default = default

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return True


class Lead(Lag):
    pass


class FirstValue(WindowFunction):
    """first_value(x): first row of the frame (default running frame →
    value at the partition start; reference: windowExpressions.scala
    First as a window function, RESPECT NULLS)."""

    child_fields = ("child",)

    def __init__(self, child: Expression):
        self.child = child

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return True


class LastValue(FirstValue):
    """last_value(x): last row of the frame — with ORDER BY the default
    frame ends at the CURRENT PEER GROUP (the classic gotcha), without
    ORDER BY the whole partition."""


class NthValue(WindowFunction):
    """nth_value(x, n): n-th row of the frame, NULL while the frame has
    fewer than n rows."""

    child_fields = ("child",)

    def __init__(self, child: Expression, n: Expression):
        if not isinstance(n, Literal):
            raise UnsupportedOperationError("nth_value(x, n) needs a "
                                            "literal n")
        self.child = child
        self.n = int(n.value)
        if self.n < 1:
            raise UnsupportedOperationError("nth_value n must be >= 1")

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return True


class UnresolvedWindowExpression(Expression):
    """Parsed `fn(...) OVER (...)` awaiting function resolution."""

    child_fields = ("function", "partition_spec", "order_spec")

    def __init__(self, function: Expression,
                 partition_spec: Sequence[Expression],
                 order_spec: Sequence["SortOrder"],
                 frame: tuple | None = None,
                 ref_name: str | None = None):
        self.function = function
        self.partition_spec = list(partition_spec)
        self.order_spec = list(order_spec)
        self.frame = frame
        # `fn() OVER w` — spec filled in from the query's WINDOW clause by
        # the parser before analysis
        self.ref_name = ref_name

    @property
    def resolved(self):
        return False


class WindowExpression(Expression):
    child_fields = ("function", "partition_spec", "order_spec")

    def __init__(self, function: Expression,
                 partition_spec: Sequence[Expression],
                 order_spec: Sequence[SortOrder],
                 frame: tuple | None = None):
        if not isinstance(function, (WindowFunction, AggregateFunction)):
            raise UnsupportedOperationError(
                f"{type(function).__name__} is not a window function")
        self.function = function
        self.partition_spec = list(partition_spec)
        self.order_spec = list(order_spec)
        # frame: None = Spark default; ("rows", lo, hi) with offsets where
        # None = unbounded (lo ≤ 0 ≤ hi row deltas)
        self.frame = frame

    @property
    def dtype(self) -> DataType:
        return self.function.dtype

    @property
    def nullable(self):
        return True

    def spec_signature(self):
        """Grouping key: window expressions sharing a spec evaluate in one
        WindowExec pass."""
        return (tuple(e.simple_string() for e in self.partition_spec),
                tuple((o.child.simple_string(), o.ascending, o.nulls_first)
                      for o in self.order_spec))

    def simple_string(self):
        p = ", ".join(e.simple_string() for e in self.partition_spec)
        o = ", ".join(x.child.simple_string() for x in self.order_spec)
        return (f"{self.function.simple_string()} OVER "
                f"(PARTITION BY {p} ORDER BY {o})")
