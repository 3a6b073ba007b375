"""Aggregate lowering: logical aggregate functions -> buffer ops + final
expressions (counterpart of `spark_tpu/physical/aggregates.py`, for sum,
count, min, max (of strings too, reduced in rank space), first and
any_value, avg, bit_and/bit_or/bit_xor, the central moments: stddev and
variance, sample and population, from sum/sumsq/count buffers as
`(sumsq - sum^2/n) / (n - ddof)`, NULL at n <= ddof, and the non-mergeable
percentile and collect specs, which the planner gathers to one partition
first). Merge ops are the partial ops' associative counterparts, so one
kernel serves map-side partial and reduce-side final aggregation. A decimal sum is an exact int64 sum of the scaled values; a
decimal average finishes as cast(sum / count as decimal(p+4, s+4)), the
division in float64, as the reference lowers it."""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import NotPortedError
from ..expr.expressions import (
    AggregateFunction, Alias, AttributeReference, Average, BitAndAgg,
    CollectList, CollectSet, Count, Divide, Expression, First, GreaterThan,
    If, Literal, Max, Min, Multiply, Percentile, Sqrt, StddevPop, StddevSamp,
    Subtract, Sum, _CentralMoment, cast_if,
)
from ..types import DataType, DecimalType, IntegralType, float64, int64

# primitive ops the kernels implement
PARTIAL_TO_MERGE = {
    "sum": "sum", "count": "sum", "countstar": "sum",
    "min": "min", "max": "max", "first": "first", "sumsq": "sum",
    # bitwise reduces are associative: partials merge with themselves
    "bitand": "bitand", "bitor": "bitor", "bitxor": "bitxor",
}


def _buffer_dtype(op: str, in_dtype: DataType | None) -> DataType:
    if op in ("count", "countstar", "bitand", "bitor", "bitxor"):
        return int64
    if op == "sumsq":
        return float64
    if op == "sum":
        if isinstance(in_dtype, DecimalType):
            return DecimalType(DecimalType.MAX_PRECISION, in_dtype.scale)
        return int64 if isinstance(in_dtype, IntegralType) else float64
    return in_dtype  # min/max/first preserve type


@dataclass
class AggSpec:
    """One aggregate function lowered to buffer columns + a finishing expr."""

    func: AggregateFunction
    input_expr: Expression | None          # argument (None for count(*))
    ops: list[str]                         # primitive op per buffer column
    buffer_attrs: list[AttributeReference]  # schema of partial output
    result_alias: Alias                    # final output (over buffer attrs)
    mergeable: bool = True
    param: float | None = None


def lower_aggregate_function(func: AggregateFunction, out_name: str,
                             out_id: int) -> AggSpec:
    child = func.child

    def battr(i: int, op: str) -> AttributeReference:
        dt = _buffer_dtype(op, child.dtype if child is not None else None)
        nullable = op not in ("count", "countstar")
        return AttributeReference(f"{out_name}#buf{i}", dt, nullable)

    if isinstance(func, Sum):
        b = battr(0, "sum")
        return AggSpec(func, child, ["sum"], [b],
                       Alias(cast_if(b, func.dtype), out_name, out_id))
    if isinstance(func, Count):
        if func.distinct:
            raise NotPortedError("count(distinct)")
        op = "count" if child is not None else "countstar"
        b = battr(0, op)
        return AggSpec(func, child, [op], [b], Alias(b, out_name, out_id))
    if isinstance(func, (Min, Max)):
        op = "min" if isinstance(func, Min) else "max"
        b = battr(0, op)
        return AggSpec(func, child, [op], [b], Alias(b, out_name, out_id))
    if isinstance(func, First):
        b = battr(0, "first")
        return AggSpec(func, child, ["first"], [b], Alias(b, out_name, out_id))
    if isinstance(func, Average):
        bs = battr(0, "sum")
        bc = battr(1, "count")
        return AggSpec(func, child, ["sum", "count"], [bs, bc],
                       Alias(cast_if(Divide(bs, bc), func.dtype), out_name,
                             out_id))
    if isinstance(func, BitAndAgg):
        op = "bit" + func.kind
        b = battr(0, op)
        return AggSpec(func, child, [op], [b],
                       Alias(cast_if(b, func.dtype), out_name, out_id))
    if isinstance(func, Percentile):
        b = AttributeReference(f"{out_name}#buf0", func.dtype, True)
        return AggSpec(func, child, ["percentile"], [b],
                       Alias(b, out_name, out_id), mergeable=False,
                       param=func.q)
    if isinstance(func, (CollectList, CollectSet)):
        b = AttributeReference(f"{out_name}#buf0", func.dtype, False)
        return AggSpec(func, child, ["collect"], [b],
                       Alias(b, out_name, out_id), mergeable=False,
                       param=1.0 if isinstance(func, CollectSet) else 0.0)
    if isinstance(func, _CentralMoment):
        bs = battr(0, "sum")
        bq = battr(1, "sumsq")
        bc = battr(2, "count")
        scaled = isinstance(child.dtype, DecimalType)
        if scaled:
            # a decimal's sum and sumsq add its scaled integers: the
            # moments come out in scale^2 and are scaled back last (the
            # reference mixes the two: ROADMAP.md section C)
            bs = AttributeReference(bs.name, int64, True)
        n = cast_if(bc, float64)
        mean_sq = Divide(Multiply(cast_if(bs, float64),
                                  cast_if(bs, float64)), n)
        ddof = func.ddof
        denom = Subtract(n, Literal(float(ddof))) if ddof else n
        var = Divide(Subtract(bq, mean_sq), denom)
        if scaled:
            var = Divide(var, Literal(float(10 ** (2 * child.dtype.scale))))
        var = If(GreaterThan(bc, Literal(ddof)), var, Literal(None, float64))
        result: Expression = var
        if isinstance(func, (StddevSamp, StddevPop)):
            result = Sqrt(var)
        return AggSpec(func, child, ["sum", "sumsq", "count"], [bs, bq, bc],
                       Alias(result, out_name, out_id))
    raise NotPortedError(f"aggregate {type(func).__name__}")
