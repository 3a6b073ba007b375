"""Expression tree (counterpart of `spark_tpu/expr/expressions.py`, the
subset the port evaluates).

Each expression keeps the JAX package's class name, type rules, null
semantics and `simple_string`, with one `eval(ctx)` written on torch
tensors: attributes, literals, aliases, casts between the ported types,
`+ - * /` (plain ops wrap on integral overflow; the try_ variants give NULL;
x/0 gives NULL), sort orders, the comparisons, Kleene and/or/not, is [not]
null, and the aggregate functions sum, count, min, max and avg.
"""

from __future__ import annotations

import datetime
from typing import Any, Sequence

import torch

from ..errors import AnalysisException, NotPortedError, TypeCheckError
from ..plan.tree import TreeNode, next_id
from ..types import (
    BooleanType, DataType, DateType, FractionalType, IntegralType, NullType,
    NumericType, boolean, common_type, float64, infer_type, int64, null_type,
)
from .eval import EvalCtx, Val

__all__ = [
    "Expression", "Literal", "AttributeReference", "UnresolvedAttribute",
    "UnresolvedStar", "Alias", "SortOrder", "Cast", "cast_if",
    "Add", "Subtract", "Multiply", "Divide", "TryAdd", "TrySubtract",
    "TryMultiply", "EqualTo", "NotEqualTo", "LessThan", "LessThanOrEqual",
    "GreaterThan", "GreaterThanOrEqual", "And", "Or", "Not", "IsNull",
    "IsNotNull", "AggregateFunction", "Sum", "Count", "Min", "Max", "Average",
]


# ---------------------------------------------------------------------------
# Base
# ---------------------------------------------------------------------------

class Expression(TreeNode):
    @property
    def dtype(self) -> DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return True

    @property
    def resolved(self) -> bool:
        return all(c.resolved for c in self.children)

    def references(self) -> set[int]:
        out: set[int] = set()
        for n in self.iter_nodes():
            if isinstance(n, AttributeReference):
                out.add(n.expr_id)
        return out

    def eval(self, ctx: EvalCtx) -> Val:
        raise NotPortedError(f"expression {type(self).__name__}")

    def sql_name(self) -> str:
        return type(self).__name__.lower()


# ---------------------------------------------------------------------------
# Leaves & named expressions
# ---------------------------------------------------------------------------

class Literal(Expression):
    child_fields = ()

    def __init__(self, value: Any, dtype: DataType | None = None):
        self.value = value
        self._dtype = dtype if dtype is not None else infer_type(value)
        if isinstance(value, datetime.date):
            self.value = (value - datetime.date(1970, 1, 1)).days

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    @property
    def resolved(self) -> bool:
        return True

    def _data_args(self) -> tuple:
        return (("value", self.value), ("dtype", str(self._dtype)))

    def eval(self, ctx: EvalCtx) -> Val:
        dt = self._dtype.device_dtype
        if self.value is None:
            return Val(self._dtype, ctx.scalar(0, dt),
                       ctx.scalar(False, torch.bool))
        return Val(self._dtype, ctx.scalar(self.value, dt), None)

    def simple_string(self) -> str:
        return f"lit({self.value!r})"


class AttributeReference(Expression):
    """A resolved column (expr_id disambiguates same-named columns)."""

    child_fields = ()

    def __init__(self, name: str, dtype: DataType, nullable: bool = True,
                 expr_id: int | None = None):
        self.name = name
        self._dtype = dtype
        self._nullable = nullable
        self.expr_id = next_id() if expr_id is None else expr_id

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    @property
    def resolved(self) -> bool:
        return True

    def eval(self, ctx: EvalCtx) -> Val:
        return ctx.attribute(self.expr_id)

    def _data_args(self) -> tuple:
        return (("expr_id", self.expr_id),)

    def with_nullability(self, nullable: bool) -> "AttributeReference":
        return AttributeReference(self.name, self._dtype, nullable,
                                  self.expr_id)

    def simple_string(self) -> str:
        return f"{self.name}#{self.expr_id}"


class UnresolvedAttribute(Expression):
    child_fields = ()

    def __init__(self, name_parts: Sequence[str]):
        self.name_parts = tuple(name_parts)

    @property
    def name(self) -> str:
        return ".".join(self.name_parts)

    @property
    def resolved(self) -> bool:
        return False

    def simple_string(self) -> str:
        return f"'{self.name}"


class UnresolvedStar(Expression):
    child_fields = ()

    @property
    def resolved(self) -> bool:
        return False


class Alias(Expression):
    child_fields = ("child",)

    def __init__(self, child: Expression, name: str, expr_id: int | None = None):
        self.child = child
        self.name = name
        self.expr_id = next_id() if expr_id is None else expr_id

    @property
    def dtype(self) -> DataType:
        return self.child.dtype

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def to_attribute(self) -> AttributeReference:
        dt = self.child.dtype if self.child.resolved else null_type
        return AttributeReference(self.name, dt, self.child.nullable,
                                  self.expr_id)

    def eval(self, ctx: EvalCtx) -> Val:
        return ctx.eval(self.child)

    def _data_args(self) -> tuple:
        return (("name", self.name), ("expr_id", self.expr_id))

    def simple_string(self) -> str:
        return f"{self.child.simple_string()} AS {self.name}#{self.expr_id}"


class SortOrder(Expression):
    """Sort direction wrapper: `nulls_first` None means Spark's default
    (nulls first when ascending, last when descending)."""

    child_fields = ("child",)

    def __init__(self, child: Expression, ascending: bool = True,
                 nulls_first: bool | None = None):
        self.child = child
        self.ascending = ascending
        self.nulls_first = nulls_first

    @property
    def dtype(self) -> DataType:
        return self.child.dtype

    @property
    def nulls_first_effective(self) -> bool:
        return self.ascending if self.nulls_first is None else \
            self.nulls_first

    def eval(self, ctx: EvalCtx) -> Val:
        return ctx.eval(self.child)


# ---------------------------------------------------------------------------
# Cast
# ---------------------------------------------------------------------------

class Cast(Expression):
    child_fields = ("child",)

    def __init__(self, child: Expression, to: DataType):
        self.child = child
        self.to = to

    @property
    def dtype(self) -> DataType:
        return self.to

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, ctx: EvalCtx) -> Val:
        return cast_val(ctx, ctx.eval(self.child), self.to)

    def simple_string(self) -> str:
        return f"cast({self.child.simple_string()} as {self.to.simple_string()})"


def cast_val(ctx: EvalCtx, c: Val, to: DataType) -> Val:
    frm = c.dtype
    if type(frm) is type(to) and frm == to:
        return c
    dd = to.device_dtype
    if isinstance(frm, NullType):
        return Val(to, ctx.scalar(0, dd), ctx.scalar(False, torch.bool))
    data = c.data
    if isinstance(to, BooleanType):
        return Val(to, data != 0, c.validity)
    if isinstance(frm, FractionalType) and isinstance(to, IntegralType):
        # float -> int truncates toward zero; NaN/inf read as 0
        t = torch.nan_to_num(torch.trunc(data), nan=0.0, posinf=0.0,
                             neginf=0.0)
        return Val(to, t.to(dd), c.validity)
    return Val(to, data.to(dd), c.validity)


def cast_if(e: Expression, to: DataType) -> Expression:
    if e.resolved and e.dtype == to:
        return e
    c = getattr(e, "_cast_cache", None)
    if c is not None and c.to == to:
        return c
    c = Cast(e, to)
    e._cast_cache = c
    return c


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

class BinaryExpression(Expression):
    child_fields = ("left", "right")
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.left = left
        self.right = right

    def simple_string(self) -> str:
        return (f"({self.left.simple_string()} {self.symbol} "
                f"{self.right.simple_string()})")


class BinaryArithmetic(BinaryExpression):
    @property
    def dtype(self) -> DataType:
        lt, rt = self.left.dtype, self.right.dtype
        if isinstance(lt, DateType) or isinstance(rt, DateType):
            raise NotPortedError(f"date arithmetic ({self.symbol})")
        ct = common_type(lt, rt)
        if ct is None or not isinstance(ct, NumericType):
            raise TypeCheckError(
                f"{type(self).__name__} needs numeric operands, got "
                f"{lt.simple_string()}, {rt.simple_string()}")
        return self._result_type(ct)

    def _result_type(self, ct: DataType) -> DataType:
        return ct

    def eval(self, ctx: EvalCtx) -> Val:
        l = ctx.eval(self.left)
        r = ctx.eval(self.right)
        v = ctx.and_valid(l, r)
        out = self.dtype
        ld, rd = self._align(ctx, l, r, out)
        data, extra_null = self._op(ld, rd)
        if extra_null is not None:
            v = extra_null if v is None else (v & extra_null)
        return Val(out, data, v)

    def _align(self, ctx, l: Val, r: Val, out: DataType):
        dd = out.device_dtype
        return l.data.to(dd), r.data.to(dd)

    def _op(self, l, r):
        raise NotImplementedError


class Add(BinaryArithmetic):
    symbol = "+"

    def _op(self, l, r):
        return l + r, None


class Subtract(BinaryArithmetic):
    symbol = "-"

    def _op(self, l, r):
        return l - r, None


class Multiply(BinaryArithmetic):
    symbol = "*"

    def _op(self, l, r):
        return l * r, None


def _signed_int(t: torch.Tensor) -> bool:
    return not t.dtype.is_floating_point and t.dtype != torch.bool


class TryAdd(Add):
    """try_add: NULL on integral overflow instead of wrapping."""

    def _op(self, l, r):
        data, _ = super()._op(l, r)
        if not _signed_int(data):
            return data, None
        # signed add overflows iff operands share a sign the result lost
        ok = ~(((l >= 0) == (r >= 0)) & ((data >= 0) != (l >= 0)))
        return data, ok


class TrySubtract(Subtract):
    """try_subtract: NULL on integral overflow instead of wrapping."""

    def _op(self, l, r):
        data, _ = super()._op(l, r)
        if not _signed_int(data):
            return data, None
        ok = ~(((l >= 0) != (r >= 0)) & ((data >= 0) != (l >= 0)))
        return data, ok


class TryMultiply(Multiply):
    """try_multiply: NULL on integral overflow instead of wrapping."""

    def _op(self, l, r):
        data, _ = super()._op(l, r)
        if not _signed_int(data):
            return data, None
        info = torch.iinfo(data.dtype)
        if info.bits < 64:
            wide = l.to(torch.int64) * r.to(torch.int64)
            return data, (wide >= info.min) & (wide <= info.max)
        # int64: the wrapped product res = l*r - k*2^64 satisfies
        # floor(res/l) == r only for k == 0; (-1, INT64_MIN) is special
        nz = torch.where(l == 0, torch.ones_like(l), l)
        ok = (l == 0) | (torch.floor_divide(data, nz) == r)
        ok = ok & ~((l == -1) & (r == info.min))
        return data, ok


class Divide(BinaryArithmetic):
    symbol = "/"

    def _result_type(self, ct):
        return float64

    def _align(self, ctx, l, r, out):
        return (cast_val(ctx, l, float64).data, cast_val(ctx, r, float64).data)

    def _op(self, l, r):
        zero = r == 0
        safe = torch.where(zero, torch.ones_like(r), r)
        return l / safe, ~zero  # x/0 => NULL (non-ANSI Spark semantics)


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------

class BinaryComparison(BinaryExpression):
    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        l = ctx.eval(self.left)
        r = ctx.eval(self.right)
        ct = common_type(l.dtype, r.dtype) or l.dtype
        lc = cast_val(ctx, l, ct)
        rc = cast_val(ctx, r, ct)
        return Val(boolean, self._cmp(lc.data, rc.data),
                   ctx.and_valid(lc, rc))

    def _cmp(self, l, r):
        raise NotImplementedError


class EqualTo(BinaryComparison):
    symbol = "="

    def _cmp(self, l, r):
        return l == r


class NotEqualTo(BinaryComparison):
    symbol = "!="

    def _cmp(self, l, r):
        return l != r


class LessThan(BinaryComparison):
    symbol = "<"

    def _cmp(self, l, r):
        return l < r


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def _cmp(self, l, r):
        return l <= r


class GreaterThan(BinaryComparison):
    symbol = ">"

    def _cmp(self, l, r):
        return l > r


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def _cmp(self, l, r):
        return l >= r


# ---------------------------------------------------------------------------
# Boolean logic — Kleene three-valued
# ---------------------------------------------------------------------------

def _known(ctx: EvalCtx, validity):
    return validity if validity is not None else ctx.scalar(True, torch.bool)


class And(BinaryExpression):
    symbol = "AND"

    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        l = ctx.eval(self.left)
        r = ctx.eval(self.right)
        if l.validity is None and r.validity is None:
            return Val(boolean, l.data & r.data)
        lv, rv = _known(ctx, l.validity), _known(ctx, r.validity)
        # FALSE wins over NULL: known iff both known or either a known FALSE
        known = (lv & rv) | (lv & ~l.data) | (rv & ~r.data)
        return Val(boolean, (lv & l.data) & (rv & r.data), known)


class Or(BinaryExpression):
    symbol = "OR"

    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        l = ctx.eval(self.left)
        r = ctx.eval(self.right)
        if l.validity is None and r.validity is None:
            return Val(boolean, l.data | r.data)
        lv, rv = _known(ctx, l.validity), _known(ctx, r.validity)
        known = (lv & rv) | (lv & l.data) | (rv & r.data)
        return Val(boolean, (lv & l.data) | (rv & r.data), known)


class UnaryExpression(Expression):
    child_fields = ("child",)

    def __init__(self, child: Expression):
        self.child = child

    def simple_string(self) -> str:
        return f"{self.sql_name()}({self.child.simple_string()})"


class Not(UnaryExpression):
    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        c = ctx.eval(self.child)
        return Val(boolean, ~c.data, c.validity)


class IsNull(UnaryExpression):
    @property
    def dtype(self):
        return boolean

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if c.validity is None:
            return Val(boolean, ctx.scalar(False, torch.bool))
        return Val(boolean, ~c.validity)


class IsNotNull(UnaryExpression):
    @property
    def dtype(self):
        return boolean

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if c.validity is None:
            return Val(boolean, ctx.scalar(True, torch.bool))
        return Val(boolean, c.validity)


# ---------------------------------------------------------------------------
# Aggregate functions (evaluated by the aggregation operator, not eval())
# ---------------------------------------------------------------------------

class AggregateFunction(Expression):
    child_fields = ("child",)

    def __init__(self, child: Expression | None):
        self.child = child

    @property
    def nullable(self):
        return True

    def eval(self, ctx):
        raise AnalysisException(
            f"aggregate function {type(self).__name__} cannot be evaluated "
            "outside an aggregation")


class Sum(AggregateFunction):
    @property
    def dtype(self):
        if isinstance(self.child.dtype, IntegralType):
            return int64
        return float64


class Count(AggregateFunction):
    def __init__(self, child: Expression | None = None, distinct: bool = False):
        super().__init__(child)
        self.distinct = distinct

    @property
    def dtype(self):
        return int64

    @property
    def nullable(self):
        return False


class Min(AggregateFunction):
    @property
    def dtype(self):
        return self.child.dtype


class Max(AggregateFunction):
    @property
    def dtype(self):
        return self.child.dtype


class Average(AggregateFunction):
    @property
    def dtype(self):
        return float64
