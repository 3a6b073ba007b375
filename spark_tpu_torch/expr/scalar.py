"""Scalar (per-value) expression interpreter (counterpart of
`spark_tpu/expr/scalar.py`).

The one place the engine evaluates an expression per value on the host:
the lambda bodies of higher-order functions (expr/higher_order.py).
Batch expressions run through expr/eval.py; a lambda runs over the
elements of one collection value, against an environment that binds the
lambda variables (and captured outer columns) to Python values.

Three-valued logic follows SQL: any null in gives null out for strict
operators; Kleene AND/OR; comparisons on null give null.
"""

from __future__ import annotations

import datetime
import math
from typing import Any, Callable

from ..errors import UnsupportedOperationError
from ..types import (
    ArrayType, BooleanType, DataType, DateType, DecimalType, DoubleType,
    FloatType, IntegerType, LongType, MapType, StringType, TimestampType,
)
from . import expressions as E

__all__ = ["scalar_eval", "free_attributes"]


def free_attributes(e: E.Expression) -> list:
    """Resolved outer-column references inside a lambda body (captured
    variables: they become extra host inputs of the enclosing higher-order
    function)."""
    out, seen = [], set()
    for n in e.iter_nodes():
        if isinstance(n, E.AttributeReference) and n.expr_id not in seen:
            seen.add(n.expr_id)
            out.append(n)
    return out


def _cast_scalar(v, to: DataType):
    if v is None:
        return None
    try:
        if isinstance(to, StringType):
            if isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
                return f"{v:.1f}"
            return str(v)
        if isinstance(to, (IntegerType, LongType)):
            if isinstance(v, str):
                v = v.strip()
                return int(float(v)) if "." in v or "e" in v.lower() \
                    else int(v)
            return int(v)
        if isinstance(to, (DoubleType, FloatType)):
            return float(v)
        if isinstance(to, BooleanType):
            if isinstance(v, str):
                s = v.strip().lower()
                return True if s in ("true", "t", "1", "yes", "y") else \
                    False if s in ("false", "f", "0", "no", "n") else None
            return bool(v)
        if isinstance(to, DecimalType):
            return round(float(v), to.scale)
        if isinstance(to, (DateType, TimestampType)):
            return v       # already epoch-based ints in this engine
    except (ValueError, TypeError):
        return None
    return v


def _arith(fn: Callable[[Any, Any], Any]):
    def h(e, env):
        a = scalar_eval(e.left, env)
        b = scalar_eval(e.right, env)
        if a is None or b is None:
            return None
        try:
            return fn(a, b)
        except (ZeroDivisionError, ValueError, OverflowError):
            return None
    return h


def _cmp(fn: Callable[[Any, Any], bool]):
    def h(e, env):
        a = scalar_eval(e.left, env)
        b = scalar_eval(e.right, env)
        if a is None or b is None:
            return None
        return bool(fn(a, b))   # numpy bools are not the True singleton
    return h


def _h_and(e, env):
    a = scalar_eval(e.left, env)
    if a is False:
        return False
    b = scalar_eval(e.right, env)
    if b is False:
        return False
    return None if a is None or b is None else True


def _h_or(e, env):
    a = scalar_eval(e.left, env)
    if a is True:
        return True
    b = scalar_eval(e.right, env)
    if b is True:
        return True
    return None if a is None or b is None else False


def _h_case(e, env):
    for cond, val in e.branches:
        if scalar_eval(cond, env) is True:
            return scalar_eval(val, env)
    return scalar_eval(e.else_expr, env)


def _h_if(e, env):
    return scalar_eval(e.then if scalar_eval(e.pred, env) is True
                       else e.otherwise, env)


def _h_in(e, env):
    v = scalar_eval(e.child, env)
    if v is None:
        return None
    saw_null = False
    for item in e.items:
        x = scalar_eval(item, env)
        if x is None:
            saw_null = True
        elif x == v:
            return True
    return None if saw_null else False


def _h_coalesce(e, env):
    for c in e.args:
        v = scalar_eval(c, env)
        if v is not None:
            return v
    return None


def _h_extreme(pick):
    def h(e, env):
        vals = [scalar_eval(c, env) for c in e.args]
        vals = [v for v in vals if v is not None]
        return pick(vals) if vals else None
    return h


def _int_div(a, b):
    if b == 0:
        return None
    return int(a // b)


_DISPATCH: dict[type, Callable] = {
    E.Add: _arith(lambda a, b: a + b),
    E.Subtract: _arith(lambda a, b: a - b),
    E.Multiply: _arith(lambda a, b: a * b),
    E.Divide: _arith(lambda a, b: a / b if b else None),
    # SQL % follows the dividend's sign (fmod), unlike Python's %
    E.Remainder: _arith(lambda a, b: None if not b else (
        math.fmod(a, b) if isinstance(a, float) or isinstance(b, float)
        else int(math.fmod(a, b)))),
    E.Pow: _arith(lambda a, b: float(a) ** float(b)),
    E.EqualTo: _cmp(lambda a, b: a == b),
    E.NotEqualTo: _cmp(lambda a, b: a != b),
    E.LessThan: _cmp(lambda a, b: a < b),
    E.LessThanOrEqual: _cmp(lambda a, b: a <= b),
    E.GreaterThan: _cmp(lambda a, b: a > b),
    E.GreaterThanOrEqual: _cmp(lambda a, b: a >= b),
    E.And: _h_and,
    E.Or: _h_or,
    E.CaseWhen: _h_case,
    E.If: _h_if,
    E.In: _h_in,
    E.Coalesce: _h_coalesce,
    E.Greatest: _h_extreme(max),
    E.Least: _h_extreme(min),
}


def _strict_unary(fn):
    def h(v):
        return None if v is None else fn(v)
    return h


_UNARY: dict[type, Callable] = {
    E.UnaryMinus: _strict_unary(lambda v: -v),
    E.Abs: _strict_unary(abs),
    E.Not: _strict_unary(lambda v: not v),
    E.Floor: _strict_unary(lambda v: int(math.floor(v))),
    E.Ceil: _strict_unary(lambda v: int(math.ceil(v))),
    E.Sqrt: _strict_unary(lambda v: math.sqrt(v) if v >= 0 else None),
    E.Exp: _strict_unary(math.exp),
}


def scalar_eval(e: E.Expression, env: dict) -> Any:
    """Evaluate `e` to one Python value. `env` maps expr_id -> value for
    NamedLambdaVariable and captured AttributeReference leaves."""
    from .higher_order import HigherOrderFunction, NamedLambdaVariable

    t = type(e)
    if t is E.Literal:
        return e.value
    if isinstance(e, NamedLambdaVariable):
        return env[e.expr_id]
    if isinstance(e, E.AttributeReference):
        if e.expr_id in env:
            return env[e.expr_id]
        raise UnsupportedOperationError(
            f"unbound column {e.name} inside lambda")
    if t is E.Alias:
        return scalar_eval(e.child, env)
    if t is E.Cast:
        return _cast_scalar(scalar_eval(e.child, env), e.to)
    if t is E.IsNull:
        return scalar_eval(e.child, env) is None
    if t is E.IsNotNull:
        return scalar_eval(e.child, env) is not None
    if t is E.EqualNullSafe:
        a, b = scalar_eval(e.left, env), scalar_eval(e.right, env)
        return a == b if (a is None) == (b is None) else False
    if t is E.NullIf:
        a, b = scalar_eval(e.left, env), scalar_eval(e.right, env)
        return None if a == b else a
    h = _DISPATCH.get(t)
    if h is not None:
        return h(e, env)
    u = _UNARY.get(t)
    if u is not None:
        return u(scalar_eval(e.child, env))
    if isinstance(e, HigherOrderFunction):
        return e.scalar_apply(
            [scalar_eval(c, env) for c in e.collection_args()], env)
    # bridges onto the batch expressions' host lookups: any
    # value_of/transform/int_of expression evaluates one value directly
    if isinstance(e, E._ArrayLut):
        v = scalar_eval(e.child, env)
        if v is None:
            return None
        out, ok = e.value_of(v)
        return out if ok else None
    if isinstance(e, E._StringIntLut):
        v = scalar_eval(e.child, env)
        return None if v is None else e.int_of(v)
    if isinstance(e, E._DictTransform):
        v = scalar_eval(e.child, env)
        return None if v is None else e.transform(v)
    if isinstance(e, E.Concat):
        parts = [scalar_eval(c, env) for c in e.args]
        if any(p is None for p in parts):
            return None
        return "".join(str(p) for p in parts)
    from .pyudf import PythonUDF

    if isinstance(e, PythonUDF):
        # e.g. an array()/map() constructor nested in a lambda body
        return e.fn(*[scalar_eval(a, env) for a in e.args])
    raise UnsupportedOperationError(
        f"expression {type(e).__name__} not supported inside a lambda")
