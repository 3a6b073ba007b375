"""User-facing Column DSL (counterpart of `spark_tpu/api/column.py`, the
operators whose expressions are ported; string literals come through `_expr`
and `substr`; `isin`, `between`, the string predicates `contains`,
`startswith`, `endswith`, `like` and `rlike`, `isNaN`, `eqNullSafe`, the
`when`/`otherwise` chain that `functions.when` starts, `over` a window
spec of `api/window.py`, and the nested accessors `getField`, `getItem`
and `[]`)."""

from __future__ import annotations

from typing import Any

from ..expr import expressions as E
from ..types import DataType


def _expr(v: Any) -> E.Expression:
    if isinstance(v, Column):
        return v.expr
    if isinstance(v, E.Expression):
        return v
    return E.Literal(v)


class Column:
    def __init__(self, expr: E.Expression):
        self.expr = expr

    def alias(self, name: str) -> "Column":
        return Column(E.Alias(self.expr, name))

    def cast(self, to: DataType) -> "Column":
        return Column(E.Cast(self.expr, to, explicit=True))

    # --- nested access ----------------------------------------------------
    def getField(self, name: str) -> "Column":
        """A struct field."""
        return Column(E.GetStructField(self.expr, name))

    def getItem(self, key) -> "Column":
        """A map value or an array element; which one is decided at
        analysis, since the column may be unresolved here."""
        return Column(E.UnresolvedFunction(
            "element_at", [self.expr, E.Literal(key)], False))

    def __getitem__(self, key) -> "Column":
        if isinstance(key, str):
            from ..types import StructType

            try:
                if isinstance(self.expr.dtype, StructType):
                    return self.getField(key)
            except Exception:
                pass
        return self.getItem(key)

    # --- arithmetic -------------------------------------------------------
    def __add__(self, o):
        return Column(E.Add(self.expr, _expr(o)))

    def __radd__(self, o):
        return Column(E.Add(_expr(o), self.expr))

    def __sub__(self, o):
        return Column(E.Subtract(self.expr, _expr(o)))

    def __rsub__(self, o):
        return Column(E.Subtract(_expr(o), self.expr))

    def __mul__(self, o):
        return Column(E.Multiply(self.expr, _expr(o)))

    def __rmul__(self, o):
        return Column(E.Multiply(_expr(o), self.expr))

    def __truediv__(self, o):
        return Column(E.Divide(self.expr, _expr(o)))

    def __rtruediv__(self, o):
        return Column(E.Divide(_expr(o), self.expr))

    def __mod__(self, o):
        return Column(E.Remainder(self.expr, _expr(o)))

    def __neg__(self):
        return Column(E.UnaryMinus(self.expr))

    def __pow__(self, o):
        return Column(E.Pow(self.expr, _expr(o)))

    # --- comparisons ------------------------------------------------------
    def __eq__(self, o):  # type: ignore[override]
        return Column(E.EqualTo(self.expr, _expr(o)))

    def __ne__(self, o):  # type: ignore[override]
        return Column(E.NotEqualTo(self.expr, _expr(o)))

    def __lt__(self, o):
        return Column(E.LessThan(self.expr, _expr(o)))

    def __le__(self, o):
        return Column(E.LessThanOrEqual(self.expr, _expr(o)))

    def __gt__(self, o):
        return Column(E.GreaterThan(self.expr, _expr(o)))

    def __ge__(self, o):
        return Column(E.GreaterThanOrEqual(self.expr, _expr(o)))

    def eqNullSafe(self, o):
        return Column(E.EqualNullSafe(self.expr, _expr(o)))

    # --- boolean ----------------------------------------------------------
    def __and__(self, o):
        return Column(E.And(self.expr, _expr(o)))

    def __rand__(self, o):
        return Column(E.And(_expr(o), self.expr))

    def __or__(self, o):
        return Column(E.Or(self.expr, _expr(o)))

    def __ror__(self, o):
        return Column(E.Or(_expr(o), self.expr))

    def __invert__(self):
        return Column(E.Not(self.expr))

    # --- predicates -------------------------------------------------------
    def isNull(self):
        return Column(E.IsNull(self.expr))

    def isNotNull(self):
        return Column(E.IsNotNull(self.expr))

    def isNaN(self):
        return Column(E.IsNaN(self.expr))

    def isin(self, *vals):
        if len(vals) == 1 and isinstance(vals[0], (list, tuple, set)):
            vals = tuple(vals[0])
        return Column(E.In(self.expr, [_expr(v) for v in vals]))

    def between(self, lo, hi):
        return Column(E.And(
            E.GreaterThanOrEqual(self.expr, _expr(lo)),
            E.LessThanOrEqual(self.expr, _expr(hi))))

    def like(self, pattern: str):
        return Column(E.Like(self.expr, pattern))

    def rlike(self, pattern: str):
        return Column(E.RLike(self.expr, pattern))

    def contains(self, s: str):
        return Column(E.Contains(self.expr, s))

    def startswith(self, s: str):
        return Column(E.StartsWith(self.expr, s))

    def endswith(self, s: str):
        return Column(E.EndsWith(self.expr, s))

    # --- CASE WHEN --------------------------------------------------------
    def when(self, cond: "Column", value) -> "Column":
        if not isinstance(self.expr, E.CaseWhen):
            raise ValueError("when() follows F.when(...)")
        return Column(E.CaseWhen(
            self.expr.branches + [(cond.expr, _expr(value))], None))

    def otherwise(self, value) -> "Column":
        if not isinstance(self.expr, E.CaseWhen):
            raise ValueError("otherwise() follows F.when(...)")
        return Column(E.CaseWhen(self.expr.branches, _expr(value)))

    # --- strings ----------------------------------------------------------
    def substr(self, pos, length=None):
        return Column(E.Substring(self.expr, E.Literal(pos),
                                  None if length is None else E.Literal(length)))

    # --- sort orders ------------------------------------------------------
    def asc(self):
        return Column(E.SortOrder(self.expr, True))

    def desc(self):
        return Column(E.SortOrder(self.expr, False))

    def asc_nulls_first(self):
        return Column(E.SortOrder(self.expr, True, True))

    def asc_nulls_last(self):
        return Column(E.SortOrder(self.expr, True, False))

    def desc_nulls_first(self):
        return Column(E.SortOrder(self.expr, False, True))

    def desc_nulls_last(self):
        return Column(E.SortOrder(self.expr, False, False))

    # --- window -----------------------------------------------------------
    def over(self, spec) -> "Column":
        from ..expr.window import WindowExpression

        return Column(WindowExpression(self.expr, spec._partition,
                                       spec._order, spec._frame))

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return f"Column<{self.expr.simple_string()}>"

    def __bool__(self):
        raise ValueError(
            "Cannot convert Column to bool: use '&' for AND, '|' for OR")
