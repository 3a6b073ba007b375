"""Window specification API (counterpart of `spark_tpu/api/window.py`, the
pyspark.sql.Window analog): `Window.partitionBy(...).orderBy(...)` with
`rowsBetween` and `rangeBetween`, consumed by `Column.over`."""

from __future__ import annotations

from ..expr import expressions as E
from .column import Column, _expr


class WindowSpec:
    def __init__(self, partition_spec=(), order_spec=(), frame=None):
        self._partition = list(partition_spec)
        self._order = list(order_spec)
        self._frame = frame

    def partitionBy(self, *cols) -> "WindowSpec":
        exprs = [_to_expr(c) for c in cols]
        return WindowSpec(self._partition + exprs, self._order, self._frame)

    def orderBy(self, *cols) -> "WindowSpec":
        orders = []
        for c in cols:
            e = _to_expr(c)
            orders.append(e if isinstance(e, E.SortOrder)
                          else E.SortOrder(e, True))
        return WindowSpec(self._partition, self._order + orders, self._frame)

    def rowsBetween(self, start, end) -> "WindowSpec":
        def off(v):
            if v <= Window.unboundedPreceding:
                return None
            if v >= Window.unboundedFollowing:
                return None
            return int(v)

        return WindowSpec(self._partition, self._order,
                          ("rows", off(start), off(end)))

    def rangeBetween(self, start, end) -> "WindowSpec":
        if start <= Window.unboundedPreceding and end == 0:
            return WindowSpec(self._partition, self._order, None)
        if start <= Window.unboundedPreceding and \
                end >= Window.unboundedFollowing:
            return WindowSpec(self._partition, self._order,
                              ("rows", None, None))

        def off(v):
            if v <= Window.unboundedPreceding or \
                    v >= Window.unboundedFollowing:
                return None
            return int(v)

        return WindowSpec(self._partition, self._order,
                          ("vrange", off(start), off(end)))


class Window:
    unboundedPreceding = -(1 << 62)
    unboundedFollowing = 1 << 62
    currentRow = 0

    @staticmethod
    def partitionBy(*cols) -> WindowSpec:
        return WindowSpec().partitionBy(*cols)

    @staticmethod
    def orderBy(*cols) -> WindowSpec:
        return WindowSpec().orderBy(*cols)


def _to_expr(c):
    if isinstance(c, Column):
        return c.expr
    if isinstance(c, str):
        return E.UnresolvedAttribute(c.split("."))
    return _expr(c)
