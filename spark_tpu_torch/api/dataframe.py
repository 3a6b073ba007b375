"""DataFrame API (counterpart of `spark_tpu/api/dataframe.py`, the port's
subset): a lazy wrapper over a logical plan bound to a session; groupBy,
rollup and cube hand a GroupedData to `agg`."""

from __future__ import annotations

import itertools

import pyarrow as pa

from ..errors import AnalysisException, NotPortedError, UnresolvedColumnError
from ..exec.query_execution import QueryExecution
from ..expr import expressions as E
from ..plan import logical as L
from .column import Column, _expr


class Row(dict):
    """Dict-backed row with attribute access."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in self.items())
        return f"Row({inner})"


def _to_expr_list(cols, allow_str=True) -> list[E.Expression]:
    out = []
    for c in cols:
        if isinstance(c, Column):
            out.append(c.expr)
        elif isinstance(c, E.Expression):
            out.append(c)
        elif isinstance(c, str) and allow_str:
            out.append(E.UnresolvedStar() if c == "*"
                       else E.UnresolvedAttribute(c.split(".")))
        else:
            out.append(E.Literal(c))
    return out


class DataFrame:
    def __init__(self, session, plan: L.LogicalPlan):
        self.session = session
        self.plan = plan
        self._qe: QueryExecution | None = None

    def _with(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(self.session, plan)

    @property
    def query_execution(self) -> QueryExecution:
        if self._qe is None:
            self._qe = QueryExecution(self.session, self.plan)
        return self._qe

    @property
    def columns(self) -> list[str]:
        return [a.name for a in self.query_execution.analyzed.output]

    def __getitem__(self, item):
        if isinstance(item, str):
            for a in self.query_execution.analyzed.output:
                if a.name == item:
                    return Column(a)
            raise UnresolvedColumnError(item, self.columns[:5])
        if isinstance(item, (list, tuple)):
            return self.select(*item)
        if isinstance(item, Column):
            return self.filter(item)
        raise TypeError(f"cannot index DataFrame with {type(item)}")

    # --- transformations ----------------------------------------------
    def select(self, *cols) -> "DataFrame":
        return self._with(L.Project(_to_expr_list(cols or ("*",)), self.plan))

    def filter(self, condition) -> "DataFrame":
        if isinstance(condition, str):
            raise NotPortedError("string filter conditions (the SQL parser)")
        return self._with(L.Filter(_expr(condition), self.plan))

    def withColumn(self, name: str, col: Column) -> "DataFrame":
        exprs: list[E.Expression] = []
        replaced = False
        for a in self.query_execution.analyzed.output:
            if a.name == name:
                exprs.append(E.Alias(_expr(col), name))
                replaced = True
            else:
                exprs.append(a)
        if not replaced:
            exprs.append(E.Alias(_expr(col), name))
        return self._with(L.Project(exprs, self.plan))

    def repartition(self, num_or_col, *cols) -> "DataFrame":
        if isinstance(num_or_col, int):
            return self._with(L.Repartition(num_or_col, True,
                                            _to_expr_list(cols), self.plan))
        return self._with(L.Repartition(
            None, True, _to_expr_list((num_or_col,) + cols), self.plan))

    def limit(self, n: int) -> "DataFrame":
        return self._with(L.Limit(n, self.plan))

    def offset(self, n: int) -> "DataFrame":
        return self._with(L.Offset(n, self.plan))

    def sort(self, *cols, ascending=None) -> "DataFrame":
        exprs = _to_expr_list(cols)
        if ascending is None:
            asc_list = [True] * len(exprs)
        elif isinstance(ascending, bool):
            asc_list = [ascending] * len(exprs)
        else:
            asc_list = list(ascending)
        orders = [e if isinstance(e, E.SortOrder) else E.SortOrder(e, a)
                  for e, a in zip(exprs, asc_list)]
        return self._with(L.Sort(orders, True, self.plan))

    orderBy = sort

    def sortWithinPartitions(self, *cols) -> "DataFrame":
        orders = [e if isinstance(e, E.SortOrder) else E.SortOrder(e, True)
                  for e in _to_expr_list(cols)]
        return self._with(L.Sort(orders, False, self.plan))

    def join(self, other: "DataFrame", on=None,
             how: str = "inner") -> "DataFrame":
        if on is None or isinstance(on, Column):
            cond = None if on is None else on.expr
            return self._with(L.Join(self.plan, other.plan, how, cond))
        if isinstance(on, str):
            on = [on]
        cond = None
        for name in on:
            c = E.EqualTo(_resolve_using(self, name),
                          _resolve_using(other, name))
            cond = c if cond is None else E.And(cond, c)
        # USING semantics: the output keeps each key column once (the
        # left side's)
        df = self._with(L.Join(self.plan, other.plan, how, cond))
        drop_ids = {_resolve_using(other, name).expr_id for name in on}
        keep = [a for a in df.query_execution.analyzed.output
                if a.expr_id not in drop_ids]
        return df._with(L.Project(keep, df.query_execution.analyzed))

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        return self._with(L.Join(self.plan, other.plan, "cross", None))

    def groupBy(self, *cols) -> "GroupedData":
        return GroupedData(self, _to_expr_list(cols))

    def rollup(self, *cols) -> "GroupedData":
        return GroupedData(self, _to_expr_list(cols), sets_kind="rollup")

    def cube(self, *cols) -> "GroupedData":
        return GroupedData(self, _to_expr_list(cols), sets_kind="cube")

    def agg(self, *cols) -> "DataFrame":
        return GroupedData(self, []).agg(*cols)

    def createOrReplaceTempView(self, name: str) -> None:
        self.session.catalog_.register(name, self.plan)

    # --- actions -------------------------------------------------------
    @property
    def write(self):
        from .readwriter import DataFrameWriter

        return DataFrameWriter(self)

    def toArrow(self) -> pa.Table:
        return self.query_execution.to_arrow()

    def explain(self, mode: str = "formatted") -> None:
        """Print the query plans and the compile tier with its reason."""
        print(self.query_execution.explain_string(mode))

    def count(self) -> int:
        agg = L.Aggregate([], [E.Alias(E.Count(None), "count")], self.plan)
        t = QueryExecution(self.session, agg).to_arrow()
        return int(t.column(0)[0].as_py())

    def collect(self) -> list[Row]:
        t = self.toArrow()
        return [Row(zip(t.column_names, vals))
                for vals in zip(*[c.to_pylist() for c in t.columns])] \
            if t.num_columns else []


def _resolve_using(df: DataFrame, name: str) -> E.AttributeReference:
    for a in df.query_execution.analyzed.output:
        if a.name.lower() == name.lower():
            return a
    raise AnalysisException(f"USING column {name} not found")


class GroupedData:
    """Role of RelationalGroupedDataset."""

    def __init__(self, df: DataFrame, grouping: list[E.Expression],
                 sets_kind: str | None = None):
        self.df = df
        self.grouping = grouping
        self._sets_kind = sets_kind  # "rollup" | "cube" | None

    def agg(self, *cols) -> DataFrame:
        out = list(self.grouping) + _to_expr_list(cols, allow_str=False)
        if self._sets_kind is not None:
            n = len(self.grouping)
            if self._sets_kind == "rollup":
                sets = [list(range(n - i)) for i in range(n + 1)]
            else:  # cube: every subset
                sets = [list(c) for k in range(n, -1, -1)
                        for c in itertools.combinations(range(n), k)]
            return self.df._with(
                L.GroupingSets(sets, self.grouping, out, self.df.plan))
        return self.df._with(L.Aggregate(self.grouping, out, self.df.plan))
