"""DataFrame API (counterpart of `spark_tpu/api/dataframe.py`): a lazy
wrapper over a logical plan bound to a session; groupBy, rollup and cube
hand a GroupedData to `agg`, `pivot` and the shorthand aggregates.

Not ported, each raising NotPortedError naming its ROADMAP.md item:
`sample` (SampleExec, A15), `cache`, `persist` and `unpersist` (the block
store, A12), `mapInPandas` and `applyInPandas` (A15), and the streaming
surface (`isStreaming`, `withWatermark`, `writeStream`: A14)."""

from __future__ import annotations

import itertools

import pyarrow as pa

from typing import Sequence

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
    def schema(self):
        from ..types import StructField, StructType

        return StructType([StructField(a.name, a.dtype, a.nullable)
                           for a in self.query_execution.analyzed.output])

    @property
    def columns(self) -> list[str]:
        return [a.name for a in self.query_execution.analyzed.output]

    @property
    def dtypes(self) -> list[tuple[str, str]]:
        return [(f.name, f.dataType.simple_string()) for f in self.schema]

    def printSchema(self) -> None:
        for f in self.schema:
            print(f" |-- {f.name}: {f.dataType.simple_string()} "
                  f"(nullable = {str(f.nullable).lower()})")

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

    def selectExpr(self, *exprs: str) -> "DataFrame":
        from ..sql.parser import parse_expression

        return self._with(L.Project(
            [parse_expression(e) for e in exprs], self.plan))

    def filter(self, condition) -> "DataFrame":
        if isinstance(condition, str):
            from ..sql.parser import parse_expression

            cond = parse_expression(condition)
        else:
            cond = _expr(condition)
        return self._with(L.Filter(cond, self.plan))

    where = filter

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

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        exprs = [E.Alias(a, new) if a.name == old else a
                 for a in self.query_execution.analyzed.output]
        return self._with(L.Project(exprs, self.plan))

    def drop(self, *names: str) -> "DataFrame":
        keep = [a for a in self.query_execution.analyzed.output
                if a.name not in names]
        return self._with(L.Project(keep, self.plan))

    def alias(self, alias: str) -> "DataFrame":
        return self._with(L.SubqueryAlias(alias, self.plan))

    def distinct(self) -> "DataFrame":
        return self._with(L.Distinct(self.plan))

    def dropDuplicates(self, subset: Sequence[str] | None = None
                       ) -> "DataFrame":
        """Distinct rows, or one row per distinct `subset`: its other
        columns take their first non-null value."""
        if subset is None:
            return self.distinct()
        names = set(subset)
        out = [a if a.name in names else E.Alias(E.First(a), a.name)
               for a in self.query_execution.analyzed.output]
        return self._with(L.Aggregate(_to_expr_list(subset), out,
                                      self.plan))

    def union(self, other: "DataFrame") -> "DataFrame":
        return self._with(L.Union([self.plan, other.plan]))

    unionAll = union

    def repartition(self, num_or_col, *cols) -> "DataFrame":
        if isinstance(num_or_col, int):
            return self._with(L.Repartition(num_or_col, True,
                                            _to_expr_list(cols), self.plan))
        return self._with(L.Repartition(
            None, True, _to_expr_list((num_or_col,) + cols), self.plan))

    def coalesce(self, n: int) -> "DataFrame":
        return self._with(L.Repartition(n, False, [], self.plan))

    def sample(self, fraction: float, seed: int = 42) -> "DataFrame":
        raise NotPortedError("sample (SampleExec, A15)")

    def cache(self) -> "DataFrame":
        raise NotPortedError("cache (the block store, A12)")

    persist = cache

    def unpersist(self) -> "DataFrame":
        raise NotPortedError("unpersist (the block store, A12)")

    def mapInPandas(self, fn, schema) -> "DataFrame":
        raise NotPortedError("mapInPandas (A15)")

    @property
    def isStreaming(self) -> bool:
        raise NotPortedError("streaming (isStreaming, A14)")

    def withWatermark(self, column: str, delay: str) -> "DataFrame":
        raise NotPortedError("streaming (withWatermark, A14)")

    @property
    def writeStream(self):
        raise NotPortedError("streaming (writeStream, A14)")

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

    groupby = groupBy

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

    def toPandas(self):
        return self.toArrow().to_pandas()

    def first(self) -> Row | None:
        rows = self.limit(1).collect()
        return rows[0] if rows else None

    def head(self, n: int = 1):
        rows = self.limit(n).collect()
        return rows[0] if n == 1 and rows else rows

    def take(self, n: int) -> list[Row]:
        return self.limit(n).collect()

    def isEmpty(self) -> bool:
        return len(self.take(1)) == 0

    def show(self, n: int = 20, truncate: bool = True) -> None:
        t = self.limit(n).toArrow()
        names = t.column_names
        rows = [[_fmt(v, truncate) for v in col.to_pylist()]
                for col in t.columns]
        widths = [max([len(nm)] + [len(r[i]) for i in range(len(r))])
                  for nm, r in zip(names, rows)] if t.num_rows else \
            [len(nm) for nm in names]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        print(sep)
        print("|" + "|".join(f" {nm:<{w}} " for nm, w in zip(names, widths))
              + "|")
        print(sep)
        for ri in range(t.num_rows):
            print("|" + "|".join(
                f" {rows[ci][ri]:<{widths[ci]}} " for ci in range(len(names)))
                + "|")
        print(sep)

    def describe(self, *cols: str) -> "DataFrame":
        """count, mean, stddev, min and max of the numeric columns (all,
        or those named), as strings, one row per statistic."""
        from ..types import NumericType
        from . import functions as FN

        targets = [f.name for f in self.schema
                   if isinstance(f.dataType, NumericType)
                   and (not cols or f.name in cols)]
        if not targets:
            return self.session.createDataFrame(
                pa.table({"summary": pa.array([], pa.string())}))
        aggs = []
        for c in targets:
            aggs += [FN.count(c).alias(f"count_{c}"),
                     FN.avg(c).alias(f"mean_{c}"),
                     FN.stddev(c).alias(f"stddev_{c}"),
                     FN.min(c).alias(f"min_{c}"),
                     FN.max(c).alias(f"max_{c}")]
        row = self.agg(*aggs).collect()[0]
        stats = ["count", "mean", "stddev", "min", "max"]
        data = {"summary": stats}
        for c in targets:
            data[c] = [str(row[f"{st}_{c}"]) for st in stats]
        return self.session.createDataFrame(pa.table(data))

    summary = describe

    @property
    def stat(self):
        from .stat import DataFrameStatFunctions

        return DataFrameStatFunctions(self)

    @property
    def na(self):
        from .na import DataFrameNaFunctions

        return DataFrameNaFunctions(self)

    def fillna(self, value, subset=None) -> "DataFrame":
        return self.na.fill(value, subset)

    def dropna(self, how: str = "any", subset=None) -> "DataFrame":
        return self.na.drop(how, subset)

    def replace(self, to_replace, value=None, subset=None) -> "DataFrame":
        return self.na.replace(to_replace, value, subset)

    def unpivot(self, ids, values, variableColumnName: str = "variable",
                valueColumnName: str = "value") -> "DataFrame":
        """Wide to long: a union of one projection per value column."""
        ids = [ids] if isinstance(ids, str) else list(ids)
        values = [values] if isinstance(values, str) else list(values)
        branches = [self.select(
            *ids,
            Column(E.Alias(E.Literal(v), variableColumnName)),
            Column(E.Alias(E.UnresolvedAttribute([v]),
                           valueColumnName))).plan for v in values]
        return self._with(L.Union(branches))

    melt = unpivot


def _fmt(v, truncate: bool) -> str:
    s = "NULL" if v is None else str(v)
    if truncate and len(s) > 20:
        s = s[:17] + "..."
    return s


def _resolve_using(df: DataFrame, name: str) -> E.AttributeReference:
    for a in df.query_execution.analyzed.output:
        if a.name.lower() == name.lower():
            return a
    raise AnalysisException(f"USING column {name} not found")


class GroupedData:
    """Role of RelationalGroupedDataset."""

    def __init__(self, df: DataFrame, grouping: list[E.Expression],
                 sets_kind: str | None = None,
                 pivot_col: str | None = None,
                 pivot_values: list | None = None):
        self.df = df
        self.grouping = grouping
        self._sets_kind = sets_kind  # "rollup" | "cube" | None
        self._pivot_col = pivot_col
        self._pivot_values = pivot_values

    def pivot(self, pivot_col: str, values: list | None = None
              ) -> "GroupedData":
        """Each pivot value becomes a conditional aggregate column; without
        `values`, the column's distinct non-null values in order."""
        if values is None:
            vals = (self.df.select(pivot_col).distinct()
                    .orderBy(pivot_col).toArrow().column(0).to_pylist())
            values = [v for v in vals if v is not None]
        return GroupedData(self.df, self.grouping, self._sets_kind,
                           pivot_col, list(values))

    def agg(self, *cols) -> DataFrame:
        aggs = _to_expr_list(cols, allow_str=False)
        if self._pivot_col is not None:
            aggs = self._pivot_aggs(aggs)
        out = list(self.grouping) + aggs
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

    def _pivot_aggs(self, aggs: list[E.Expression]) -> list[E.Expression]:
        pivot_attr = E.UnresolvedAttribute([self._pivot_col])
        out: list[E.Expression] = []
        for v in self._pivot_values:
            for a in aggs:
                inner = a.child if isinstance(a, E.Alias) else a
                base = a.name if isinstance(a, E.Alias) else None

                def guard(x: E.Expression) -> E.Expression:
                    if isinstance(x, E.AggregateFunction) and \
                            x.child is not None:
                        return x.copy(child=E.If(
                            E.EqualTo(pivot_attr, E.Literal(v)),
                            x.child, E.Literal(None)))
                    if isinstance(x, E.Count) and x.child is None:
                        return E.Count(E.If(
                            E.EqualTo(pivot_attr, E.Literal(v)),
                            E.Literal(1), E.Literal(None)))
                    return x

                guarded = inner.transform_up(guard)
                name = str(v) if len(aggs) == 1 and base is None \
                    else (f"{v}_{base}" if base else f"{v}_{len(out)}")
                out.append(E.Alias(guarded, name))
        return out

    def count(self) -> DataFrame:
        return self.agg(Column(E.Alias(E.Count(None), "count")))

    def sum(self, *names: str) -> DataFrame:  # noqa: A003
        return self.agg(*[Column(E.Sum(E.UnresolvedAttribute([n])))
                          for n in names])

    def avg(self, *names: str) -> DataFrame:
        return self.agg(*[Column(E.Average(E.UnresolvedAttribute([n])))
                          for n in names])

    mean = avg

    def min(self, *names: str) -> DataFrame:  # noqa: A003
        return self.agg(*[Column(E.Min(E.UnresolvedAttribute([n])))
                          for n in names])

    def max(self, *names: str) -> DataFrame:  # noqa: A003
        return self.agg(*[Column(E.Max(E.UnresolvedAttribute([n])))
                          for n in names])

    def applyInPandas(self, fn, schema=None) -> DataFrame:
        raise NotPortedError("applyInPandas (A15)")
