"""`df.na` (counterpart of `spark_tpu/api/na.py`, copied): drop, fill and
replace, each a chain of the port's DataFrame filters and projections."""

from __future__ import annotations

from typing import Any, Sequence

from . import functions as F
from ..types import NumericType, StringType


class DataFrameNaFunctions:
    def __init__(self, df):
        self.df = df

    def drop(self, how: str = "any", subset: Sequence[str] | None = None):
        cols = list(subset) if subset else self.df.columns
        if how == "any":
            out = self.df
            for c in cols:
                out = out.filter(F.col(c).isNotNull())
            return out
        # how == "all": keep rows with at least one non-null
        cond = None
        for c in cols:
            p = F.col(c).isNotNull()
            cond = p if cond is None else (cond | p)
        return self.df.filter(cond)

    def fill(self, value, subset: Sequence[str] | None = None):
        out = self.df
        schema = {f.name: f.dataType for f in self.df.schema}
        if isinstance(value, dict):
            items = value.items()
        else:
            cols = list(subset) if subset else self.df.columns
            items = []
            for c in cols:
                dt = schema[c]
                if isinstance(value, str) and not isinstance(dt, StringType):
                    continue
                if isinstance(value, (int, float)) and not isinstance(
                        dt, NumericType):
                    continue
                items.append((c, value))
        for c, v in items:
            out = out.withColumn(c, F.coalesce(F.col(c), F.lit(v)))
        return out

    def replace(self, to_replace, value=None,
                subset: Sequence[str] | None = None):
        mapping = to_replace if isinstance(to_replace, dict) \
            else {to_replace: value}
        cols = list(subset) if subset else self.df.columns
        schema = {f.name: f.dataType for f in self.df.schema}
        out = self.df
        for c in cols:
            dt = schema[c]
            expr = None
            applied = False
            for old, new in mapping.items():
                if isinstance(old, str) != isinstance(dt, StringType):
                    continue
                branch = F.when(F.col(c) == old, F.lit(new))
                expr = branch if expr is None else expr.when(
                    F.col(c) == old, F.lit(new))
                applied = True
            if applied:
                out = out.withColumn(c, expr.otherwise(F.col(c)))
        return out
