"""`df.stat` (counterpart of `spark_tpu/api/stat.py`): corr and cov (one
aggregate each, `F.corr` and `F.covar_samp`), approxQuantile (the
reference's exact quantiles: the column collected and sorted), freqItems
and crosstab, each over the port's queries. `sampleBy` raises
NotPortedError: it samples (SampleExec, A15)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..errors import NotPortedError
from . import functions as F


class DataFrameStatFunctions:
    def __init__(self, df):
        self.df = df

    def corr(self, col1: str, col2: str) -> float:
        out = self.df.agg(F.corr(col1, col2).alias("c")).collect()
        return float(out[0]["c"])

    def cov(self, col1: str, col2: str) -> float:
        out = self.df.agg(F.covar_samp(col1, col2).alias("c")).collect()
        return float(out[0]["c"])

    def approxQuantile(self, col, probabilities: Sequence[float],
                       relativeError: float = 0.0):
        """Exact quantiles: the reference's choice over Spark's
        Greenwald-Khanna sketch (`relativeError` is ignored)."""
        cols = [col] if isinstance(col, str) else list(col)
        sorted_df = self.df.select(*cols)
        table = sorted_df.toArrow()
        out = []
        for c in cols:
            vals = np.sort(np.asarray(
                table.column(c).drop_null().to_numpy(zero_copy_only=False),
                dtype=np.float64))
            if len(vals) == 0:
                out.append([float("nan")] * len(probabilities))
                continue
            qs = []
            for p in probabilities:
                idx = min(int(p * len(vals)), len(vals) - 1)
                qs.append(float(vals[idx]))
            out.append(qs)
        return out[0] if isinstance(col, str) else out

    def freqItems(self, cols: Sequence[str], support: float = 0.01):
        """Frequent items per column (reference: StatFunctions.freqItems)."""
        n = self.df.count()
        threshold = max(int(n * support), 1)
        result = {}
        for c in cols:
            counts = (self.df.groupBy(c).agg(F.count("*").alias("cnt"))
                      .filter(F.col("cnt") >= threshold)
                      .toArrow().to_pydict())
            result[c + "_freqItems"] = counts[c]
        return result

    def crosstab(self, col1: str, col2: str):
        """Contingency table as a DataFrame."""
        import pyarrow as pa

        counts = (self.df.groupBy(col1, col2)
                  .agg(F.count("*").alias("cnt")).toArrow().to_pydict())
        rows = sorted(set(map(str, counts[col1])))
        cols = sorted(set(map(str, counts[col2])))
        grid = {r: {c: 0 for c in cols} for r in rows}
        for r, c, n in zip(counts[col1], counts[col2], counts["cnt"]):
            grid[str(r)][str(c)] = n
        data = {f"{col1}_{col2}": rows}
        for c in cols:
            data[c] = [grid[r][c] for r in rows]
        return self.df.session.createDataFrame(pa.table(data))

    def sampleBy(self, col: str, fractions: dict, seed: int = 42):
        raise NotPortedError("stat.sampleBy (SampleExec, A15)")
