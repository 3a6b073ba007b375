"""Session entry point (counterpart of `spark_tpu/api/session.py`, the
surface of the port's slices): `TorchSession(appName, conf, device)`,
`createDataFrame`, `read` (Parquet, ORC, CSV, JSON, text, Avro, XML and
JDBC sources: `api/readwriter.py`), `range`, `sql` (SELECT queries over
temp views; a CTE the parser materialises runs once here, its result
collected to Arrow and spliced in as an in-memory relation wherever it is
read, subquery expressions included), `table`, `conf` and `stop`. SQL
scripting, hints and commands raise `NotPortedError`.

The session runs on CUDA unless the caller asks for the CPU, by
`device="cpu"` or the conf key `spark.torch.device`. With no card and no
explicit CPU it raises `DeviceUnavailableError`; there is no silent
fallback.
"""

from __future__ import annotations

import re
from typing import Any

import pyarrow as pa
import torch

from ..config import DEFAULT_PARALLELISM, DEVICE, SQLConf
from ..errors import DeviceUnavailableError, NotPortedError
from ..exec.context import ExecContext, Metrics
from ..expr.expressions import AttributeReference
from ..physical.compile import LaunchCounters
from ..physical.planner import Planner
from ..plan.analyzer import Analyzer
from ..plan.catalog import Catalog
from ..plan.logical import (
    LocalRelation, LogicalRelation, RangeRelation, UnresolvedRelation,
    WithCTE,
)
from ..plan.optimizer import Optimizer
from ..types import from_arrow_type


def resolve_device(requested: str | torch.device | None,
                   conf: SQLConf) -> torch.device:
    """The session's device: the argument, else `spark.torch.device`, else
    cuda. CUDA without a card raises."""
    dev = torch.device(requested if requested is not None
                       else conf.get(DEVICE))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device is available; pass device='cpu' (or set "
            "spark.torch.device=cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise NotPortedError(f"device type {dev.type}")
    return dev


class TorchSession:
    def __init__(self, appName: str = "spark_tpu_torch",
                 conf: dict[str, Any] | None = None,
                 device: str | torch.device | None = None):
        self.appName = appName
        self.conf = SQLConf(conf)
        self.device = resolve_device(device, self.conf)
        self.catalog_ = Catalog()
        self._analyzer = Analyzer(self.catalog_)
        self._optimizer = Optimizer()
        self._metrics = Metrics()
        self.launches = LaunchCounters()
        self._scan_cache: dict = {}

    def _planner(self) -> Planner:
        return Planner(self.conf)

    def _exec_context(self) -> ExecContext:
        return ExecContext(conf=self.conf, device=self.device,
                           metrics=self._metrics, launches=self.launches,
                           scan_cache=self._scan_cache)

    @property
    def metrics(self) -> dict:
        return self._metrics.snapshot()

    def createDataFrame(self, data, schema=None):
        from .dataframe import DataFrame

        table = _to_arrow_table(data, schema)
        attrs = [AttributeReference(f.name, from_arrow_type(f.type),
                                    f.nullable)
                 for f in table.schema]
        return DataFrame(self, LocalRelation(attrs, table))

    @property
    def read(self):
        from .readwriter import DataFrameReader

        return DataFrameReader(self)

    def range(self, start: int, end: int | None = None, step: int = 1,
              numPartitions: int | None = None):
        """int64 `id` from start to end (exclusive) by step, in
        numPartitions partitions (default spark.default.parallelism)."""
        from .dataframe import DataFrame

        if end is None:
            start, end = 0, start
        n = numPartitions or int(self.conf.get(DEFAULT_PARALLELISM))
        return DataFrame(self, RangeRelation(start, end, step, n))

    def table(self, name: str):
        from .dataframe import DataFrame

        return DataFrame(self, UnresolvedRelation(name.split(".")))

    def sql(self, sqlText: str):
        """A DataFrame over one SELECT query (sql/parser.py's grammar)."""
        from ..sql.parser import parse_sql
        from .dataframe import DataFrame

        if _HINT_RE.search(sqlText):
            raise NotPortedError("SQL hints (/*+ ... */)")
        plan = parse_sql(sqlText)
        if isinstance(plan, WithCTE):
            plan = self._materialize_ctes(plan)
        return DataFrame(self, plan)

    def _materialize_ctes(self, wplan: WithCTE):
        """Run each materialised CTE body once, collect it to Arrow and
        splice it into every site that reads it as an in-memory relation,
        each site with fresh attribute ids over the shared table (the
        reference's WithCTE round trip through the host)."""
        from .dataframe import DataFrame

        mapping = {}
        for uniq, body in wplan.materializations:
            body = self._splice_relations(body, mapping)
            table = DataFrame(self, body).toArrow()
            self._metrics.add("cte.materialized")
            mapping[uniq.lower()] = self.createDataFrame(table).plan
        return self._splice_relations(wplan.child, mapping)

    @classmethod
    def _splice_relations(cls, plan, mapping):
        """Each read of a materialised CTE, in the plan and in the plans of
        its subquery expressions, becomes an in-memory relation."""
        from ..plan.subquery import map_subquery_plans

        def fresh(rel):
            attrs = [AttributeReference(a.name, a.dtype, a.nullable)
                     for a in rel.output]
            if isinstance(rel, LocalRelation):
                return LocalRelation(attrs, rel.table)
            return LogicalRelation(rel.source, attrs, rel.name)

        def rule(node):
            if isinstance(node, UnresolvedRelation):
                rel = mapping.get(node.name.lower())
                return fresh(rel) if rel is not None else node
            return map_subquery_plans(
                node, lambda p: cls._splice_relations(p, mapping))

        return plan.transform_up(rule)

    def stop(self) -> None:
        self._scan_cache.clear()


_HINT_RE = re.compile(r"/\*\+")


def _to_arrow_table(data, schema) -> pa.Table:
    if schema is not None:
        raise NotPortedError("createDataFrame with an explicit schema")
    if isinstance(data, pa.Table):
        return data
    if isinstance(data, dict):
        return pa.table(data)
    if isinstance(data, (list, tuple)) and data and isinstance(data[0], dict):
        names = list(data[0].keys())
        return pa.table({n: [r.get(n) for r in data] for n in names})
    raise NotPortedError(f"createDataFrame from {type(data).__name__}")
