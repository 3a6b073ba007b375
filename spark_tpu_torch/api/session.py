"""Session entry point (counterpart of `spark_tpu/api/session.py`, the
surface of the port's slices): `TorchSession(appName, conf, device)`,
`TorchSession.builder` (appName, master, config, getOrCreate),
`newSession`, `createDataFrame` (an Arrow table, a dict of columns, rows
as dicts or as tuples with a schema, a pandas frame), `read` (Parquet,
ORC, CSV, JSON, text, Avro, XML and JDBC sources: `api/readwriter.py`),
`range`, `sql`, `table`, `catalog`, `version`, `conf` and `stop`.

`sql` runs a query, a command (plan/commands.py: DDL, DML, SHOW,
DESCRIBE, EXPLAIN, SET, variables, ANALYZE) or a BEGIN ... END script
(sql/scripting.py). A CTE the parser materialises runs once here, its
result collected to Arrow and spliced in as an in-memory relation wherever
it is read, subquery expressions included. With
`spark.sql.warehouse.dir` set, saved tables live there as Parquet
(plan/warehouse.py). Hints raise `NotPortedError`: the reference's only
hint, /*+ POOL(x) */, is its serving layer's (A14).

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

from ..columnar.encoding import configure as configure_encoding
from ..config import DEFAULT_PARALLELISM, DEVICE, WAREHOUSE_DIR, SQLConf
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
from ..types import StructType, from_arrow_type, to_arrow_type


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


class SessionBuilder:
    """`TorchSession.builder`: appName, master (local[n] sets the default
    parallelism), config and getOrCreate, which returns the active session
    with the new conf applied, or makes one."""

    def __init__(self):
        self._conf: dict[str, Any] = {}
        self._name = "spark_tpu_torch"

    def appName(self, name: str) -> "SessionBuilder":
        self._name = name
        return self

    def master(self, master: str) -> "SessionBuilder":
        if master.startswith("local[") and master.endswith("]"):
            n = master[6:-1]
            if n != "*":
                self._conf[DEFAULT_PARALLELISM.key] = int(n)
        return self

    def config(self, key=None, value=None, **kw) -> "SessionBuilder":
        if key is not None:
            self._conf[key] = value
        self._conf.update(kw)
        return self

    def getOrCreate(self) -> "TorchSession":
        if TorchSession._active is not None:
            for k, v in self._conf.items():
                TorchSession._active.conf.set(k, v)
            return TorchSession._active
        return TorchSession(self._name, self._conf)


class _Builder:
    def __get__(self, obj, objtype=None):
        return SessionBuilder()


class TorchSession:
    _active: "TorchSession | None" = None
    builder = _Builder()

    def __init__(self, appName: str = "spark_tpu_torch",
                 conf: dict[str, Any] | None = None,
                 device: str | torch.device | None = None):
        self.appName = appName
        self.conf = SQLConf(conf)
        self.device = resolve_device(device, self.conf)
        # the ingest-time RunInfo harvest follows this session's
        # spark.tpu.encoding.enabled, as the reference's session sets it
        configure_encoding(self.conf)
        self.catalog_ = Catalog()
        wh_dir = self.conf.get(WAREHOUSE_DIR)
        if wh_dir:
            from ..plan.warehouse import Warehouse

            # no write hook: the persistent result cache it feeds in the
            # reference is not ported (A12)
            self.catalog_.external = Warehouse(str(wh_dir))
        self._init_state()
        TorchSession._active = self

    def _init_state(self) -> None:
        self.catalog_.on_release = self._release_tiles
        self._analyzer = Analyzer(self.catalog_)
        self._optimizer = Optimizer()
        self._metrics = Metrics()
        self.launches = LaunchCounters()
        self._scan_cache: dict = {}
        self._table_stats: dict[str, Any] = {}  # ANALYZE TABLE output

    def _release_tiles(self, plan) -> None:
        """Drop the ingested tiles of the in-memory tables a replaced or
        dropped view read that no view of the catalog reads any more (a
        DataFrame still over one ingests it again when run)."""
        def tables(p):
            return {id(n.table) for n in p.iter_nodes()
                    if isinstance(n, LocalRelation)}

        gone = tables(plan)
        for live in self.catalog_.plans():
            gone -= tables(live)
        for tid in gone:
            self._scan_cache.pop(tid, None)

    def newSession(self) -> "TorchSession":
        """A session with its own conf (a copy of this one's overrides),
        temp views, variables, statistics, metrics and ingested tiles, on
        the same device, sharing only the warehouse. The reference's clone
        also reads its parent's views and variables through, for its
        server's per-connection sessions (serve/, A14)."""
        clone = object.__new__(TorchSession)
        clone.appName = self.appName
        clone.conf = SQLConf(self.conf.overrides())
        clone.device = self.device
        clone.catalog_ = Catalog()
        clone.catalog_.external = self.catalog_.external
        clone._init_state()
        return clone

    def _planner(self) -> Planner:
        return Planner(self.conf)

    def _exec_context(self) -> ExecContext:
        return ExecContext(conf=self.conf, device=self.device,
                           metrics=self._metrics, launches=self.launches,
                           scan_cache=self._scan_cache)

    @property
    def metrics(self) -> dict:
        return self._metrics.snapshot()

    @property
    def catalog(self) -> "_CatalogApi":
        return _CatalogApi(self)

    def version(self) -> str:
        from .. import __version__

        return __version__

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
        """A DataFrame over a query; a command runs now and returns its
        result rows, a BEGIN ... END script its last query's result."""
        from ..plan.commands import Command, run_command
        from ..sql.parser import parse_sql
        from ..sql.scripting import execute_script, is_script
        from .dataframe import DataFrame

        if is_script(sqlText):
            return execute_script(self, sqlText)
        if _HINT_RE.search(sqlText):
            raise NotPortedError("SQL hints (/*+ ... */)")
        plan = parse_sql(sqlText)
        if isinstance(plan, Command):
            return run_command(self, plan)
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
        if TorchSession._active is self:
            TorchSession._active = None


class _CatalogApi:
    """`session.catalog` (pyspark's Catalog shape)."""

    def __init__(self, session: TorchSession):
        self.s = session

    def listTables(self):
        return self.s.catalog_.list_tables()

    def dropTempView(self, name: str) -> bool:
        return self.s.catalog_.drop(name)

    def tableExists(self, name: str) -> bool:
        try:
            self.s.catalog_.lookup(name.split("."))
            return True
        except Exception:
            return False

    def listColumns(self, table: str):
        """name, dataType and nullable of each column of a table."""
        from ..exec.query_execution import QueryExecution

        plan = self.s.catalog_.lookup(table.split("."))
        analyzed = QueryExecution(self.s, plan).analyzed
        return [{"name": a.name, "dataType": str(a.dtype),
                 "nullable": bool(a.nullable)} for a in analyzed.output]

    def listFunctions(self, pattern: str | None = None):
        from ..expr.registry import filter_names

        return filter_names(pattern)

    def functionExists(self, name: str) -> bool:
        from ..expr.registry import function_exists

        return function_exists(name)

    def cacheTable(self, name: str) -> None:
        raise NotPortedError("cacheTable (the block store, A12)")

    def uncacheTable(self, name: str) -> None:
        raise NotPortedError("uncacheTable (the block store, A12)")


_HINT_RE = re.compile(r"/\*\+")


def _to_arrow_table(data, schema) -> pa.Table:
    """An Arrow table from a table, a dict of columns, a pandas frame, or
    rows: dicts, or tuples with a schema (a StructType or column names)."""
    if isinstance(data, pa.Table):
        return data
    if type(data).__module__.split(".")[0] == "pandas":
        return pa.Table.from_pandas(data, preserve_index=False)
    if isinstance(data, dict):
        return pa.table(data)
    if isinstance(data, (list, tuple)):
        if not data:
            raise ValueError("cannot infer schema from empty data")
        first = data[0]
        if isinstance(first, dict):
            names = list(first.keys())
            return pa.table({n: [r.get(n) for r in data] for n in names})
        if isinstance(first, (list, tuple)):
            if schema is None:
                raise ValueError("schema required for list-of-tuples")
            if isinstance(schema, StructType):
                arrays = [pa.array([r[i] for r in data],
                                   type=to_arrow_type(f.dataType))
                          for i, f in enumerate(schema.fields)]
                return pa.table(arrays, names=schema.names)
            names = list(schema)
            return pa.table({n: [r[i] for r in data]
                             for i, n in enumerate(names)})
    raise TypeError(f"cannot create DataFrame from {type(data)}")
