"""Session catalog (counterpart of `spark_tpu/plan/catalog.py`): an
in-memory registry of temp views and tables, a persistent warehouse behind
`external` (plan/warehouse.py) when `spark.sql.warehouse.dir` is set, and
the SQL session variables (`variables`: name, lower case -> Literal).

`on_release`, when set, is called with the plan a view held after the
view is replaced or dropped: the session lets that plan's ingested tiles
go (api/session.py)."""

from __future__ import annotations

from ..errors import AnalysisException
from .logical import LogicalPlan


class Catalog:
    def __init__(self, case_sensitive: bool = False):
        self._tables: dict[str, LogicalPlan] = {}
        self.case_sensitive = case_sensitive
        self.external = None  # Warehouse (plan/warehouse.py) when configured
        self.variables: dict = {}
        self.on_release = None

    def _norm(self, name: str) -> str:
        return name if self.case_sensitive else name.lower()

    def register(self, name: str, plan: LogicalPlan) -> None:
        old = self._tables.get(self._norm(name))
        self._tables[self._norm(name)] = plan
        if old is not None and old is not plan:
            self._released(old)

    def drop(self, name: str) -> bool:
        old = self._tables.pop(self._norm(name), None)
        if old is not None:
            self._released(old)
        return old is not None

    def _released(self, plan: LogicalPlan) -> None:
        if self.on_release is not None:
            self.on_release(plan)

    def plans(self) -> list[LogicalPlan]:
        return list(self._tables.values())

    def lookup(self, name_parts) -> LogicalPlan:
        name = ".".join(name_parts)
        p = self._tables.get(self._norm(name))
        if p is None and len(name_parts) > 1:
            p = self._tables.get(self._norm(name_parts[-1]))
        if p is None and self.external is not None:
            p = self.external.lookup(self._norm(name_parts[-1]))
        if p is None:
            raise AnalysisException(
                f"Table or view not found: {name}",
                error_class="TABLE_OR_VIEW_NOT_FOUND")
        return p

    def list_tables(self) -> list[str]:
        out = set(self._tables)
        if self.external is not None:
            out |= set(self.external.list_tables())
        return sorted(out)
