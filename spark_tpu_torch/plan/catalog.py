"""Session catalog (counterpart of `spark_tpu/plan/catalog.py`): an
in-memory registry of temp views. The external metastore and session
variables are not ported."""

from __future__ import annotations

from ..errors import AnalysisException
from .logical import LogicalPlan


class Catalog:
    def __init__(self, case_sensitive: bool = False):
        self._tables: dict[str, LogicalPlan] = {}
        self.case_sensitive = case_sensitive

    def _norm(self, name: str) -> str:
        return name if self.case_sensitive else name.lower()

    def register(self, name: str, plan: LogicalPlan) -> None:
        self._tables[self._norm(name)] = plan

    def lookup(self, name_parts) -> LogicalPlan:
        name = ".".join(name_parts)
        p = self._tables.get(self._norm(name))
        if p is None and len(name_parts) > 1:
            p = self._tables.get(self._norm(name_parts[-1]))
        if p is None:
            raise AnalysisException(
                f"Table or view not found: {name}",
                error_class="TABLE_OR_VIEW_NOT_FOUND")
        return p
