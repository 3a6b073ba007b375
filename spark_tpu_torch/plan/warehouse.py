"""Persistent warehouse catalog (counterpart of `spark_tpu/plan/warehouse.py`,
copied): saved tables live as Parquet under `spark.sql.warehouse.dir`,
listed in a JSON catalog file (`_catalog.json`) that every lookup reads,
so sessions over one directory see each other's tables.

`on_write` is the catalog's write hook, called with a table's directory
after every save, append, overwrite and drop. The reference wires it to
its persistent result cache's invalidation; that cache is not ported
(ROADMAP.md A12), so the port's sessions leave it None."""

from __future__ import annotations

import json
import os
import threading


class Warehouse:
    def __init__(self, path: str, on_write=None):
        self.path = path
        self._lock = threading.Lock()
        self.on_write = on_write
        os.makedirs(path, exist_ok=True)

    def _notify_write(self, p: str) -> None:
        if self.on_write is not None:
            try:
                self.on_write(p)
            except Exception:
                pass  # cache invalidation must never fail a write

    @property
    def _catalog_file(self) -> str:
        return os.path.join(self.path, "_catalog.json")

    def _load(self) -> dict:
        if os.path.exists(self._catalog_file):
            with open(self._catalog_file) as f:
                return json.load(f)
        return {"tables": {}}

    def _save(self, cat: dict) -> None:
        tmp = self._catalog_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cat, f, indent=2)
        os.replace(tmp, self._catalog_file)

    def table_path(self, name: str) -> str:
        return os.path.join(self.path, name)

    def save_table(self, name: str, table, mode: str = "error") -> str:
        """Write an Arrow table as a managed Parquet table; mode error
        (or errorifexists), overwrite or append."""
        import pyarrow.parquet as pq

        from ..errors import AnalysisException

        with self._lock:
            cat = self._load()
            exists = name in cat["tables"]
            p = self.table_path(name)
            if exists and mode in ("error", "errorifexists"):
                raise AnalysisException(
                    f"Table {name} already exists",
                    error_class="TABLE_OR_VIEW_ALREADY_EXISTS")
            os.makedirs(p, exist_ok=True)
            if mode == "append" and exists:
                i = len([f for f in os.listdir(p) if f.endswith(".parquet")])
                pq.write_table(table, os.path.join(p, f"part-{i:05d}.parquet"))
            else:
                for f in os.listdir(p):
                    if f.endswith(".parquet"):
                        os.remove(os.path.join(p, f))
                pq.write_table(table, os.path.join(p, "part-00000.parquet"))
            cat["tables"][name] = {"format": "parquet", "path": p}
            self._save(cat)
        self._notify_write(p)
        return p

    def drop_table(self, name: str) -> bool:
        import shutil

        with self._lock:
            cat = self._load()
            if name not in cat["tables"]:
                return False
            p = cat["tables"].pop(name)["path"]
            self._save(cat)
        shutil.rmtree(p, ignore_errors=True)
        self._notify_write(p)
        return True

    def list_tables(self) -> list[str]:
        return sorted(self._load()["tables"])

    def lookup(self, name: str):
        """A LogicalRelation over a saved table, or None."""
        meta = self._load()["tables"].get(name)
        if meta is None:
            return None
        from ..expr.expressions import AttributeReference
        from ..io.sources import ParquetSource
        from .logical import LogicalRelation

        src = ParquetSource(meta["path"])
        attrs = [AttributeReference(f.name, f.dataType, f.nullable)
                 for f in src.schema.fields]
        return LogicalRelation(src, attrs, name)
