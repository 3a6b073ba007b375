"""DataFrameReader / DataFrameWriter (counterpart of
`spark_tpu/api/readwriter.py`).

Role of the reference's DataFrameReader/Writer
(sql/api .../DataFrameReader.scala, sqlx/datasources/DataSource resolution).
A reader builds a `LogicalRelation` over an `io/sources.py` source, which
plans `ScanExec`; a writer collects the DataFrame to Arrow and writes it
with pyarrow, a partitioned write through `io/commit.py`'s two-phase
commit. `saveAsTable` and `insertInto` write managed tables into the
session's warehouse (`plan/warehouse.py`); with no warehouse,
`saveAsTable` registers a temp view, as in the reference.
"""

from __future__ import annotations

import os
from typing import Any

import pyarrow as pa

from ..errors import AnalysisException
from ..io.sources import (
    CSVSource, DataSource, JDBCSource, JSONSource, ORCSource, ParquetSource,
)
from ..plan.logical import LogicalRelation
from ..expr.expressions import AttributeReference


class DataFrameReader:
    def __init__(self, session):
        self.session = session
        self._options: dict[str, Any] = {}
        self._format = "parquet"
        self._schema = None

    def format(self, fmt: str) -> "DataFrameReader":  # noqa: A003
        self._format = fmt
        return self

    def option(self, k: str, v) -> "DataFrameReader":
        self._options[k] = v
        return self

    def options(self, **kw) -> "DataFrameReader":
        self._options.update(kw)
        return self

    def schema(self, s) -> "DataFrameReader":
        self._schema = s
        return self

    def _df(self, source: DataSource, name: str):
        from .dataframe import DataFrame

        attrs = [AttributeReference(f.name, f.dataType, f.nullable)
                 for f in source.schema.fields]
        return DataFrame(self.session, LogicalRelation(source, attrs, name))

    def parquet(self, path: str):
        return self._df(ParquetSource(path), os.path.basename(path))

    def csv(self, path: str, header: bool | None = None, **kw):
        h = self._options.get("header", True if header is None else header)
        if isinstance(h, str):
            h = h.lower() == "true"
        sep = self._options.get("sep", self._options.get("delimiter", ","))
        return self._df(CSVSource(path, header=h, schema=self._schema,
                                  delimiter=sep),
                        os.path.basename(path))

    def json(self, path: str):
        return self._df(JSONSource(path), os.path.basename(path))

    def orc(self, path: str):
        return self._df(ORCSource(path), os.path.basename(path))

    def text(self, path: str):
        from ..io.sources import TextSource

        return self._df(TextSource(path), os.path.basename(path))

    def avro(self, path: str):
        from ..io.sources import AvroSource

        return self._df(AvroSource(path), os.path.basename(path))

    def xml(self, path: str, rowTag: str | None = None):
        from ..io.sources import XMLSource

        return self._df(XMLSource(
            path, row_tag=rowTag or self._options.get("rowTag", "ROW")),
            os.path.basename(path))

    def jdbc(self, url: str | None = None, table: str | None = None,
             **kw):
        url = url or self._options.get("url")
        table = table or self._options.get("dbtable")
        if not url or not table:
            raise AnalysisException("jdbc requires url and dbtable")
        src = JDBCSource(
            url, table,
            partition_column=kw.get("column",
                                    self._options.get("partitionColumn")),
            lower_bound=kw.get("lowerBound",
                               self._options.get("lowerBound")),
            upper_bound=kw.get("upperBound",
                               self._options.get("upperBound")),
            num_partitions=int(kw.get(
                "numPartitions", self._options.get("numPartitions", 1))),
            connector=self._options.get("connector"))
        return self._df(src, table)

    def table(self, name: str):
        return self.session.table(name)

    def load(self, path: str | None = None):
        fmt = self._format.lower()
        if fmt == "jdbc":
            return self.jdbc()
        if path is None:
            raise AnalysisException(f"format {fmt} requires a path")
        if fmt == "parquet":
            return self.parquet(path)
        if fmt == "csv":
            return self.csv(path)
        if fmt == "json":
            return self.json(path)
        if fmt == "orc":
            return self.orc(path)
        if fmt == "text":
            return self.text(path)
        if fmt == "avro":
            return self.avro(path)
        if fmt == "xml":
            return self.xml(path)
        raise AnalysisException(f"unknown format {fmt}")


class DataFrameWriter:
    def __init__(self, df):
        self.df = df
        self._mode = "errorifexists"
        self._format = "parquet"
        self._options: dict[str, Any] = {}
        self._partition_by: list[str] = []

    def partitionBy(self, *cols: str) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    def mode(self, m: str) -> "DataFrameWriter":
        self._mode = m.lower()
        return self

    def format(self, fmt: str) -> "DataFrameWriter":  # noqa: A003
        self._format = fmt
        return self

    def option(self, k, v) -> "DataFrameWriter":
        self._options[k] = v
        return self

    def _check(self, path: str):
        if os.path.exists(path):
            if self._mode in ("error", "errorifexists"):
                raise AnalysisException(f"path {path} already exists")
            if self._mode == "ignore":
                return False
            if self._mode == "overwrite":
                import shutil

                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:
                    os.remove(path)
        return True

    def parquet(self, path: str) -> None:
        self._write_file_format(path, "parquet")

    def orc(self, path: str) -> None:
        self._write_file_format(path, "orc")

    def avro(self, path: str) -> None:
        self._write_file_format(path, "avro")

    @staticmethod
    def _write_one(table: pa.Table, path: str, fmt: str) -> None:
        if fmt == "parquet":
            import pyarrow.parquet as pq

            pq.write_table(table, path)
        elif fmt == "avro":
            from ..io.avro import write_avro

            write_avro(path, table)
        else:
            import pyarrow.orc as po

            po.write_table(table, path)

    def _write_file_format(self, path: str, fmt: str) -> None:
        if not self._check(path):
            return
        table = self.df.toArrow()
        if not self._partition_by:
            self._write_one(table, path, fmt)
            return
        # hive-style layout path/k1=v1/part-*.{fmt} written through the
        # two-phase commit protocol: every partition combo is a task,
        # files land in attempt staging dirs and move into place only at
        # job commit (reference: FileFormatWriter dynamic partitioning +
        # HadoopMapReduceCommitProtocol; arbitration =
        # core/scheduler/OutputCommitCoordinator.scala)
        import pyarrow.compute as pc

        from ..io.commit import FileCommitProtocol

        os.makedirs(path, exist_ok=True)
        proto = FileCommitProtocol(
            path, getattr(self.df.session, "_commit_coordinator", None))
        proto.setup_job()
        keys = self._partition_by
        try:
            combos = table.select(keys).group_by(keys).aggregate([])
            for i in range(combos.num_rows):
                vals = [combos.column(k)[i].as_py() for k in keys]
                mask = None
                for k, v in zip(keys, vals):
                    cond = pc.is_null(table.column(k)) if v is None \
                        else pc.equal(table.column(k), v)
                    mask = cond if mask is None else pc.and_(mask, cond)
                part = table.filter(mask).drop_columns(keys)
                sub = [f"{k}={'__HIVE_DEFAULT_PARTITION__' if v is None else v}"
                       for k, v in zip(keys, vals)]
                attempt = proto.new_task_attempt(i)
                self._write_one(
                    part, attempt.path_for(*sub, f"part-00000.{fmt}"), fmt)
                attempt.commit()
        except BaseException:
            proto.abort_job()
            raise
        proto.commit_job()

    def csv(self, path: str) -> None:
        import pyarrow.csv as pacsv

        if not self._check(path):
            return
        pacsv.write_csv(self.df.toArrow(), path)

    def json(self, path: str) -> None:
        if not self._check(path):
            return
        import json as _json

        t = self.df.toArrow()
        with open(path, "w") as f:
            for row in t.to_pylist():
                f.write(_json.dumps(row, default=str) + "\n")

    def saveAsTable(self, name: str) -> None:
        wh = self.df.session.catalog_.external
        if wh is None:
            self.df.createOrReplaceTempView(name)
            return
        mode = {"errorifexists": "error"}.get(self._mode, self._mode)
        wh.save_table(name, self.df.toArrow(), mode=mode)

    def insertInto(self, name: str) -> None:
        wh = self.df.session.catalog_.external
        if wh is not None and name in wh.list_tables():
            wh.save_table(name, self.df.toArrow(), mode="append")
            return
        raise AnalysisException(f"table {name} is not a saved table")

    def save(self, path: str) -> None:
        getattr(self, self._format)(path)
