"""Data sources (the port's copy of `spark_tpu/io/sources.py`).

Role of the reference's DataSource V2 read SPI (sqlcatj/connector/read/*.java:
Table/ScanBuilder/Batch/PartitionReaderFactory with SupportsPushDownRequiredColumns)
and the vectorized file formats (sqlx/datasources/parquet/
VectorizedParquetRecordReader.java). pyarrow provides the columnar decoders;
partitions map to parquet row-group ranges / file splits, and column pruning
is pushed into the reader.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Optional, Sequence

import pyarrow as pa

from ..types import StructType
from ..columnar.arrow import schema_from_arrow


class DataSource:
    """Minimal source contract: schema + partitioned columnar reads."""

    name: str = "source"
    schema: StructType
    estimated_rows: Optional[int] = None

    def num_partitions(self) -> int:
        raise NotImplementedError

    def read_partition(self, i: int, columns: Sequence[str] | None) -> pa.Table:
        raise NotImplementedError

    def __getstate__(self):
        # device-resident batch caches never travel to other processes
        state = dict(self.__dict__)
        state.pop("_device_cache", None)
        return state


class SupportsPushDownFilters:
    """DSv2 pushdown mixin (reference: sql/catalyst connector/read/
    SupportsPushDownFilters.java). Predicates arrive as the engine's
    source-filter currency — (col, op, value) with op in
    =,<,<=,>,>=,in — and the source returns (new_source, residual):
    a clone that applies what it accepted plus the predicates the
    ENGINE must still evaluate. Functional style (clone, don't mutate)
    so plan caching and retries stay safe."""

    def push_filters(self, predicates: list) -> tuple["DataSource", list]:
        raise NotImplementedError


class SupportsPushDownLimit:
    """reference: SupportsPushDownLimit.java. Returns a clone applying
    the PER-PARTITION limit, or None when it cannot."""

    def push_limit(self, n: int) -> "DataSource | None":
        raise NotImplementedError


class SupportsPushDownAggregation:
    """reference: SupportsPushDownAggregates.java. `groupings` is a list
    of column names; `aggs` a list of (fn, col|None, out_name) with fn
    in count/sum/min/max/avg (col None = count(*)). Returns a clone
    whose scan yields the FINAL aggregated rows (columns named
    groupings + out_names), or None to decline."""

    def push_aggregation(self, groupings: list, aggs: list) \
            -> "DataSource | None":
        raise NotImplementedError


UNKNOWN_PARTITION_VALUE = object()
"""Sentinel: a source cannot tell which partition-column value a split
holds (DPP must then read the split)."""


class InMemorySource(DataSource):
    """An Arrow table split into N partitions (role of LocalTableScan +
    parallelize)."""

    name = "memory"

    def __init__(self, table: pa.Table, num_partitions: int = 1):
        self.table = table
        self._n = max(1, min(num_partitions, max(table.num_rows, 1)))
        self.schema = schema_from_arrow(table.schema)
        self.estimated_rows = table.num_rows

    def num_partitions(self) -> int:
        return self._n

    def read_partition(self, i: int, columns=None) -> pa.Table:
        n = self.table.num_rows
        per = -(-n // self._n) if n else 0
        lo = min(i * per, n)
        hi = min(lo + per, n)
        t = self.table.slice(lo, hi - lo)
        if columns is not None:
            t = t.select(list(columns))
        return t


class ParquetSource(DataSource):
    """Parquet scan; a partition is a (file, row-group range) split
    (reference: FileSourceScanExec partitioning over row groups)."""

    name = "parquet"

    def __init__(self, paths: str | Sequence[str],
                 target_partition_bytes: int = 128 << 20):
        import pyarrow.parquet as pq

        if isinstance(paths, str):
            paths = sorted(_glob.glob(paths)) if any(
                ch in paths for ch in "*?[") else [paths]
        files: list[str] = []
        for p in paths:
            if os.path.isdir(p):
                files.extend(sorted(
                    _glob.glob(os.path.join(p, "**", "*.parquet"),
                               recursive=True)))
            else:
                files.append(p)
        if not files:
            raise FileNotFoundError(f"no parquet files under {paths}")
        self.files = files
        self._pq = pq
        # hive-style partition columns from directory names k=v
        # (reference: PartitioningAwareFileIndex partition discovery)
        self._part_values: dict[str, dict[str, str]] = {}
        part_keys: list[str] = []
        for fpath in files:
            vals: dict[str, str] = {}
            for seg in fpath.split(os.sep)[:-1]:
                if "=" in seg:
                    k, _, v = seg.partition("=")
                    vals[k] = v
                    if k not in part_keys:
                        part_keys.append(k)
            self._part_values[fpath] = vals
        self._part_keys = [k for k in part_keys
                           if all(k in self._part_values[f] for f in files)]
        md0 = pq.ParquetFile(files[0])
        self.schema = schema_from_arrow(md0.schema_arrow)
        for k in self._part_keys:
            self.schema = self.schema.add(k, _infer_partition_type(
                [self._part_values[f][k] for f in files]))
        # build splits: (file, rg_start, rg_end)
        self._splits: list[tuple[str, int, int]] = []
        total_rows = 0
        for fpath in files:
            f = pq.ParquetFile(fpath)
            nrg = f.metadata.num_row_groups
            total_rows += f.metadata.num_rows
            acc_bytes = 0
            start = 0
            for rg in range(nrg):
                acc_bytes += f.metadata.row_group(rg).total_byte_size
                if acc_bytes >= target_partition_bytes:
                    self._splits.append((fpath, start, rg + 1))
                    start = rg + 1
                    acc_bytes = 0
            if start < nrg:
                self._splits.append((fpath, start, nrg))
            if nrg == 0:
                self._splits.append((fpath, 0, 0))
        self.estimated_rows = total_rows

    def num_partitions(self) -> int:
        return len(self._splits)

    # --- plan-time statistics ----------------------------------------------
    def _footer(self, fpath: str):
        cache = self.__dict__.setdefault("_md_cache", {})
        md = cache.get(fpath)
        if md is None:
            md = cache[fpath] = self._pq.ParquetFile(fpath).metadata
        return md

    def plan_time_rows(self) -> Optional[int]:
        """Exact row count of the CURRENT split set from footer metadata
        (row-group counts; no data read). Prune-aware — a `pruned()`
        clone reports only its kept splits. Ends the whole-tier's
        categorical exclusion of external scans
        (physical/whole_query._external_scan_rows)."""
        total = 0
        for (fpath, lo, hi) in self._splits:
            md = self._footer(fpath)
            for rg in range(lo, hi):
                total += md.row_group(rg).num_rows
        return total

    def plan_time_column_range(self, name: str) -> Optional[tuple]:
        """Footer (min, max) of a data column across the CURRENT splits,
        coerced to the engine's device domain (dates → epoch days).
        None when the column is a hive-partition column or any row
        group lacks statistics — never guess."""
        lo = hi = None
        for (fpath, a, b) in self._splits:
            if b <= a:
                continue
            md = self._footer(fpath)
            ci = next((i for i in range(md.num_columns)
                       if md.schema.column(i).name == name), None)
            if ci is None:
                return None
            for rg in range(a, b):
                st = md.row_group(rg).column(ci).statistics
                if st is None or not st.has_min_max:
                    return None
                mn, mx = _stat_coerce(st.min), _stat_coerce(st.max)
                lo = mn if lo is None else min(lo, mn)
                hi = mx if hi is None else max(hi, mx)
        return None if lo is None else (lo, hi)

    # --- predicate pruning -------------------------------------------------
    def pruned(self, predicates) -> "ParquetSource":
        """A clone reading only splits that can satisfy `predicates`
        (each: (col, op, value) with op in =,<,<=,>,>=,in).

        Partition columns prune whole files from the hive directory values
        (reference: PartitioningAwareFileIndex.listFiles pruning); data
        columns prune by row-group min/max statistics (reference:
        VectorizedParquetRecordReader / ParquetFileFormat row-group filter).
        Conservative: a split is kept unless a predicate proves it empty."""
        part_preds = [p for p in predicates if p[0] in self._part_keys]
        data_preds = [p for p in predicates if p[0] not in self._part_keys]
        keep: list[tuple[str, int, int]] = []
        dropped_files: set[str] = set()
        # footer metadata survives on the source: repeated plans of filtered
        # queries must not re-open every file
        stats_cache = self.__dict__.setdefault("_md_cache", {})
        for (fpath, lo, hi) in self._splits:
            if fpath in dropped_files:
                continue
            vals = self._part_values.get(fpath, {})
            if part_preds and not all(
                    self._part_match(vals.get(c), c, op, v)
                    for (c, op, v) in part_preds):
                dropped_files.add(fpath)
                continue
            if not data_preds or hi <= lo:
                keep.append((fpath, lo, hi))
                continue
            md = stats_cache.get(fpath)
            if md is None:
                md = stats_cache[fpath] = self._pq.ParquetFile(fpath).metadata
            name_to_idx = {md.schema.column(ci).name: ci
                           for ci in range(md.num_columns)}
            run_start = None  # merge contiguous kept row groups so a
            # non-selective predicate keeps the original split granularity
            for rg in range(lo, hi):
                rgm = md.row_group(rg)
                ok = True
                for (c, op, v) in data_preds:
                    ci = name_to_idx.get(c)
                    if ci is None:
                        continue
                    st = rgm.column(ci).statistics
                    if st is None or not st.has_min_max:
                        continue
                    if not _range_overlaps(st.min, st.max, op, v):
                        ok = False
                        break
                if ok and run_start is None:
                    run_start = rg
                elif not ok and run_start is not None:
                    keep.append((fpath, run_start, rg))
                    run_start = None
            if run_start is not None:
                keep.append((fpath, run_start, hi))
        if keep == self._splits:
            return self  # nothing pruned — keep the (cached) source
        import copy

        clone = copy.copy(self)
        clone._splits = keep or [(self.files[0], 0, 0)]
        # the shallow copy shares the device cache, but its keys are split
        # INDICES — different split lists must not alias each other's data
        clone.__dict__.pop("_device_cache", None)
        return clone

    def split_partition_value(self, i: int, col: str):
        """Typed hive-partition value of split i for `col`; None for the
        null partition; UNKNOWN_PARTITION_VALUE when not derivable."""
        if col not in self._part_keys:
            return UNKNOWN_PARTITION_VALUE
        fpath = self._splits[i][0]
        raw = self._part_values.get(fpath, {}).get(col)
        if raw is None:
            return UNKNOWN_PARTITION_VALUE
        if raw == "__HIVE_DEFAULT_PARTITION__":
            return None
        from ..types import float64, int64

        dt = self.schema[col].dataType
        return int(raw) if dt is int64 else \
            float(raw) if dt is float64 else raw

    def _part_match(self, raw: str | None, col: str, op: str, v) -> bool:
        if raw is None or raw == "__HIVE_DEFAULT_PARTITION__":
            return False  # null partition never equals a literal
        from ..types import float64, int64

        dt = self.schema[col].dataType
        pv = int(raw) if dt is int64 else float(raw) if dt is float64 else raw
        return _range_overlaps(pv, pv, op, v)

    def read_partition(self, i: int, columns=None) -> pa.Table:
        from ..types import StringType, to_arrow_type

        fpath, lo, hi = self._splits[i]
        # keep parquet DICTIONARY PAGES encoded end to end: string
        # columns decode to pa.DictionaryArray (codes + dictionary)
        # straight from the file, and columnar ingest ships those codes
        # to HBM without ever materializing row values (compressed
        # execution; _chunked_to_numpy's is_dictionary branch)
        dict_cols = [f.name for f in self.schema.fields
                     if isinstance(f.dataType, StringType)
                     and f.name not in self._part_keys]
        f = self._pq.ParquetFile(fpath, read_dictionary=dict_cols or None)
        pvals = self._part_values.get(fpath, {})
        want_part = [k for k in self._part_keys
                     if columns is None or k in columns]
        file_cols = None
        if columns is not None:
            file_cols = [c for c in columns if c not in self._part_keys]
        if hi <= lo:
            t = f.schema_arrow.empty_table()
            if file_cols is not None:
                t = t.select(file_cols)
        else:
            t = f.read_row_groups(list(range(lo, hi)), columns=file_cols)
        for k in want_part:
            at = to_arrow_type(self.schema[k].dataType)
            raw = pvals.get(k)
            v = None if raw == "__HIVE_DEFAULT_PARTITION__" else raw
            if v is not None and pa.types.is_integer(at):
                v = int(v)
            elif v is not None and pa.types.is_floating(at):
                v = float(v)
            t = t.append_column(k, pa.array([v] * t.num_rows, type=at))
        if columns is not None:
            t = t.select(list(columns))
        return t


def _stat_coerce(x):
    """Normalize parquet-statistics values into the engine's device domain
    (dates → epoch days, timestamps → epoch micros) so they compare against
    Literal values."""
    import datetime as _dt

    if isinstance(x, _dt.datetime):
        epoch = _dt.datetime(1970, 1, 1, tzinfo=x.tzinfo)
        return int((x - epoch).total_seconds() * 1_000_000)
    if isinstance(x, _dt.date):
        return (x - _dt.date(1970, 1, 1)).days
    if isinstance(x, bytes):
        try:
            return x.decode("utf-8")
        except UnicodeDecodeError:
            return x
    return x


def _range_overlaps(lo, hi, op: str, v) -> bool:
    """Can a value in [lo, hi] satisfy `x op v`? Conservative true on any
    type mismatch (mirrors the reference's ParquetFilters nullability/type
    guards)."""
    lo, hi = _stat_coerce(lo), _stat_coerce(hi)
    v = [_stat_coerce(x) for x in v] if op == "in" else _stat_coerce(v)
    try:
        if op == "=":
            return lo <= v <= hi
        if op == "<":
            return lo < v
        if op == "<=":
            return lo <= v
        if op == ">":
            return hi > v
        if op == ">=":
            return hi >= v
        if op == "in":
            return any(lo <= x <= hi for x in v)
    except TypeError:
        return True
    return True


def _infer_partition_type(values: list[str]):
    from ..types import float64, int64, string

    def ok(fn):
        try:
            for v in values:
                if v != "__HIVE_DEFAULT_PARTITION__":
                    fn(v)
            return True
        except ValueError:
            return False

    if ok(int):
        return int64
    if ok(float):
        return float64
    return string


class CSVSource(DataSource):
    name = "csv"

    def __init__(self, paths: str | Sequence[str], header: bool = True,
                 schema: StructType | None = None, delimiter: str = ","):
        import pyarrow.csv as pacsv

        if isinstance(paths, str):
            paths = sorted(_glob.glob(paths)) if any(
                ch in paths for ch in "*?[") else [paths]
        self.files = list(paths)
        self._pacsv = pacsv
        self.header = header
        self.delimiter = delimiter
        t = self._read(self.files[0])
        self.schema = schema or schema_from_arrow(t.schema)
        self.estimated_rows = None

    def _read(self, path: str) -> pa.Table:
        ropt = self._pacsv.ReadOptions(
            autogenerate_column_names=not self.header)
        popt = self._pacsv.ParseOptions(delimiter=self.delimiter)
        return self._pacsv.read_csv(path, read_options=ropt,
                                    parse_options=popt)

    def num_partitions(self) -> int:
        return len(self.files)

    def read_partition(self, i: int, columns=None) -> pa.Table:
        t = self._read(self.files[i])
        if columns is not None:
            t = t.select(list(columns))
        return t


class JSONSource(DataSource):
    name = "json"

    def __init__(self, paths: str | Sequence[str]):
        import pyarrow.json as pajson

        if isinstance(paths, str):
            paths = sorted(_glob.glob(paths)) if any(
                ch in paths for ch in "*?[") else [paths]
        self.files = list(paths)
        self._pajson = pajson
        t = pajson.read_json(self.files[0])
        self.schema = schema_from_arrow(t.schema)
        self.estimated_rows = None

    def num_partitions(self) -> int:
        return len(self.files)

    def read_partition(self, i: int, columns=None) -> pa.Table:
        t = self._pajson.read_json(self.files[i])
        if columns is not None:
            t = t.select(list(columns))
        return t


class ORCSource(DataSource):
    """ORC scan; a partition is a (file, stripe range) split (reference:
    sqlx/datasources/orc/OrcFileFormat.scala + OrcColumnarBatchReader —
    pyarrow's ORC reader supplies the vectorized decode)."""

    name = "orc"

    def __init__(self, paths: str | Sequence[str]):
        import pyarrow.orc as po

        if isinstance(paths, str):
            paths = sorted(_glob.glob(paths)) if any(
                ch in paths for ch in "*?[") else [paths]
        files: list[str] = []
        for p in paths:
            if os.path.isdir(p):
                files.extend(sorted(
                    _glob.glob(os.path.join(p, "**", "*.orc"),
                               recursive=True)))
            else:
                files.append(p)
        if not files:
            raise FileNotFoundError(f"no orc files under {paths}")
        self.files = files
        self._po = po
        f0 = po.ORCFile(files[0])
        self.schema = schema_from_arrow(f0.schema)
        self.estimated_rows = sum(po.ORCFile(f).nrows for f in files)
        # one split per (file, stripe): stripes are ORC's row groups
        self._splits: list[tuple[str, int]] = []
        for fpath in files:
            n = po.ORCFile(fpath).nstripes
            for s in range(max(n, 1)):
                self._splits.append((fpath, s))

    def num_partitions(self) -> int:
        return len(self._splits)

    def read_partition(self, i: int, columns=None) -> pa.Table:
        fpath, stripe = self._splits[i]
        f = self._po.ORCFile(fpath)
        cols = list(columns) if columns is not None else None
        if f.nstripes == 0:
            return f.read(columns=cols)
        return f.read_stripe(stripe, columns=cols) if cols is not None \
            else f.read_stripe(stripe)


class AvroSource(DataSource):
    """Avro container-file scan, one partition per file (reference:
    connector/avro/AvroFileFormat.scala; decode in io/avro.py)."""

    name = "avro"

    def __init__(self, paths: str | Sequence[str]):
        from .avro import read_avro

        if isinstance(paths, str):
            paths = sorted(_glob.glob(paths)) if any(
                ch in paths for ch in "*?[") else [paths]
        files: list[str] = []
        for p in paths:
            if os.path.isdir(p):
                files.extend(sorted(
                    _glob.glob(os.path.join(p, "**", "*.avro"),
                               recursive=True)))
            else:
                files.append(p)
        if not files:
            raise FileNotFoundError(f"no avro files under {paths}")
        self.files = files
        self._read = read_avro
        # schema from file 0 only; partitions decode on demand (no
        # whole-dataset cache — a directory larger than RAM must stream)
        self.schema = schema_from_arrow(read_avro(files[0]).schema)
        self.estimated_rows = None

    def num_partitions(self) -> int:
        return len(self.files)

    def read_partition(self, i: int, columns=None) -> pa.Table:
        t = self._read(self.files[i])
        if columns is not None:
            t = t.select(list(columns))
        return t


class XMLSource(DataSource):
    """XML scan: one row per `rowTag` element; child elements become
    string columns (reference: connector/xml — XmlFileFormat, rowTag
    option). Types stay strings like the reference's schema-less mode;
    cast downstream."""

    name = "xml"

    def __init__(self, paths: str | Sequence[str], row_tag: str = "ROW"):
        import xml.etree.ElementTree as ET

        if isinstance(paths, str):
            paths = sorted(_glob.glob(paths)) if any(
                ch in paths for ch in "*?[") else [paths]
        files: list[str] = []
        for p in paths:
            if os.path.isdir(p):
                files.extend(sorted(
                    _glob.glob(os.path.join(p, "**", "*.xml"),
                               recursive=True)))
            else:
                files.append(p)
        if not files:
            raise FileNotFoundError(f"no xml files under {paths}")
        self.files = files
        self.row_tag = row_tag
        self._et = ET
        # schema inference spans ALL files (a tag present only in a
        # later file must still become a column, like the reference's
        # whole-input XML schema inference)
        names: list[str] = []
        seen = set()
        for f in files:
            for r in self._rows(f):
                for k in r:
                    if k not in seen:
                        seen.add(k)
                        names.append(k)
        self._names = names
        self.schema = schema_from_arrow(pa.schema(
            [(n, pa.string()) for n in names]))
        self.estimated_rows = None

    def _rows(self, path: str) -> list[dict]:
        root = self._et.parse(path).getroot()
        elems = root.iter(self.row_tag)
        out = []
        for el in elems:
            row: dict = {}
            # attributes as _attr columns, children as named columns
            for k, v in el.attrib.items():
                row[f"_{k}"] = v
            for child in el:
                row[child.tag] = (child.text or "").strip() or None
            if row:
                out.append(row)
        return out

    def num_partitions(self) -> int:
        return len(self.files)

    def read_partition(self, i: int, columns=None) -> pa.Table:
        rows = self._rows(self.files[i])
        names = list(columns) if columns is not None else self._names
        return pa.table({n: pa.array([r.get(n) for r in rows],
                                     pa.string()) for n in names})


class JDBCSource(DataSource, SupportsPushDownFilters,
                 SupportsPushDownLimit, SupportsPushDownAggregation):
    """Database scan over a DB-API connection (reference:
    sqlx/datasources/jdbc/JDBCRDD.scala — column pruning and partitioned
    reads via `partitionColumn/lowerBound/upperBound/numPartitions`
    WHERE-range predicates; JDBCScanBuilder for the v2 pushdown SPI:
    WHERE conjuncts, LIMIT, and whole-query aggregation all execute
    REMOTELY in the database). URLs: `jdbc:sqlite:<path>` ships in-tree
    (stdlib module); other DB-API modules plug in via `connector`.
    `last_sql` records the most recent generated statement (tests
    assert remote execution on it)."""

    name = "jdbc"

    def __init__(self, url: str, table: str,
                 partition_column: str | None = None,
                 lower_bound=None, upper_bound=None,
                 num_partitions: int = 1, connector=None):
        self.url = url
        self.table = table
        self.partition_column = partition_column
        self._connector = connector
        self.num_parts = max(1, int(num_partitions)) \
            if partition_column else 1
        probe = self._query(f"SELECT * FROM {table} LIMIT 1")
        self.schema = schema_from_arrow(probe.schema)
        if partition_column and (lower_bound is None or upper_bound is None):
            bounds = self._query(
                f"SELECT min({partition_column}), max({partition_column}) "
                f"FROM {table}")
            lower_bound = bounds.column(0)[0].as_py() \
                if lower_bound is None else lower_bound
            upper_bound = bounds.column(1)[0].as_py() \
                if upper_bound is None else upper_bound
        if not (isinstance(lower_bound, (int, float))
                and isinstance(upper_bound, (int, float))):
            # empty table (NULL bounds) or non-numeric partition column:
            # a range split is impossible — read as one partition
            # (reference: JDBCRelation.columnPartition requires numeric/
            # date bounds)
            self.num_parts = 1
            lower_bound = upper_bound = None
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.estimated_rows = None
        self._where: list[str] = []     # pushed WHERE conjuncts
        self._limit: int | None = None  # pushed per-partition LIMIT
        self._agg_sql: str | None = None
        self.last_sql: str | None = None

    def _connect(self):
        if self._connector is not None:
            return self._connector()
        if self.url.startswith("jdbc:sqlite:") or \
                self.url.startswith("sqlite:"):
            import sqlite3

            path = self.url.split("sqlite:", 1)[1].lstrip("/")
            if not path.startswith(":"):
                path = "/" + path
            return sqlite3.connect(path)
        raise ValueError(f"no DB-API module for {self.url!r}; pass "
                         "connector=")

    def _query(self, sql: str) -> pa.Table:
        conn = self._connect()
        try:
            cur = conn.execute(sql)
            names = [d[0] for d in cur.description]
            rows = cur.fetchall()
        finally:
            conn.close()
        cols = list(zip(*rows)) if rows else [[] for _ in names]
        return pa.table({n: list(c) for n, c in zip(names, cols)})

    def num_partitions(self) -> int:
        return self.num_parts

    # -- DSv2 pushdown SPI ----------------------------------------------
    @staticmethod
    def _sql_literal(v) -> str | None:
        """SQL literal rendering; None = untranslatable (stays an
        engine-side residual)."""
        import math

        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        if isinstance(v, bool):
            return "1" if v else "0"
        if isinstance(v, int):
            return str(v)
        if isinstance(v, float):
            if math.isnan(v) or math.isinf(v):
                return None
            return repr(v)
        return None    # bytes, dates-as-objects, nested values …

    @staticmethod
    def _quote_ident(name: str) -> str:
        return '"' + str(name).replace('"', '""') + '"'

    def _clone(self) -> "JDBCSource":
        import copy

        c = copy.copy(self)
        c.__dict__.pop("_device_cache", None)
        c._where = list(self._where)
        return c

    def push_filters(self, predicates):
        """Translatable predicates execute in the database. For the
        in-tree sqlite module the remote comparison semantics are exact, so
        consumed predicates leave no residual; a PLUGGABLE connector's
        collation/comparison rules are unknown, so everything pushed is
        ALSO returned as residual and the engine re-checks (the
        conservative contract parquet's row-group stats use)."""
        c = self._clone()
        residual = []
        for pred in predicates:
            col, op, val = pred
            if op == "in":
                lits = [self._sql_literal(v) for v in val]
                if any(x is None for x in lits):
                    residual.append(pred)
                    continue
                c._where.append(
                    f"{self._quote_ident(col)} IN ({', '.join(lits)})")
            else:
                lit = self._sql_literal(val)
                if lit is None:
                    residual.append(pred)
                    continue
                c._where.append(f"{self._quote_ident(col)} {op} {lit}")
            if self._connector is not None:
                residual.append(pred)   # pushed for IO, re-checked
        return c, residual

    def push_limit(self, n: int):
        c = self._clone()
        c._limit = n if self._limit is None else min(self._limit, n)
        return c

    def push_aggregation(self, groupings, aggs):
        """Whole-query aggregation runs in the database; only for
        single-partition scans (a range-split scan would aggregate each
        split independently — wrong for non-decomposable finals). The
        result schema derives statically from the source schema — no
        probe query against the remote database at planning time."""
        from ..types import IntegralType, StructField, float64, int64

        if self.num_parts > 1 or self._limit is not None:
            return None
        out_names = [out for _, _, out in aggs]
        if len(set(out_names) | set(groupings)) != \
                len(out_names) + len(groupings):
            return None     # name collision would fold columns silently
        by_name = {f.name: f.dataType for f in self.schema.fields}
        cols, fields = [], []
        for g in groupings:
            if g not in by_name:
                return None
            cols.append(self._quote_ident(g))
            fields.append(StructField(str(g), by_name[g], True))
        for fn, col, out in aggs:
            if fn not in ("count", "sum", "min", "max", "avg"):
                return None
            if col is not None and col not in by_name:
                return None
            arg = "*" if col is None else self._quote_ident(col)
            cols.append(f"{fn}({arg}) AS {self._quote_ident(out)}")
            if fn == "count":
                dt = int64
            elif fn == "avg":
                dt = float64
            elif fn == "sum":
                dt = int64 if isinstance(by_name[col], IntegralType) \
                    else float64
            else:
                dt = by_name[col]
            fields.append(StructField(str(out), dt, True))
        sql = f"SELECT {', '.join(cols)} FROM {self.table}"
        if self._where:
            sql += " WHERE " + " AND ".join(self._where)
        if groupings:
            sql += " GROUP BY " + ", ".join(self._quote_ident(g)
                                            for g in groupings)
        from ..types import StructType

        c = self._clone()
        c._agg_sql = sql
        c.num_parts = 1
        c.schema = StructType(tuple(fields))
        c.estimated_rows = None
        return c

    def generated_sql(self, i: int, columns=None) -> str:
        """The exact statement partition `i` executes remotely."""
        if self._agg_sql is not None:
            return self._agg_sql
        proj = ", ".join(columns) if columns else "*"
        sql = f"SELECT {proj} FROM {self.table}"
        clauses = list(self._where)
        if self.partition_column and self.num_parts > 1:
            lo, hi = self.lower_bound, self.upper_bound
            step = (hi - lo) / self.num_parts
            a = lo + step * i
            b = lo + step * (i + 1)
            c = self.partition_column
            if i == 0:
                clauses.append(f"({c} < {b} OR {c} IS NULL)")
            elif i == self.num_parts - 1:
                clauses.append(f"{c} >= {a}")
            else:
                clauses.append(f"({c} >= {a} AND {c} < {b})")
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        if self._limit is not None:
            sql += f" LIMIT {self._limit}"
        return sql

    def read_partition(self, i: int, columns=None) -> pa.Table:
        sql = self.generated_sql(i, columns)
        self.last_sql = sql
        t = self._query(sql)
        if columns is not None and t.column_names != list(columns) and \
                set(columns) <= set(t.column_names):
            t = t.select(list(columns))
        return t


class TextSource(DataSource):
    """Line-per-row text scan, one `value` string column (reference:
    sqlx/datasources/text/TextFileFormat.scala)."""

    name = "text"

    def __init__(self, paths: str | Sequence[str]):
        if isinstance(paths, str):
            paths = sorted(_glob.glob(paths)) if any(
                ch in paths for ch in "*?[") else [paths]
        files: list[str] = []
        for p in paths:
            if os.path.isdir(p):
                files.extend(sorted(
                    _glob.glob(os.path.join(p, "**", "*"), recursive=True)))
            else:
                files.append(p)
        self.files = [f for f in files if os.path.isfile(f)]
        if not self.files:
            raise FileNotFoundError(f"no text files under {paths}")
        from ..types import StructField, string

        self.schema = StructType([StructField("value", string, True)])
        self.estimated_rows = None

    def num_partitions(self) -> int:
        return len(self.files)

    def read_partition(self, i: int, columns=None) -> pa.Table:
        with open(self.files[i], "r", errors="replace") as f:
            lines = f.read().splitlines()
        t = pa.table({"value": pa.array(lines, pa.string())})
        if columns is not None:
            t = t.select(list(columns))
        return t
