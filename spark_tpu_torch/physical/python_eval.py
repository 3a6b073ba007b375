"""PythonEvalExec: vectorized host UDF evaluation (counterpart of
`spark_tpu/physical/python_eval.py`).

The role of Spark's ArrowEvalPythonExec and its worker protocol. There is
no process boundary: device pipelines evaluate the argument expressions,
the live rows cross to the host once, the UDF runs vectorized over numpy
arrays, and its results come back as new device columns (strings re-enter
through a dictionary; an array, map or struct result is dictionary-encoded
by canonical form). A deterministic UDF over one dictionary-encoded
argument runs once per distinct live entry instead of once per row.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..columnar.batch import (
    Column, ColumnarBatch, StringDict, empty_entry, encode_values,
)
from ..config import ENCODING_ENABLED
from ..exec.context import ExecContext
from ..expr.expressions import Alias
from ..types import (
    ArrayType, DateType, DecimalType, MapType, StringType, StructField,
    StructType, TimestampType, dict_encoded,
)
from .compile import ExprPipeline
from .operators import PhysicalPlan, attrs_schema


def host_values(col: Column, sel: torch.Tensor) -> np.ndarray:
    """The selected rows of `col` as host Python-level values: strings,
    blobs, lists and dicts decoded, decimals scaled to floats, dates and
    timestamps as their int days and microseconds, NULL as None."""
    data = col.data[sel].cpu().numpy()
    if dict_encoded(col.dtype):
        values = col.dictionary.values if col.dictionary is not None else []
        vals = np.empty(len(values) + 1, dtype=object)
        for i, v in enumerate(values):  # lists stay whole, never 2-D
            vals[i] = v
        vals[-1] = empty_entry(col.dtype)
        out = vals[np.clip(data, 0, len(values))] if values \
            else vals[np.full(len(data), -1)]
        out = np.asarray(out, dtype=object)
    elif isinstance(col.dtype, DecimalType):
        out = data.astype(np.float64) / (10 ** col.dtype.scale)
    else:
        out = data
    if col.validity is not None:
        valid = col.validity[sel].cpu().numpy()
        out = np.asarray(out, dtype=object).copy()
        out[~valid] = None
    return out


def conform(v, dt):
    """A host UDF's value inside a nested result in the form Arrow's ingest
    gives the same type: a decimal as a Decimal at its scale, a date and a
    timestamp as date and datetime objects (a UDF sees them as a float,
    days and microseconds), numpy scalars as Python values, recursively.
    The reference keeps the float, so a decimal read back from its struct
    or map loses its scale and its collect fails (ROADMAP.md C15)."""
    import datetime
    import decimal

    if v is None:
        return None
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(dt, DecimalType):
        if isinstance(v, decimal.Decimal):
            return v
        return decimal.Decimal(int(round(float(v) * 10 ** dt.scale))) \
            .scaleb(-dt.scale)
    if isinstance(dt, TimestampType) and not isinstance(v, datetime.datetime):
        return datetime.datetime(1970, 1, 1) + \
            datetime.timedelta(microseconds=int(v))
    if isinstance(dt, DateType) and not isinstance(v, datetime.date):
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))
    if isinstance(dt, ArrayType):
        return [conform(x, dt.element_type) for x in v]
    if isinstance(dt, MapType):
        return {conform(k, dt.key_type): conform(x, dt.value_type)
                for k, x in v.items()}
    if isinstance(dt, StructType) and isinstance(v, dict):
        return {f.name: conform(v.get(f.name), f.dataType)
                for f in dt.fields}
    return v


def _holds_scaled(dt) -> bool:
    """True where a nested type holds a decimal, a date or a timestamp
    (the values `conform` rewrites)."""
    if isinstance(dt, (DecimalType, DateType, TimestampType)):
        return True
    if isinstance(dt, ArrayType):
        return _holds_scaled(dt.element_type)
    if isinstance(dt, MapType):
        return _holds_scaled(dt.key_type) or _holds_scaled(dt.value_type)
    if isinstance(dt, StructType):
        return any(_holds_scaled(f.dataType) for f in dt.fields)
    return False


class PythonEvalExec(PhysicalPlan):
    child_fields = ("child",)

    def __init__(self, udf_aliases: Sequence[Alias], child: PhysicalPlan):
        self.udf_aliases = list(udf_aliases)
        self.child = child
        self._arg_pipelines = None

    @property
    def output(self):
        return self.child.output + [a.to_attribute()
                                    for a in self.udf_aliases]

    def output_partitioning(self):
        return self.child.output_partitioning()

    def _pipelines(self):
        if self._arg_pipelines is None:
            self._arg_pipelines = []
            # each UDF's args may reference earlier UDF outputs (nested
            # UDFs extract bottom-up): grow the visible input attrs as the
            # aliases accumulate
            inputs = list(self.child.output)
            for al in self.udf_aliases:
                udf = al.child
                arg_aliases = [Alias(a, f"__a{i}")
                               for i, a in enumerate(udf.args)]
                schema = StructType([
                    StructField(x.name, x.child.dtype, True)
                    for x in arg_aliases])
                self._arg_pipelines.append(ExprPipeline(
                    list(inputs), [], arg_aliases, schema))
                inputs.append(al.to_attribute())
        return self._arg_pipelines

    def execute(self, ctx: ExecContext):
        parts = self.child.execute(ctx)
        return [[self._eval_batch(b, ctx) for b in p] for p in parts]

    def _eval_batch(self, batch: ColumnarBatch, ctx) -> ColumnarBatch:
        cap = batch.capacity
        sel = torch.nonzero(batch.row_mask).squeeze(1)
        new_cols = list(batch.columns)
        cur_attrs = list(self.child.output)
        cur = batch
        for al, pipe in zip(self.udf_aliases, self._pipelines()):
            udf = al.child
            arg_batch = pipe.run(cur)
            result = self._dict_domain_call(udf, arg_batch, sel, ctx)
            if result is None:
                args = [host_values(c, sel) for c in arg_batch.columns]
                result = self._call(udf, args, int(sel.shape[0]))
            ctx.launches.add("python_udf")
            new_cols.append(self._to_column(udf.return_type, result, sel,
                                            cap, batch.device))
            cur_attrs.append(al.to_attribute())
            cur = ColumnarBatch(attrs_schema(cur_attrs), new_cols,
                                batch.row_mask, batch._num_rows)
        return ColumnarBatch(attrs_schema(self.output), new_cols,
                             batch.row_mask, batch._num_rows)

    def _dict_domain_call(self, udf, arg_batch: ColumnarBatch,
                          sel: torch.Tensor, ctx):
        """Dictionary-domain lane: a deterministic UDF over one
        dictionary-encoded column (a string, or an array, map, struct or
        binary value: a higher-order function whose lambda captures no
        column has just its collection argument) evaluates once per
        distinct live dictionary entry and maps over the codes; the
        reference takes the lane for strings only, and the per-row path
        gives the same values. Returns the per-row results, or None where
        the lane does not apply (the per-row path runs). Gated by
        spark.tpu.encoding.enabled, as in the reference."""
        if not ctx.conf.get(ENCODING_ENABLED):
            return None
        if not getattr(udf, "deterministic", True):
            return None
        if len(arg_batch.columns) != 1:
            return None
        c = arg_batch.columns[0]
        if not dict_encoded(c.dtype) or c.dictionary is None:
            return None
        values = c.dictionary.values
        n = int(sel.shape[0])
        if not values or len(values) >= max(n, 1):
            return None  # domain not smaller than the rows: no win
        codes = np.clip(c.data[sel].cpu().numpy(), 0, len(values) - 1)
        vm = None
        if c.validity is not None:
            vm = c.validity[sel].cpu().numpy()
        # evaluate over the live distinct codes only: the dictionary still
        # holds values only rows an upstream filter dropped carry
        live_codes = np.unique(codes if vm is None else codes[vm])
        if live_codes.size:
            dvals = np.empty(live_codes.size, dtype=object)
            text = isinstance(c.dtype, StringType)
            for j, cd in enumerate(live_codes):  # lists stay whole
                dvals[j] = str(values[cd]) if text else values[cd]
            per_value = np.asarray(self._call(udf, [dvals], live_codes.size))
            pos = np.clip(np.searchsorted(live_codes, codes), 0,
                          live_codes.size - 1)
            out = per_value[pos]
        else:
            out = np.empty(n, dtype=object)
        if vm is not None and not vm.all():
            # the null lane evaluates once too (invalid rows hand the UDF
            # a None)
            null_res = self._call(udf, [np.array([None], dtype=object)], 1)
            out = np.asarray(out, dtype=object).copy()
            out[~vm] = null_res[0] if len(null_res) else None
        ctx.metrics.add("udf.dict_domain_evals")
        ctx.metrics.add("udf.dict_domain_rows_saved", n - live_codes.size)
        return out

    @staticmethod
    def _call(udf, args: list, n: int):
        if n == 0:
            return np.zeros(0)
        if udf.vectorized:
            try:
                out = np.asarray(udf.fn(*args))
                if out.shape[:1] == (n,):
                    return out
            except Exception:
                pass
        # row-at-a-time fallback (Spark's non-Arrow UDF path)
        return np.array([udf.fn(*[a[i] for a in args]) for i in range(n)],
                        dtype=object)

    @staticmethod
    def _to_column(dt, result, sel: torch.Tensor, cap: int,
                   device) -> Column:
        result = np.asarray(result)
        nulls = np.array([v is None for v in result], bool) \
            if result.dtype == object else np.zeros(len(result), bool)
        sel_np = sel.cpu().numpy()
        if isinstance(dt, (ArrayType, MapType, StructType)):
            # np.asarray may have made equal-length list results 2-D: take
            # them row by row
            fix = conform if _holds_scaled(dt) else (lambda v, _dt: v)
            rows = [None if v is None else
                    fix(list(v) if isinstance(v, np.ndarray) else v, dt)
                    for v in (result.tolist() if result.ndim > 1
                              else result)]
            values, codes = encode_values(rows)
            data = np.zeros(cap, np.int32)
            data[sel_np] = codes
            validity = np.zeros(cap, bool)
            validity[sel_np] = np.array([v is not None for v in rows], bool)
            return Column(dt, torch.from_numpy(data).to(device),
                          torch.from_numpy(validity).to(device),
                          StringDict(values or [empty_entry(dt)]))
        if isinstance(dt, StringType):
            values: list[str] = []
            index: dict[str, int] = {}
            codes = np.zeros(len(result), np.int32)
            for i, v in enumerate(result):
                if v is None:
                    continue
                s = str(v)
                j = index.get(s)
                if j is None:
                    j = len(values)
                    values.append(s)
                    index[s] = j
                codes[i] = j
            data = np.zeros(cap, np.int32)
            data[sel_np] = codes
            validity = np.zeros(cap, bool)
            validity[sel_np] = ~nulls
            return Column(dt, torch.from_numpy(data).to(device),
                          torch.from_numpy(validity).to(device),
                          StringDict(values or [""]))
        dd = dt.numpy_dtype
        clean = np.asarray([0 if v is None else v for v in result]
                           if result.dtype == object else result)
        data = np.zeros(cap, dd)
        data[sel_np] = clean.astype(dd)[:len(sel_np)]
        validity = None
        if nulls.any():
            vm = np.zeros(cap, bool)
            vm[sel_np] = ~nulls
            validity = torch.from_numpy(vm).to(device)
        return Column(dt, torch.from_numpy(data).to(device), validity, None)

    def simple_string(self):
        names = ", ".join(a.child.fname for a in self.udf_aliases)
        return f"PythonEval[{names}]"
