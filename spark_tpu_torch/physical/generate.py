"""GenerateExec: row expansion for explode() (counterpart of
`spark_tpu/physical/generate.py`; the role of Spark's GenerateExec).

An array has no dense device layout, so the expansion is planned per
dictionary entry on the host, once per dictionary: each entry's element
count, its first element's offset into one flat element table, and that
table (the elements' device values, their validity, and for string or
nested elements a dictionary of their own). Splitting runs once per
distinct string, never per row. On the device each row's count gathers
through its code, the rows repeat (`repeat_interleave`), and each output
row's element gathers from the flat table. The output size is known only
after one read of the total on the host, so the operator stays out of
fused stages and captured graphs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar.batch import (
    Column, ColumnarBatch, StringDict, _take_codes, bucket_capacity,
    empty_entry, encode_values,
)
from ..columnar.ops import gather_batch
from ..errors import UnsupportedOperationError
from ..exec.context import ExecContext
from ..expr.expressions import (
    AttributeReference, Literal, Split, _device_value,
)
from ..types import ArrayType, StringType, dict_encoded
from .operators import PhysicalPlan, attrs_schema


class _Tables:
    """The expansion plan of one dictionary: counts and offsets per entry
    (int64), and the flat elements' device values, validity and
    dictionary."""

    def __init__(self, lists: list, edt):
        counts = np.array([len(x) for x in lists] or [0], np.int64)
        offsets = np.zeros(len(counts), np.int64)
        np.cumsum(counts[:-1], out=offsets[1:])
        flat = [e for lst in lists for e in lst]
        valid = np.array([e is not None for e in flat] or [True], bool)
        if dict_encoded(edt):
            uniq, codes = encode_values(flat)
            data = codes if len(flat) else np.zeros(1, np.int32)
            self.dictionary = StringDict(uniq or [empty_entry(edt)])
        else:
            data = np.zeros(max(len(flat), 1), edt.numpy_dtype)
            for i, e in enumerate(flat):
                if e is not None:
                    data[i] = _device_value(edt, e)
            self.dictionary = None
        self.host = (counts, offsets, data, valid)
        self.any_null = not valid.all()
        self._device: dict = {}

    def on(self, device) -> tuple:
        key = str(device)
        hit = self._device.get(key)
        if hit is None:
            hit = self._device[key] = tuple(
                torch.from_numpy(a).to(device) for a in self.host)
        return hit


class GenerateExec(PhysicalPlan):
    child_fields = ("child",)

    def __init__(self, generator, element_attr: AttributeReference,
                 child: PhysicalPlan):
        if not (isinstance(generator, Split)
                or (isinstance(generator, (AttributeReference, Literal))
                    and isinstance(generator.dtype, ArrayType))):
            raise UnsupportedOperationError(
                "explode() supports split(col, delim) or an array column")
        self.generator = generator
        self.element_attr = element_attr
        self.child = child

    @property
    def output(self):
        return self.child.output + [self.element_attr]

    def output_partitioning(self):
        return self.child.output_partitioning()

    def _source(self):
        return self.generator.child if isinstance(self.generator, Split) \
            else self.generator

    def execute(self, ctx: ExecContext):
        src = self._source()
        if isinstance(src, Literal):
            cidx = None  # every row expands by the same literal list
        elif isinstance(src, AttributeReference):
            pos = {a.expr_id: i for i, a in enumerate(self.child.output)}
            cidx = pos[src.expr_id]
        else:
            raise UnsupportedOperationError(
                "split() argument must be a column or literal")
        out_schema = attrs_schema(self.output)
        parts = self.child.execute(ctx)
        ctx.launches.add("generate")
        return [[self._expand(b, cidx, out_schema) for b in p]
                for p in parts]

    def _tables(self, values: list) -> _Tables:
        """The expansion plan of a dictionary's values (or a literal's
        one value), memoised on its StringDict as a transform is."""
        if isinstance(self.generator, Split):
            if values and not isinstance(values[0], str):
                raise UnsupportedOperationError("split() needs a string")
            lists = self.generator.split_lists(values or [""])
        else:
            lists = [list(v) for v in values] or [[]]
        return _Tables(lists, self.element_attr.dtype)

    def _expand(self, batch: ColumnarBatch, cidx: int | None,
                out_schema) -> ColumnarBatch:
        dev = batch.device
        cap = batch.capacity
        if cidx is None:
            src = self._source()
            if src.value is None:
                tables = self._tables([])  # explode(NULL) emits nothing
                live = torch.zeros(cap, dtype=torch.bool, device=dev)
            else:
                tables = self._tables([src.value])
                live = batch.row_mask
            codes = torch.zeros(cap, dtype=torch.int32, device=dev)
        else:
            col = batch.columns[cidx]
            sd = col.dictionary or StringDict([])
            key = ("generate", self.generator.simple_string(),
                   self.element_attr.dtype.simple_string())
            tables = sd._transforms.get(key)
            if tables is None:
                tables = sd._transforms[key] = self._tables(sd.values)
            codes = col.data
            live = batch.row_mask if col.validity is None \
                else batch.row_mask & col.validity
        counts_l, offsets_l, data_l, valid_l = tables.on(dev)
        counts = torch.where(live, _take_codes(counts_l, codes), 0)
        total = int(counts.sum().item())  # the output size: one host read
        out_cap = bucket_capacity(max(total, 1))
        src_rows = torch.repeat_interleave(
            torch.arange(cap, device=dev), counts, output_size=total)
        # each output row's element: its row's first element's offset plus
        # its position among the row's outputs
        starts = torch.cumsum(counts, 0) - counts
        within = torch.arange(total, device=dev) - starts[src_rows]
        elem = _take_codes(offsets_l, codes[src_rows]) + within
        pad = out_cap - total
        rows = torch.nn.functional.pad(src_rows, (0, pad))
        elem = torch.nn.functional.pad(elem, (0, pad))
        out_mask = torch.arange(out_cap, device=dev) < total
        gathered = gather_batch(batch, rows, out_mask)
        edt = self.element_attr.dtype
        elem_col = Column(edt, _take_codes(data_l, elem),
                          _take_codes(valid_l, elem) if tables.any_null
                          else None, tables.dictionary)
        return ColumnarBatch(out_schema, list(gathered.columns) + [elem_col],
                             out_mask, num_rows=total)

    def simple_string(self):
        return f"Generate[{self.generator.simple_string()}]"
