"""Columnar batch substrate: fixed-capacity device tiles (counterpart of
`spark_tpu/columnar/batch.py`).

Every batch has a power-of-two `capacity`; live rows are marked by a bool
`row_mask` tensor, so filters never change tensor shapes. A column is a
tensor in its type's device dtype plus an optional bool validity plane.
Only numeric, boolean and date columns are ported; dictionary-encoded
(string) columns raise `NotPortedError`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ..types import (
    BooleanType, DateType, NullType, StructType, to_arrow_type,
)

__all__ = ["Column", "ColumnarBatch", "bucket_capacity"]


def bucket_capacity(n: int, minimum: int = 1 << 10) -> int:
    """Round a row count up to a power-of-two capacity bucket (1024 floor),
    the same buckets the JAX package uses."""
    cap = minimum
    while cap < n:
        cap <<= 1
    return cap


@dataclass(frozen=True)
class Column:
    """One column of a batch: device data + optional validity plane.

    data: tensor [capacity] in dtype.device_dtype
    validity: bool tensor [capacity] or None (= no nulls)
    """

    dtype: Any
    data: torch.Tensor
    validity: torch.Tensor | None = None

    def eq_keys(self) -> torch.Tensor:
        """Tensor usable as an equality key (group-by, exchange hashing)."""
        if isinstance(self.dtype, BooleanType):
            return self.data.to(torch.int32)
        return self.data

    def sort_keys(self) -> torch.Tensor:
        """Tensor whose numeric order is SQL ORDER BY order (booleans as
        int32: the card's sort takes no bool keys)."""
        if isinstance(self.dtype, BooleanType):
            return self.data.to(torch.int32)
        return self.data


class ColumnarBatch:
    """A fixed-capacity tile of rows. `num_rows` is the host-known live
    count when available (None after a device-side filter until counted)."""

    __slots__ = ("schema", "columns", "row_mask", "_num_rows")

    def __init__(self, schema: StructType, columns: Sequence[Column],
                 row_mask: torch.Tensor, num_rows: int | None = None):
        if len(schema.fields) != len(columns):
            raise ValueError(f"{len(schema.fields)} fields, "
                             f"{len(columns)} columns")
        self.schema = schema
        self.columns = list(columns)
        self.row_mask = row_mask
        self._num_rows = num_rows

    @property
    def capacity(self) -> int:
        return int(self.row_mask.shape[0])

    @property
    def device(self) -> torch.device:
        return self.row_mask.device

    def num_rows(self) -> int:
        """Live row count; syncs with the device if unknown."""
        if self._num_rows is None:
            self._num_rows = int(self.row_mask.sum().item())
        return self._num_rows

    # --- construction ------------------------------------------------------
    @staticmethod
    def from_numpy(schema: StructType, arrays: Sequence[np.ndarray],
                   validities: Sequence[np.ndarray | None] | None = None,
                   capacity: int | None = None,
                   device: torch.device | str = "cpu",
                   row_mask: np.ndarray | None = None) -> "ColumnarBatch":
        """Build a tile from host planes. Without `row_mask` the first n
        rows are live; with it (e.g. the planes of a JAX batch, taken with
        np.asarray) the mask is used as given."""
        n = int(arrays[0].shape[0]) if arrays else 0
        if row_mask is not None:
            n = int(row_mask.shape[0])
        cap = capacity or bucket_capacity(max(n, 1))
        validities = validities or [None] * len(arrays)
        cols = []
        for f, arr, v in zip(schema.fields, arrays, validities):
            pad = np.zeros(cap, dtype=f.dataType.numpy_dtype)
            pad[:n] = np.asarray(arr, dtype=f.dataType.numpy_dtype)[:cap]
            vv = None
            if v is not None:
                vm = np.zeros(cap, dtype=bool)
                vm[:n] = np.asarray(v, dtype=bool)[:cap]
                vv = torch.from_numpy(vm).to(device)
            cols.append(Column(f.dataType, torch.from_numpy(pad).to(device), vv))
        mask = np.zeros(cap, dtype=bool)
        if row_mask is not None:
            mask[:n] = np.asarray(row_mask, dtype=bool)[:cap]
            nrows = int(mask.sum())
        else:
            mask[:n] = True
            nrows = n
        return ColumnarBatch(schema, cols, torch.from_numpy(mask).to(device),
                             num_rows=nrows)

    @staticmethod
    def empty(schema: StructType, device: torch.device | str = "cpu",
              capacity: int = 1 << 10) -> "ColumnarBatch":
        return ColumnarBatch.from_numpy(
            schema, [np.zeros(0, dtype=f.dataType.numpy_dtype)
                     for f in schema.fields],
            capacity=capacity, device=device)

    # --- host materialization ---------------------------------------------
    def to_arrow(self):
        import pyarrow as pa

        # select the live rows on the device, so only they cross to the host
        sel = torch.nonzero(self.row_mask).squeeze(1)
        arrays = []
        for f, c in zip(self.schema.fields, self.columns):
            at = to_arrow_type(f.dataType)
            if isinstance(f.dataType, NullType):
                arrays.append(pa.nulls(int(sel.shape[0])))
                continue
            data = c.data[sel].cpu().numpy()
            mask = None
            if c.validity is not None:
                mask = ~c.validity[sel].cpu().numpy()
            if isinstance(f.dataType, DateType):
                data = data.astype(np.int32)
            arrays.append(pa.array(data, type=at, mask=mask))
        return pa.table(arrays, names=self.schema.names)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"ColumnarBatch(cap={self.capacity}, rows={self._num_rows}, "
                f"schema={self.schema.simple_string()})")
