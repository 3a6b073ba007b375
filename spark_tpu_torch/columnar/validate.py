"""Batch invariant validation, a debug mode (counterpart of
`spark_tpu/columnar/validate.py`).

With spark.tpu.debug.validateBatches=true the stage scheduler checks every
stage's output batches (`exec/scheduler.py`): the column count against the
schema, the row mask's dtype and shape, each column's shape and device
dtype, its validity plane, and the dictionary code bounds of every
dictionary-encoded column (strings, as the reference checks, and also
binary, arrays, maps and structs). A kernel fault then shows at the stage
that produced it rather than rows downstream. The code bounds read two
scalars of each such column to the host: a sync per column, which is the
price of the debug mode and is paid only when the key is set.
"""

from __future__ import annotations

import torch

from ..config import VALIDATE_BATCHES
from ..errors import ExecutionError
from ..types import dict_encoded
from .batch import ColumnarBatch


def validate_batch(batch: ColumnarBatch, site: str = "") -> None:
    cap = batch.capacity
    if len(batch.columns) != len(batch.schema.fields):
        raise ExecutionError(
            f"[{site}] column count {len(batch.columns)} != schema "
            f"{len(batch.schema.fields)}")
    mask = batch.row_mask
    if mask.dtype != torch.bool or tuple(mask.shape) != (cap,):
        raise ExecutionError(
            f"[{site}] bad row mask {mask.dtype} {tuple(mask.shape)}")
    for f, c in zip(batch.schema.fields, batch.columns):
        d = c.data
        if tuple(d.shape) != (cap,):
            raise ExecutionError(
                f"[{site}] column {f.name}: shape {tuple(d.shape)} != cap "
                f"{cap}")
        if d.dtype != f.dataType.device_dtype:
            raise ExecutionError(
                f"[{site}] column {f.name}: dtype {d.dtype} != "
                f"{f.dataType.device_dtype}")
        live = mask
        if c.validity is not None:
            v = c.validity
            if v.dtype != torch.bool or tuple(v.shape) != (cap,):
                raise ExecutionError(
                    f"[{site}] column {f.name}: bad validity "
                    f"{v.dtype} {tuple(v.shape)}")
            live = mask & v
        if dict_encoded(f.dataType):
            if c.dictionary is None:
                raise ExecutionError(
                    f"[{site}] {f.dataType.simple_string()} column {f.name} "
                    "missing dictionary")
            n = max(len(c.dictionary), 1)
            lo, hi, any_live = (int(x) for x in torch.stack([
                torch.where(live, d, torch.full_like(d, n)).min(),
                torch.where(live, d, torch.full_like(d, -1)).max(),
                live.any().to(d.dtype)]).tolist())
            if any_live and (lo < 0 or hi >= n):
                raise ExecutionError(
                    f"[{site}] column {f.name}: code out of range "
                    f"[{lo}, {hi}] for dict size {n}")


def maybe_validate(parts, ctx, site: str):
    """Validate every batch of `parts` when the session's
    spark.tpu.debug.validateBatches is set; returns `parts`."""
    if not ctx.conf.get(VALIDATE_BATCHES):
        return parts
    for p in parts:
        for b in p:
            validate_batch(b, site)
    return parts
