"""Expression evaluation context (counterpart of `spark_tpu/expr/eval.py`).

The JAX package evaluates each expression twice: a host pass for metadata
and aux lookup tables (dictionaries, their hash and rank luts), then a trace
inside `jax.jit`. PyTorch runs eagerly, so one pass does both: a string
value carries its host dictionary (`sdict`) beside its device codes, and a
lut crosses to the device where the expression needs it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..types import DataType

__all__ = ["Val", "EvalCtx"]


@dataclass
class Val:
    """An evaluated expression value: `data` is a tensor of the batch's
    capacity or a 0-dim tensor (literals); `validity` a bool tensor of
    either shape, or None when the value has no nulls; `sdict` the host
    dictionary a string value's codes index."""

    dtype: DataType
    data: Any
    validity: Any = None
    sdict: Any = None


class EvalCtx:
    """Memoized evaluation over one batch. `inputs` maps attribute
    expr_id -> Val."""

    def __init__(self, inputs: dict[int, Val], capacity: int,
                 device: torch.device):
        # entries hold a strong ref to the keyed expression: id() values
        # recycle after GC, and eval() builds transient nodes (cast_if)
        self._memo: dict[int, tuple[Any, Val]] = {}
        self.inputs = inputs
        self.capacity = capacity
        self.device = device

    def eval(self, expr) -> Val:
        key = id(expr)
        hit = self._memo.get(key)
        if hit is not None and hit[0] is expr:
            return hit[1]
        v = expr.eval(self)
        self._memo[key] = (expr, v)
        return v

    def attribute(self, expr_id: int) -> Val:
        return self.inputs[expr_id]

    def scalar(self, value, dtype: torch.dtype) -> torch.Tensor:
        return torch.tensor(value, dtype=dtype, device=self.device)

    @staticmethod
    def and_valid(*vals: Val):
        """Combined validity (NULL if any input is NULL)."""
        present = [v.validity for v in vals if v.validity is not None]
        if not present:
            return None
        out = present[0]
        for p in present[1:]:
            out = out & p
        return out
