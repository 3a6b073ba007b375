"""Expression evaluation contexts (counterpart of `spark_tpu/expr/eval.py`).

A string value carries its host dictionary (`sdict`) beside its device
codes, and an expression that needs a lookup table over a dictionary
(value hashes, ranks, recodes, parsed values) asks the context for it with
`ctx.aux(make)`. Three contexts answer:

  * `EvalCtx`: eager evaluation over one batch (the operator-at-a-time
    pipelines). A lut crosses to the device where the expression needs it,
    cached on its dictionary where the expression says how.
  * `HostCtx`: the host pass of a fused stage (the reference's HostCtx).
    The expressions run over meta tensors, so no row is computed and no
    value is read: the pass yields each output's dtype, validity presence
    and dictionary, and every lut the device pass will read, as numpy
    arrays padded to a power of two (`aux_arrays`, in request order). A
    program's key holds only their shapes, so an expression asks for the
    same luts whatever its dictionaries hold. A value read on the host (a
    sync) raises here, on the CPU too.
  * `TraceCtx`: the device pass of a fused stage (the reference's
    TraceCtx): the same expressions over the stage's inputs, each `aux`
    request answered by the next of the luts the host pass harvested,
    already on the device. Nothing in it copies from the host, so it can
    be captured into a CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..types import DataType

__all__ = ["Val", "EvalCtx", "HostCtx", "TraceCtx", "pad_pow2"]


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


def pad_pow2(arr: np.ndarray, minimum: int = 8) -> np.ndarray:
    """`arr` (1-D) padded to a power-of-two length of at least `minimum`
    by repeating its last entry, so a fused program's key does not change
    with every dictionary size. Codes clamp into a lut, so a live code
    reads what it read unpadded; a membership test over padded targets
    sees the last target twice."""
    arr = np.asarray(arr)
    if arr.size == 0:
        arr = np.zeros(1, dtype=arr.dtype)
    n = minimum
    while n < arr.shape[0]:
        n <<= 1
    if n == arr.shape[0]:
        return arr
    return np.pad(arr, (0, n - arr.shape[0]), mode="edge")


class EvalCtx:
    """Memoized eager evaluation over one batch. `inputs` maps attribute
    expr_id -> Val."""

    # True in the two passes of a fused stage: an expression whose luts
    # depend on the dictionary's contents then asks for them all the same
    fused = False

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
        # a fill kernel, not a host copy: literals may sit inside a
        # captured stage (they are part of its key)
        return torch.full((), value, dtype=dtype, device=self.device)

    def aux(self, make: Callable[[], np.ndarray],
            cached: Callable[[], torch.Tensor] | None = None
            ) -> torch.Tensor:
        """A lookup table on the device: `cached()` (a copy the
        dictionary keeps per device) where the expression has one, else
        `make()` (a numpy array) copied over."""
        if cached is not None:
            return cached()
        return torch.from_numpy(np.asarray(make())).to(self.device)

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


class HostCtx(EvalCtx):
    """The host pass of a fused stage over meta tensors; see the module
    docstring. `aux_arrays` holds the luts in request order."""

    fused = True

    def __init__(self, inputs: dict[int, Val], capacity: int):
        super().__init__(inputs, capacity, torch.device("meta"))
        self.aux_arrays: list[np.ndarray] = []

    def aux(self, make, cached=None) -> torch.Tensor:
        arr = pad_pow2(np.asarray(make()))
        self.aux_arrays.append(arr)
        return torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype,
                           device="meta")

    def signature(self) -> tuple:
        """Part of a fused program's key: the luts' shapes and dtypes."""
        return tuple((a.shape, str(a.dtype)) for a in self.aux_arrays)


class TraceCtx(EvalCtx):
    """The device pass of a fused stage: `aux_args` are the host pass's
    luts on the device, answered in request order."""

    fused = True

    def __init__(self, inputs: dict[int, Val], capacity: int,
                 device: torch.device, aux_args: list):
        super().__init__(inputs, capacity, device)
        self._aux_args = aux_args
        self._aux_pos = 0

    def aux(self, make, cached=None) -> torch.Tensor:
        a = self._aux_args[self._aux_pos]
        self._aux_pos += 1
        return a
