"""Sort kernels (counterpart of `spark_tpu/ops/sorting.py`).

The JAX package sorts every key operand at once with `lax.sort(num_keys=k,
is_stable=True)`. PyTorch's sort takes one key, so the same order comes from
chained stable passes, least significant operand first: each pass sorts the
next operand gathered by the permutation so far, and stability keeps the
order of the passes before it. The operands, most significant first, are
the inactive-row flag, then per key its null flag (when it has a validity
plane) and its directional value; the row index is the payload, so ties keep
input order. Flags sort as uint8: a radix sort on the card then makes one
8-bit pass instead of four for int32.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class SortKeySpec(NamedTuple):
    ascending: bool = True
    nulls_first: bool | None = None  # None => Spark default (first if asc)

    @property
    def nulls_first_effective(self) -> bool:
        if self.nulls_first is None:
            return self.ascending
        return self.nulls_first


def _directional(key: torch.Tensor, ascending: bool) -> torch.Tensor:
    """Transform key so an ascending sort yields the requested order.

    Signed ints: bitwise NOT is an exact order reversal (~x = -x-1, no
    overflow). Floats: NaN becomes +inf (SQL: NaN sorts greatest), then
    negate for DESC. -0.0 becomes 0.0: the two compare equal and keep input
    order in `lax.sort`, while a radix sort on the card orders them by bit
    pattern."""
    if key.dtype.is_floating_point:
        k = torch.where(torch.isnan(key),
                        torch.full_like(key, float("inf")), key)
        if not ascending:
            k = -k
        return torch.where(k == 0, torch.zeros_like(k), k)
    if ascending:
        return key
    return ~key  # bool and signed ints


def sort_permutation(keys: Sequence[torch.Tensor],
                     valids: Sequence[torch.Tensor | None],
                     specs: Sequence[SortKeySpec],
                     row_mask: torch.Tensor) -> torch.Tensor:
    """int64 permutation ordering live rows by the sort spec; inactive rows
    last. Keys are in the numeric sort-key domain (Column.sort_keys())."""
    # most significant first
    operands = [(~row_mask).to(torch.uint8)]
    for key, valid, spec in zip(keys, valids, specs):
        if valid is not None:
            nf = spec.nulls_first_effective
            operands.append((valid if nf else ~valid).to(torch.uint8))
            key = torch.where(valid, key, torch.zeros_like(key))
        operands.append(_directional(key, spec.ascending))
    perm = None
    for op in reversed(operands):
        order = torch.sort(op if perm is None else op[perm], stable=True)[1]
        perm = order if perm is None else perm[order]
    return perm


def limit_mask(row_mask_sorted: torch.Tensor, n: int,
               offset: int = 0) -> torch.Tensor:
    """Keep the first n live rows after skipping `offset` (post-sort): the
    LocalLimit/GlobalLimit kernel."""
    live_rank = torch.cumsum(row_mask_sorted.to(torch.int64), 0)
    keep = row_mask_sorted & (live_rank <= offset + n)
    return keep & (live_rank > offset) if offset else keep
