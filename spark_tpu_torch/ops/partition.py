"""Exchange partitioning (counterpart of `spark_tpu/ops/partition.py`).

The partition id is computed for a whole batch (hash, round-robin, or a
search of sampled range bounds); rows are then grouped by pid with one
stable sort so the shuffle can slice contiguous per-partition
runs. The per-partition live counts come from the hand-written histogram
kernel (ops/scatter_kernels.partition_histogram).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .hashing import hash_columns, partition_ids
from .scatter_kernels import partition_histogram


class PartitionedRows(NamedTuple):
    perm: torch.Tensor    # int64[cap]: row order grouped by pid (inactive last)
    pids: torch.Tensor    # int32[cap]: pid per sorted slot (P where inactive)
    counts: torch.Tensor  # int64[num_partitions]: live rows per partition


def hash_partition(key_cols: Sequence[torch.Tensor],
                   key_valids: Sequence[torch.Tensor | None],
                   row_mask: torch.Tensor,
                   num_partitions: int, seed: int = 42) -> PartitionedRows:
    h = hash_columns(key_cols, list(key_valids), seed=seed)
    pids = partition_ids(h, num_partitions)
    return _group_by_pid(pids, row_mask, num_partitions)


def round_robin_partition(row_mask: torch.Tensor, num_partitions: int,
                          start: int = 0) -> PartitionedRows:
    """Round-robin over live rows; `start` is the running live-row offset
    across the exchange's batches."""
    live_rank = torch.cumsum(row_mask.to(torch.int64), 0) - 1
    pids = ((live_rank + start) % num_partitions).to(torch.int32)
    return _group_by_pid(pids, row_mask, num_partitions)


def range_partition(sort_keys: torch.Tensor, bounds: torch.Tensor,
                    row_mask: torch.Tensor, num_partitions: int,
                    descending: bool = False,
                    key_valid: torch.Tensor | None = None,
                    nulls_first: bool = True) -> PartitionedRows:
    """Range partitioning against sampled bounds: `bounds` is
    int64/float64[num_partitions-1] ascending in the sort-key domain (NaN
    as +inf, the greatest value). Null keys go to the first partition when
    they sort first and to the last when they sort last."""
    if sort_keys.dtype.is_floating_point:
        sort_keys = torch.where(torch.isnan(sort_keys),
                                torch.full_like(sort_keys, float("inf")),
                                sort_keys)
    pids = torch.searchsorted(bounds, sort_keys.to(bounds.dtype),
                              right=True).to(torch.int32)
    if descending:
        pids = (num_partitions - 1) - pids
    if key_valid is not None:
        null_pid = 0 if nulls_first else num_partitions - 1
        pids = torch.where(key_valid, pids, torch.full_like(pids, null_pid))
    return _group_by_pid(pids, row_mask, num_partitions)


def _group_by_pid(pids: torch.Tensor, row_mask: torch.Tensor,
                  num_partitions: int) -> PartitionedRows:
    key = torch.where(row_mask, pids,
                      torch.full_like(pids, num_partitions))  # inactive last
    skey, perm = torch.sort(key, stable=True)
    counts = partition_histogram(pids, row_mask, num_partitions)
    return PartitionedRows(perm, skey, counts.to(torch.int64))
