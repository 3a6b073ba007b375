"""Device memory discipline for blocking operators (the port's copy of
`spark_tpu/exec/memory.py`): how many rows a blocking operator may hold as
one device tile before it takes its multi-pass path. A sort partition over
the budget takes the external range-bucketed sort
(physical/external_sort.py); a join build over it takes the grace hash
join (HashJoinExec._grace_join). The caching allocator owns the card's
memory, so the budget is operator policy, not a reservation ledger.

Budget resolution: an explicit `spark.tpu.memory.deviceBudgetBytes` >
half of the card's memory (`torch.cuda.mem_get_info`) > 4 GiB, the
reference's fallback, which is what a CPU session takes, so its decisions
equal the reference's there. One MemoryManager travels with a query's
ExecContext and counts into its metrics.

Not ported: the host shuffle buffers' spilling to disk
(`spark.tpu.shuffle.spillBytes`, `spark.local.dir`; the port's reduce
buffers stay on the device), the map-side column stats and the
pre-flight memory budget (`spark.tpu.memory.budget`, A12).
"""

from __future__ import annotations

import functools

import torch

from ..config import ConfigEntry, _register
from ..types import dict_encoded

DEVICE_BUDGET = _register(ConfigEntry(
    "spark.tpu.memory.deviceBudgetBytes", 0,
    "Device-memory budget (bytes) a single blocking operator may "
    "materialize as one tile. 0 = auto: half of the card's memory, else "
    "4 GiB.", int))

_MIN_TILE_ROWS = 1 << 14
_EXPLICIT_MIN_TILE_ROWS = 1 << 10
_FALLBACK_BUDGET = 4 << 30


def schema_row_bytes(schema) -> int:
    """Device bytes per row: column data (dict-encoded = int32 codes) +
    validity planes + the row mask."""
    total = 1  # row mask
    for f in schema.fields:
        if dict_encoded(f.dataType):
            total += 4
        else:
            total += f.dataType.device_dtype.itemsize
        total += 1  # validity (may be absent; budget conservatively)
    return total


@functools.lru_cache(maxsize=16)
def _card_bytes(device: torch.device) -> int:
    """The card's total memory (constant: asked once per device)."""
    return torch.cuda.mem_get_info(device)[1]


def _auto_budget(device) -> int:
    if device is not None and torch.device(device).type == "cuda":
        return _card_bytes(torch.device(device)) // 2
    return _FALLBACK_BUDGET


class MemoryManager:
    """Per-query policy object; see the module note."""

    def __init__(self, conf, metrics=None, device=None):
        explicit = int(conf.get(DEVICE_BUDGET))
        self.device_budget = explicit if explicit > 0 \
            else _auto_budget(device)
        # an explicit budget is a deliberate cap and may push tiles below
        # the auto floor
        self._floor = _EXPLICIT_MIN_TILE_ROWS if explicit > 0 \
            else _MIN_TILE_ROWS
        self.metrics = metrics

    def tile_rows(self, schema, amplification: int = 3) -> int:
        """Most rows a blocking operator may hold in one device tile.
        `amplification` models its working set beside the input tile
        (sort: keys + permutation + gathered output, about 3x; join build:
        build + probe + outputs, about 4x)."""
        per_row = schema_row_bytes(schema) * max(1, amplification)
        return max(self._floor, int(self.device_budget // per_row))

    def count(self, name: str, v: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.add(name, v)
