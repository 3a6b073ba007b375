"""Execution context shared across a query run (counterpart of
`spark_tpu/exec/context.py`): the session conf, the device the query runs
on, metric counters, the operator launch counters and the query's device
budget (`memory`, exec/memory.py). Partitions run one after another on the
device's current stream."""

from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from ..config import SQLConf
from ..physical.compile import LaunchCounters


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: dict[str, int] = defaultdict(int)

    def add(self, name: str, v: int = 1) -> None:
        with self._lock:
            self.counters[name] += v

    def peak(self, name: str, v: int) -> None:
        """Keep the largest value seen under `name`."""
        with self._lock:
            self.counters[name] = max(self.counters[name], v)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counters)


@dataclass
class ExecContext:
    conf: SQLConf = field(default_factory=SQLConf)
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    metrics: Metrics = field(default_factory=Metrics)
    launches: LaunchCounters = field(default_factory=LaunchCounters)
    # session-owned cache of ingested local tables: id(table) ->
    # (weakref to the table, {(column names, capacity): batches})
    scan_cache: dict = field(default_factory=dict, repr=False)
    _memory: object = field(default=None, repr=False)

    @property
    def memory(self):
        """The query's MemoryManager (the device budget's policy)."""
        if self._memory is None:
            from .memory import MemoryManager

            self._memory = MemoryManager(self.conf, self.metrics,
                                         self.device)
        return self._memory
