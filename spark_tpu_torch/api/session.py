"""Session entry point (counterpart of `spark_tpu/api/session.py`, the
DataFrame surface of the slice): `TorchSession(appName, conf, device)`,
`createDataFrame`, `conf` and `stop`.

The session runs on CUDA unless the caller asks for the CPU, by
`device="cpu"` or the conf key `spark.torch.device`. With no card and no
explicit CPU it raises `DeviceUnavailableError`; there is no silent
fallback.
"""

from __future__ import annotations

from typing import Any

import pyarrow as pa
import torch

from ..config import DEVICE, SQLConf
from ..errors import DeviceUnavailableError, NotPortedError
from ..exec.context import ExecContext, Metrics
from ..expr.expressions import AttributeReference
from ..physical.compile import LaunchCounters
from ..physical.planner import Planner
from ..plan.analyzer import Analyzer
from ..plan.logical import LocalRelation
from ..plan.optimizer import Optimizer
from ..types import from_arrow_type


def resolve_device(requested: str | torch.device | None,
                   conf: SQLConf) -> torch.device:
    """The session's device: the argument, else `spark.torch.device`, else
    cuda. CUDA without a card raises."""
    dev = torch.device(requested if requested is not None
                       else conf.get(DEVICE))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device is available; pass device='cpu' (or set "
            "spark.torch.device=cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise NotPortedError(f"device type {dev.type}")
    return dev


class TorchSession:
    def __init__(self, appName: str = "spark_tpu_torch",
                 conf: dict[str, Any] | None = None,
                 device: str | torch.device | None = None):
        self.appName = appName
        self.conf = SQLConf(conf)
        self.device = resolve_device(device, self.conf)
        self._analyzer = Analyzer()
        self._optimizer = Optimizer()
        self._metrics = Metrics()
        self.launches = LaunchCounters()
        self._scan_cache: dict = {}

    def _planner(self) -> Planner:
        return Planner(self.conf)

    def _exec_context(self) -> ExecContext:
        return ExecContext(conf=self.conf, device=self.device,
                           metrics=self._metrics, launches=self.launches,
                           scan_cache=self._scan_cache)

    @property
    def metrics(self) -> dict:
        return self._metrics.snapshot()

    def createDataFrame(self, data, schema=None):
        from .dataframe import DataFrame

        table = _to_arrow_table(data, schema)
        attrs = [AttributeReference(f.name, from_arrow_type(f.type),
                                    f.nullable)
                 for f in table.schema]
        return DataFrame(self, LocalRelation(attrs, table))

    def sql(self, sqlText: str):
        raise NotPortedError("SQL text (session.sql: lexer and parser)")

    def stop(self) -> None:
        self._scan_cache.clear()


def _to_arrow_table(data, schema) -> pa.Table:
    if schema is not None:
        raise NotPortedError("createDataFrame with an explicit schema")
    if isinstance(data, pa.Table):
        return data
    if isinstance(data, dict):
        return pa.table(data)
    if isinstance(data, (list, tuple)) and data and isinstance(data[0], dict):
        names = list(data[0].keys())
        return pa.table({n: [r.get(n) for r in data] for n in names})
    raise NotPortedError(f"createDataFrame from {type(data).__name__}")
