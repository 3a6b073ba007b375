"""Python UDF expression (counterpart of `spark_tpu/expr/pyudf.py`).

The role of Spark's PythonUDF + Arrow eval path (ArrowEvalPythonExec). In
process there is no JVM/Python boundary to cross, so the worker protocol
collapses to a vectorized host evaluation over the batch's columns: device
pipelines evaluate the UDF's argument expressions, live rows cross to the
host once, the function runs vectorized (numpy in and out, a row-at-a-time
fallback), and the result re-enters the device as a new column. The port
builds these only from host-only expressions (RewriteHostOnlyExpressions).
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

from ..errors import ExecutionError
from ..types import DataType
from .expressions import Expression

_udf_uid_counter = itertools.count(1)


class PythonUDF(Expression):
    child_fields = ("args",)

    def __init__(self, fn: Callable, args: Sequence[Expression],
                 return_type: DataType, name: str = "udf",
                 vectorized: bool = True, deterministic: bool = True):
        self.fn = fn
        self.args = list(args)
        self.return_type = return_type
        self.fname = name
        self.vectorized = vectorized
        # deterministic element-wise contract: licenses the
        # dictionary-domain lane of PythonEvalExec (evaluate once per
        # distinct value of a dictionary-encoded argument)
        self.deterministic = deterministic

    @property
    def dtype(self) -> DataType:
        return self.return_type

    @property
    def nullable(self) -> bool:
        return True

    def _data_args(self):
        # a process-unique serial kept on the function, not id(fn): a dead
        # function's recycled address must not make two UDFs equal
        uid = getattr(self.fn, "_sparktpu_uid", None)
        if uid is None:
            uid = getattr(self, "_fallback_uid", None)
        if uid is None:
            uid = next(_udf_uid_counter)
            try:
                self.fn._sparktpu_uid = uid
            except (AttributeError, TypeError):
                # unsettable callable (builtin/method): pin the uid on the
                # expression so repeated calls stay equal
                object.__setattr__(self, "_fallback_uid", uid)
        return (("fn", uid), ("name", self.fname))

    def eval(self, ctx):
        raise ExecutionError(
            "PythonUDF must be extracted by the planner (ExtractPythonUDFs)")

    def simple_string(self):
        a = ", ".join(x.simple_string() for x in self.args)
        return f"{self.fname}({a})"
