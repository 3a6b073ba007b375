"""Error-condition framework (the port's copy of `spark_tpu/errors.py`,
reduced to the classes the port raises) plus `NotPortedError`, the typed
error every operator, expression or entry point that has no PyTorch
counterpart yet raises instead of running anything else."""

from __future__ import annotations


class SparkTpuError(Exception):
    """Base error. `error_class` is a stable machine-readable identifier."""

    error_class: str = "INTERNAL_ERROR"

    def __init__(self, message: str, error_class: str | None = None):
        super().__init__(message)
        if error_class is not None:
            self.error_class = error_class


class AnalysisException(SparkTpuError):
    """Raised during analysis/resolution (reference: AnalysisException)."""

    error_class = "ANALYSIS_ERROR"


class ParseException(AnalysisException):
    """SQL text could not be parsed (reference: ParseException)."""

    error_class = "PARSE_SYNTAX_ERROR"


class UnresolvedColumnError(AnalysisException):
    error_class = "UNRESOLVED_COLUMN"

    def __init__(self, name: str, candidates: list[str] | None = None):
        hint = f". Did you mean one of: {candidates}?" if candidates else ""
        super().__init__(
            f"A column or function parameter with name `{name}` cannot be resolved{hint}"
        )
        self.name = name


class TypeCheckError(AnalysisException):
    error_class = "DATATYPE_MISMATCH"


class ExecutionError(SparkTpuError):
    """Raised while executing a physical plan."""

    error_class = "EXECUTION_ERROR"


class UnsupportedOperationError(SparkTpuError):
    error_class = "UNSUPPORTED_OPERATION"


class NotPortedError(UnsupportedOperationError):
    """The JAX package supports this, the PyTorch port does not yet.
    `what` names the operator, expression, type or entry point."""

    error_class = "NOT_PORTED"

    def __init__(self, what: str):
        super().__init__(f"{what} is not ported to spark_tpu_torch yet "
                         "(see ROADMAP.md)")
        self.what = what


class DeviceUnavailableError(ExecutionError):
    """The session asked for a CUDA device and none is present. The port
    never falls back to the CPU on its own: pass device="cpu" (or set
    spark.torch.device=cpu) to run there."""

    error_class = "DEVICE_UNAVAILABLE"
