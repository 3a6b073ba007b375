"""spark_tpu_torch — the PyTorch/CUDA port of spark_tpu for NVIDIA Hopper.

A second package beside `spark_tpu` (the JAX reference), with the same
module paths: `spark_tpu_torch/ops/grouping.py` is held against
`spark_tpu/ops/grouping.py`. It imports torch, never jax, and nothing of
`spark_tpu`. The two Pallas kernels of the reference have hand-written CUDA
counterparts in `csrc/scatter_kernels.cu`.

Exports resolve lazily (PEP 562)."""

__version__ = "0.1.0"

_EXPORTS = {
    "TorchSession": ".api.session",
    "DataFrame": ".api.dataframe",
    "Row": ".api.dataframe",
    "Column": ".api.column",
    "AnalysisException": ".errors",
    "NotPortedError": ".errors",
    "DeviceUnavailableError": ".errors",
    "SparkTpuError": ".errors",
}

__all__ = [*_EXPORTS]


def __getattr__(name):
    import importlib

    home = _EXPORTS.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    val = getattr(importlib.import_module(home, __name__), name)
    globals()[name] = val
    return val


def __dir__():
    return sorted(set(globals()) | set(__all__))
