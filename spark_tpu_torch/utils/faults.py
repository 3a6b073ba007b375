"""Runtime-fault classification (counterpart of `is_runtime_fault` in
`spark_tpu/utils/faults.py`; the port has no chaos points, so no
`InjectedFault`).

A runtime fault is a failure of a program on the device that a smaller
execution granularity may avoid: the card running out of memory, also when
that happened inside a CUDA graph capture (`CaptureError` caused by it).
The whole-query tier then re-executes stage at a time. Anything else (a
host read inside a capture, a shape error, `NotPortedError`) is a logic
error and keeps propagating: re-executing a deterministic bug elsewhere
hides it."""

from __future__ import annotations

import torch


def is_runtime_fault(e: BaseException) -> bool:
    """Is `e` the card running out of memory, directly or as the cause of
    a failed capture?"""
    from .cuda_graph import CaptureError

    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(e, CaptureError) \
        and isinstance(e.__cause__, torch.cuda.OutOfMemoryError)
