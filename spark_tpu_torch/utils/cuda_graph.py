"""Capture and replay one fused program as a CUDA graph (port-only helper;
the JAX package's counterpart is `jax.jit`, which compiles a traced program
once and dispatches it per call).

A fused stage's body is a function of a flat list of tensors (the batch's
columns, masks, lookup tables and device scalars) returning a flat list of
tensors. `capture` records it once on a side stream into a graph whose
inputs are static buffers allocated outside the capture; `CapturedProgram.
replay` copies each batch's inputs into those buffers, replays the graph on
the current stream and copies the outputs out of the graph's memory before
anything else can replay.

Memory: every graph of a cache shares ONE memory pool. A graph keeps its
intermediates for as long as it lives, and a fused stage over a 2^22-row
tile holds hundreds of MB of them; with one pool the graphs reuse each
other's blocks. That is safe only because replays run one at a time on one
stream and each replay's outputs are copied out right after it: no graph's
result is read after another graph ran. A small keeper graph holds the
pool for the cache's lifetime, since a pool whose last graph dies is freed
and its handle may not be used again.

Failure: a body that syncs with the host (`.item()`, boolean-mask
indexing, `nonzero`, a pageable host copy) or allocates in a way capture
forbids invalidates the capture. `capture` then raises `CaptureError`
naming the stage; nothing runs the stage eagerly in its place. The failed
capture leaves its pool unusable, so the caller starts a new one.

Counting: `ops/scatter_kernels.LAUNCHES` counts histogram wrapper calls in
Python, and a replay runs no Python. The calls a capture made are taken
out of the counts and kept with the graph, and every replay adds them
back, so the counts read as if the body had run eagerly once per batch.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..errors import ExecutionError

__all__ = ["CaptureError", "CapturedProgram", "capture", "new_pool",
           "as_tensors"]


class CaptureError(ExecutionError):
    """A fused stage could not be captured into a CUDA graph."""

    error_class = "STAGE_CAPTURE_FAILED"


def as_tensors(inputs: Sequence) -> list:
    """Inputs as tensors: numpy arrays (lookup tables harvested on the
    host) become CPU tensors without a copy, which a replay copies into
    its device buffers; tensors and None pass."""
    return [torch.from_numpy(np.ascontiguousarray(x))
            if isinstance(x, np.ndarray) else x for x in inputs]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def new_pool(device: torch.device):
    """(pool handle, keeper graph): a memory pool for a cache's graphs,
    held by a one-kernel graph captured into it."""
    pool = torch.cuda.graph_pool_handle()
    keeper = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        x = torch.zeros(1, device=device)
        with torch.cuda.graph(keeper, pool=pool):
            x.add_(1)
    return pool, keeper


def _end_failed_capture(device: torch.device, pool) -> None:
    """Undo what a capture that raised left behind: the allocator may
    still route this device's allocations to the pool."""
    try:
        torch._C._cuda_endAllocateToPool(device.index, pool)
    except Exception:
        pass  # the capture got far enough to end it itself


class CapturedProgram:
    """One captured fused program with its static input buffers.
    `pool_bytes` is what its capture grew the shared pool by (reserved
    memory, so an estimate of its own share), `static_bytes` its input
    buffers, `graph_bytes` both."""

    def __init__(self, name: str, graph, static_inputs: list, outputs: list,
                 hist_calls: dict, pool_bytes: int, capture_ms: float):
        self.name = name
        self.graph = graph
        self.static_inputs = static_inputs
        self.outputs = outputs
        self.hist_calls = hist_calls
        self.pool_bytes = pool_bytes
        self.static_bytes = _nbytes(static_inputs)
        self.graph_bytes = pool_bytes + self.static_bytes
        self.capture_ms = capture_ms

    def copy_in(self, inputs: Sequence) -> None:
        for dst, src in zip(self.static_inputs, inputs):
            if dst is not None:
                dst.copy_(src, non_blocking=True)

    def copy_out(self) -> list:
        return [None if o is None else o.clone() for o in self.outputs]

    def replay(self, inputs: Sequence) -> list:
        """Copy `inputs` in, replay, and return copies of the outputs."""
        from ..ops import scatter_kernels as sk

        self.copy_in(inputs)
        self.graph.replay()
        out = self.copy_out()
        for k, n in self.hist_calls.items():
            sk.LAUNCHES[k] += n
        return out


def capture(name: str, fn: Callable[[list], list], inputs: Sequence,
            device: torch.device, pool) -> CapturedProgram:
    """Capture `fn` over static buffers shaped as `inputs` (tensors or
    None, on `device` or host lookup tables) into a graph in `pool`.
    Raises CaptureError naming `name`."""
    from ..ops import scatter_kernels as sk

    # outside the capture: the histogram library loads and reads the
    # card's SM count on its first call
    sk.prepare(device)
    with torch.cuda.device(device):
        static = [None if x is None else torch.empty(
            x.shape, dtype=x.dtype, device=device) for x in inputs]
        before = dict(sk.LAUNCHES)
        torch.cuda.synchronize(device)
        # the capture's own entry empties the allocator's cache; doing it
        # first makes the reserved-memory delta the graph's growth alone
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool):
                outs = list(fn(static))
        except Exception as e:
            _end_failed_capture(device, pool)
            sk.LAUNCHES.update(before)
            raise CaptureError(
                f"capturing fused stage {name} failed: "
                f"{type(e).__name__}: {e}") from e
        capture_ms = (time.perf_counter() - t0) * 1e3
        grown = max(torch.cuda.memory_reserved(device) - r0, 0)
    calls = {k: sk.LAUNCHES[k] - before.get(k, 0) for k in sk.LAUNCHES}
    sk.LAUNCHES.update(before)
    for o in outs:
        if o is not None and not isinstance(o, torch.Tensor):
            raise CaptureError(f"fused stage {name} returned a "
                               f"{type(o).__name__}, not a tensor")
    return CapturedProgram(name, graph, static, outs,
                           {k: n for k, n in calls.items() if n},
                           grown, capture_ms)
