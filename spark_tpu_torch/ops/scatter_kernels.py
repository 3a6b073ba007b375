"""Scatter-accumulate kernels: the counterparts of the two Pallas kernels in
`spark_tpu/ops/pallas_kernels.py`, written by hand in CUDA C++ for Hopper
(`spark_tpu_torch/csrc/scatter_kernels.cu`).

  * `partition_histogram`: exact live-row count per bucket. The exchanges'
    per-partition counts (ops/partition.py) and the dense aggregate's
    `present` and count buffers (ops/grouping.py, physical/operators.py)
    all go through it.
  * `dense_group_sum_f32`: float32 grouped sum over dense int keys. The
    engine does not call it (its sums are int64/float64); it is ported so
    every TPU kernel has a counterpart, and is held against its plain
    version.

Each wrapper takes its plain PyTorch version (`*_plain`, `index_add_` at the
clipped keys) only for tensors on the CPU. Given CUDA tensors it launches
the kernel or raises; it never drops to the plain version. `LAUNCHES`
counts the wrapper calls that launched the kernel, one per call. Each such
call issues two CUDA kernels of the source: the scatter kernel and either
the merge of its block partials or, ahead of it, the kernel that zeroes
the output (see the source's note).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build

SOURCE = "scatter_kernels"

# wrapper calls that launched the kernel (incremented only where it launches)
LAUNCHES: dict[str, int] = {"partition_histogram": 0,
                            "dense_group_sum_f32": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _padded_last(n: int) -> int:
    """The TPU kernel's last (padded) bucket: keys clip to [0, this]."""
    return _round_up(max(n, 1), 128) - 1


# --- plain versions ---------------------------------------------------------

def partition_histogram_plain(pids: torch.Tensor, mask: torch.Tensor,
                              num_partitions: int) -> torch.Tensor:
    hi = _padded_last(num_partitions)
    k = pids.to(torch.int64).clamp(0, hi)
    out = torch.zeros(hi + 1, dtype=torch.int32, device=pids.device)
    out.index_add_(0, k, mask.to(torch.int32))
    return out[:num_partitions]


def dense_group_sum_f32_plain(keys: torch.Tensor, values: torch.Tensor,
                              mask: torch.Tensor,
                              num_groups: int) -> torch.Tensor:
    hi = _padded_last(num_groups)
    k = keys.to(torch.int64).clamp(0, hi)
    v = torch.where(mask, values.to(torch.float32),
                    torch.zeros((), dtype=torch.float32, device=keys.device))
    out = torch.zeros(hi + 1, dtype=torch.float32, device=keys.device)
    out.index_add_(0, k, v)
    return out[:num_groups]


# --- CUDA launch ---------------------------------------------------------------

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = cuda_build.load(SOURCE)
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.spark_scatter_scratch_rows.argtypes = [i32, i64, i32]
        lib.spark_scatter_scratch_rows.restype = ctypes.c_int
        lib.spark_scatter_count_i32.argtypes = [p, p, i64, i32, i32, p, p,
                                                i64, p]
        lib.spark_scatter_count_i32.restype = ctypes.c_int
        lib.spark_scatter_sum_f32.argtypes = [p, p, p, i64, i32, i32, p, p,
                                              i64, p]
        lib.spark_scatter_sum_f32.restype = ctypes.c_int
        _bound = lib
    return _bound


def _check_inputs(keys: torch.Tensor, mask: torch.Tensor,
                  values: torch.Tensor | None = None) -> str:
    dev = keys.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"scatter kernels run on cpu or cuda, not {dev}")
    others = [mask] + ([values] if values is not None else [])
    for t in others:
        if t.device != keys.device:
            raise ValueError("scatter kernel inputs must share one device")
        if t.shape != keys.shape:
            raise ValueError("scatter kernel inputs must share one shape")
    if keys.dim() != 1:
        raise ValueError("scatter kernels take 1-D inputs")
    if dev == "cuda" and keys.shape[0] >= 1 << 31:
        raise ValueError("the CUDA scatter kernels take at most 2^31 - 1 rows")
    return dev


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


@functools.lru_cache(maxsize=256)
def _scratch_rows(weighted: bool, n: int, n_out: int, device: int) -> int:
    """Blocks of a launch with these sizes on `device` (the current device),
    one scratch row each; 0 for the global path, which writes none. The
    grid depends only on these, so it is asked of the C side once."""
    return _lib().spark_scatter_scratch_rows(int(weighted), n, n_out)


def _scratch(weighted: bool, n: int, n_out: int, out: torch.Tensor):
    """(buffer, rows): a fresh [rows, n_out] buffer for the blocks' partial
    histograms, or (None, 0) where the launch writes none."""
    rows = _scratch_rows(weighted, n, n_out, out.device.index)
    if rows == 0:
        return None, 0
    return torch.empty(rows * n_out, dtype=out.dtype, device=out.device), rows


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device as a raw pointer, without the
    Stream object torch.cuda.current_stream() builds on every call."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _histogram_call(keys, mask, n_out, out, scratch, rows) -> int:
    """One launch of the histogram kernel on the current stream (with its
    zeroing or merge kernel), one block per scratch row; returns the CUDA
    error code. Takes int32 keys and a bool mask, contiguous, on the
    current device, and does no check."""
    return _lib().spark_scatter_count_i32(
        keys.data_ptr(), mask.data_ptr(), keys.shape[0], n_out,
        _padded_last(n_out), out.data_ptr(),
        0 if scratch is None else scratch.data_ptr(), rows, _stream(keys))


def _group_sum_call(keys, values, mask, n_out, out, scratch, rows) -> int:
    return _lib().spark_scatter_sum_f32(
        keys.data_ptr(), values.data_ptr(), mask.data_ptr(), keys.shape[0],
        n_out, _padded_last(n_out), out.data_ptr(),
        0 if scratch is None else scratch.data_ptr(), rows, _stream(keys))


def _on_device(device: torch.device, fn):
    """fn() with `device` current; enters no context when it already is."""
    if device.index == torch.cuda.current_device():
        return fn()
    with torch.cuda.device(device):
        return fn()


def partition_histogram(pids: torch.Tensor, mask: torch.Tensor,
                        num_partitions: int) -> torch.Tensor:
    """Exact per-bucket live-row counts: int32 pids[cap] + bool mask[cap]
    -> int32[num_partitions]. Pids clip to [0, round_up(P,128)-1]; buckets
    at or past P are dropped."""
    if _check_inputs(pids, mask) == "cpu":
        return partition_histogram_plain(pids, mask, num_partitions)
    keys, m = _as(pids, torch.int32), _as(mask, torch.bool)
    n = keys.shape[0]
    out = torch.empty(num_partitions, dtype=torch.int32, device=keys.device)
    if n == 0 or num_partitions == 0:
        return out.zero_()

    def launch():
        scratch, rows = _scratch(False, n, num_partitions, out)
        return _histogram_call(keys, m, num_partitions, out, scratch, rows)

    _raise_on(_on_device(keys.device, launch), "partition_histogram")
    LAUNCHES["partition_histogram"] += 1
    return out


def dense_group_sum_f32(keys: torch.Tensor, values: torch.Tensor,
                        mask: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Grouped float32 sum over dense int keys in [0, num_groups); masked
    rows add nothing. Up to 16 groups the sums add in a fixed order and
    repeat bit for bit; above that shared-memory or global atomics add in a
    varying order, so sums agree with the plain version to float32
    rounding, not bit for bit."""
    if _check_inputs(keys, mask, values) == "cpu":
        return dense_group_sum_f32_plain(keys, values, mask, num_groups)
    k, m = _as(keys, torch.int32), _as(mask, torch.bool)
    v = _as(values, torch.float32)
    n = k.shape[0]
    out = torch.empty(num_groups, dtype=torch.float32, device=k.device)
    if n == 0 or num_groups == 0:
        return out.zero_()

    def launch():
        scratch, rows = _scratch(True, n, num_groups, out)
        return _group_sum_call(k, v, m, num_groups, out, scratch, rows)

    _raise_on(_on_device(k.device, launch), "dense_group_sum_f32")
    LAUNCHES["dense_group_sum_f32"] += 1
    return out
