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
the kernel or raises; it never drops to the plain version. `LAUNCHES` counts
the kernel launches of each wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build

SOURCE = "scatter_kernels"

# kernel launches per wrapper (incremented only where a kernel launches)
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
        lib.spark_scatter_count_i32.argtypes = [p, p, i64, i32, i32, p, p]
        lib.spark_scatter_count_i32.restype = ctypes.c_int
        lib.spark_scatter_sum_f32.argtypes = [p, p, p, i64, i32, i32, p, p]
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
    return dev


def _prepare_cuda(keys, mask, values=None):
    keys = keys.to(torch.int32).contiguous()
    mask = mask.to(torch.bool).contiguous()
    if values is not None:
        values = values.to(torch.float32).contiguous()
    return keys, mask, values


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def partition_histogram(pids: torch.Tensor, mask: torch.Tensor,
                        num_partitions: int) -> torch.Tensor:
    """Exact per-bucket live-row counts: int32 pids[cap] + bool mask[cap]
    -> int32[num_partitions]. Pids clip to [0, round_up(P,128)-1]; buckets
    at or past P are dropped."""
    if _check_inputs(pids, mask) == "cpu":
        return partition_histogram_plain(pids, mask, num_partitions)
    keys, m, _ = _prepare_cuda(pids, mask)
    out = torch.zeros(num_partitions, dtype=torch.int32, device=keys.device)
    n = keys.shape[0]
    if n == 0:
        return out
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        code = _lib().spark_scatter_count_i32(
            keys.data_ptr(), m.data_ptr(), n, num_partitions,
            _padded_last(num_partitions), out.data_ptr(), stream)
    _raise_on(code, "partition_histogram")
    LAUNCHES["partition_histogram"] += 1
    return out


def dense_group_sum_f32(keys: torch.Tensor, values: torch.Tensor,
                        mask: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Grouped float32 sum over dense int keys in [0, num_groups); masked
    rows add nothing. Atomics add in a varying order, so sums agree with
    the plain version to float32 rounding, not bit for bit."""
    if _check_inputs(keys, mask, values) == "cpu":
        return dense_group_sum_f32_plain(keys, values, mask, num_groups)
    k, m, v = _prepare_cuda(keys, mask, values)
    out = torch.zeros(num_groups, dtype=torch.float32, device=k.device)
    n = k.shape[0]
    if n == 0:
        return out
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        code = _lib().spark_scatter_sum_f32(
            k.data_ptr(), v.data_ptr(), m.data_ptr(), n, num_groups,
            _padded_last(num_groups), out.data_ptr(), stream)
    _raise_on(code, "dense_group_sum_f32")
    LAUNCHES["dense_group_sum_f32"] += 1
    return out
