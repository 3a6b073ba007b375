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
  * `segment_bits`: the bitwise AND, OR or XOR of int64 values per
    segment (`spark_tpu_torch/csrc/segment_bits.cu`), the hand-written
    kernel of the reference's XLA-lowered `bitplane_reduce`
    (`spark_tpu/ops/grouping.py:159`), behind bit_and, bit_or and bit_xor.
  * `run_layout`: the group layout of a presorted key
    (`spark_tpu_torch/csrc/run_layout.cu`), the hand-written kernel of the
    reference's XLA-lowered `group_rows_presorted`
    (`spark_tpu/ops/grouping.py:63`), behind the sorted-run aggregate.

Each wrapper takes its plain PyTorch version (`*_plain`, `index_add_` at the
clipped keys) only for tensors on the CPU. Given CUDA tensors it launches
the kernel or raises; it never drops to the plain version. `LAUNCHES`
counts the wrapper calls that launched the kernel, one per call. Each
histogram or float32-sum call issues two CUDA kernels of its source: the
scatter kernel and either the merge of its block partials or, ahead of it,
the kernel that zeroes the output (see the source's note); a run-layout
call issues three (tile summaries, the carry across tiles, the writes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build

SOURCE = "scatter_kernels"
BITS_SOURCE = "segment_bits"
BLOOM_SOURCE = "bloom_filter"   # its wrappers live in ops/bloom.py
RUN_SOURCE = "run_layout"
SOURCES = (SOURCE, BITS_SOURCE, BLOOM_SOURCE, RUN_SOURCE)

# wrapper calls that launched the kernel (incremented only where it
# launches); bloom_build and bloom_probe count ops/bloom.py's
LAUNCHES: dict[str, int] = {"partition_histogram": 0,
                            "dense_group_sum_f32": 0,
                            "segment_bits": 0,
                            "bloom_build": 0,
                            "bloom_probe": 0,
                            "run_layout": 0}
BIT_KINDS = ("and", "or", "xor")


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


def segment_bits_plain(values: torch.Tensor, weights: torch.Tensor,
                       seg_ids: torch.Tensor, num_segments: int,
                       kind: str) -> torch.Tensor:
    """The reference's bit-plane reduce: each value (as int64, so negatives
    keep their two's-complement bits) splits into 64 planes summed by
    segment in one [n, 64] int32 matrix; OR is plane sum > 0, AND plane sum
    == the segment's count (0 in an empty segment), XOR its parity. Ids
    outside [0, num_segments) add nothing."""
    dev = values.device
    v = values.to(torch.int64)
    shifts = torch.arange(64, dtype=torch.int64, device=dev)
    bits = ((v[:, None] >> shifts[None, :]) & 1).to(torch.int32)
    bits = torch.where(weights[:, None], bits,
                       torch.zeros((), dtype=torch.int32, device=dev))
    seg = seg_ids.to(torch.int64)
    seg = torch.where((seg >= 0) & (seg < num_segments), seg,
                      torch.full_like(seg, num_segments))
    sums = torch.zeros(num_segments + 1, 64, dtype=torch.int32, device=dev)
    sums.index_add_(0, seg, bits)
    cnt = torch.zeros(num_segments + 1, dtype=torch.int32, device=dev)
    cnt.index_add_(0, seg, weights.to(torch.int32))
    sums, cnt = sums[:num_segments], cnt[:num_segments, None]
    if kind == "and":
        plane = (sums == cnt) & (cnt > 0)
    elif kind == "xor":
        plane = (sums & 1) == 1
    else:
        plane = sums > 0
    return (plane.to(torch.int64) << shifts[None, :]).sum(dim=1)


def run_layout_plain(key: torch.Tensor, row_mask: torch.Tensor):
    """The reference's group_rows_presorted layout: a run is a maximal
    stretch of equal keys over all rows (masked and padding rows
    included); a row opens a group iff it is live and no live row precedes
    it in its run. Returns (start bool[n], seg_ids int64[n] = max(starts
    so far - 1, 0), num_groups int64 0-dim)."""
    n, dev = row_mask.shape[0], row_mask.device
    pos = torch.arange(n, device=dev)
    changed = torch.ones(n, dtype=torch.bool, device=dev)
    changed[1:] = key[1:] != key[:-1]
    run_id = torch.cumsum(changed.to(torch.int64), 0) - 1
    first_live = torch.full((n,), n, dtype=torch.int64, device=dev)
    first_live.scatter_reduce_(0, run_id, torch.where(row_mask, pos, n),
                               "amin")
    start = row_mask & (pos == first_live[run_id])
    seg = (torch.cumsum(start.to(torch.int64), 0) - 1).clamp_min(0)
    return start, seg, start.sum()


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


_bits_bound = None


def _bits_lib():
    global _bits_bound
    if _bits_bound is None:
        lib = cuda_build.load(BITS_SOURCE)
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.spark_segment_bits_prepare.argtypes = []
        lib.spark_segment_bits_prepare.restype = ctypes.c_int
        lib.spark_segment_bits_i64.argtypes = [p, p, p, i64, i32, i32, p, p,
                                               p]
        lib.spark_segment_bits_i64.restype = ctypes.c_int
        _bits_bound = lib
    return _bits_bound


_run_bound = None


def _run_lib():
    global _run_bound
    if _run_bound is None:
        lib = cuda_build.load(RUN_SOURCE)
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.spark_run_layout_scratch_bytes.argtypes = [i64]
        lib.spark_run_layout_scratch_bytes.restype = ctypes.c_int64
        for fn in (lib.spark_run_layout_i32, lib.spark_run_layout_i64):
            fn.argtypes = [p, p, i64, p, p, p, p, p]
            fn.restype = ctypes.c_int
        _run_bound = lib
    return _run_bound


def prepare(device: torch.device) -> None:
    """Load the libraries and read the card's SM count for `device`: what
    the first launch does, done ahead of a CUDA graph capture."""
    _on_device(device, lambda: _scratch_rows(False, 1 << 20, 64,
                                             device.index))
    _on_device(device, lambda: _bits_lib().spark_segment_bits_prepare())
    _run_lib()


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


def segment_bits(values: torch.Tensor, weights: torch.Tensor,
                 seg_ids: torch.Tensor, num_segments: int, kind: str,
                 count: torch.Tensor) -> torch.Tensor:
    """int64[num_segments]: the bitwise `kind` ("and", "or" or "xor") of
    the values (sign-extended to int64) of the weighted rows of each
    segment; 0 in a segment whose `count` (the caller's count of its
    weighted rows, e.g. `partition_histogram`'s) is 0. Masked rows' ids may
    lie anywhere; weighted rows' ids outside [0, num_segments) add
    nothing. On the card it launches the kernel: no host read and no
    allocation sized by data, so it runs inside a CUDA graph capture."""
    if kind not in BIT_KINDS:
        raise ValueError(f"bit reduce kind {kind!r}")
    if _check_inputs(seg_ids, weights, values) == "cpu":
        return segment_bits_plain(values, weights, seg_ids, num_segments,
                                  kind)
    if count.device != seg_ids.device or count.shape != (num_segments,):
        raise ValueError("segment_bits: count must be [num_segments] on the "
                         "inputs' device")
    v, g = _as(values, torch.int64), _as(seg_ids, torch.int32)
    m, c = _as(weights, torch.bool), _as(count, torch.int32)
    out = torch.empty(num_segments, dtype=torch.int64, device=v.device)
    if num_segments == 0:
        return out

    def launch():
        return _bits_lib().spark_segment_bits_i64(
            v.data_ptr(), g.data_ptr(), m.data_ptr(), v.shape[0],
            num_segments, BIT_KINDS.index(kind), c.data_ptr(),
            out.data_ptr(), _stream(v))

    _raise_on(_on_device(v.device, launch), "segment_bits")
    LAUNCHES["segment_bits"] += 1
    return out


_RUN_KEYS = (torch.int8, torch.int16, torch.int32, torch.int64)


def run_layout(key: torch.Tensor, row_mask: torch.Tensor):
    """The group layout of a single key column whose equal values are
    adjacent (`run_layout_plain`'s definition, which holds for any key
    order): (start bool[n], seg_ids int64[n], num_groups int64 0-dim). The
    key is a signed integer of at most 64 bits (compared as int32 or
    int64). On the card it launches the kernel: no host read and a scratch
    sized by n alone, so it runs inside a CUDA graph capture."""
    if _check_inputs(key, row_mask) == "cpu":
        return run_layout_plain(key, row_mask)
    if key.dtype not in _RUN_KEYS:
        raise ValueError(f"run_layout takes a signed integer key, not "
                         f"{key.dtype}")
    wide = key.dtype == torch.int64
    k = _as(key, torch.int64 if wide else torch.int32)
    m = _as(row_mask, torch.bool)
    n, dev = k.shape[0], k.device
    start = torch.empty(n, dtype=torch.bool, device=dev)
    seg = torch.empty(n, dtype=torch.int64, device=dev)
    groups = torch.empty(1, dtype=torch.int64, device=dev)
    lib = _run_lib()
    scratch = torch.empty(max(lib.spark_run_layout_scratch_bytes(n), 1),
                          dtype=torch.uint8, device=dev)
    fn = lib.spark_run_layout_i64 if wide else lib.spark_run_layout_i32

    def launch():
        return fn(k.data_ptr(), m.data_ptr(), n, start.data_ptr(),
                  seg.data_ptr(), groups.data_ptr(), scratch.data_ptr(),
                  _stream(k))

    _raise_on(_on_device(dev, launch), "run_layout")
    LAUNCHES["run_layout"] += 1
    return start, seg, groups.reshape(())
