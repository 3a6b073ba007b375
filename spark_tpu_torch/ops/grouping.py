"""Grouped aggregation primitives (counterpart of `spark_tpu/ops/grouping.py`).

The sorted-segment path orders rows so equal keys are adjacent (the JAX
package's multi-operand stable `lax.sort` becomes chained stable
`torch.sort` passes, least significant operand first), then reduces each
segment with `index_add_` / `scatter_reduce_`. The dense-range path
scatters by precomputed segment ids; its counts go through the
hand-written histogram kernel. Output capacity equals input capacity with a
row mask for live groups; empty segments hold the same identities the JAX
package's segment reductions give them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..errors import NotPortedError
from .scatter_kernels import partition_histogram


class GroupLayout(NamedTuple):
    """Result of grouping rows by key columns."""

    perm: torch.Tensor        # int64[cap] permutation sorting rows (inactive last)
    seg_ids: torch.Tensor     # int64[cap] segment id per SORTED row (0-based)
    start_flag: torch.Tensor  # bool[cap] first-row-of-group flag per sorted row
    active: torch.Tensor      # bool[cap] row_mask per sorted row
    num_groups: torch.Tensor  # int64 scalar — number of live groups


def _stable_multisort(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation that sorts rows by `operands` lexicographically (first
    operand most significant), ties kept in row order."""
    cap = operands[0].shape[0]
    perm = torch.arange(cap, device=operands[0].device)
    for op in reversed(operands):
        _, idx = torch.sort(op[perm], stable=True)
        perm = perm[idx]
    return perm


def group_rows(key_cols: Sequence[torch.Tensor],
               key_valids: Sequence[torch.Tensor | None],
               row_mask: torch.Tensor) -> GroupLayout:
    """Sort rows so equal keys (SQL semantics: null == null, inactive rows
    last) are adjacent; derive segment structure."""
    cap = row_mask.shape[0]
    operands = [(~row_mask).to(torch.int32)]
    for c, v in zip(key_cols, key_valids):
        if v is not None:
            operands.append((~v).to(torch.int32))  # nulls group together
            operands.append(torch.where(v, c, torch.zeros_like(c)))
        else:
            operands.append(c)
    perm = _stable_multisort(operands)
    active = row_mask[perm]

    changed = torch.zeros(cap, dtype=torch.bool, device=row_mask.device)
    changed[:1] = True
    for op in operands:
        k = op[perm]
        changed[1:] |= k[1:] != k[:-1]
    start_flag = changed & active
    seg_ids = (torch.cumsum(start_flag.to(torch.int64), 0) - 1).clamp_min(0)
    num_groups = start_flag.sum()
    return GroupLayout(perm, seg_ids, start_flag, active, num_groups)


def scatter_group_keys(layout: GroupLayout, key_col: torch.Tensor,
                       key_valid: torch.Tensor | None):
    """Each group's key value in output slot seg_id. Returns (data[cap],
    validity[cap] | None) in group-output order."""
    cap = layout.perm.shape[0]
    starts = layout.start_flag
    idx = layout.seg_ids[starts]
    out = torch.zeros(cap, dtype=key_col.dtype, device=key_col.device)
    out[idx] = key_col[layout.perm][starts]
    out_valid = None
    if key_valid is not None:
        out_valid = torch.zeros(cap, dtype=torch.bool, device=key_col.device)
        out_valid[idx] = key_valid[layout.perm][starts]
    return out, out_valid


def group_output_mask(layout: GroupLayout) -> torch.Tensor:
    cap = layout.perm.shape[0]
    return torch.arange(cap, device=layout.perm.device) < layout.num_groups


# --- segment reduction primitives ---------------------------------------------

def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point


def _max_ident(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


def _min_ident(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


def _segment_sum(values: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg, values)


def _segment_extreme(values: torch.Tensor, seg: torch.Tensor,
                     num_segments: int, kind: str) -> torch.Tensor:
    """segment min/max; empty segments hold the identity, as in JAX."""
    dt = values.dtype
    as_int = dt == torch.bool   # scatter_reduce has no bool amin/amax
    v = values.to(torch.int32) if as_int else values
    ident = _max_ident(dt) if kind == "amin" else _min_ident(dt)
    out = torch.full((num_segments,), int(ident) if as_int else ident,
                     dtype=v.dtype, device=v.device)
    out.scatter_reduce_(0, seg, v, kind, include_self=True)
    return out.to(torch.bool) if as_int else out


def _weights(layout: GroupLayout, valid: torch.Tensor | None):
    w = layout.active
    if valid is not None:
        w = w & valid[layout.perm]
    return w


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if _is_float(t) else torch.int64


def seg_sum(layout: GroupLayout, values: torch.Tensor, valid=None):
    cap = values.shape[0]
    v = values[layout.perm]
    w = _weights(layout, valid)
    acc = _acc_dtype(v)
    vv = torch.where(w, v.to(acc), torch.zeros((), dtype=acc, device=v.device))
    total = _segment_sum(vv, layout.seg_ids, cap)
    cnt = _segment_sum(w.to(torch.int64), layout.seg_ids, cap)
    return total, cnt


def seg_count(layout: GroupLayout, valid=None):
    cap = layout.perm.shape[0]
    w = _weights(layout, valid)
    return _segment_sum(w.to(torch.int64), layout.seg_ids, cap)


def seg_min(layout: GroupLayout, values: torch.Tensor, valid=None):
    cap = values.shape[0]
    v = values[layout.perm]
    w = _weights(layout, valid)
    vv = torch.where(w, v, torch.full_like(v, _max_ident(v.dtype)))
    m = _segment_extreme(vv, layout.seg_ids, cap, "amin")
    cnt = _segment_sum(w.to(torch.int32), layout.seg_ids, cap)
    return m, cnt > 0


def seg_max(layout: GroupLayout, values: torch.Tensor, valid=None):
    cap = values.shape[0]
    v = values[layout.perm]
    w = _weights(layout, valid)
    vv = torch.where(w, v, torch.full_like(v, _min_ident(v.dtype)))
    m = _segment_extreme(vv, layout.seg_ids, cap, "amax")
    cnt = _segment_sum(w.to(torch.int32), layout.seg_ids, cap)
    return m, cnt > 0


def seg_first(layout: GroupLayout, values: torch.Tensor, valid=None):
    """First value per group in sorted order."""
    cap = values.shape[0]
    v = values[layout.perm]
    w = _weights(layout, valid)
    pos = torch.arange(cap, device=v.device)
    p = torch.where(w, pos, torch.full_like(pos, cap))
    first_pos = _segment_extreme(p, layout.seg_ids, cap, "amin")
    has = first_pos < cap
    return v[first_pos.clamp_max(cap - 1)], has


# --- primitive-op dispatch tables ---------------------------------------------

def apply_group_ops(layout: GroupLayout, ops: Sequence[str], val_datas,
                    val_valids):
    """Sorted-segment reduce of each (op, values, validity) triple over a
    GroupLayout. Returns [(buffer, validity | None)] per op."""
    bufs = []
    for op, vd, vv in zip(ops, val_datas, val_valids):
        if op in ("count", "countstar"):
            bufs.append((seg_count(layout, vv if op == "count" else None),
                         None))
        elif op == "sum":
            total, cnt = seg_sum(layout, vd, vv)
            bufs.append((total, cnt > 0))
        elif op == "min":
            bufs.append(seg_min(layout, vd, vv))
        elif op == "max":
            bufs.append(seg_max(layout, vd, vv))
        elif op == "first":
            bufs.append(seg_first(layout, vd, vv))
        else:
            raise NotPortedError(f"aggregate buffer op {op!r}")
    return bufs


def apply_dense_ops(seg, out_cap: int, cap: int, ops: Sequence[str],
                    val_datas, val_valids, live_mask, present=None):
    """Direct scatter reduce keyed by precomputed segment ids (dense-range
    fast path; `live_mask` is the row mask after filters). Returns
    [(buffer, validity | None)] per op.

    Counts go through the histogram kernel once per distinct weight
    tensor: `present` (the caller's count of `live_mask` rows, if it has
    one) serves every op whose weights are the row mask itself, and ops
    that share a validity tensor share its count."""
    seg32 = seg.to(torch.int32).contiguous()   # histogram kernel keys
    seg = seg.to(torch.int64)                  # index_add_/scatter index
    counts: dict = {}   # id(validity) (None: the row mask) -> int64 counts
    if present is not None:
        counts[None] = present.to(torch.int64)

    def count(vv, w):
        key = None if vv is None else id(vv)
        if key not in counts:
            counts[key] = partition_histogram(seg32, w, out_cap) \
                .to(torch.int64)
        return counts[key]

    bufs = []
    for op, vd, vv in zip(ops, val_datas, val_valids):
        w = live_mask if vv is None else (live_mask & vv)
        if op == "countstar":
            bufs.append((count(None, live_mask), None))
        elif op == "count":
            bufs.append((count(vv, w), None))
        elif op == "sum":
            x = vd.to(_acc_dtype(vd))
            total = _segment_sum(
                torch.where(w, x, torch.zeros((), dtype=x.dtype,
                                              device=x.device)),
                seg, out_cap)
            bufs.append((total, count(vv, w) > 0))
        elif op == "min":
            m = _segment_extreme(
                torch.where(w, vd, torch.full_like(vd, _max_ident(vd.dtype))),
                seg, out_cap, "amin")
            bufs.append((m, count(vv, w) > 0))
        elif op == "max":
            m = _segment_extreme(
                torch.where(w, vd, torch.full_like(vd, _min_ident(vd.dtype))),
                seg, out_cap, "amax")
            bufs.append((m, count(vv, w) > 0))
        elif op == "first":
            pos = torch.arange(cap, device=seg.device)
            p = torch.where(w, pos, torch.full_like(pos, cap))
            fp = _segment_extreme(p, seg, out_cap, "amin")
            bufs.append((vd[fp.clamp_max(cap - 1)], fp < cap))
        else:
            raise NotPortedError(f"aggregate buffer op {op!r}")
    return bufs


def apply_global_ops(ops: Sequence[str], val_datas, val_valids, row_mask):
    """Whole-tile (ungrouped) reduce. Returns [(scalar, has | None)]."""
    outs = []
    for op, vd, vv in zip(ops, val_datas, val_valids):
        w = row_mask if vv is None else (row_mask & vv)
        if op in ("count", "countstar"):
            ww = row_mask if op == "countstar" else w
            outs.append((ww.to(torch.int64).sum(), None))
        elif op == "sum":
            x = vd.to(_acc_dtype(vd))
            s = torch.where(w, x, torch.zeros((), dtype=x.dtype,
                                              device=x.device)).sum()
            outs.append((s, w.any()))
        elif op == "min":
            outs.append((torch.where(w, vd, torch.full_like(
                vd, _max_ident(vd.dtype))).min(), w.any()))
        elif op == "max":
            outs.append((torch.where(w, vd, torch.full_like(
                vd, _min_ident(vd.dtype))).max(), w.any()))
        elif op == "first":
            pos = torch.argmax(w.to(torch.int8))  # first True (0 if none)
            outs.append((vd[pos], w.any()))
        else:
            raise NotPortedError(f"aggregate buffer op {op!r}")
    return outs
