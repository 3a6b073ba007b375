"""Window function kernels (counterpart of `spark_tpu/ops/window.py`).

One stable multi-key sort by (partition keys, order keys) makes partitions
and peer groups contiguous; every ranking and frame computation is then a
cumulative sum, a scan or a gather over that sorted layout, and the results
scatter back to the input row order. The reference sorts every operand at
once with `lax.sort(num_keys=k, is_stable=True)`; here the same order
comes from chained stable `torch.sort` passes, least significant operand
first (`ops/sorting.py`).

Default frames (Spark semantics):
  ranking functions: the whole partition by definition;
  aggregates with ORDER BY: RANGE UNBOUNDED PRECEDING..CURRENT ROW (peer
    rows share the value);
  aggregates without ORDER BY: the whole partition.

Every function returns values in SORTED order; `scatter_back` puts them
back in row order.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .grouping import _max_ident, _min_ident
from .sorting import SortKeySpec, _directional


class WindowLayout(NamedTuple):
    perm: torch.Tensor        # sorted row -> input row (int64)
    active: torch.Tensor      # bool per sorted row
    pos: torch.Tensor         # int64 position of each sorted row
    seg_start: torch.Tensor   # position of the row's partition start
    seg_id: torch.Tensor      # partition id per sorted row
    peer_id: torch.Tensor     # peer-group id per sorted row
    peer_first: torch.Tensor  # position of the first row of the peer group
    peer_last: torch.Tensor   # position of the last row of the peer group
    seg_size: torch.Tensor    # live rows in the row's partition


def _change_flag(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """True where any key differs from the row before (and at row 0)."""
    flag = torch.zeros(keys[0].shape[0], dtype=torch.bool,
                       device=keys[0].device)
    flag[0] = True
    for k in keys:
        flag[1:] |= k[1:] != k[:-1]
    return flag


def _first_position(change: torch.Tensor, ids: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """Each row's group start: the rows that start a group scatter their
    position to their group id, and every row gathers its group's (the
    reference's formula; the other rows write to a spare slot)."""
    cap = pos.shape[0]
    by_id = torch.zeros(cap + 1, dtype=pos.dtype, device=pos.device)
    by_id.scatter_(0, torch.where(change, ids, torch.full_like(ids, cap)),
                   pos)
    return by_id[ids]


def build_layout(part_keys: Sequence[torch.Tensor],
                 part_valids: Sequence[torch.Tensor | None],
                 order_keys: Sequence[torch.Tensor],
                 order_valids: Sequence[torch.Tensor | None],
                 order_specs: Sequence[SortKeySpec],
                 row_mask: torch.Tensor) -> WindowLayout:
    cap = row_mask.shape[0]
    dev = row_mask.device
    # most significant first: inactive flag, partition keys (null flag and
    # value), order keys (null flag and directional value)
    operands: list[torch.Tensor] = [(~row_mask).to(torch.int32)]
    for k, v in zip(part_keys, part_valids):
        if v is not None:
            operands.append((~v).to(torch.int32))
            operands.append(torch.where(v, k, torch.zeros_like(k)))
        else:
            operands.append(k)
    n_part_ops = len(operands)
    for k, v, s in zip(order_keys, order_valids, order_specs):
        if v is not None:
            nf = s.nulls_first_effective
            operands.append((v if nf else ~v).to(torch.int32))
            k = torch.where(v, k, torch.zeros_like(k))
        operands.append(_directional(k, s.ascending))
    perm = torch.arange(cap, device=dev)
    for op in reversed(operands):
        perm = perm[torch.sort(op[perm], stable=True)[1]]
    sorted_keys = [op[perm] for op in operands]
    active = row_mask[perm]
    pos = torch.arange(cap, device=dev)

    pchange = _change_flag(sorted_keys[:n_part_ops])
    ochange = pchange | _change_flag(sorted_keys)
    seg_id = torch.cumsum(pchange.to(torch.int64), 0) - 1
    peer_id = torch.cumsum(ochange.to(torch.int64), 0) - 1
    seg_start = _first_position(pchange, seg_id, pos)
    peer_first = _first_position(ochange, peer_id, pos)
    peer_last = torch.zeros_like(pos).scatter_reduce_(
        0, peer_id, pos, "amax", include_self=True)[peer_id]
    seg_size = torch.zeros_like(pos).index_add_(
        0, seg_id, active.to(torch.int64))[seg_id]
    return WindowLayout(perm, active, pos, seg_start, seg_id, peer_id,
                        peer_first, peer_last, seg_size)


# --- ranking functions ---------------------------------------------------

def w_row_number(lo: WindowLayout):
    return (lo.pos - lo.seg_start + 1).to(torch.int32)


def w_rank(lo: WindowLayout):
    return (lo.peer_first - lo.seg_start + 1).to(torch.int32)


def w_dense_rank(lo: WindowLayout):
    return (lo.peer_id - lo.peer_id[lo.seg_start] + 1).to(torch.int32)


def w_percent_rank(lo: WindowLayout):
    denom = torch.clamp(lo.seg_size - 1, min=1)
    return (w_rank(lo) - 1).to(torch.float64) / denom


def w_cume_dist(lo: WindowLayout):
    return (lo.peer_last - lo.seg_start + 1).to(torch.float64) / \
        torch.clamp(lo.seg_size, min=1)


def w_ntile(lo: WindowLayout, n: int):
    rn0 = lo.pos - lo.seg_start
    return (rn0 * n // torch.clamp(lo.seg_size, min=1) + 1).to(torch.int32)


# --- aggregates over frames ----------------------------------------------

def _sorted_vals(lo: WindowLayout, values, valid):
    v = values[lo.perm]
    w = lo.active if valid is None else lo.active & valid[lo.perm]
    return v, w


def _acc(v: torch.Tensor) -> torch.dtype:
    return torch.float64 if v.dtype.is_floating_point else torch.int64


def _ident(kind: str, dtype: torch.dtype):
    return _max_ident(dtype) if kind == "min" else _min_ident(dtype)


def _masked(v, w, kind):
    return torch.where(w, v, torch.full_like(v, _ident(kind, v.dtype)))


def w_agg_unbounded(lo: WindowLayout, values, valid, kind: str):
    """sum/count/min/max/avg over the whole partition, broadcast to rows."""
    cap = values.shape[0]
    v, w = _sorted_vals(lo, values, valid)
    c = torch.zeros(cap, dtype=torch.int64, device=v.device).index_add_(
        0, lo.seg_id, w.to(torch.int64))[lo.seg_id]
    if kind == "count":
        return c, None
    if kind in ("sum", "avg"):
        acc = _acc(v)
        vv = torch.where(w, v.to(acc), torch.zeros((), dtype=acc,
                                                   device=v.device))
        s = torch.zeros(cap, dtype=acc, device=v.device).index_add_(
            0, lo.seg_id, vv)[lo.seg_id]
        if kind == "sum":
            return s, c > 0
        return s.to(torch.float64) / torch.clamp(c, min=1), c > 0
    m = torch.full((cap,), _ident(kind, v.dtype), dtype=v.dtype,
                   device=v.device).scatter_reduce_(
        0, lo.seg_id, _masked(v, w, kind),
        "amin" if kind == "min" else "amax", include_self=True)
    return m[lo.seg_id], c > 0


def _prefix_sums(v, w):
    acc = _acc(v)
    vv = torch.where(w, v.to(acc), torch.zeros((), dtype=acc, device=v.device))
    return torch.cumsum(vv, 0), torch.cumsum(w.to(torch.int64), 0)


def _before(c: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """c[idx - 1], 0 where idx is 0: the prefix before a position."""
    prev = c[torch.clamp(idx - 1, 0, c.shape[0] - 1)]
    return torch.where(idx > 0, prev, torch.zeros_like(prev))


def _segmented_scan(x: torch.Tensor, seg_id: torch.Tensor, kind: str):
    """Inclusive running min/max restarting at each partition (segments are
    contiguous): log2(cap) doubling passes."""
    op = torch.minimum if kind == "min" else torch.maximum
    cap = x.shape[0]
    step = 1
    while step < cap:
        same = seg_id[step:] == seg_id[:-step]
        nxt = x.clone()
        nxt[step:] = torch.where(same, op(x[step:], x[:-step]), x[step:])
        x = nxt
        step <<= 1
    return x


def w_agg_running(lo: WindowLayout, values, valid, kind: str):
    """RANGE UNBOUNDED PRECEDING..CURRENT ROW (peers share the value): one
    cumulative sum over the whole tile, less the prefix before each
    partition (the reference's formula: it sets the rounding of doubles)."""
    v, w = _sorted_vals(lo, values, valid)
    csum, ccnt = _prefix_sums(v, w)
    run_sum = csum[lo.peer_last] - _before(csum, lo.seg_start)
    run_cnt = ccnt[lo.peer_last] - _before(ccnt, lo.seg_start)
    if kind == "count":
        return run_cnt, None
    if kind == "sum":
        return run_sum, run_cnt > 0
    if kind == "avg":
        return run_sum.to(torch.float64) / torch.clamp(run_cnt, min=1), \
            run_cnt > 0
    scanned = _segmented_scan(_masked(v, w, kind), lo.seg_id, kind)
    return scanned[lo.peer_last], run_cnt > 0


def _frame_reduce(v, w, lo_idx, hi_idx, kind: str, max_len=None):
    """sum/count/avg/min/max over per-row index ranges [lo_idx, hi_idx] of
    the sorted values (empty where hi < lo)."""
    cap = v.shape[0]
    empty = hi_idx < lo_idx
    csum, ccnt = _prefix_sums(v, w)

    def rng(c):
        hi_v = c[torch.clamp(hi_idx, 0, cap - 1)]
        out = hi_v - _before(c, lo_idx)
        return torch.where(empty, torch.zeros_like(out), out)

    cnt = rng(ccnt)
    if kind == "count":
        return cnt, None
    if kind == "sum":
        return rng(csum), cnt > 0
    if kind == "avg":
        return rng(csum).to(torch.float64) / torch.clamp(cnt, min=1), cnt > 0
    if kind in ("min", "max"):
        return _range_minmax(v, w, lo_idx, hi_idx, empty, kind,
                             max_len), cnt > 0
    raise ValueError(kind)


def w_agg_rows(lo: WindowLayout, values, valid, kind: str, lo_off, hi_off):
    """ROWS BETWEEN <lo_off> AND <hi_off>: offsets are row deltas from the
    current row, None is unbounded on that side."""
    v, w = _sorted_vals(lo, values, valid)
    seg_end = lo.seg_start + lo.seg_size - 1
    lo_idx = lo.seg_start if lo_off is None else \
        torch.maximum(lo.pos + lo_off, lo.seg_start)
    hi_idx = seg_end if hi_off is None else \
        torch.minimum(lo.pos + hi_off, seg_end)
    max_len = None if lo_off is None or hi_off is None \
        else hi_off - lo_off + 1
    return _frame_reduce(v, w, lo_idx, hi_idx, kind, max_len)


def w_agg_value_range(lo: WindowLayout, order_key, values, valid, kind: str,
                      lo_off, hi_off, kmin: int, band: int):
    """RANGE BETWEEN <lo_off> AND <hi_off> with VALUE offsets over one
    integral order key. Keys are banded per partition, enc = seg_id * band
    + (key - kmin), so one global `searchsorted` finds each row's value
    window inside its own partition (band exceeds the key span plus the
    largest offset)."""
    k = order_key[lo.perm].to(torch.int64)
    enc = lo.seg_id * band + (k - kmin)
    lo_q = enc + (lo_off if lo_off is not None else -(band - 1))
    hi_q = enc + (hi_off if hi_off is not None else (band - 1))
    lo_idx = torch.searchsorted(enc, lo_q, right=False)
    hi_idx = torch.searchsorted(enc, hi_q, right=True) - 1
    seg_end = lo.seg_start + lo.seg_size - 1
    lo_idx = torch.maximum(lo_idx, lo.seg_start)
    hi_idx = torch.minimum(hi_idx, seg_end)
    v, w = _sorted_vals(lo, values, valid)
    return _frame_reduce(v, w, lo_idx, hi_idx, kind)


def _range_minmax(v, w, lo_idx, hi_idx, empty, kind, max_len=None):
    """min/max over per-row index ranges [lo_idx, hi_idx] through a sparse
    table: level j holds the reduce of the windows of length 2^j, and each
    row reads two overlapping windows. With a bounded frame (`max_len`)
    only the levels its windows read are built: the values are the same."""
    cap = v.shape[0]
    ident = _ident(kind, v.dtype)
    op = torch.minimum if kind == "min" else torch.maximum
    levels = [torch.where(w, v, torch.full_like(v, ident))]
    limit = cap if max_len is None else min(cap, max_len)
    step = 1
    while step < limit and (step << 1) <= limit:
        prev = levels[-1]
        shifted = torch.cat([prev[step:], torch.full((step,), ident,
                                                     dtype=prev.dtype,
                                                     device=prev.device)])
        levels.append(op(prev, shifted))
        step <<= 1
    sp = torch.stack(levels)  # [L, cap]
    length = torch.clamp(hi_idx - lo_idx + 1, min=1)
    # floor(log2(length)), made exact in integers on both sides
    k = torch.floor(torch.log2(length.to(torch.float64))).to(torch.int64)
    k = torch.where((1 << k) > length, k - 1, k)
    k = torch.where((1 << (k + 1)) <= length, k + 1, k)
    k = torch.clamp(k, 0, len(levels) - 1)
    p1 = sp[k, torch.clamp(lo_idx, 0, cap - 1)]
    p2 = sp[k, torch.clamp(hi_idx - (1 << k) + 1, 0, cap - 1)]
    return torch.where(empty, torch.full_like(p1, ident), op(p1, p2))


# --- offsets and values --------------------------------------------------

def w_shift(lo: WindowLayout, values, valid, offset: int,
            default_data=None, default_valid=None):
    """lag (offset > 0) / lead (offset < 0) within the partition. A row
    whose source lies outside its partition is NULL, or takes
    `default_data` (in the layout's sorted order, as the result is; None
    for no default) where `default_valid` (same order; None: all valid)
    holds. A source inside the partition that is NULL stays NULL."""
    cap = values.shape[0]
    v = values[lo.perm]
    src = lo.pos - offset
    seg_end = lo.seg_start + lo.seg_size - 1
    in_seg = (src >= lo.seg_start) & (src <= seg_end)
    srcc = torch.clamp(src, 0, cap - 1)
    out = v[srcc]
    out_valid = in_seg
    if valid is not None:
        out_valid = out_valid & valid[lo.perm][srcc]
    if default_data is None:
        return out, out_valid
    out = torch.where(in_seg, out, default_data)
    if valid is None and default_valid is None:
        return out, None
    if default_valid is None:
        return out, out_valid | ~in_seg
    return out, out_valid | (~in_seg & default_valid)


def w_first_value(lo: WindowLayout, values, valid):
    """first_value: the frame's first row, the partition's first row."""
    v = values[lo.perm]
    out_valid = None if valid is None else valid[lo.perm][lo.seg_start]
    return v[lo.seg_start], out_valid


def w_last_value(lo: WindowLayout, values, valid, whole: bool = False):
    """last_value: the default frame ends at the current peer group's last
    row; whole=True (UNBOUNDED..UNBOUNDED) at the partition's last row."""
    v = values[lo.perm]
    end = (lo.seg_start + lo.seg_size - 1) if whole else lo.peer_last
    out_valid = None if valid is None else valid[lo.perm][end]
    return v[end], out_valid


def w_nth_value(lo: WindowLayout, values, valid, n: int,
                whole: bool = False):
    """nth_value(x, n): NULL until the frame reaches n rows."""
    cap = values.shape[0]
    v = values[lo.perm]
    idx = lo.seg_start + (n - 1)
    end = (lo.seg_start + lo.seg_size - 1) if whole else lo.peer_last
    idxc = torch.clamp(idx, 0, cap - 1)
    out_valid = idx <= end
    if valid is not None:
        out_valid = out_valid & valid[lo.perm][idxc]
    return v[idxc], out_valid


def scatter_back(lo: WindowLayout, sorted_vals, sorted_valid=None):
    """Sorted-order results -> input row order."""
    out = torch.empty_like(sorted_vals)
    out[lo.perm] = sorted_vals
    ov = None
    if sorted_valid is not None:
        ov = torch.empty_like(sorted_valid)
        ov[lo.perm] = sorted_valid
    return out, ov
