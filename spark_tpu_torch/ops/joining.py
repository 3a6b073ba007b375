"""Equi-join kernel (counterpart of `spark_tpu/ops/joining.py`): a sorted
build side, a searchsorted probe and a cumsum expansion.

The build side is sorted by a combined 64-bit key hash; each probe row finds
its match range with two `searchsorted` binary searches, and the
variable-fanout output is flattened into a STATIC-capacity batch with the
cumsum/searchsorted expansion. Hash false positives are removed by gathering
and comparing the actual key columns, so the hash only groups.

Output capacity overflow is reported in `needed`, which the host reads to
retry at the next capacity bucket. Every gather index is kept in range: on
the card an index out of range is a device assert, not a clamp.
`cross_join` is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .hashing import hash_columns

I64_MAX = torch.iinfo(torch.int64).max


class BuildSide(NamedTuple):
    """Build-side index: key-hash-sorted."""

    sorted_hash: torch.Tensor  # int64[Bcap], inactive rows pushed to +inf
    perm: torch.Tensor         # int64[Bcap] original row index per slot


def _usable(mask: torch.Tensor, valids) -> torch.Tensor:
    for v in valids:
        if v is not None:
            mask = mask & v
    return mask


def build_index(key_cols: Sequence[torch.Tensor],
                key_valids: Sequence[torch.Tensor | None],
                row_mask: torch.Tensor) -> BuildSide:
    h = hash_columns(key_cols, list(key_valids))
    # null join keys never match (SQL equi-join); drop them from the index
    usable = _usable(row_mask, key_valids)
    hh = torch.where(usable, h, torch.full_like(h, I64_MAX))
    sh, perm = torch.sort(hh, stable=True)
    return BuildSide(sh, perm)


class JoinResult(NamedTuple):
    probe_idx: torch.Tensor  # int64[OC] source probe-row index per output row
    build_idx: torch.Tensor  # int64[OC] build-row index (clipped if unmatched)
    matched: torch.Tensor    # bool[OC] true => real build match
    out_mask: torch.Tensor   # bool[OC] live output rows
    needed: torch.Tensor     # int64 scalar: rows the join wanted to emit


def probe_join(build: BuildSide,
               build_key_cols: Sequence[torch.Tensor],
               build_key_valids: Sequence[torch.Tensor | None],
               probe_key_cols: Sequence[torch.Tensor],
               probe_key_valids: Sequence[torch.Tensor | None],
               probe_mask: torch.Tensor,
               out_capacity: int,
               join_type: str = "inner") -> JoinResult:
    """join_type: inner | left_outer | left_semi | left_anti. 'left' is
    always the probe side; the planner flips sides for right joins."""
    if join_type not in ("inner", "left_outer", "left_semi", "left_anti"):
        raise ValueError(f"unsupported join type {join_type}")
    pcap = probe_mask.shape[0]
    bcap = build.perm.shape[0]
    dev = probe_mask.device

    ph = hash_columns(probe_key_cols, list(probe_key_valids))
    usable = _usable(probe_mask, probe_key_valids)
    # a sentinel that matches nothing (the build pads with I64_MAX)
    ph = torch.where(usable, ph, torch.full_like(ph, I64_MAX - 1))

    lo = torch.searchsorted(build.sorted_hash, ph)
    hi = torch.searchsorted(build.sorted_hash, ph, right=True)
    counts = torch.where(usable, hi - lo, torch.zeros_like(lo))

    # semi/anti/outer rows emit at least one slot, so the verified-match
    # count can decide them after the expansion
    if join_type == "inner":
        ecounts = counts
    else:
        ecounts = torch.maximum(counts, probe_mask.to(torch.int64))

    offsets = torch.cumsum(ecounts, 0)  # inclusive
    total = offsets[pcap - 1]

    j = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    src = torch.searchsorted(offsets, j, right=True).clamp_max(pcap - 1)
    within = j - (offsets[src] - ecounts[src])
    in_range = j < total

    has_build = within < counts[src]
    bpos = (lo[src] + within).clamp_max(bcap - 1)
    bidx = build.perm[bpos]

    # verify true key equality (null keys already excluded via sentinels)
    pair_ok = has_build
    for bc, bv, pc_, pv in zip(build_key_cols, build_key_valids,
                               probe_key_cols, probe_key_valids):
        eq = bc[bidx] == pc_[src]
        if bv is not None:
            eq = eq & bv[bidx]
        if pv is not None:
            eq = eq & pv[src]
        pair_ok = pair_ok & eq

    live_probe = probe_mask[src]
    if join_type == "inner":
        return JoinResult(src, bidx, pair_ok, in_range & live_probe & pair_ok,
                          total)

    # count of VERIFIED matches per probe row (scatter-add over output rows)
    vmatch = torch.zeros(pcap, dtype=torch.int64, device=dev).index_add_(
        0, src, (in_range & pair_ok).to(torch.int64))
    any_match = vmatch[src] > 0
    first_slot = within == 0
    if join_type == "left_semi":
        out_mask = in_range & live_probe & first_slot & any_match
    elif join_type == "left_anti":
        out_mask = in_range & live_probe & first_slot & ~any_match
    else:
        # matched rows pass; an unmatched probe row emits exactly one
        # null-extended row in its first slot
        out_mask = in_range & live_probe & (pair_ok | (~any_match
                                                       & first_slot))
    return JoinResult(src, bidx, pair_ok, out_mask, total)
