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

The nested-loop join's pairs come from the same expansion: `expand_pairs`
cuts the probe-major pair sequence of per-row build ranges into tiles of a
fixed capacity, the ranges being every live build row (`all_pairs`, as
the reference's `cross_join` pairs them) or a probe key's hash range in
the sorted build (`match_ranges`).
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


def dedup_build(build: BuildSide, key_cols: Sequence[torch.Tensor],
                key_valids: Sequence[torch.Tensor | None]) -> BuildSide:
    """The build index without the rows whose keys equal the row before
    them in hash order (pushed to +inf): a semi or anti join asks only
    whether a match exists, so one build row per key gives the same
    answer, and a probe row's expansion no longer grows with the key's
    duplicates. Rows of one key sit together unless a hash collision
    interleaves them; then some duplicates stay, which changes nothing."""
    perm = build.perm
    same = torch.zeros_like(build.sorted_hash, dtype=torch.bool)
    same[1:] = build.sorted_hash[1:] == build.sorted_hash[:-1]
    prev = torch.cat([perm[:1], perm[:-1]])
    for k, v in zip(key_cols, key_valids):
        same = same & (k[perm] == k[prev])
        if v is not None:
            same = same & (v[perm] == v[prev])
    sh, order = torch.sort(torch.where(same, I64_MAX, build.sorted_hash),
                           stable=True)
    return BuildSide(sh, perm[order])


class JoinResult(NamedTuple):
    probe_idx: torch.Tensor  # int64[OC] source probe-row index per output row
    build_idx: torch.Tensor  # int64[OC] build-row index (clipped if unmatched)
    matched: torch.Tensor    # bool[OC] true => real build match
    out_mask: torch.Tensor   # bool[OC] live output rows
    needed: torch.Tensor     # int64 scalar: rows the join wanted to emit


def match_ranges(build: BuildSide,
                 probe_key_cols: Sequence[torch.Tensor],
                 probe_key_valids: Sequence[torch.Tensor | None],
                 probe_mask: torch.Tensor):
    """(lo, counts): each probe row's range of build slots with its key
    hash, `build.perm[lo : lo + counts]` (empty for a dead row or a NULL
    key). The range holds every build row with an equal key, and may hold
    hash collisions."""
    ph = hash_columns(probe_key_cols, list(probe_key_valids))
    usable = _usable(probe_mask, probe_key_valids)
    # a sentinel that matches nothing (the build pads with I64_MAX)
    ph = torch.where(usable, ph, torch.full_like(ph, I64_MAX - 1))
    lo = torch.searchsorted(build.sorted_hash, ph)
    hi = torch.searchsorted(build.sorted_hash, ph, right=True)
    return lo, torch.where(usable, hi - lo, torch.zeros_like(lo))


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

    lo, counts = match_ranges(build, probe_key_cols, probe_key_valids,
                              probe_mask)

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


def expand_pairs(offsets: torch.Tensor, counts: torch.Tensor,
                 starts: torch.Tensor, order: torch.Tensor, first: int,
                 out_capacity: int):
    """Pairs `first .. first + out_capacity` of the probe-major sequence in
    which probe row i pairs with build rows `order[starts[i] : starts[i] +
    counts[i]]` (`offsets` is the inclusive cumsum of `counts`). Returns
    (probe_idx, build_idx, live): live marks the slots before the
    sequence's end."""
    pcap = counts.shape[0]
    bcap = order.shape[0]
    j = torch.arange(first, first + out_capacity, dtype=torch.int64,
                     device=counts.device)
    src = torch.searchsorted(offsets, j, right=True).clamp_max(pcap - 1)
    within = j - (offsets[src] - counts[src])
    bidx = order[(starts[src] + within).clamp(0, bcap - 1)]
    return src, bidx, j < offsets[pcap - 1]


def all_pairs(probe_mask: torch.Tensor, build_mask: torch.Tensor):
    """(counts, starts, order) pairing every live probe row with every live
    build row: the build side compacted, live rows first in row order."""
    nb = build_mask.to(torch.int64).sum()
    order = torch.sort((~build_mask).to(torch.int8), stable=True)[1]
    counts = torch.where(probe_mask, nb, torch.zeros_like(nb))
    return counts, torch.zeros_like(counts), order


def cross_join(probe_mask: torch.Tensor, build_mask: torch.Tensor,
               out_capacity: int) -> JoinResult:
    """Cartesian product (Spark's CartesianProductExec) in one tile. The
    build side is compacted first so the output is probe-major."""
    counts, starts, order = all_pairs(probe_mask, build_mask)
    offsets = torch.cumsum(counts, 0)
    src, bidx, live = expand_pairs(offsets, counts, starts, order, 0,
                                   out_capacity)
    out_mask = live & probe_mask[src]
    return JoinResult(src, bidx, torch.ones_like(out_mask), out_mask,
                      offsets[-1])
