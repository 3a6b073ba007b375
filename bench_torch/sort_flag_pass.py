#!/usr/bin/env python3
"""Times the 0/1-flag pass of the port's `sort_permutation` on one GPU.

    python3 bench_torch/sort_flag_pass.py

A sort orders rows by the inactive-row flag (and, where a key has nulls, by
its null flag) after the key passes. Three ways give the same stable
permutation: a stable partition (two cumsums, a where and a scatter), a
stable torch.sort of the flag as int32, and one as uint8. Each is timed
with CUDA events (median of 5 rounds of 10 calls after 3 warm-up calls) at
the tiles of chip_smoke.py's legs: the sort leg's 2^27-row tile with 1e8
live rows and the topk leg's 2^25-row tile with 2e7 live rows. As in the
engine, the flag arrives in the order of the key pass before it: random
int64 keys for live rows, zeros for the padding, stably sorted. Prints the
card line, then one JSON line per tile; fails if the three permutations
differ.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

TILES = ((1 << 27, 100_000_000, "sort leg"), (1 << 25, 20_000_000, "topk leg"))


def partition(flag, perm):
    ones = flag.to(torch.int64)
    zeros = 1 - ones
    dest = torch.where(ones.bool(), zeros.sum() + torch.cumsum(ones, 0) - 1,
                       torch.cumsum(zeros, 0) - 1)
    out = torch.empty_like(perm)
    out[dest] = perm
    return out


def sort_as(dtype):
    def run(flag, perm):
        return perm[torch.sort(flag.to(dtype), stable=True)[1]]
    return run


WAYS = {"stable partition": partition,
        "torch.sort int32": sort_as(torch.int32),
        "torch.sort uint8": sort_as(torch.uint8)}


def ms(fn, *args) -> float:
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 10)
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for cap, live, label in TILES:
        keys = torch.zeros(cap, dtype=torch.int64, device="cuda")
        keys[:live] = torch.randint(-(1 << 62), 1 << 62, (live,),
                                    generator=gen, device="cuda")
        row_mask = torch.arange(cap, device="cuda") < live
        perm = torch.sort(keys, stable=True)[1]
        flag = (~row_mask)[perm]
        outs = {name: way(flag, perm) for name, way in WAYS.items()}
        first = next(iter(outs.values()))
        if not all(torch.equal(first, o) for o in outs.values()):
            sys.exit(f"{label}: the permutations differ")
        print(json.dumps({"tile": label, "rows": cap, "live_rows": live,
                          "ms": {name: ms(way, flag, perm)
                                 for name, way in WAYS.items()}}), flush=True)
        del keys, row_mask, perm, flag, outs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
