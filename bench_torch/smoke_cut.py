#!/usr/bin/env python3
"""What chip_smoke.py's time cut saves: the range_sort and window legs with
their operator-tier reruns untimed (the script's setting) and timed.

    python3 bench_torch/smoke_cut.py [--rounds untimed,timed,timed,untimed]

Builds the port's CUDA kernels, makes the main table (`chip_smoke.
main_table`) and runs `chip_smoke.range_sort_leg` then
`chip_smoke.window_leg` once per round, with every operator-tier rerun
the legs ask for timed (3 warm runs and a profiled one, as before the
cut) or untimed (its counted cold run and checks only). Each leg prints
its lines as in chip_smoke.py; each round prints one JSON line with the
two legs' seconds beside the card's name and power limit, and the last
line gives each setting's median over its rounds.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", default="untimed,timed,timed,untimed")
    args = ap.parse_args()
    rounds = args.rounds.split(",")
    if set(rounds) - {"timed", "untimed"}:
        sys.exit(f"rounds must be timed or untimed, not {args.rounds}")
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs only on a GPU")
    from spark_tpu_torch.ops import scatter_kernels as sk
    from spark_tpu_torch.utils import cuda_build

    card = cs.card_line()
    print(card, flush=True)
    cuda_build.build_all(list(sk.SOURCES))
    k, v = cs.main_table()
    real_drive = cs.drive

    def drive_with(timed: bool):
        def drive(*a, **kw):
            if "operator_timed" in kw:
                kw["operator_timed"] = timed
            return real_drive(*a, **kw)
        return drive

    seconds = {"timed": [], "untimed": []}
    for i, setting in enumerate(rounds):
        cs.drive = drive_with(setting == "timed")
        try:
            t0 = time.perf_counter()
            cs.range_sort_leg(torch, sk, card, k, v)
            t1 = time.perf_counter()
            cs.window_leg(torch, sk, card, k, v)
            t2 = time.perf_counter()
        finally:
            cs.drive = real_drive
        row = {"round": i + 1, "operator_reruns": setting,
               "range_sort_s": t1 - t0, "window_s": t2 - t1,
               "both_s": t2 - t0, "card": card}
        seconds[setting].append(row["both_s"])
        print("smoke_cut " + json.dumps(row), flush=True)
    print(json.dumps({f"{s}_median_s": statistics.median(x)
                      for s, x in seconds.items() if x} | {"card": card}),
          flush=True)


if __name__ == "__main__":
    main()
