#!/usr/bin/env python3
"""chip_smoke.py's parquet leg alone on one GPU, its checks printed
instead of failing.

    python3 bench_torch/parquet_leg.py [--store-sales-rows N]

Builds the port's CUDA kernels, writes the leg's Parquet files with
`chip_smoke.tpcds_parquet` (store_sales at N lines, default
`chip_smoke.PARQUET_ROWS`' SF10 cut; 287997024 is SF100's count; the
dimensions stay SF100's), then runs `chip_smoke.parquet_leg`: q3, q7 and
q19 through session.sql over the files, the DPP, partition and row-group
checks, spark.range and SELECT without FROM, each with its plan, oracle,
histogram calls, times and breakdown printed as chip_smoke.py prints them.
A check that does not hold prints a `SOFT-FAIL` line and the leg goes on,
so one run shows every check at a new size. The files are deleted at the
end. Prints the generator's and the leg's seconds last.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store-sales-rows", type=int,
                    default=cs.PARQUET_ROWS["store_sales"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this runs only on a GPU")
    card = cs.card_line()
    print(card, flush=True)
    from spark_tpu_torch.ops import scatter_kernels as sk
    from spark_tpu_torch.utils import cuda_build

    cs.fail = lambda msg: print("SOFT-FAIL " + msg, flush=True)
    cs.PARQUET_ROWS["store_sales"] = args.store_sales_rows
    t_start = time.perf_counter()
    cuda_build.build_all([sk.SOURCE])
    t0 = time.perf_counter()
    oracle = cs.tpcds_parquet(cs.PARQUET_DIR)
    gen_s = time.perf_counter() - t0
    with open(cs.PARQUET_LOG, "w") as log:
        log.write(f"generated {oracle['rows']['store_sales']:,} store_sales "
                  f"lines in {gen_s:.1f} s\n")
    done = subprocess.Popen([sys.executable, "-c", ""])
    done.wait()
    t0 = time.perf_counter()
    out = cs.parquet_leg(torch, sk, card, done, t_start)
    print({k: v.get("partition_histogram") for k, v in out.items()})
    print(f"parquet_leg: generator {gen_s:.1f} s, leg "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)


if __name__ == "__main__":
    main()
