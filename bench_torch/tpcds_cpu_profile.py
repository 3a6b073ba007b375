#!/usr/bin/env python3
"""Where the SF10 TPC-DS queries spend the CPU's time in the port.

    python3 bench_torch/tpcds_cpu_profile.py [--time q1 q2 ...] q31 q23a ...

Builds chip_smoke.py's SF10 tables (`tpcds_data`, the same seeds) and runs
each named query on a TorchSession(device="cpu") with the cores but two, as
chip_smoke.py's `--tpcds-cpu` process does: one cold run (the ingest of the
tables it reads), then one warm run under torch.profiler (CPU activities).
Prints one JSON line per query: the cold wall seconds, the profiled warm
run's wall seconds, and the ten operators of largest self CPU
time (seconds, calls, and the largest input shape seen). The queries after
`--time` run once and are only timed, as the `--tpcds-cpu` process runs
each query. Needs no card.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str]) -> None:
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from spark_tpu_torch import TorchSession

    timed_only = set()
    if "--time" in argv:
        i = argv.index("--time")
        rest = argv[i + 1:]
        argv = argv[:i]
        timed_only = set(rest)
        argv += rest
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) - 2))
    t0 = time.perf_counter()
    tables, _ = cs.tpcds_data()
    print(json.dumps({"tables_s": time.perf_counter() - t0,
                      "threads": torch.get_num_threads()}), flush=True)
    # the operator tier: the SF10 check's CPU oracle runs there
    cpu = TorchSession("tpcds_cpu_profile", dict(
        cs.TPCDS_CONF, **{"spark.tpu.compile.tier": "operator"}),
        device="cpu")
    for name, table in tables.items():
        cpu.createDataFrame(table).createOrReplaceTempView(name)
    for q in argv:
        text = cs.tpcds_text(q)
        t1 = time.perf_counter()
        cpu.sql(text).toArrow()
        cold = time.perf_counter() - t1
        if q in timed_only:
            print(json.dumps({"query": q, "cold_s": cold}), flush=True)
            continue
        t1 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            cpu.sql(text).toArrow()
        wall = time.perf_counter() - t1
        ops = sorted(prof.key_averages(group_by_input_shape=True),
                     key=lambda e: e.self_cpu_time_total, reverse=True)
        top = []
        for e in ops:
            if len(top) == 10:
                break
            top.append({"op": e.key, "self_s": e.self_cpu_time_total / 1e6,
                        "calls": e.count,
                        "shapes": str(e.input_shapes)[:80]})
        print(json.dumps({"query": q, "cold_s": cold,
                          "profiled_warm_s": wall, "top_self_cpu": top}),
              flush=True)
    cpu.stop()


if __name__ == "__main__":
    main(sys.argv[1:])
