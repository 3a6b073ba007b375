#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (spark_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     no card -> fail;
  2. build every CUDA source of the port with nvcc (one process per source,
     all started together) and print the build time;
  3. hold each hand-written kernel against its plain PyTorch version on the
     card, at the main path's shapes, with its time, the plain version's
     time, the time of one PyTorch call computing the same function
     (torch.bincount with weights; a yardstick the port never calls) and
     the least time the card could take (the bytes this input needs moved:
     every mask byte, the key and value of each live row, every output,
     over 3.35 TB/s);
  4. the main path through the DataFrame API at the source's size: 2e7 rows,
     k uniform in [0, 2^20), v uniform in [0, 1000) (numpy seed 42),
     filter + project + repartition(8) + groupBy(k).agg(sum, count, min,
     max, avg) with 8 shuffle partitions and 2^22-row tiles; every group is
     checked against a numpy oracle, the plan must hold both exchanges and
     both aggregate modes, the dense path must be taken, and the histogram
     kernel's launch count must rise during the query; then a cold run, the
     median of 3 warm runs, and where one warm run's time goes (each
     operator's exclusive wall time; the device-busy share and heaviest
     kernels from torch.profiler);
  5. a JSON line with every kernel's numbers, then, last, the result line
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12      # HBM3 rate of an H100 SXM (data sheet)
ROWS = 20_000_000
KEYS = 1 << 20
TILE = 1 << 22
PARTITIONS = 8


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int) -> float:
    return nbytes / H100_BYTES_PER_S * 1e3


def check_kernels(torch, sk):
    """Phase 3: each kernel against its plain version on the card."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    rows = []

    def hist_case(label, n, buckets, live_frac, key_hi=None):
        keys = rng.integers(0, key_hi or buckets, n).astype(np.int32)
        mask = rng.random(n) < live_frac
        k = torch.from_numpy(keys).to(dev)
        m = torch.from_numpy(mask).to(dev)
        got = sk.partition_histogram(k, m, buckets)
        exp = sk.partition_histogram_plain(k, m, buckets)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - exp.to(torch.int64)).abs().max())
        # keys >= buckets clip into the padded tail and are dropped
        if err != 0 or int(got.sum()) != int((mask & (keys < buckets)).sum()):
            fail(f"partition_histogram {label}: max abs err {err}")
        w = m.to(torch.float32)
        row = {
            "kernel": "partition_histogram", "shape": label,
            "max_abs_err": err,
            "ms": cuda_ms(lambda: sk.partition_histogram(k, m, buckets)),
            "plain_ms": cuda_ms(
                lambda: sk.partition_histogram_plain(k, m, buckets)),
            "library_ms": cuda_ms(
                lambda: torch.bincount(k, weights=w, minlength=buckets)),
            # each mask byte, the key of each live row, each output
            "bound_ms": bound_ms(n + int(mask.sum()) * 4 + buckets * 4),
        }
        rows.append(row)
        return row

    def sum_case(label, n, groups):
        keys = rng.integers(0, groups, n).astype(np.int32)
        vals = rng.random(n).astype(np.float32)
        mask = rng.random(n) < 0.9
        k = torch.from_numpy(keys).to(dev)
        v = torch.from_numpy(vals).to(dev)
        m = torch.from_numpy(mask).to(dev)
        got = sk.dense_group_sum_f32(k, v, m, groups)
        exp = sk.dense_group_sum_f32_plain(k, v, m, groups)
        torch.cuda.synchronize()
        diff = (got - exp).abs()
        rel = float((diff / exp.abs().clamp_min(1.0)).max())
        if not rel <= 1e-4:
            fail(f"dense_group_sum_f32 {label}: relative error {rel}")
        wv = torch.where(m, v, torch.zeros_like(v))
        row = {
            "kernel": "dense_group_sum_f32", "shape": label,
            "max_abs_err": float(diff.max()), "rel_err": rel,
            "ms": cuda_ms(lambda: sk.dense_group_sum_f32(k, v, m, groups)),
            "plain_ms": cuda_ms(
                lambda: sk.dense_group_sum_f32_plain(k, v, m, groups)),
            "library_ms": cuda_ms(
                lambda: torch.bincount(k, weights=wv, minlength=groups)),
            # each mask byte, key and value of each live row, each output
            "bound_ms": bound_ms(n + int(mask.sum()) * 8 + groups * 4),
        }
        rows.append(row)
        return row

    n = 1 << 22
    hist_case("2^22 rows, P=8", n, 8, 0.97)
    hist_case("2^22 rows, P=200", n, 200, 0.97)
    main_hist = hist_case("2^22 rows, 2^21 buckets", n, 1 << 21, 0.58,
                          key_hi=1 << 20)
    # ragged edge, and keys past the last bucket (clip to the padded
    # bucket round_up(P,128)-1 >= P, which is dropped)
    hist_case("1,000,003 rows, P=200, keys up to 300", 1_000_003, 200, 0.5,
              key_hi=300)
    hist_case("2^22 rows, all masked", n, 200, 0.0)
    sum_case("2^22 rows, 300 groups", n, 300)
    main_sum = sum_case("2^22 rows, 2^20 groups", n, 1 << 20)
    for r in rows:
        print("kernel " + json.dumps(r), flush=True)
    return main_hist, main_sum


def main_path(torch, sk, card: str):
    """Phase 4: the 2e7-row query through the DataFrame API."""
    import numpy as np
    import pyarrow as pa

    from spark_tpu_torch import TorchSession
    import spark_tpu_torch.api.functions as F

    rng = np.random.default_rng(42)
    k = rng.integers(0, KEYS, ROWS, dtype=np.int64)
    v = rng.integers(0, 1000, ROWS, dtype=np.int64)
    table = pa.table({"k": k, "v": v})

    spark = TorchSession("chip_smoke", {
        "spark.sql.shuffle.partitions": PARTITIONS,
        "spark.tpu.batch.capacity": TILE})
    df = (spark.createDataFrame(table)
          .filter(F.col("v") > 25)
          .withColumn("v2", F.col("v") * 3)
          .repartition(PARTITIONS)
          .groupBy("k")
          .agg(F.sum("v2"), F.count("*"), F.min("v"), F.max("v"),
               F.avg("v")))
    plan = df.query_execution.physical.tree_string()
    print(plan, flush=True)
    for part in (f"Exchange[UnknownPartitioning({PARTITIONS})]",
                 f"Exchange[HashPartitioning({PARTITIONS})]",
                 "HashAggregate[partial]", "HashAggregate[final]"):
        if part not in plan:
            fail(f"physical plan lacks {part}")

    torch.cuda.synchronize()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    out = df.toArrow()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    print(f"main path launches {json.dumps(launches)}; operator dispatches "
          f"{json.dumps(spark.launches.snapshot())}", flush=True)
    if launches["partition_histogram"] <= 0:
        fail("the main path never launched the histogram kernel")
    if spark.metrics.get("agg.dense_fast_path", 0) <= 0:
        fail("the main path did not take the dense aggregate")

    # numpy oracle
    live = v > 25
    kk, vv = k[live], v[live]
    cnt = np.bincount(kk, minlength=KEYS)
    s2 = np.bincount(kk, weights=vv * 3, minlength=KEYS).astype(np.int64)
    s1 = np.bincount(kk, weights=vv, minlength=KEYS).astype(np.int64)
    mn = np.full(KEYS, np.iinfo(np.int64).max)
    mx = np.full(KEYS, np.iinfo(np.int64).min)
    np.minimum.at(mn, kk, vv)
    np.maximum.at(mx, kk, vv)
    present = np.nonzero(cnt)[0]
    got = out.sort_by("k")
    gk = got.column("k").to_numpy()
    if not np.array_equal(gk, present):
        fail(f"group keys differ: {len(gk)} groups vs {len(present)}")
    checks = {
        "sum(v2)": s2[present], "count(1)": cnt[present],
        "min(v)": mn[present], "max(v)": mx[present],
    }
    for name, exp in checks.items():
        col = got.column(name).to_numpy()
        if not np.array_equal(col, exp):
            fail(f"{name} differs from the numpy oracle")
    avg = got.column("avg(v)").to_numpy()
    exp_avg = s1[present] / cnt[present]
    rel = float(np.max(np.abs(avg - exp_avg) / np.abs(exp_avg)))
    if not rel <= 1e-12:
        fail(f"avg(v) relative error {rel}")
    print(f"main path: {out.num_rows} groups equal to the numpy oracle "
          f"(integers exact, avg rel err {rel:.3e})", flush=True)

    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        df.toArrow()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    warm_s = statistics.median(warm)
    timing = {"rows": ROWS, "cold_s": cold_s, "warm_median_s": warm_s,
              "warm_s": warm, "cold_rows_per_s": ROWS / cold_s,
              "warm_rows_per_s": ROWS / warm_s, "card": card}
    print("main path timing " + json.dumps(timing), flush=True)
    print("main path breakdown " + json.dumps(breakdown(torch, df)),
          flush=True)
    spark.stop()
    return launches


def breakdown(torch, df) -> dict:
    """Where one warm run's time goes: each operator's exclusive wall time
    (synchronized before and after every execute, so device work lands on
    the operator that queued it), then a torch.profiler pass for the
    device-busy share and the heaviest device kernels."""
    nodes = list(df.query_execution.physical.iter_nodes())
    incl: dict[int, float] = {}
    for i, node in enumerate(nodes):
        orig = node.execute

        def timed(ctx, _orig=orig, _i=i):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(ctx)
            torch.cuda.synchronize()
            incl[_i] = time.perf_counter() - t0
            return out

        node.execute = timed
    t0 = time.perf_counter()
    df.toArrow()
    total = time.perf_counter() - t0
    for node in nodes:
        del node.execute
    index = {id(n): i for i, n in enumerate(nodes)}
    ops = []
    for i, node in enumerate(nodes):
        child = sum(incl.get(index[id(c)], 0.0) for c in node.children)
        ops.append({"op": node.simple_string()[:70],
                    "exclusive_s": incl.get(i, 0.0) - child})
    out = {"wall_s": total, "operators": ops,
           "collect_s": total - incl.get(0, 0.0)}

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        df.toArrow()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue    # host ops; their kernels are listed on their own
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            kernels.append((dev_us, ev.key, ev.count))
    busy_s = sum(k[0] for k in kernels) / 1e6
    kernels.sort(reverse=True)
    out["profiled_wall_s"] = wall
    out["device_busy_s"] = busy_s if kernels else "not measured"
    out["device_idle_share"] = 1 - busy_s / wall if kernels \
        else "not measured"
    out["top_device_ops"] = [{"op": k[1][:60], "device_ms": k[0] / 1e3,
                              "calls": k[2]} for k in kernels[:12]]
    return out


def run() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a GPU")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    sys.path.insert(0, ROOT)
    try:
        from spark_tpu_torch.ops import scatter_kernels as sk
        from spark_tpu_torch.utils import cuda_build
    except ImportError as e:
        fail(f"spark_tpu_torch is not beside this script: {e}")
    t0 = time.perf_counter()
    reports = cuda_build.build_all([sk.SOURCE])
    print(f"built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        print(f"--- nvcc {name} ---\n{text.strip()}", flush=True)

    main_hist, main_sum = check_kernels(torch, sk)
    launches = main_path(torch, sk, card)

    def entry(name, row, replaces):
        return {"name": name, "route": "cuda",
                "source": "spark_tpu_torch/csrc/scatter_kernels.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": "bytes", "library_ms": row["library_ms"],
                "shape": row["shape"]}

    print(json.dumps({"kernels": [
        entry("partition_histogram", main_hist,
              "spark_tpu/ops/pallas_kernels.py:67"),
        entry("dense_group_sum_f32", main_sum,
              "spark_tpu/ops/pallas_kernels.py:128"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    run()
