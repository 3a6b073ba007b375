#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (spark_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     no card -> fail;
  2. build every CUDA source of the port with nvcc (one process per source,
     all started together) and print the build time;
  3. hold each hand-written kernel against its plain PyTorch version on the
     card, at the main path's shapes, at each switch point of the kernels'
     paths and on misaligned views, with its device time alone (device_ms:
     CUDA events around 100 launches of the C entry point on buffers
     allocated once, queued behind a sleep kernel so host dispatch is
     hidden), the wrapper's time per call (call_ms), the plain
     version's device time, the device time of one PyTorch call computing
     the same function (torch.bincount with weights, from torch.profiler;
     a yardstick the port never calls) and the least time the card could
     take (the bytes this input needs moved: every mask byte, the key and
     value of each live row, every output, over 3.35 TB/s);
  4. the main path through the DataFrame API at the source's size: 2e7 rows,
     k uniform in [0, 2^20), v uniform in [0, 1000) (numpy seed 42),
     filter + project + repartition(8) + groupBy(k).agg(sum, count, min,
     max, avg) with 8 shuffle partitions and 2^22-row tiles; every group is
     checked against a numpy oracle, the plan must hold both exchanges and
     both aggregate modes, the dense path must be taken, and the histogram
     kernel must launch MAIN_HISTOGRAMS times during the query; then a cold
     run, the median of 3 warm runs, and where one warm run's time goes (each
     operator's exclusive wall time; the device-busy share, the heaviest
     kernels and the calls of each kernel of the port's CUDA source from
     torch.profiler);
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
REG_BUCKETS = 16                # the float32 sums' register-path limit
SMEM_BUCKETS = 57344            # the kernels' shared-memory bucket limit
# histogram wrapper calls of one main query: 5 round-robin input tiles + 8
# hash-exchange inputs + 8 partial tiles x 1 (every partial op weighs rows
# by the row mask) + 8 final tiles x 5 (the row mask and the validities of
# sum(v2), min, max and avg's sum); each call issues two CUDA kernels
MAIN_HISTOGRAMS = 5 + 8 + 8 * 1 + 8 * 5
# the kernels of spark_tpu_torch/csrc/scatter_kernels.cu, by name
SOURCE_KERNELS = ("scatter_shared", "sum_registers", "merge_partials",
                  "zero_output", "scatter_global")


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


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Per-call time of `fn` as its caller pays it: CUDA events around
    back-to-back calls. Where the device work is a few microseconds this
    times the host path of each call (checks, allocation, dispatch)."""
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


def device_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Device time per call of `fn`, with host dispatch hidden: a sleep
    kernel holds the stream while the host enqueues `iters` calls, then
    CUDA events around those calls time the device running them back to
    back. The device's queue of pending launches is about a thousand deep
    and a full queue stalls the host, so a call of many kernels gets fewer
    iterations. Fails if the host did not finish enqueuing before the sleep
    ended (then host gaps would be timed too) even after longer sleeps with
    fewer calls. `fn` must not synchronise with the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 50_000_000          # about 25 ms at the H100's clock
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()   # the sleep still held the stream
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 2
        iters = max(iters // 2, 10)
    fail("device_ms: the host could not enqueue ahead of the device")


def device_kernels(prof) -> list:
    """(self device us, name, calls) of every device op a torch.profiler
    run recorded, heaviest first."""
    kernels = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue    # host ops; their kernels are listed on their own
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            kernels.append((dev_us, ev.key, ev.count))
    return sorted(kernels, reverse=True)


def profiled_ms(fn, iters: int = 50):
    """Summed device time of the kernels and memsets of one call of `fn`,
    from torch.profiler: for calls that synchronise with the host
    (torch.bincount reads its input's max), where `device_ms` cannot hold
    the stream. Gaps between kernels are not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    if not kernels:
        return "not measured"
    return sum(k[0] for k in kernels) / 1e3 / iters


def bound_ms(nbytes: int) -> float:
    return nbytes / H100_BYTES_PER_S * 1e3


def bare_launch(torch, sk, keys, mask, n_out, values=None):
    """(launch, out): `launch()` runs the kernel's C entry point once on the
    current stream into `out` and a scratch buffer, both allocated here
    once, with no checks and no launch count; for timing the kernel alone.
    Takes contiguous int32 keys, a bool mask and float32 values (None: the
    histogram) on the current device."""
    weighted = values is not None
    out = torch.empty(n_out, device=keys.device,
                      dtype=torch.float32 if weighted else torch.int32)
    scratch, rows = sk._scratch(weighted, keys.shape[0], n_out, out)
    if weighted:
        def launch():
            return sk._group_sum_call(keys, values, mask, n_out, out,
                                      scratch, rows)
    else:
        def launch():
            return sk._histogram_call(keys, mask, n_out, out, scratch, rows)
    if launch() != 0:
        fail(f"the bare launch at n_out={n_out} failed")
    torch.cuda.synchronize()
    return launch, out


def check_kernels(torch, sk):
    """Phase 3: each kernel against its plain version on the card, then
    its times: device_ms (the bare kernel alone), call_ms (the wrapper per
    call), the plain version's device_ms, torch.bincount's profiled device
    time, and the bound."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    rows = []

    def on_card(arr, off):
        # a view `off` elements into its storage: off > 0 leaves the
        # data pointer off 16-byte alignment
        full = np.concatenate([np.zeros(off, arr.dtype), arr])
        return torch.from_numpy(full).to(dev)[off:]

    def timed(row, launch, wrapper, plain, library):
        row.update({
            "device_ms": device_ms(launch),
            "call_ms": call_ms(wrapper),
            "plain_ms": device_ms(plain, iters=30),
            "library_ms": profiled_ms(library),
        })
        row["ms"] = row["device_ms"]
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        rows.append(row)
        return row

    def hist_case(label, n, buckets, live_frac, key_hi=None, key_off=0,
                  mask_off=0):
        keys = rng.integers(0, key_hi or buckets, n).astype(np.int32)
        mask = rng.random(n) < live_frac
        k, m = on_card(keys, key_off), on_card(mask, mask_off)
        got = sk.partition_histogram(k, m, buckets)
        exp = sk.partition_histogram_plain(k, m, buckets)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - exp.to(torch.int64)).abs().max())
        # keys >= buckets clip into the padded tail and are dropped
        if err != 0 or int(got.sum()) != int((mask & (keys < buckets)).sum()):
            fail(f"partition_histogram {label}: max abs err {err}")
        launch, bare = bare_launch(torch, sk, k, m, buckets)
        if not torch.equal(bare, exp):
            fail(f"partition_histogram {label}: the bare launch differs")
        w = m.to(torch.float32)
        return timed(
            {"kernel": "partition_histogram", "shape": label,
             "max_abs_err": err,
             # each mask byte, the key of each live row, each output
             "bound_ms": bound_ms(n + int(mask.sum()) * 4 + buckets * 4)},
            launch, lambda: sk.partition_histogram(k, m, buckets),
            lambda: sk.partition_histogram_plain(k, m, buckets),
            lambda: torch.bincount(k, weights=w, minlength=buckets))

    def sum_case(label, n, groups, off=0):
        keys = rng.integers(0, groups, n).astype(np.int32)
        vals = rng.random(n).astype(np.float32)
        mask = rng.random(n) < 0.9
        k, v, m = on_card(keys, off), on_card(vals, off), on_card(mask, off)
        got = sk.dense_group_sum_f32(k, v, m, groups)
        exp = sk.dense_group_sum_f32_plain(k, v, m, groups)
        torch.cuda.synchronize()
        diff = (got - exp).abs()
        # float32 sums added in another order: relative 1e-4 covers the
        # rounding of up to half a million float32 adds per group
        rel = float((diff / exp.abs().clamp_min(1.0)).max())
        if not rel <= 1e-4:
            fail(f"dense_group_sum_f32 {label}: relative error {rel}")
        launch, bare = bare_launch(torch, sk, k, m, groups, v)
        if not float(((bare - exp).abs() / exp.abs().clamp_min(1.0))
                     .max()) <= 1e-4:
            fail(f"dense_group_sum_f32 {label}: the bare launch differs")
        wv = torch.where(m, v, torch.zeros_like(v))
        return timed(
            {"kernel": "dense_group_sum_f32", "shape": label,
             "max_abs_err": float(diff.max()), "rel_err": rel,
             # each mask byte, key and value of each live row, each output
             "bound_ms": bound_ms(n + int(mask.sum()) * 8 + groups * 4)},
            launch, lambda: sk.dense_group_sum_f32(k, v, m, groups),
            lambda: sk.dense_group_sum_f32_plain(k, v, m, groups),
            lambda: torch.bincount(k, weights=wv, minlength=groups))

    n = 1 << 22
    big = 1 << 21
    # the exchanges' P; the counts take shared memory up to SMEM_BUCKETS,
    # then global atomics (P = 16 to 33 match rows of PERF.md's table)
    hist_case("2^22 rows, P=8", n, 8, 0.97)
    hist_case("2^22 rows, P=16", n, 16, 0.97)
    hist_case("2^22 rows, P=17", n, 17, 0.97)
    hist_case("2^22 rows, P=32", n, 32, 0.97)
    hist_case("2^22 rows, P=33", n, 33, 0.97)
    hist_case("2^22 rows, P=200", n, 200, 0.97)
    hist_case(f"2^22 rows, P={SMEM_BUCKETS}", n, SMEM_BUCKETS, 0.97)
    hist_case(f"2^22 rows, P={SMEM_BUCKETS + 1}", n, SMEM_BUCKETS + 1, 0.97)
    # the dense aggregate's `present` at the share of live rows a partial
    # tile holds (2.4M rows in a 2^22 tile), then 0% and 100% live
    main_hist = hist_case("2^22 rows, 2^21 buckets, 58% live", n, big,
                          0.58, key_hi=1 << 20)
    hist_case("2^22 rows, 2^21 buckets, 0% live", n, big, 0.0,
              key_hi=1 << 20)
    hist_case("2^22 rows, 2^21 buckets, 100% live", n, big, 1.0,
              key_hi=1 << 20)
    # ragged edge, and keys past the last bucket (clip to the padded
    # bucket round_up(P,128)-1 >= P, which is dropped)
    hist_case("1,000,003 rows, P=200, keys up to 300", 1_000_003, 200, 0.5,
              key_hi=300)
    hist_case("2^22 rows, P=200, all masked", n, 200, 0.0)
    hist_case("2^22 rows, P=8, keys[1:] mask[3:]", n, 8, 0.97, key_off=1,
              mask_off=3)
    hist_case("2^22 rows, 2^21 buckets, keys[1:] mask[1:]", n, big, 0.58,
              key_hi=1 << 20, key_off=1, mask_off=1)
    # the float32 sums switch registers -> shared memory at REG_BUCKETS
    sum_case("2^22 rows, 8 groups", n, 8)
    sum_case(f"2^22 rows, {REG_BUCKETS} groups", n, REG_BUCKETS)
    sum_case(f"2^22 rows, {REG_BUCKETS + 1} groups", n, REG_BUCKETS + 1)
    sum_case("2^22 rows, 300 groups", n, 300)
    main_sum = sum_case("2^22 rows, 2^20 groups", n, 1 << 20)
    sum_case("2^22 rows, 300 groups, all inputs [1:]", n, 300, off=1)
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
    if launches["partition_histogram"] != MAIN_HISTOGRAMS:
        fail(f"the main path launched the histogram kernel "
             f"{launches['partition_histogram']} times, not "
             f"{MAIN_HISTOGRAMS}")
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
    kernels = device_kernels(prof)
    busy_s = sum(k[0] for k in kernels) / 1e6
    out["profiled_wall_s"] = wall
    out["device_busy_s"] = busy_s if kernels else "not measured"
    out["device_idle_share"] = 1 - busy_s / wall if kernels \
        else "not measured"
    out["top_device_ops"] = [{"op": k[1][:60], "device_ms": k[0] / 1e3,
                              "calls": k[2]} for k in kernels[:12]]
    source = {}
    for dev_us, key, calls in kernels:
        for name in SOURCE_KERNELS:
            if name in key:
                row = source.setdefault(name, {"calls": 0, "device_ms": 0.0})
                row["calls"] += calls
                row["device_ms"] += dev_us / 1e3
    out["source_kernels"] = source if kernels else "not measured"
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
                "device_ms": row["device_ms"], "call_ms": row["call_ms"],
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
