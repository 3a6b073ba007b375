#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (spark_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     no card -> fail;
  2. build every CUDA source of the port with nvcc (one process per source,
     all started together) and print the build time;
  3. hold each hand-written kernel against its plain PyTorch version on the
     card (the bit kernel, `check_bit_kernel`: bit_and/bit_or/bit_xor per
     segment at 2^22 rows and 8, 1,024 and 2^21 segments, all-masked,
     negative, int32, stray masked ids, misaligned views and inside a
     captured graph; no library call computes it; the bloom kernel,
     `check_bloom_kernel`: the runtime join filter's bitset build at
     131,072 and 2^21 rows and probe at 2^22 and 2^25 rows, 0/58/100%
     live, duplicate keys, misaligned views and inside a captured graph,
     exactly; no library call computes it; the run-layout kernel,
     `check_run_layout`: the sorted-run aggregate's group layout at 2^22
     and 2^25 rows of sorted runs, int32 and int64 keys, one run, every
     row masked, masked rows and whole masked runs, ragged ends, an
     unsorted key, misaligned views and inside a captured graph, exactly;
     no library call computes it), at the main path's
     shapes, at each switch point of the kernels' paths and on misaligned
     views, with its device time alone (device_ms:
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
  5. more paths through the DataFrame API and SQL, each the same way (its
     physical plan asserted, a cold run, the median of 3 warm runs, a numpy
     oracle, the exact number of histogram calls, the breakdown); after
     each path, the main one too, one more run keeps the inputs of every
     histogram call of a new shape, and phase 3 holds each against the
     plain version and times it there. The paths run at the session's
     default compile tier, `auto`, whose decision each prints: `whole`
     (physical/whole_query.py: the query as one CUDA graph per step, no
     histogram call) or `stage` (physical/fusion.py: a fused stage is a
     CUDA graph captured once and replayed per batch); each fused batch
     and each whole program's attempt must be one replay, and the
     histogram calls inside replays count. Every query runs through the
     stage scheduler with AQE on (spark_tpu_torch/exec/scheduler.py,
     physical/adaptive.py), as the reference's default does; each run
     prints its stage count and AQE counters (partitions coalesced, joins
     demoted, probe shuffles skipped, skew splits) and fails on a stage
     retry. Each prints its report: the
     decision, whole dispatches, capacity retries and degrades, fused
     stages, captures, replays, cache hits, batches the minRows gate sent
     to the unfused kernels, capture ms, the copies' device ms, graph
     memory, pool resets, peak memory. main, join, range_sort, topk and
     q78 (whole at `auto`) then run once more at the `stage` tier, where
     their exact histogram calls and dense-path checks are held, sort
     (staged) at forced `whole`, and these and window at the `operator`
     tier, in the same session (the oracle, equal to the first tier's
     result, warm median and idle share; window's and range_sort's
     untimed, cut for the script's time), and main's and q78's programs
     are held replay against the same body run eagerly on the card at
     both fused tiers (`replay_equals_eager`):
       join:       bench.py's bench_join, 2e7 store_sales rows joined to the
                   73,049-row date_dim and summed by year (broadcast, dense
                   direct-address build), 1 shuffle partition;
       sort:       bench.py's bench_sort, orderBy over 1e8 int64 keys in one
                   2^27-row tile; then the budget leg's sort on its
                   session: the same keys under a 512 MiB device budget,
                   through the external range-bucketed sort (16 buckets);
       range_sort: the main table, repartition(8).orderBy(k, desc(v))
                   through a range exchange;
       topk:       the main table, orderBy(desc(v), k).limit(100);
       q78:        TPC-DS q78's first CTE shape: 2e7 store_sales LEFT JOIN
                   2e6 store_returns on (ticket, item), rows with no return
                   counted and summed by store (shuffled, sorted probe);
                   then the budget leg's join on its session: the same
                   query under a budget that leaves a build partition a
                   quarter tile, through the grace join (4 fragments a
                   partition), to the same oracle;
       sorted_runs: order lines clustered by order id (2e7 lines, 1-20 an
                   order, numpy seed 29) in 8 in-memory partitions of one
                   2^22-row tile each, grouped by order id with count,
                   sum, min, max and bit_or over WHERE qty > 1: at the
                   operator tier every partial aggregate takes the
                   sorted-run path (the run-layout kernel), at stage the
                   fused aggregate, at `auto` its tier; each to a numpy
                   oracle, once more with spark.tpu.debug.validateBatches
                   set, the run-layout kernel held at the leg's inputs;
       window:     Spark's top-N-per-group idiom over the main table in 8
                   round-robin partitions: row_number, rank, dense_rank,
                   the running sum with peers, lag and a 3-row max over
                   Window.partitionBy("k").orderBy(desc("v")) (a hash
                   exchange on k, then WindowExec), row_number <= 3 kept,
                   every row held to a numpy oracle;
       tpcds:      bench.py's bench_tpcds widened to all 103 TPC-DS
                   query files of tests/tpcds/queries, verbatim:
                   first `tpcds_gate`, every query on the card over
                   tests/tpcds/datagen.py's tables at scale 0.1 at the
                   stage tier with spark.tpu.fusion.minRows 0 and at
                   forced `whole`, equal to its committed golden (LIMIT
                   dropped) and to the port on the CPU at the operator
                   tier; then each but TPCDS_SF10_CUT (q72) and
                   TPCDS_TIME_CUT (q64), at `auto`
                   (TPCDS_CONF; its decision held to TPCDS_TIERS), through
                   session.sql over temp views of the 24 tables they read
                   at SF10 row counts (28,800,991 store_sales and
                   133,110,000 inventory rows; the columns the queries
                   read, with tests/tpcds/datagen.py's value pools,
                   strings and decimal prices), its plan held to the
                   reference's operator sequence (a query that plans
                   NestedLoopJoinExec prints the pairs it formed beside
                   the pairs all-pairs enumeration would form, and fails
                   past the pair tile's cap), q3, q7 and q19
                   exactly to numpy oracles, the others to at least one
                   row (q9 to no histogram call: its aggregates have no
                   key) and then (but those of TPCDS_CPU_SKIP) to the
                   port's result on the CPU over the same tables, computed
                   by a second process of this script (`--tpcds-cpu`)
                   that starts after the build and runs beside every
                   phase on the host's cores but two; each query's peak
                   device memory is printed; past q3, q7 and q19 (3 warm
                   runs and a breakdown each) a query runs cold only,
                   with every check, to keep the script inside its time
                   limit on a slower host; a query whose CTEs
                   materialise or whose scalar subqueries run before it
                   is timed as sql() + collect, with the sql() call (the
                   CTE round trip) and the scalar subqueries on lines of
                   their own (its cold run makes the DataFrame the plan
                   checks read after it, so its sql() runs once, and
                   its scalar subqueries are counted against
                   TPCDS_SCALAR_SUBQUERIES); last q3, q7 and q19 once
                   more at each of the whole, stage and operator tiers on
                   the same session, each to its oracle; then the
                   runtime_filters leg: q3, q7 and q19 at forced `stage`
                   with both runtime join filters on, each equal to its
                   result above, the bloom kernel launched and held to
                   its plain version at every input it was given; then the
                   expressions leg on that session and its views: the
                   scalar functions of EXPRESSION_QUERIES at `auto`,
                   stage and forced `whole`, each to numpy/Python oracle
                   rows computed after the last timed run of the query
                   files; then the types leg: TYPES_QUERIES (timestamps
                   made on the card from d_date and t_time grouped by
                   hour and filtered by a TIMESTAMP window; a word count
                   of explode(split(ca_county)), two or three words an
                   address, and array functions of the split; a struct key and a map lookup over a
                   view of item built by named_struct and map, and that
                   view collected) at `auto` and at the stage tier, each
                   to numpy oracle rows; then the aggregates leg:
                   AGG_QUERIES (bit_and/bit_or/bit_xor over all
                   store_sales lines by store, by two keys, ungrouped
                   and by month over a join, percentiles over a year,
                   string min/max and first, collects over item,
                   moments, DISTINCT sums, mode, and lambdas over county
                   words, a collect_set and item_nested's maps) at
                   `auto` and at stage, the bits statements at forced
                   `whole` too, each to its oracle (the oracles of these
                   three legs come from the `--tpcds-cpu` process, which
                   computes them first), the bit kernel held to its
                   plain version at every input of the bits statements,
                   inside whole programs too;
                   then the maintenance leg;
       parquet:    (at `auto`, DPP at the stage tier; 1 warm run each)
                   q3, q7 and q19 read through
                   spark.read.parquet from
                   files a third process of this script writes
                   (`--tpcds-parquet`, started with it; SF100's
                   dimensions, store_sales cut to SF10's lines), each plan
                   and each scan's columns, splits and rows read held,
                   each result to a numpy oracle the writer accumulated
                   chunk by chunk, the histogram kernel held at the
                   inputs of one more run at the operator tier;
                   bench_join's shape over SF10 store_sales
                   partitioned by date (dynamic partition pruning must
                   prune every split outside November, and DPP off gives
                   the same answer), a partition and a row-group
                   predicate, spark.range over 2^28 rows and at a negative
                   step, and SELECT without FROM; the files are deleted;
  6. a JSON line with every kernel's numbers (the bit kernel's launches
     are the aggregates leg's bits statements', the bloom kernel's the
     runtime_filters leg's, the run-layout kernel's the sorted_runs leg's
     at the operator tier), the stage retries over every session (0),
     then, last, the result line
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12      # HBM3 rate of an H100 SXM (data sheet)
ROWS = 20_000_000
KEYS = 1 << 20
TILE = 1 << 22
PARTITIONS = 8
REG_BUCKETS = 16                # the float32 sums' register-path limit
SMEM_BUCKETS = 57344            # the kernels' shared-memory bucket limit
# histogram wrapper calls of one main query at the stage and operator
# tiers: 5 round-robin input tiles + 8 hash-exchange inputs + 8 partial
# tiles x 1 (every partial op weighs rows by the row mask) + 4 final passes
# x 5 (the row mask and the validities of sum(v2), min, max and avg's
# sum); each call issues two CUDA kernels. The 4: AQE merges the final
# aggregate's 8 partitions in adjacent pairs (MAIN_COALESCED). Each holds
# 943,630-949,690 partial rows (each round-robin partition's ~2.44M rows
# keep ~0.945M of the 2^20 keys, an eighth of them hashed to each reducer;
# counted with numpy from the seeded table) of 7 columns at 8 B
# (`_row_width`, 56 B), under the 64 MiB advisory size of 1,198,372 rows;
# two reach it
MAIN_COALESCED = 4
MAIN_HISTOGRAMS = 5 + 8 + 8 * 1 + (8 - MAIN_COALESCED) * 5
# the kernels of spark_tpu_torch/csrc/scatter_kernels.cu, by name
SOURCE_KERNELS = ("scatter_shared", "sum_registers", "merge_partials",
                  "zero_output", "scatter_global")

# the legs after the main path
DATE0 = 2450816                 # first d_date_sk of TPC-DS date_dim
DATES = 73049                   # date_dim rows
SORT_ROWS = 100_000_000
SORT_TILE = 1 << 27
Q78_RETURNS = 2_000_000
Q78_ITEMS = 102_000             # SF10's item and store counts
Q78_STORES = 102
TOPK = 100
WINDOW_TOP = 3                  # the window leg's rows kept per key

# the tpcds leg: TPC-DS SF10 row counts (the specification's), the conf of
# the other legs, and each query's physical operator sequence at these
# sizes, the JAX package's (tests/test_torch_tpcds_slice.py plans both
# engines at these row counts and holds them to this table)
TPCDS_ROWS = {"store_sales": 28_800_991, "store_returns": 2_875_432,
              "catalog_sales": 14_401_261, "catalog_returns": 1_439_749,
              "web_sales": 7_197_566, "web_returns": 719_217,
              "item": 102_000, "customer": 500_000,
              "customer_address": 250_000,
              "customer_demographics": 1_920_800,
              "household_demographics": 7_200, "date_dim": 73_049,
              "time_dim": 86_400, "store": 102, "promotion": 500,
              "ship_mode": 20, "warehouse": 10, "web_site": 42,
              "web_page": 200, "call_center": 24, "reason": 45,
              "income_band": 20, "catalog_page": 12_000,
              "inventory": 133_110_000}
# the SF10 leg over the 102 files runs at the default tier, `auto`: each
# query at the tier the reference's cost model picks for it (TPCDS_TIERS);
# q3, q7 and q19 also run at each of the three tiers on the leg's session
# (tpcds_stage)
TPCDS_CONF = {"spark.sql.shuffle.partitions": PARTITIONS,
              "spark.tpu.batch.capacity": TILE}
_TOPK_OPS = ("LimitExec", "SortExec", "ShuffleExchangeExec", "LimitExec",
             "SortExec", "ComputeExec", "HashAggregateExec")
_SCAN = ("ComputeExec", "LocalTableScanExec")
_BCAST = ("BroadcastExchangeExec",) + _SCAN
_JOIN = ("HashJoinExec", "ComputeExec")
# an aggregate planned as one pass over one partition whose input a shuffled
# join below splits by other keys merges its partials (the port's planner;
# the reference's one pass is right there only where AQE coalesces the
# join's partitions back into one)
_MERGE = ("HashAggregateExec", "ShuffleExchangeExec", "HashAggregateExec")


def _plan(ops: str) -> tuple:
    """An operator sequence written without each name's "Exec"."""
    return tuple(f"{o}Exec" for o in ops.split())


# each query's physical operator sequence at SF10 and the default tier, the
# JAX package's (tests/test_torch_tpcds_store.py's Sf10Planner plans both
# engines at these row counts and holds them to this table): a plan the
# cost model runs whole starts with WholeQueryExec, then its inner plan
TPCDS_PLAN_OPS = {
    "q3": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q7": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q13": _plan(
        "WholeQuery Compute HashAggregate HashJoin HashJoin HashJoin "
        "HashJoin HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q15": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin HashJoin Compute HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q19": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashJoin HashJoin Compute HashJoin HashJoin "
        "Compute HashJoin LocalTableScan BroadcastExchange Compute "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q25": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin HashJoin HashJoin Compute HashJoin "
        "Compute HashJoin Compute HashJoin HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q26": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q29": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin HashJoin HashJoin Compute HashJoin "
        "Compute HashJoin Compute HashJoin HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q31": _plan(
        "Sort Compute HashJoin HashJoin HashJoin HashJoin HashJoin "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q34": _plan(
        "WholeQuery Sort Compute HashJoin HashAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q42": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q43": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q46": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashJoin Compute HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute FusedAggregate "
        "HashJoin HashJoin HashJoin Compute HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q48": _plan(
        "WholeQuery Compute HashAggregate HashJoin HashJoin HashJoin "
        "HashJoin LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q50": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashJoin HashJoin Compute HashJoin HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan"),
    "q52": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q55": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q59": _plan(
        "Limit Sort ShuffleExchange Limit Sort Compute HashJoin HashJoin "
        "Compute HashJoin LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute HashJoin Compute HashJoin "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q62": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashJoin HashJoin Compute HashJoin HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q64": _plan(
        "Sort Compute HashJoin LocalTableScan BroadcastExchange Compute "
        "LocalTableScan"),
    "q65": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashJoin Compute HashJoin HashJoin LocalTableScan "
        "BroadcastExchange Compute FusedAggregate HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute FusedAggregate "
        "HashAggregate HashJoin LocalTableScan BroadcastExchange Compute "
        "LocalTableScan"),
    "q68": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashJoin Compute HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute FusedAggregate "
        "HashJoin HashJoin HashJoin Compute HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q73": _plan(
        "WholeQuery Sort Compute HashJoin HashAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q78": _plan(
        "WholeQuery Limit Limit Compute Sort Compute HashJoin HashJoin "
        "HashAggregate HashJoin HashJoin Compute LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute HashAggregate HashJoin HashJoin "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin HashJoin Compute LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q79": _plan(
        "WholeQuery Limit Limit Compute Sort Compute HashJoin "
        "FusedAggregate HashJoin HashJoin Compute HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q85": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin HashJoin HashJoin HashJoin HashJoin "
        "Compute HashJoin HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q93": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashJoin HashJoin Compute LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q96": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin HashJoin Compute HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q99": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashJoin HashJoin Compute HashJoin HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q97": _plan(
        "Limit FusedLimit FusedAggregate HashJoin HashAggregate HashJoin "
        "LocalTableScan BroadcastExchange Compute LocalTableScan Compute "
        "HashAggregate HashJoin LocalTableScan BroadcastExchange Compute "
        "LocalTableScan"),
    "q2": _plan(
        "Sort Compute HashJoin HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute HashJoin "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q4": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashJoin HashJoin Compute HashJoin LocalTableScan "
        "BroadcastExchange Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan Compute LocalTableScan "
        "Compute LocalTableScan Compute LocalTableScan"),
    "q11": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashJoin HashJoin Compute HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q66": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate ShuffleExchange FusedAggregate Union Compute "
        "FusedAggregate HashJoin HashJoin Compute HashJoin HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute FusedAggregate "
        "HashJoin HashJoin Compute HashJoin HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q71": _plan(
        "WholeQuery Sort ShuffleExchange Compute HashAggregate "
        "ShuffleExchange HashAggregate HashJoin Compute HashJoin "
        "ShuffleExchange LocalTableScan ShuffleExchange Union Compute "
        "HashJoin LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute HashJoin LocalTableScan BroadcastExchange Compute "
        "LocalTableScan Compute HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q74": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashJoin HashJoin Compute HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q75": _plan(
        "Limit Sort ShuffleExchange Limit Sort Compute HashJoin "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q76": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q1": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashJoin Compute HashJoin Compute HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute HashAggregate "
        "LocalTableScan"),
    "q9": _plan(
        "Compute LocalTableScan"),
    "q10": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashJoin Compute HashJoin HashJoin Compute "
        "HashJoin Compute HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute LocalTableScan Compute HashJoin "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute HashAggregate HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute HashAggregate HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q23a": _plan(
        "WholeQuery Limit FusedLimit HashAggregate ShuffleExchange "
        "HashAggregate Union Compute HashJoin Compute HashJoin Compute "
        "HashJoin LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute HashJoin Compute HashJoin Compute "
        "HashJoin LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q23b": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Union Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute FusedAggregate HashJoin Compute HashJoin Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q24a": _plan(
        "Compute FusedAggregate LocalTableScan"),
    "q24b": _plan(
        "Compute FusedAggregate LocalTableScan"),
    "q30": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashJoin Compute HashJoin Compute HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute HashAggregate "
        "LocalTableScan"),
    "q33": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute "
        "HashAggregate HashJoin Compute HashJoin HashJoin Compute "
        "HashJoin LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin Compute HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin Compute HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q35": _plan(
        "WholeQuery Limit Limit Compute Sort Compute FusedAggregate "
        "HashJoin Compute HashJoin HashJoin Compute HashJoin Compute "
        "HashJoin LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute LocalTableScan Compute HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute HashAggregate HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute HashAggregate "
        "HashJoin LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q45": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashJoin Compute HashJoin HashJoin Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute FusedAggregate LocalTableScan"),
    "q56": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute "
        "HashAggregate HashJoin Compute HashJoin HashJoin Compute "
        "HashJoin LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin Compute HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin Compute HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q58": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashJoin HashJoin FusedAggregate HashJoin Compute HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute FusedAggregate "
        "HashJoin Compute HashJoin Compute HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute FusedAggregate HashJoin Compute HashJoin Compute "
        "HashJoin LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q60": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute "
        "HashAggregate HashJoin Compute HashJoin HashJoin Compute "
        "HashJoin LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin Compute HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin Compute HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q69": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin HashJoin HashJoin Compute HashJoin "
        "Compute HashJoin LocalTableScan BroadcastExchange Compute "
        "LocalTableScan Compute LocalTableScan Compute HashJoin "
        "LocalTableScan BroadcastExchange Compute LocalTableScan Compute "
        "HashJoin LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute HashJoin LocalTableScan BroadcastExchange Compute "
        "LocalTableScan"),
    "q81": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashJoin Compute HashJoin Compute HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute HashAggregate "
        "LocalTableScan"),
    "q83": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashJoin Compute HashJoin FusedAggregate HashJoin Compute "
        "HashJoin Compute HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute HashJoin Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute FusedAggregate HashJoin Compute HashJoin Compute "
        "HashJoin LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute HashJoin Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute FusedAggregate "
        "HashJoin Compute HashJoin Compute HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute HashJoin "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q12": _plan(
        "Limit Limit Compute Sort Compute Window Compute HashAggregate "
        "Compute HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q20": _plan(
        "Limit Limit Compute Sort Compute Window Compute HashAggregate "
        "Compute HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q36": _plan(
        "Limit ShuffleExchange Limit Compute Sort ShuffleExchange Compute "
        "Window ShuffleExchange Union Compute HashAggregate HashJoin "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute HashAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute HashAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q44": _plan(
        "Limit Sort ShuffleExchange Limit Sort Compute HashJoin Compute "
        "HashJoin HashJoin Window Compute FusedAggregate LocalTableScan "
        "BroadcastExchange Compute Window Compute FusedAggregate "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q47": _plan(
        "Limit Limit Compute Sort Compute HashJoin Compute HashJoin "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q49": _plan(
        "Limit ShuffleExchange Limit Compute Sort ShuffleExchange Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute Window "
        "Window Compute FusedAggregate HashJoin HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute Window Window Compute FusedAggregate HashJoin HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan Compute Window Window Compute FusedAggregate "
        "HashJoin HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q51": _plan(
        "Limit Sort ShuffleExchange Limit Sort Compute Window Compute "
        "HashJoin Window Compute HashAggregate HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute Window Compute "
        "HashAggregate HashJoin LocalTableScan BroadcastExchange Compute "
        "LocalTableScan"),
    "q53": _plan(
        "Limit Sort ShuffleExchange Limit Sort Compute Window Compute "
        "HashAggregate Compute HashJoin Compute HashJoin HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q57": _plan(
        "WholeQuery Limit Limit Compute Sort Compute HashJoin Compute "
        "HashJoin LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q63": _plan(
        "Limit Sort ShuffleExchange Limit Sort Compute Window Compute "
        "HashAggregate Compute HashJoin Compute HashJoin HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q67": _plan(
        "Limit Sort ShuffleExchange Limit Sort Compute Window "
        "ShuffleExchange Union Compute FusedAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute FusedAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute FusedAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute FusedAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute FusedAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute FusedAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute FusedAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute FusedAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute FusedAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q70": _plan(
        "Limit ShuffleExchange Limit Compute Sort ShuffleExchange Compute "
        "Window ShuffleExchange Union Compute HashAggregate HashJoin "
        "Compute HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute Window Compute HashAggregate Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin Compute HashJoin Compute HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute Window Compute HashAggregate Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin Compute HashJoin Compute HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute Window Compute HashAggregate Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q86": _plan(
        "Limit ShuffleExchange Limit Compute Sort ShuffleExchange Compute "
        "Window ShuffleExchange Union Compute HashAggregate Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "Compute HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan Compute "
        "HashAggregate Compute HashJoin Compute HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q89": _plan(
        "Limit Limit Compute Sort Compute Window Compute HashAggregate "
        "Compute HashJoin Compute HashJoin HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q98": _plan(
        "Compute Sort Compute Window Compute HashAggregate Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q5": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Union Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute "
        "HashAggregate ShuffleExchange HashAggregate Compute HashJoin "
        "Compute HashJoin ShuffleExchange LocalTableScan ShuffleExchange "
        "Union Compute LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "ShuffleExchange HashAggregate Compute HashJoin Compute HashJoin "
        "ShuffleExchange LocalTableScan ShuffleExchange Union Compute "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan Compute HashAggregate ShuffleExchange "
        "HashAggregate Compute HashJoin Compute HashJoin ShuffleExchange "
        "LocalTableScan ShuffleExchange Union Compute LocalTableScan "
        "Compute HashJoin Compute LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "ShuffleExchange HashAggregate Union Compute HashAggregate "
        "ShuffleExchange HashAggregate Compute HashJoin Compute HashJoin "
        "ShuffleExchange LocalTableScan ShuffleExchange Union Compute "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan Compute HashAggregate ShuffleExchange "
        "HashAggregate Compute HashJoin Compute HashJoin ShuffleExchange "
        "LocalTableScan ShuffleExchange Union Compute LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute HashAggregate ShuffleExchange HashAggregate Compute "
        "HashJoin Compute HashJoin ShuffleExchange LocalTableScan "
        "ShuffleExchange Union Compute LocalTableScan Compute HashJoin "
        "Compute LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute HashAggregate ShuffleExchange "
        "HashAggregate Union Compute HashAggregate ShuffleExchange "
        "HashAggregate Compute HashJoin Compute HashJoin ShuffleExchange "
        "LocalTableScan ShuffleExchange Union Compute LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute HashAggregate ShuffleExchange HashAggregate Compute "
        "HashJoin Compute HashJoin ShuffleExchange LocalTableScan "
        "ShuffleExchange Union Compute LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan Compute "
        "HashAggregate ShuffleExchange HashAggregate Compute HashJoin "
        "Compute HashJoin ShuffleExchange LocalTableScan ShuffleExchange "
        "Union Compute LocalTableScan Compute HashJoin Compute "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan"),
    "q18": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Union Compute "
        "FusedAggregate HashJoin HashJoin HashJoin HashJoin Compute "
        "HashJoin Compute HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute FusedAggregate HashJoin HashJoin "
        "HashJoin HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan BroadcastExchange Compute LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute FusedAggregate HashJoin HashJoin HashJoin HashJoin "
        "Compute HashJoin Compute HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute FusedAggregate "
        "HashJoin HashJoin HashJoin HashJoin Compute HashJoin Compute "
        "HashJoin LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute FusedAggregate HashJoin HashJoin HashJoin HashJoin "
        "Compute HashJoin Compute HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q27": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Union Compute "
        "HashAggregate HashJoin HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin HashJoin HashJoin Compute HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute HashAggregate HashJoin HashJoin "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q80": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Union Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute "
        "FusedAggregate HashJoin HashJoin Compute HashJoin HashJoin "
        "LocalTableScan Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute FusedAggregate HashJoin HashJoin "
        "HashJoin Compute HashJoin LocalTableScan Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute FusedAggregate "
        "HashJoin HashJoin Compute HashJoin HashJoin LocalTableScan "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute HashAggregate ShuffleExchange HashAggregate Union "
        "Compute FusedAggregate HashJoin HashJoin Compute HashJoin "
        "HashJoin LocalTableScan Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute FusedAggregate HashJoin HashJoin "
        "HashJoin Compute HashJoin LocalTableScan Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute FusedAggregate "
        "HashJoin HashJoin Compute HashJoin HashJoin LocalTableScan "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute HashAggregate ShuffleExchange HashAggregate Union "
        "Compute FusedAggregate HashJoin HashJoin Compute HashJoin "
        "HashJoin LocalTableScan Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute FusedAggregate HashJoin HashJoin "
        "HashJoin Compute HashJoin LocalTableScan Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute FusedAggregate "
        "HashJoin HashJoin Compute HashJoin HashJoin LocalTableScan "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q32": _plan(
        "WholeQuery Limit FusedLimit FusedAggregate HashJoin Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute HashAggregate HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q40": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashJoin HashJoin Compute HashJoin LocalTableScan "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q92": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute HashAggregate HashJoin "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q21": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashJoin HashJoin Compute HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q22": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Union Compute "
        "HashAggregate HashJoin HashJoin Compute HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute HashAggregate "
        "HashJoin HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q37": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin Compute HashJoin HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute LocalTableScan"),
    "q72": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashJoin Compute HashJoin HashJoin Compute "
        "HashJoin LocalTableScan BroadcastExchange Compute HashJoin "
        "Compute HashJoin LocalTableScan BroadcastExchange Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute LocalTableScan"),
    "q82": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin Compute HashJoin HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute LocalTableScan"),
    "q6": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "HashJoin Compute HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute HashAggregate LocalTableScan"),
    "q8": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate Compute HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute HashAggregate Compute "
        "HashJoin LocalTableScan BroadcastExchange Compute HashAggregate "
        "HashJoin LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q14a": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Union Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan Compute "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan"),
    "q14b": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort HashJoin "
        "FusedAggregate HashJoin Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange LocalTableScan "
        "BroadcastExchange Compute FusedAggregate HashJoin Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "LocalTableScan"),
    "q16": _plan(
        "Limit Sort ShuffleExchange Limit Sort Compute NestedLoopJoin "
        "Compute HashAggregate HashJoin Compute NestedLoopJoin Compute "
        "HashJoin HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute HashAggregate Compute HashAggregate HashJoin Compute "
        "NestedLoopJoin Compute HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute LocalTableScan"),
    "q17": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "HashAggregate HashJoin HashJoin HashJoin Compute HashJoin "
        "Compute HashJoin Compute HashJoin HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q28": _plan(
        "Limit Limit NestedLoopJoin NestedLoopJoin NestedLoopJoin "
        "NestedLoopJoin NestedLoopJoin Compute NestedLoopJoin Compute "
        "FusedAggregate LocalTableScan BroadcastExchange Compute "
        "HashAggregate Compute FusedAggregate LocalTableScan "
        "BroadcastExchange Compute NestedLoopJoin Compute FusedAggregate "
        "LocalTableScan BroadcastExchange Compute HashAggregate Compute "
        "FusedAggregate LocalTableScan BroadcastExchange Compute "
        "NestedLoopJoin Compute FusedAggregate LocalTableScan "
        "BroadcastExchange Compute HashAggregate Compute FusedAggregate "
        "LocalTableScan BroadcastExchange Compute NestedLoopJoin Compute "
        "FusedAggregate LocalTableScan BroadcastExchange Compute "
        "HashAggregate Compute FusedAggregate LocalTableScan "
        "BroadcastExchange Compute NestedLoopJoin Compute FusedAggregate "
        "LocalTableScan BroadcastExchange Compute HashAggregate Compute "
        "FusedAggregate LocalTableScan BroadcastExchange Compute "
        "NestedLoopJoin Compute FusedAggregate LocalTableScan "
        "BroadcastExchange Compute HashAggregate Compute FusedAggregate "
        "LocalTableScan"),
    "q38": _plan(
        "WholeQuery Limit FusedLimit HashAggregate Compute HashAggregate "
        "Compute HashJoin HashAggregate Compute HashJoin HashAggregate "
        "Compute HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute HashAggregate Compute HashJoin Compute "
        "HashJoin LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute HashAggregate "
        "Compute HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q39a": _plan(
        "WholeQuery Sort HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q39b": _plan(
        "WholeQuery Sort HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q41": _plan(
        "Limit Sort ShuffleExchange Limit Sort Compute FusedAggregate "
        "HashJoin LocalTableScan BroadcastExchange Compute FusedAggregate "
        "LocalTableScan"),
    "q54": _plan(
        "WholeQuery Limit Sort ShuffleExchange Limit Sort Compute "
        "FusedAggregate HashAggregate HashJoin HashJoin Compute HashJoin "
        "Compute HashJoin LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute HashAggregate "
        "ShuffleExchange FusedAggregate HashJoin HashJoin Compute "
        "HashJoin ShuffleExchange LocalTableScan ShuffleExchange Union "
        "Compute LocalTableScan Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q61": _plan(
        "Limit Sort ShuffleExchange Limit Sort Compute NestedLoopJoin "
        "Compute HashAggregate HashJoin HashJoin Compute HashJoin "
        "LocalTableScan BroadcastExchange Compute HashJoin Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute HashAggregate HashJoin HashJoin HashJoin Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q77": _plan(
        "Limit Sort ShuffleExchange Limit Sort Union Compute "
        "HashAggregate ShuffleExchange HashAggregate Union Compute "
        "HashJoin HashAggregate Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute HashAggregate Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute NestedLoopJoin "
        "Compute HashAggregate HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute HashAggregate "
        "HashJoin LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute HashJoin HashAggregate Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute HashAggregate Compute "
        "HashJoin Compute HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute HashAggregate ShuffleExchange HashAggregate Union "
        "Compute HashJoin HashAggregate Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute HashAggregate Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute NestedLoopJoin "
        "Compute HashAggregate HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute HashAggregate "
        "HashJoin LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute HashJoin HashAggregate Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute HashAggregate Compute "
        "HashJoin Compute HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute HashAggregate ShuffleExchange HashAggregate Union "
        "Compute HashJoin HashAggregate Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute HashAggregate Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute NestedLoopJoin "
        "Compute HashAggregate HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute HashAggregate "
        "HashJoin LocalTableScan BroadcastExchange Compute LocalTableScan "
        "Compute HashJoin HashAggregate Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute HashAggregate Compute "
        "HashJoin Compute HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q84": _plan(
        "Limit Limit Compute Sort Compute PythonEval HashJoin HashJoin "
        "HashJoin HashJoin HashJoin LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan Compute LocalTableScan "
        "Compute LocalTableScan"),
    "q87": _plan(
        "WholeQuery Compute HashAggregate Compute HashAggregate Compute "
        "HashJoin HashAggregate Compute HashJoin HashAggregate Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute HashAggregate Compute HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute HashAggregate Compute "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q88": _plan(
        "NestedLoopJoin NestedLoopJoin NestedLoopJoin NestedLoopJoin "
        "NestedLoopJoin NestedLoopJoin NestedLoopJoin Compute "
        "HashAggregate HashJoin HashJoin Compute HashJoin LocalTableScan "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute HashAggregate HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute HashAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute HashAggregate "
        "HashJoin HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute HashAggregate HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute HashAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute HashAggregate "
        "HashJoin HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute HashAggregate HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan"),
    "q90": _plan(
        "Limit Sort ShuffleExchange Limit Sort Compute NestedLoopJoin "
        "Compute HashAggregate HashJoin HashJoin Compute HashJoin "
        "LocalTableScan Compute LocalTableScan BroadcastExchange Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute HashAggregate HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q91": _plan(
        "WholeQuery Sort Compute HashAggregate Compute HashJoin Compute "
        "HashJoin LocalTableScan BroadcastExchange Compute HashJoin "
        "Compute HashJoin Compute HashJoin HashJoin LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan"),
    "q94": _plan(
        "Limit Sort ShuffleExchange Limit Sort Compute NestedLoopJoin "
        "Compute HashAggregate HashJoin Compute NestedLoopJoin Compute "
        "HashJoin HashJoin Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute HashAggregate Compute HashAggregate "
        "HashJoin Compute NestedLoopJoin Compute HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan BroadcastExchange Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan"),
    "q95": _plan(
        "Limit Sort ShuffleExchange Limit Sort Compute NestedLoopJoin "
        "Compute HashAggregate HashJoin HashJoin Compute HashJoin "
        "HashJoin Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute HashJoin LocalTableScan "
        "BroadcastExchange Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute HashAggregate Compute "
        "HashAggregate HashJoin HashJoin Compute HashJoin HashJoin "
        "Compute HashJoin LocalTableScan Compute LocalTableScan "
        "BroadcastExchange Compute LocalTableScan BroadcastExchange "
        "Compute LocalTableScan Compute HashJoin LocalTableScan Compute "
        "LocalTableScan BroadcastExchange Compute HashJoin LocalTableScan "
        "BroadcastExchange Compute HashJoin LocalTableScan Compute "
        "LocalTableScan"),
}
# each plan's compile-tier decision at SF10 and the default tier, `auto`:
# (tier, reason), the JAX package's (the same tests hold both engines to it)
_AUTO = "cost model (spark.tpu.compile.tier=auto)"
_FALLBACK = "whole-query fallback: "
TPCDS_TIERS = {
    "q3": ("whole", _AUTO),
    "q7": ("whole", _AUTO),
    "q13": ("whole", _AUTO),
    "q15": ("whole", _AUTO),
    "q19": ("whole", _AUTO),
    "q25": ("whole", _AUTO),
    "q26": ("whole", _AUTO),
    "q29": ("whole", _AUTO),
    "q31": ("stage", _FALLBACK
        + "batch volume 12000 rows under the compile-amortization "
        + "floor (393216; spark.tpu.compile.whole.minRows scaled by"
        + " program depth)"),
    "q34": ("whole", _AUTO),
    "q42": ("whole", _AUTO),
    "q43": ("whole", _AUTO),
    "q46": ("whole", _AUTO),
    "q48": ("whole", _AUTO),
    "q50": ("whole", _AUTO),
    "q52": ("whole", _AUTO),
    "q55": ("whole", _AUTO),
    "q59": ("stage", _FALLBACK
        + "batch volume 200068 rows under the compile-amortization "
        + "floor (524288; spark.tpu.compile.whole.minRows scaled by"
        + " program depth)"),
    "q62": ("whole", _AUTO),
    "q64": ("stage", _FALLBACK
        + "batch volume 13128 rows under the compile-amortization "
        + "floor (131072; spark.tpu.compile.whole.minRows scaled by"
        + " program depth)"),
    "q65": ("whole", _AUTO),
    "q68": ("whole", _AUTO),
    "q73": ("whole", _AUTO),
    "q78": ("whole", _AUTO),
    "q79": ("whole", _AUTO),
    "q85": ("whole", _AUTO),
    "q93": ("whole", _AUTO),
    "q96": ("whole", _AUTO),
    "q99": ("whole", _AUTO),
    "q97": ("stage", _FALLBACK
        + "full_outer join runs eager host-side passes (no in-"
        + "program lowering)"),
    "q2": ("stage", _FALLBACK
        + "batch volume 146656 rows under the compile-amortization "
        + "floor (262144; spark.tpu.compile.whole.minRows scaled by"
        + " program depth)"),
    "q4": ("whole", _AUTO),
    "q11": ("whole", _AUTO),
    "q66": ("whole", _AUTO),
    "q71": ("whole", _AUTO),
    "q74": ("whole", _AUTO),
    "q75": ("stage", _FALLBACK
        + "batch volume 106350 rows under the compile-amortization "
        + "floor (262144; spark.tpu.compile.whole.minRows scaled by"
        + " program depth)"),
    "q76": ("whole", _AUTO),
    "q1": ("whole", _AUTO),
    "q9": ("stage", _FALLBACK
        + "no exchange round-trips to eliminate (single-stage plan "
        + "— stage fusion already dispatches once per batch)"),
    "q10": ("whole", _AUTO),
    "q23a": ("whole", _AUTO),
    "q23b": ("whole", _AUTO),
    "q24a": ("stage", _FALLBACK
        + "no exchange round-trips to eliminate (single-stage plan "
        + "— stage fusion already dispatches once per batch)"),
    "q24b": ("stage", _FALLBACK
        + "no exchange round-trips to eliminate (single-stage plan "
        + "— stage fusion already dispatches once per batch)"),
    "q30": ("whole", _AUTO),
    "q33": ("whole", _AUTO),
    "q35": ("whole", _AUTO),
    "q45": ("whole", _AUTO),
    "q56": ("whole", _AUTO),
    "q58": ("whole", _AUTO),
    "q60": ("whole", _AUTO),
    "q69": ("whole", _AUTO),
    "q81": ("whole", _AUTO),
    "q83": ("whole", _AUTO),
    "q12": ("stage", _FALLBACK
        + "operator WindowExec has no whole-query lowering"),
    "q20": ("stage", _FALLBACK
        + "operator WindowExec has no whole-query lowering"),
    "q36": ("stage", _FALLBACK
        + "operator WindowExec has no whole-query lowering"),
    "q44": ("stage", _FALLBACK
        + "operator WindowExec has no whole-query lowering"),
    "q47": ("stage", _FALLBACK
        + "batch volume 134400 rows under the compile-amortization "
        + "floor (262144; spark.tpu.compile.whole.minRows scaled by"
        + " program depth)"),
    "q49": ("stage", _FALLBACK
        + "operator WindowExec has no whole-query lowering"),
    "q51": ("stage", _FALLBACK
        + "operator WindowExec has no whole-query lowering"),
    "q53": ("stage", _FALLBACK
        + "operator WindowExec has no whole-query lowering"),
    "q57": ("whole", _AUTO),
    "q63": ("stage", _FALLBACK
        + "operator WindowExec has no whole-query lowering"),
    "q67": ("stage", _FALLBACK
        + "operator WindowExec has no whole-query lowering"),
    "q70": ("stage", _FALLBACK
        + "operator WindowExec has no whole-query lowering"),
    "q86": ("stage", _FALLBACK
        + "operator WindowExec has no whole-query lowering"),
    "q89": ("stage", _FALLBACK
        + "operator WindowExec has no whole-query lowering"),
    "q98": ("stage", _FALLBACK
        + "operator WindowExec has no whole-query lowering"),
    "q5": ("whole", _AUTO),
    "q18": ("whole", _AUTO),
    "q27": ("whole", _AUTO),
    "q80": ("whole", _AUTO),
    "q32": ("whole", _AUTO),
    "q40": ("whole", _AUTO),
    "q92": ("whole", _AUTO),
    "q21": ("whole", _AUTO),
    "q22": ("whole", _AUTO),
    "q37": ("whole", _AUTO),
    "q72": ("whole", _AUTO),
    "q82": ("whole", _AUTO),
    "q6": ("whole", _AUTO),
    "q8": ("whole", _AUTO),
    "q14a": ("whole", _AUTO),
    "q14b": ("whole", _AUTO),
    "q16": ("stage", _FALLBACK
        + "operator NestedLoopJoinExec has no whole-query lowering"),
    "q17": ("whole", _AUTO),
    "q28": ("stage", _FALLBACK
        + "operator NestedLoopJoinExec has no whole-query lowering"),
    "q38": ("whole", _AUTO),
    "q39a": ("whole", _AUTO),
    "q39b": ("whole", _AUTO),
    "q41": ("stage", _FALLBACK
        + "batch volume 204000 rows under the compile-amortization "
        + "floor (262144; spark.tpu.compile.whole.minRows scaled by"
        + " program depth)"),
    "q54": ("whole", _AUTO),
    "q61": ("stage", _FALLBACK
        + "operator NestedLoopJoinExec has no whole-query lowering"),
    "q77": ("stage", _FALLBACK
        + "operator NestedLoopJoinExec has no whole-query lowering"),
    "q84": ("stage", _FALLBACK
        + "operator PythonEvalExec has no whole-query lowering"),
    "q87": ("whole", _AUTO),
    "q88": ("stage", _FALLBACK
        + "operator NestedLoopJoinExec has no whole-query lowering"),
    "q90": ("stage", _FALLBACK
        + "operator NestedLoopJoinExec has no whole-query lowering"),
    "q91": ("whole", _AUTO),
    "q94": ("stage", _FALLBACK
        + "operator NestedLoopJoinExec has no whole-query lowering"),
    "q95": ("stage", _FALLBACK
        + "operator NestedLoopJoinExec has no whole-query lowering"),
}
# the joins of each plan by kind, in the order of the tree
TPCDS_JOINS = {
    "q3": (
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
    ),
    "q7": (
        "BroadcastHashJoin[inner](ss_promo_sk=p_promo_sk)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ss_cdemo_sk=cd_demo_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
    ),
    "q13": (
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ss_cdemo_sk=cd_demo_sk)",
        "BroadcastHashJoin[inner](ss_addr_sk=ca_address_sk)",
        "BroadcastHashJoin[inner](ss_hdemo_sk=hd_demo_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q15": (
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](c_customer_sk=cs_bill_customer_sk)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
    ),
    "q19": (
        "BroadcastHashJoin[inner](ss_store_sk=s_store_sk)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](c_customer_sk=ss_customer_sk)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
    ),
    "q25": (
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](sr_returned_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](sr_customer_sk=cs_bill_customer_sk, "
        "sr_item_sk=cs_item_sk)",
        "ShuffledHashJoin[inner](ss_customer_sk=sr_customer_sk, "
        "ss_item_sk=sr_item_sk, ss_ticket_number=sr_ticket_number)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q26": (
        "BroadcastHashJoin[inner](cs_promo_sk=p_promo_sk)",
        "BroadcastHashJoin[inner](cs_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](cs_bill_cdemo_sk=cd_demo_sk)",
        "ShuffledHashJoin[inner](d_date_sk=cs_sold_date_sk)",
    ),
    "q29": (
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](sr_returned_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](sr_customer_sk=cs_bill_customer_sk, "
        "sr_item_sk=cs_item_sk)",
        "ShuffledHashJoin[inner](ss_customer_sk=sr_customer_sk, "
        "ss_item_sk=sr_item_sk, ss_ticket_number=sr_ticket_number)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q31": (
        "BroadcastHashJoin[inner](ca_county=ca_county)",
        "BroadcastHashJoin[inner](ca_county=ca_county)",
        "BroadcastHashJoin[inner](ca_county=ca_county)",
        "BroadcastHashJoin[inner](ca_county=ca_county)",
        "BroadcastHashJoin[inner](ca_county=ca_county)",
    ),
    "q34": (
        "BroadcastHashJoin[inner](ss_customer_sk=c_customer_sk)",
        "BroadcastHashJoin[inner](ss_hdemo_sk=hd_demo_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q42": (
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
    ),
    "q43": (
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q46": (
        "BroadcastHashJoin[inner](c_customer_sk=ss_customer_sk)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
        "BroadcastHashJoin[inner](ss_addr_sk=ca_address_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ss_hdemo_sk=hd_demo_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q48": (
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ss_cdemo_sk=cd_demo_sk)",
        "BroadcastHashJoin[inner](ss_addr_sk=ca_address_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q50": (
        "BroadcastHashJoin[inner](sr_returned_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](ss_ticket_number=sr_ticket_number, "
        "ss_item_sk=sr_item_sk, ss_customer_sk=sr_customer_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q52": (
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
    ),
    "q55": (
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
    ),
    "q59": (
        "BroadcastHashJoin[inner](s_store_id1=s_store_id2, "
        "d_week_seq1=__jkr_1)",
        "BroadcastHashJoin[inner](d_week_seq=d_week_seq)",
        "BroadcastHashJoin[inner](s_store_sk=ss_store_sk)",
        "BroadcastHashJoin[inner](d_week_seq=d_week_seq)",
        "BroadcastHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q62": (
        "BroadcastHashJoin[inner](ws_ship_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ws_web_site_sk=web_site_sk)",
        "BroadcastHashJoin[inner](ws_ship_mode_sk=sm_ship_mode_sk)",
        "ShuffledHashJoin[inner](w_warehouse_sk=ws_warehouse_sk)",
    ),
    "q64": (
        "BroadcastHashJoin[inner](item_sk=item_sk, store_name=store_name, "
        "store_zip=store_zip)",
    ),
    "q65": (
        "BroadcastHashJoin[inner](ss_store_sk=ss_store_sk)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](s_store_sk=ss_store_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
    ),
    "q68": (
        "BroadcastHashJoin[inner](c_customer_sk=ss_customer_sk)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
        "BroadcastHashJoin[inner](ss_addr_sk=ca_address_sk)",
        "BroadcastHashJoin[inner](ss_hdemo_sk=hd_demo_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q73": (
        "BroadcastHashJoin[inner](ss_customer_sk=c_customer_sk)",
        "BroadcastHashJoin[inner](ss_hdemo_sk=hd_demo_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q78": (
        "ShuffledHashJoin[left_outer](ss_sold_year=cs_sold_year, "
        "ss_item_sk=cs_item_sk, ss_customer_sk=cs_customer_sk)",
        "BroadcastHashJoin[left_outer](ss_sold_year=ws_sold_year, "
        "ss_item_sk=ws_item_sk, ss_customer_sk=ws_customer_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[left_outer](ss_ticket_number=sr_ticket_number, "
        "ss_item_sk=sr_item_sk)",
        "BroadcastHashJoin[inner](ws_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[left_outer](ws_order_number=wr_order_number, "
        "ws_item_sk=wr_item_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[left_outer](cs_order_number=cr_order_number, "
        "cs_item_sk=cr_item_sk)",
    ),
    "q79": (
        "BroadcastHashJoin[inner](ss_customer_sk=c_customer_sk)",
        "BroadcastHashJoin[inner](ss_hdemo_sk=hd_demo_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q85": (
        "BroadcastHashJoin[inner](wr_reason_sk=r_reason_sk)",
        "BroadcastHashJoin[inner](wr_refunded_addr_sk=ca_address_sk)",
        "BroadcastHashJoin[inner](cd_marital_status=cd_marital_status, "
        "cd_education_status=cd_education_status, "
        "wr_returning_cdemo_sk=cd_demo_sk)",
        "BroadcastHashJoin[inner](wr_refunded_cdemo_sk=cd_demo_sk)",
        "BroadcastHashJoin[inner](ws_item_sk=wr_item_sk, "
        "ws_order_number=wr_order_number)",
        "BroadcastHashJoin[inner](ws_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](wp_web_page_sk=ws_web_page_sk)",
    ),
    "q93": (
        "BroadcastHashJoin[inner](sr_reason_sk=r_reason_sk)",
        "ShuffledHashJoin[left_outer](ss_item_sk=sr_item_sk, "
        "ss_ticket_number=sr_ticket_number)",
    ),
    "q96": (
        "BroadcastHashJoin[inner](ss_store_sk=s_store_sk)",
        "BroadcastHashJoin[inner](ss_sold_time_sk=t_time_sk)",
        "ShuffledHashJoin[inner](hd_demo_sk=ss_hdemo_sk)",
    ),
    "q99": (
        "BroadcastHashJoin[inner](cs_ship_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](cs_call_center_sk=cc_call_center_sk)",
        "BroadcastHashJoin[inner](cs_ship_mode_sk=sm_ship_mode_sk)",
        "ShuffledHashJoin[inner](w_warehouse_sk=cs_warehouse_sk)",
    ),
    "q97": (
        "ShuffledHashJoin[full_outer](customer_sk=customer_sk, "
        "item_sk=item_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
    ),
    "q2": (
        "BroadcastHashJoin[inner](d_week_seq1=__jkr_0)",
        "BroadcastHashJoin[inner](d_week_seq=d_week_seq)",
        "BroadcastHashJoin[inner](d_week_seq=d_week_seq)",
    ),
    "q4": (
        "ShuffledHashJoin[inner](customer_id=customer_id)",
        "ShuffledHashJoin[inner](customer_id=customer_id)",
        "BroadcastHashJoin[inner](customer_id=customer_id)",
        "ShuffledHashJoin[inner](customer_id=customer_id)",
        "ShuffledHashJoin[inner](customer_id=customer_id)",
    ),
    "q11": (
        "BroadcastHashJoin[inner](customer_id=customer_id)",
        "ShuffledHashJoin[inner](customer_id=customer_id)",
        "BroadcastHashJoin[inner](customer_id=customer_id)",
    ),
    "q66": (
        "BroadcastHashJoin[inner](ws_ship_mode_sk=sm_ship_mode_sk)",
        "BroadcastHashJoin[inner](ws_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ws_sold_time_sk=t_time_sk)",
        "ShuffledHashJoin[inner](w_warehouse_sk=ws_warehouse_sk)",
        "BroadcastHashJoin[inner](cs_ship_mode_sk=sm_ship_mode_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](cs_sold_time_sk=t_time_sk)",
        "ShuffledHashJoin[inner](w_warehouse_sk=cs_warehouse_sk)",
    ),
    "q71": (
        "BroadcastHashJoin[inner](time_sk=t_time_sk)",
        "ShuffledHashJoin[inner](i_item_sk=sold_item_sk)",
        "BroadcastHashJoin[inner](ws_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
    ),
    "q74": (
        "BroadcastHashJoin[inner](customer_id=customer_id)",
        "BroadcastHashJoin[inner](customer_id=customer_id)",
        "BroadcastHashJoin[inner](customer_id=customer_id)",
    ),
    "q75": (
        "BroadcastHashJoin[inner](i_brand_id=i_brand_id, "
        "i_class_id=i_class_id, i_category_id=i_category_id, "
        "i_manufact_id=i_manufact_id)",
    ),
    "q76": (
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
        "BroadcastHashJoin[inner](ws_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ws_sold_date_sk)",
        "BroadcastHashJoin[inner](cs_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=cs_sold_date_sk)",
    ),
    "q1": (
        "BroadcastHashJoin[left_outer](ctr_store_sk=ctr_store_sk)",
        "BroadcastHashJoin[inner](ctr_customer_sk=c_customer_sk)",
        "BroadcastHashJoin[inner](s_store_sk=ctr_store_sk)",
    ),
    "q9": (),
    "q10": (
        "BroadcastHashJoin[left_outer](c_customer_sk=cs_ship_customer_sk)",
        "BroadcastHashJoin[left_outer](c_customer_sk=ws_bill_customer_sk)",
        "ShuffledHashJoin[left_semi](c_customer_sk=ss_customer_sk)",
        "ShuffledHashJoin[inner](c_current_cdemo_sk=cd_demo_sk)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ws_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
    ),
    "q23a": (
        "BroadcastHashJoin[left_semi](cs_bill_customer_sk=c_customer_sk)",
        "BroadcastHashJoin[left_semi](cs_item_sk=item_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[left_semi](ws_bill_customer_sk=c_customer_sk)",
        "BroadcastHashJoin[left_semi](ws_item_sk=item_sk)",
        "BroadcastHashJoin[inner](ws_sold_date_sk=d_date_sk)",
    ),
    "q23b": (
        "BroadcastHashJoin[left_semi](cs_bill_customer_sk=c_customer_sk)",
        "BroadcastHashJoin[left_semi](cs_item_sk=item_sk)",
        "BroadcastHashJoin[inner](cs_bill_customer_sk=c_customer_sk)",
        "ShuffledHashJoin[inner](d_date_sk=cs_sold_date_sk)",
        "BroadcastHashJoin[left_semi](ws_bill_customer_sk=c_customer_sk)",
        "BroadcastHashJoin[left_semi](ws_item_sk=item_sk)",
        "BroadcastHashJoin[inner](ws_bill_customer_sk=c_customer_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ws_sold_date_sk)",
    ),
    "q24a": (),
    "q24b": (),
    "q30": (
        "BroadcastHashJoin[left_outer](ctr_state=ctr_state)",
        "BroadcastHashJoin[inner](c_customer_sk=ctr_customer_sk)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
    ),
    "q33": (
        "BroadcastHashJoin[left_semi](i_manufact_id=i_manufact_id)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ss_addr_sk=ca_address_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
        "BroadcastHashJoin[left_semi](i_manufact_id=i_manufact_id)",
        "BroadcastHashJoin[inner](cs_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](cs_bill_addr_sk=ca_address_sk)",
        "ShuffledHashJoin[inner](d_date_sk=cs_sold_date_sk)",
        "BroadcastHashJoin[left_semi](i_manufact_id=i_manufact_id)",
        "BroadcastHashJoin[inner](ws_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ws_bill_addr_sk=ca_address_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ws_sold_date_sk)",
    ),
    "q35": (
        "BroadcastHashJoin[left_outer](c_customer_sk=cs_ship_customer_sk)",
        "BroadcastHashJoin[left_outer](c_customer_sk=ws_bill_customer_sk)",
        "ShuffledHashJoin[left_semi](c_customer_sk=ss_customer_sk)",
        "ShuffledHashJoin[inner](c_current_cdemo_sk=cd_demo_sk)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ws_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
    ),
    "q45": (
        "BroadcastHashJoin[left_outer](i_item_id=i_item_id)",
        "BroadcastHashJoin[inner](ws_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](c_current_addr_sk=ca_address_sk)",
        "BroadcastHashJoin[inner](ws_bill_customer_sk=c_customer_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ws_sold_date_sk)",
    ),
    "q56": (
        "BroadcastHashJoin[left_semi](i_item_id=i_item_id)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ss_addr_sk=ca_address_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
        "BroadcastHashJoin[left_semi](i_item_id=i_item_id)",
        "BroadcastHashJoin[inner](cs_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](cs_bill_addr_sk=ca_address_sk)",
        "ShuffledHashJoin[inner](d_date_sk=cs_sold_date_sk)",
        "BroadcastHashJoin[left_semi](i_item_id=i_item_id)",
        "BroadcastHashJoin[inner](ws_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ws_bill_addr_sk=ca_address_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ws_sold_date_sk)",
    ),
    "q58": (
        "BroadcastHashJoin[inner](item_id=item_id)",
        "BroadcastHashJoin[inner](item_id=item_id)",
        "BroadcastHashJoin[left_semi](d_date=d_date)",
        "BroadcastHashJoin[inner](ws_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ws_sold_date_sk)",
        "BroadcastHashJoin[left_semi](d_date=d_date)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
        "BroadcastHashJoin[left_semi](d_date=d_date)",
        "BroadcastHashJoin[inner](cs_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=cs_sold_date_sk)",
    ),
    "q60": (
        "BroadcastHashJoin[left_semi](i_item_id=i_item_id)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ss_addr_sk=ca_address_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
        "BroadcastHashJoin[left_semi](i_item_id=i_item_id)",
        "BroadcastHashJoin[inner](cs_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](cs_bill_addr_sk=ca_address_sk)",
        "ShuffledHashJoin[inner](d_date_sk=cs_sold_date_sk)",
        "BroadcastHashJoin[left_semi](i_item_id=i_item_id)",
        "BroadcastHashJoin[inner](ws_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ws_bill_addr_sk=ca_address_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ws_sold_date_sk)",
    ),
    "q69": (
        "ShuffledHashJoin[left_anti](c_customer_sk=cs_ship_customer_sk)",
        "ShuffledHashJoin[left_anti](c_customer_sk=ws_bill_customer_sk)",
        "ShuffledHashJoin[left_semi](c_customer_sk=ss_customer_sk)",
        "ShuffledHashJoin[inner](c_current_cdemo_sk=cd_demo_sk)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ws_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
    ),
    "q81": (
        "BroadcastHashJoin[left_outer](ctr_state=ctr_state)",
        "BroadcastHashJoin[inner](c_customer_sk=ctr_customer_sk)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
    ),
    "q83": (
        "BroadcastHashJoin[inner](item_id=item_id)",
        "BroadcastHashJoin[inner](item_id=item_id)",
        "BroadcastHashJoin[left_semi](d_date=d_date)",
        "BroadcastHashJoin[inner](wr_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](d_date_sk=wr_returned_date_sk)",
        "BroadcastHashJoin[left_semi](d_week_seq=d_week_seq)",
        "BroadcastHashJoin[left_semi](d_date=d_date)",
        "BroadcastHashJoin[inner](sr_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](d_date_sk=sr_returned_date_sk)",
        "BroadcastHashJoin[left_semi](d_week_seq=d_week_seq)",
        "BroadcastHashJoin[left_semi](d_date=d_date)",
        "BroadcastHashJoin[inner](cr_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](d_date_sk=cr_returned_date_sk)",
        "BroadcastHashJoin[left_semi](d_week_seq=d_week_seq)",
    ),
    "q12": (
        "BroadcastHashJoin[inner](ws_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ws_sold_date_sk)",
    ),
    "q20": (
        "BroadcastHashJoin[inner](cs_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=cs_sold_date_sk)",
    ),
    "q36": (
        "BroadcastHashJoin[inner](ss_store_sk=s_store_sk)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
    ),
    "q44": (
        "BroadcastHashJoin[inner](item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](rnk=rnk)",
    ),
    "q47": (
        "BroadcastHashJoin[inner](i_category=i_category, i_brand=i_brand, "
        "s_store_name=s_store_name, s_company_name=s_company_name, "
        "rn=__jkr_4)",
    ),
    "q49": (
        "BroadcastHashJoin[inner](ws_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[left_outer](ws_order_number=wr_order_number, "
        "ws_item_sk=wr_item_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[left_outer](cs_order_number=cr_order_number, "
        "cs_item_sk=cr_item_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[left_outer](ss_ticket_number=sr_ticket_number, "
        "ss_item_sk=sr_item_sk)",
    ),
    "q51": (
        "ShuffledHashJoin[full_outer](item_sk=item_sk, d_date=d_date)",
        "BroadcastHashJoin[inner](ws_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
    ),
    "q53": (
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q57": (
        "BroadcastHashJoin[inner](i_category=i_category, i_brand=i_brand, "
        "cc_name=cc_name, rn=__jkr_3)",
    ),
    "q63": (
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q67": (
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q70": (
        "BroadcastHashJoin[left_semi](s_state=s_state)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q86": (
        "BroadcastHashJoin[inner](ws_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ws_sold_date_sk)",
    ),
    "q89": (
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q98": (
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
    ),
    "q5": (
        "BroadcastHashJoin[inner](date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=store_sk)",
        "BroadcastHashJoin[inner](page_sk=cp_catalog_page_sk)",
        "ShuffledHashJoin[inner](d_date_sk=date_sk)",
        "ShuffledHashJoin[inner](web_site_sk=wsr_web_site_sk)",
        "ShuffledHashJoin[left_outer](wr_item_sk=ws_item_sk, "
        "wr_order_number=ws_order_number)",
    ),
    "q18": (
        "BroadcastHashJoin[inner](cs_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](cs_bill_cdemo_sk=cd_demo_sk)",
        "BroadcastHashJoin[inner](c_current_cdemo_sk=cd_demo_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](c_customer_sk=cs_bill_customer_sk)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
    ),
    "q27": (
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ss_cdemo_sk=cd_demo_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q80": (
        "BroadcastHashJoin[inner](ss_promo_sk=p_promo_sk)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
        "ShuffledHashJoin[left_outer](ss_item_sk=sr_item_sk, "
        "ss_ticket_number=sr_ticket_number)",
        "BroadcastHashJoin[inner](cs_promo_sk=p_promo_sk)",
        "BroadcastHashJoin[inner](cs_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](cs_catalog_page_sk=cp_catalog_page_sk)",
        "ShuffledHashJoin[inner](d_date_sk=cs_sold_date_sk)",
        "ShuffledHashJoin[left_outer](cs_item_sk=cr_item_sk, "
        "cs_order_number=cr_order_number)",
        "BroadcastHashJoin[inner](ws_promo_sk=p_promo_sk)",
        "BroadcastHashJoin[inner](ws_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ws_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](web_site_sk=ws_web_site_sk)",
        "ShuffledHashJoin[left_outer](ws_item_sk=wr_item_sk, "
        "ws_order_number=wr_order_number)",
    ),
    "q32": (
        "BroadcastHashJoin[left_outer](i_item_sk=cs_item_sk)",
        "BroadcastHashJoin[inner](cs_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=cs_sold_date_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
    ),
    "q40": (
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](cs_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](w_warehouse_sk=cs_warehouse_sk)",
        "ShuffledHashJoin[left_outer](cs_order_number=cr_order_number, "
        "cs_item_sk=cr_item_sk)",
    ),
    "q92": (
        "BroadcastHashJoin[left_outer](i_item_sk=ws_item_sk)",
        "BroadcastHashJoin[inner](ws_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ws_sold_date_sk)",
        "BroadcastHashJoin[inner](ws_sold_date_sk=d_date_sk)",
    ),
    "q21": (
        "BroadcastHashJoin[inner](inv_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](inv_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](w_warehouse_sk=inv_warehouse_sk)",
    ),
    "q22": (
        "BroadcastHashJoin[inner](inv_warehouse_sk=w_warehouse_sk)",
        "BroadcastHashJoin[inner](inv_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=inv_date_sk)",
    ),
    "q37": (
        "ShuffledHashJoin[inner](i_item_sk=cs_item_sk)",
        "BroadcastHashJoin[inner](inv_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](i_item_sk=inv_item_sk)",
    ),
    "q72": (
        "ShuffledHashJoin[left_outer](cs_item_sk=cr_item_sk, "
        "cs_order_number=cr_order_number)",
        "BroadcastHashJoin[left_outer](cs_promo_sk=p_promo_sk)",
        "BroadcastHashJoin[inner](cs_ship_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](d_date_sk=inv_date_sk, "
        "d_week_seq=d_week_seq)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](hd_demo_sk=cs_bill_hdemo_sk)",
        "BroadcastHashJoin[inner](cs_bill_cdemo_sk=cd_demo_sk)",
        "ShuffledHashJoin[inner](i_item_sk=cs_item_sk)",
        "ShuffledHashJoin[inner](inv_item_sk=cs_item_sk)",
        "ShuffledHashJoin[inner](w_warehouse_sk=inv_warehouse_sk)",
    ),
    "q82": (
        "ShuffledHashJoin[inner](i_item_sk=ss_item_sk)",
        "BroadcastHashJoin[inner](inv_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](i_item_sk=inv_item_sk)",
    ),    # the fifth SQL slice (each join once, in the order of the tree)
    "q6": (
        "BroadcastHashJoin[left_outer](i_category=i_category)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](c_customer_sk=ss_customer_sk)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
    ),
    "q8": (
        "BroadcastHashJoin[inner](__jkl_0=__jkr_0)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
        "BroadcastHashJoin[left_semi](__jkl_0=__jkr_0, __jkl_1=__jkr_1)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
    ),
    "q14a": (
        "BroadcastHashJoin[left_semi](ss_item_sk=ss_item_sk)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
        "BroadcastHashJoin[left_semi](cs_item_sk=ss_item_sk)",
        "BroadcastHashJoin[inner](cs_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=cs_sold_date_sk)",
        "BroadcastHashJoin[left_semi](ws_item_sk=ss_item_sk)",
        "BroadcastHashJoin[inner](ws_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ws_sold_date_sk)",
    ),
    "q14b": (
        "BroadcastHashJoin[inner](i_brand_id=i_brand_id, "
        "i_class_id=i_class_id, i_category_id=i_category_id)",
        "BroadcastHashJoin[left_semi](ss_item_sk=ss_item_sk)",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
    ),
    "q16": (
        "NestedLoopJoin[cross]()",
        "ShuffledHashJoin[left_anti](cs_order_number=cr_order_number)",
        "NestedLoopJoin[left_semi](((cs_order_number = cs_order_number) AND"
        " (cs_warehouse_sk != cs_warehouse_sk)))",
        "BroadcastHashJoin[inner](cs_ship_addr_sk=ca_address_sk)",
        "BroadcastHashJoin[inner](cs_ship_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](cc_call_center_sk=cs_call_center_sk)",
    ),
    "q17": (
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](sr_returned_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](sr_customer_sk=cs_bill_customer_sk, "
        "sr_item_sk=cs_item_sk)",
        "ShuffledHashJoin[inner](ss_customer_sk=sr_customer_sk, "
        "ss_item_sk=sr_item_sk, ss_ticket_number=sr_ticket_number)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q28": (
        "NestedLoopJoin[cross]()",
    ),
    "q38": (
        "BroadcastHashJoin[left_semi](__jkl_0=__jkr_0, __jkl_1=__jkr_1, "
        "__jkl_2=__jkr_2, __jkl_3=__jkr_3, __jkl_4=__jkr_4, "
        "__jkl_5=__jkr_5)",
        "BroadcastHashJoin[inner](ss_customer_sk=c_customer_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
        "BroadcastHashJoin[inner](cs_bill_customer_sk=c_customer_sk)",
        "ShuffledHashJoin[inner](d_date_sk=cs_sold_date_sk)",
        "BroadcastHashJoin[inner](ws_bill_customer_sk=c_customer_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ws_sold_date_sk)",
    ),
    "q39a": (
        "BroadcastHashJoin[inner](i_item_sk=i_item_sk, "
        "w_warehouse_sk=w_warehouse_sk)",
    ),
    "q39b": (
        "BroadcastHashJoin[inner](i_item_sk=i_item_sk, "
        "w_warehouse_sk=w_warehouse_sk)",
    ),
    "q41": (
        "BroadcastHashJoin[left_outer](i_manufact=i_manufact)",
    ),
    "q54": (
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](c_customer_sk=ss_customer_sk)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
        "BroadcastHashJoin[inner](s_county=ca_county, s_state=ca_state)",
        "BroadcastHashJoin[inner](customer_sk=c_customer_sk)",
        "BroadcastHashJoin[inner](item_sk=i_item_sk)",
        "ShuffledHashJoin[inner](d_date_sk=sold_date_sk)",
    ),
    "q61": (
        "NestedLoopJoin[cross]()",
        "BroadcastHashJoin[inner](ss_item_sk=i_item_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](p_promo_sk=ss_promo_sk)",
        "BroadcastHashJoin[inner](c_current_addr_sk=ca_address_sk)",
        "BroadcastHashJoin[inner](ss_customer_sk=c_customer_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
    ),
    "q77": (
        "BroadcastHashJoin[left_outer](s_store_sk=s_store_sk)",
        "BroadcastHashJoin[inner](ss_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=ss_store_sk)",
        "BroadcastHashJoin[inner](sr_returned_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](s_store_sk=sr_store_sk)",
        "NestedLoopJoin[cross]()",
        "BroadcastHashJoin[inner](cs_sold_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](cr_returned_date_sk=d_date_sk)",
        "BroadcastHashJoin[left_outer](wp_web_page_sk=wp_web_page_sk)",
        "BroadcastHashJoin[inner](ws_sold_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](wp_web_page_sk=ws_web_page_sk)",
        "BroadcastHashJoin[inner](wr_returned_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](wp_web_page_sk=wr_web_page_sk)",
    ),
    "q84": (
        "ShuffledHashJoin[inner](cd_demo_sk=sr_cdemo_sk)",
        "ShuffledHashJoin[inner](c_current_cdemo_sk=cd_demo_sk)",
        "BroadcastHashJoin[inner](c_current_addr_sk=ca_address_sk)",
        "BroadcastHashJoin[inner](hd_demo_sk=c_current_hdemo_sk)",
        "BroadcastHashJoin[inner](ib_income_band_sk=hd_income_band_sk)",
    ),
    "q87": (
        "BroadcastHashJoin[left_anti](__jkl_0=__jkr_0, __jkl_1=__jkr_1, "
        "__jkl_2=__jkr_2, __jkl_3=__jkr_3, __jkl_4=__jkr_4, "
        "__jkl_5=__jkr_5)",
        "BroadcastHashJoin[inner](ss_customer_sk=c_customer_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ss_sold_date_sk)",
        "BroadcastHashJoin[inner](cs_bill_customer_sk=c_customer_sk)",
        "ShuffledHashJoin[inner](d_date_sk=cs_sold_date_sk)",
        "BroadcastHashJoin[inner](ws_bill_customer_sk=c_customer_sk)",
        "ShuffledHashJoin[inner](d_date_sk=ws_sold_date_sk)",
    ),
    "q88": (
        "NestedLoopJoin[cross]()",
        "BroadcastHashJoin[inner](ss_store_sk=s_store_sk)",
        "BroadcastHashJoin[inner](ss_sold_time_sk=t_time_sk)",
        "ShuffledHashJoin[inner](hd_demo_sk=ss_hdemo_sk)",
    ),
    "q90": (
        "NestedLoopJoin[cross]()",
        "BroadcastHashJoin[inner](ws_web_page_sk=wp_web_page_sk)",
        "BroadcastHashJoin[inner](ws_sold_time_sk=t_time_sk)",
        "ShuffledHashJoin[inner](hd_demo_sk=ws_ship_hdemo_sk)",
    ),
    "q91": (
        "BroadcastHashJoin[inner](c_current_cdemo_sk=cd_demo_sk)",
        "BroadcastHashJoin[inner](ca_address_sk=c_current_addr_sk)",
        "BroadcastHashJoin[inner](c_current_hdemo_sk=hd_demo_sk)",
        "BroadcastHashJoin[inner](cr_returning_customer_sk=c_customer_sk)",
        "BroadcastHashJoin[inner](cr_returned_date_sk=d_date_sk)",
        "BroadcastHashJoin[inner](cc_call_center_sk=cr_call_center_sk)",
    ),
    "q94": (
        "NestedLoopJoin[cross]()",
        "BroadcastHashJoin[left_anti](ws_order_number=wr_order_number)",
        "NestedLoopJoin[left_semi](((ws_order_number = ws_order_number) AND"
        " (ws_warehouse_sk != ws_warehouse_sk)))",
        "BroadcastHashJoin[inner](ws_ship_addr_sk=ca_address_sk)",
        "BroadcastHashJoin[inner](ws_ship_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](web_site_sk=ws_web_site_sk)",
    ),
    "q95": (
        "NestedLoopJoin[cross]()",
        "BroadcastHashJoin[left_semi](ws_order_number=wr_order_number)",
        "ShuffledHashJoin[left_semi](ws_order_number=ws_order_number)",
        "BroadcastHashJoin[inner](ws_ship_addr_sk=ca_address_sk)",
        "BroadcastHashJoin[inner](ws_ship_date_sk=d_date_sk)",
        "ShuffledHashJoin[inner](web_site_sk=ws_web_site_sk)",
        "ShuffledHashJoin[inner](ws_order_number=ws_order_number)",
        "BroadcastHashJoin[inner](wr_order_number=ws_order_number)",
    ),
}
TPCDS_QUERIES = tuple(TPCDS_PLAN_OPS)
# the query files the tpcds leg does not run at SF10 (tpcds_gate holds them
# at scale 0.1, and the tests plan them at SF10): q72's plan, the
# reference's, joins inventory to catalog_sales on the item alone first,
# 14,401,261 sales lines x 2,610 snapshots of half the items = 1.9e10 rows
TPCDS_SF10_CUT = ("q72",)
# cut for time, so the budget and runtime_filters legs fit in the limit:
# q64's first sql() took 23.5-39.4 s on the card (its CTE body's 17
# capacity retries); its plan is still held at SF10 by the tests, and its
# CPU check was already skipped (TPCDS_CPU_SKIP)
TPCDS_TIME_CUT = ("q64",)
# the queries held to numpy oracles at SF10 (tpcds_oracle)
TPCDS_ORACLES = ("q3", "q7", "q19")
# the query files that return no rows over tpcds_data, held to exactly none
# (and to the CPU): q8's zips need over 10 preferred customers each, where
# uniform addresses give about 2.7 (250,000 addresses over 89,999 zips); q54
# needs customers of one class and month living in a store's county and
# state, which uniform draws give about once. Making either return rows
# would rewrite columns the earlier queries read
TPCDS_SF10_EMPTY = ("q8", "q54")
# the queries whose CTEs the session materialises (each body runs once,
# inside session.sql, and is collected to the host), with the rows of each
# materialised CTE at SF10, in definition order: they are the row counts
# the join reorder and the broadcast choice of the rest of the plan read
# (the tests plan both engines with them)
TPCDS_CTE_ROWS = {"q31": {"ss": 2000, "ws": 2000}, "q59": {"wss": 26883},
                  "q64": {"cross_sales": 6564},
                  "q1": {"customer_total_return": 397688},
                  "q2": {"wswscs": 279},
                  "q4": {"year_total": 4845605},
                  "q11": {"year_total": 2886937},
                  "q23a": {"frequent_ss_items": 2039, "best_ss_customer": 3},
                  "q23b": {"frequent_ss_items": 2039, "best_ss_customer": 3},
                  "q24a": {"ssales": 75782}, "q24b": {"ssales": 75782},
                  "q30": {"customer_total_return": 137635},
                  "q74": {"year_total": 1153137},
                  "q75": {"all_sales": 53175},
                  "q81": {"customer_total_return": 270131},
                  "q47": {"v1": 44800}, "q57": {"v1": 107520},
                  "q14a": {"cross_items": 102000, "avg_sales": 1},
                  "q14b": {"cross_items": 102000, "avg_sales": 1},
                  "q39a": {"inv": 367524}, "q39b": {"inv": 367524}}
# the queries whose optimizer runs uncorrelated scalar subqueries (in its
# last step, each once: the `subquery.scalar` metric), with their number
TPCDS_SCALAR_SUBQUERIES = {"q9": 15, "q24a": 1, "q24b": 1, "q45": 2,
                           "q58": 3, "q44": 2, "q6": 1, "q14a": 15,
                           "q14b": 4, "q54": 2}


def tiles(rows: int, tile: int) -> int:
    return -(-rows // tile)


def leg_calls(leg: str) -> int:
    """Histogram wrapper calls of one leg, derived from the code as
    MAIN_HISTOGRAMS is; `t` is the fact or sales scan's tile count and `p`
    the shuffle partitions."""
    t, p = tiles(ROWS, TILE), PARTITIONS
    return {
        # the dense join build's `present` (1: one probe partition); the
        # partial aggregate folds its one partition tile by tile (t chunks
        # x 1: the row mask; the price has no nulls) and merges the chunk
        # partials (x 2: the row mask and the sum buffer's validity); no
        # exchange: one shuffle partition satisfies the final aggregate's
        # clustering
        "join": 1 + t + 2,
        # sorts, limits and the gather to one partition count nothing
        "sort": 0,
        "topk": 0,
        # round-robin input tiles + one range-exchange input per partition
        "range_sort": t + p,
        # round-robin input tiles + p hash-exchange inputs for the sales
        # side + 1 returns tile + p partial tiles x 1 (the row mask; the
        # paid column comes from the probe side and has no nulls) + p
        # hash-exchange inputs + 1 final pass x 2 (the row mask and the
        # sum buffer's validity): AQE merges the final aggregate's p
        # partitions (at most 102 stores of each of p partials) into one.
        # The join's partitions stay apart: each holds about 2.5M sales
        # rows of 4 columns (32 B), over the 2,097,152 rows of the 64 MiB
        # advisory size
        "q78": t + p + 1 + p + p + 1 * 2,
        # round-robin input tiles + one hash-exchange input per partition;
        # the window's sorts and scans count nothing
        "window": t + p,
    }[leg]


# device-kernel name fragments (lower case) whose share of a leg's profiled
# kernel time the breakdown reports: torch.sort's radix and bitonic sorts;
# the join probe's binary searches (match ranges and the expansion); scans
# (the expansion's cumsum, the limits' live ranks); the index_add_ sums of
# the dense aggregate
KERNEL_SHARES = {"sort": ("sort",), "searchsorted": ("searchsorted",),
                 "scan (cumsum)": ("scan",), "index_add_": ("indexfunc",)}


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
    # device activity alone: the kernels are the same, and the trace of a
    # query's host ops costs seconds to build
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def timed(row, launch, wrapper, plain, library) -> dict:
    """`row` with the times of one kernel case: device_ms (the bare kernel
    alone), call_ms (the wrapper per call), the plain version's device_ms,
    torch.bincount's profiled device time, and the share of the bound."""
    row.update({
        "device_ms": device_ms(launch),
        "call_ms": call_ms(wrapper),
        "plain_ms": device_ms(plain, iters=30),
        "library_ms": profiled_ms(library),
    })
    row["ms"] = row["device_ms"]
    row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
    print("kernel " + json.dumps(row), flush=True)
    return row


def hist_check(torch, sk, label: str, k, m, buckets: int) -> int:
    """partition_histogram on the card tensors `k` (int32 keys) and `m`
    (bool mask) held against its plain version; fails on any difference.
    Returns the max abs error (0)."""
    got = sk.partition_histogram(k, m, buckets)
    exp = sk.partition_histogram_plain(k, m, buckets)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - exp.to(torch.int64)).abs().max())
    if err != 0:
        fail(f"partition_histogram {label}: max abs err {err}")
    return err


def hist_row(torch, sk, label: str, k, m, buckets: int) -> dict:
    """`hist_check`, the bare launch too, then timed."""
    err = hist_check(torch, sk, label, k, m, buckets)
    exp = sk.partition_histogram_plain(k, m, buckets)
    launch, bare = bare_launch(torch, sk, k, m, buckets)
    if not torch.equal(bare, exp):
        fail(f"partition_histogram {label}: the bare launch differs")
    w = m.to(torch.float32)
    live = int(m.sum())
    return timed(
        {"kernel": "partition_histogram", "shape": label, "rows": k.shape[0],
         "buckets": buckets, "live_rows": live, "max_abs_err": err,
         # each mask byte, the key of each live row, each output
         "bound_ms": bound_ms(k.shape[0] + live * 4 + buckets * 4)},
        launch, lambda: sk.partition_histogram(k, m, buckets),
        lambda: sk.partition_histogram_plain(k, m, buckets),
        lambda: torch.bincount(k, weights=w, minlength=buckets))


# the modules that call the histogram wrapper, each under its own name
HIST_CALLERS = ("spark_tpu_torch.ops.grouping", "spark_tpu_torch.ops.partition",
                "spark_tpu_torch.physical.operators")


def path_histograms(torch, sk, label: str, runs,
                    timed_shapes=None) -> tuple:
    """Phase 3 at a path's own inputs: one more run of each of `runs`
    ({tier: run}) keeps a copy of the inputs of each histogram call with a
    new (rows, buckets, live share to 1%), then each copy is held against
    the plain version, and timed as the kernel phase's cases are where its
    (rows, buckets) is not yet in `timed_shapes` (a set shared by the
    paths that pass one; None times every copy). Outside the counted run:
    the copies sync with the host. A run at the stage tier goes through
    `bodies_on_card`, so the calls inside graphs are seen at the replays'
    own inputs; a capture in it (a program the cache dropped) records
    nothing. Returns (the calls each run saw, the timed rows)."""
    import importlib

    mods = [importlib.import_module(name) for name in HIST_CALLERS]
    seen, inputs = set(), []
    calls = dict.fromkeys(runs, 0)
    at = []

    def keep(pids, mask, buckets):
        if torch.cuda.is_current_stream_capturing():
            return sk.partition_histogram(pids, mask, buckets)
        calls[at[-1]] += 1
        n, live = pids.shape[0], int(mask.sum())
        shape = (n, buckets, round(live / max(n, 1), 2))
        if shape not in seen:
            seen.add(shape)
            inputs.append((pids.to(torch.int32, copy=True).contiguous(),
                           mask.to(torch.bool, copy=True).contiguous(),
                           buckets, live))
        return sk.partition_histogram(pids, mask, buckets)

    for mod in mods:
        mod.partition_histogram = keep
    try:
        for tier, run in runs.items():
            at.append(tier)
            run()
    finally:
        for mod in mods:
            mod.partition_histogram = sk.partition_histogram
    rows = []
    for k, m, p, live in inputs:
        shape = f"{label}: {k.shape[0]:,} rows, P={p:,}, {live:,} live"
        if timed_shapes is None or (k.shape[0], p) not in timed_shapes:
            if timed_shapes is not None:
                timed_shapes.add((k.shape[0], p))
            rows.append(hist_row(torch, sk, shape, k, m, p))
        else:
            hist_check(torch, sk, shape, k, m, p)
    print(f"{label}: the histogram equals its plain version at "
          f"{len(inputs)} path inputs ({len(rows)} timed; calls seen: "
          f"{json.dumps(calls)})", flush=True)
    return calls, rows


def check_kernels(torch, sk):
    """Phase 3: each kernel against its plain version on the card, then
    its times (see `timed`) and the bound."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)

    def on_card(arr, off):
        # a view `off` elements into its storage: off > 0 leaves the
        # data pointer off 16-byte alignment
        full = np.concatenate([np.zeros(off, arr.dtype), arr])
        return torch.from_numpy(full).to(dev)[off:]

    def hist_case(label, n, buckets, live_frac, key_hi=None, key_off=0,
                  mask_off=0):
        keys = rng.integers(0, key_hi or buckets, n).astype(np.int32)
        mask = rng.random(n) < live_frac
        k, m = on_card(keys, key_off), on_card(mask, mask_off)
        # keys >= buckets clip into the padded tail and are dropped
        got = sk.partition_histogram(k, m, buckets)
        if int(got.sum()) != int((mask & (keys < buckets)).sum()):
            fail(f"partition_histogram {label}: the counts do not add up")
        return hist_row(torch, sk, label, k, m, buckets)

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
    return main_hist, main_sum


BIT_KINDS = ("and", "or", "xor")
BIT_LIBRARY = "none: torch has no bitwise segment reduce"


def bit_values(rng, seg, segs: int, dtype, negative: bool = False):
    """Values of low entropy for the bit kernel's checks, one per segment
    id of `seg`: each segment's random base with four bits of its own
    flipped at random in each row, so AND and OR differ from segment to
    segment (full-width random values give AND 0 and OR -1 in every
    segment of more than a few rows, which a kernel could return without
    reducing). `negative`: every value below 0 (the sign bit is set in
    each base and never flipped)."""
    import numpy as np

    info = np.iinfo(dtype)
    udt = np.dtype(f"uint{info.bits}")
    base = rng.integers(0, np.iinfo(udt).max, segs, dtype=udt, endpoint=True)
    span = info.bits - 1 if negative else info.bits
    if negative:
        base |= udt.type(1) << udt.type(info.bits - 1)
    flip = np.zeros(segs, udt)
    for _ in range(4):
        flip |= udt.type(1) << rng.integers(0, span, segs).astype(udt)
    noise = rng.integers(0, np.iinfo(udt).max, len(seg), dtype=udt,
                         endpoint=True)
    return (base[seg] ^ (noise & flip[seg])).view(dtype)


def sorted_ids(rng, n: int, segs: int, run: int, jitter: bool = False):
    """int32 segment ids sorted into runs of `run` equal ids (with
    `jitter`, of run/2 to 3run/2 at random), as a sorted-segment flow hands
    them to the bit kernel: the runs' ids spread evenly over [0, segs), and
    wrap around where there are more runs than segments."""
    import numpy as np

    lo = max(run // 2, 1) if jitter else run
    lens = (rng.integers(lo, run + run // 2 + 1, n // lo + 1) if jitter
            else np.full(n // run + 1, run))
    k = int(np.searchsorted(np.cumsum(lens), n)) + 1
    ids = (np.arange(k, dtype=np.int64) * segs // k if k <= segs
           else np.arange(k, dtype=np.int64) % segs)
    return np.repeat(ids, lens[:k])[:n].astype(np.int32)


def bits_bare_launch(torch, sk, v, m, g, segs: int, kind: str, count):
    """(launch, out): the bit kernel's C entry point on the current stream
    into `out`, allocated here once, with no checks and no launch count;
    for timing the kernel alone. Takes contiguous int64 values, a bool
    mask, int32 segment ids and int32 counts on the current device."""
    out = torch.empty(segs, dtype=torch.int64, device=v.device)
    lib = sk._bits_lib()
    k = sk.BIT_KINDS.index(kind)

    def launch():
        return lib.spark_segment_bits_i64(
            v.data_ptr(), g.data_ptr(), m.data_ptr(), v.shape[0], segs, k,
            count.data_ptr(), out.data_ptr(), sk._stream(v))
    if launch() != 0:
        fail(f"the bit kernel's bare launch at {segs} segments failed")
    torch.cuda.synchronize()
    return launch, out


# inputs whose plain version runs whole: n x 64 planes and segs x 64 sums
PLAIN_BITS_ROWS = 1 << 22
PLAIN_BITS_SEGMENTS = 1 << 21


def plain_fits(n: int, segs: int) -> bool:
    return n <= PLAIN_BITS_ROWS and segs <= PLAIN_BITS_SEGMENTS


def plain_bits(torch, sk, v, m, g, segs: int, kind: str):
    """The plain version's result on the card tensors. Where its [n, 64]
    bit planes and [segs, 64] sums would not fit beside the leg's tables
    (a sorted-segment tile of 2^25 rows and segments), it runs on chunks
    of PLAIN_BITS_ROWS rows over the segments that hold a weighted row,
    numbered densely, and the chunks' results merge by the reduce itself
    (an AND over the chunks where the segment has a row)."""
    if plain_fits(v.shape[0], segs):
        return sk.segment_bits_plain(v, m, g, segs, kind)
    gi = g.to(torch.int64)
    w = m & (gi >= 0) & (gi < segs)
    used, dense = torch.unique(torch.where(w, gi, torch.full_like(gi, -1)),
                               return_inverse=True)
    k = used.shape[0]
    acc = torch.full((k,), -1 if kind == "and" else 0, dtype=torch.int64,
                     device=v.device)
    has = torch.zeros(k, dtype=torch.bool, device=v.device)
    op = {"and": torch.bitwise_and, "or": torch.bitwise_or,
          "xor": torch.bitwise_xor}[kind]
    for lo in range(0, v.shape[0], PLAIN_BITS_ROWS):
        sl = slice(lo, lo + PLAIN_BITS_ROWS)
        part = sk.segment_bits_plain(v[sl], w[sl], dense[sl], k, kind)
        here = torch.zeros(k, dtype=torch.bool, device=v.device)
        here.index_fill_(0, dense[sl][w[sl]], True)
        acc = torch.where(here, op(acc, part), acc)
        has |= here
    out = torch.zeros(segs, dtype=torch.int64, device=v.device)
    keep = used >= 0
    out[used[keep]] = torch.where(has, acc, torch.zeros_like(acc))[keep]
    return out


def bits_check(torch, sk, label: str, v, m, g, segs: int, kind: str):
    """segment_bits on the card tensors held against its plain version
    (the reference's bit-plane reduce on the same tensors, `plain_bits`),
    exactly; returns the histogram's counts and the plain result."""
    count = sk.partition_histogram(g, m, segs)
    got = sk.segment_bits(v, m, g, segs, kind, count)
    exp = plain_bits(torch, sk, v, m, g, segs, kind)
    torch.cuda.synchronize()
    if not torch.equal(got, exp):
        bad = int((got != exp).sum())
        fail(f"segment_bits {label} ({kind}): {bad} of {segs} segments "
             "differ from the plain version")
    return count, exp


def bits_row(torch, sk, label: str, v, m, g, segs: int, kind: str) -> dict:
    """`bits_check`, the bare launch too, then its times: device_ms (the
    kernel alone: fill, reduce and, for AND, the clearing kernel),
    call_ms (the wrapper), the plain version's device_ms; no library
    call computes this function. The bound counts the bytes the function
    needs: each mask byte, the value and segment id of each weighted row,
    each output's 8 bytes."""
    count, exp = bits_check(torch, sk, label, v, m, g, segs, kind)
    vv = v.to(torch.int64).contiguous()
    launch, bare = bits_bare_launch(torch, sk, vv, m, g, segs, kind, count)
    if not torch.equal(bare, exp):
        fail(f"segment_bits {label} ({kind}): the bare launch differs")
    n, live = v.shape[0], int(m.sum())
    row = {"kernel": "segment_bits", "shape": f"{label}, {kind}",
           "kind": kind, "rows": n, "segments": segs,
           "live_rows": live, "max_abs_err": 0,
           "bound_ms": bound_ms(n + live * (v.element_size() + 4)
                                + segs * 8),
           "device_ms": device_ms(launch),
           "call_ms": call_ms(lambda: sk.segment_bits(v, m, g, segs, kind,
                                                      count)),
           "plain_ms": device_ms(lambda: sk.segment_bits_plain(
               v, m, g, segs, kind), iters=10) if plain_fits(n, segs)
           else "not measured: its [n, 64] planes do not fit beside the "
                "leg's tables",
           "library_ms": None, "library": BIT_LIBRARY}
    row["ms"] = row["device_ms"]
    row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
    print("kernel " + json.dumps(row), flush=True)
    return row


def check_bit_kernel(torch, sk) -> dict:
    """Phase 3 for the bit kernel: each kind against the plain version at
    2^22 rows and 8, 1,024 and 2^21 segments, 58% live, and at the two
    flows of 2^25 rows, 86% live, that the aggregates leg hands it: ids
    sorted into runs of about 565 over 2^25 segments (a whole program's
    sorted-segment flow) and one segment (the ungrouped reduce) (timed),
    then all-masked input, all-negative values, int32 values, misaligned views
    and masked rows whose ids lie outside the segments (checked), and one
    case inside a captured CUDA graph, equal to the eager call. Returns
    the row the kernels line reports (1,024 segments, AND)."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    n = 1 << 22

    def inputs(segs, live, dtype=np.int64, negative=False, stray=False):
        seg = rng.integers(0, segs, n).astype(np.int32)
        vals = bit_values(rng, seg, segs, dtype, negative)
        mask = rng.random(n) < live
        if stray:
            off = ~mask & (rng.random(n) < 0.5)
            seg[off] = rng.choice(np.array([-7, segs, segs + 100],
                                           np.int32), int(off.sum()))
        return vals, mask, seg

    def card(arr, off=0):
        full = np.concatenate([np.zeros(off, arr.dtype), arr])
        return torch.from_numpy(full).to(dev)[off:]

    rows, main = [], None
    for segs in (8, 1024, 1 << 21):
        vals, mask, seg = inputs(segs, 0.58)
        v, m, g = card(vals), card(mask), card(seg)
        for kind in BIT_KINDS:
            label = f"2^22 rows, {segs:,} segments, 58% live"
            row = bits_row(torch, sk, label, v, m, g, segs, kind)
            rows.append(row)
            if segs == 1024 and kind == "and":
                main = row
    big = 1 << 25
    for label, seg, segs in (
            ("2^25 rows sorted into runs of about 565 over 2^25 segments, "
             "86% live", sorted_ids(rng, big, big, 565, jitter=True), big),
            ("2^25 rows, 1 segment, 86% live", np.zeros(big, np.int32), 1)):
        vals = bit_values(rng, seg, segs, np.int64)
        v = card(vals)
        m = card(rng.random(big) < 0.86)
        g = card(seg)
        for kind in BIT_KINDS:
            rows.append(bits_row(torch, sk, label, v, m, g, segs, kind))
        del v, m, g
    checks = 0
    for kind in BIT_KINDS:
        for label, (vals, mask, seg), off in (
                ("all masked", inputs(1024, 0.0), 0),
                ("all negative", inputs(1024, 0.58, negative=True), 0),
                ("int32 values", inputs(1024, 0.58, np.int32), 0),
                ("masked ids outside the segments",
                 inputs(1024, 0.58, stray=True), 0),
                ("values[1:] ids[1:] mask[3:]", inputs(8, 0.58), 1)):
            v = card(vals, off)
            m = card(mask, 3 if off else 0)
            g = card(seg, off)
            bits_check(torch, sk, f"2^22 rows, {label}", v, m, g,
                       1024 if "[1:]" not in label else 8, kind)
            checks += 1
    # one case inside a captured graph: the replay equals the eager call
    vals, mask, seg = inputs(1024, 0.58)
    v, m, g = card(vals), card(mask), card(seg)
    sk.prepare(dev)
    count = sk.partition_histogram(g, m, 1024)
    eager = sk.segment_bits(v, m, g, 1024, "xor", count)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c2 = sk.partition_histogram(g, m, 1024)
        out = sk.segment_bits(v, m, g, 1024, "xor", c2)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, eager):
        fail("segment_bits: the graph replay differs from the eager call")
    print(f"segment_bits: {len(rows)} timed cases and {checks} more equal "
          "the plain version; a captured graph's replay equals the eager "
          "call", flush=True)
    return main


# --- the bloom runtime filter's kernel (csrc/bloom_filter.cu) --------------

BLOOM_LIBRARY = "none: torch has no call that builds or probes a bloom bitset"


def bloom_bare(torch, h, m, nbits, off0, off1, bits=None):
    """(launch, out): `launch()` runs the build (bits None) or the probe
    entry point once on the current stream into outputs allocated here
    once, with no checks and no launch count; for timing the kernel alone.
    Takes a contiguous int64 h and bool m on the current device."""
    from spark_tpu_torch.ops import bloom as B
    from spark_tpu_torch.ops.scatter_kernels import _stream

    lib, n = B._lib(), h.shape[0]
    if bits is None:
        out = torch.empty(nbits, dtype=torch.uint8, device=h.device)

        def launch():
            return lib.spark_bloom_build(h.data_ptr(), m.data_ptr(), n,
                                         nbits, off0, off1, out.data_ptr(),
                                         _stream(h))
    else:
        out = (torch.empty(n, dtype=torch.bool, device=h.device),
               torch.empty(1, dtype=torch.int64, device=h.device))

        def launch():
            return lib.spark_bloom_probe(
                bits.data_ptr(), h.data_ptr(), m.data_ptr(), n, nbits, off0,
                off1, out[0].data_ptr(), out[1].data_ptr(), _stream(h))
    if launch() != 0:
        fail(f"the bloom bare launch at n={n}, nbits={nbits} failed")
    torch.cuda.synchronize()
    return launch, out


def bloom_check(torch, label: str, h, m, nbits: int, bits=None):
    """The build (bits None) or the probe on the card tensors held against
    its plain version exactly: every bit, or every mask byte and the live
    count. Returns the plain result."""
    from spark_tpu_torch.ops import bloom as B
    from spark_tpu_torch.utils.sketch import bloom_position_offsets

    off0, off1 = bloom_position_offsets(2)
    if bits is None:
        got = B.bloom_build(h, m, nbits, off0, off1)
        exp = B.bloom_build_plain(h, m, nbits, off0, off1)
        torch.cuda.synchronize()
        if not torch.equal(got, exp):
            fail(f"bloom_build {label}: {int((got != exp).sum())} of "
                 f"{nbits} bits differ from the plain version")
        return exp
    got, live = B.bloom_probe(bits, h, m, nbits, off0, off1)
    exp, exp_live = B.bloom_probe_plain(bits, h, m, nbits, off0, off1)
    torch.cuda.synchronize()
    if not (torch.equal(got, exp) and torch.equal(live, exp_live)):
        fail(f"bloom_probe {label}: {int((got != exp).sum())} mask bytes "
             f"differ, live {int(live)} against {int(exp_live)}")
    return exp, exp_live


def bloom_row(torch, label: str, h, m, nbits: int, bits=None) -> dict:
    """`bloom_check`, the bare launch too, then its times: device_ms (the
    entry point alone: its memset and kernel), call_ms (the wrapper),
    the plain version's device_ms; no library call computes it. The
    bound: 9 B a row read (hash and mask) plus nbits bytes written for
    the build, 1 B a row and the count for the probe; the bitset (at most
    16 MiB) stays in the 50 MB L2, so its scattered stores and gathers
    are left out."""
    from spark_tpu_torch.ops import bloom as B
    from spark_tpu_torch.utils.sketch import bloom_position_offsets

    off0, off1 = bloom_position_offsets(2)
    exp = bloom_check(torch, label, h, m, nbits, bits)
    hh, mm = h.to(torch.int64).contiguous(), m.to(torch.bool).contiguous()
    launch, bare = bloom_bare(torch, hh, mm, nbits, off0, off1, bits)
    same = torch.equal(bare, exp) if bits is None else (
        torch.equal(bare[0], exp[0]) and torch.equal(bare[1], exp[1]))
    if not same:
        fail(f"bloom {label}: the bare launch differs")
    n = h.shape[0]
    build = bits is None
    row = {"kernel": "bloom_build" if build else "bloom_probe",
           "shape": label, "rows": n, "nbits": nbits,
           "live_rows": int(m.sum()), "max_abs_err": 0,
           "bound_ms": bound_ms(n * 9 + (nbits if build else n + 8)),
           "bound_note": "bitset gathers and stores in L2, left out",
           "device_ms": device_ms(launch),
           "call_ms": call_ms(
               (lambda: B.bloom_build(h, m, nbits, off0, off1)) if build
               else (lambda: B.bloom_probe(bits, h, m, nbits, off0, off1))),
           "plain_ms": device_ms(
               (lambda: B.bloom_build_plain(h, m, nbits, off0, off1))
               if build else (lambda: B.bloom_probe_plain(
                   bits, h, m, nbits, off0, off1)), iters=20),
           "library_ms": None, "library": BLOOM_LIBRARY}
    row["ms"] = row["device_ms"]
    row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
    print("kernel " + json.dumps(row), flush=True)
    return row


def check_bloom_kernel(torch, sk) -> dict:
    """Phase 3 for the bloom kernel: build at 131,072 rows (nbits 2^20) and
    2^21 rows (nbits 2^24), probe at 2^22 and 2^25 rows against each, at
    0%, 58% and 100% live (timed at 58%), then duplicate keys, misaligned
    views and one build and probe inside a captured CUDA graph (checked),
    each held to the plain version exactly. Returns the rows the kernels
    line reports (the build and probe at 2^21 rows, 2^24 bits, 2^25
    probe rows, 58% live)."""
    import numpy as np

    from spark_tpu_torch.ops import bloom as B
    from spark_tpu_torch.utils.sketch import bloom_position_offsets

    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    off0, off1 = bloom_position_offsets(2)

    def card(arr, off=0):
        full = np.concatenate([np.zeros(off, arr.dtype), arr])
        return torch.from_numpy(full).to(dev)[off:]

    def hashes(n, distinct=None):
        h = rng.integers(-(1 << 63), (1 << 63) - 1, distinct or n,
                         dtype=np.int64)
        return h if distinct is None else rng.choice(h, n)

    main, checks = {}, 0
    for nb, nbits, npr in ((131_072, 1 << 20, 1 << 22),
                           (1 << 21, 1 << 24, 1 << 25)):
        bh = hashes(nb)
        for live in (0.0, 0.58, 1.0):
            label = f"{nb:,} build rows, nbits {nbits:,}, {live:.0%} live"
            h, m = card(bh), card(rng.random(nb) < live)
            if live == 0.58:
                build_row = bloom_row(torch, label, h, m, nbits)
            else:
                bloom_check(torch, label, h, m, nbits)
                checks += 1
            bits = B.bloom_build(h, m, nbits, off0, off1)
            # a quarter of the probe rows are build keys
            ph = hashes(npr)
            ph[: npr // 4] = rng.choice(bh, npr // 4)
            ph_d, pm = card(ph), card(rng.random(npr) < live)
            plabel = f"{npr:,} probe rows, nbits {nbits:,}, {live:.0%} live"
            if live == 0.58:
                probe_row = bloom_row(torch, plabel, ph_d, pm, nbits, bits)
                if nb == 1 << 21:
                    main = {"bloom_build": build_row,
                            "bloom_probe": probe_row}
            else:
                bloom_check(torch, plabel, ph_d, pm, nbits, bits)
                checks += 1
            del ph_d, pm
    # duplicate keys, and views off 16-byte alignment
    for label, bh, off in (("duplicate keys", hashes(1 << 21, 1 << 12), 0),
                           ("h[1:] mask[1:]", hashes(1 << 21), 1)):
        h, m = card(bh, off), card(rng.random(1 << 21) < 0.58, off)
        bits = bloom_check(torch, f"2^21 build rows, {label}", h, m, 1 << 24)
        ph = card(np.concatenate([bh, hashes(1 << 21)]), off)
        pm = card(rng.random(1 << 22) < 0.58, off)
        bloom_check(torch, f"2^22 probe rows, {label}", ph, pm, 1 << 24,
                    bits)
        checks += 2
    # build and probe inside a captured graph: the replay equals the
    # plain versions
    h, m = card(hashes(131_072)), card(rng.random(131_072) < 0.58)
    ph, pm = card(hashes(1 << 22)), card(rng.random(1 << 22) < 0.58)
    ph[:131_072] = h
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gbits = B.bloom_build(h, m, 1 << 20, off0, off1)
        gout, glive = B.bloom_probe(gbits, ph, pm, 1 << 20, off0, off1)
    gout.zero_()
    graph.replay()
    torch.cuda.synchronize()
    exp_bits = B.bloom_build_plain(h, m, 1 << 20, off0, off1)
    exp, exp_live = B.bloom_probe_plain(exp_bits, ph, pm, 1 << 20, off0,
                                        off1)
    if not (torch.equal(gbits, exp_bits) and torch.equal(gout, exp)
            and torch.equal(glive, exp_live)):
        fail("bloom: the graph replay differs from the plain version")
    print(f"bloom: 4 timed cases and {checks + 1} more equal the plain "
          "version exactly; a captured graph's replay equals it", flush=True)
    return main


def path_blooms(torch, label: str, runs) -> int:
    """The bloom kernel at a path's own inputs: one more run of each of
    `runs` keeps a copy of the inputs of every bloom_build and
    bloom_probe call, then holds each copy against the plain version
    exactly and times its bare launch beside its bound (`bloom_row`'s).
    Returns the number of inputs held."""
    from spark_tpu_torch.ops import bloom as B

    real_build, real_probe = B.bloom_build, B.bloom_probe
    kept = []

    def build(h, mask, nbits, off0, off1):
        kept.append(("build", h.clone(), mask.clone(), nbits, None))
        return real_build(h, mask, nbits, off0, off1)

    def probe(bits, h, mask, nbits, off0, off1):
        kept.append(("probe", h.clone(), mask.clone(), nbits, bits.clone()))
        return real_probe(bits, h, mask, nbits, off0, off1)

    B.bloom_build, B.bloom_probe = build, probe
    try:
        for run in runs:
            run()
    finally:
        B.bloom_build, B.bloom_probe = real_build, real_probe
    from spark_tpu_torch.utils.sketch import bloom_position_offsets

    off0, off1 = bloom_position_offsets(2)
    timed = []
    for kind, h, m, nbits, bits in kept:
        bloom_check(torch, f"{label} {kind}: {h.shape[0]:,} rows, "
                    f"nbits {nbits:,}", h, m, nbits, bits)
        hh, mm = h.to(torch.int64).contiguous(), m.contiguous()
        launch, _ = bloom_bare(torch, hh, mm, nbits, off0, off1, bits)
        n = h.shape[0]
        timed.append({"kind": kind, "rows": n, "nbits": nbits,
                      "live_rows": int(m.sum()),
                      "device_ms": device_ms(launch),
                      "bound_ms": bound_ms(n * 9 + (
                          nbits if bits is None else n + 8))})
    print(f"{label}: the bloom kernel equals its plain version at "
          f"{len(kept)} path inputs " + json.dumps(timed), flush=True)
    return len(kept)


RUN_LIBRARY = "none: no torch call computes run starts"


def run_bare(torch, sk, k, m):
    """(launch, (start, seg, groups)): `launch()` runs the run-layout C
    entry point once on the current stream into outputs and scratch
    allocated here once, with no checks and no launch count; for timing
    the kernel alone. Takes a contiguous int32 or int64 key and bool mask
    on the current device."""
    lib, n = sk._run_lib(), k.shape[0]
    start = torch.empty(n, dtype=torch.bool, device=k.device)
    seg = torch.empty(n, dtype=torch.int64, device=k.device)
    groups = torch.empty(1, dtype=torch.int64, device=k.device)
    scratch = torch.empty(max(lib.spark_run_layout_scratch_bytes(n), 1),
                          dtype=torch.uint8, device=k.device)
    fn = lib.spark_run_layout_i64 if k.dtype == torch.int64 \
        else lib.spark_run_layout_i32

    def launch():
        return fn(k.data_ptr(), m.data_ptr(), n, start.data_ptr(),
                  seg.data_ptr(), groups.data_ptr(), scratch.data_ptr(),
                  sk._stream(k))
    if launch() != 0:
        fail(f"the run_layout bare launch at n={n} failed")
    torch.cuda.synchronize()
    return launch, (start, seg, groups.reshape(()))


def run_check(torch, sk, label: str, k, m):
    """run_layout on the card tensors held against its plain version
    exactly: every start flag, every group id and the group count.
    Returns the plain result."""
    got = sk.run_layout(k, m)
    exp = sk.run_layout_plain(k, m)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, exp)):
        fail(f"run_layout {label}: {int((got[0] != exp[0]).sum())} start "
             f"flags and {int((got[1] != exp[1]).sum())} ids differ, "
             f"{int(got[2])} groups against {int(exp[2])}")
    return exp


def run_row(torch, sk, card: str, label: str, k, m) -> dict:
    """`run_check`, the bare launch too, then its times: device_ms (the
    entry point alone: its three kernels), call_ms (the wrapper), the
    plain version's device_ms; no library call computes it. The bound:
    each row's key and mask byte read once, its start byte and 8-byte id
    written once, over 3.35 TB/s."""
    exp = run_check(torch, sk, label, k, m)
    kk = k.contiguous()
    launch, bare = run_bare(torch, sk, kk, m.contiguous())
    if not all(torch.equal(a, b) for a, b in zip(bare, exp)):
        fail(f"run_layout {label}: the bare launch differs")
    n = k.shape[0]
    row = {"kernel": "run_layout", "shape": label, "rows": n,
           "key_bytes": kk.element_size(), "live_rows": int(m.sum()),
           "groups": int(exp[2]), "max_abs_err": 0,
           "bound_ms": bound_ms(n * (kk.element_size() + 1) + n * 9 + 8),
           "device_ms": device_ms(launch),
           "call_ms": call_ms(lambda: sk.run_layout(k, m)),
           "plain_ms": device_ms(lambda: sk.run_layout_plain(k, m),
                                 iters=20),
           "library_ms": None, "library": RUN_LIBRARY, "card": card}
    row["ms"] = row["device_ms"]
    row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
    print("kernel " + json.dumps(row), flush=True)
    return row


def sorted_run_keys(rng, n: int, lo: int = 1, hi: int = 21):
    """n int64 keys in sorted runs of lo..hi-1 rows, the gaps between run
    keys uniform in [16, 112), as the sorted_runs leg's order ids."""
    import numpy as np

    lens = rng.integers(lo, hi, n // lo + 1)
    return np.repeat(np.cumsum(rng.integers(16, 112, len(lens))), lens)[:n]


def check_run_layout(torch, sk, card: str) -> dict:
    """The run-layout kernel's phase: sorted runs of 1-20 rows at 2^22
    and 2^25 rows, 99% live (timed, int64 keys; 2^22 int32 too), then one
    run of every row, every row masked, masked rows inside runs, runs
    whose rows are all masked, ragged ends, an unsorted key, misaligned
    views and one layout inside a captured CUDA graph, each equal to the
    plain version exactly. Returns the row the kernels line reports (2^22
    rows, the sorted_runs leg's tile)."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(31)

    def on_card(arr, off=0):
        full = np.concatenate([np.zeros(off, arr.dtype), arr])
        return torch.from_numpy(full).to(dev)[off:]

    rows = {}
    for n in (1 << 22, 1 << 25):
        key = sorted_run_keys(rng, n)
        live = rng.random(n) < 0.99
        rows[n] = run_row(torch, sk, card, f"{n:,} rows, sorted runs of "
                          "1-20, 99% live, int64", on_card(key),
                          on_card(live))
        if n == 1 << 22:
            run_row(torch, sk, card, f"{n:,} rows, sorted runs of 1-20, "
                    "99% live, int32", on_card(key.astype(np.int32)),
                    on_card(live))
    checks = 0
    for n in (1, 1023, 1024, 1025, 1_000_003, 1 << 22):
        key = sorted_run_keys(rng, n)
        whole_runs = np.isin(key, np.unique(key)[::3])
        cases = {
            "one run": (np.full(n, 7, np.int64), rng.random(n) < 0.5),
            "every row masked": (key, np.zeros(n, bool)),
            "masked rows inside runs": (key, rng.random(n) < 0.6),
            "runs all masked": (key, ~whole_runs & (rng.random(n) < 0.9)),
            "int32": (key.astype(np.int32), rng.random(n) < 0.7),
            "unsorted": (rng.integers(0, 4, n), rng.random(n) < 0.6),
            "negative": (key - (1 << 40), rng.random(n) < 0.8),
        }
        for label, (k, m) in cases.items():
            run_check(torch, sk, f"{n:,} rows, {label}", on_card(k),
                      on_card(m))
            checks += 1
        run_check(torch, sk, f"{n:,} rows, key[1:] mask[3:]",
                  on_card(key, 1), on_card(rng.random(n) < 0.7, 3))
        checks += 1
    # a layout inside a captured graph: the replay equals the plain version
    n = 1 << 22
    k = on_card(sorted_run_keys(rng, n))
    m = on_card(rng.random(n) < 0.8)
    sk.run_layout(k, m)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gout = sk.run_layout(k, m)
    for t in gout:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    exp = sk.run_layout_plain(k, m)
    if not all(torch.equal(a, b) for a, b in zip(gout, exp)):
        fail("run_layout: the graph replay differs from the plain version")
    print(f"run_layout: 3 timed cases and {checks} more equal the plain "
          "version exactly; a captured graph's replay equals it "
          f"({card})", flush=True)
    return rows[1 << 22]


def path_runs(torch, sk, label: str, run) -> list:
    """The run-layout kernel at a path's own inputs: one more `run()`
    keeps a copy of the inputs of every run_layout call, then holds each
    against the plain version exactly and times the first's bare launch.
    Returns the rows (rows, live rows, groups, bound_ms; device_ms of the
    first)."""
    import spark_tpu_torch.ops.grouping as G

    real, kept = G.run_layout, []

    def record(key, row_mask):
        kept.append((key.clone(), row_mask.clone()))
        return real(key, row_mask)

    G.run_layout = record
    try:
        run()
    finally:
        G.run_layout = real
    out = []
    for i, (k, m) in enumerate(kept):
        exp = run_check(torch, sk, f"{label}: {k.shape[0]:,} rows", k, m)
        n = k.shape[0]
        row = {"rows": n, "live_rows": int(m.sum()), "groups": int(exp[2]),
               "bound_ms": bound_ms(n * (k.element_size() + 1) + n * 9 + 8)}
        if i == 0:  # the inputs share one shape: the first is timed
            launch, _ = run_bare(torch, sk, k.contiguous(), m.contiguous())
            row["device_ms"] = device_ms(launch)
        out.append(row)
    print(f"{label}: the run-layout kernel equals its plain version at "
          f"{len(kept)} path inputs " + json.dumps(out), flush=True)
    return out


TIER = "spark.tpu.compile.tier"


class tier_set:
    """`with tier_set(spark, "operator"):` the session's compile tier set
    for the block, its earlier setting restored after."""

    def __init__(self, spark, tier: str):
        self.spark, self.tier = spark, tier

    def __enter__(self):
        self.had = self.spark.conf.get(TIER)
        self.spark.conf.set(TIER, self.tier)

    def __exit__(self, *exc):
        self.spark.conf.set(TIER, self.had)


def stage_counters() -> dict:
    from spark_tpu_torch.physical.compile import STAGE_CACHE

    return STAGE_CACHE.counters()


@contextlib.contextmanager
def bodies_on_card(torch, sk, check=None):
    """For the block, every fused program replays as usual and then runs
    its body once more eagerly on the card over the same inputs, so the
    kernel wrappers inside it run in Python at the replay's own inputs;
    the eager run's histogram calls are not counted. `check(name,
    replayed, eager)` sees both results, when given."""
    from spark_tpu_torch.physical.compile import STAGE_CACHE
    from spark_tpu_torch.utils.cuda_graph import as_tensors

    replay = STAGE_CACHE.run

    def run(name, key, fn, inputs, device):
        out = replay(name, key, fn, inputs, device)
        before = dict(sk.LAUNCHES)
        try:
            want = list(fn([x if x is None or x.is_cuda else x.to(device)
                            for x in as_tensors(inputs)]))
        finally:
            sk.LAUNCHES.update(before)
        if check is not None:
            check(name, out, want)
        return out

    STAGE_CACHE.run = run
    try:
        yield
    finally:
        del STAGE_CACHE.run


@contextlib.contextmanager
def copies_timed(torch, events: list):
    """For the block, each graph replay's copies in and out are timed with
    device events, appended to `events` as (kind, start, end) and read
    after the block."""
    from spark_tpu_torch.utils.cuda_graph import CapturedProgram

    copy_in, copy_out = CapturedProgram.copy_in, CapturedProgram.copy_out

    def timed(kind, f):
        def run(self, *args):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = f(self, *args)
            ev[1].record()
            events.append((kind, ev[0], ev[1]))
            return out
        return run

    CapturedProgram.copy_in = timed("copy_in", copy_in)
    CapturedProgram.copy_out = timed("copy_out", copy_out)
    try:
        yield
    finally:
        CapturedProgram.copy_in, CapturedProgram.copy_out = copy_in, copy_out


def plan_nodes(df) -> list:
    """The plan's operators, through a whole-query program into its inner
    plan (which is no child of it)."""
    from spark_tpu_torch.physical.whole_query import plan_nodes as nodes

    return list(nodes(df.query_execution.physical))


def plan_ops(df) -> tuple:
    """The plan's operator sequence as TPCDS_PLAN_OPS writes it: a whole
    program's name, then its inner plan's operators."""
    p = df.query_execution.physical
    head = ("WholeQueryExec",) if type(p).__name__ == "WholeQueryExec" \
        else ()
    return head + tuple(type(n).__name__ for n in plan_nodes(df))


def fused_stages(df) -> list:
    """The plan's fused operators (a fused aggregate or limit, a join
    with its probe pipeline, an exchange with its map pipeline), inside a
    whole program too."""
    return [n.simple_string()[:60] for n in plan_nodes(df)
            if type(n).__name__.startswith("Fused")
            or getattr(n, "probe_fusion", None) is not None
            or getattr(n, "pipe_fusion", None) is not None]


def decision_report(df) -> dict:
    """The plan's compile-tier decision: tier, reason, volume_rows and
    est_resident_bytes where the cost model got that far, and the cause of
    a run-time degrade to the stage tier, if one happened."""
    d = df.query_execution.tier_decision
    return {"tier": d.tier, "reason": d.reason,
            "volume_rows": d.details.get("volume_rows"),
            "est_resident_bytes": d.details.get("est_resident_bytes"),
            "runtime_degraded": d.details.get("runtime_degraded")}


# the stage scheduler's and AQE's counters each counted run reports: its
# stage count, the four AQE decisions, and the stage retries (held to 0)
SCHED_METRICS = ("scheduler.stages_completed", "scheduler.stage_retries",
                 "aqe.partitions_coalesced", "aqe.broadcast_demotions",
                 "aqe.probe_shuffles_elided", "aqe.skew_splits")


def sched_report(sched: dict) -> dict:
    """The stage count and AQE counters of a counted run, short keys."""
    return {"stages": sched["scheduler.stages_completed"],
            "stage_retries": sched["scheduler.stage_retries"],
            **{k.split(".", 1)[1]: sched[k] for k in SCHED_METRICS[2:]}}


WHOLE_METRICS = ("whole_query.dispatches", "whole_query.capacity_retries",
                 "whole_query.runtime_degraded")


def once(fn):
    """`fn()`, computed at the first call and kept: a leg's numpy oracle
    holds every tier's run of the same query."""
    box = []

    def get():
        if not box:
            box.append(fn())
        return box[0]
    return get


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def counted_run(torch, sk, spark, run):
    """(result, seconds, histogram launches, stage report) of one run with
    the launch counts set to 0 just before and read just after, beside the
    stage cache's counters, the operator dispatches and the batches the
    minRows gate sent to the unfused kernels. Each fused dispatch must be
    one graph replay."""
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    c0, l0, m0 = stage_counters(), spark.launches.snapshot(), spark.metrics
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    cache = _delta(stage_counters(), c0)
    for gauge in ("stage_cache.entries", "stage_cache.held_bytes"):
        cache.pop(gauge, None)  # levels, not counts
    dispatches = _delta(spark.launches.snapshot(), l0)
    m1 = spark.metrics
    gated = m1.get("fusion.min_rows_gated", 0) - \
        m0.get("fusion.min_rows_gated", 0)
    whole = {k.split(".")[1]: m1.get(k, 0) - m0.get(k, 0)
             for k in WHOLE_METRICS}
    sched = {k: m1.get(k, 0) - m0.get(k, 0) for k in SCHED_METRICS}
    if sched["scheduler.stage_retries"]:
        fail(f"{sched['scheduler.stage_retries']} stage retries: a retry "
             "must not hide a fault")
    # a fused batch and a whole program's attempt are one replay each
    fused = sum(n for k, n in dispatches.items()
                if k.startswith("fused_") or k == "whole_query")
    if cache.get("stage_cache.replays", 0) != fused:
        fail(f"{cache.get('stage_cache.replays', 0)} graph replays for "
             f"{fused} fused and whole-program dispatches: each must be "
             "one replay")
    if not whole["runtime_degraded"] and \
            whole["dispatches"] != dispatches.get("whole_query", 0):
        fail(f"{whole['dispatches']} whole-query dispatches counted, "
             f"{dispatches.get('whole_query', 0)} made")
    return out, secs, launches, {"cache": cache, "dispatches": dispatches,
                                 "gated_batches": gated, "whole": whole,
                                 "sched": sched}


def busy_share(torch, run) -> dict:
    """Device busy s, wall s and idle share of one profiled run."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    if not kernels:
        return {"device_busy_s": "not measured", "profiled_wall_s": wall,
                "device_idle_share": "not measured"}
    busy = sum(k[0] for k in kernels) / 1e6
    return {"device_busy_s": busy, "profiled_wall_s": wall,
            "device_idle_share": 1 - busy / wall}


def same_tables(label: str, a, b, rel: float = 1e-9) -> None:
    """Two tiers' results equal row for row, both sorted by every column
    in order (the legs' leading columns are their keys): nulls and
    non-float columns exactly, floats to `rel` (float sums add in atomic
    order on the card)."""
    import numpy as np
    import pyarrow as pa

    if a.column_names != b.column_names or a.num_rows != b.num_rows:
        fail(f"{label}: the tiers' results differ in shape")
    if a.equals(b):
        return  # the same rows in the same order (the sort leg's 1e8)
    order = [(n, "ascending") for n in a.column_names]
    a, b = a.sort_by(order), b.sort_by(order)
    for name in a.column_names:
        x, y = a.column(name), b.column(name)
        if not np.array_equal(x.is_null().to_numpy(zero_copy_only=False),
                              y.is_null().to_numpy(zero_copy_only=False)):
            fail(f"{label}: the tiers' nulls differ in column {name}")
        xv = x.drop_null().to_numpy(zero_copy_only=False)
        yv = y.drop_null().to_numpy(zero_copy_only=False)
        same = np.allclose(xv, yv, rtol=rel, atol=0, equal_nan=True) \
            if pa.types.is_floating(x.type) else np.array_equal(xv, yv)
        if not same:
            fail(f"{label}: the tiers differ in column {name}")


def _warm(torch, run, n: int = 3) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def tier_run(torch, sk, card: str, label: str, spark, tier: str, run,
             histograms, check, first, post_check=None,
             timed: bool = True) -> dict:
    """The same query once more at `tier` in the same session (planned
    anew there): its histogram calls exactly `histograms`, its result to
    the oracle `check`, to `post_check(metrics delta)` where given and to
    the first tier's result `first`; 3 warm runs and a profiled one (none
    where not `timed`: the counted cold run and its checks only), printed
    as the `<label> <tier>` line. Returns the launch counts."""
    with tier_set(spark, tier):
        m0 = spark.metrics
        out, cold, launches, st = counted_run(torch, sk, spark, run)
        calls = launches["partition_histogram"]
        if calls != histograms:
            fail(f"{label} at the {tier} tier launched the histogram "
                 f"kernel {calls} times, not {histograms}")
        if tier == "operator" and st["cache"].get("stage_cache.replays", 0):
            fail(f"{label}: the operator tier replayed a graph")
        msg = check(out)
        if post_check is not None:
            msg += "; " + post_check(_delta(spark.metrics, m0))
        print(f"{label} {tier} tier: {msg}", flush=True)
        same_tables(label, first, out)
        if timed:
            warm = _warm(torch, run)
            busy, median = busy_share(torch, run), statistics.median(warm)
        else:
            cut = "not measured: cut for the script's time"
            warm, busy, median = [], {"device_idle_share": cut}, cut
        cc = st["cache"]
        print(f"{label} {tier} " + json.dumps(dict(
            busy, tier=tier, cold_s=cold,
            warm_median_s=median, warm_s=warm,
            dispatches=st["dispatches"], histogram_calls=calls,
            captures=cc.get("stage_cache.captures", 0),
            replays=cc.get("stage_cache.replays", 0),
            capture_ms=cc.get("stage_cache.capture_ms", 0.0),
            **sched_report(st["sched"]), card=card)), flush=True)
    return launches


def show_plan(label: str, df, plan_parts) -> dict:
    """Print the physical plan and the tier decision of `df`, assert the
    plan holds each of `plan_parts`, and return the decision."""
    plan = df.query_execution.physical.tree_string()
    decision = decision_report(df)
    print(f"{label} plan:\n{plan}", flush=True)
    print(f"{label} tier " + json.dumps(decision), flush=True)
    for part in plan_parts:
        if part not in plan:
            fail(f"{label}: the physical plan lacks {part}")
    return decision


def drive(torch, sk, card: str, label: str, df, rows: int, plan_parts,
          histograms, check, run=None, timed_shapes=None,
          profile: bool = True, operator=None, stage=None,
          stage_check=None, tiers_out=None, main_calls=None,
          warm_runs: int = 3, record_operator: bool = False,
          whole: bool = False, session=None,
          operator_timed: bool = True) -> dict:
    """One path through the DataFrame API at the session's tier (the
    default: `auto`, whose cost model picks whole, stage or operator per
    plan, printed with its reason): assert the physical plan holds each of
    `plan_parts`, run it cold with the launch counts set to 0 just before
    and read just after (the histogram wrapper must count exactly
    `histograms` calls, replays counted, or `histograms()` where it is a
    function of what the run recorded, or at least one where it is None;
    a whole program calls it never, so there exactly 0; each fused batch
    and each whole program's attempt must be one graph replay), hold the
    result to the oracle `check(table)`, then time `warm_runs` warm runs
    (none where the cold run degraded to the stage tier), print the
    breakdown (none without a warm run) (without its profiler pass where not `profile`) and the
    tier's report (the decision; whole dispatches, capacity retries and a
    degrade with its cause; fused stages, captures, replays, hits, gated
    batches, capture ms, the copies' device ms per replay in the last warm
    run, graph memory, pool resets, peak memory), and hold the histogram
    kernel at the path's own inputs (`path_histograms`: the stage tier's
    bodies run once more eagerly beside their replays, where the wrappers
    see the replays' inputs; and the operator tier). Where the plan is not
    at the stage tier and `stage` is given, the query runs once more at
    the stage tier in the same session (`tier_run`: its histogram calls
    exactly `stage`, `stage_check(metrics delta)` for the stage tier's own
    paths); where `whole` is set and the plan is not whole, once more at
    forced `whole` (no histogram call); where `operator` is given, once
    more at the operator tier (untimed where not `operator_timed`: its
    counted cold run and checks only).
    `run()` runs the path and returns its Arrow table (default:
    `df.toArrow`, over the plan made once; `main_calls()` then gives the
    histogram calls of the main plan alone in its last run). The SF10
    leg cuts its time with `warm_runs` (0 but for q3, q7 and q19: the
    cold run only, with every check). The histogram's path inputs are
    recorded from the stage tier's run, where the path has one: its
    operator tier's run records the same shapes and a whole program calls
    no kernel. A path with no stage run (parquet q3, q7 and q19: whole at
    `auto`, no `stage`) records them from an operator tier's run instead
    (`record_operator`). `df` is the path's DataFrame or, where each run
    makes its own (`run` parses anew: the SF10 queries whose sql() runs
    their CTE bodies or whose optimizer runs their scalar subqueries), a
    function giving the one the cold run made, whose plan is read after
    that run; `session` is then the session. Returns the launch counts of
    the first run; `tiers_out`, where given, gets each tier's, by tier."""
    from spark_tpu_torch.api.dataframe import DataFrame

    tiers_out = {} if tiers_out is None else tiers_out
    made = callable(df)
    spark = session if made else df.session
    custom = run is not None
    run = run or df.toArrow
    if not made:
        decision = show_plan(label, df, plan_parts)

    torch.cuda.reset_peak_memory_stats()
    held0 = stage_counters()["stage_cache.held_bytes"]
    m0 = spark.metrics
    out, cold_s, launches, st = counted_run(torch, sk, spark, run)
    if made:
        df = df()
        decision = show_plan(label, df, plan_parts)
    tier = decision["tier"]
    calls = launches["partition_histogram"]
    tiers_out[tier] = launches
    print(f"{label} launches {json.dumps(launches)}; operator dispatches "
          f"{json.dumps(st['dispatches'])}; stages and AQE "
          f"{json.dumps(sched_report(st['sched']))}", flush=True)
    if tier == "whole" and not st["whole"]["runtime_degraded"]:
        # a whole program calls neither kernel (materialised CTE bodies
        # and scalar subqueries, which run before it, may: `main_calls`)
        own = calls if main_calls is None else main_calls()
        if own:
            fail(f"{label}: the whole program launched the histogram "
                 f"kernel {own} times, not 0")
    else:
        if callable(histograms):
            histograms = histograms()
        # "at least 1" counts on the run's joins, exchanges or CTE bodies;
        # CTE bodies and scalar subqueries that ran as whole programs
        # call none
        if calls != histograms and (histograms is not None or (
                calls < 1 and not st["whole"]["dispatches"])):
            fail(f"{label} launched the histogram kernel {calls} times, "
                 f"not {'at least 1' if histograms is None else histograms}")
    msg = check(out)
    if tier == "stage" and stage_check is not None:
        msg += "; " + stage_check(_delta(spark.metrics, m0))
    print(f"{label}: {msg}", flush=True)

    skipped = "not measured: no warm run"
    if st["whole"]["runtime_degraded"]:
        # each run tries the program again, runs out of memory again and
        # re-runs the plan staged: the cold run has shown that path
        warm_runs, skipped = 0, "not measured: the cold run degraded"
    warm, events = [], []
    for i in range(warm_runs):
        # the copies into and out of each graph, timed with device events
        # in the last warm run (2 events per copy, read after the run)
        with copies_timed(torch, events) if i == warm_runs - 1 \
                else contextlib.nullcontext():
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    copy_ms = {"copy_in": 0.0, "copy_out": 0.0}
    for kind, start, end in events:
        copy_ms[kind] += start.elapsed_time(end)
    batches = sum(kind == "copy_in" for kind, _, _ in events)
    warm_s = statistics.median(warm) if warm else skipped
    timing = {"rows": rows, "cold_s": cold_s, "warm_median_s": warm_s,
              "warm_s": warm, "cold_rows_per_s": rows / cold_s,
              "warm_rows_per_s": rows / warm_s if warm else warm_s,
              "histogram_calls": calls, "card": card}
    print(f"{label} timing " + json.dumps(timing), flush=True)
    bd = breakdown(torch, df, profile) if warm else {"operators": warm_s}
    print(f"{label} breakdown " + json.dumps(bd), flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cc = st["cache"]
    report = dict(decision_report(df), **{
        "whole_dispatches": st["whole"]["dispatches"],
        "capacity_retries": st["whole"]["capacity_retries"],
        "degrades": st["whole"]["runtime_degraded"],
        "fused_stages": fused_stages(df),
        "captures": cc.get("stage_cache.captures", 0),
        "replays": cc.get("stage_cache.replays", 0),
        "hits": cc.get("stage_cache.hits", 0),
        "gated_batches": st["gated_batches"],
        "capture_ms": cc.get("stage_cache.capture_ms", 0.0),
        "copy_in_ms_per_replay": copy_ms["copy_in"] / batches
        if batches else None,
        "copy_out_ms_per_replay": copy_ms["copy_out"] / batches
        if batches else None,
        "warm_replays": batches,
        "graph_gb_captured": cc.get("stage_cache.graph_bytes", 0) / 1e9,
        "graph_gb_held": stage_counters()["stage_cache.held_bytes"] / 1e9,
        "pool_resets": cc.get("stage_cache.resets", 0),
        "graph_gb_held_before": held0 / 1e9,
        "peak_gb": peak_gb,
        "warm_median_s": warm_s,
        "device_idle_share": bd.get("device_idle_share", "not measured"),
        "dispatches": st["dispatches"], "histogram_calls": calls,
        **sched_report(st["sched"]), "card": card})
    print(f"{label} report " + json.dumps(report), flush=True)

    if custom:
        again = run
    else:
        def again():
            return DataFrame(spark, df.plan).toArrow()
    if tier != "stage" and stage is not None:
        tiers_out["stage"] = tier_run(torch, sk, card, label, spark,
                                      "stage", again, stage, check, out,
                                      stage_check)
    if whole and tier != "whole":
        tiers_out["whole"] = tier_run(torch, sk, card, label, spark,
                                      "whole", again, 0, check, out)
    if operator is not None:
        tiers_out["operator"] = tier_run(torch, sk, card, label, spark,
                                         "operator", again, operator,
                                         check, out, timed=operator_timed)

    if tier == "stage" or stage is not None:
        def stage_run():
            with tier_set(spark, "stage"), bodies_on_card(torch, sk):
                (run if tier == "stage" else again)()
        seen, _ = path_histograms(torch, sk, label, {"stage": stage_run},
                                  timed_shapes)
        if not seen["stage"] and (calls if tier == "stage" else stage):
            fail(f"{label}: the stage tier's run showed no histogram call "
                 f"to record, though the path made some")
    elif record_operator:
        def operator_run():
            with tier_set(spark, "operator"):
                again()
        seen, _ = path_histograms(torch, sk, label,
                                  {"operator": operator_run}, timed_shapes)
        if not seen["operator"]:
            fail(f"{label}: the operator tier's run showed no histogram "
                 f"call to record")
    return launches


# the metrics of every card session the script makes (not the sessions,
# which hold their views' tables): the end of the run holds their stage
# retries, summed over every statement, to 0
SESSION_METRICS: list = []


def session(conf: dict):
    from spark_tpu_torch import TorchSession

    s = TorchSession("chip_smoke", dict(conf))
    SESSION_METRICS.append(s._metrics)
    return s


def main_table():
    """The main path's table: ROWS rows, k uniform in [0, KEYS), v uniform
    in [0, 1000), numpy seed 42."""
    import numpy as np

    rng = np.random.default_rng(42)
    k = rng.integers(0, KEYS, ROWS, dtype=np.int64)
    v = rng.integers(0, 1000, ROWS, dtype=np.int64)
    return k, v


def main_path(torch, sk, card: str, k, v):
    """Phase 4: the 2e7-row query through the DataFrame API."""
    import numpy as np
    import pyarrow as pa

    import spark_tpu_torch.api.functions as F
    from spark_tpu_torch.api.dataframe import DataFrame

    spark = session({"spark.sql.shuffle.partitions": PARTITIONS,
                     "spark.tpu.batch.capacity": TILE})
    df = (spark.createDataFrame(pa.table({"k": k, "v": v}))
          .filter(F.col("v") > 25)
          .withColumn("v2", F.col("v") * 3)
          .repartition(PARTITIONS)
          .groupBy("k")
          .agg(F.sum("v2"), F.count("*"), F.min("v"), F.max("v"),
               F.avg("v")))

    @once
    def oracle():
        live = v > 25
        kk, vv = k[live], v[live]
        cnt = np.bincount(kk, minlength=KEYS)
        s2 = np.bincount(kk, weights=vv * 3, minlength=KEYS).astype(np.int64)
        s1 = np.bincount(kk, weights=vv, minlength=KEYS).astype(np.int64)
        mn = np.full(KEYS, np.iinfo(np.int64).max)
        mx = np.full(KEYS, np.iinfo(np.int64).min)
        np.minimum.at(mn, kk, vv)
        np.maximum.at(mx, kk, vv)
        return cnt, s2, s1, mn, mx, np.nonzero(cnt)[0]

    def check(out):
        cnt, s2, s1, mn, mx, present = oracle()
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
        return (f"{out.num_rows} groups equal to the numpy oracle "
                f"(integers exact, avg rel err {rel:.3e})")

    def dense(metrics):
        if metrics.get("agg.dense_fast_path", 0) <= 0:
            fail("the main path did not take the dense aggregate")
        if metrics.get("aqe.partitions_coalesced", 0) != MAIN_COALESCED:
            fail(f"the main path coalesced "
                 f"{metrics.get('aqe.partitions_coalesced', 0)} partitions, "
                 f"not {MAIN_COALESCED}")
        return (f"the dense aggregate taken; {MAIN_COALESCED} partitions "
                "coalesced")

    tiers = {}
    drive(torch, sk, card, "main path", df, ROWS,
          (f"Exchange[UnknownPartitioning({PARTITIONS})]",
           f"Exchange[HashPartitioning({PARTITIONS})]",
           "HashAggregate[partial]", "HashAggregate[final]"),
          MAIN_HISTOGRAMS, check, operator=MAIN_HISTOGRAMS,
          stage=MAIN_HISTOGRAMS, stage_check=dense, tiers_out=tiers)
    replay_equals_eager(torch, "main path", df.toArrow)
    with tier_set(spark, "stage"):
        replay_equals_eager(torch, "main path stage",
                            DataFrame(spark, df.plan).toArrow)
    spark.stop()
    return tiers


def replay_equals_eager(torch, label: str, run) -> None:
    """One more run in which every fused batch's graph outputs are held
    to the same fused body run eagerly on the card over the same inputs,
    batch by batch: integers and masks exactly, floats to relative 1e-12
    (the dense sums add in atomic order)."""
    import spark_tpu_torch.ops.scatter_kernels as sk

    seen = []

    def compare(name, got, want):
        if len(got) != len(want):
            fail(f"{label} {name}: {len(got)} outputs replayed, "
                 f"{len(want)} eager")
        for i, (g, w) in enumerate(zip(got, want)):
            if (g is None) != (w is None):
                fail(f"{label} {name}: output {i} is None on one side")
            if g is None:
                continue
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"{label} {name}: output {i} is {g.dtype}{list(g.shape)}"
                     f" replayed, {w.dtype}{list(w.shape)} eager")
            ok = torch.allclose(g, w, rtol=1e-12, atol=0, equal_nan=True) \
                if g.dtype.is_floating_point else torch.equal(g, w)
            if not ok:
                fail(f"{label} {name}: output {i} differs between the "
                     "replay and the eager run")
        seen.append(name)

    with bodies_on_card(torch, sk, compare):
        run()
        torch.cuda.synchronize()
    if not seen:
        fail(f"{label}: no fused batch to hold against its eager run")
    print(f"{label}: {len(seen)} fused batches' replays equal their eager "
          f"runs on the card ({sorted(set(seen))})", flush=True)


def rel_err(got, exp) -> float:
    import numpy as np

    return float(np.max(np.abs(got - exp) / np.maximum(np.abs(exp), 1e-300)))


def join_leg(torch, sk, card: str) -> dict:
    """bench.py's bench_join (BASELINE config 3): store_sales joined to
    date_dim, summed by year; the dim side is broadcast and takes the dense
    direct-address build."""
    import numpy as np
    import pyarrow as pa

    import spark_tpu_torch.api.functions as F

    rng = np.random.default_rng(3)
    sold = rng.integers(DATE0, DATE0 + DATES, ROWS)
    price = rng.random(ROWS)
    dsk = np.arange(DATE0, DATE0 + DATES)
    spark = session({"spark.sql.shuffle.partitions": 1,
                     "spark.tpu.batch.capacity": TILE})
    f = spark.createDataFrame(pa.table({"ss_sold_date_sk": sold,
                                        "ss_ext_sales_price": price}))
    d = spark.createDataFrame(pa.table({
        "d_date_sk": dsk, "d_year": 1998 + (dsk - DATE0) // 365}))
    df = (f.join(d, f["ss_sold_date_sk"] == d["d_date_sk"])
          .groupBy("d_year").agg(F.sum("ss_ext_sales_price")))

    def dense(metrics):
        if metrics.get("join.dense_fast_path", 0) <= 0:
            fail("join: the dense join build was not taken")
        return "the dense join build taken"

    def check(out):
        year = (sold - DATE0) // 365
        sums = np.bincount(year, weights=price)
        present = np.nonzero(np.bincount(year))[0]
        got = out.sort_by("d_year")
        if not np.array_equal(got.column("d_year").to_numpy(),
                              1998 + present):
            fail("join: the years differ from the numpy oracle")
        # float64 sums added in atomic order, not the oracle's
        rel = rel_err(got.column("sum(ss_ext_sales_price)").to_numpy(),
                      sums[present])
        if not rel <= 1e-9:
            fail(f"join: sum relative error {rel}")
        return (f"{out.num_rows} years equal to the numpy oracle (sum rel "
                f"err {rel:.3e})")

    launches = drive(torch, sk, card, "join leg", df, ROWS + DATES,
                     ("BroadcastExchange", "BroadcastHashJoin[inner]"),
                     leg_calls("join"), check, operator=leg_calls("join"),
                     stage=leg_calls("join"), stage_check=dense)
    spark.stop()
    return launches


def sort_leg(torch, sk, card: str) -> dict:
    """bench.py's bench_sort (BASELINE config 2): a global orderBy over 1e8
    int64 keys uniform over the whole int64 range, one 2^27-row tile."""
    import numpy as np
    import pyarrow as pa

    info = np.iinfo(np.int64)
    k = np.random.default_rng(7).integers(info.min, info.max, SORT_ROWS,
                                          dtype=np.int64, endpoint=True)
    spark = session({"spark.sql.shuffle.partitions": 1,
                     "spark.tpu.batch.capacity": SORT_TILE})
    df = spark.createDataFrame(pa.table({"k": k})).orderBy("k")

    ordered = once(lambda: np.sort(k))

    def check(out):
        got = out.column("k").to_numpy()
        if not np.array_equal(got, ordered()):
            fail("sort: the keys differ from np.sort")
        return f"{out.num_rows} keys equal to np.sort"

    launches = drive(torch, sk, card, "sort leg", df, SORT_ROWS,
                     ("Sort[k#",), leg_calls("sort"), check,
                     operator=leg_calls("sort"), whole=True)
    budget = budget_sort(torch, sk, card, spark, df, check)
    spark.stop()
    return launches, budget


def range_sort_leg(torch, sk, card: str, k, v) -> dict:
    """The main table through a round-robin and a range exchange, then a
    sort of each partition: orderBy(k, desc(v))."""
    import numpy as np
    import pyarrow as pa

    import spark_tpu_torch.api.functions as F

    spark = session({"spark.sql.shuffle.partitions": PARTITIONS,
                     "spark.tpu.batch.capacity": TILE})
    df = (spark.createDataFrame(pa.table({"k": k, "v": v}))
          .repartition(PARTITIONS).orderBy("k", F.desc("v")))

    lexsorted = once(lambda: np.lexsort((-v, k)))

    def check(out):
        order = lexsorted()
        for name, col in (("k", k), ("v", v)):
            if not np.array_equal(out.column(name).to_numpy(), col[order]):
                fail(f"range_sort: column {name} differs from the "
                     f"np.lexsort order")
        return f"{out.num_rows} rows in the np.lexsort order"

    # the operator tier's rerun is untimed (cut for the script's time):
    # its counted cold run, histogram calls and oracle stay
    launches = drive(torch, sk, card, "range_sort leg", df, ROWS,
                     (f"Exchange[RangePartitioning({PARTITIONS})]",
                      "Sort[k#"), leg_calls("range_sort"), check,
                     operator=leg_calls("range_sort"), operator_timed=False,
                     stage=leg_calls("range_sort"))
    spark.stop()
    return launches


def topk_leg(torch, sk, card: str, k, v) -> dict:
    """ORDER BY + LIMIT over the main table: a local sort and limit, a
    gather to one partition, a final sort and limit."""
    import numpy as np
    import pyarrow as pa

    import spark_tpu_torch.api.functions as F

    spark = session({"spark.sql.shuffle.partitions": PARTITIONS,
                     "spark.tpu.batch.capacity": TILE})
    df = (spark.createDataFrame(pa.table({"k": k, "v": v}))
          .orderBy(F.desc("v"), "k").limit(TOPK))

    top = once(lambda: np.lexsort((k, -v))[:TOPK])

    def check(out):
        order = top()
        for name, col in (("k", k), ("v", v)):
            if not np.array_equal(out.column(name).to_numpy(), col[order]):
                fail(f"topk: column {name} differs from the oracle")
        return f"{out.num_rows} rows equal to the np.lexsort top {TOPK}"

    launches = drive(torch, sk, card, "topk leg", df, ROWS,
                     ("LimitExec(is_global=True", "LimitExec(is_global=False",
                      "Exchange[SinglePartition(1)]"),
                     leg_calls("topk"), check, operator=leg_calls("topk"),
                     stage=leg_calls("topk"))
    spark.stop()
    return launches


def q78_shape(spark, label: str = "q78"):
    """(df, check) of TPC-DS q78's first CTE shape on `spark`: the sales
    (2e7 rows) and returns (2e6) of numpy seed 11, the sales repartitioned
    into PARTITIONS, their left outer join on (ticket, item) where the
    return is null, counted and summed by store; `check(table)` holds a
    result to the numpy oracle."""
    import numpy as np
    import pyarrow as pa

    import spark_tpu_torch.api.functions as F
    from spark_tpu_torch.physical.exchange import ShuffleExchangeExec
    from spark_tpu_torch.physical.operators import HashJoinExec
    from spark_tpu_torch.physical.partitioning import HashPartitioning

    rng = np.random.default_rng(11)
    ticket = np.arange(ROWS) // 10
    item = rng.integers(1, Q78_ITEMS + 1, ROWS)
    store = rng.integers(1, Q78_STORES + 1, ROWS)
    paid = rng.random(ROWS) * 100
    idx = rng.choice(ROWS, Q78_RETURNS, replace=False)
    amt = rng.random(Q78_RETURNS) * 50
    s = spark.createDataFrame(pa.table({
        "ss_ticket_number": ticket, "ss_item_sk": item,
        "ss_store_sk": store, "ss_net_paid": paid}))
    r = spark.createDataFrame(pa.table({
        "sr_ticket_number": ticket[idx], "sr_item_sk": item[idx],
        "sr_return_amt": amt}))
    cond = (s["ss_ticket_number"] == r["sr_ticket_number"]) & \
        (s["ss_item_sk"] == r["sr_item_sk"])
    df = (s.repartition(PARTITIONS).join(r, cond, "left_outer")
          .filter(F.col("sr_ticket_number").isNull())
          .groupBy("ss_store_sk").agg(F.count("*"), F.sum("ss_net_paid")))

    @once
    def oracle():
        code = ticket * (1 << 17) + item
        kept = ~np.isin(code, code[idx])
        cnt = np.bincount(store[kept], minlength=Q78_STORES + 1)
        sums = np.bincount(store[kept], weights=paid[kept],
                           minlength=Q78_STORES + 1)
        return kept, cnt, sums, np.nonzero(cnt)[0]

    def check(out):
        joins = [n for n in plan_nodes(df) if isinstance(n, HashJoinExec)]
        if len(joins) != 1 or any(
                not (isinstance(c, ShuffleExchangeExec)
                     and isinstance(c.partitioning, HashPartitioning))
                for c in joins[0].children):
            fail(f"{label}: the join is not fed by a hash exchange on each "
                 "side")
        kept, cnt, sums, present = oracle()
        got = out.sort_by("ss_store_sk")
        if not np.array_equal(got.column("ss_store_sk").to_numpy(), present):
            fail(f"{label}: the stores differ from the numpy oracle")
        if not np.array_equal(got.column("count(1)").to_numpy(),
                              cnt[present]):
            fail(f"{label}: the counts differ from the numpy oracle")
        rel = rel_err(got.column("sum(ss_net_paid)").to_numpy(),
                      sums[present])
        if not rel <= 1e-9:
            fail(f"{label}: sum relative error {rel}")
        return (f"{out.num_rows} stores, {int(kept.sum())} rows with no "
                f"return; counts exact, sum rel err {rel:.3e}")

    return df, check


def q78_leg(torch, sk, card: str) -> dict:
    """TPC-DS q78's first CTE shape: store_sales LEFT JOIN store_returns on
    (ticket, item) where the return is null, counted and summed by store.
    The build side (2e6 rows x 16 bytes after pruning) is over the 10 MB
    broadcast threshold, so both sides are hash-shuffled and the two-key
    join takes the sorted probe."""
    from spark_tpu_torch.api.dataframe import DataFrame

    spark = session({"spark.sql.shuffle.partitions": PARTITIONS,
                     "spark.tpu.batch.capacity": TILE})
    df, check = q78_shape(spark)

    def sorted_probe(metrics):
        if metrics.get("join.sorted_probe", 0) <= 0 or \
                metrics.get("join.dense_fast_path", 0) > 0:
            fail("q78: the join did not take the sorted probe")
        return "the sorted probe taken"

    launches = drive(torch, sk, card, "q78 leg", df, ROWS + Q78_RETURNS,
                     ("ShuffledHashJoin[left_outer]",),
                     leg_calls("q78"), check, operator=leg_calls("q78"),
                     stage=leg_calls("q78"), stage_check=sorted_probe)
    replay_equals_eager(torch, "q78 leg", df.toArrow)
    with tier_set(spark, "stage"):
        replay_equals_eager(torch, "q78 leg stage",
                            DataFrame(spark, df.plan).toArrow)
    budget = budget_q78(torch, sk, card, spark, df, check)
    spark.stop()
    return launches, budget


# --- the budget leg: the device budget's multi-pass paths ----------------

# the sort's budget: 512 MiB over schema_row_bytes 10 B x 3 is 17,895,697
# rows a tile, against the sort leg's one 2^27-row tile: external_sort asks
# for 2 x 8 = 16 buckets (15 sampled bounds)
BUDGET_SORT_BYTES = 512 << 20
BUDGET_SORT_BUCKETS = 16
# q78's reducer tile: 2e6 returns hashed into 8 partitions of 250,000 rows,
# one tile each of 262,144; the grace budget leaves a quarter of it a tile
Q78_REDUCER_TILE = 1 << 18
GRACE_FRAGMENTS = 4


def budget_run(torch, sk, card: str, label: str, spark, df, check,
               histograms: int, counters, at_least: bool = False) -> dict:
    """One statement of the budget leg: planned at `stage`, run cold with
    the launch counts set to 0 just before and read just after (the
    histogram wrapper exactly `histograms`, or at least that many where
    `at_least`), held to the oracle `check`, the histogram kernel held to
    its plain version at the inputs of one more run (`path_histograms`),
    its multi-pass counters to `counters(metrics delta)`, then one warm
    run; the times, counters and histogram calls printed as the `<label>`
    line. Returns the cold run's launch counts."""
    with tier_set(spark, "stage"):
        show_plan(label, df, ())
        m0 = spark.metrics
        out, cold, launches, st = counted_run(torch, sk, spark, df.toArrow)
        delta = _delta(spark.metrics, m0)
        calls = launches["partition_histogram"]
        if calls < histograms if at_least else calls != histograms:
            fail(f"{label} launched the histogram kernel {calls} times, not "
                 f"{'at least ' if at_least else ''}{histograms}")
        msg = check(out) + "; " + counters(delta)
        print(f"{label}: {msg}", flush=True)
        warm = _warm(torch, df.toArrow, 1)

        def stage_run():
            with bodies_on_card(torch, sk):
                df.toArrow()

        # the histogram kernel at the multi-pass paths' own inputs: the
        # external sort's bucketing, the grace join's fragmenting
        path_histograms(torch, sk, label, {"stage": stage_run})
    print(f"{label} " + json.dumps(dict(
        cold_s=cold, warm_s=warm[0], histogram_calls=calls,
        **{k: v for k, v in delta.items()
           if k.startswith(("sort.external", "join.grace"))},
        **sched_report(st["sched"]), card=card)), flush=True)
    return launches


def budget_sort(torch, sk, card: str, spark, df, check) -> dict:
    """The budget leg's sort, at the end of the sort leg and on its
    session, table and oracle (1e8 int64, seed 7, one 2^27-row tile):
    planned anew under BUDGET_SORT_BYTES, so the external range-bucketed
    sort takes it in BUDGET_SORT_BUCKETS buckets. Users see this where a
    card is shared or an operator's slice of memory is capped."""
    from spark_tpu_torch.api.dataframe import DataFrame

    def sort_counters(delta):
        passes = delta.get("sort.external.passes", 0)
        buckets = spark.metrics.get("sort.external.buckets", 0)
        over = delta.get("sort.external.oversizedBucket", 0)
        if passes != 1 or buckets != BUDGET_SORT_BUCKETS or over:
            fail(f"budget sort: {passes} external passes over {buckets} "
                 f"buckets ({over} oversized), not 1 over "
                 f"{BUDGET_SORT_BUCKETS} (none oversized)")
        return (f"the external sort: 1 pass, {buckets} buckets, none "
                f"oversized; budget {BUDGET_SORT_BYTES:,} B")

    spark.conf.set("spark.tpu.memory.deviceBudgetBytes", BUDGET_SORT_BYTES)
    try:
        # the range-bucketing's one histogram call (one input tile)
        return budget_run(torch, sk, card, "budget sort", spark,
                          DataFrame(spark, df.plan), check, 1,
                          sort_counters)
    finally:
        spark.conf.unset("spark.tpu.memory.deviceBudgetBytes")


def budget_q78(torch, sk, card: str, spark, df, check) -> dict:
    """The budget leg's join, at the end of the q78 leg and on its
    session, tables and oracle (sales 2e7, returns 2e6, seed 11, 8
    partitions, 2^22 tiles): planned anew under a budget that leaves each
    build partition's reducer tile a quarter tile, so the grace join
    splits it into GRACE_FRAGMENTS."""
    from spark_tpu_torch.api.dataframe import DataFrame
    from spark_tpu_torch.exec.memory import schema_row_bytes
    from spark_tpu_torch.physical.operators import HashJoinExec, attrs_schema

    join = next(n for n in plan_nodes(df) if isinstance(n, HashJoinExec))
    row_bytes = schema_row_bytes(attrs_schema(join.right.output))
    # tile_rows(amplification=4) = budget // (row_bytes * 4) = a quarter
    # of the reducer tile: ceil(262,144 / 65,536) = 4 fragments
    budget = Q78_REDUCER_TILE // GRACE_FRAGMENTS * row_bytes * 4
    print(f"budget q78: the returns side's {row_bytes} B a row x 4 x "
          f"{Q78_REDUCER_TILE // GRACE_FRAGMENTS:,} rows = a budget of "
          f"{budget:,} B", flush=True)

    def grace_counters(delta):
        frags = delta.get("join.grace.fragments", 0)
        if frags != PARTITIONS * GRACE_FRAGMENTS:
            fail(f"budget q78: {frags} grace fragments, not "
                 f"{PARTITIONS * GRACE_FRAGMENTS} ({GRACE_FRAGMENTS} for "
                 f"each of {PARTITIONS} partitions)")
        return (f"the grace join: {GRACE_FRAGMENTS} fragments in each of "
                f"{PARTITIONS} partitions; budget {budget:,} B")

    spark.conf.set("spark.tpu.memory.deviceBudgetBytes", budget)
    try:
        # at least the q78 leg's calls + the fragmenting's hash partition
        # of each partition's one build and one probe tile; on the card
        # each fragment's probe output is a partial aggregate pass of its
        # own (4 a partition where there was 1) and their merge 2 more
        return budget_run(torch, sk, card, "budget q78", spark,
                          DataFrame(spark, df.plan), check,
                          leg_calls("q78") + 2 * PARTITIONS,
                          grace_counters, at_least=True)
    finally:
        spark.conf.unset("spark.tpu.memory.deviceBudgetBytes")


# --- the tpcds leg ---------------------------------------------------------

# --- the sorted_runs leg: the sorted-run aggregate ------------------------

SORTED_ROWS = ROWS              # order lines
SORTED_SEED = 29
SORTED_QUERY = ("SELECT order_id, count(*) n, sum(qty) q, min(price) lo, "
                "max(price) hi, bit_or(flags) f FROM order_lines "
                "WHERE qty > 1 GROUP BY order_id")


def sorted_runs_table(rows: int = SORTED_ROWS, seed: int = SORTED_SEED):
    """Order lines clustered by order id, as a table written sorted by its
    key: 1-20 lines an order (uniform), order ids sorted with gaps uniform
    in [16, 112), qty in 1-100, price int64 cents in [100, 100000), flags
    in [0, 2^16); numpy seed 29. Returns the columns as numpy arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 21, rows // 10 + 1)
    if int(lens.sum()) < rows:
        fail("sorted_runs: too few orders for the lines")
    ids = np.cumsum(rng.integers(16, 112, len(lens)))
    return {"order_id": np.repeat(ids, lens)[:rows],
            "qty": rng.integers(1, 101, rows),
            "price": rng.integers(100, 100_000, rows),
            "flags": rng.integers(0, 1 << 16, rows)}


def sorted_runs_oracle(a: dict) -> dict:
    """The query's groups from numpy: the live lines' runs of equal ids
    reduced with reduceat."""
    import numpy as np

    live = a["qty"] > 1
    oid = a["order_id"][live]
    starts = np.flatnonzero(np.r_[True, oid[1:] != oid[:-1]])
    return {"order_id": oid[starts],
            "n": np.diff(np.r_[starts, len(oid)]),
            "q": np.add.reduceat(a["qty"][live], starts),
            "lo": np.minimum.reduceat(a["price"][live], starts),
            "hi": np.maximum.reduceat(a["price"][live], starts),
            "f": np.bitwise_or.reduceat(a["flags"][live], starts)}


def sorted_runs_leg(torch, sk, card: str) -> dict:
    """Spark users group by the clustering key of a table written sorted
    by it (order lines clustered by order id; a sortBy / SORT BY write):
    SORTED_QUERY over 2e7 lines (`sorted_runs_table`) ingested from Arrow
    into 8 partitions, each one 2^22-row tile of 2.5M lines whose key span
    (about 1.5e7) is over the dense path's 2^23, so the partial aggregate
    takes the sorted-run path where it runs unfused. The query runs at the
    operator tier (every partial aggregate takes ragg: the sorted-run
    count, ragg dispatches and run-layout launches each equal the tiles,
    and the sorted path runs only for the final aggregate's partitions),
    at stage (the fused aggregate, no ragg) and at `auto` (its tier
    printed), each cold and 3 warm, held to the numpy oracle; then once
    more at the operator tier with spark.tpu.debug.validateBatches set,
    to the same result, and once more to hold the run-layout kernel at
    the leg's own inputs. A cold dense decision over the ingested tiles
    reads nothing from the device (their ranges were seeded at ingest).
    Returns the launch counts of the operator tier's run (the kernels
    line's run-layout launches) and of each tier."""
    import numpy as np
    import pyarrow as pa

    from spark_tpu_torch.api.dataframe import DataFrame
    from spark_tpu_torch.expr.expressions import AttributeReference
    from spark_tpu_torch.io.sources import InMemorySource
    from spark_tpu_torch.physical.operators import dense_range_stats
    from spark_tpu_torch.plan.logical import LogicalRelation

    t0 = time.perf_counter()
    a = sorted_runs_table()
    per = -(-SORTED_ROWS // PARTITIONS)
    spans = [int(a["order_id"][min(lo + per, SORTED_ROWS) - 1]
                 - a["order_id"][lo]) + 1
             for lo in range(0, SORTED_ROWS, per)]
    if min(spans) + 1 <= min(4 * TILE, 1 << 23):
        fail(f"sorted_runs: a partition's key span {min(spans)} would take "
             "the dense path")
    spark = session({"spark.sql.shuffle.partitions": PARTITIONS,
                     "spark.tpu.batch.capacity": TILE})
    # the table in PARTITIONS splits, its ingested tiles kept on the card
    # as an in-memory view's are
    src = InMemorySource(pa.table(a), PARTITIONS)
    src.cache_device_batches = True
    attrs = [AttributeReference(f.name, f.dataType, f.nullable)
             for f in src.schema.fields]
    DataFrame(spark, LogicalRelation(src, attrs, "order_lines")) \
        .createOrReplaceTempView("order_lines")
    want = once(lambda: sorted_runs_oracle(a))

    def check(out):
        exp = want()
        got = out.sort_by("order_id")
        if got.num_rows != len(exp["order_id"]):
            fail(f"sorted_runs: {got.num_rows} groups, not "
                 f"{len(exp['order_id'])}")
        for name, col in exp.items():
            if not np.array_equal(got.column(name).to_numpy(), col):
                fail(f"sorted_runs: column {name} differs from the numpy "
                     "oracle")
        return f"{got.num_rows} groups equal to the numpy oracle"

    tiers = {}
    for tier in ("operator", "stage", "auto"):
        with tier_set(spark, tier):
            df = spark.sql(SORTED_QUERY)
            m0 = spark.metrics
            out, cold, launches, st = counted_run(torch, sk, spark,
                                                  df.toArrow)
            delta = _delta(spark.metrics, m0)
            msg = check(out)
            warm = _warm(torch, df.toArrow)
            disp = st["dispatches"]
            ragg = disp.get("ragg", 0)
            if tier == "operator":
                finals = PARTITIONS - delta.get("aqe.partitions_coalesced",
                                                0)
                if not (ragg == launches["run_layout"] == PARTITIONS
                        == delta.get("agg.run_sorted_fast_path", 0)):
                    fail(f"sorted_runs at operator: {ragg} ragg, "
                         f"{launches['run_layout']} run-layout launches, "
                         f"{delta.get('agg.run_sorted_fast_path', 0)} "
                         f"sorted-run partials for {PARTITIONS} tiles")
                if disp.get("gagg", 0) != finals or disp.get("dagg", 0):
                    fail(f"sorted_runs at operator: {disp.get('gagg', 0)} "
                         f"sorted and {disp.get('dagg', 0)} dense "
                         f"aggregates for {finals} final partitions")
            elif tier == "stage" and (ragg or launches["run_layout"] or
                                      not disp.get("fused_agg", 0)):
                fail(f"sorted_runs at stage: {ragg} ragg and "
                     f"{disp.get('fused_agg', 0)} fused aggregate "
                     "dispatches")
            tiers[tier] = launches
            print(f"sorted_runs {tier}: {msg}", flush=True)
            print(f"sorted_runs {tier} " + json.dumps(dict(
                decision_report(df), cold_s=cold,
                warm_median_s=statistics.median(warm), warm_s=warm,
                histogram_calls=launches["partition_histogram"],
                bits_calls=launches["segment_bits"],
                run_layout_calls=launches["run_layout"],
                dispatches=disp,
                cold_dense_range_syncs=delta.get("dense_range.syncs", 0),
                run_sorted_partials=delta.get("agg.run_sorted_fast_path",
                                              0),
                **sched_report(st["sched"]), card=card)), flush=True)
    # a cold dense decision over the ingested tiles: seeded at ingest
    m0 = spark.metrics
    tiles = [b for part in src._device_cache.values() for b in part]
    for b in tiles:
        dense_range_stats(b.columns[0], b.row_mask, spark._metrics)
    syncs = _delta(spark.metrics, m0).get("dense_range.syncs", 0)
    if len(tiles) != PARTITIONS or syncs:
        fail(f"sorted_runs: {syncs} dense-range reads over {len(tiles)} "
             "ingested tiles")
    spark.conf.set("spark.tpu.debug.validateBatches", "true")
    with tier_set(spark, "operator"):
        check(spark.sql(SORTED_QUERY).toArrow())
    spark.conf.unset("spark.tpu.debug.validateBatches")
    with tier_set(spark, "operator"):
        path = path_runs(torch, sk, "sorted_runs",
                         spark.sql(SORTED_QUERY).toArrow)
    print(f"sorted_runs: {len(tiles)} ingested tiles, 0 dense-range reads "
          "over them; the validated run equals the oracle too; leg "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    spark.stop()
    return tiers, path


def window_leg(torch, sk, card: str, k, v) -> dict:
    """Spark's top-N-per-group idiom (pyspark.sql.Window) over the main
    table in PARTITIONS round-robin partitions, hash-exchanged on k:
    w = Window.partitionBy("k").orderBy(desc("v")); row_number,
    rank and dense_rank over w, the running sum(v) with peers, lag(v),
    max(v) over w.rowsBetween(-2, 0), lead(v) and lag(v, 1, -1) (the
    default where the partition has no row before); then row_number <=
    WINDOW_TOP. Every
    row is held to a numpy oracle: each column exactly, row_number as a
    permutation within each (k, v) peer group (the rows of a group are
    equal but for it)."""
    import numpy as np
    import pyarrow as pa

    import spark_tpu_torch.api.functions as F
    from spark_tpu_torch.api.window import Window

    spark = session({"spark.sql.shuffle.partitions": PARTITIONS,
                     "spark.tpu.batch.capacity": TILE})
    w = Window.partitionBy("k").orderBy(F.desc("v"))
    df = (spark.createDataFrame(pa.table({"k": k, "v": v}))
          .repartition(PARTITIONS)
          .select("k", "v", F.row_number().over(w).alias("rn"),
                  F.rank().over(w).alias("rk"),
                  F.dense_rank().over(w).alias("dr"),
                  F.sum("v").over(w).alias("run_sum"),
                  F.lag("v").over(w).alias("prev_v"),
                  F.max("v").over(w.rowsBetween(-2, 0)).alias("max3"),
                  F.lead("v").over(w).alias("next_v"),
                  F.lag("v", 1, -1).over(w).alias("prev_or"))
          .filter(F.col("rn") <= WINDOW_TOP))

    lexsorted = once(lambda: np.lexsort((-v, k)))

    def check(out):
        order = lexsorted()
        ks, vs = k[order], v[order]
        n = len(ks)
        idx = np.arange(n)
        new_part = np.ones(n, bool)
        new_part[1:] = ks[1:] != ks[:-1]
        new_peer = new_part.copy()
        new_peer[1:] |= vs[1:] != vs[:-1]
        start = np.maximum.accumulate(np.where(new_part, idx, 0))
        peer_first = np.maximum.accumulate(np.where(new_peer, idx, 0))
        peer_id = np.cumsum(new_peer)
        peer_last = np.empty(n, np.int64)
        peer_last[np.nonzero(new_peer)[0]] = np.append(
            np.nonzero(new_peer)[0][1:] - 1, n - 1)
        peer_last = peer_last[peer_first]
        csum = np.cumsum(vs)
        before = np.where(start > 0, csum[np.maximum(start - 1, 0)], 0)
        exp = {"rn": idx - start + 1, "rk": peer_first - start + 1,
               "dr": peer_id - peer_id[start] + 1,
               "run_sum": csum[peer_last] - before,
               "prev_v": vs[np.maximum(idx - 1, 0)],
               "max3": vs[np.maximum(idx - 2, start)]}
        has_prev = idx > start
        has_next = np.append(~new_part[1:], False)
        exp["next_v"] = np.where(has_next, vs[np.minimum(idx + 1, n - 1)], 0)
        exp["prev_or"] = np.where(has_prev, exp["prev_v"], -1)
        keep = idx - start < WINDOW_TOP
        got = out.sort_by([("k", "ascending"), ("rn", "ascending")])
        if got.num_rows != int(keep.sum()):
            fail(f"window: {got.num_rows} rows, not {int(keep.sum())}")
        for name, col in (("k", ks), ("v", vs), *exp.items()):
            g = got.column(name)
            if name in ("prev_v", "next_v"):
                has = has_prev if name == "prev_v" else has_next
                if not np.array_equal(g.is_null().to_numpy(
                        zero_copy_only=False), ~has[keep]):
                    fail(f"window: {name} is NULL on other rows than each "
                         "partition's first (lag) or last (lead)")
                g = g.fill_null(0)
                col = np.where(has, col, 0)
            if not np.array_equal(g.to_numpy(), col[keep]):
                fail(f"window: column {name} differs from the numpy oracle")
        return (f"{got.num_rows} rows equal to the numpy oracle (the top "
                f"{WINDOW_TOP} of {len(np.unique(ks))} partitions)")

    # the operator tier's rerun is untimed (cut for the script's time):
    # its counted cold run, histogram calls and oracle stay
    launches = drive(torch, sk, card, "window leg", df, ROWS,
                     (f"Exchange[HashPartitioning({PARTITIONS})]",
                      "Window[rownumber, rank, denserank, sum, lag, max, "
                      "lead, lag]"),
                     leg_calls("window"), check,
                     operator=leg_calls("window"), operator_timed=False)
    spark.stop()
    return launches


def tpcds_calls(query: str) -> int | None:
    """Histogram wrapper calls of q3, q7, q19, q9 and q28 at SF10, derived
    from their plans (TPCDS_PLAN_OPS) and tile counts as leg_calls is;
    None for the other queries, whose plans (or materialised CTE bodies,
    which run inside the counted run) all hold a join build or an exchange
    that takes at least one (drive then asserts one or more). Every scan is
    one partition and no exchange below the aggregate splits it, so each
    join and the aggregate run once, on one batch: the probe side of the
    shuffled join (a dimension, one tile) yields one batch. Each join's
    build tries the dense direct-address table (1: its `present`, also
    when duplicate keys then send it to the sorted probe, as store_sales
    and customer do); a single string key aggregates over its dictionary
    codes (1 `present` + 1 count per distinct validity plane of the
    summed columns: the four store_sales prices come through the shuffled
    join's build-side gather, each with its own plane); several keys take
    the sorted-segment kernel (0)."""
    return {
        # the shuffled join's dense attempt (dates repeat) + item
        "q3": 1 + 1,
        # the shuffled join's attempt + customer_demographics, item,
        # promotion + the aggregate's present and 4 validity counts
        "q7": 1 + 3 + 1 + 4,
        # customer (addresses repeat), store_sales (customers repeat),
        # date_dim, item, store
        "q19": 1 + 1 + 3,
        # none: the main query reads the 45-row reason table alone, and its
        # 15 scalar subqueries (run before it, counted with it) each
        # aggregate store_sales with no grouping key in its one partition
        "q9": 0,
        # none: six cross-joined aggregates of store_sales' one partition,
        # each grouped by a decimal list price (the count(DISTINCT)
        # rewrite; the sorted-segment kernel) or by nothing
        "q28": 0,
    }.get(query)


def tpcds_datagen():
    """tests/tpcds/datagen.py, loaded from its path: its value pools and
    date keys (a `tests` package installed elsewhere may shadow the repo's
    directory)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "tpcds_datagen", os.path.join(ROOT, "tests", "tpcds", "datagen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _decimal_column(pa, cents, precision: int = 7, scale: int = 2):
    """decimal(precision, scale) Arrow array from int64 unscaled values:
    each value a 16-byte little-endian word (sign-extended), no per-value
    objects."""
    import numpy as np

    words = np.empty((len(cents), 2), dtype=np.int64)
    words[:, 0] = cents
    words[:, 1] = cents >> 63
    return pa.Array.from_buffers(pa.decimal128(precision, scale), len(cents),
                                 [None, pa.py_buffer(words.tobytes())])


def _int_column(pa, values, null_mask=None):
    return pa.array(values.astype("int32"), pa.int32(), mask=null_mask)


def _line_prices(rng, n):
    """Per-line quantity and prices in cents, as datagen derives them:
    list = wholesale x U(1, 2), sales = list x U(0.3, 1), the extended
    amounts quantity times the unit prices, a 20% coupon on 10% of lines,
    net profit = extended sales - coupon - extended wholesale."""
    import numpy as np

    qty = rng.integers(1, 100, n)
    whole = rng.integers(100, 10000, n)
    list_c = np.rint(whole * rng.uniform(1.0, 2.0, n)).astype(np.int64)
    sales = np.rint(list_c * rng.uniform(0.3, 1.0, n)).astype(np.int64)
    ext_sales = qty * sales
    coupon = np.where(rng.random(n) < 0.1,
                      np.rint(ext_sales * 0.2).astype(np.int64), 0)
    return {"quantity": qty, "wholesale_cost": whole, "list_price": list_c,
            "sales_price": sales, "ext_sales_price": ext_sales,
            "ext_wholesale_cost": qty * whole, "ext_list_price": qty * list_c,
            "ext_tax": np.rint(ext_sales * 0.05).astype(np.int64),
            "coupon_amt": coupon,
            "net_profit": ext_sales - coupon - qty * whole}


def _groups(rng, n, lo, hi):
    """Group index of each of n rows, groups of uniform size in [lo, hi]
    (tickets of line items, catalog and web orders); and the group
    count."""
    import numpy as np

    sizes = rng.integers(lo, hi + 1, n // lo + 1)
    count = int(np.searchsorted(np.cumsum(sizes), n)) + 1
    return np.repeat(np.arange(count), sizes[:count])[:n], count


def _shape_store_sales(rng, G, ss, ss_null, tk, n_tickets, ni, nc, kept):
    """q23 reads items sold more than 4 times on one date from 2000 on and
    the customers whose store purchases pass half the largest total. At
    uniform draws neither exists at SF10 (28.8M lines over 102,000 items
    and 1,826 dates), so 50 items fill the lines of 2,000 tickets that
    hold 7 such lines or more dated 2000 on, and three customers each buy
    the lines of 3,000 tickets. Lines in `kept` (returned ones, and those
    the catalog and web repeat) keep their values; the others are
    rewritten, so the queries that read ss_item_sk or ss_customer_sk read
    other data than before this shaping. Returns (the 50 item keys, the 3
    customer keys, the lines rewritten by column)."""
    import datetime

    import numpy as np

    free = np.ones(len(tk), bool)
    free[kept] = False
    lines = np.bincount(tk[free], minlength=n_tickets)
    starts = np.concatenate([[0], np.cumsum(np.bincount(
        tk, minlength=n_tickets))[:-1]])
    cand = np.nonzero((lines >= 7) & (ss["ss_sold_date_sk"][starts] >=
                                      G._dsk(datetime.date(2000, 1, 1))))[0]
    hot = rng.choice(np.arange(1, ni + 1), 50, replace=False)
    hot_t = rng.choice(cand, 2000, replace=False)
    per_ticket = np.zeros(n_tickets, np.int64)
    per_ticket[hot_t] = hot[rng.integers(0, 50, len(hot_t))]
    sel = (per_ticket[tk] > 0) & free
    ss["ss_item_sk"][sel] = per_ticket[tk][sel]
    rewritten = {"ss_item_sk": int(sel.sum())}
    heavy = rng.choice(np.arange(1, nc + 1), 3, replace=False)
    rest = np.setdiff1d(np.arange(n_tickets), hot_t)
    per_ticket[:] = 0
    per_ticket[rng.choice(rest, 9000, replace=False)] = np.repeat(heavy,
                                                                  3000)
    sel = (per_ticket[tk] > 0) & free
    ss["ss_customer_sk"][sel] = per_ticket[tk][sel]
    ss_null["ss_customer_sk"][sel] = False
    rewritten["ss_customer_sk"] = int(sel.sum())
    return hot, heavy, rewritten


def _plant_q23_channels(rng, G, channels, hot, heavy, rewritten):
    """q23's catalog and web legs: 100 lines of each, sold in February
    2000, bought by the heavy customers and of the hot items (lines no
    return reads), counted into `rewritten`."""
    import datetime

    import numpy as np

    lo = G._dsk(datetime.date(2000, 2, 1))
    hi = G._dsk(datetime.date(2000, 2, 29))
    for prefix, sales, masks, kept in channels:
        d = sales[f"{prefix}_sold_date_sk"]
        cand = np.setdiff1d(np.nonzero((d >= lo) & (d <= hi) & ~masks[
            f"{prefix}_sold_date_sk"])[0], kept)
        sel = rng.choice(cand, 100, replace=False)
        sales[f"{prefix}_bill_customer_sk"][sel] = heavy[
            rng.integers(0, len(heavy), 100)]
        masks[f"{prefix}_bill_customer_sk"][sel] = False
        sales[f"{prefix}_item_sk"][sel] = hot[rng.integers(0, len(hot), 100)]
        for col in ("bill_customer_sk", "item_sk"):
            rewritten[f"{prefix}_{col}"] = \
                rewritten.get(f"{prefix}_{col}", 0) + len(sel)


def _plant_q58(rng, dsk0, d_week_seq, n_ids, channels, rewritten):
    """q58 keeps the items whose revenue in the week of 2000-01-03 agrees
    within 10% across the store, catalog and web channels; single lines of
    spread-out prices rarely do. Ten item ids no channel sells that week
    get one line in each channel at one price per id (lines outside each
    channel's `kept`), counted into `rewritten`."""
    import datetime

    import numpy as np

    wk = d_week_seq[(datetime.date(2000, 1, 3)
                     - datetime.date(1900, 1, 2)).days]
    week = dsk0 + np.nonzero(d_week_seq == wk)[0]
    lines, sold = {}, set()
    for prefix, sales, masks, kept in channels:
        m = np.isin(sales[f"{prefix}_sold_date_sk"], week) & \
            ~masks[f"{prefix}_sold_date_sk"]
        lines[prefix] = np.nonzero(m)[0]
        sold |= set(((sales[f"{prefix}_item_sk"][m] - 1) % n_ids).tolist())
    free = np.setdiff1d(np.arange(n_ids), np.fromiter(sold, np.int64))
    ids = rng.choice(free, 10, replace=False)
    prices = rng.integers(100_000, 1_000_000, 10)
    for prefix, sales, masks, kept in channels:
        sel = rng.choice(np.setdiff1d(lines[prefix], kept), 10,
                         replace=False)
        sales[f"{prefix}_item_sk"][sel] = ids + 1
        sales[f"{prefix}_ext_sales_price"][sel] = prices
        for col in ("item_sk", "ext_sales_price"):
            rewritten[f"{prefix}_{col}"] = \
                rewritten.get(f"{prefix}_{col}", 0) + len(sel)


def tpcds_data(scale: float = 1.0, seed: int = 10):
    """The 24 tables the tpcds queries read, the columns they read (names
    and types of tests/tpcds/schema.json), at TPCDS_ROWS with the facts,
    item, customer and customer_address times `scale`; built vectorised
    from numpy (seed `seed`): surrogate keys dense from 1 (date_dim: the
    TPC-DS julian keys of 1900-01-02 on; time_dim: seconds of the day),
    strings taken from tests/tpcds/datagen.py's pools by index, amounts as
    int64 cents into decimal(7,2). Tickets hold 1 to 20 line items that
    share date, time, customer, demographics, address and store; catalog
    and web orders 1 to 9. Returns are 10% samples of their sales lines,
    returned 1 to 150 days later. The channels share what the cross-channel
    queries join on: a third of the store returns' (customer, item) pairs
    buy again from the catalog within 120 days (q25, q29), and store
    sales lines as many as 5% of the catalog's repeat (customer, item,
    date) in the catalog, half of them on the web too (q78). Inventory
    holds weekly snapshots of every other item in every warehouse over the
    sales window (3% null quantities); the fourth slice's columns and the
    catalog_page and inventory tables draw from a third generator (seed
    + 2), the fifth slice's columns from a fourth (seed + 3), so every
    earlier column keeps its values. The households with no vehicle
    spell the buy potential 'Unknown' where datagen writes 'unknown' (q91
    reads the one, q34 and q73 the other, over households with vehicles
    only). Returns
    ({name: pyarrow.Table}, {name: numpy arrays} for the numpy oracles of
    q3, q7 and q19)."""
    import datetime

    import numpy as np
    import pyarrow as pa

    G = tpcds_datagen()
    rng = np.random.default_rng(seed)
    # the columns added for the third slice draw from their own generator,
    # so every earlier column keeps its values
    rng2 = np.random.default_rng(seed + 1)
    n = dict(TPCDS_ROWS)
    for k in ("store_sales", "store_returns", "catalog_sales",
              "catalog_returns", "web_sales", "web_returns", "item",
              "customer", "customer_address"):
        n[k] = max(1, int(n[k] * scale))
    strs = lambda vals: pa.array(list(vals), pa.string())  # noqa: E731
    pick = lambda pool, codes: strs(pool).take(pa.array(codes))  # noqa: E731
    dec = lambda c: _decimal_column(pa, c)  # noqa: E731

    def nulls(size, frac=0.02):
        return rng.random(size) < frac

    # date_dim: 1900-01-02 .. 2100-01-01; time_dim: one row per second
    dsk0 = G._dsk(datetime.date(1900, 1, 2))
    nd = n["date_dim"]
    days = np.datetime64("1900-01-02") + np.arange(nd)
    d_year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    d_moy = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    weekday = (days.astype(np.int64) + 3) % 7          # Monday 0
    dd = {"d_date_sk": dsk0 + np.arange(nd), "d_year": d_year,
          "d_moy": d_moy,
          "d_dom": (days - days.astype("datetime64[M]")).astype(np.int64)
          + 1,
          "d_dow": (weekday + 1) % 7,                  # Sunday 0
          "d_qoy": (d_moy - 1) // 3 + 1,
          "d_month_seq": (d_year - 1900) * 12 + d_moy - 1,
          "d_week_seq": (np.arange(nd) + 1) // 7 + 1}
    d_week_seq = dd["d_week_seq"]
    day_names = ("Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
                 "Saturday", "Sunday")
    t_sk = np.arange(n["time_dim"])

    # item: i_item_id spans several sks (datagen: 75% as many ids), pools
    ni = n["item"]
    n_ids = max(2, int(ni * 0.75))
    id_pool = strs(f"AAAAAAAA{i:08d}" for i in rng.permutation(n_ids))
    manufact_ids = np.array([128, 129, 350, 677, 738, 977]
                            + list(range(1, 1000, 7)))
    manufact_pool = strs(f"manufact{i}" for i in range(100))
    cat = rng.integers(0, len(G.CATEGORIES), ni)
    price = rng.integers(50, 30000, ni)
    item = {"i_item_sk": np.arange(1, ni + 1),
            "i_item_id": np.arange(ni) % n_ids,
            "i_brand_id": rng.integers(1001001, 10016017, ni),
            "i_brand": rng.integers(0, len(G.BRANDS), ni),
            "i_manufact_id": manufact_ids[rng.integers(
                0, len(manufact_ids), ni)],
            "i_manufact": np.arange(ni) % 100,
            "i_manager_id": rng.integers(1, 101, ni),
            "i_class_id": rng2.integers(1, 16, ni)}

    # customer_address, customer, store, promotion
    na, nc, ns, npr = (n["customer_address"], n["customer"], n["store"],
                       n["promotion"])
    ncd, nhd = n["customer_demographics"], n["household_demographics"]
    counties = G.CA_COUNTIES + [f"County {i}" for i in range(85)]
    ca = {"ca_address_sk": np.arange(1, na + 1),
          "ca_zip": rng.integers(10000, 99999, na)}
    cust = {"c_customer_sk": np.arange(1, nc + 1),
            "c_current_addr_sk": rng.integers(1, na + 1, nc)}
    first_sale = rng.integers(G._dsk(datetime.date(1998, 1, 1)),
                              G._dsk(datetime.date(2001, 1, 1)), nc)
    store = {"s_store_sk": np.arange(1, ns + 1),
             "s_zip": 38000 + np.arange(ns)}
    promo = {"p_promo_sk": np.arange(1, npr + 1),
             # datagen's pools: email N,N,N,Y; event N,N,Y (code 0 = 'N')
             "p_channel_email": (rng.integers(0, 4, npr) == 3).astype(int),
             "p_channel_event": (rng.integers(0, 3, npr) == 2).astype(int)}

    # customer_demographics: the specification's full cross product,
    # gender x marital x education x 20 x 4 x 7 x 7 x 7
    idx = np.arange(ncd)
    cd = {"cd_demo_sk": idx + 1, "cd_gender": idx % 2,
          "cd_marital_status": (idx // 2) % len(G.MARITAL),
          "cd_education_status": (idx // 10) % len(G.EDUCATION)}
    # household_demographics: income band x buy potential x dependants
    # (0-9) x vehicles (-1 to 4), the specification's 7,200 rows
    hidx = np.arange(nhd)

    # store_sales: tickets of 1-20 line items, 2% null keys, 30% null
    # promotions, amounts in cents
    nss = n["store_sales"]
    tk, n_tickets = _groups(rng, nss, 1, 20)
    lo = G._dsk(datetime.date(1998, 1, 2))
    hi = G._dsk(datetime.date(2002, 12, 30))
    ss = {"ss_sold_date_sk": rng.integers(lo, hi, n_tickets)[tk],
          "ss_sold_time_sk": rng.integers(0, n["time_dim"], n_tickets)[tk],
          "ss_item_sk": rng.integers(1, ni + 1, nss),
          "ss_customer_sk": rng.integers(1, nc + 1, n_tickets)[tk],
          "ss_cdemo_sk": rng.integers(1, ncd + 1, n_tickets)[tk],
          "ss_hdemo_sk": rng.integers(1, nhd + 1, n_tickets)[tk],
          "ss_addr_sk": rng.integers(1, na + 1, n_tickets)[tk],
          "ss_store_sk": rng.integers(1, ns + 1, n_tickets)[tk],
          "ss_promo_sk": rng.integers(1, npr + 1, nss),
          "ss_ticket_number": tk + 1}
    ss.update({f"ss_{k}": v for k, v in _line_prices(rng, nss).items()})
    ss_null = {c: nulls(nss, 0.3 if c == "ss_promo_sk" else 0.02)
               for c in ("ss_sold_date_sk", "ss_sold_time_sk",
                         "ss_customer_sk", "ss_cdemo_sk", "ss_hdemo_sk",
                         "ss_addr_sk", "ss_store_sk", "ss_promo_sk")}
    ss["ss_ext_discount_amt"] = ss["ss_ext_list_price"] - \
        ss["ss_ext_sales_price"]
    ss["ss_net_paid"] = ss["ss_ext_sales_price"] - ss["ss_coupon_amt"]
    sold = np.where(ss_null["ss_sold_date_sk"],
                    G._dsk(datetime.date(2000, 1, 1)), ss["ss_sold_date_sk"])

    # store_returns: a 10% sample of the lines
    r = np.sort(rng.permutation(nss)[:n["store_returns"]])
    nsr = len(r)
    rqty = np.maximum(1, (ss["ss_quantity"][r] * rng.uniform(0.2, 1.0, nsr))
                      .astype(np.int64))
    sr_date = sold[r] + rng.integers(1, 151, nsr)
    sr = {"sr_returned_date_sk": sr_date, "sr_item_sk": ss["ss_item_sk"][r],
          "sr_customer_sk": ss["ss_customer_sk"][r],
          "sr_ticket_number": ss["ss_ticket_number"][r],
          "sr_return_quantity": rqty,
          "sr_net_loss": np.rint(rqty * ss["ss_sales_price"][r] * 0.5)
          .astype(np.int64) + rng.integers(50, 10000, nsr),
          "sr_reason_sk": rng.integers(1, n["reason"] + 1, nsr),
          "sr_store_sk": ss["ss_store_sk"][r],
          "sr_return_amt": rqty * ss["ss_sales_price"][r]}
    sr_null = {"sr_returned_date_sk": nulls(nsr),
               "sr_customer_sk": ss_null["ss_customer_sk"][r],
               "sr_reason_sk": nulls(nsr),
               "sr_store_sk": ss_null["ss_store_sk"][r]}

    # lines shared across channels: store sales lines the catalog and the
    # web repeat (q78), store returns the catalog sells again (q25, q29)
    shared = rng.choice(nss, n["catalog_sales"] // 20, replace=False)
    again = rng.choice(nsr, nsr // 3, replace=False)
    # q23's shape, on store lines no return and no other channel copies
    kept = np.union1d(r, shared)
    hot_items, heavy, rewritten = _shape_store_sales(
        rng2, G, ss, ss_null, tk, n_tickets, ni, nc, kept)

    def channel(prefix, rows, shares, extra):
        """catalog or web sales: orders of 1-9 lines; the first lines
        repeat (customer, item, date) of each `shares` block."""
        o, n_orders = _groups(rng, rows, 1, 9)
        out = {f"{prefix}_sold_date_sk": rng.integers(lo, hi, n_orders)[o],
               f"{prefix}_item_sk": rng.integers(1, ni + 1, rows),
               f"{prefix}_bill_customer_sk":
               rng.integers(1, nc + 1, n_orders)[o],
               f"{prefix}_order_number": o + 1,
               f"{prefix}_ship_mode_sk": rng.integers(
                   1, n["ship_mode"] + 1, rows),
               f"{prefix}_warehouse_sk": rng.integers(
                   1, n["warehouse"] + 1, rows)}
        start = 0
        for cust_s, item_s, date_s in shares:
            k = min(len(cust_s), rows - start)
            for col, v in (("bill_customer_sk", cust_s), ("item_sk", item_s),
                           ("sold_date_sk", date_s)):
                out[f"{prefix}_{col}"][start:start + k] = v[:k]
            start += k
        out[f"{prefix}_ship_date_sk"] = out[f"{prefix}_sold_date_sk"] + \
            rng.integers(1, 151, rows)
        out.update({f"{prefix}_{k}": v
                    for k, v in _line_prices(rng, rows).items()})
        out.update(extra(o, n_orders, rows))
        return out

    ss_repeat = (ss["ss_customer_sk"][shared], ss["ss_item_sk"][shared],
                 sold[shared])
    cs = channel("cs", n["catalog_sales"], [
        ss_repeat,
        (sr["sr_customer_sk"][again], sr["sr_item_sk"][again],
         sold[r][again] + rng.integers(0, 121, len(again)))],
        lambda o, no, rows: {
            "cs_bill_cdemo_sk": rng.integers(1, ncd + 1, no)[o],
            "cs_call_center_sk": rng.integers(
                1, n["call_center"] + 1, no)[o],
            "cs_promo_sk": rng.integers(1, npr + 1, rows)})
    ws = channel("ws", n["web_sales"],
                 [tuple(v[:len(shared) // 2] for v in ss_repeat)],
                 lambda o, no, rows: {
                     "ws_bill_addr_sk": rng.integers(1, na + 1, no)[o],
                     "ws_web_page_sk": rng.integers(
                         1, n["web_page"] + 1, rows),
                     "ws_web_site_sk": rng.integers(
                         1, n["web_site"] + 1, rows)})
    ncs, nws = n["catalog_sales"], n["web_sales"]
    # q16, q94 and q95 keep the orders shipped from several warehouses
    # and drop the orders shipped from one: both kinds are present
    kinds = {}
    for prefix, sales in (("cs", cs), ("ws", ws)):
        pairs = np.unique(sales[f"{prefix}_order_number"]
                          * (n["warehouse"] + 1)
                          + sales[f"{prefix}_warehouse_sk"])
        per_order = np.bincount(pairs // (n["warehouse"] + 1))
        per_order = per_order[per_order > 0]
        kinds[prefix] = {"one_warehouse": int((per_order == 1).sum()),
                         "several": int((per_order > 1).sum())}
    print("tpcds orders by warehouses " + json.dumps(kinds), flush=True)
    cs_null = {c: nulls(ncs, 0.3 if c == "cs_promo_sk" else 0.02)
               for c in ("cs_sold_date_sk", "cs_ship_date_sk",
                         "cs_bill_customer_sk", "cs_bill_cdemo_sk",
                         "cs_call_center_sk", "cs_ship_mode_sk",
                         "cs_warehouse_sk", "cs_promo_sk")}
    ws_null = {c: nulls(nws)
               for c in ("ws_sold_date_sk", "ws_ship_date_sk",
                         "ws_bill_customer_sk", "ws_bill_addr_sk",
                         "ws_ship_mode_sk", "ws_warehouse_sk",
                         "ws_web_page_sk", "ws_web_site_sk")}
    # the third slice's channel columns: the shipping customer is the
    # billed one 85% of the time (datagen's rule), addresses per line
    for prefix, sales, masks, rows in (("cs", cs, cs_null, ncs),
                                       ("ws", ws, ws_null, nws)):
        bill = sales[f"{prefix}_bill_customer_sk"]
        sales[f"{prefix}_ship_customer_sk"] = np.where(
            rng2.random(rows) < 0.85, bill, rng2.integers(1, nc + 1, rows))
        sales[f"{prefix}_sold_time_sk"] = rng2.integers(0, n["time_dim"],
                                                        rows)
        sales[f"{prefix}_ext_discount_amt"] = \
            sales[f"{prefix}_ext_list_price"] - \
            sales[f"{prefix}_ext_sales_price"]
        net_paid = sales[f"{prefix}_ext_sales_price"] - \
            sales[f"{prefix}_coupon_amt"]
        if prefix == "cs":
            sales["cs_bill_addr_sk"] = rng2.integers(1, na + 1, rows)
            sales["cs_ship_addr_sk"] = rng2.integers(1, na + 1, rows)
            sales["cs_net_paid_inc_tax"] = net_paid + sales["cs_ext_tax"]
            sales["cs_net_paid"] = net_paid
        else:
            sales["ws_net_paid"] = net_paid
        masks.update({f"{prefix}_{c}": rng2.random(rows) < 0.02
                      for c in ("ship_customer_sk", "sold_time_sk")})
        if prefix == "cs":
            masks.update({c: rng2.random(rows) < 0.02
                          for c in ("cs_bill_addr_sk", "cs_ship_addr_sk")})

    def returns(sales, prefix, rows):
        """A 10% sample of the sales lines and each return's amount."""
        s = np.sort(rng.permutation(len(sales[f"{prefix}_item_sk"]))[:rows])
        q = np.maximum(1, (sales[f"{prefix}_quantity"][s]
                           * rng.uniform(0.2, 1.0, len(s))).astype(np.int64))
        return s, q, q * sales[f"{prefix}_sales_price"][s]

    def returned_on(sales, prefix, s):
        """Each return's date: 1 to 150 days after its sale."""
        return sales[f"{prefix}_sold_date_sk"][s] + \
            rng2.integers(1, 151, len(s))

    c_s, c_q, c_amt = returns(cs, "cs", n["catalog_returns"])
    cr = {"cr_item_sk": cs["cs_item_sk"][c_s],
          "cr_order_number": cs["cs_order_number"][c_s],
          "cr_refunded_cash": np.rint(c_amt * 0.7).astype(np.int64),
          "cr_reversed_charge": np.rint(c_amt * 0.2).astype(np.int64),
          "cr_store_credit": np.rint(c_amt * 0.1).astype(np.int64),
          "cr_returned_date_sk": returned_on(cs, "cs", c_s),
          "cr_returning_customer_sk": cs["cs_ship_customer_sk"][c_s],
          "cr_returning_addr_sk": cs["cs_ship_addr_sk"][c_s],
          "cr_return_quantity": c_q,
          "cr_return_amount": c_amt,
          "cr_return_amt_inc_tax": np.rint(c_amt * 1.05).astype(np.int64)}
    cr_null = {"cr_returned_date_sk": rng2.random(len(c_s)) < 0.02,
               "cr_returning_customer_sk":
               cs_null["cs_ship_customer_sk"][c_s],
               "cr_returning_addr_sk": cs_null["cs_ship_addr_sk"][c_s]}
    w_s, w_q, w_amt = returns(ws, "ws", n["web_returns"])
    nwr = len(w_s)
    # q23's and q58's lines, on sales lines no return reads
    _plant_q23_channels(rng2, G, (("cs", cs, cs_null, c_s),
                                  ("ws", ws, ws_null, w_s)),
                        hot_items, heavy, rewritten)
    _plant_q58(rng2, dsk0, d_week_seq, n_ids,
               (("ss", ss, ss_null, kept), ("cs", cs, cs_null, c_s),
                ("ws", ws, ws_null, w_s)), rewritten)
    print("tpcds shaping rewrote (lines by column) "
          + json.dumps(rewritten), flush=True)
    refunded = rng.integers(1, ncd + 1, nwr)
    wr = {"wr_item_sk": ws["ws_item_sk"][w_s],
          "wr_order_number": ws["ws_order_number"][w_s],
          "wr_refunded_cdemo_sk": refunded,
          # the returning customer is the refunded one 85% of the time
          "wr_returning_cdemo_sk": np.where(rng.random(nwr) < 0.85, refunded,
                                            rng.integers(1, ncd + 1, nwr)),
          "wr_refunded_addr_sk": rng.integers(1, na + 1, nwr),
          "wr_reason_sk": rng.integers(1, n["reason"] + 1, nwr),
          "wr_refunded_cash": np.rint(w_amt * 0.7).astype(np.int64),
          "wr_fee": rng.integers(50, 10000, nwr),
          "wr_returned_date_sk": returned_on(ws, "ws", w_s),
          "wr_returning_customer_sk": ws["ws_ship_customer_sk"][w_s],
          "wr_returning_addr_sk": rng2.integers(1, na + 1, nwr),
          "wr_return_quantity": w_q,
          "wr_return_amt": w_amt}
    wr_null = {"wr_returned_date_sk": rng2.random(nwr) < 0.02,
               "wr_returning_customer_sk":
               ws_null["ws_ship_customer_sk"][w_s]}

    # the fourth slice's columns and tables draw from a generator of their
    # own too: the channels' catalog pages, household demographics, promos
    # and net amounts, and the weekly inventory snapshots (datagen's shape:
    # every week of the sales window x half the items x every warehouse)
    rng3 = np.random.default_rng(seed + 2)
    ncp = n["catalog_page"]
    cs["cs_bill_hdemo_sk"] = rng3.integers(1, nhd + 1, ncs)
    cs["cs_catalog_page_sk"] = rng3.integers(1, ncp + 1, ncs)
    cs_null.update({c: rng3.random(ncs) < 0.02
                    for c in ("cs_bill_hdemo_sk", "cs_catalog_page_sk")})
    ws["ws_promo_sk"] = rng3.integers(1, npr + 1, nws)
    ws_null["ws_promo_sk"] = rng3.random(nws) < 0.3
    cr["cr_catalog_page_sk"] = cs["cs_catalog_page_sk"][c_s]
    cr_null["cr_catalog_page_sk"] = cs_null["cs_catalog_page_sk"][c_s]
    cr["cr_net_loss"] = np.rint(c_amt * 0.5).astype(np.int64) + \
        rng3.integers(50, 10000, len(c_s))
    wr["wr_net_loss"] = np.rint(w_amt * 0.5).astype(np.int64) + \
        rng3.integers(50, 10000, nwr)
    weeks = G._dsk(datetime.date(1998, 1, 2)) + 7 * np.arange(261)
    inv_items = np.arange(1, ni + 1, 2)[:ni // 2]
    nw = n["warehouse"]
    per_week = len(inv_items) * nw
    inv_qty_null = rng3.random(len(weeks) * per_week) < 0.03
    inventory = {
        "inv_date_sk": np.repeat(weeks.astype(np.int32), per_week),
        "inv_item_sk": np.tile(np.repeat(inv_items.astype(np.int32), nw),
                               len(weeks)),
        "inv_warehouse_sk": np.tile(np.arange(1, nw + 1, dtype=np.int32),
                                    len(weeks) * len(inv_items)),
        "inv_quantity_on_hand": rng3.integers(0, 1001, len(inv_qty_null),
                                              dtype=np.int32)}

    # the fifth slice's columns draw from a fourth generator: ship costs,
    # the web channel's shipping household and address (one per order),
    # the returns' call centre, web page and demographics
    rng4 = np.random.default_rng(seed + 3)
    for prefix, sales, masks, rows in (("cs", cs, cs_null, ncs),
                                       ("ws", ws, ws_null, nws)):
        sales[f"{prefix}_ext_ship_cost"] = \
            sales[f"{prefix}_quantity"] * rng4.integers(0, 1000, rows)
    n_ws_orders = int(ws["ws_order_number"].max())
    ws["ws_ship_addr_sk"] = rng4.integers(
        1, na + 1, n_ws_orders)[ws["ws_order_number"] - 1]
    ws["ws_ship_hdemo_sk"] = rng4.integers(1, nhd + 1, nws)
    ws_null.update({c: rng4.random(nws) < 0.02
                    for c in ("ws_ship_addr_sk", "ws_ship_hdemo_sk")})
    cr["cr_call_center_sk"] = cs["cs_call_center_sk"][c_s]
    cr_null["cr_call_center_sk"] = cs_null["cs_call_center_sk"][c_s]
    wr["wr_web_page_sk"] = ws["ws_web_page_sk"][w_s]
    wr_null["wr_web_page_sk"] = ws_null["ws_web_page_sk"][w_s]
    sr["sr_cdemo_sk"] = rng4.integers(1, ncd + 1, nsr)
    sr_null["sr_cdemo_sk"] = rng4.random(nsr) < 0.02

    def ints(cols, null_masks=None):
        null_masks = null_masks or {}
        return {k: _int_column(pa, v, null_masks.get(k))
                for k, v in cols.items()}

    def decs(cols):
        return {k: dec(v) for k, v in cols.items()}

    def split(cols, decimal_names):
        return ({k: v for k, v in cols.items()
                 if k.split("_", 1)[1] not in decimal_names},
                {k: v for k, v in cols.items()
                 if k.split("_", 1)[1] in decimal_names})

    money = ("wholesale_cost", "list_price", "sales_price", "ext_sales_price",
             "ext_wholesale_cost", "ext_list_price", "ext_tax", "coupon_amt",
             "net_profit", "net_loss", "refunded_cash", "reversed_charge",
             "store_credit", "fee", "ext_discount_amt", "net_paid",
             "net_paid_inc_tax", "return_amt", "return_amount",
             "return_amt_inc_tax", "ext_ship_cost")
    tables = {}
    for name, cols, masks in (("store_sales", ss, ss_null),
                              ("store_returns", sr, sr_null),
                              ("catalog_sales", cs, cs_null),
                              ("catalog_returns", cr, cr_null),
                              ("web_sales", ws, ws_null),
                              ("web_returns", wr, wr_null)):
        keys, amounts = split(cols, money)
        tables[name] = pa.table({**ints(keys, masks), **decs(amounts)})
    tables["date_dim"] = pa.table({
        **ints(dd), "d_day_name": pick(day_names, weekday),
        "d_date": pa.array(days),
        "d_quarter_name": pa.array(np.char.add(
            np.char.add(d_year.astype(str), "Q"),
            dd["d_qoy"].astype(str)).astype(object), pa.string())})
    hour = t_sk // 3600
    meal = np.select([(hour >= 6) & (hour <= 9), (hour >= 11) & (hour <= 13),
                      (hour >= 17) & (hour <= 20)], [0, 1, 2], 3)
    tables["time_dim"] = pa.table({
        **ints({"t_time_sk": t_sk, "t_hour": hour,
                "t_minute": (t_sk // 60) % 60, "t_time": t_sk}),
        "t_meal_time": pa.array(["breakfast", "lunch", "dinner", None],
                                pa.string()).take(pa.array(meal))})
    tables["item"] = pa.table({
        **ints({k: item[k] for k in ("i_item_sk", "i_brand_id",
                                     "i_manufact_id", "i_manager_id",
                                     "i_class_id")}),
        "i_size": pick(G.SIZES, rng2.integers(0, len(G.SIZES), ni)),
        "i_units": pick(G.UNITS, rng2.integers(0, len(G.UNITS), ni)),
        "i_item_id": id_pool.take(pa.array(item["i_item_id"])),
        "i_brand": pick(G.BRANDS, item["i_brand"]),
        "i_manufact": manufact_pool.take(pa.array(item["i_manufact"])),
        "i_item_desc": strs(f"item description {i}" for i in range(ni)),
        "i_product_name": strs(f"product{i}" for i in range(ni)),
        "i_category_id": _int_column(pa, cat + 1),
        "i_category": pick(G.CATEGORIES, cat),
        "i_class": pick(G.CLASSES, rng3.integers(0, len(G.CLASSES), ni)),
        "i_color": pick(G.COLORS, rng.integers(0, len(G.COLORS), ni)),
        "i_current_price": dec(price),
        "i_wholesale_cost": dec(np.rint(price * 0.6).astype(np.int64))})
    tables["customer_address"] = pa.table({
        "ca_address_sk": _int_column(pa, ca["ca_address_sk"]),
        "ca_zip": strs(f"{z:05d}" for z in range(10000, 99999)).take(
            pa.array(ca["ca_zip"] - 10000)),
        "ca_street_number": pick([str(i) for i in range(1, 1000)],
                                 rng.integers(0, 999, na)),
        "ca_street_name": pick(G.STREET_NAMES,
                               rng.integers(0, len(G.STREET_NAMES), na)),
        "ca_city": pick(G.CA_CITIES, rng.integers(0, len(G.CA_CITIES), na)),
        "ca_county": pick(counties, rng.integers(0, len(counties), na)),
        "ca_state": pick(G.CA_STATES, rng.integers(0, len(G.CA_STATES), na)),
        "ca_country": pick(["United States"], np.zeros(na, np.int64)),
        "ca_street_type": pick(G.STREET_TYPES, rng2.integers(
            0, len(G.STREET_TYPES), na)),
        "ca_suite_number": pick([f"Suite {i}" for i in range(80)],
                                np.arange(na) % 80),
        "ca_gmt_offset": _decimal_column(
            pa, rng2.choice([-500, -600, -700, -800], na), 5, 2),
        "ca_location_type": pick(["apartment", "condo", "single family"],
                                 rng2.integers(0, 3, na))})

    def names(pool, size):
        return pa.array(np.array(pool, dtype=object)[
            rng.integers(0, len(pool), size)], pa.string(),
            mask=nulls(size))

    tables["customer"] = pa.table({
        **ints(cust),
        "c_current_cdemo_sk": _int_column(pa, rng.integers(1, ncd + 1, nc),
                                          nulls(nc)),
        "c_current_hdemo_sk": _int_column(pa, rng.integers(1, nhd + 1, nc),
                                          nulls(nc)),
        "c_first_sales_date_sk": _int_column(pa, first_sale),
        "c_first_shipto_date_sk": _int_column(pa, first_sale + 30),
        "c_salutation": names(["Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir"],
                              nc),
        "c_first_name": names(G.FIRST_NAMES, nc),
        "c_last_name": names(G.LAST_NAMES, nc),
        "c_preferred_cust_flag": names(["Y", "N"], nc),
        "c_customer_id": strs(f"AAAAAAAA{i:08d}" for i in range(nc)),
        # upper case, as the specification's generator writes it (q24
        # compares it with upper(ca_country))
        "c_birth_country": pa.array(np.array(
            [c.upper() for c in G.COUNTRIES], dtype=object)[
            rng2.integers(0, len(G.COUNTRIES), nc)], pa.string(),
            mask=rng2.random(nc) < 0.02),
        **{f"c_birth_{k}": _int_column(pa, rng2.integers(lo_, hi_, nc),
                                       rng2.random(nc) < 0.02)
           for k, lo_, hi_ in (("day", 1, 29), ("month", 1, 13),
                               ("year", 1930, 1993))},
        "c_login": pa.nulls(nc, pa.string()),
        "c_email_address": strs(f"c{i}@example.com" for i in range(nc)),
        "c_last_review_date": _int_column(pa, rng2.integers(
            G._dsk(datetime.date(1999, 1, 1)),
            G._dsk(datetime.date(2002, 1, 1)), nc))})
    si = np.arange(ns)
    tables["store"] = pa.table({
        "s_store_sk": _int_column(pa, store["s_store_sk"]),
        "s_zip": strs(str(z) for z in store["s_zip"]),
        "s_store_id": strs(f"AAAAAAAA{i % max(1, ns // 2):08d}" for i in si),
        "s_store_name": pick(G.STORE_NAMES, si % len(G.STORE_NAMES)),
        "s_company_id": _int_column(pa, np.ones(ns, np.int64)),
        "s_street_number": strs(str(i * 10 + 1) for i in si),
        "s_street_name": pick(G.STREET_NAMES, si % len(G.STREET_NAMES)),
        "s_street_type": pick(G.STREET_TYPES, si % len(G.STREET_TYPES)),
        "s_suite_number": strs(f"Suite {i}" for i in si),
        "s_city": pick(["Fairview"] * 6 + ["Midway"] * 3 + ["Salem"],
                       si % 10),
        "s_county": pick(["Franklin Parish", "Williamson County"],
                         ((si + 1) % 8 != 0).astype(np.int64)),
        "s_state": pick(["TN"], np.zeros(ns, np.int64)),
        "s_gmt_offset": _decimal_column(pa, np.full(ns, -500), 5, 2),
        "s_number_employees": _int_column(pa, rng.integers(200, 301, ns)),
        "s_market_id": _int_column(pa, rng2.integers(1, 11, ns)),
        "s_company_name": pick(["Unknown"], np.zeros(ns, np.int64))})
    tables["promotion"] = pa.table({
        "p_promo_sk": _int_column(pa, promo["p_promo_sk"]),
        "p_channel_email": pick("NY", promo["p_channel_email"]),
        "p_channel_event": pick("NY", promo["p_channel_event"]),
        # datagen's pool: N,N,N,Y
        "p_channel_tv": pick("NY", (rng3.integers(0, 4, npr) == 3)
                             .astype(np.int64)),
        "p_channel_dmail": pick("YN", rng4.integers(0, 2, npr))})
    tables["customer_demographics"] = pa.table({
        "cd_demo_sk": _int_column(pa, cd["cd_demo_sk"]),
        "cd_gender": pick("MF", cd["cd_gender"]),
        "cd_marital_status": pick(G.MARITAL, cd["cd_marital_status"]),
        "cd_education_status": pick(G.EDUCATION,
                                    cd["cd_education_status"]),
        # the rest of the specification's cross product: purchase
        # estimate x credit rating x dependants, employed, at college
        "cd_purchase_estimate": _int_column(pa, (idx // 70 % 20 + 1) * 500),
        "cd_credit_rating": pick(G.CREDIT, idx // 1400 % 4),
        "cd_dep_count": _int_column(pa, idx // 5600 % 7),
        "cd_dep_employed_count": _int_column(pa, idx // 39200 % 7),
        "cd_dep_college_count": _int_column(pa, idx // 274400 % 7)})
    # q91 reads the specification's 'Unknown' (LIKE 'Unknown%'), q34 and
    # q73 datagen's 'unknown' over households with vehicles: the households
    # with no vehicle (q34 and q73 never read them) take the first
    buy = np.array(G.BUY_POTENTIAL + ["Unknown"], dtype=object)
    potential = (hidx // 60) % 6
    spelled = (buy[potential] == "unknown") & (hidx % 6 - 1 <= 0)
    potential = np.where(spelled, len(G.BUY_POTENTIAL), potential)
    print(f"tpcds shaping spelled {int(spelled.sum())} households' "
          "buy potential 'Unknown'", flush=True)
    tables["household_demographics"] = pa.table({
        **ints({"hd_demo_sk": hidx + 1,
                "hd_income_band_sk": hidx // 360 + 1,
                "hd_dep_count": (hidx // 6) % 10,
                "hd_vehicle_count": hidx % 6 - 1}),
        "hd_buy_potential": pick(list(buy), potential)})
    nib = n["income_band"]
    tables["income_band"] = pa.table(ints({
        "ib_income_band_sk": np.arange(1, nib + 1),
        "ib_lower_bound": np.arange(nib) * 10000,
        "ib_upper_bound": (np.arange(nib) + 1) * 10000}))
    for name, sk, label, fmt in (
            ("ship_mode", "sm_ship_mode_sk", "sm_type", None),
            ("warehouse", "w_warehouse_sk", "w_warehouse_name",
             "Warehouse number {} of the west"),
            ("web_site", "web_site_sk", "web_name", "site_{}"),
            ("call_center", "cc_call_center_sk", "cc_name",
             "call center {}"),
            ("reason", "r_reason_sk", "r_reason_desc", "reason {}")):
        k = np.arange(1, n[name] + 1)
        labels = pick(G.SM_TYPES, (k - 1) % len(G.SM_TYPES)) \
            if fmt is None else strs(fmt.format(i) for i in k)
        tables[name] = pa.table({sk: _int_column(pa, k), label: labels})
    sm = np.arange(n["ship_mode"])
    tables["ship_mode"] = tables["ship_mode"].append_column(
        "sm_carrier", pick(G.SM_CARRIERS, sm % len(G.SM_CARRIERS)))
    nw = n["warehouse"]
    for name, col in (
            ("w_warehouse_sq_ft", _int_column(
                pa, rng2.integers(50000, 1000000, nw))),
            ("w_city", pick(G.CA_CITIES,
                            rng2.integers(0, len(G.CA_CITIES), nw))),
            ("w_county", pick(["Williamson County"], np.zeros(nw, np.int64))),
            ("w_state", pick(["TN"], np.zeros(nw, np.int64))),
            ("w_country", pick(["United States"], np.zeros(nw, np.int64)))):
        tables["warehouse"] = tables["warehouse"].append_column(name, col)
    tables["web_page"] = pa.table(ints({
        "wp_web_page_sk": np.arange(1, n["web_page"] + 1),
        "wp_char_count": rng4.integers(2000, 8000, n["web_page"])}))
    tables["web_site"] = tables["web_site"].append_column(
        "web_site_id", strs(f"AAAAAAAA{i:08d}"
                            for i in range(n["web_site"])))
    # datagen's pools: three of every six sites are 'pri'
    tables["web_site"] = tables["web_site"].append_column(
        "web_company_name", pick(["pri", "able", "ese", "anti"],
                                 np.array([0, 0, 0, 1, 2, 3])[
                                     np.arange(n["web_site"]) % 6]))
    ncc = n["call_center"]
    for name, col in (
            ("cc_call_center_id", strs(f"AAAAAAAA{i:08d}"
                                       for i in range(ncc))),
            ("cc_manager", pick(G.FIRST_NAMES, rng4.integers(
                0, len(G.FIRST_NAMES), ncc))),
            # datagen's single county
            ("cc_county", pick(["Williamson County"],
                               np.zeros(ncc, np.int64)))):
        tables["call_center"] = tables["call_center"].append_column(
            name, col)
    tables["catalog_page"] = pa.table({
        "cp_catalog_page_sk": _int_column(pa, np.arange(1, ncp + 1)),
        "cp_catalog_page_id": strs(f"AAAAAAAA{i:08d}" for i in range(ncp))})
    tables["inventory"] = pa.table({
        **{k: pa.array(v, pa.int32()) for k, v in inventory.items()
           if k != "inv_quantity_on_hand"},
        "inv_quantity_on_hand": pa.array(inventory["inv_quantity_on_hand"],
                                         pa.int32(), mask=inv_qty_null)})
    assert set(tables) == set(TPCDS_ROWS)

    arrays = {"dd": dd, "dsk0": dsk0, "item": item, "ca": ca, "cust": cust,
              "store": store, "promo": promo, "cd": cd, "ss": ss,
              "nulls": ss_null, "id_pool": id_pool.to_pylist(),
              "manufact_pool": manufact_pool.to_pylist(), "datagen": G}
    return tables, arrays


def _group_sum(keys, values):
    """(unique key rows, int64 sums, counts) of `values` grouped by the
    columns of `keys` (int64 arrays), exact."""
    import numpy as np

    stacked = np.stack(keys, axis=1)
    uniq, inv = np.unique(stacked, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind="stable")
    starts = np.searchsorted(inv[order], np.arange(len(uniq)))
    sums = [np.add.reduceat(v[order].astype(np.int64), starts)
            for v in values]
    return uniq, sums, np.bincount(inv, minlength=len(uniq))


def _dec(v) -> int:
    """A decimal(p, 2) value from Arrow as int64 cents."""
    return int(v.scaleb(2))


def _check_topk(label: str, got_rows: list, oracle_rows: list, key,
                limit: int = 100) -> str:
    """ORDER BY + LIMIT against the full oracle result: the rows come in
    ORDER BY order, they are min(limit, n) rows of the oracle result, and
    they hold every oracle row that sorts strictly before the last one."""
    if len(got_rows) != min(limit, len(oracle_rows)):
        fail(f"{label}: {len(got_rows)} rows, not "
             f"min({limit}, {len(oracle_rows)})")
    keys = [key(r) for r in got_rows]
    if keys != sorted(keys):
        fail(f"{label}: the rows are not in ORDER BY order")
    pool = {}
    for r in oracle_rows:
        pool[r] = pool.get(r, 0) + 1
    for r in got_rows:
        if pool.get(r, 0) <= 0:
            fail(f"{label}: row {r} is not in the oracle result")
        pool[r] -= 1
    if got_rows:
        last = key(got_rows[-1])
        before = sorted(r for r in oracle_rows if key(r) < last)
        if sorted(r for r in got_rows if key(r) < last) != before:
            fail(f"{label}: a row before the last one is missing")
    return (f"{len(got_rows)} rows of {len(oracle_rows)} equal to the numpy "
            "oracle in ORDER BY order")


def tpcds_oracle(query: str, a: dict) -> tuple[list, callable]:
    """The full result of `query` (no LIMIT) from numpy, exact, as rows of
    Python values shaped like the collected Arrow rows (decimals in int64
    units of their scale); and the ORDER BY key of a row."""
    import numpy as np

    G = a["datagen"]
    ss, nulls, it = a["ss"], a["nulls"], a["item"]
    d_idx = ss["ss_sold_date_sk"] - a["dsk0"]
    year, moy = a["dd"]["d_year"][d_idx], a["dd"]["d_moy"][d_idx]
    item = ss["ss_item_sk"] - 1
    if query == "q3":
        sel = ~nulls["ss_sold_date_sk"] & (moy == 11) &             (it["i_manufact_id"][item] == 128)
        keys, (s,), _ = _group_sum(
            [year[sel], it["i_brand"][item[sel]], it["i_brand_id"][item[sel]]],
            [ss["ss_ext_sales_price"][sel]])
        rows = [(int(y), int(bid), G.BRANDS[b], int(v))
                for (y, b, bid), v in zip(keys, s)]
        return rows, lambda r: (r[0], -r[3], r[1])
    if query == "q7":
        cd, promo = a["cd"], a["promo"]
        c = ss["ss_cdemo_sk"] - 1
        p = ss["ss_promo_sk"] - 1
        sel = ~nulls["ss_sold_date_sk"] & ~nulls["ss_cdemo_sk"] &             ~nulls["ss_promo_sk"] & (year == 2000) &             (cd["cd_gender"][c] == 0) &             (cd["cd_marital_status"][c] == G.MARITAL.index("S")) &             (cd["cd_education_status"][c] == G.EDUCATION.index("College")) &             ((promo["p_channel_email"][p] == 0) |
             (promo["p_channel_event"][p] == 0))
        cols = ("ss_quantity", "ss_list_price", "ss_coupon_amt",
                "ss_sales_price")
        keys, sums, cnt = _group_sum([it["i_item_id"][item[sel]]],
                                     [ss[col][sel] for col in cols])
        n = cnt.astype(np.float64)
        # the reference's lowering: avg(int) = sum / count in float64;
        # avg(decimal(7,2)) = cast(sum / 10^2 / count as decimal(11,6)),
        # the cast rounding half to even
        agg1 = sums[0].astype(np.float64) / n
        decs = [np.rint(s.astype(np.float64) / 100.0 / n * 1e6)
                .astype(np.int64) for s in sums[1:]]
        rows = [(a["id_pool"][k[0]], float(agg1[i]),
                 int(decs[0][i]), int(decs[1][i]), int(decs[2][i]))
                for i, k in enumerate(keys)]
        return rows, lambda r: r[0]
    if query == "q19":
        cust = ss["ss_customer_sk"] - 1
        addr = a["cust"]["c_current_addr_sk"][cust] - 1
        zip_ca = a["ca"]["ca_zip"][addr]
        zip_s = a["store"]["s_zip"][ss["ss_store_sk"] - 1]
        sel = ~nulls["ss_sold_date_sk"] & ~nulls["ss_customer_sk"] &             ~nulls["ss_store_sk"] & (it["i_manager_id"][item] == 8) &             (moy == 11) & (year == 1998) & (zip_ca != zip_s)
        keys, (s,), _ = _group_sum(
            [it["i_brand"][item[sel]], it["i_brand_id"][item[sel]],
             it["i_manufact_id"][item[sel]], it["i_manufact"][item[sel]]],
            [ss["ss_ext_sales_price"][sel]])
        rows = [(int(bid), G.BRANDS[b], int(mid), a["manufact_pool"][m],
                 int(v)) for (b, bid, mid, m), v in zip(keys, s)]
        return rows, lambda r: (-r[4], r[1], r[0], r[2], r[3])
    raise ValueError(query)


def tpcds_rows(query: str, out) -> list:
    """The collected Arrow result as oracle-shaped rows."""
    rows = []
    for r in out.to_pylist():
        if query == "q3":
            rows.append((r["d_year"], r["brand_id"], r["brand"],
                         _dec(r["sum_agg"])))
        elif query == "q7":
            rows.append((r["i_item_id"], r["agg1"],
                         *(int(r[c].scaleb(6)) for c in
                           ("agg2", "agg3", "agg4"))))
        else:
            rows.append((r["brand_id"], r["brand"], r["i_manufact_id"],
                         r["i_manufact"], _dec(r["ext_price"])))
    return rows


def tpcds_text(query: str) -> str:
    return open(os.path.join(ROOT, "tests", "tpcds", "queries",
                             f"{query}.sql")).read()


def tpcds_golden_oracle():
    """tests/tpcds/oracle.py (the goldens' comparison), loaded from its
    path as tpcds_datagen is."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "tpcds_oracle", os.path.join(ROOT, "tests", "tpcds", "oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# result columns that hold sums of doubles: the card adds them in atomic
# order, the CPU in index_add_ order, so they agree to relative 1e-12 and
# every other column exactly
FLOAT_SUM_COLUMNS = {
    "q66": tuple(f"{m}_sales_per_sq_foot" for m in (
        "jan", "feb", "mar", "apr", "may", "jun", "jul", "aug", "sep", "oct",
        "nov", "dec")),
    "q75": ("sales_amt_diff",),
}


# the ORDER BY keys of results whose ties the plan may order either way
# (q75 orders by an integer difference only, and its CTE's rows come in
# another order at another tier): rows with equal keys compare as a
# multiset, and LIMIT may cut the last group of ties anywhere
TIED_ORDER = {"q75": ("sales_cnt_diff",)}


def _rows_equal(a: dict, b: dict, floats) -> bool:
    import math

    for col, x in b.items():
        y = a[col]
        if col in floats and x is not None and y is not None:
            if not math.isclose(x, y, rel_tol=1e-12):
                return False
        elif x != y:
            return False
    return True


def same_result(query: str, got, want) -> bool:
    """The card's Arrow result equals the CPU's: schema and rows in order,
    exactly but for the float-sum columns of FLOAT_SUM_COLUMNS, and but for
    the order of ties under TIED_ORDER's keys."""
    floats = FLOAT_SUM_COLUMNS.get(query, ())
    if got.schema != want.schema or got.num_rows != want.num_rows:
        return False
    g, w = got.to_pylist(), want.to_pylist()
    keys = TIED_ORDER.get(query)
    if keys:
        gk = [tuple(r[k] for k in keys) for r in g]
        if gk != [tuple(r[k] for k in keys) for r in w]:
            return False

        def exact(r):
            return repr(tuple(v for c, v in r.items() if c not in floats))

        # the last group of ties may hold other rows; the others, sorted
        # by their exact columns, pair up
        last = gk[-1] if gk else None
        g = sorted((r for r, k in zip(g, gk) if k != last), key=exact)
        w = sorted((r for r, k in zip(w, gk) if k != last), key=exact)
    return all(_rows_equal(a, b, floats) for a, b in zip(g, w))


def tpcds_gate(torch) -> None:
    """Every tpcds query on the card over tests/tpcds/datagen.py's tables
    at scale 0.1 (the tests' conf: 2^10-row tiles, 4 partitions), at
    forced `whole` with every tile fused (minRows 0; a plan the whole tier
    cannot lower stays staged, with its reason): as written, equal to a
    TorchSession(device="cpu") run at the operator tier row for row, and
    with its trailing LIMIT dropped, equal to its committed golden under
    tests/tpcds/oracle.py's comparison. The pass at the stage tier was cut
    to pay for the maintenance leg (PERF.md section 5)."""
    from spark_tpu_torch import TorchSession

    G, O = tpcds_datagen(), tpcds_golden_oracle()
    t0 = time.perf_counter()
    tables = G.gen_tpcds_full(scale=0.1)
    conf = {"spark.sql.shuffle.partitions": 4,
            "spark.tpu.batch.capacity": 1 << 10,
            "spark.tpu.fusion.minRows": 0}
    cards = {"whole": session(dict(conf, **{TIER: "whole"}))}
    cpu = TorchSession("chip_smoke_cpu", dict(conf, **{TIER: "operator"}),
                       device="cpu")
    for name, table in tables.items():
        for s in (cpu, *cards.values()):
            s.createDataFrame(table).createOrReplaceTempView(name)
    rows, wants = {}, {}
    for q in TPCDS_QUERIES:
        wants[q] = cpu.sql(tpcds_text(q)).toArrow()
    cpu.stop()
    for tier, card in cards.items():
        t1 = time.perf_counter()
        c0, m0 = stage_counters(), card.metrics
        fused_files, whole_files = 0, []
        for q in TPCDS_QUERIES:
            text = tpcds_text(q)
            got_df = card.sql(text)
            fused_files += bool(fused_stages(got_df))
            if type(got_df.query_execution.physical).__name__ == \
                    "WholeQueryExec":
                whole_files.append(q)
            got = got_df.toArrow()
            if not same_result(q, got, wants[q]):
                fail(f"tpcds_gate {q}: the card's result at the {tier} "
                     "tier differs from the CPU's")
            full = card.sql(O.strip_trailing_limit(text)).toArrow()
            cols = [full.column(i).to_pylist()
                    for i in range(full.num_columns)]
            norm = sorted([tuple(O._norm_cell(c) for c in r)
                           for r in zip(*cols)], key=O._sort_key)
            golden = json.load(open(os.path.join(
                ROOT, "tests", "tpcds", "expected", f"{q}.json")))
            ok, msg = O.compare_rows(norm,
                                     [tuple(r) for r in golden["rows"]])
            if not ok:
                fail(f"tpcds_gate {q}: not its golden at the {tier} tier: "
                     f"{msg}")
            rows[q] = got.num_rows
        m = _delta(card.metrics, m0)
        gated = m.get("fusion.min_rows_gated", 0)
        card.stop()
        cache = _delta(stage_counters(), c0)
        if gated:
            fail(f"tpcds_gate: {gated} batches took the unfused kernels at "
                 "minRows 0")
        print(f"tpcds_gate {tier}: {len(rows)} queries equal to their "
              f"goldens and to the CPU's operator tier in "
              f"{time.perf_counter() - t1:.1f} s; {fused_files} plans fuse"
              + (f"; {len(whole_files)} whole programs, "
                 f"{m.get('whole_query.dispatches', 0)} dispatches, "
                 f"{m.get('whole_query.capacity_retries', 0)} capacity "
                 f"retries, {m.get('whole_query.runtime_degraded', 0)} "
                 f"degrades; staged: "
                 f"{sorted(set(TPCDS_QUERIES) - set(whole_files))}"
                 if tier == "whole" else "")
              + f"; stage cache {json.dumps(cache)}", flush=True)
    print(f"tpcds_gate: {time.perf_counter() - t0:.1f} s; rows as written "
          f"{json.dumps(rows)}", flush=True)


def cte_rows(df) -> dict:
    """{CTE name: rows} of the CTEs the session materialised for `df`: the
    in-memory relations spliced under each CTE's alias, in the plan and in
    the plans of its subquery expressions."""
    from spark_tpu_torch.plan.logical import LocalRelation, SubqueryAlias
    from spark_tpu_torch.plan.subquery import iter_plans

    return {n.alias: n.child.table.num_rows for p in iter_plans(df.plan)
            for n in p.iter_nodes() if isinstance(n, SubqueryAlias)
            and isinstance(n.child, LocalRelation)}


_FACTS = ("store_sales", "store_returns", "catalog_sales", "catalog_returns",
          "web_sales", "web_returns", "inventory")


def tpcds_leg(torch, sk, card: str, cpu_proc):
    """bench.py's bench_tpcds (BASELINE config 4) widened to every tpcds
    query: the query files through session.sql at SF10 row counts, each
    plan held to its operator sequence, q3, q7 and q19 to their numpy
    oracles and exact histogram calls, the others to at least one row and
    one histogram call (their results are held to the CPU afterwards,
    `tpcds_cpu_check`). A query whose CTEs the session materialises is
    timed as session.sql(text).toArrow() whole, with the sql() call (the
    CTE bodies' run and collect) timed on its own. Returns the launch
    counts by query, the results the CPU check holds, and the launch
    counts of the expressions, types, aggregates and maintenance legs,
    which run last on the same session and views, against oracles the
    `--tpcds-cpu` process (`cpu_proc`) computed."""
    import re

    t0 = time.perf_counter()
    tables, arrays = tpcds_data()
    print(f"tpcds data: {sum(t.num_rows for t in tables.values()):,} rows, "
          f"{sum(t.num_columns for t in tables.values())} columns, "
          f"{sum(t.nbytes for t in tables.values()) / 1e9:.2f} GB of Arrow "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    spark = session(TPCDS_CONF)
    for name, table in tables.items():
        spark.createDataFrame(table).createOrReplaceTempView(name)
    out, results, timed_shapes, peak, firsts = {}, {}, set(), {}, {}
    for q in TPCDS_QUERIES:
        if q in TPCDS_SF10_CUT or q in TPCDS_TIME_CUT:
            continue
        text = tpcds_text(q)
        scalars = TPCDS_SCALAR_SUBQUERIES.get(q, 0)
        parts = TPCDS_JOINS[q]
        if q in TPCDS_ORACLES:
            oracle_rows, key = tpcds_oracle(q, arrays)
            parts += ("LimitExec(is_global=True", "LimitExec(is_global=False",
                      "Exchange[SinglePartition(1)]")

            def check(result, q=q, rows=oracle_rows, key=key):
                firsts.setdefault(q, result)
                return _check_topk(f"tpcds {q}", tpcds_rows(q, result), rows,
                                   key)
        else:
            def check(result, q=q):
                if q in TPCDS_SF10_EMPTY and result.num_rows:
                    fail(f"tpcds {q}: {result.num_rows} rows at SF10, "
                         "where the data gives none")
                if q not in TPCDS_SF10_EMPTY and result.num_rows < 1:
                    fail(f"tpcds {q}: no rows at SF10")
                results[q] = result
                return f"{result.num_rows} rows (held to the CPU later)"
        run, cte_s, scalar_s, ran, own, made = None, [], [], [], [], []
        if q in TPCDS_CTE_ROWS or scalars:
            # each run parses anew: the CTE bodies run in sql(), the
            # uncorrelated scalar subqueries in the optimizer's last step;
            # the plan checks read the DataFrame the cold run made
            def run(text=text, cte_s=cte_s, scalar_s=scalar_s, ran=ran,
                    own=own, made=made):
                t1 = time.perf_counter()
                d = spark.sql(text)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                s0 = spark.metrics.get("subquery.scalar", 0)
                d.query_execution.optimized
                torch.cuda.synchronize()
                cte_s.append(t2 - t1)
                scalar_s.append(time.perf_counter() - t2)
                ran.append(spark.metrics.get("subquery.scalar", 0) - s0)
                c0 = sk.LAUNCHES["partition_histogram"]
                out = d.toArrow()
                own.append(sk.LAUNCHES["partition_histogram"] - c0)
                if not made:
                    made.append(d)
                return out
            df = lambda made=made: made[0]  # noqa: E731
        else:
            df = spark.sql(text)
            s0 = spark.metrics.get("subquery.scalar", 0)
            df.query_execution.optimized
            if spark.metrics.get("subquery.scalar", 0) != s0:
                fail(f"tpcds {q}: the optimizer ran scalar subqueries "
                     "TPCDS_SCALAR_SUBQUERIES does not list")
        rows = sum(tables[f].num_rows for f in _FACTS
                   if re.search(rf"\b{f}\b", text))
        torch.cuda.reset_peak_memory_stats()
        t_q = time.perf_counter()
        out[q] = drive(torch, sk, card, f"tpcds {q}", df, rows, parts,
                       tpcds_calls(q), check, run, timed_shapes,
                       main_calls=(lambda own=own: own[-1]) if run
                       else None, session=spark,
                       warm_runs=3 if q in TPCDS_ORACLES else 0)
        peak[q] = torch.cuda.max_memory_allocated() / 1e9
        print(f"tpcds {q} done in {time.perf_counter() - t_q:.1f} s, at "
              f"{time.perf_counter() - t0:.1f} s of the leg", flush=True)
        if run:
            df = made[0]
            if ran[0] != scalars:
                fail(f"tpcds {q}: the optimizer ran {ran[0]} scalar "
                     f"subqueries, not {scalars}")
        if q in TPCDS_CTE_ROWS:
            mat = cte_rows(df)
            if mat != TPCDS_CTE_ROWS[q]:
                fail(f"tpcds {q}: materialised CTE rows {mat}, not "
                     f"{TPCDS_CTE_ROWS[q]}")
        ops = plan_ops(df)
        if ops != TPCDS_PLAN_OPS[q]:
            fail(f"tpcds {q}: the operator sequence {ops} is not the "
                 f"reference's {TPCDS_PLAN_OPS[q]}")
        d = df.query_execution.tier_decision
        if (d.tier, d.reason) != TPCDS_TIERS[q]:
            fail(f"tpcds {q}: the tier decision {(d.tier, d.reason)} is "
                 f"not the reference's {TPCDS_TIERS[q]}")
        if "NestedLoopJoinExec" in ops:
            nested_loop_pairs(spark, q, run or df.toArrow, card)
        if q in TPCDS_CTE_ROWS:
            print(f"tpcds {q} cte " + json.dumps({
                "sql_s": cte_s, "cold_sql_s": cte_s[0],
                "warm_sql_median_s": statistics.median(cte_s[1:4])
                if cte_s[1:] else "not measured: no warm run",
                "card": card}), flush=True)
        if scalars:
            print(f"tpcds {q} scalar_subqueries " + json.dumps({
                "count": scalars, "optimize_s": scalar_s,
                "cold_optimize_s": scalar_s[0],
                "warm_optimize_median_s": statistics.median(scalar_s[1:4])
                if scalar_s[1:] else "not measured: no warm run",
                "card": card}), flush=True)
    tpcds_stage(torch, sk, card, spark, arrays)
    rf = runtime_filters_leg(torch, sk, card, spark, firsts)
    out.update({f"runtime_filters {q}": n for q, n in rf.items()})
    print("tpcds peak device memory " + json.dumps({
        "max_memory_allocated_gb": max(peak.values()),
        "by_query_gb": peak, "card": card}), flush=True)
    # the oracles of the expressions, types and aggregates legs (Python
    # loops and numpy over the same seeded tables) come from the
    # `--tpcds-cpu` process, which computed them first
    oracles = side_oracles(cpu_proc)
    expressions = expressions_leg(torch, sk, card, spark,
                                  oracles["expressions"])
    types = types_leg(torch, sk, card, spark, oracles["types"],
                      timed_shapes)
    aggregates = aggregates_leg(torch, sk, card, spark,
                                oracles["aggregates"], timed_shapes)
    for table in TYPES_TABLES:
        spark.sql(f"DROP TABLE {table}")
    # the maintenance leg changes the views: it runs after every other
    # run over them
    maintenance = maintenance_leg(torch, sk, card, spark, tables, arrays,
                                  timed_shapes)
    spark.stop()
    return out, results, expressions, types, aggregates, maintenance


# the runtime_filters leg: BASELINE.json config 4's queries at `stage` with
# both runtime join filters on (bench.py:1118)
RF_QUERIES = ("q3", "q7", "q19")
RF_CONF = {"spark.tpu.join.runtimeFilter": "true",
           "spark.tpu.join.runtimeFilter.bloom": "true"}
RF_METRICS = ("join.bloom_filtered_rows", "join.range_filtered_rows",
              "join.runtime_filter_compactions")


def runtime_filters_leg(torch, sk, card: str, spark, firsts: dict) -> dict:
    """q3, q7 and q19 on the tpcds leg's SF10 session and views (nothing
    ingested again) at forced `stage` with spark.tpu.join.runtimeFilter
    and .bloom on and .minCapacity at its default (1 << 20): each result
    equal to the same file's result in the tpcds leg (`firsts`), the bloom
    kernel launched; the rows each filter dropped, the compactions and
    the kernel's calls printed per statement. One more run of each keeps
    every bloom call's inputs and holds them to the plain version. Returns
    the launch counts by query."""
    out = {}
    saved = {k: spark.conf.get(k) for k in RF_CONF}
    for k, v in RF_CONF.items():
        spark.conf.set(k, v)
    runs = []
    try:
        with tier_set(spark, "stage"):
            for q in RF_QUERIES:
                text = tpcds_text(q)
                m0 = spark.metrics
                got, cold, launches, st = counted_run(
                    torch, sk, spark, lambda text=text: spark.sql(text)
                    .toArrow())
                delta = _delta(spark.metrics, m0)
                if not same_result(q, got, firsts[q]):
                    fail(f"runtime_filters {q}: the result differs from the "
                         "tpcds leg's")
                calls = {k: launches[k] for k in ("bloom_build",
                                                  "bloom_probe")}
                if not calls["bloom_build"] or not calls["bloom_probe"]:
                    fail(f"runtime_filters {q}: the bloom kernel launched "
                         f"{calls}")
                out[q] = launches
                print(f"runtime_filters {q} " + json.dumps(dict(
                    cold_s=cold, rows=got.num_rows, **calls,
                    histogram_calls=launches["partition_histogram"],
                    **{k: delta.get(k, 0) for k in RF_METRICS},
                    **sched_report(st["sched"]), card=card)), flush=True)
                runs.append(lambda text=text: spark.sql(text).toArrow())
            path_blooms(torch, "runtime_filters", runs)
    finally:
        for k, v in saved.items():
            spark.conf.set(k, v)
    return out


def tpcds_stage(torch, sk, card: str, spark, arrays) -> None:
    """q3, q7 and q19 at SF10 once more at each of the three tiers, whole,
    stage and operator, on the tpcds leg's session (its conf set; the
    views are the same, nothing is ingested again): each plan made once
    per tier, each result equal to its numpy oracle, the histogram calls
    `tpcds_calls` at the stage and operator tiers and none whole, each
    fused batch and each whole program's attempt one replay. Then each query runs warm 3
    times at each tier in turn (whole, stage, operator, ...), with one
    profiled run at each (device busy and idle share) and the copies into
    and out of the graphs timed in one more run at each fused tier, to
    place the tiers' difference: device copies, or host time."""
    from spark_tpu_torch.api.dataframe import DataFrame

    tiers = ("whole", "stage", "operator")
    for q in TPCDS_ORACLES:
        dfs = {}
        for tier in tiers:
            with tier_set(spark, tier):
                dfs[tier] = DataFrame(spark, spark.sql(tpcds_text(q)).plan)
                dfs[tier].query_execution.physical
            got = dfs[tier].query_execution.tier_decision.tier
            if got != tier:
                fail(f"tpcds {q}: planned at the {got} tier, not {tier}")
        if not fused_stages(dfs["stage"]):
            fail(f"tpcds {q}: nothing fuses at the stage tier")
        rows, key = tpcds_oracle(q, arrays)
        report = {}
        for tier, df in dfs.items():
            out, cold_s, launches, st = counted_run(torch, sk, spark,
                                                    df.toArrow)
            want = 0 if tier == "whole" else tpcds_calls(q)
            if launches["partition_histogram"] != want:
                fail(f"tpcds {q} at the {tier} tier launched the histogram "
                     f"kernel {launches['partition_histogram']} times, not "
                     f"{want}")
            report[tier] = {
                "check": _check_topk(f"tpcds {q} {tier}",
                                     tpcds_rows(q, out), rows, key),
                "cold_s": cold_s, "warm_s": [],
                "histogram_calls": launches["partition_histogram"], **st}
        for _ in range(3):
            for tier, df in dfs.items():
                report[tier]["warm_s"] += _warm(torch, df.toArrow, 1)
        for tier, df in dfs.items():
            r = report[tier]
            r["warm_median_s"] = statistics.median(r["warm_s"])
            r["busy"] = busy_share(torch, df.toArrow)
            if tier != "operator":
                events = []
                with copies_timed(torch, events):
                    df.toArrow()
                    torch.cuda.synchronize()
                copies = {"copy_in": 0.0, "copy_out": 0.0}
                for kind, start, end in events:
                    copies[kind] += start.elapsed_time(end)
                r["replays_per_run"] = sum(k == "copy_in"
                                           for k, _, _ in events)
                r["copy_in_ms_per_run"] = copies["copy_in"]
                r["copy_out_ms_per_run"] = copies["copy_out"]
        print(f"tpcds {q} tiers " + json.dumps({
            "tiers": report, "fused_stages": fused_stages(dfs["stage"]),
            "held_gb": stage_counters()["stage_cache.held_bytes"] / 1e9,
            "card": card}), flush=True)


# --- the expressions leg: the scalar functions over the SF10 views -----------

EXPRESSION_QUERIES = {
    # date parts, DIV and pmod as group keys over store_sales x date_dim
    "dates": (
        "SELECT year(d_date) y, quarter(d_date) q, dayofweek(d_date) dw, "
        "pmod(ss_customer_sk, 7) pc, ss_quantity DIV 25 qd, count(*) n, "
        "sum(ss_ext_sales_price) s FROM store_sales JOIN date_dim "
        "ON ss_sold_date_sk = d_date_sk GROUP BY year(d_date), "
        "quarter(d_date), dayofweek(d_date), pmod(ss_customer_sk, 7), "
        "ss_quantity DIV 25"),
    # greatest/least, nullif, nvl and <=> over the money columns
    "money": (
        "SELECT sum(greatest(ss_list_price, ss_sales_price, ss_coupon_amt)) "
        "g, sum(nullif(ss_coupon_amt, 0)) nz, count(nullif(ss_coupon_amt, "
        "0)) cnz, sum(nvl(ss_coupon_amt, ss_net_paid)) nv, "
        "count_if(ss_ext_discount_amt <=> ss_coupon_amt) eq, "
        "count_if(least(ss_list_price, ss_sales_price) <=> ss_sales_price) "
        "le, sum(pmod(ss_item_sk, 13)) pm FROM store_sales"),
    # the math functions, summed as doubles
    "math": (
        "SELECT sum(sqrt(ss_quantity)) a, sum(ln(ss_list_price)) b, "
        "sum(sin(ss_quantity)) c, sum(cbrt(ss_net_profit)) d, "
        "sum(pow(ss_quantity, 1.5)) e, sum(exp(ss_quantity / 100.0)) f, "
        "sum(bround(ss_list_price / 3, 2)) g, sum(log10(ss_list_price) "
        "* degrees(atan2(ss_quantity, 7))) h, sum(bround(ss_sales_price, "
        "1)) r FROM store_sales"),
    # the bitwise operators over the ticket numbers
    "bitwise": (
        "SELECT ss_ticket_number & 7 b, count(*) n, sum(ss_ticket_number "
        ">> 3) s, sum(ss_ticket_number ^ 255) x, sum(~ss_ticket_number | 1) "
        "o, sum(shiftleft(ss_quantity, 2)) sl, sum(ss_ticket_number % 13) m "
        "FROM store_sales GROUP BY ss_ticket_number & 7"),
    # string transforms as group keys over customer x store_sales
    "strings": (
        "SELECT lower(c_first_name) f, length(c_last_name) l, "
        "initcap(c_salutation) s, count(*) n, sum(ss_quantity) q "
        "FROM store_sales JOIN customer ON ss_customer_sk = c_customer_sk "
        "GROUP BY lower(c_first_name), length(c_last_name), "
        "initcap(c_salutation)"),
    # string predicates and RLIKE over customer_address
    "predicates": (
        "SELECT count_if(ca_city RLIKE '^[A-M].*e$') a, "
        "count_if(startswith(ca_street_name, 'Oak')) b, "
        "count_if(contains(ca_county, 'ton')) c, count_if(endswith(ca_zip, "
        "'7')) d, sum(instr(ca_street_name, 'a')) e, sum(length(ca_city)) "
        "f, count_if(ca_state LIKE 'T_') g, count_if(ca_city NOT RLIKE 'a') "
        "h, count(regexp_substr(ca_street_name, '[A-Z][a-z]+ey')) i "
        "FROM customer_address"),
    # casts from a string and try_cast
    "casts": (
        "SELECT sum(cast(ca_zip AS INT)) z, sum(try_cast(ca_street_number "
        "AS BIGINT)) n, sum(cast(ca_zip AS DOUBLE)) zd, "
        "count(try_cast(ca_suite_number AS INT)) bad, "
        "sum(cast(concat(ca_street_number, '.25') AS DECIMAL(7, 2))) dc "
        "FROM customer_address"),
    # hashes and encodings over item, and hash/xxhash64 (host UDFs, row by
    # row or once per dictionary value) over the dimensions only; a host
    # UDF is projected below the aggregate, as the reference extracts it
    # only from projections and filters
    "hashes": (
        "SELECT sum(c) c, count(DISTINCT m) m, sum(h & 1023) h, "
        "sum(x & 65535) x, sum(length(s)) s, sum(length(b)) b FROM "
        "(SELECT crc32(i_item_id) c, md5(i_brand) m, hash(i_item_sk) h, "
        "xxhash64(i_item_id) x, sha2(i_category, 256) s, base64(i_color) b "
        "FROM item)"),
    "hashes_customer": (
        "SELECT sum(h & 1023) h, sum(x & 255) x, sum(c) c FROM "
        "(SELECT hash(c_birth_country) h, xxhash64(c_salutation) x, "
        "crc32(c_email_address) c FROM customer)"),
}
# the expressions leg's double columns, held to relative 1e-9 (float sums
# add in atomic order on the card)
EXPRESSION_FLOATS = {"math": ("a", "b", "c", "d", "e", "f", "g", "h"),
                     "casts": ("zd",)}


def _np_col(table, name):
    """(values, valid) of an Arrow column as numpy: decimals in int64
    units of their scale, dates in days; strings stay Arrow (take them
    with `_by_value`)."""
    import numpy as np
    import pyarrow as pa

    col = table.column(name).combine_chunks()
    valid = ~col.is_null().to_numpy(zero_copy_only=False)
    t = col.type
    if pa.types.is_string(t):
        return col, valid
    if pa.types.is_decimal(t):
        v = np.rint(col.cast(pa.float64()).fill_null(0).to_numpy()
                    * 10.0 ** t.scale).astype(np.int64)
    elif pa.types.is_date32(t):
        v = col.view(pa.int32()).fill_null(0).to_numpy()
    else:
        v = col.fill_null(0).to_numpy()
    return v, valid


def _by_value(col, fn, dtype=object):
    """fn over each distinct value of the Arrow string column `col`,
    gathered back per row (NULL rows get fn(None))."""
    import numpy as np

    enc = col.dictionary_encode()
    per = np.array([fn(v) for v in enc.dictionary.to_pylist()] + [fn(None)],
                   dtype=dtype)
    idx = enc.indices.fill_null(len(per) - 1).to_numpy()
    return per[idx]


def _grouped(keys: list, valid: list, sums: list) -> list:
    """Rows (key values or None..., count, sums...) of a GROUP BY over
    integer key arrays (`valid` False for NULL) and (values, valid) int64
    sum columns (a group's sum NULL where none of its values is valid):
    the keys in mixed radix, counted and summed by bincount (each sum
    below 2^53, so exact in its float64 weights)."""
    import numpy as np

    code = np.zeros(len(keys[0]), np.int64)
    radix = []
    for k, v in zip(keys, valid):
        k = k.astype(np.int64)
        lo = int(k[v].min()) if v.any() else 0
        span = (int(k[v].max()) if v.any() else 0) - lo + 2  # NULL last
        code = code * span + np.where(v, k - lo, span - 1)
        radix.append((lo, span))
    total = int(np.prod([span for _, span in radix]))
    n = np.bincount(code, minlength=total)
    tot = [(np.bincount(code, weights=np.where(ok, x, 0).astype(np.float64),
                        minlength=total),
            np.bincount(code, weights=ok.astype(np.float64),
                        minlength=total)) for x, ok in sums]
    rows = []
    for g in np.nonzero(n)[0]:
        key, rest = [], int(g)
        for lo, span in reversed(radix):
            d = rest % span
            rest //= span
            key.append(None if d == span - 1 else lo + d)
        rows.append(tuple(reversed(key)) + (int(n[g]),) + tuple(
            int(t[g]) if c[g] else None for t, c in tot))
    return rows


def expression_oracle(name: str, tables: dict) -> list:
    """The expected rows of EXPRESSION_QUERIES[name] from numpy and Python
    over the Arrow tables, decimals in int64 units of their scale."""
    import base64
    import hashlib
    import re
    import zlib

    import numpy as np

    ss, dd = tables["store_sales"], tables["date_dim"]
    if name == "dates":
        dsk, _ = _np_col(dd, "d_date_sk")
        days, _ = _np_col(dd, "d_date")
        lut = np.full(int(dsk.max()) + 1, -1, np.int64)
        lut[dsk] = np.arange(len(dsk))
        sold, sold_ok = _np_col(ss, "ss_sold_date_sk")
        row = np.where(sold_ok, lut[np.clip(sold, 0, len(lut) - 1)], -1)
        sel = row >= 0
        d = days[row[sel]].astype(np.int64)
        dt64 = d.astype("datetime64[D]")
        y = dt64.astype("datetime64[Y]").astype(np.int64) + 1970
        m = dt64.astype("datetime64[M]").astype(np.int64) % 12 + 1
        cust, cust_ok = _np_col(ss, "ss_customer_sk")
        qty, qty_ok = _np_col(ss, "ss_quantity")
        one = np.ones(int(sel.sum()), bool)
        price, price_ok = _np_col(ss, "ss_ext_sales_price")
        return _grouped([y, (m - 1) // 3 + 1, (d + 4) % 7 + 1,
                         cust[sel] % 7, qty[sel] // 25],
                        [one, one, one, cust_ok[sel], qty_ok[sel]],
                        [(price[sel], price_ok[sel])])
    if name == "money":
        lp, lp_ok = _np_col(ss, "ss_list_price")
        sp, sp_ok = _np_col(ss, "ss_sales_price")
        cp, cp_ok = _np_col(ss, "ss_coupon_amt")
        da, da_ok = _np_col(ss, "ss_ext_discount_amt")
        npd, np_ok = _np_col(ss, "ss_net_paid")
        item, _ = _np_col(ss, "ss_item_sk")
        low = np.iinfo(np.int64).min
        g = np.maximum.reduce([np.where(ok, v, low) for v, ok in
                               ((lp, lp_ok), (sp, sp_ok), (cp, cp_ok))])
        g_ok = lp_ok | sp_ok | cp_ok
        nz = cp_ok & (cp != 0)
        nv = np.where(cp_ok, cp, npd)
        nv_ok = cp_ok | np_ok

        def null_safe_eq(a, a_ok, b, b_ok):
            return np.where(a_ok & b_ok, a == b, ~a_ok & ~b_ok)

        le = np.where(lp_ok & sp_ok, np.minimum(lp, sp),
                      np.where(lp_ok, lp, sp))
        return [(int(g[g_ok].sum()), int(cp[nz].sum()), int(nz.sum()),
                 int(nv[nv_ok].sum()),
                 int(null_safe_eq(da, da_ok, cp, cp_ok).sum()),
                 int(null_safe_eq(le, lp_ok | sp_ok, sp, sp_ok).sum()),
                 int((item % 13).sum()))]
    if name == "math":
        def half_even(units, f):
            # integers rounded to multiples of f, ties to even
            q, r = np.divmod(np.abs(units), f)
            up = (r * 2 > f) | ((r * 2 == f) & (q % 2 == 1))
            return np.sign(units) * (q + up) * f

        qty, q_ok = _np_col(ss, "ss_quantity")
        lp, lp_ok = _np_col(ss, "ss_list_price")
        sp, sp_ok = _np_col(ss, "ss_sales_price")
        pr, pr_ok = _np_col(ss, "ss_net_profit")
        q = qty[q_ok].astype(np.float64)
        lpv = lp[lp_ok] / 100.0
        both = q_ok & lp_ok
        h = np.log10(lp[both] / 100.0) * np.degrees(
            np.arctan2(qty[both].astype(np.float64), 7.0))
        return [(float(np.sqrt(q).sum()), float(np.log(lpv).sum()),
                 float(np.sin(q).sum()), float(np.cbrt(pr[pr_ok] / 100.0)
                                               .sum()),
                 float((q ** 1.5).sum()), float(np.exp(q / 100.0).sum()),
                 float((np.rint(lp[lp_ok] / 3.0) / 100.0).sum()),
                 float(h.sum()), int(half_even(sp[sp_ok], 10).sum()))]
    if name == "bitwise":
        tk, tk_ok = _np_col(ss, "ss_ticket_number")
        qty, q_ok = _np_col(ss, "ss_quantity")
        return _grouped([tk & 7], [tk_ok],
                        [(tk >> 3, tk_ok), (tk ^ 255, tk_ok),
                         (~tk | 1, tk_ok), (qty << 2, q_ok),
                         (tk % 13, tk_ok)])
    if name == "strings":
        cu = tables["customer"]
        csk, _ = _np_col(cu, "c_customer_sk")
        first = _by_value(cu.column("c_first_name").combine_chunks(),
                          lambda v: None if v is None else v.lower())
        length = _by_value(cu.column("c_last_name").combine_chunks(),
                           lambda v: None if v is None else len(v))
        salut = _by_value(cu.column("c_salutation").combine_chunks(),
                          lambda v: None if v is None else " ".join(
                              w[:1].upper() + w[1:].lower() if w else w
                              for w in v.split(" ")))
        pos = np.full(int(csk.max()) + 1, -1, np.int64)
        pos[csk] = np.arange(len(csk))
        cust, c_ok = _np_col(ss, "ss_customer_sk")
        qty, q_ok = _np_col(ss, "ss_quantity")
        row = np.where(c_ok, pos[np.clip(cust, 0, len(pos) - 1)], -1)
        sel = row >= 0
        r = row[sel]
        # the string keys by code: each distinct value, None last
        keys, codes = [], []
        for arr in (first, length, salut):
            vals = sorted({v for v in arr if v is not None})
            at = {v: i for i, v in enumerate(vals)}
            keys.append(vals + [None])
            codes.append(np.array([len(vals) if v is None else at[v]
                                   for v in arr], np.int64)[r])
        one = np.ones(len(r), bool)
        return [(keys[0][k[0]], keys[1][k[1]], keys[2][k[2]]) + k[3:]
                for k in _grouped(codes, [one, one, one],
                                  [(qty[sel], q_ok[sel])])]
    ca = tables["customer_address"]
    if name == "predicates":
        def count(col, fn):
            v = _by_value(ca.column(col).combine_chunks(),
                          lambda s: None if s is None else fn(s))
            return int(sum(x for x in v if x is not None))

        city_rx = re.compile("^[A-M].*e$")
        state_rx = re.compile("^T.$", re.DOTALL)
        sub_rx = re.compile("[A-Z][a-z]+ey")
        return [(count("ca_city", lambda s: bool(city_rx.search(s))),
                 count("ca_street_name", lambda s: s.startswith("Oak")),
                 count("ca_county", lambda s: "ton" in s),
                 count("ca_zip", lambda s: s.endswith("7")),
                 count("ca_street_name", lambda s: s.find("a") + 1),
                 count("ca_city", len),
                 count("ca_state", lambda s: bool(state_rx.match(s))),
                 count("ca_city", lambda s: not re.search("a", s)),
                 count("ca_street_name",
                       lambda s: sub_rx.search(s) is not None))]
    if name == "casts":
        def parse(col, fn):
            return _by_value(ca.column(col).combine_chunks(),
                             lambda s: None if s is None else fn(s.strip()))

        def as_int(s):
            try:
                return int(float(s)) if ("." in s or "e" in s.lower()) \
                    else int(s)
            except (ValueError, ArithmeticError):
                return None

        def as_float(s):
            try:
                return float(s)
            except ValueError:
                return None

        zi = [v for v in parse("ca_zip", as_int) if v is not None]
        sn = [v for v in parse("ca_street_number", as_int) if v is not None]
        zd = [v for v in parse("ca_zip", as_float) if v is not None]
        bad = [v for v in parse("ca_suite_number", as_int) if v is not None]
        dc = [round(float(s + ".25") * 100) for s in parse(
            "ca_street_number", lambda s: s) if s is not None]
        return [(sum(zi), sum(sn), float(sum(zd)), len(bad), sum(dc))]
    if name in ("hashes", "hashes_customer"):
        def stable_hash(xs, bits):
            h = hashlib.sha256(repr(tuple(xs)).encode()).digest()
            return int.from_bytes(h[: bits // 8], "little", signed=True)

        def per_row(table, col, fn):
            c = table.column(col).combine_chunks()
            return _by_value(c, fn) if c.type == "string" else np.array(
                [fn(v) for v in c.to_numpy(zero_copy_only=False)], object)

        if name == "hashes":
            it = tables["item"]
            crc = per_row(it, "i_item_id", lambda s: None if s is None
                          else zlib.crc32(s.encode()))
            md5 = {hashlib.md5(s.encode()).hexdigest()
                   for s in it.column("i_brand").to_pylist()
                   if s is not None}
            sk_type = it.column("i_item_sk").type.to_pandas_dtype()
            h = per_row(it, "i_item_sk", lambda v: stable_hash(
                (sk_type(v),), 32) & 1023)
            x = per_row(it, "i_item_id", lambda s: stable_hash((s,), 64)
                        & 65535)
            sha = per_row(it, "i_category", lambda s: None if s is None
                          else 64)
            b64 = per_row(it, "i_color", lambda s: None if s is None
                          else len(base64.b64encode(s.encode())))
            return [(sum(v for v in crc if v is not None), len(md5),
                     int(sum(h)), int(sum(x)),
                     sum(v for v in sha if v is not None),
                     sum(v for v in b64 if v is not None))]
        cu = tables["customer"]
        h = per_row(cu, "c_birth_country", lambda s: stable_hash((s,), 32)
                    & 1023)
        x = per_row(cu, "c_salutation", lambda s: stable_hash((s,), 64)
                    & 255)
        crc = per_row(cu, "c_email_address", lambda s: None if s is None
                      else zlib.crc32(s.encode()))
        return [(int(sum(h)), int(sum(x)),
                 sum(v for v in crc if v is not None))]
    raise ValueError(name)


def expression_rows(table) -> list:
    """A result table's rows as tuples of Python values, decimals in int64
    units of their scale."""
    import decimal

    # every decimal of the leg's results has scale 2
    return [tuple(int(v * 100) if isinstance(v, decimal.Decimal) else v
                  for v in r.values()) for r in table.to_pylist()]


def expression_check(name: str, table, want: list) -> str:
    """The result of EXPRESSION_QUERIES[name] against its oracle rows:
    exactly, the double columns to relative 1e-9."""
    import math

    floats = {table.column_names.index(c)
              for c in EXPRESSION_FLOATS.get(name, ())}
    got = sorted(expression_rows(table), key=repr)
    want = sorted(want, key=repr)
    if len(got) != len(want):
        fail(f"expressions {name}: {len(got)} rows, the oracle "
             f"{len(want)}")
    for g, w in zip(got, want):
        for i, (a, b) in enumerate(zip(g, w)):
            ok = (a == b) if i not in floats else (
                a is not None and math.isclose(a, b, rel_tol=1e-9))
            if not ok:
                fail(f"expressions {name}: row {g} is not the oracle's {w}")
    return f"{len(got)} rows equal to the oracle"


def expressions_leg(torch, sk, card: str, spark, oracles: dict) -> dict:
    """The scalar functions at SF10, on the tpcds leg's session and views
    (nothing ingested again): each of EXPRESSION_QUERIES at `auto`, then at
    the stage tier and at forced `whole`, each result held to its numpy or
    Python oracle (`oracles[name]`, the rows of `expression_oracle`), so
    the three tiers agree; a whole
    program calls the histogram kernel never, and each fused dispatch is
    one replay (`counted_run`). Prints each statement's tier and reason,
    warm time at `auto`, histogram calls and captures by tier, then holds
    the histogram kernel against its plain version at the stage run's
    inputs. Returns the launch counts of each statement's run at `auto`."""
    from spark_tpu_torch.api.dataframe import DataFrame

    t0 = time.perf_counter()
    out = {}
    own_shapes = set()
    for name, text in EXPRESSION_QUERIES.items():
        label = f"expressions {name}"
        want = oracles[name]
        report, dfs = {}, {}
        for tier in ("auto", "stage", "whole"):
            with tier_set(spark, tier):
                df = dfs[tier] = DataFrame(spark, spark.sql(text).plan)
                decision = decision_report(df)
                res, cold, launches, st = counted_run(torch, sk, spark,
                                                      df.toArrow)
                msg = expression_check(name, res, want)
                calls = launches["partition_histogram"]
                if decision["tier"] == "whole" and calls and \
                        not st["whole"]["runtime_degraded"]:
                    fail(f"{label}: the whole program launched the "
                         f"histogram kernel {calls} times, not 0")
                warm = _warm(torch, df.toArrow, 1) if tier == "auto" else []
            cc = st["cache"]
            report[tier] = {
                "tier": decision["tier"], "reason": decision.get("reason"),
                "check": msg, "cold_s": cold,
                "warm_s": warm[0] if warm else "not measured: cold run only",
                "histogram_calls": calls,
                "captures": cc.get("stage_cache.captures", 0),
                "replays": cc.get("stage_cache.replays", 0),
                "degrades": st["whole"]["runtime_degraded"]}
            if tier == "auto":
                out[name] = launches
        for tier in ("stage", "whole"):
            r = report[tier]
            # forced whole plans stage where the reference's chooser finds
            # an operator with no whole-query lowering (a host UDF, a
            # nested-loop join), as the reference plans it
            if r["tier"] != tier and not (
                    tier == "whole" and str(r["reason"]).startswith(
                        _FALLBACK + "operator")):
                fail(f"{label}: planned at {r['tier']} where {tier} was "
                     f"forced ({r['reason']})")

        def stage_run(df=dfs["stage"]):
            with tier_set(spark, "stage"), bodies_on_card(torch, sk):
                df.toArrow()
        # the leg's own inputs are timed once each (PERF.md's kernel table
        # has their row), even where an earlier path timed the shape
        path_histograms(torch, sk, label, {"stage": stage_run}, own_shapes)
        print(f"{label} tiers " + json.dumps(dict(report, card=card)),
              flush=True)
    print(f"expressions leg done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


# --- the types leg: timestamps, arrays, maps and structs over the SF10 views -

# a sale's instant: its date as a TIMESTAMP plus its time of day, made on
# the device
TYPES_EVENTS = (
    "SELECT from_unixtime(unix_timestamp(CAST(d_date AS TIMESTAMP)) + "
    "t_time) ts, ss_net_paid FROM store_sales "
    "JOIN date_dim ON ss_sold_date_sk = d_date_sk "
    "JOIN time_dim ON ss_sold_time_sk = t_time_sk")
TYPES_WINDOW = ("2000-03-01 06:00:00", "2000-03-31 18:30:00")
# tables the statements read, made once by CTAS: a struct and a map per
# item, built on the host row by row (PythonEvalExec) over the 102,000
# items only, collected to Arrow with their nested columns and read back
# through the nested ingest
TYPES_TABLES = {
    "item_nested": "CREATE TABLE item_nested AS SELECT i_item_sk, "
                   "named_struct('category', i_category, 'brand', i_brand) "
                   "cb, map(i_category, i_current_price) m FROM item"}
TYPES_QUERIES = {
    # sales by hour of day
    "events": f"SELECT hour(ts) h, count(*) n, sum(ss_net_paid) paid FROM "
              f"({TYPES_EVENTS}) e GROUP BY hour(ts)",
    # a month's sales: the first and last instant, 90 minutes later
    "events_window": f"SELECT min(ts + INTERVAL 90 MINUTES) lo, "
                     f"max(ts + INTERVAL 90 MINUTES) hi, count(*) n FROM "
                     f"({TYPES_EVENTS}) e WHERE ts BETWEEN TIMESTAMP "
                     f"'{TYPES_WINDOW[0]}' AND TIMESTAMP '{TYPES_WINDOW[1]}'",
    # the Spark SQL guide's word count, over county names of two and
    # three words ('Dona Ana County', 'County 12'): each address explodes
    # into two or three rows
    "words": "SELECT w, count(*) n FROM (SELECT explode(split("
             "ca_county, ' ')) w FROM customer_address) x GROUP BY w",
    "word_arrays": "SELECT size(sp) sz, element_at(sp, 1) w1, "
                   "element_at(sp, -1) wl, array_contains(sp, 'County') "
                   "cty, array_join(sort_array(sp), '+') j, count(*) n "
                   "FROM (SELECT split(ca_county, ' ') sp FROM "
                   "customer_address) x GROUP BY sz, w1, wl, cty, j",
    # sales by a struct key, its fields read above the aggregate
    "structs": "SELECT g.cb.category cat, g.cb.brand brand, n, paid, music "
               "FROM (SELECT cb, count(*) n, sum(ss_net_paid) paid, "
               "max(m['Music']) music FROM store_sales JOIN item_nested ON "
               "ss_item_sk = i_item_sk GROUP BY cb) g",
    # the table read back and collected to Arrow with its struct and map
    # columns
    "item_nested": "SELECT i_item_sk, cb, m FROM item_nested",
}


def _plain(v):
    """A result value as the oracles give it: decimals in int64 units of
    their scale (2 in every result of the leg), timestamps in
    microseconds, structs and maps as tuples of their items."""
    import datetime
    import decimal

    if isinstance(v, decimal.Decimal):
        return int(v * 100)
    if isinstance(v, datetime.datetime):
        return (v - datetime.datetime(1970, 1, 1)) // \
            datetime.timedelta(microseconds=1)
    if isinstance(v, dict):
        return tuple((k, _plain(x)) for k, x in v.items())
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    return v


def _event_seconds(tables: dict):
    """(seconds since the epoch, ss_net_paid, its validity) of each
    store_sales line whose date and time join: what both events
    statements read."""
    import numpy as np

    ss = tables["store_sales"]
    dd, td = tables["date_dim"], tables["time_dim"]
    dsk, _ = _np_col(dd, "d_date_sk")
    days, _ = _np_col(dd, "d_date")
    tsk, _ = _np_col(td, "t_time_sk")
    tt, _ = _np_col(td, "t_time")
    sold, sold_ok = _np_col(ss, "ss_sold_date_sk")
    stime, stime_ok = _np_col(ss, "ss_sold_time_sk")
    dlut = np.full(int(dsk.max()) + 1, -1, np.int64)
    dlut[dsk] = np.arange(len(dsk))
    tlut = np.full(int(tsk.max()) + 1, -1, np.int64)
    tlut[tsk] = np.arange(len(tsk))
    # a NULL or unknown key joins nothing: its lut entry is -1
    dlut = np.append(dlut, -1)
    tlut = np.append(tlut, -1)
    drow = dlut[np.where(sold_ok & (sold >= 0) & (sold < len(dlut) - 1),
                         sold, -1)]
    trow = tlut[np.where(stime_ok & (stime >= 0) &
                         (stime < len(tlut) - 1), stime, -1)]
    sel = (drow >= 0) & (trow >= 0)
    secs = days.astype(np.int64)[drow[sel]] * 86400 + \
        tt.astype(np.int64)[trow[sel]]
    paid, paid_ok = _np_col(ss, "ss_net_paid")
    return secs, paid[sel], paid_ok[sel]


def types_oracle(name: str, tables: dict, events=None) -> list:
    """The expected rows of TYPES_QUERIES[name] from numpy and Python's
    str.split over the Arrow tables (`_plain` values); `events`, where
    given, is `_event_seconds(tables)`."""
    import collections

    import numpy as np

    ss = tables["store_sales"]
    if name in ("events", "events_window"):
        secs, paid, paid_ok = events or _event_seconds(tables)
        if name == "events":
            one = np.ones(len(secs), bool)
            return _grouped([np.floor_divide(np.mod(secs, 86400), 3600)],
                            [one], [(paid, paid_ok)])
        lo, hi = (int((np.datetime64(t) - np.datetime64("1970-01-01"))
                      .astype("timedelta64[s]").astype(np.int64))
                  for t in TYPES_WINDOW)
        w = secs[(secs >= lo) & (secs <= hi)] + 5400
        if not len(w):
            return [(None, None, 0)]
        return [(int(w.min()) * 1_000_000, int(w.max()) * 1_000_000,
                 int(len(w)))]
    if name in ("words", "word_arrays"):
        splits = [None if v is None else v.split(" ") for v in
                  tables["customer_address"].column("ca_county").to_pylist()]
        if name == "words":
            # explode of NULL gives no row
            return list(collections.Counter(
                w for sp in splits if sp is not None for w in sp).items())
        return [k + (n,) for k, n in collections.Counter(
            (None,) * 5 if sp is None else
            (len(sp), sp[0], sp[-1], "County" in sp, "+".join(sorted(sp)))
            for sp in splits).items()]
    it = tables["item"]
    isk, _ = _np_col(it, "i_item_sk")
    price, price_ok = _np_col(it, "i_current_price")
    cats = it.column("i_category").to_pylist()
    brands = it.column("i_brand").to_pylist()
    if name == "item_nested":
        return [(int(k), (("category", c), ("brand", b)),
                 ((c, int(p) if ok else None),))
                for k, c, b, p, ok in zip(isk, cats, brands, price,
                                          price_ok)]
    pairs = sorted(set(zip(cats, brands)), key=repr)
    pair_code = {p: i for i, p in enumerate(pairs)}
    icode = np.array([pair_code[p] for p in zip(cats, brands)], np.int64)
    music = np.array([c == "Music" for c in cats], bool) & price_ok
    ilut = np.full(int(isk.max()) + 1, -1, np.int64)
    ilut[isk] = np.arange(len(isk))
    item, item_ok = _np_col(ss, "ss_item_sk")
    ilut = np.append(ilut, -1)
    row = ilut[np.where(item_ok & (item >= 0) & (item < len(ilut) - 1),
                        item, -1)]
    sel = row >= 0
    rs = row[sel]
    g = icode[rs]
    paid, paid_ok = _np_col(ss, "ss_net_paid")
    rows = _grouped([g], [np.ones(len(g), bool)],
                    [(paid[sel], paid_ok[sel])])
    # the best Music price per pair: over the items sold, not the lines
    best = np.full(len(pairs), np.iinfo(np.int64).min, np.int64)
    sold_items = np.nonzero(np.bincount(rs, minlength=len(isk)))[0]
    m = music[sold_items]
    np.maximum.at(best, icode[sold_items][m], price[sold_items][m])
    return [(pairs[k][0], pairs[k][1], n, s,
             int(best[k]) if best[k] != np.iinfo(np.int64).min else None)
            for (k, n, s) in rows]


def types_oracles(tables: dict) -> dict:
    events = _event_seconds(tables)
    return {name: types_oracle(name, tables, events)
            for name in TYPES_QUERIES}


def types_check(name: str, table, want: list) -> str:
    """The result of TYPES_QUERIES[name] against its oracle rows, exactly
    (row order aside)."""
    got = sorted((tuple(_plain(v) for v in r.values())
                  for r in table.to_pylist()), key=repr)
    want = sorted(want, key=repr)
    if len(got) != len(want):
        fail(f"types {name}: {len(got)} rows, the oracle {len(want)}")
    for g, w in zip(got, want):
        if g != w:
            fail(f"types {name}: row {g} is not the oracle's {w}")
    return f"{len(got)} rows equal to the oracle"


def types_leg(torch, sk, card: str, spark, oracles: dict,
              timed_shapes) -> dict:
    """A1's value types and A11's collections at SF10, on the tpcds leg's
    session and views (nothing ingested again; TYPES_TABLES made over them,
    timed):
    each of TYPES_QUERIES at `auto`, then at the stage tier, each result
    held to its numpy oracle (`oracles[name]`, the rows of `types_oracles`
    computed by the `--tpcds-cpu` process), the tier and reason printed (tests/test_torch_nested.py
    holds them to the reference's at scale 0.1); a whole program calls the
    histogram kernel never, and each fused dispatch is one replay
    (`counted_run`). Then the histogram kernel is held against its plain
    version at the stage run's inputs. Returns the launch counts of each
    statement's run at `auto`. TYPES_TABLES stay for the aggregates leg;
    the tpcds leg drops them after it."""
    from spark_tpu_torch.api.dataframe import DataFrame

    t0 = time.perf_counter()
    for table, text in TYPES_TABLES.items():
        t1 = time.perf_counter()
        spark.sql(text)
        torch.cuda.synchronize()
        print(f"types {table} made in {time.perf_counter() - t1:.3f} s",
              flush=True)
    out = {}
    for name, text in TYPES_QUERIES.items():
        label = f"types {name}"
        report, dfs = {}, {}
        for tier in ("auto", "stage"):
            with tier_set(spark, tier):
                df = dfs[tier] = DataFrame(spark, spark.sql(text).plan)
                decision = decision_report(df)
                res, cold, launches, st = counted_run(torch, sk, spark,
                                                      df.toArrow)
                msg = types_check(name, res, oracles[name])
            calls = launches["partition_histogram"]
            if decision["tier"] == "whole" and calls and \
                    not st["whole"]["runtime_degraded"]:
                fail(f"{label}: the whole program launched the histogram "
                     f"kernel {calls} times, not 0")
            if tier == "stage" and decision["tier"] != "stage":
                fail(f"{label}: planned at {decision['tier']} where stage "
                     f"was set ({decision['reason']})")
            cc = st["cache"]
            report[tier] = {
                "tier": decision["tier"], "reason": decision["reason"],
                "check": msg, "cold_s": cold, "histogram_calls": calls,
                "captures": cc.get("stage_cache.captures", 0),
                "replays": cc.get("stage_cache.replays", 0),
                "degrades": st["whole"]["runtime_degraded"],
                "dispatches": st["dispatches"]}
            if tier == "auto":
                out[name] = launches

        def stage_run(df=dfs["stage"]):
            with tier_set(spark, "stage"), bodies_on_card(torch, sk):
                df.toArrow()
        path_histograms(torch, sk, label, {"stage": stage_run}, timed_shapes)
        print(f"{label} tiers " + json.dumps(dict(report, card=card)),
              flush=True)
    print(f"types leg done in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# --- the aggregates leg: A3's aggregates and A11's lambdas over the SF10 views -

# the bit kernel's statements first: the JSON line's launches are theirs
AGG_BITS = ("bits", "bits_two_keys", "bits_global", "bits_months")
_BIT_COLS = ("bit_and(ss_ticket_number) ba, bit_or(ss_item_sk) bo, "
             "bit_xor(ss_customer_sk) bx, count(*) n FROM store_sales")
AGG_QUERIES = {
    # flag rollups over every store_sales line: the dense fused aggregate
    # by store at the stage tier, the sorted-segment one by two keys
    "bits": f"SELECT ss_store_sk, {_BIT_COLS} GROUP BY ss_store_sk",
    "bits_two_keys": f"SELECT ss_store_sk, ss_promo_sk, {_BIT_COLS} "
                     "GROUP BY ss_store_sk, ss_promo_sk",
    "bits_global": f"SELECT {_BIT_COLS}",
    # a month's date keys share their high bits, so AND and OR differ from
    # month to month; over a join, so `auto` lowers it whole
    "bits_months": "SELECT d_year, d_moy, bit_and(ss_sold_date_sk) ba, "
                   "bit_or(ss_sold_date_sk) bo, bit_xor(ss_ticket_number) "
                   "bx, count(*) n FROM store_sales JOIN date_dim ON "
                   "ss_sold_date_sk = d_date_sk GROUP BY d_year, d_moy",
    # a report's quantiles over one year of sales (about 5.8M lines): the
    # gather to one partition and the multi-key sort
    "percentiles": "SELECT ss_store_sk, percentile(ss_quantity, 0.9) p, "
                   "median(ss_net_paid) m, percentile_approx("
                   "ss_sales_price, 0.25) a FROM store_sales JOIN date_dim "
                   "ON ss_sold_date_sk = d_date_sk WHERE d_year = 2001 "
                   "GROUP BY ss_store_sk",
    # string min/max in rank space (a fused body, a whole program) and
    # first over a string, which keeps its dictionary
    "strings": "SELECT s_state, s_city, min(c_last_name) lo, "
               "max(c_first_name) hi, first(c_last_name) f, count(*) n "
               "FROM store_sales JOIN customer ON ss_customer_sk = "
               "c_customer_sk JOIN store ON ss_store_sk = s_store_sk "
               "GROUP BY s_state, s_city",
    "collects": "SELECT i_category, sort_array(collect_set(i_brand)) b, "
                "size(collect_list(i_item_sk)) n FROM item "
                "GROUP BY i_category",
    "moments": "SELECT ss_store_sk, corr(ss_quantity, ss_net_paid) c, "
               "covar_samp(ss_quantity, ss_sales_price) cs, "
               "covar_pop(ss_quantity, ss_sales_price) cp, "
               "skewness(ss_net_paid) sk, kurtosis(ss_quantity) ku "
               "FROM store_sales GROUP BY ss_store_sk",
    "distinct": "SELECT ss_store_sk, sum(DISTINCT ss_quantity) sd, "
                "avg(DISTINCT ss_quantity) ad FROM store_sales "
                "GROUP BY ss_store_sk",
    "mode": "SELECT ss_store_sk, mode(ss_quantity) m FROM store_sales "
            "GROUP BY ss_store_sk",
    # lambdas over the words of every address's county, grouped small
    "lambda_words": "SELECT t, f, e, a, count(*) n FROM (SELECT "
                    "transform(sp, w -> concat(w, '.')) t, filter(sp, w -> "
                    "w <> 'County') f, exists(sp, w -> w = 'County') e, "
                    "aggregate(sp, 0, (acc, w) -> acc + 1) a FROM "
                    "(SELECT split(ca_county, ' ') sp FROM "
                    "customer_address) x) y GROUP BY t, f, e, a",
    "lambda_collect": "SELECT ss_store_sk, aggregate(qs, 0L, (acc, x) -> "
                      "acc + x) tot, size(filter(qs, x -> x > 50)) big "
                      "FROM (SELECT ss_store_sk, collect_set(ss_quantity) "
                      "qs FROM store_sales GROUP BY ss_store_sk) c",
    # the types leg's item_nested map (TYPES_TABLES)
    "lambda_maps": "SELECT big, nv, count(*) n FROM (SELECT "
                   "size(map_filter(m, (k, v) -> v > 50)) big, "
                   "transform_values(m, (k, v) -> v IS NULL) nv FROM "
                   "item_nested) x GROUP BY big, nv",
}
AGG_FLOAT_RTOL = 1e-9           # the moments' oracle: float64 raw moments


class Approx(NamedTuple):
    """An oracle's float64 value and the largest term its formula
    subtracts: a result within AGG_FLOAT_RTOL of the larger of the two
    matches (two summation orders of a cancelling raw-moment formula
    differ by the rounding of its terms, not of its result)."""

    value: float
    scale: float


def _group_code(keys: list, valid: list):
    """(code per row, decode(code) -> key tuple): integer key arrays in
    mixed radix, a NULL key (valid False) its own value."""
    import numpy as np

    code = np.zeros(len(keys[0]) if keys else 0, np.int64)
    radix = []
    for k, v in zip(keys, valid):
        k = k.astype(np.int64)
        lo = int(k[v].min()) if v.any() else 0
        span = (int(k[v].max()) if v.any() else 0) - lo + 2  # NULL last
        code = code * span + np.where(v, k - lo, span - 1)
        radix.append((lo, span))

    def decode(g: int) -> tuple:
        key, rest = [], int(g)
        for lo, span in reversed(radix):
            d = rest % span
            rest //= span
            key.append(None if d == span - 1 else lo + d)
        return tuple(reversed(key))

    return code, decode


def _bits_oracle(keys: list, values: list, n_rows: int) -> list:
    """Rows (keys..., one result per value column, count) of a bits
    statement: one stable sort by group, then a bitwise reduceat per
    column (a NULL value is the identity: all ones for AND, 0 for OR and
    XOR). `keys` and `values` are (array, valid) pairs; `values` are
    reduced by AND, OR and XOR in turn."""
    import numpy as np

    code, decode = _group_code([k[0] for k in keys], [k[1] for k in keys]) \
        if keys else (np.zeros(n_rows, np.int64), lambda g: ())
    order = np.argsort(code, kind="stable")
    code = code[order]
    starts = np.flatnonzero(np.r_[True, code[1:] != code[:-1]])
    outs = []
    for (v, ok), (ufunc, ident) in zip(values, (
            (np.bitwise_and, -1), (np.bitwise_or, 0), (np.bitwise_xor, 0))):
        v, ok = v.astype(np.int64)[order], ok[order]
        red = ufunc.reduceat(np.where(ok, v, ident), starts)
        has = np.add.reduceat(ok.astype(np.int64), starts) > 0
        outs.append([int(x) if h else None for x, h in zip(red, has)])
    counts = np.diff(np.r_[starts, len(code)])
    return [decode(code[st]) + tuple(o[i] for o in outs) + (int(counts[i]),)
            for i, st in enumerate(starts)]


def _bits_months_oracle(tables: dict) -> list:
    """The bits_months rows: store_sales lines whose date key is in
    date_dim, by (d_year, d_moy)."""
    import numpy as np

    ss, dd = tables["store_sales"], tables["date_dim"]
    dsk, _ = _np_col(dd, "d_date_sk")
    lo = int(dsk.min())
    row = np.full(int(dsk.max()) - lo + 1, -1, np.int64)
    row[dsk - lo] = np.arange(len(dsk))
    sold, sold_ok = _np_col(ss, "ss_sold_date_sk")
    inside = sold_ok & (sold >= lo) & (sold <= int(dsk.max()))
    r = np.where(inside, row[np.clip(sold - lo, 0, len(row) - 1)], -1)
    sel = r >= 0
    r = r[sel]
    keys = []
    for name in ("d_year", "d_moy"):
        v, ok = _np_col(dd, name)
        keys.append((v[r], ok[r]))
    ticket, ticket_ok = _np_col(ss, "ss_ticket_number")
    values = [(sold[sel], sold_ok[sel])] * 2 + [(ticket[sel], ticket_ok[sel])]
    return _bits_oracle(keys, values, int(sel.sum()))


def _sorted_runs(code, vals):
    """(group code of each run, run starts, sorted values, run lengths) of
    `vals` ordered by (code, value)."""
    import numpy as np

    order = np.lexsort((vals, code))
    c, v = code[order], vals[order]
    starts = np.flatnonzero(np.r_[True, c[1:] != c[:-1]]) if len(c) else \
        np.zeros(0, np.int64)
    return c[starts], starts, v, np.diff(np.r_[starts, len(c)])


def aggregates_oracle(name: str, tables: dict) -> list:
    """The expected rows of AGG_QUERIES[name] from numpy and Python over
    the Arrow tables (`_plain` values: decimals in int64 units of 0.01;
    the moments in float64 by the reference's raw-moment formulas, each
    an `Approx` with its formula's largest term; the
    strings statement's first as the set of its group's values)."""
    import collections

    import numpy as np

    ss = tables["store_sales"]
    if name in ("bits", "bits_two_keys", "bits_global"):
        keys = {"bits": ("ss_store_sk",),
                "bits_two_keys": ("ss_store_sk", "ss_promo_sk"),
                "bits_global": ()}[name]
        return _bits_oracle([_np_col(ss, k) for k in keys],
                            [_np_col(ss, c) for c in (
                                "ss_ticket_number", "ss_item_sk",
                                "ss_customer_sk")], ss.num_rows)
    if name == "bits_months":
        return _bits_months_oracle(tables)
    store, store_ok = _np_col(ss, "ss_store_sk")
    scode, sdecode = _group_code([store], [store_ok])
    qty, _ = _np_col(ss, "ss_quantity")
    if name == "percentiles":
        dd = tables["date_dim"]
        dsk, _ = _np_col(dd, "d_date_sk")
        year, _ = _np_col(dd, "d_year")
        lut = np.full(int(dsk.max()) + 2, 0, np.int64)
        lut[dsk] = year
        sold, sold_ok = _np_col(ss, "ss_sold_date_sk")
        sel = sold_ok & (sold >= 0) & (sold <= dsk.max()) & \
            (lut[np.clip(sold, 0, len(lut) - 1)] == 2001)
        out = {}
        for col, q in (("ss_quantity", 0.9), ("ss_net_paid", 0.5),
                       ("ss_sales_price", 0.25)):
            v, ok = _np_col(ss, col)
            m = sel & ok
            g, st, sv, cnt = _sorted_runs(scode[m], v[m].astype(np.int64))
            idx = st + np.floor(q * (cnt - 1)).astype(np.int64)
            for gg, x in zip(g, sv[idx]):
                out.setdefault(int(gg), []).append(int(x))
        return [sdecode(g) + tuple(v) for g, v in out.items()]
    if name == "strings":
        cu, st = tables["customer"], tables["store"]
        csk, _ = _np_col(cu, "c_customer_sk")
        ssk, _ = _np_col(st, "s_store_sk")
        clut = np.full(int(csk.max()) + 2, -1, np.int64)
        clut[csk] = np.arange(len(csk))
        slut = np.full(int(ssk.max()) + 2, -1, np.int64)
        slut[ssk] = np.arange(len(ssk))
        cust, cust_ok = _np_col(ss, "ss_customer_sk")
        crow = np.where(cust_ok & (cust >= 0) & (cust < len(clut)),
                        clut[np.clip(cust, 0, len(clut) - 1)], -1)
        srow = np.where(store_ok & (store >= 0) & (store < len(slut)),
                        slut[np.clip(store, 0, len(slut) - 1)], -1)
        sel = (crow >= 0) & (srow >= 0)
        states = st.column("s_state").to_pylist()
        cities = st.column("s_city").to_pylist()
        keys = sorted(set(zip(states, cities)), key=repr)
        kcode = {k: i for i, k in enumerate(keys)}
        gofs = np.array([kcode[k] for k in zip(states, cities)], np.int64)
        g = gofs[srow[sel]]
        counts = np.bincount(g, minlength=len(keys))
        pairs = np.unique(g * len(csk) + crow[sel])
        last = cu.column("c_last_name").to_pylist()
        first = cu.column("c_first_name").to_pylist()
        rows = []
        for k in range(len(keys)):
            if not counts[k]:
                continue
            cs = pairs[(pairs // len(csk)) == k] % len(csk)
            lasts = {last[i] for i in cs} - {None}
            firsts = {first[i] for i in cs} - {None}
            rows.append(keys[k] + (min(lasts) if lasts else None,
                                   max(firsts) if firsts else None,
                                   frozenset(lasts), int(counts[k])))
        return rows
    if name == "collects":
        it = tables["item"]
        groups: dict = {}
        for c, b, sk_ in zip(it.column("i_category").to_pylist(),
                             it.column("i_brand").to_pylist(),
                             it.column("i_item_sk").to_pylist()):
            brands, n = groups.setdefault(c, (set(), [0]))
            if b is not None:
                brands.add(b)
            n[0] += sk_ is not None
        return [(c, tuple(sorted(b)), n[0]) for c, (b, n) in groups.items()]
    if name == "moments":
        paid, _ = _np_col(ss, "ss_net_paid")
        price, _ = _np_col(ss, "ss_sales_price")
        x, y, z = qty.astype(np.float64), paid / 100.0, price / 100.0
        ng = int(scode.max()) + 1

        def s(w):
            return np.bincount(scode, weights=w, minlength=ng)

        n = s(np.ones(len(x)))

        def div(a, b):
            return np.where(b != 0, a / np.where(b != 0, b, 1), np.nan)

        def top(*terms):
            return np.max(np.abs(np.stack(terms)), axis=0)

        # each value with the largest term its formula subtracts, over
        # the same denominator: the raw-moment formulas cancel, so two
        # summation orders agree to AGG_FLOAT_RTOL of that term
        def corr(a, b):
            sa, sb, sab = s(a), s(b), s(a * b)
            den = np.sqrt((n * s(a * a) - sa * sa) * (n * s(b * b) - sb * sb))
            return div(n * sab - sa * sb, den), div(top(n * sab, sa * sb),
                                                    den)

        def covar(a, b, ddof):
            sab, prod = s(a * b), div(s(a) * s(b), n)
            return div(sab - prod, n - ddof), div(top(sab, prod), n - ddof)

        def moments(a):
            mu = div(s(a), n)
            e2, e3, e4 = div(s(a * a), n), div(s(a * a * a), n), \
                div(s((a * a) * (a * a)), n)
            m2 = e2 - mu * mu
            t3 = (e3, 3.0 * (mu * e2), 2.0 * (mu * (mu * mu)))
            m3 = t3[0] - (t3[1] - t3[2])
            mu2 = mu * mu
            t4 = (e4, 4.0 * (mu * e3), 6.0 * (mu2 * e2), 3.0 * (mu2 * mu2))
            m4 = t4[0] - (t4[1] - (t4[2] - t4[3]))
            return m2, (m3, top(*t3)), (m4, top(*t4))

        m2p, (m3p, t3p), _ = moments(y)
        m2q, _, (m4q, t4q) = moments(x)
        cube = np.sqrt(m2p * m2p * m2p)
        cols = [corr(x, y), covar(x, z, 1.0), covar(x, z, 0.0),
                (div(m3p, cube), div(t3p, cube)),
                (div(m4q, m2q * m2q) - 3.0, div(t4q, m2q * m2q))]
        return [sdecode(g) + tuple(
            None if np.isnan(v[g]) else Approx(float(v[g]), float(t[g]))
            for v, t in cols) for g in range(ng) if n[g]]
    if name in ("distinct", "mode", "lambda_collect"):
        pair = scode * 100 + qty.astype(np.int64)
        cnt = np.bincount(pair)
        rows = []
        for g in np.unique(scode):
            c = cnt[g * 100:(g + 1) * 100]
            vals = np.nonzero(c)[0]
            if name == "distinct":
                rows.append(sdecode(g) + (int(vals.sum()),
                                          float(vals.sum()) / len(vals)))
            elif name == "mode":
                rows.append(sdecode(g) + (int(np.argmax(c)),))
            else:
                rows.append(sdecode(g) + (int(vals.sum()),
                                          int((vals > 50).sum())))
        return rows
    if name == "lambda_words":
        counts = collections.Counter()
        for county in tables["customer_address"].column(
                "ca_county").to_pylist():
            if county is None:
                counts[(None,) * 4] += 1
                continue
            sp = county.split(" ")
            counts[(tuple(w + "." for w in sp),
                    tuple(w for w in sp if w != "County"), "County" in sp,
                    len(sp))] += 1
        return [k + (n,) for k, n in counts.items()]
    if name == "lambda_maps":
        it = tables["item"]
        price, price_ok = _np_col(it, "i_current_price")
        counts = collections.Counter(
            (int(ok and p > 5000), ((c, not ok),))
            for c, p, ok in zip(it.column("i_category").to_pylist(), price,
                                price_ok))
        return [k + (n,) for k, n in counts.items()]
    raise KeyError(name)


def aggregates_check(name: str, table, want: list) -> str:
    """The result of AGG_QUERIES[name] against its oracle rows (row order
    aside): exact, but the moments within AGG_FLOAT_RTOL of the larger of
    the value and the largest term its formula subtracts (`Approx`), and the
    strings statement's first, which must be one of its group's values
    (Spark leaves the row it takes unspecified)."""
    import math

    got = sorted((tuple(_plain(v) for v in r.values())
                  for r in table.to_pylist()), key=repr)
    want = sorted(want, key=repr)
    if len(got) != len(want):
        fail(f"aggregates {name}: {len(got)} rows, the oracle {len(want)}")
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, frozenset):
                ok = x in y if y else x is None
            elif isinstance(y, Approx):
                ok = isinstance(x, float) and abs(x - y.value) <= \
                    AGG_FLOAT_RTOL * max(abs(y.value), y.scale)
            else:
                ok = x == y
            if not ok:
                fail(f"aggregates {name}: row {g} is not the oracle's {w}")
    return f"{len(got)} rows equal to the oracle"


def path_bits(torch, sk, label: str, runs, timed_shapes) -> int:
    """The bit kernel at a path's own inputs: one more run of each of
    `runs` ({tier: run}) keeps a copy of the inputs of each segment_bits
    call of a new (rows, segments, kind, live share), inside whole
    programs and fused bodies too (`bodies_on_card` runs each body once
    more eagerly, so the wrapper runs in Python at the replay's inputs),
    then holds each copy against the plain version, and times it where
    its (rows, segments, kind) is not yet in `timed_shapes`. Returns the
    number of inputs held."""
    from spark_tpu_torch.ops import grouping as G

    seen, inputs = set(), []
    real = G.segment_bits

    def keep(values, weights, seg_ids, num_segments, kind, count):
        if not torch.cuda.is_current_stream_capturing():
            n, live = seg_ids.shape[0], int(weights.sum())
            shape = (n, num_segments, kind, round(live / max(n, 1), 2))
            if shape not in seen:
                seen.add(shape)
                inputs.append((values.clone(), weights.clone(),
                               seg_ids.to(torch.int32, copy=True)
                               .contiguous(), num_segments, kind, live))
        return real(values, weights, seg_ids, num_segments, kind, count)

    G.segment_bits = keep
    try:
        for tier, run in runs.items():
            with bodies_on_card(torch, sk):
                run()
    finally:
        G.segment_bits = real
    timed = 0
    for v, m, g, segs, kind, live in inputs:
        shape = f"{label}: {g.shape[0]:,} rows, {segs:,} segments, " \
                f"{live:,} live"
        if (g.shape[0], segs, kind) not in timed_shapes:
            timed_shapes.add((g.shape[0], segs, kind))
            bits_row(torch, sk, shape, v, m, g, segs, kind)
            timed += 1
        else:
            bits_check(torch, sk, shape, v, m, g, segs, kind)
    print(f"{label}: the bit kernel equals its plain version at "
          f"{len(inputs)} path inputs ({timed} timed)", flush=True)
    return len(inputs)


def aggregates_leg(torch, sk, card: str, spark, oracles: dict,
                   timed_shapes) -> dict:
    """A3's aggregates and A11's lambdas at SF10, on the tpcds leg's
    session and views (nothing ingested again; the types leg's
    item_nested table still made): each of AGG_QUERIES at `auto` (its
    decision printed; tests/test_torch_aggregates_leg.py holds it to the
    reference's on the same plan at a small scale), then at the stage tier
    and, for the bits statements, at the whole tier (each skipped where
    `auto` chose it: that run is its run), each result held to its oracle
    rows (`oracles[name]`, computed by the `--tpcds-cpu` process). A whole
    program calls the histogram kernel only for a bit reduce's counts;
    each fused dispatch is one replay (`counted_run`); the bits
    statements launch the bit kernel at every tier. Then one more run of
    the bits statements at each of their tiers holds the bit kernel
    against its plain version at every input they gave it, inside whole
    programs too. Returns the launch counts of each statement's run at
    each tier, and the tier `auto` chose for each statement."""
    from spark_tpu_torch.api.dataframe import DataFrame

    t0 = time.perf_counter()
    out, auto_tiers, bit_runs = {}, {}, {}
    for name, text in AGG_QUERIES.items():
        label = f"aggregates {name}"
        report = {}
        tiers = ("auto", "stage") + (("whole",) if name in AGG_BITS else ())
        for tier in tiers:
            if tier != "auto" and report["auto"]["tier"] == tier:
                out[(name, tier)] = out[(name, "auto")]
                report[tier] = f"the auto run (auto chose {tier})"
                continue
            with tier_set(spark, tier):
                df = DataFrame(spark, spark.sql(text).plan)
                decision = decision_report(df)
                res, secs, launches, st = counted_run(torch, sk, spark,
                                                      df.toArrow)
                msg = aggregates_check(name, res, oracles[name])
            calls = launches["partition_histogram"]
            bits = launches["segment_bits"]
            # in a whole program the histogram kernel counts only the bit
            # reduces' weighted rows, one call for each
            if decision["tier"] == "whole" and calls != bits and \
                    not st["whole"]["runtime_degraded"]:
                fail(f"{label}: the whole program launched the histogram "
                     f"kernel {calls} times, not {bits}")
            if tier != "auto" and decision["tier"] != tier:
                fail(f"{label}: planned at {decision['tier']} where {tier} "
                     f"was set ({decision['reason']})")
            if (name in AGG_BITS) != (bits > 0):
                fail(f"{label}: {bits} bit kernel launches at {tier}")
            cc = st["cache"]
            report[tier] = {
                "tier": decision["tier"], "reason": decision["reason"],
                "check": msg, "seconds": secs, "histogram_calls": calls,
                "bit_kernel_calls": bits,
                "captures": cc.get("stage_cache.captures", 0),
                "replays": cc.get("stage_cache.replays", 0),
                "degrades": st["whole"]["runtime_degraded"],
                "dispatches": st["dispatches"]}
            out[(name, tier)] = launches
            if tier == "auto":
                auto_tiers[name] = decision["tier"]
            if name in AGG_BITS:
                def run(df=df, tier=tier):
                    with tier_set(spark, tier):
                        df.toArrow()
                bit_runs[f"{name} {tier}"] = run
        print(f"{label} tiers " + json.dumps(dict(report, card=card)),
              flush=True)
    path_bits(torch, sk, "aggregates bits", bit_runs, timed_shapes)
    print(f"aggregates leg done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out, auto_tiers


# --- the maintenance leg: TPC-DS data maintenance over the SF10 views --------

# TPC-DS v3.2.0 clause 5 (Data Maintenance): LF_SS loads a refresh set of
# store sales, DF_SS deletes the sales of a date range and the returns of
# their tickets. The specification's refresh sets come from dsdgen's update
# option, which the repo does not have, so the leg derives its refresh set
# from the seeded tables: the lines of 30 days of store_sales with their
# ticket numbers moved past the largest. The item dimension takes a MERGE
# (every tenth item repriced, MAINT_NEW_ITEMS new items) and an UPDATE of
# i_manager_id, which q19 reads.
MAINT_REFRESH_DAYS = ("1998-11-01", "1998-11-30")   # LF_SS source lines
MAINT_DELETE_DAYS = ("2000-03-01", "2000-03-30")    # DF_SS lines and returns
MAINT_NEW_ITEMS = 1000
# statement -> the view it changes
MAINT_TARGETS = {"create_refresh": "ss_refresh",
                 "delete_returns": "store_returns",
                 "delete_sales": "store_sales",
                 "insert_sales": "store_sales",
                 "create_item_delta": "item_delta",
                 "merge_item": "item", "update_item": "item"}
MAINT_QUERIES = ("q3", "q7", "q19")


def _sql_type(t) -> str:
    import pyarrow as pa

    if pa.types.is_int32(t):
        return "INT"
    if pa.types.is_int64(t):
        return "BIGINT"
    if pa.types.is_decimal(t):
        return f"DECIMAL({t.precision}, {t.scale})"
    raise ValueError(f"no SQL type for {t}")


def maintenance_deletes() -> dict:
    """DF_SS's DELETE conditions, by statement."""
    days = (f"d_date BETWEEN DATE '{MAINT_DELETE_DAYS[0]}' AND "
            f"DATE '{MAINT_DELETE_DAYS[1]}'")
    return {"delete_returns":
            "sr_ticket_number IN (SELECT ss_ticket_number FROM store_sales, "
            f"date_dim WHERE ss_sold_date_sk = d_date_sk AND {days})",
            "delete_sales": "ss_sold_date_sk IN (SELECT d_date_sk FROM "
            f"date_dim WHERE {days})"}


def maintenance_statements(tables: dict) -> dict:
    """The leg's statements in order ({name: SQL}), over the views of
    `tables` (their schemas give the column lists): the LF_SS refresh set
    (CTAS), DF_SS (the returns, then the sales), LF_SS (INSERT), the item
    delta (CTAS of a UNION ALL), the MERGE and the UPDATE."""
    def cols(schema, name, expr):
        return ", ".join(
            f"CAST({expr} AS {_sql_type(f.type)}) AS {f.name}"
            if f.name == name else f.name for f in schema)

    def days(window):
        return f"d_date BETWEEN DATE '{window[0]}' AND DATE '{window[1]}'"

    ss, it = tables["store_sales"].schema, tables["item"].schema
    ticket = ("ss_ticket_number + "
              "(SELECT max(ss_ticket_number) FROM store_sales)")
    new_sk = "i_item_sk + (SELECT max(i_item_sk) FROM item)"
    return {
        "create_refresh":
            f"CREATE TABLE ss_refresh AS SELECT "
            f"{cols(ss, 'ss_ticket_number', ticket)} FROM store_sales "
            f"WHERE ss_sold_date_sk IN (SELECT d_date_sk FROM date_dim "
            f"WHERE {days(MAINT_REFRESH_DAYS)})",
        "delete_returns": "DELETE FROM store_returns WHERE "
                          + maintenance_deletes()["delete_returns"],
        "delete_sales": "DELETE FROM store_sales WHERE "
                        + maintenance_deletes()["delete_sales"],
        "insert_sales": "INSERT INTO store_sales SELECT * FROM ss_refresh",
        "create_item_delta":
            f"CREATE TABLE item_delta AS SELECT "
            f"{cols(it, 'i_current_price', 'i_current_price + 1')} "
            f"FROM item WHERE i_item_sk % 10 = 0 UNION ALL SELECT "
            f"{cols(it, 'i_item_sk', new_sk)} FROM item "
            f"WHERE i_item_sk <= {MAINT_NEW_ITEMS}",
        "merge_item":
            "MERGE INTO item t USING item_delta s ON t.i_item_sk = "
            "s.i_item_sk WHEN MATCHED THEN UPDATE SET i_current_price = "
            "s.i_current_price WHEN NOT MATCHED THEN INSERT *",
        "update_item":
            "UPDATE item SET i_manager_id = 8 WHERE i_manager_id = 9 AND "
            "i_item_sk % 3 = 0",
    }


def maintenance_oracle(tables: dict, arrays: dict | None = None) -> dict:
    """What the leg must leave, from numpy over the unchanged tables: each
    statement's view rows after it, the checks' values over the changed
    store_sales, and (given the tpcds leg's `arrays`) q3, q7 and q19's
    full results with the same edits applied."""
    import numpy as np

    dsk, _ = _np_col(tables["date_dim"], "d_date_sk")
    dday, _ = _np_col(tables["date_dim"], "d_date")

    def window_sks(window):
        lo, hi = (np.datetime64(d).astype("datetime64[D]").astype(np.int64)
                  for d in window)
        return dsk[(dday >= lo) & (dday <= hi)]

    ss = tables["store_sales"]
    date, date_ok = _np_col(ss, "ss_sold_date_sk")
    ticket, ticket_ok = _np_col(ss, "ss_ticket_number")
    refresh = date_ok & np.isin(date, window_sks(MAINT_REFRESH_DAYS))
    dropped = date_ok & np.isin(date, window_sks(MAINT_DELETE_DAYS))
    keep = ~dropped
    shift = int(ticket[ticket_ok].max())
    sr = tables["store_returns"]
    sr_ticket, sr_ok = _np_col(sr, "sr_ticket_number")
    gone_tickets = np.unique(ticket[dropped & ticket_ok])
    sr_keep = ~(sr_ok & np.isin(sr_ticket, gone_tickets))
    it = tables["item"]
    isk, _ = _np_col(it, "i_item_sk")
    mgr, mgr_ok = _np_col(it, "i_manager_id")
    n_delta = int((isk % 10 == 0).sum()) + int((isk <= MAINT_NEW_ITEMS).sum())
    rows = {"create_refresh": int(refresh.sum()),
            "delete_returns": int(sr_keep.sum()),
            "delete_sales": int(keep.sum()),
            "insert_sales": int(keep.sum() + refresh.sum()),
            "create_item_delta": n_delta,
            "merge_item": it.num_rows + int((isk <= MAINT_NEW_ITEMS).sum()),
            "update_item": it.num_rows + int((isk <= MAINT_NEW_ITEMS).sum())}

    def final(name):
        v, ok = _np_col(ss, name)
        if name == "ss_ticket_number":
            return (np.concatenate([v[keep], v[refresh] + shift]),
                    np.concatenate([ok[keep], ok[refresh]]))
        return (np.concatenate([v[keep], v[refresh]]),
                np.concatenate([ok[keep], ok[refresh]]))

    paid, paid_ok = final("ss_net_paid")
    qty, qty_ok = final("ss_quantity")
    tk, tk_ok = final("ss_ticket_number")
    promo, promo_ok = final("ss_promo_sk")
    out = {"rows": rows,
           "count": int(len(paid)), "sum_net_paid": int(paid[paid_ok].sum()),
           "tickets": int(len(np.unique(tk[tk_ok])) + (~tk_ok).any()),
           "fill_sum": int(promo[promo_ok].sum()),
           "fill_count": int(len(promo)),
           "fill_nulls": int((~promo_ok).sum())}
    desc = {}
    for name, (v, ok) in (("ss_quantity", (qty, qty_ok)),
                          ("ss_net_paid", (paid, paid_ok))):
        x = v[ok].astype(np.float64)
        desc[name] = {"count": int(ok.sum()), "mean": float(x.mean()),
                      "stddev": float(x.std(ddof=1)), "min": int(v[ok].min()),
                      "max": int(v[ok].max())}
    out["describe"] = desc
    if arrays is not None:
        a = dict(arrays)
        if len(a["ss"]["ss_sold_date_sk"]) != ss.num_rows:
            fail("maintenance: the oracle arrays do not match store_sales")

        class Edited(dict):
            """A column of `base` with the edits applied, made when the
            oracles first read it."""

            def __init__(self, base):
                super().__init__()
                self.base = base

            def __missing__(self, k):
                v = self.base[k]
                self[k] = out = np.concatenate([v[keep], v[refresh]])
                return out

        a["ss"], a["nulls"] = Edited(arrays["ss"]), Edited(arrays["nulls"])
        item = dict(arrays["item"])
        item["i_manager_id"] = np.where(
            (item["i_manager_id"] == 9) & (item["i_item_sk"] % 3 == 0), 8,
            item["i_manager_id"])
        a["item"] = item
        out["queries"] = {q: tpcds_oracle(q, a) for q in MAINT_QUERIES}
    return out


def _view_rows(spark, name: str):
    """Rows of the in-memory table a view holds (None: no such view)."""
    from spark_tpu_torch.errors import AnalysisException

    try:
        rel = spark.catalog_.lookup([name])
    except AnalysisException:
        return None
    return rel.table.num_rows


def _tile_bytes(spark, name: str) -> int:
    """Device bytes of the ingested tiles of the table view `name` holds."""
    rel = spark.catalog_.lookup([name])
    entry = spark._scan_cache.get(id(rel.table))
    total = 0
    for batches in (entry[1].values() if entry else ()):
        for b in batches:
            ts = [b.row_mask] + [t for c in b.columns
                                 for t in (c.data, c.validity)
                                 if t is not None]
            total += sum(t.numel() * t.element_size() for t in ts)
    return total


def maintenance_checks(spark, F, want: dict, label: str) -> dict:
    """The leg's checks after the changes, each against `want`
    (maintenance_oracle): count and sum(ss_net_paid) exact, the distinct
    tickets of dropDuplicates, describe() of two columns (count, min and
    max exact, the mean to relative 1e-12 and stddev to 1e-9) and an
    aggregate over na.fill of the nullable ss_promo_sk. Returns what each
    gave."""
    import decimal

    got = {}
    r = spark.sql("SELECT count(*) AS n, sum(ss_net_paid) AS s FROM "
                  "store_sales").toArrow().to_pylist()[0]
    got["count"], got["sum_net_paid"] = r["n"], _dec(r["s"])
    got["tickets"] = spark.table("store_sales") \
        .dropDuplicates(["ss_ticket_number"]).count()
    # ss_promo_sk is the nullable column: 30% of the lines have none
    r = spark.table("store_sales").na.fill(0, ["ss_promo_sk"]).agg(
        F.sum("ss_promo_sk").alias("s"), F.count("ss_promo_sk").alias("n"),
        F.sum(F.when(F.col("ss_promo_sk") == 0, 1).otherwise(0))
        .alias("z")).collect()[0]
    got["fill_sum"], got["fill_count"], got["fill_nulls"] = \
        r["s"], r["n"], r["z"]
    for key in ("count", "sum_net_paid", "tickets", "fill_sum",
                "fill_count", "fill_nulls"):
        if got[key] != want[key]:
            fail(f"{label}: {key} {got[key]}, not {want[key]}")
    desc = spark.table("store_sales").describe("ss_quantity", "ss_net_paid") \
        .collect()
    stats = {r["summary"]: r for r in desc}
    for col, exp in want["describe"].items():
        scale = 100 if col == "ss_net_paid" else 1
        for key in ("count", "min", "max"):
            v = stats[key][col]
            v = int(v) if key == "count" or scale == 1 else \
                int(decimal.Decimal(v).scaleb(2))
            if v != exp[key]:
                fail(f"{label}: describe {col} {key} {v}, not {exp[key]}")
        for key, rel in (("mean", 1e-12), ("stddev", 1e-9)):
            # the engine's stddev is (sumsq - sum^2 / n) / (n - 1) over
            # float64 sums of up to 2^25 rows, numpy's two passes; a
            # decimal mean is rounded to 6 places
            v = float(stats[key][col]) * scale
            tol = max(rel * abs(exp[key]),
                      0.5e-6 * scale if key == "mean" and scale > 1 else 0)
            if abs(v - exp[key]) > tol:
                fail(f"{label}: describe {col} {key} {v}, not {exp[key]}")
    got["describe"] = {c: {k: stats[k][c] for k in stats} for c in
                       want["describe"]}
    return got


def maintenance_leg(torch, sk, card: str, spark, tables: dict, arrays: dict,
                    timed_shapes) -> dict:
    """TPC-DS data maintenance at SF10 on the tpcds leg's session and
    views, after every other run of that session: each statement of
    `maintenance_statements` through session.sql at `auto`, its view's
    rows before and after held to numpy (`maintenance_oracle`), its time
    and histogram calls printed; each statement's work again at the stage
    tier (the INSERT's and the DELETEs' queries, the others as written),
    where the histogram kernel is held against its plain version at every
    input of a new shape. Then q3, q7 and q19
    against their numpy oracles over the changed arrays, and the checks
    of `maintenance_checks`. Device memory after the changes may exceed
    what it was before by at most the new tables' ingested bytes plus 10%:
    a replaced view's tiles must go (the stage cache is emptied before
    both readings). Returns the launch counts of each statement at auto."""
    import gc

    import spark_tpu_torch.api.functions as F
    from spark_tpu_torch.physical.compile import STAGE_CACHE

    t0 = time.perf_counter()
    want = maintenance_oracle(tables, arrays)
    print(f"maintenance oracle computed in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def settled_memory() -> int:
        STAGE_CACHE.clear()
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    mem0 = settled_memory()
    t1 = time.perf_counter()
    out = {}
    for name, text in maintenance_statements(tables).items():
        target = MAINT_TARGETS[name]
        before = _view_rows(spark, target)
        _, secs, launches, st = counted_run(torch, sk, spark,
                                            lambda text=text: spark.sql(text))
        after = _view_rows(spark, target)
        if after != want["rows"][name]:
            fail(f"maintenance {name}: {target} holds {after} rows, not "
                 f"{want['rows'][name]}")
        out[name] = launches
        # the recording run: the INSERT's query, a DELETE's query of the
        # rows it keeps run without the collect to Arrow (the command's
        # plan; 28.3M lines of store_sales take seconds to collect), and
        # the other statements again (each leaves its view as it was)
        cond = maintenance_deletes().get(name)
        again = "SELECT * FROM ss_refresh" if name == "insert_sales" else \
            f"SELECT * FROM {target} WHERE NOT ({cond}) OR ({cond}) IS NULL" \
            if cond else text

        def stage_run(again=again, query=again != text):
            with tier_set(spark, "stage"), bodies_on_card(torch, sk):
                df = spark.sql(again)
                if query:
                    df.query_execution.execute()
                    torch.cuda.synchronize()
        calls, _ = path_histograms(torch, sk, f"maintenance {name}",
                                   {"stage": stage_run}, timed_shapes)
        if _view_rows(spark, target) != after:
            fail(f"maintenance {name}: its stage-tier run changed {target}")
        print(f"maintenance {name} " + json.dumps({
            "view": target, "rows_before": before, "rows_after": after,
            "s": secs, "histogram_calls": launches["partition_histogram"],
            "histogram_calls_at_stage": calls["stage"],
            "whole_dispatches": st["dispatches"].get("whole_query", 0),
            "captures": st["cache"].get("stage_cache.captures", 0),
            "card": card}), flush=True)
    statements_s = time.perf_counter() - t1
    for q in MAINT_QUERIES:
        rows, key = want["queries"][q]
        res, secs, launches, _ = counted_run(
            torch, sk, spark, lambda q=q: spark.sql(tpcds_text(q)).toArrow())
        msg = _check_topk(f"maintenance {q}", tpcds_rows(q, res), rows, key)
        out[q] = launches
        print(f"maintenance {q} " + json.dumps({
            "check": msg, "s": secs,
            "histogram_calls": launches["partition_histogram"],
            "card": card}), flush=True)
    got = maintenance_checks(spark, F, want, "maintenance")
    new_bytes = sum(_tile_bytes(spark, v) for v in set(MAINT_TARGETS.values()))
    mem1 = settled_memory()
    if mem1 - mem0 > 1.1 * new_bytes:
        fail(f"maintenance: device memory grew by {mem1 - mem0:,} bytes, "
             f"more than the new tables' {new_bytes:,} ingested bytes + 10%")
    print("maintenance checks " + json.dumps({
        **{k: v for k, v in got.items() if k != "describe"},
        "describe": got["describe"],
        "memory_allocated_before": mem0, "memory_allocated_after": mem1,
        "new_tables_tile_bytes": new_bytes, "statements_s": statements_s,
        "leg_s": time.perf_counter() - t0, "card": card}, default=str),
        flush=True)
    return out


def nested_loop_pairs(spark, q: str, run, card: str) -> None:
    """One more run of a query that plans NestedLoopJoinExec: the pairs
    all-pairs enumeration would form (computed, probe rows x build rows)
    and the pairs it formed (by key where its condition has an equality of
    the two sides); fails if any pair tile passed the operator's cap."""
    from spark_tpu_torch.config import NESTED_LOOP_TILE_FACTOR

    before = spark.metrics
    run()
    after = spark.metrics
    cap = TPCDS_CONF["spark.tpu.batch.capacity"] * NESTED_LOOP_TILE_FACTOR
    pairs = {k: after.get(f"nlj.{k}", 0) - before.get(f"nlj.{k}", 0)
             for k in ("pairs_all", "pairs_formed")}
    pairs.update({"largest_tile_so_far": after.get("nlj.max_tile", 0),
                  "tile_cap": cap, "card": card})
    print(f"tpcds {q} nested_loop " + json.dumps(pairs), flush=True)
    if pairs["largest_tile_so_far"] > cap:
        fail(f"tpcds {q}: a nested-loop pair tile of "
             f"{pairs['largest_tile_so_far']} rows passed the cap {cap}")


# queries whose SF10 result is not held to the CPU: each took over 30 s
# there on the CPU of the H100's machine (PERF.md: q78 155-157 s; of the
# third slice's, q4 61.7 s, q66 56.0 s, q97 37.1 s, q11 35.6 s, q9
# 33.6 s; of the fourth's, q67 184.9 s, q22 145.4 s, q80 82.2 s, q21
# 64.0 s, q70 53.2 s, q5 48.1 s, q27 39.4 s; of the fifth's, q14a
# 83.9 s, q14b 73.3 s, q95 65.7 s, q39b 35.9 s, q88 32.6 s, q39a 31.7 s);
# the gate still holds them to the CPU and their goldens at scale 0.1
TPCDS_CPU_SKIP = ("q13", "q25", "q29", "q50", "q64", "q78", "q4", "q9",
                  "q11", "q66", "q97", "q67", "q22", "q80", "q21", "q70",
                  "q5", "q27", "q14a", "q14b", "q95", "q39b", "q88", "q39a")


TPCDS_CPU_DIR = os.path.join(ROOT, "build", "tpcds_cpu")
ORACLES_FILE = os.path.join(TPCDS_CPU_DIR, "oracles.pkl")


def side_oracles(proc: subprocess.Popen) -> dict:
    """The expressions, types and aggregates legs' oracle rows, as the
    `--tpcds-cpu` process wrote them (it computes them before its
    queries); waits for the file, and fails if the process ended without
    it. Prints the wait."""
    t0 = time.perf_counter()
    while not os.path.exists(ORACLES_FILE):
        if proc.poll() is not None:
            with open(os.path.join(TPCDS_CPU_DIR, "log.txt")) as f:
                tail = f.read()[-2000:]
            fail(f"the tpcds CPU process ended with {proc.returncode} and "
                 f"no oracles:\n{tail}")
        time.sleep(0.5)
    with open(ORACLES_FILE, "rb") as f:
        oracles = pickle.load(f)
    print(f"leg oracles read after a wait of {time.perf_counter() - t0:.1f}"
          " s (computed by the tpcds CPU process)", flush=True)
    return oracles


def start_tpcds_cpu() -> subprocess.Popen:
    """The SF10 CPU results in a process of their own (this script with
    `--tpcds-cpu`), started before the card's tpcds phases so that it runs
    beside them: it builds the same seeded tables and writes each result
    to TPCDS_CPU_DIR. It sees no CUDA device."""
    import shutil

    shutil.rmtree(TPCDS_CPU_DIR, ignore_errors=True)
    os.makedirs(TPCDS_CPU_DIR)
    with open(os.path.join(TPCDS_CPU_DIR, "log.txt"), "w") as log:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tpcds-cpu"],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def tpcds_cpu_results() -> None:
    """`--tpcds-cpu`: first the oracle rows of the expressions, types and
    aggregates legs over tpcds_data(), written to ORACLES_FILE; then each
    tpcds query but those of TPCDS_CPU_SKIP and TPCDS_ORACLES on a
    TorchSession(device="cpu") over the same tables, its Arrow result and
    its time written to TPCDS_CPU_DIR. It leaves two cores to the process
    that drives the card."""
    import pyarrow as pa
    import torch

    sys.path.insert(0, ROOT)
    from spark_tpu_torch import TorchSession

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) - 2))
    tables, _ = tpcds_data()
    # the legs' oracles first: the card's process waits for them
    t0 = time.perf_counter()
    oracles = {
        "expressions": {name: expression_oracle(name, tables)
                        for name in EXPRESSION_QUERIES},
        "types": types_oracles(tables),
        "aggregates": {name: aggregates_oracle(name, tables)
                       for name in AGG_QUERIES}}
    tmp = ORACLES_FILE + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(oracles, f)
    os.replace(tmp, ORACLES_FILE)
    print(f"oracles {time.perf_counter() - t0:.3f} s", flush=True)
    # the oracle: operator at a time (at `auto` the CPU would run whole
    # programs over 2^25-slot flows)
    cpu = TorchSession("chip_smoke_cpu", dict(TPCDS_CONF, **{TIER: "operator"}),
                       device="cpu")
    for name, table in tables.items():
        cpu.createDataFrame(table).createOrReplaceTempView(name)
    secs = {}
    for q in TPCDS_QUERIES:
        if q in TPCDS_CPU_SKIP or q in TPCDS_ORACLES or q in TPCDS_SF10_CUT:
            continue
        t0 = time.perf_counter()
        want = cpu.sql(tpcds_text(q)).toArrow()
        secs[q] = time.perf_counter() - t0
        with pa.OSFile(os.path.join(TPCDS_CPU_DIR, f"{q}.arrow"), "wb") as f:
            with pa.ipc.new_file(f, want.schema) as w:
                w.write_table(want)
        print(f"{q} {secs[q]:.3f} s", flush=True)
    cpu.stop()
    with open(os.path.join(TPCDS_CPU_DIR, "cpu_s.json"), "w") as f:
        json.dump(secs, f)


def tpcds_cpu_check(proc: subprocess.Popen, results: dict,
                    t_start: float) -> None:
    """Each SF10 result from the card, but those of TPCDS_CPU_SKIP, equal
    row for row to the port's on the CPU over the same tables, as the
    `--tpcds-cpu` process wrote it (waited for until the script has run
    1150 s); its CPU times printed."""
    import resource
    import shutil

    import pyarrow as pa

    try:
        rc = proc.wait(timeout=max(1.0, 1150 - (time.perf_counter()
                                                - t_start)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed at the script's 1150th second"
    if rc != 0:
        with open(os.path.join(TPCDS_CPU_DIR, "log.txt")) as f:
            tail = f.read()[-2000:]
        fail(f"the tpcds CPU process ended with {rc}:\n{tail}")
    with open(os.path.join(TPCDS_CPU_DIR, "cpu_s.json")) as f:
        secs = json.load(f)
    for q, got in results.items():
        if q in TPCDS_CPU_SKIP:
            continue
        if q not in secs:
            fail(f"tpcds {q}: the CPU process has no result")
        with pa.memory_map(os.path.join(TPCDS_CPU_DIR, f"{q}.arrow")) as f:
            want = pa.ipc.open_file(f).read_all()
        if not same_result(q, got, want):
            fail(f"tpcds {q}: the card's SF10 result differs from the "
                 "CPU's")
    shutil.rmtree(TPCDS_CPU_DIR, ignore_errors=True)
    print("tpcds cpu " + json.dumps({
        "equal": sorted(q for q in results if q not in TPCDS_CPU_SKIP),
        "skipped": TPCDS_CPU_SKIP, "cpu_s": secs,
        "total_cpu_s": sum(secs.values()),
        "largest_child_max_rss_gb": resource.getrusage(
            resource.RUSAGE_CHILDREN).ru_maxrss / 1e6,
        "max_rss_gb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1e6}), flush=True)


# ---------------------------------------------------------------------------
# The parquet leg: TPC-DS q3, q7 and q19 read from Parquet files (SF100's
# dimensions, store_sales cut to SF10), dynamic partition pruning over a
# date-partitioned store_sales at SF10, static partition and row-group
# pruning, spark.range and SELECT without FROM
# ---------------------------------------------------------------------------

# the TPC-DS specification's SF100 row counts of the tables q3, q7 and q19
# read, but store_sales: SF100's 287,997,024 lines are cut to SF10's, the
# tpcds leg's count, because the scan decodes and ingests them on the host
# at 6-8M lines a second and the script's time limit holds no more
# (PERF.md section 4 has the runs that forced the cut)
PARQUET_ROWS = {"store_sales": 28_800_991, "date_dim": 73_049,
                "item": 204_000, "customer": 2_000_000,
                "customer_address": 1_000_000,
                "customer_demographics": 1_920_800, "promotion": 1_000,
                "store": 402}
PARQUET_DIR = os.path.join(ROOT, "build", "tpcds_parquet")
PARQUET_SEED = 20               # numpy seed of the parquet leg's tables
PARQUET_CHUNK = 1 << 24         # store_sales rows per file (whole tickets)
PARQUET_ROW_GROUP = 1 << 20
PARQUET_QUERIES = ("q3", "q7", "q19")
DPP_ROWS = 28_800_991           # SF10 store_sales, partitioned by date
PARQUET_DISK_GB = 12            # free disk the leg's files need, at most
# each query's physical operator sequence over the Parquet views at
# PARQUET_ROWS (tests/test_torch_scan_leaves.py plans both engines at these
# row counts and holds them to this table): date_dim and store_sales meet
# in a shuffled join, every other dimension is broadcast, and the aggregate
# merges its partials (_MERGE)
_PSCAN = ("ComputeExec", "ScanExec")
_PBCAST = ("BroadcastExchangeExec",) + _PSCAN
_PTOP = _TOPK_OPS[:-1] + _MERGE
# the parquet leg's plans at the stage tier (the leg runs at the default
# tier): each shuffle exchange runs its scan's filter/project in its map
# program, a join whose probe pipeline fuses loses its ComputeExec, and
# q19's partial aggregate fuses with the Compute below it
_PFSHUF = ("ShuffleExchangeExec", "ScanExec")
PARQUET_PLAN_OPS = {
    "q3": _PTOP + _JOIN + ("HashJoinExec",) + _PFSHUF * 2 + _PBCAST,
    "q7": _PTOP + ("HashJoinExec",) * 3 + ("ComputeExec", "HashJoinExec")
    + _PFSHUF * 2 + _PBCAST * 3,
    "q19": _PTOP[:-1] + ("FusedAggregateExec",) + ("HashJoinExec",) * 3
    + ("ComputeExec", "HashJoinExec") * 2 + _PFSHUF * 2 + _PBCAST * 4,
}
# the parquet leg runs at the default tier, `auto` (PARQUET_PLAN_OPS are
# the stage plans a whole program holds inside), its DPP checks at `stage`
PARQUET_CONF = dict(TPCDS_CONF)
# the columns each scan reads (column pruning into the Parquet reader)
PARQUET_SCAN_COLS = {
    "q3": (("date_dim", ("d_date_sk", "d_year", "d_moy")),
           ("store_sales", ("ss_sold_date_sk", "ss_item_sk",
                            "ss_ext_sales_price")),
           ("item", ("i_item_sk", "i_brand_id", "i_brand",
                     "i_manufact_id"))),
    "q7": (("date_dim", ("d_date_sk", "d_year")),
           ("store_sales", ("ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk",
                            "ss_promo_sk", "ss_quantity", "ss_list_price",
                            "ss_sales_price", "ss_coupon_amt")),
           ("customer_demographics", ("cd_demo_sk", "cd_gender",
                                      "cd_marital_status",
                                      "cd_education_status")),
           ("item", ("i_item_sk", "i_item_id")),
           ("promotion", ("p_promo_sk", "p_channel_email",
                          "p_channel_event"))),
    "q19": (("date_dim", ("d_date_sk", "d_year", "d_moy")),
            ("store_sales", ("ss_sold_date_sk", "ss_item_sk",
                             "ss_customer_sk", "ss_store_sk",
                             "ss_ext_sales_price")),
            ("customer", ("c_customer_sk", "c_current_addr_sk")),
            ("customer_address", ("ca_address_sk", "ca_zip")),
            ("item", ("i_item_sk", "i_brand_id", "i_brand", "i_manufact_id",
                      "i_manufact", "i_manager_id")),
            ("store", ("s_store_sk", "s_zip"))),
}
# the DPP query: store_sales (partitioned by date) probes a broadcast
# date_dim (partitioned by year); the reference marks the fact scan
DPP_QUERY = ("SELECT d_year, sum(ss_ext_sales_price) s FROM store_sales "
             "JOIN date_dim ON ss_sold_date_sk = d_date_sk WHERE d_moy = 11 "
             "GROUP BY d_year")
DPP_PLAN_OPS = ("ComputeExec",) + _MERGE + ("HashJoinExec", "ScanExec") \
    + _PBCAST


def _parquet_dims(G, rng, n: dict) -> dict:
    """The dimension tables of q3, q7 and q19 as numpy columns (strings as
    pool indices), built as tpcds_data builds them, at the row counts
    `n`; the pools ride along under '_pools'."""
    import datetime

    import numpy as np

    dsk0 = G._dsk(datetime.date(1900, 1, 2))
    days = np.datetime64("1900-01-02") + np.arange(n["date_dim"])
    ni = n["item"]
    n_ids = max(2, int(ni * 0.75))
    manufact_ids = np.array([128, 129, 350, 677, 738, 977]
                            + list(range(1, 1000, 7)))
    na, nc, ncd, npr = (n["customer_address"], n["customer"],
                        n["customer_demographics"], n["promotion"])
    idx = np.arange(ncd)
    return {
        "date_dim": {
            "d_date_sk": dsk0 + np.arange(n["date_dim"]),
            "d_year": days.astype("datetime64[Y]").astype(np.int64) + 1970,
            "d_moy": days.astype("datetime64[M]").astype(np.int64) % 12
            + 1},
        "item": {
            "i_item_sk": np.arange(1, ni + 1),
            "i_item_id": rng.permutation(n_ids)[np.arange(ni) % n_ids],
            "i_brand_id": rng.integers(1001001, 10016017, ni),
            "i_brand": rng.integers(0, len(G.BRANDS), ni),
            "i_manufact_id": manufact_ids[rng.integers(
                0, len(manufact_ids), ni)],
            "i_manufact": np.arange(ni) % 100,
            "i_manager_id": rng.integers(1, 101, ni)},
        "customer_address": {
            "ca_address_sk": np.arange(1, na + 1),
            "ca_zip": rng.integers(10000, 99999, na)},
        "customer": {
            "c_customer_sk": np.arange(1, nc + 1),
            "c_current_addr_sk": rng.integers(1, na + 1, nc)},
        "customer_demographics": {
            # the specification's cross product: gender x marital x
            # education x ...
            "cd_demo_sk": idx + 1, "cd_gender": idx % 2,
            "cd_marital_status": (idx // 2) % len(G.MARITAL),
            "cd_education_status": (idx // 10) % len(G.EDUCATION)},
        "promotion": {
            "p_promo_sk": np.arange(1, npr + 1),
            # datagen's pools: email N,N,N,Y; event N,N,Y (index 0 = 'N')
            "p_channel_email": (rng.integers(0, 4, npr) == 3).astype(int),
            "p_channel_event": (rng.integers(0, 3, npr) == 2).astype(int)},
        "store": {"s_store_sk": np.arange(1, n["store"] + 1),
                  "s_zip": 38000 + np.arange(n["store"])},
        "_pools": {
            "i_item_id": [f"AAAAAAAA{i:08d}" for i in range(n_ids)],
            "i_brand": list(G.BRANDS),
            "i_manufact": [f"manufact{i}" for i in range(100)],
            "cd_gender": ["M", "F"], "cd_marital_status": list(G.MARITAL),
            "cd_education_status": list(G.EDUCATION),
            "p_channel_email": ["N", "Y"], "p_channel_event": ["N", "Y"]},
        "_dsk0": dsk0,
    }


def _dim_table(pa, name: str, cols: dict, pools: dict):
    """A dimension as Arrow: int64 integers, strings from their pools (the
    zips as 5-digit strings)."""
    out = {}
    for k, v in cols.items():
        if k in pools:
            out[k] = pa.array(pools[k], pa.string()).take(pa.array(v))
        elif k in ("ca_zip", "s_zip"):
            out[k] = pa.array(v.astype(str).astype(object), pa.string())
        else:
            out[k] = pa.array(v.astype("int64"), pa.int64())
    return pa.table(out)


def _sales_chunk(G, rng, rows: int, first_ticket: int, n: dict) -> tuple:
    """`rows` store_sales lines in whole tickets of 1-20 lines (the last
    one cut at the chunk's end), as tpcds_data draws them: date, customer,
    demographics and store per ticket, item and promotion per line, 2%
    null keys (30% null promotions), datagen's prices in cents. Returns
    (columns, null masks, tickets)."""
    import datetime

    import numpy as np

    tk, n_tickets = _groups(rng, rows, 1, 20)
    lo = G._dsk(datetime.date(1998, 1, 2))
    hi = G._dsk(datetime.date(2002, 12, 30))
    ss = {"ss_sold_date_sk": rng.integers(lo, hi, n_tickets)[tk],
          "ss_item_sk": rng.integers(1, n["item"] + 1, rows),
          "ss_customer_sk": rng.integers(1, n["customer"] + 1,
                                         n_tickets)[tk],
          "ss_cdemo_sk": rng.integers(1, n["customer_demographics"] + 1,
                                      n_tickets)[tk],
          "ss_promo_sk": rng.integers(1, n["promotion"] + 1, rows),
          "ss_store_sk": rng.integers(1, n["store"] + 1, n_tickets)[tk]}
    prices = _line_prices(rng, rows)
    for k in ("quantity", "list_price", "sales_price", "coupon_amt",
              "ext_sales_price"):
        ss[f"ss_{k}"] = prices[k]
    nulls = {c: rng.random(rows) < (0.3 if c == "ss_promo_sk" else 0.02)
             for c in ("ss_sold_date_sk", "ss_customer_sk", "ss_cdemo_sk",
                       "ss_promo_sk", "ss_store_sk")}
    return ss, nulls, tk + first_ticket


_PARQUET_MONEY = ("ss_list_price", "ss_sales_price", "ss_coupon_amt",
                  "ss_ext_sales_price")


def _sales_table(pa, ss: dict, nulls: dict):
    import numpy as np

    cols = {}
    for k, v in ss.items():
        if k in _PARQUET_MONEY:
            cols[k] = _decimal_column(pa, v.astype(np.int64))
        else:
            cols[k] = pa.array(v.astype(np.int64), pa.int64(),
                               mask=nulls.get(k))
    return pa.table(cols)


def _parquet_partials(ss: dict, nulls: dict, dims: dict) -> dict:
    """The group partials of q3, q7 and q19 over one chunk of store_sales
    (tpcds_oracle's selections; sums and counts are additive): query ->
    (key rows [m, k], sums [m, v], counts [m])."""
    import numpy as np

    dd, it, cd = dims["date_dim"], dims["item"], dims["customer_demographics"]
    promo, pools = dims["promotion"], dims["_pools"]
    d_idx = ss["ss_sold_date_sk"] - dims["_dsk0"]
    year, moy = dd["d_year"][d_idx], dd["d_moy"][d_idx]
    item = ss["ss_item_sk"] - 1
    out = {}

    def part(q, sel, keys, values):
        uniq, sums, cnt = _group_sum([k[sel] for k in keys],
                                     [v[sel] for v in values])
        out[q] = (uniq, np.stack(sums, axis=1), cnt)

    part("q3", ~nulls["ss_sold_date_sk"] & (moy == 11)
         & (it["i_manufact_id"][item] == 128),
         [year, it["i_brand"][item], it["i_brand_id"][item]],
         [ss["ss_ext_sales_price"]])
    c = ss["ss_cdemo_sk"] - 1
    p = ss["ss_promo_sk"] - 1
    part("q7", ~nulls["ss_sold_date_sk"] & ~nulls["ss_cdemo_sk"]
         & ~nulls["ss_promo_sk"] & (year == 2000) & (cd["cd_gender"][c] == 0)
         & (cd["cd_marital_status"][c] == pools["cd_marital_status"]
            .index("S"))
         & (cd["cd_education_status"][c] == pools["cd_education_status"]
            .index("College"))
         & ((promo["p_channel_email"][p] == 0)
            | (promo["p_channel_event"][p] == 0)),
         [it["i_item_id"][item]],
         [ss[k] for k in ("ss_quantity", "ss_list_price", "ss_coupon_amt",
                          "ss_sales_price")])
    addr = dims["customer"]["c_current_addr_sk"][ss["ss_customer_sk"] - 1]
    zip_ca = dims["customer_address"]["ca_zip"][addr - 1]
    zip_s = dims["store"]["s_zip"][ss["ss_store_sk"] - 1]
    part("q19", ~nulls["ss_sold_date_sk"] & ~nulls["ss_customer_sk"]
         & ~nulls["ss_store_sk"] & (it["i_manager_id"][item] == 8)
         & (moy == 11) & (year == 1998) & (zip_ca != zip_s),
         [it["i_brand"][item], it["i_brand_id"][item],
          it["i_manufact_id"][item], it["i_manufact"][item]],
         [ss["ss_ext_sales_price"]])
    return out


def _merge_partials(parts: list) -> tuple:
    """Partials of several chunks -> one (key rows, sums, counts)."""
    import numpy as np

    keys = np.concatenate([k for k, _, _ in parts])
    sums = np.concatenate([s for _, s, _ in parts])
    cnts = np.concatenate([c for _, _, c in parts])
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    tot = np.zeros((len(uniq), sums.shape[1]), np.int64)
    np.add.at(tot, inv, sums)
    return uniq, tot, np.bincount(inv, weights=cnts,
                                  minlength=len(uniq)).astype(np.int64)


def _parquet_oracle_rows(q: str, merged: tuple, pools: dict) -> list:
    """The full result of q (no LIMIT) as tpcds_rows shapes it."""
    import numpy as np

    keys, sums, cnt = merged
    if q == "q3":
        return [[int(y), int(bid), pools["i_brand"][b], int(s[0])]
                for (y, b, bid), s in zip(keys, sums)]
    if q == "q7":
        # avg(int) = sum / count in float64; avg(decimal(7,2)) =
        # cast(sum / 10^2 / count as decimal(11,6)), rounding half to even
        n = cnt.astype(np.float64)
        agg1 = sums[:, 0].astype(np.float64) / n
        decs = [np.rint(sums[:, i].astype(np.float64) / 100.0 / n * 1e6)
                .astype(np.int64) for i in (1, 2, 3)]
        return [[pools["i_item_id"][k[0]], float(agg1[i]),
                 int(decs[0][i]), int(decs[1][i]), int(decs[2][i])]
                for i, k in enumerate(keys)]
    return [[int(bid), pools["i_brand"][b], int(mid),
             pools["i_manufact"][m], int(s[0])]
            for (b, bid, mid, m), s in zip(keys, sums)]


PARQUET_ORACLE_KEYS = {"q3": lambda r: (r[0], -r[3], r[1]),
                       "q7": lambda r: r[0],
                       "q19": lambda r: (-r[4], r[1], r[0], r[2], r[3])}


def tpcds_parquet(out_dir: str, scale: float = 1.0, seed: int = PARQUET_SEED,
                  chunk: int = PARQUET_CHUNK,
                  row_group: int = PARQUET_ROW_GROUP,
                  dpp_rows: int = DPP_ROWS) -> dict:
    """Write the parquet leg's files under `out_dir` and return its oracle
    (also written to out_dir/oracle.json):
      <table>/       the 8 tables of q3, q7 and q19 at PARQUET_ROWS (the
                     facts, item, customer and customer_address times
                     `scale`), only the columns the queries read; int64
                     integers, decimal(7,2) money, strings from datagen's
                     pools; store_sales one file per `chunk` lines of
                     whole tickets, every file in row groups of
                     `row_group` rows; numpy seed `seed`, one generator
                     per store_sales chunk;
      dpp/store_sales/         `dpp_rows` lines (ss_sold_date_sk,
                     ss_ext_sales_price) partitioned by ss_sold_date_sk
                     with pyarrow.dataset's hive flavour: 1,823 dates from
                     1998-01-02 to 2002-12-29 and a null partition;
      dpp/store_sales_sorted/  the same lines in one file sorted by
                     ss_sold_date_sk (nulls last), row groups of
                     `row_group` rows.
    The oracle holds q3's, q7's and q19's full results, accumulated chunk
    by chunk from their group partials, and the DPP query's, the rows each
    pruning check must read and the split counts."""
    import datetime
    import shutil

    import numpy as np
    import pyarrow as pa
    import pyarrow.dataset as ds
    import pyarrow.parquet as pq

    G = tpcds_datagen()
    n = dict(PARQUET_ROWS)
    for k in ("store_sales", "item", "customer", "customer_address"):
        n[k] = max(1, int(n[k] * scale))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    rng = np.random.default_rng(seed)
    dims = _parquet_dims(G, rng, n)
    pools = dims["_pools"]
    for name, cols in dims.items():
        if name.startswith("_"):
            continue
        os.makedirs(os.path.join(out_dir, name))
        pq.write_table(_dim_table(pa, name, cols, pools),
                       os.path.join(out_dir, name, "part-00000.parquet"),
                       row_group_size=row_group)
    os.makedirs(os.path.join(out_dir, "store_sales"))
    partials = {q: [] for q in PARQUET_QUERIES}
    first_ticket, files = 1, 0
    for lo in range(0, n["store_sales"], chunk):
        rows = min(chunk, n["store_sales"] - lo)
        crng = np.random.default_rng([seed, files])
        ss, nulls, tk = _sales_chunk(G, crng, rows, first_ticket, n)
        first_ticket = int(tk[-1]) + 1
        pq.write_table(_sales_table(pa, ss, nulls),
                       os.path.join(out_dir, "store_sales",
                                    f"part-{files:05d}.parquet"),
                       row_group_size=row_group)
        for q, part in _parquet_partials(ss, nulls, dims).items():
            partials[q].append(part)
        files += 1
    oracle = {q: _parquet_oracle_rows(q, _merge_partials(partials[q]), pools)
              for q in PARQUET_QUERIES}
    # the date_dim rows each query reads: its year and month predicates
    # prune the row groups whose ranges rule them out (the other tables'
    # predicates rule out no row group, and are read whole)
    dd = dims["date_dim"]
    want = {"q3": (None, 11), "q7": (2000, None), "q19": (1998, 11)}
    oracle["date_dim_read"] = {}
    for q, (year, moy) in want.items():
        rows = 0
        for lo in range(0, n["date_dim"], row_group):
            y = dd["d_year"][lo:lo + row_group]
            m = dd["d_moy"][lo:lo + row_group]
            if (year is None or y.min() <= year <= y.max()) and \
                    (moy is None or m.min() <= moy <= m.max()):
                rows += len(y)
        oracle["date_dim_read"][q] = rows

    # DPP: SF10 store_sales' dates and prices, partitioned by date
    drng = np.random.default_rng([seed, 1 << 20])
    ss, nulls, _ = _sales_chunk(G, drng, dpp_rows, 1, n)
    date, price = ss["ss_sold_date_sk"], ss["ss_ext_sales_price"]
    dnull = nulls["ss_sold_date_sk"]
    order = np.lexsort((date, dnull))       # nulls last
    fact = pa.table({
        "ss_sold_date_sk": pa.array(date, pa.int64(), mask=dnull),
        "ss_ext_sales_price": _decimal_column(pa, price)}).take(
            pa.array(order))
    # sorted by date, each partition's rows arrive together: one file each
    ds.write_dataset(fact, os.path.join(out_dir, "dpp", "store_sales"),
                     format="parquet", partitioning=["ss_sold_date_sk"],
                     partitioning_flavor="hive", max_partitions=4096,
                     basename_template="part-{i}.parquet",
                     use_threads=False)
    pq.write_table(fact, os.path.join(out_dir, "dpp",
                                      "store_sales_sorted.parquet"),
                   row_group_size=row_group)
    dd = dims["date_dim"]
    d_idx = date - dims["_dsk0"]
    nov = ~dnull & (dd["d_moy"][d_idx] == 11)
    years, inv = np.unique(dd["d_year"][d_idx[nov]], return_inverse=True)
    dpp_sum = np.bincount(inv.reshape(-1), weights=price[nov])
    a = G._dsk(datetime.date(2000, 3, 1))
    b = G._dsk(datetime.date(2000, 3, 31))
    rg_key = G._dsk(datetime.date(2002, 12, 1))
    sorted_keys = np.where(dnull, np.iinfo(np.int64).min, date)[order]
    rg_rows = 0
    for start in range(0, dpp_rows, row_group):
        block = sorted_keys[start:start + row_group]
        live = block[block != np.iinfo(np.int64).min]
        # a row group of nulls alone has no min/max: the reader keeps it
        if not len(live) or live.max() >= rg_key:
            rg_rows += len(block)
    oracle.update({
        "dpp": [[int(y), int(s)] for y, s in zip(years, dpp_sum)],
        "dpp_rows": int(nov.sum()),
        "dpp_dates": int(len(np.unique(date[~dnull]))),
        "dpp_november_dates": int(len(np.unique(date[nov]))),
        "dpp_null_rows": int(dnull.sum()),
        "between": [a, b], "between_rows": int(
            (~dnull & (date >= a) & (date <= b)).sum()),
        "rowgroup_key": rg_key, "rowgroup_rows": rg_rows,
        "rowgroup_match": int((~dnull & (date >= rg_key)).sum()),
        "dpp_total_rows": dpp_rows, "rows": n,
        "store_sales_files": files})
    with open(os.path.join(out_dir, "oracle.json"), "w") as f:
        json.dump(oracle, f)
    return oracle


PARQUET_LOG = os.path.join(ROOT, "build", "tpcds_parquet.log")


def start_tpcds_parquet() -> subprocess.Popen:
    """The parquet leg's files in a process of their own (this script with
    `--tpcds-parquet`), started with the script so that its writing
    overlaps the card's earlier legs; fails first when the disk under
    build/ has less than PARQUET_DISK_GB free."""
    import shutil

    os.makedirs(os.path.dirname(PARQUET_DIR), exist_ok=True)
    free = shutil.disk_usage(os.path.dirname(PARQUET_DIR)).free
    print(f"parquet leg: {free / 1e9:.1f} GB free under build/", flush=True)
    if free < PARQUET_DISK_GB * 1e9:
        fail(f"the parquet leg needs {PARQUET_DISK_GB} GB free under build/"
             f", and {free / 1e9:.1f} GB are")
    with open(PARQUET_LOG, "w") as log:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tpcds-parquet"],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def tpcds_parquet_files() -> None:
    """`--tpcds-parquet`: tpcds_parquet(PARQUET_DIR) at PARQUET_ROWS,
    timed."""
    t0 = time.perf_counter()
    oracle = tpcds_parquet(PARQUET_DIR)
    du = sum(os.path.getsize(os.path.join(d, f))
             for d, _, fs in os.walk(PARQUET_DIR) for f in fs)
    print(json.dumps({"seconds": time.perf_counter() - t0,
                      "bytes_on_disk": du,
                      "store_sales_files": oracle["store_sales_files"]}),
          flush=True)


def parquet_calls(query: str, fact_tiles: int, dict_passes: int) -> int:
    """Histogram wrapper calls of q3, q7 and q19 over the Parquet views at
    PARQUET_ROWS, derived from PARQUET_PLAN_OPS as tpcds_calls is;
    `fact_tiles` is the store_sales scan's tile count (each split's rows
    in tiles of TILE), `dict_passes` the aggregate passes that took q7's
    dictionary-code path. Every dimension is one split of one tile. The
    hash exchanges count one call per input tile: date_dim's one tile,
    store_sales' `fact_tiles`, and the partial aggregate's P output tiles.
    In each of the P partitions the shuffled join's build (store_sales:
    dates repeat) tries the dense table once, and each broadcast
    dimension's dense build takes one `present`. The probe side (a
    date_dim partition) is one tile, so every join and the partial
    aggregate see one batch. Several grouping keys take the sorted-segment
    kernel (0). q7's single string key aggregates over its dictionary
    codes where the 153,000 item ids fit 4x the tile (the partial passes;
    a final pass only where its partition's tile is that large): one
    `present` plus one count per validity plane, the four prices' planes
    (they come through the shuffled join's build-side gather) or the four
    avg sums'."""
    p = PARTITIONS
    common = 1 + fact_tiles + p + p
    return {
        "q3": common + p * 1,
        "q7": common + p * 3 + dict_passes * (1 + 4),
        "q19": common + p * 4,
    }[query]


def _scan_tiles(scan) -> int:
    """Tiles of TILE rows a ParquetSource scan makes: per split, from the
    row groups' counts in the footers."""
    src = scan.source
    total = 0
    for fpath, lo, hi in src._splits:
        md = src._footer(fpath)
        total += tiles(sum(md.row_group(rg).num_rows
                           for rg in range(lo, hi)), TILE)
    return total


def _scans(df) -> dict:
    return {n.name: n for n in plan_nodes(df)
            if type(n).__name__ == "ScanExec"}


def parquet_leg(torch, sk, card: str, proc: subprocess.Popen,
                t_start: float) -> dict:
    """TPC-DS q3, q7 and q19 through session.sql over temp views of
    spark.read.parquet at PARQUET_ROWS, each plan held to
    PARQUET_PLAN_OPS and each scan to its columns, the splits and the rows
    each scan read printed and held, every result to the generator's numpy
    oracle (exact, ORDER BY + LIMIT by _check_topk), the histogram calls
    to parquet_calls; then the DPP query over the date-partitioned SF10
    store_sales (its date_dim written by the port's partitioned writer),
    with DPP on and off; a partition predicate and a row-group predicate;
    spark.range and SELECT without FROM. The files are deleted at the
    end. Returns the launch counts by query."""
    import gc
    import shutil

    import pyarrow.parquet as pq

    try:
        t0 = time.perf_counter()
        try:
            rc = proc.wait(timeout=max(1.0, 1100 - (time.perf_counter()
                                                    - t_start)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed at the script's 1100th second"
        with open(PARQUET_LOG) as f:
            log = f.read()
        if rc != 0:
            fail(f"the parquet generator ended with {rc}:\n{log[-2000:]}")
        print(f"parquet files after waiting {time.perf_counter() - t0:.1f}"
              f" s: {log.strip().splitlines()[-1]}", flush=True)
        with open(os.path.join(PARQUET_DIR, "oracle.json")) as f:
            oracle = json.load(f)
        gc.collect()
        torch.cuda.empty_cache()
        spark = session(PARQUET_CONF)
        for name in PARQUET_ROWS:
            spark.read.parquet(os.path.join(PARQUET_DIR, name)) \
                .createOrReplaceTempView(name)
        out, summary, timed_shapes = {}, {}, set()
        fact_rows = oracle["rows"]["store_sales"]
        for q in PARQUET_QUERIES:
            df = spark.sql(tpcds_text(q))
            # at `auto` (the footers give the leaf rows) a whole program
            # holds the stage plan inside
            ops = tuple(type(n).__name__ for n in plan_nodes(df))
            if ops != PARQUET_PLAN_OPS[q]:
                fail(f"parquet {q}: the operator sequence {ops} is not the "
                     f"reference's {PARQUET_PLAN_OPS[q]}")
            scans = _scans(df)
            cols = sorted((n, tuple(a.name for a in s.attrs))
                          for n, s in scans.items())
            if cols != sorted(PARQUET_SCAN_COLS[q]):
                fail(f"parquet {q}: the scans read {cols}, not "
                     f"{sorted(PARQUET_SCAN_COLS[q])}")
            splits = {n: s.output_partitioning().num_partitions
                      for n, s in scans.items()}
            fact_tiles = _scan_tiles(scans["store_sales"])
            rows, key = [tuple(r) for r in oracle[q]], PARQUET_ORACLE_KEYS[q]
            before = spark.metrics

            def check(result, q=q, rows=rows, key=key, before=before,
                      scans=scans, splits=splits):
                msg = _check_topk(f"parquet {q}", tpcds_rows(q, result),
                                  rows, key)
                m = spark.metrics
                read = {n: m.get(f"scan.{n}.rows", 0)
                        - before.get(f"scan.{n}.rows", 0) for n in scans}
                want = {n: oracle["rows"][n] for n in scans}
                want["date_dim"] = oracle["date_dim_read"][q]
                if read != want:
                    fail(f"parquet {q}: the scans read {read} rows, not "
                         f"{want}")
                return f"{msg}; rows read {read}, splits {splits}"

            def calls(q=q, fact_tiles=fact_tiles, before=before):
                passes = spark.metrics.get("agg.dict_code_fast_path", 0) - \
                    before.get("agg.dict_code_fast_path", 0)
                return parquet_calls(q, fact_tiles, passes)

            torch.cuda.reset_peak_memory_stats()
            # whole at `auto` with no stage run: the kernel's inputs on
            # this path come from an operator tier's run
            out[q] = drive(torch, sk, card, f"parquet {q}", df, fact_rows,
                           (), calls, check, None, timed_shapes,
                           warm_runs=1, record_operator=True)
            print(f"parquet {q} ingest split " + json.dumps(dict(
                ingest_split(torch, df.toArrow), card=card)), flush=True)
            print(f"parquet {q} done at {time.perf_counter() - t_start:.1f}"
                  " s", flush=True)
            summary[q] = {"splits": splits, "fact_tiles": fact_tiles,
                          "columns": dict(cols),
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        # DPP pinned to the stage tier: a whole program executes its probe
        # scan before any join could install the build side's keys, so it
        # prunes nothing (in the reference too)
        with tier_set(spark, "stage"):
            out.update(dpp_checks(torch, sk, card, spark, oracle,
                                  timed_shapes, summary))
        print(f"parquet dpp done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
        out.update(range_checks(torch, sk, card, spark, summary))
        spark.stop()
        print("parquet summary " + json.dumps(dict(summary, card=card)),
              flush=True)
        return out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(PARQUET_DIR, ignore_errors=True)


def ingest_split(torch, run) -> dict:
    """One more warm run of a file query with the scan's host work timed
    by wrappers, in host s summed over the calls: the files' read and
    decode to Arrow (`ParquetSource.read_partition`), each tile's ingest
    (`arrow.record_batch_to_columnar`: Arrow to numpy, the padded plane,
    the harvest, the copy to the card), and inside the ingest the harvest:
    the RunInfo (`arrow.harvest_runs`) and the live range that seeds the
    dense-range memo (`arrow._live_range`)."""
    import spark_tpu_torch.columnar.arrow as A
    from spark_tpu_torch.io.sources import ParquetSource

    spent = dict.fromkeys(("read_s", "ingest_s", "runs_s", "range_s"), 0.0)
    targets = {"read_s": (ParquetSource, "read_partition"),
               "ingest_s": (A, "record_batch_to_columnar"),
               "runs_s": (A, "harvest_runs"), "range_s": (A, "_live_range")}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        return wrapper

    saved = {key: getattr(*target) for key, target in targets.items()}
    for key, (owner, name) in targets.items():
        setattr(owner, name, timed(key, saved[key]))
    try:
        _, wall = _timed_once(torch, run)
    finally:
        for key, (owner, name) in targets.items():
            setattr(owner, name, saved[key])
    harvest = spent["runs_s"] + spent["range_s"]
    return dict(spent, wall_s=wall, harvest_s=harvest,
                harvest_share_of_ingest=harvest / spent["ingest_s"]
                if spent["ingest_s"] else None,
                harvest_share_of_wall=harvest / wall)


def _timed_once(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def dpp_checks(torch, sk, card: str, spark, oracle: dict, timed_shapes,
               summary: dict) -> dict:
    """bench_join's shape (BASELINE config 3) from files: SF10 store_sales
    partitioned by date joined to date_dim (written here by the port's
    partitionBy("d_year") and read back equal), November's sales by year.
    DPP must prune every split outside the 150 November days (the null
    partition too) and read exactly November's rows; off, the same answer
    and no split pruned. A partition predicate and a row-group predicate
    must read exactly their rows."""
    import pyarrow.parquet as pq

    dd_dir = os.path.join(PARQUET_DIR, "dpp", "date_dim")
    src = os.path.join(PARQUET_DIR, "date_dim")
    (_, write_s) = _timed_once(torch, lambda: spark.read.parquet(src).write
                               .partitionBy("d_year").parquet(dd_dir))
    back = spark.read.parquet(dd_dir).toArrow()
    want = pq.read_table(src)
    if not back.select(want.column_names).sort_by("d_date_sk").equals(
            want.sort_by("d_date_sk")):
        fail("parquet dpp: date_dim does not read back equal")
    spark.read.parquet(os.path.join(PARQUET_DIR, "dpp", "store_sales")) \
        .createOrReplaceTempView("store_sales")
    spark.read.parquet(dd_dir).createOrReplaceTempView("date_dim")
    spark.read.parquet(os.path.join(PARQUET_DIR, "dpp",
                                    "store_sales_sorted.parquet")) \
        .createOrReplaceTempView("store_sales_sorted")
    df = spark.sql(DPP_QUERY)
    ops = tuple(type(n).__name__
                for n in df.query_execution.physical.iter_nodes())
    if ops != DPP_PLAN_OPS:
        fail(f"parquet dpp: the operator sequence {ops} is not the "
             f"reference's {DPP_PLAN_OPS}")
    marked = [n for n in df.query_execution.physical.iter_nodes()
              if type(n).__name__ == "HashJoinExec" and n.dpp_targets]
    if len(marked) != 1:
        fail("parquet dpp: the join does not prune the fact scan")
    splits = _scans(df)["store_sales"].output_partitioning().num_partitions
    if splits != oracle["dpp_dates"] + 1:
        fail(f"parquet dpp: {splits} splits, not one per date and the null "
             "partition")
    expect = sorted(tuple(r) for r in oracle["dpp"])

    def result(t):
        return sorted((r["d_year"], _dec(r["s"])) for r in t.to_pylist())

    before = spark.metrics

    def check(t):
        if result(t) != expect:
            fail(f"parquet dpp: {result(t)} is not {expect}")
        m = spark.metrics
        pruned = m.get("scan.dpp_pruned_splits", 0) - \
            before.get("scan.dpp_pruned_splits", 0)
        read = m.get("scan.store_sales.rows", 0) - \
            before.get("scan.store_sales.rows", 0)
        want_pruned = splits - oracle["dpp_november_dates"]
        if pruned != want_pruned or read != oracle["dpp_rows"]:
            fail(f"parquet dpp: {pruned} splits pruned and {read} rows read"
                 f", not {want_pruned} and {oracle['dpp_rows']}")
        return (f"equal to numpy; {pruned} of {splits} splits pruned, "
                f"{read:,} rows read")

    # the cold run only: a warm run and its breakdown took 25 s of the
    # script's 1,200 (its 1,824 partitions; without a profiler pass, whose
    # trace took 70 s to read, PERF.md section 5)
    total = oracle["dpp_total_rows"]
    out = {"dpp": drive(torch, sk, card, "parquet dpp", df, total,
                        (), None, check, None, timed_shapes, profile=False,
                        warm_runs=0)}
    checks = {"date_dim_write_s": write_s, "dpp_splits": splits}
    spark.conf.set("spark.sql.dynamicPartitionPruning.enabled", "false")
    before = spark.metrics
    t, secs = _timed_once(torch, lambda: spark.sql(DPP_QUERY).toArrow())
    spark.conf.set("spark.sql.dynamicPartitionPruning.enabled", "true")
    m = spark.metrics
    pruned = m.get("scan.dpp_pruned_splits", 0) - \
        before.get("scan.dpp_pruned_splits", 0)
    read = m.get("scan.store_sales.rows", 0) - \
        before.get("scan.store_sales.rows", 0)
    if result(t) != expect or pruned or read != total:
        fail(f"parquet dpp off: {pruned} pruned, {read} rows read")
    checks["dpp_off_s"] = secs
    a, b = oracle["between"]
    for label, text, name, rows, match in (
            ("between", f"SELECT count(*) c FROM store_sales WHERE "
             f"ss_sold_date_sk BETWEEN {a} AND {b}", "store_sales",
             oracle["between_rows"], oracle["between_rows"]),
            ("rowgroup", f"SELECT count(*) c FROM store_sales_sorted WHERE "
             f"ss_sold_date_sk >= {oracle['rowgroup_key']}",
             "store_sales_sorted.parquet", oracle["rowgroup_rows"],
             oracle["rowgroup_match"])):
        before = spark.metrics
        t, secs = _timed_once(torch, lambda: spark.sql(text).toArrow())
        read = spark.metrics.get(f"scan.{name}.rows", 0) - \
            before.get(f"scan.{name}.rows", 0)
        if t.to_pylist() != [{"c": match}] or read != rows:
            fail(f"parquet {label}: {t.to_pylist()} and {read} rows read, "
                 f"not {match} and {rows}")
        checks[f"{label}_s"] = secs
        checks[f"{label}_rows_read"] = read
    print("parquet dpp checks " + json.dumps(dict(checks, card=card)),
          flush=True)
    summary["dpp"] = checks
    return out


RANGE_ROWS = 1 << 28


def range_checks(torch, sk, card: str, spark, summary: dict) -> dict:
    """spark.range at 2^28 rows and at a negative step, aggregated to sum,
    count, min and max, each equal to its closed form (no histogram call:
    ungrouped aggregates and a gather); SELECT without FROM, one row."""
    import spark_tpu_torch.api.functions as F

    def agg(df):
        return df.agg(F.sum("id").alias("s"), F.count("*").alias("n"),
                      F.min("id").alias("lo"), F.max("id").alias("hi"))

    out = {}
    for label, (start, end, step) in (
            ("range", (0, RANGE_ROWS, 1)),
            ("range_down", (10, -(1 << 26), -3))):
        n = len(range(start, end, step))
        last = start + (n - 1) * step
        want = [{"s": n * (start + last) // 2, "n": n,
                 "lo": min(start, last), "hi": max(start, last)}]
        df = agg(spark.range(start, end, step, 8))

        def check(t, want=want, label=label):
            if t.to_pylist() != want:
                fail(f"parquet {label}: {t.to_pylist()} is not {want}")
            return f"equal to the closed form {want}"

        out[label] = drive(torch, sk, card, f"parquet {label}", df, n,
                           ("Range(",), 0, check)
    t = spark.sql("SELECT 1 + 1 AS two, 'x' AS s").toArrow()
    if t.to_pylist() != [{"two": 2, "s": "x"}]:
        fail(f"parquet one-row: {t.to_pylist()}")
    print("parquet one-row: SELECT 1 + 1 AS two, 'x' AS s -> "
          f"{t.to_pylist()}", flush=True)
    return out


def _operator_times(torch, df, nodes) -> dict:
    """One run with each operator's execute timed (inclusive, then made
    exclusive by its children's)."""
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
    return {"wall_s": total, "operators": ops,
            "collect_s": total - incl.get(0, 0.0)}


def breakdown(torch, df, profile: bool = True) -> dict:
    """Where one warm run's time goes: each operator's exclusive wall time
    (synchronized before and after every execute, so device work lands on
    the operator that queued it), then, where `profile`, a torch.profiler
    pass for the device-busy share and the heaviest device kernels."""
    nodes = list(df.query_execution.physical.iter_nodes())
    if len(nodes) == 1 and profile:
        # one operator (a whole program): its wall is the profiled run's
        out = {"operators": [{"op": nodes[0].simple_string()[:70],
                              "exclusive_s": "profiled_wall_s"}]}
    else:
        out = _operator_times(torch, df, nodes)
    if not profile:
        return out

    from torch.profiler import ProfilerActivity, profile

    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        df.toArrow()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    # the profiler's own cost: closing the trace and reading its events
    out["profiler_read_s"] = time.perf_counter() - t_prof - wall
    busy_s = sum(k[0] for k in kernels) / 1e6
    out["profiled_wall_s"] = wall
    out["device_busy_s"] = busy_s if kernels else "not measured"
    out["device_idle_share"] = 1 - busy_s / wall if kernels \
        else "not measured"
    out["top_device_ops"] = [{"op": k[1][:60], "device_ms": k[0] / 1e3,
                              "calls": k[2]} for k in kernels[:12]]
    # shares of kernel time: copies (Memcpy, Memset) left out
    kernel_s = sum(k[0] for k in kernels
                   if not k[1].startswith(("Memcpy", "Memset"))) / 1e6
    out["device_kernel_s"] = kernel_s if kernels else "not measured"
    out["kernel_shares"] = {
        label: sum(k[0] for k in kernels
                   if any(f in k[1].lower() for f in frags)) / 1e6 / kernel_s
        for label, frags in KERNEL_SHARES.items()} if kernel_s \
        else "not measured"
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
    t_start = time.perf_counter()
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
    reports = cuda_build.build_all(list(sk.SOURCES))
    print(f"built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        print(f"--- nvcc {name} ---\n{text.strip()}", flush=True)

    def phase(name, fn, *args):
        out = fn(*args)
        print(f"phase {name} done at {time.perf_counter() - t0:.1f} s",
              flush=True)
        return out

    # the parquet leg's files and the SF10 CPU results take the longest:
    # their processes start first and run beside every leg (they see no
    # card)
    parquet_proc = start_tpcds_parquet()
    cpu_proc = start_tpcds_cpu()
    try:
        main_hist, main_sum = phase("kernels", check_kernels, torch, sk)
        main_bits = phase("bit_kernel", check_bit_kernel, torch, sk)
        main_bloom = phase("bloom_kernel", check_bloom_kernel, torch, sk)
        main_runs = phase("run_layout_kernel", check_run_layout, torch, sk,
                          card)
        k, v = main_table()
        main_tiers = phase("main", main_path, torch, sk, card, k, v)
        # the main query at `auto` runs as one whole program, which calls
        # neither kernel: the kernels line reports that run's counts, and
        # beside them its stage-tier run's in the same session, the path
        # through the kernels
        main_tier = next(iter(main_tiers))
        by_path = {"main": main_tiers[main_tier],
            "join": phase("join", join_leg, torch, sk, card),
            "sort": phase("sort", sort_leg, torch, sk, card),
            "range_sort": phase("range_sort", range_sort_leg, torch, sk,
                                card, k, v),
            "topk": phase("topk", topk_leg, torch, sk, card, k, v),
            "q78": phase("q78", q78_leg, torch, sk, card),
        }
        sorted_tiers, sorted_path = phase("sorted_runs", sorted_runs_leg,
                                          torch, sk, card)
        by_path["sorted_runs"] = sorted_tiers["operator"]
        by_path["window"] = phase("window", window_leg, torch, sk, card, k,
                                  v)
        # the budget leg runs at the end of the sort and q78 legs, on
        # their sessions and oracles
        for leg in ("sort", "q78"):
            by_path[leg], by_path[f"budget {leg}"] = by_path[leg]
        phase("tpcds_gate", tpcds_gate, torch)
        # the expressions, types and maintenance legs run at the end of
        # the tpcds leg, over its session and SF10 views
        tpcds_launches, tpcds_results, expr_launches, types_launches, \
            (agg_launches, agg_tiers), maint_launches = phase("tpcds", tpcds_leg, torch,
                                                 sk, card, cpu_proc)
        by_path.update({f"tpcds {q}": n for q, n in tpcds_launches.items()})
        by_path.update({f"expressions {q}": n
                        for q, n in expr_launches.items()})
        by_path.update({f"types {q}": n for q, n in types_launches.items()})
        by_path.update({f"aggregates {q} {tier}": n
                        for (q, tier), n in agg_launches.items()})
        by_path.update({f"maintenance {q}": n
                        for q, n in maint_launches.items()})
        parquet_launches = phase("parquet", parquet_leg, torch, sk, card,
                                 parquet_proc, t_start)
        by_path.update({f"parquet {q}": n
                        for q, n in parquet_launches.items()})
        phase("tpcds_cpu", tpcds_cpu_check, cpu_proc, tpcds_results,
              t_start)
    finally:
        for proc in (cpu_proc, parquet_proc):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        import shutil

        shutil.rmtree(PARQUET_DIR, ignore_errors=True)

    def entry(name, row, replaces, source="scatter_kernels.cu",
              at_auto=None, at_stage=None, path="main", tier_at_auto=None):
        return {"name": name, "route": "cuda",
                "source": f"spark_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": main_tiers[main_tier][name] if at_auto is None
                else at_auto,
                "path": path,
                "main_path_tier_at_auto": tier_at_auto or main_tier,
                "launches_at_stage": main_tiers["stage"][name]
                if at_stage is None else at_stage,
                "launches_by_path": {p: n.get(name, 0)
                                     for p, n in by_path.items()},
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "device_ms": row["device_ms"], "call_ms": row["call_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": "bytes", "library_ms": row["library_ms"],
                "shape": row["shape"]}

    # the bit kernel's path is this slice's: the aggregates leg's bits
    # statements, each counted from 0 at `auto`, at stage and at whole
    bits_at = {tier: sum(agg_launches[(q, tier)]["segment_bits"]
                         for q in AGG_BITS)
               for tier in ("auto", "stage", "whole")}
    if not all(bits_at.values()):
        fail(f"the bits statements launched the bit kernel {bits_at}")
    bits_entry = entry(
        "segment_bits", main_bits,
        "spark_tpu/ops/grouping.py:159 bitplane_reduce (XLA-lowered)",
        "segment_bits.cu", bits_at["auto"], bits_at["stage"],
        "aggregates bits", ", ".join(sorted({agg_tiers[q]
                                             for q in AGG_BITS})))
    bits_entry["launches_at_whole"] = bits_at["whole"]
    bits_entry["library"] = BIT_LIBRARY
    # the bloom kernel's path is this slice's: the runtime_filters leg's
    # three statements at `stage`, each counted from 0
    bloom_entries = []
    for name in ("bloom_build", "bloom_probe"):
        n = sum(tpcds_launches[f"runtime_filters {q}"][name]
                for q in RF_QUERIES)
        e = entry(name, main_bloom[name],
                  "spark_tpu/physical/operators.py:1486-1570 "
                  "_bloom_filter_probe (XLA-lowered)", "bloom_filter.cu", n,
                  n, "runtime_filters", "stage (forced)")
        e["library"] = BLOOM_LIBRARY
        e["bound_note"] = main_bloom[name]["bound_note"]
        bloom_entries.append(e)
    # the run-layout kernel's path is this slice's: the sorted_runs leg's
    # partial aggregates at the operator tier (the sorted-run path lives
    # in the unfused aggregate, as the reference's does)
    run_entry = entry(
        "run_layout", main_runs,
        "spark_tpu/ops/grouping.py:63 group_rows_presorted (XLA-lowered)",
        "run_layout.cu", sorted_tiers["operator"]["run_layout"],
        sorted_tiers["stage"]["run_layout"], "sorted_runs",
        "operator (forced: the unfused aggregate)")
    run_entry["launches_at_auto"] = sorted_tiers["auto"]["run_layout"]
    run_entry["library"] = RUN_LIBRARY
    run_entry["path_inputs"] = sorted_path
    snaps = [m.snapshot() for m in SESSION_METRICS]
    retries = sum(m.get("scheduler.stage_retries", 0) for m in snaps)
    if retries:
        fail(f"{retries} stage retries over the run's sessions")
    stages = sum(m.get("scheduler.stages_completed", 0) for m in snaps)
    print(f"stage retries over {len(snaps)} card sessions: 0; stages run: "
          f"{stages}", flush=True)
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [
        entry("partition_histogram", main_hist,
              "spark_tpu/ops/pallas_kernels.py:67"),
        entry("dense_group_sum_f32", main_sum,
              "spark_tpu/ops/pallas_kernels.py:128"),
        bits_entry,
        *bloom_entries,
        run_entry,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--tpcds-cpu"]:
        tpcds_cpu_results()
    elif sys.argv[1:] == ["--tpcds-parquet"]:
        tpcds_parquet_files()
    else:
        run()
