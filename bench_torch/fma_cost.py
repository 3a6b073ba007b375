#!/usr/bin/env python3
"""Which queries evaluate a contracted double sum, and what it costs.

    python3 bench_torch/fma_cost.py --sites [--scale 0.01]
    python3 bench_torch/fma_cost.py contracted q3 ...  (needs the card)

The port rounds a double product that feeds a sum or a difference once,
as the reference's compiler contracts `a * b + c` into a fused
multiply-add (`expressions._contracted_sum`, `_fma`: Dekker's product and
a TwoSum, about 20 element-wise ops where the plain sum has 2).

`--sites` runs each TPC-DS query file and each of chip_smoke.py's
EXPRESSION_QUERIES on a TorchSession(device="cpu") at the operator tier
over chip_smoke.py's tables (`tpcds_data`, the same seeds, at `--scale`)
and prints one JSON line per statement that reaches a contracted sum: the
sums found in its optimised plan (subquery plans too) and the sums it
evaluated (CTE bodies too), each as its expression string. Needs no card.

With statement names (TPC-DS files, `expressions <name>`, or
`contracted`, a sum of contracted double sums over store_sales:
CONTRACTED), it builds the SF10 tables on the card as chip_smoke.py's
tpcds leg does and runs each named statement at `auto` and at the
operator tier, each four times over, contraction on, off, off, on (off:
`_contracted_sum` patched to give None, the plain `a * b + c` of the
port before the contraction), each a cold run (the stage cache cleared
first, since its graphs are keyed by the plan alone) and 3 warm runs, and prints
each round's warm median and the ratio of the on and off medians, beside
the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# double products feeding sums and differences over SF10 store_sales
CONTRACTED = (
    "SELECT sum(ss_sales_price / ss_quantity * ss_list_price - "
    "ss_net_profit / 7) a, sum(ss_wholesale_cost / 3 * ss_quantity + "
    "ss_coupon_amt / 9) b FROM store_sales")


def statements(cs) -> dict:
    out = {q: cs.tpcds_text(q) for q in cs.TPCDS_QUERIES}
    out["contracted"] = CONTRACTED
    out.update({f"expressions {n}": t
                for n, t in cs.EXPRESSION_QUERIES.items()})
    return out


def plan_sums(plan, E) -> set:
    """The contracted sums of an optimised plan and of the plans of its
    subquery expressions."""
    from spark_tpu_torch.plan.logical import LogicalPlan

    found, todo = set(), [plan]
    while todo:
        p = todo.pop()
        for node in p.iter_nodes():
            for e in node.expressions():
                for x in e.iter_nodes():
                    if contracted(x, E):
                        found.add(x.simple_string())
                    todo.extend(v for v in x.__dict__.values()
                                if isinstance(v, LogicalPlan))
    return found


def contracted(e, E) -> bool:
    """`_contracted_sum`'s condition: a double + or - with a double
    product on a side."""
    return (isinstance(e, (E.Add, E.Subtract)) and e.dtype == E.float64
            and any(isinstance(s, E.Multiply) and s.dtype == E.float64
                    for s in (e.left, e.right)))


def sites(scale: float) -> None:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import spark_tpu_torch.expr.expressions as E
    from spark_tpu_torch import TorchSession

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) - 2))
    tables, _ = cs.tpcds_data(scale=scale)
    cpu = TorchSession("fma_sites", dict(
        cs.TPCDS_CONF, **{cs.TIER: "operator"}), device="cpu")
    for name, table in tables.items():
        cpu.createDataFrame(table).createOrReplaceTempView(name)
    seen: set = set()
    plain = E._contracted_sum

    def watch(ctx, e, sign):
        out = plain(ctx, e, sign)
        if out is not None:
            seen.add(e.simple_string())
        return out

    E._contracted_sum = watch
    total = 0
    for name, text in statements(cs).items():
        if name in cs.TPCDS_SF10_CUT or name == "contracted":
            continue
        seen.clear()
        df = cpu.sql(text)
        planned = plan_sums(df.query_execution.optimized, E)
        df.toArrow()
        if planned or seen:
            total += 1
            print(json.dumps({"statement": name, "planned": sorted(planned),
                              "evaluated": sorted(seen)}), flush=True)
    print(json.dumps({"statements_with_contracted_sums": total,
                      "scale": scale}), flush=True)


def cost(names: list) -> None:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import spark_tpu_torch.expr.expressions as E
    from spark_tpu_torch.api.dataframe import DataFrame
    from spark_tpu_torch.physical.compile import STAGE_CACHE

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    texts = statements(cs)
    tables, _ = cs.tpcds_data()
    spark = cs.session(cs.TPCDS_CONF)
    for name, table in tables.items():
        spark.createDataFrame(table).createOrReplaceTempView(name)
    del tables
    plain = E._contracted_sum

    def run(text):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        DataFrame(spark, spark.sql(text).plan).toArrow()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name in names:
        for tier in ("auto", "operator"):
            rounds = []
            for on in (True, False, False, True):
                E._contracted_sum = plain if on else (
                    lambda ctx, e, sign: None)
                # the graphs are keyed by the plan alone: capture anew
                STAGE_CACHE.clear()
                try:
                    with cs.tier_set(spark, tier):
                        cold = run(texts[name])
                        warm = [run(texts[name]) for _ in range(3)]
                finally:
                    E._contracted_sum = plain
                rounds.append({"contracted": on, "cold_s": cold,
                               "warm_s": warm,
                               "warm_median_s": statistics.median(warm)})
            on = [r["warm_median_s"] for r in rounds if r["contracted"]]
            off = [r["warm_median_s"] for r in rounds if not r["contracted"]]
            print(json.dumps({"statement": name, "tier": tier,
                              "rounds": rounds,
                              "on_over_off": statistics.median(on)
                              / statistics.median(off), "card": card}),
                  flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--sites"]:
        sites(float(args[args.index("--scale") + 1])
              if "--scale" in args else 0.01)
    else:
        cost(args)
