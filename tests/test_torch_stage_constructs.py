"""The SQL and window construct statements (`SQL_CONSTRUCTS` and
`WINDOW_CONSTRUCTS` of tests/test_torch_cuda.py) at the port's fused
tiers, held to the JAX reference's result (operator tier, fusion off) over
the same seeded views: the stage tier (spark.tpu.fusion.minRows 0, every
fused program's first body run for all its later batches, as a graph
replays: the `replayed` fixture) and the forced whole tier, each at tiles
of 1,024 and of 128 rows. The earlier construct files hold the operator
tier; this one holds the default tiers. Results compare exactly (the
doubles are eighths, whose sums are exact in any order)."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from tests.test_torch_cuda import LEADS, RANKED, SQL_CONSTRUCTS  # noqa: E402
from tests.test_torch_cuda import WINDOW_CONSTRUCTS  # noqa: E402
from tests.test_torch_cuda import construct_rows, construct_tables  # noqa: E402,E501
from tests.test_torch_cuda import minmax_oracle, shift_oracle  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401
from tests.test_torch_fusion import replayed  # noqa: E402,F401

CASES = dict(SQL_CONSTRUCTS, **WINDOW_CONSTRUCTS)
BASE = {"spark.sql.shuffle.partitions": 4,
        "spark.sql.autoBroadcastJoinThreshold": 1024}


@pytest.fixture(scope="module")
def engines():
    """The reference at the operator tier, and the port at the stage and
    whole tiers at each tile size; the reference's results kept."""
    tables = construct_tables()
    j = TpuSession("constructs-reference", dict(
        BASE, **{"spark.tpu.batch.capacity": 1 << 10,
                 "spark.tpu.fusion.enabled": "false",
                 "spark.tpu.compile.tier": "operator"}))
    ports = {}
    for tier in ("stage", "whole"):
        for cap in (1 << 10, 128):
            ports[(tier, cap)] = TorchSession(f"constructs-{tier}", dict(
                BASE, **{"spark.tpu.batch.capacity": cap,
                         "spark.tpu.compile.tier": tier,
                         "spark.tpu.fusion.minRows": 0}), device="cpu")
    for s in (j, *ports.values()):
        for name, tb in tables.items():
            s.createDataFrame(tb).createOrReplaceTempView(name)
    want: dict = {}
    yield j, ports, want
    for s in (j, *ports.values()):
        s.stop()


@pytest.mark.parametrize("cap", [1 << 10, 128])
@pytest.mark.parametrize("tier", ["stage", "whole"])
@pytest.mark.parametrize("name", list(CASES))
def test_construct_at_fused_tier_matches_reference(engines, replayed, name,
                                                   tier, cap):
    j, ports, want = engines
    text, ordered = CASES[name]
    if name not in want:
        want[name] = j.sql(text).toArrow()
    got = ports[(tier, cap)].sql(text).toArrow()
    assert got.schema == want[name].schema
    # a lead column is held to Spark's semantics, not to the reference's
    # (which computes lag there, ROADMAP.md C18), and a string min/max to
    # the plain oracle (the reference reduces codes there, C19)
    leads = LEADS.get(name, {})
    ranked = RANKED.get(name, {})
    keep = [c for c in got.column_names if c not in leads and c not in ranked]
    assert construct_rows(got.select(keep), ordered) == \
        construct_rows(want[name].select(keep), ordered)
    rows = construct_tables()["t3"].to_pylist()
    by_k = {col: dict(zip(got.column("k").to_pylist(),
                          got.column(col).to_pylist()))
            for col in (*leads, *ranked)}
    for col, (arg, off) in leads.items():
        assert by_k[col] == shift_oracle(rows, "g", [("k", False)], arg, off)
    for col, (fn, frame) in ranked.items():
        assert by_k[col] == minmax_oracle(rows, "g", fn, frame)
