"""All 103 TPC-DS query files at the port's forced whole-query tier
(physical/whole_query.py) on the CPU:

  * over `tests/tpcds/datagen.py`'s scale-0.1 tables, each result (its
    trailing LIMIT dropped) equal to its committed golden under
    `tests/tpcds/oracle.py`'s comparison;
  * over the scale-0.01 tables, each result equal to the port's operator
    tier, with no whole body reading a device value on the host
    (`_SyncDetector`) and each program's first body run for all its later
    runs, as a graph replays (`replayed`); integers, strings and ordered
    output exactly, float sums to relative 1e-12.
The TPC-DS slice files hold the same tier to the reference's operator tier
at scale 0.1 (`check_whole`); tests/test_torch_tpcds_whole.py holds the
tier decisions to the reference's."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from spark_tpu_torch import TorchSession  # noqa: E402
from tests.test_torch_cuda import tpcds_query  # noqa: E402
from tests.test_torch_fusion import (  # noqa: E402,F401
    TPCDS_FILES, _same, one_torch_thread, replayed, sync_checked,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "tpcds", "expected")


@pytest.fixture(scope="module")
def whole():
    from tests.tpcds.datagen import gen_tpcds_full

    s = TorchSession("tpcds-whole-golden", {
        "spark.sql.shuffle.partitions": 4,
        "spark.tpu.batch.capacity": 1 << 10,
        "spark.tpu.compile.tier": "whole",
        "spark.tpu.fusion.minRows": 0}, device="cpu")
    for name, tb in gen_tpcds_full(scale=0.1).items():
        s.createDataFrame(tb).createOrReplaceTempView(name)
    yield s
    s.stop()


@pytest.mark.parametrize("name", TPCDS_FILES)
def test_whole_equals_golden(whole, name):
    from tests.test_tpcds_full import _norm_rows
    from tests.tpcds.oracle import compare_rows, strip_trailing_limit

    got = whole.sql(strip_trailing_limit(tpcds_query(name))).toArrow()
    golden = json.load(open(os.path.join(GOLDEN_DIR, f"{name}.json")))
    ok, msg = compare_rows(_norm_rows(got),
                           [tuple(r) for r in golden["rows"]])
    assert ok, msg


def test_all_files_run():
    assert len(TPCDS_FILES) == 103


@pytest.fixture(scope="module")
def tiers_001():
    """The port over the scale-0.01 tables at forced `whole` and at
    `operator`, minRows 0."""
    from tests.tpcds.datagen import gen_tpcds_full

    tables = gen_tpcds_full(scale=0.01)
    out = []
    for tier in ("whole", "operator"):
        s = TorchSession(f"tpcds-{tier}", {
            "spark.sql.shuffle.partitions": 4,
            "spark.tpu.batch.capacity": 1 << 10,
            "spark.tpu.compile.tier": tier,
            "spark.tpu.fusion.minRows": 0}, device="cpu")
        for name, tb in tables.items():
            s.createDataFrame(tb).createOrReplaceTempView(name)
        out.append(s)
    yield out
    for s in out:
        s.stop()


@pytest.mark.parametrize("name", TPCDS_FILES)
def test_whole_equals_operator_without_host_reads(tiers_001, sync_checked,
                                                  replayed, name):
    whole, oper = tiers_001
    text = tpcds_query(name)
    got = whole.sql(text).toArrow()
    assert not sync_checked, sync_checked[:5]
    _same(got, oper.sql(text).toArrow(),
          ordered="order by" in text.lower())
