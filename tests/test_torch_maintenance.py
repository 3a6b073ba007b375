"""The maintenance leg of `chip_smoke.py` (TPC-DS data maintenance: the
LF_SS refresh set, DF_SS, LF_SS, the item MERGE and UPDATE) at TPC-DS
scale 0.1, over the tables of tests/test_torch_tpcds_store.py
(`gen_tpcds_full`). The statements of `chip_smoke.maintenance_statements`
run in order on a TpuSession and a TorchSession(device="cpu"), both at
the operator tier: after each one the view it changed holds the same rows
in both engines, as many as `chip_smoke.maintenance_oracle` (numpy) says.
The reference's DELETEs, whose IN subqueries rewrite into joins, return
the joined columns too and fail (ROADMAP.md C12): there the port's table
is held to numpy row for row and handed to the reference. After the
changes, q3, q7 and q19 and the leg's checks (count, sum, dropDuplicates,
describe, na.fill) are equal in both engines and to numpy. Then the port
runs the same statements at the stage tier and at forced `whole`, under a
dispatch mode that fails on a host read inside a fused body and with each
program's first body replayed for its later batches, and each view equals
the port's operator tier's."""

import math

import numpy as np
import pyarrow as pa
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import chip_smoke  # noqa: E402
import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as TF  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from tests.test_torch_cuda import tpcds_query  # noqa: E402
from tests.test_torch_fusion import (  # noqa: E402,F401
    one_torch_thread, replay_first, watch_syncs,
)
from tests.test_torch_tpcds_slice import CONF, JAX_CONF  # noqa: E402

STAGE = {"spark.tpu.compile.tier": "stage", "spark.tpu.fusion.minRows": 0}
WHOLE = {"spark.tpu.compile.tier": "whole",
         "spark.tpu.compile.whole.minRows": 0}
# the DELETEs the reference cannot run (ROADMAP.md C12)
REFERENCE_FAULT = ("delete_returns", "delete_sales")


@pytest.fixture(scope="module")
def data():
    from tests.tpcds.datagen import gen_tpcds_full

    tables = gen_tpcds_full(scale=0.1)
    return tables, chip_smoke.maintenance_oracle(tables)


def _session(engine: str, tables: dict, extra=None):
    if engine == "jax":
        s = TpuSession("maintenance-reference", dict(JAX_CONF))
    else:
        s = TorchSession("maintenance", dict(CONF, **(extra or {})),
                         device="cpu")
    for name, tb in tables.items():
        s.createDataFrame(tb).createOrReplaceTempView(name)
    return s


def view(s, name: str) -> list:
    """The rows of a view, sorted by every column (nulls first)."""
    rows = s.sql(f"SELECT * FROM {name}").toArrow().to_pylist()
    return sorted(rows, key=lambda r: [(v is not None, v)
                                       for v in r.values()])


def _delete_oracle(tables: dict, name: str) -> list:
    """The view a DF_SS DELETE leaves, from numpy over the unchanged
    tables, sorted as `view` sorts: the sales of the delete window go,
    then the returns whose ticket was sold in it."""
    dsk, _ = chip_smoke._np_col(tables["date_dim"], "d_date_sk")
    dday, _ = chip_smoke._np_col(tables["date_dim"], "d_date")
    lo, hi = (np.datetime64(d).astype("datetime64[D]").astype(np.int64)
              for d in chip_smoke.MAINT_DELETE_DAYS)
    ss = tables["store_sales"]
    date, date_ok = chip_smoke._np_col(ss, "ss_sold_date_sk")
    ticket, ticket_ok = chip_smoke._np_col(ss, "ss_ticket_number")
    sold = date_ok & np.isin(date, dsk[(dday >= lo) & (dday <= hi)])
    if name == "delete_sales":
        table, keep = ss, ~sold
    else:
        table = tables["store_returns"]
        t, ok = chip_smoke._np_col(table, "sr_ticket_number")
        keep = ~(ok & np.isin(t, ticket[sold & ticket_ok]))
    rows = table.filter(pa.array(keep)).to_pylist()
    return sorted(rows, key=lambda r: [(v is not None, v)
                                       for v in r.values()])


def checks(s, F) -> dict:
    """The leg's queries after the changes: q3, q7 and q19, and
    `maintenance_checks`' values."""
    out = {q: s.sql(tpcds_query(q)).toArrow().to_pylist()
           for q in chip_smoke.MAINT_QUERIES}
    out["count"] = s.sql("SELECT count(*) AS n, sum(ss_net_paid) AS s "
                         "FROM store_sales").toArrow().to_pylist()
    out["tickets"] = s.table("store_sales") \
        .dropDuplicates(["ss_ticket_number"]).count()
    out["describe"] = s.table("store_sales") \
        .describe("ss_quantity", "ss_net_paid").toArrow().to_pylist()
    out["fill"] = s.table("store_sales").na.fill(0, ["ss_promo_sk"]).agg(
        F.sum("ss_promo_sk").alias("s"), F.count("ss_promo_sk").alias("n")) \
        .toArrow().to_pylist()
    return out


def test_statements_match_reference_and_numpy(data):
    tables, want = data
    j, t = _session("jax", tables), _session("torch", tables)
    try:
        for name, text in chip_smoke.maintenance_statements(tables).items():
            target = chip_smoke.MAINT_TARGETS[name]
            t.sql(text)
            got = view(t, target)
            assert len(got) == want["rows"][name], name
            if name in REFERENCE_FAULT:
                with pytest.raises(pa.ArrowInvalid):
                    j.sql(text)
                assert got == _delete_oracle(tables, name)
                j.createDataFrame(t.table(target).toArrow()) \
                    .createOrReplaceTempView(target)
            else:
                j.sql(text)
            assert got == view(j, target), name
        got, ref = checks(t, TF), checks(j, JF)
        # the reference squares a decimal's scaled integers in its central
        # moments (ROADMAP.md section C): describe's stddev of ss_net_paid
        # is held to numpy instead
        sd = [r for r in got["describe"] if r["summary"] == "stddev"][0]
        exp = want["describe"]["ss_net_paid"]["stddev"] / 100
        assert math.isclose(float(sd["ss_net_paid"]), exp, rel_tol=1e-12)
        for rows in (got["describe"], ref["describe"]):
            for r in rows:
                if r["summary"] == "stddev":
                    r["ss_net_paid"] = None
        assert got == ref
        for col, exp in want["describe"].items():
            mean = float([r for r in got["describe"]
                          if r["summary"] == "mean"][0][col])
            scale = 100 if col == "ss_net_paid" else 1
            assert abs(mean * scale - exp["mean"]) <= 0.5e-6 * scale
        assert got["count"][0]["n"] == want["count"]
        assert int(got["count"][0]["s"].scaleb(2)) == want["sum_net_paid"]
        assert got["tickets"] == want["tickets"]
        assert got["fill"] == [{"s": want["fill_sum"],
                                "n": want["fill_count"]}]
    finally:
        j.stop()
        t.stop()


@pytest.mark.parametrize("tier", ["stage", "whole"])
def test_tiers_match_operator_tier(data, monkeypatch, tier):
    """The statements at the stage tier and at forced whole, no host read
    inside a fused body and each program's first body replayed, leave the
    views the operator tier leaves."""
    tables, want = data
    op = _session("torch", tables)
    fused = _session("torch", tables, STAGE if tier == "stage" else WHOLE)
    try:
        for name, text in chip_smoke.maintenance_statements(tables).items():
            op.sql(text)
        found = watch_syncs(monkeypatch)
        replay_first(monkeypatch)
        for name, text in chip_smoke.maintenance_statements(tables).items():
            fused.sql(text)
        assert not found, found
        for target in sorted(set(chip_smoke.MAINT_TARGETS.values())):
            assert view(fused, target) == view(op, target), target
        ran = fused.launches.snapshot()
        assert ran.get("whole_query" if tier == "whole" else "fused_agg"), \
            ran
        assert checks(fused, TF) == checks(op, TF)
    finally:
        op.stop()
        fused.stop()
