"""A1's value types in spark_tpu_torch against the JAX package: timestamps
(int64 microseconds, no time zone) and intervals, and binary columns.

Each statement runs over one numpy-seeded table (timestamps from 1900 to
2100, before 1970 to the microsecond, about 10% NULL; dates; binary blobs
with NULLs and empty values) in the reference at its operator tier and in
the port at its operator tier (held to the reference), at the stage tier
(every fused body watched for host reads and replayed for its key's later
batches, as a captured graph replays) and at the forced whole tier (both
held to the port's operator tier). Arrow round trips cover every
timestamp unit and zone. Where the reference is wrong (ROADMAP.md C14: a
TIMESTAMP literal through a float of seconds; a binary key, whose
dictionary the reference cannot hash), the port is held to a plain Python
oracle instead."""

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import NotPortedError, TorchSession  # noqa: E402
from spark_tpu_torch import types as T  # noqa: E402
from tests.test_torch_fusion import (  # noqa: E402,F401
    one_torch_thread, replay_first, watch_syncs,
)

N = 1200
CAP = 512
BASE = {"spark.sql.shuffle.partitions": 3, "spark.tpu.batch.capacity": CAP}
TIERS = {
    "operator": {"spark.tpu.compile.tier": "operator"},
    "stage": {"spark.tpu.compile.tier": "stage",
              "spark.tpu.fusion.minRows": 0},
    "whole": {"spark.tpu.compile.tier": "whole",
              "spark.tpu.compile.whole.minRows": 0,
              "spark.tpu.fusion.minRows": 0},
}
EPOCH = datetime.datetime(1970, 1, 1)
US = datetime.timedelta(microseconds=1)


def table() -> pa.Table:
    rng = np.random.default_rng(21)
    lo = int((np.datetime64("1900-01-01") - np.datetime64("1970-01-01"))
             .astype("timedelta64[us]").astype(np.int64))
    hi = int((np.datetime64("2100-12-31") - np.datetime64("1970-01-01"))
             .astype("timedelta64[us]").astype(np.int64))
    ts = rng.integers(lo, hi, N)
    ts[:8] = [-1, 0, 1, -86_400_000_000, -3_600_000_001, 59_999_999,
              -60_000_001, 86_399_999_999]
    # a few instants inside one day, so a group has several rows
    ts[8:40] = 1_000_000_000_000 + rng.integers(0, 86_400_000_000, 32)
    days = (ts // 86_400_000_000 + rng.integers(-3, 4, N)).astype(np.int32)
    blobs = [b"", b"\x00", b"ab", b"\xff\xfe", b"abc", None]
    return pa.table({
        "id": np.arange(N, dtype=np.int64),
        "g": (np.arange(N) % 4).astype(np.int64),
        "ts": pa.array(ts.astype("datetime64[us]"), pa.timestamp("us"),
                       mask=rng.random(N) < 0.1),
        "d": pa.array(days.astype("datetime64[D]"), pa.date32(),
                      mask=rng.random(N) < 0.1),
        "secs": pa.array(rng.integers(-2_000_000_000, 4_000_000_000, N),
                         mask=rng.random(N) < 0.1),
        "s": [f"20{rng.integers(0, 3)}{rng.integers(0, 10)}-0"
              f"{rng.integers(1, 10)}-1{rng.integers(0, 10)} "
              f"0{rng.integers(0, 10)}:1{rng.integers(0, 10)}:00"
              for _ in range(N)],
        "bin": pa.array([blobs[i] for i in rng.integers(0, len(blobs), N)],
                        pa.binary()),
    })


# name -> SQL over view tt; each held to the reference
CASES = {
    "select_ts": "SELECT id, ts FROM tt",
    "hour": "SELECT id, hour(ts) h, minute(ts) m, second(ts) s FROM tt",
    "unix": "SELECT id, unix_timestamp(ts) u, from_unixtime(secs) f FROM tt",
    "casts": "SELECT id, CAST(ts AS DATE) d1, CAST(d AS TIMESTAMP) t1, "
             "CAST(ts AS BIGINT) b, CAST(s AS TIMESTAMP) p, "
             "to_timestamp(s) q FROM tt",
    "intervals": "SELECT id, ts + INTERVAL 90 MINUTES a, "
                 "ts - INTERVAL '2' DAY b, ts + INTERVAL 1 DAY 3 HOURS c, "
                 "ts + make_dt_interval(1, 2, 3, 4.5) e FROM tt",
    "compare": "SELECT id, ts < TIMESTAMP '1969-12-31 23:59:59' a, "
               "ts >= d b, ts BETWEEN TIMESTAMP '1950-01-01' AND "
               "TIMESTAMP '2000-06-30 12:00:00' c FROM tt",
    "filter": "SELECT id FROM tt WHERE ts > TIMESTAMP '2000-01-01 00:00:00'",
    "minmax": "SELECT g, min(ts) lo, max(ts) hi, count(ts) n FROM tt "
              "GROUP BY g",
    "group_hour": "SELECT hour(ts) h, count(*) n, sum(id) si FROM tt "
                  "GROUP BY hour(ts)",
    "group_ts": "SELECT ts, count(*) n FROM tt GROUP BY ts",
    "order": "SELECT id, ts FROM tt ORDER BY ts DESC, id LIMIT 50",
    "date_parts": "SELECT id, year(ts) y, month(ts) mo, dayofweek(ts) dw, "
                  "EXTRACT(hour FROM ts) eh, date_part('second', ts) ds, "
                  "trunc(ts, 'month') tr FROM tt",
    "binary": "SELECT id, bin FROM tt",
}
# ordered results compare row for row; the others sorted
ORDERED = {"order"}


def _session(cls, name, conf):
    s = cls(name, dict(BASE, **conf)) if cls is TpuSession \
        else cls(name, dict(BASE, **conf), device="cpu")
    s.createDataFrame(table()).createOrReplaceTempView("tt")
    return s


def _rows(tb, ordered: bool):
    rows = [tuple(r.values()) for r in tb.to_pylist()]
    return rows if ordered else sorted(rows, key=repr)


def run_cases(cases: dict, make_table, ordered=frozenset()) -> dict:
    """Each case's rows in the reference (operator tier) and in the port
    at each tier (stage under watch_syncs and replay_first); an exception
    stands in for the rows of a case that raised."""
    out: dict = {}
    ref = TpuSession("types-reference", dict(
        BASE, **{"spark.tpu.fusion.enabled": "false",
                 "spark.tpu.compile.tier": "operator"}))
    ports = {tier: TorchSession(f"types-{tier}", dict(BASE, **conf),
                                device="cpu")
             for tier, conf in TIERS.items()}
    for s in (ref, *ports.values()):
        for name, tb in make_table().items():
            s.createDataFrame(tb).createOrReplaceTempView(name)
    with pytest.MonkeyPatch.context() as mp:
        syncs = watch_syncs(mp)
        replayed = replay_first(mp)
        for engine, s in [("reference", ref)] + list(ports.items()):
            for name, text in cases.items():
                try:
                    out[(engine, name)] = _rows(s.sql(text).toArrow(),
                                                name in ordered)
                except Exception as e:  # noqa: BLE001
                    out[(engine, name)] = e
        out["syncs"] = list(syncs)
        out["replayed"] = len(replayed)
    for s in (ref, *ports.values()):
        s.stop()
    return out


def check_case(results: dict, name: str) -> None:
    want = results[("reference", name)]
    assert not isinstance(want, Exception), f"reference raised {want!r}"
    got = results[("operator", name)]
    assert not isinstance(got, Exception), f"port raised {got!r}"
    assert got == want
    for tier in ("stage", "whole"):
        assert results[(tier, name)] == got, tier


@pytest.fixture(scope="module")
def results():
    return run_cases(CASES, lambda: {"tt": table()}, ORDERED)


@pytest.mark.parametrize("name", list(CASES))
def test_timestamp_case_matches_reference(results, name):
    check_case(results, name)


def test_fused_bodies_read_nothing_on_the_host(results):
    assert results["replayed"] > 0
    assert results["syncs"] == []


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns"])
@pytest.mark.parametrize("tz", [None, "UTC", "America/New_York"])
def test_arrow_round_trip_of_every_unit_and_zone(unit, tz):
    """Any timestamp unit or zone reads as timestamp[us] (a zone's value
    is its UTC instant), and collects back as timestamp[us], in both
    engines."""
    rng = np.random.default_rng(4)
    secs = rng.integers(-2_000_000_000, 4_000_000_000, 50)
    scale = {"s": 1, "ms": 1000, "us": 1_000_000, "ns": 1_000_000_000}[unit]
    arr = pa.array((secs * scale).astype(np.int64), pa.timestamp(unit, tz),
                   mask=rng.random(50) < 0.2)
    tb = pa.table({"t": arr})
    t = TorchSession("round-trip", {}, device="cpu")
    j = TpuSession("round-trip", {})
    got = t.createDataFrame(tb).toArrow()
    want = j.createDataFrame(tb).toArrow()
    t.stop()
    j.stop()
    assert got.schema.field("t").type == pa.timestamp("us")
    assert got.column("t").to_pylist() == want.column("t").to_pylist()
    plain = arr.cast(pa.timestamp("us", tz)).cast(pa.int64()).to_pylist()
    assert [None if v is None else (v - EPOCH) // US
            for v in got.column("t").to_pylist()] == plain


def test_timestamp_literal_is_exact_where_the_reference_rounds():
    """C14: the reference turns a TIMESTAMP literal (and a parsed string,
    and a datetime inside a nested value) into microseconds through a
    float of seconds, which loses one at about 1.4% of instants; the port
    computes it in integers, held to Python's own arithmetic."""
    text = "2004-02-08 17:26:31.179340"
    exact = (datetime.datetime.fromisoformat(text) - EPOCH) // US
    q = f"SELECT unix_timestamp(TIMESTAMP '{text}') * 0 + " \
        f"CAST(TIMESTAMP '{text}' AS BIGINT) v, " \
        f"CAST(CAST('{text}' AS TIMESTAMP) AS BIGINT) w"
    t = TorchSession("c14", {}, device="cpu")
    j = TpuSession("c14", {})
    got = t.sql(q).toArrow().to_pylist()[0]
    ref = j.sql(q).toArrow().to_pylist()[0]
    t.stop()
    j.stop()
    assert got == {"v": exact, "w": exact}
    assert ref == {"v": exact - 1, "w": exact - 1}  # the reference's fault


def test_binary_group_by_matches_python():
    """A binary key groups, and binary values compare, by value through
    the dictionary's hashes (the reference cannot hash a dictionary of
    bytes: held to Python)."""
    tb = table()
    t = _session(TorchSession, "binary", TIERS["operator"])
    got = t.sql("SELECT bin, count(*) n, sum(id) si FROM tt GROUP BY bin") \
        .toArrow().to_pylist()
    eq = t.sql("SELECT count(*) n FROM tt WHERE bin = bin").toArrow()
    t.stop()
    blobs = tb.column("bin").to_pylist()
    assert eq.to_pylist() == [{"n": sum(b is not None for b in blobs)}]
    want: dict = {}
    for b, i in zip(tb.column("bin").to_pylist(), tb.column("id").to_pylist()):
        n, si = want.get(b, (0, 0))
        want[b] = (n + 1, si + i)
    assert {r["bin"]: (r["n"], r["si"]) for r in got} == want


def test_types_module():
    assert T.infer_type(datetime.datetime(2020, 1, 1)) == T.timestamp
    assert T.infer_type(b"x") == T.binary
    assert T.infer_type([1, None, 2]) == T.ArrayType(T.int32)
    assert T.infer_type({"a": 1.5}) == T.MapType(T.string, T.float64)
    assert T.common_type(T.date, T.timestamp) == T.timestamp
    assert T.common_type(T.timestamp, T.date) == T.timestamp
    assert T.dict_encoded(T.binary) and T.dict_encoded(T.ArrayType())
    assert not T.dict_encoded(T.timestamp)
    assert T.from_arrow_type(pa.timestamp("ns", "UTC")) == T.timestamp
    assert T.to_arrow_type(T.timestamp) == pa.timestamp("us")
    assert T.to_arrow_type(T.binary) == pa.binary()
    with pytest.raises(NotPortedError):
        T.from_arrow_type(pa.decimal128(30, 2))


def test_decimal_past_18_digits_still_raises():
    t = TorchSession("wide-decimal", {}, device="cpu")
    with pytest.raises(NotPortedError):
        t.createDataFrame(pa.table({"d": pa.array(
            [decimal.Decimal("1.5")], pa.decimal128(25, 1))}))
    t.stop()
