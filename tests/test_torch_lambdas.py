"""A11's lambdas in spark_tpu_torch against the JAX package: the 13
higher-order function names (transform, filter, exists, forall, any_match,
all_match, aggregate, reduce, zip_with, transform_keys, transform_values,
map_filter, map_zip_with) and array_sort with a comparator, over seeded
arrays and maps with NULL arrays and NULL elements, lambdas that capture
outer columns, nested lambdas, a lambda over a collect_list, and the maps
and arrays of tests/torch_golden.py's `nested` view.

Each statement runs in both engines at the operator tier and must give the
reference's rows; in the port also at the stage and forced whole tiers
(a higher-order function is a host UDF, so both engines keep such a plan
staged, with the same decision and reason). The dictionary-domain lane of
PythonEvalExec, which the port widens from a string argument to any
dictionary-encoded one (a lambda's collection when it captures nothing),
is held to the per-row path."""

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401
from tests.test_torch_tpcds_slice import _tier  # noqa: E402
from tests.torch_golden import nested_table  # noqa: E402

CONF = {"spark.sql.shuffle.partitions": 3, "spark.tpu.batch.capacity": 1 << 6,
        "spark.tpu.fusion.minRows": 0, "spark.tpu.compile.whole.minRows": 0}
JAX_CONF = dict(CONF, **{"spark.tpu.fusion.enabled": "false",
                         "spark.tpu.compile.tier": "operator"})
TIER = "spark.tpu.compile.tier"
N = 120

CMP = ("(a, b) -> CASE WHEN a IS NULL THEN 1 WHEN b IS NULL THEN -1 "
       "WHEN a < b THEN 1 WHEN a > b THEN -1 ELSE 0 END")
STATEMENTS = {
    "transform": "SELECT id, transform(arr, x -> x + 1) r FROM lam",
    "transform_capture": "SELECT id, transform(arr, x -> x * k) r FROM lam",
    "transform_index": "SELECT id, transform(arr, (x, i) -> x - i) r "
                       "FROM lam",
    "filter": "SELECT id, filter(arr, x -> x > k) r FROM lam",
    "filter_index": "SELECT id, filter(arr, (x, i) -> i % 2 = 0) r FROM lam",
    "exists": "SELECT id, exists(arr, x -> x IS NULL) r FROM lam",
    "forall": "SELECT id, forall(arr, x -> x > 2) r FROM lam",
    "any_match": "SELECT id, any_match(arr, x -> x = 3) r FROM lam",
    "all_match": "SELECT id, all_match(arr, x -> x < k + 5) r FROM lam",
    "aggregate": "SELECT id, aggregate(arr, 0L, (acc, x) -> acc + "
                 "coalesce(x, 0)) r FROM lam",
    "aggregate_finish": "SELECT id, aggregate(arr, 0L, (acc, x) -> acc + "
                        "coalesce(x, 0), acc -> acc * 10 + k) r FROM lam",
    "reduce": "SELECT id, reduce(arr, 1L, (acc, x) -> acc * 2 + "
              "coalesce(x, k)) r FROM lam",
    "zip_with": "SELECT id, zip_with(arr, arr2, (a, b) -> a + b) r FROM lam",
    "transform_keys": "SELECT id, transform_keys(m, (key, v) -> "
                      "concat(key, '_x')) r FROM lam",
    "transform_values": "SELECT id, transform_values(m, (key, v) -> "
                        "v * k) r FROM lam",
    "map_filter": "SELECT id, map_filter(m, (key, v) -> v > 2) r FROM lam",
    "map_zip_with": "SELECT id, map_zip_with(m, m2, (key, a, b) -> "
                    "coalesce(a, 0) + coalesce(b, 0)) r FROM lam",
    "array_sort": f"SELECT id, array_sort(arr, {CMP}) r FROM lam",
    "nested": "SELECT id, transform(arr, x -> filter(arr2, y -> y > x)) r "
              "FROM lam",
    "nested_exists": "SELECT id, filter(arr, x -> exists(arr2, y -> y = x)) "
                     "r FROM lam",
    "over_collect": "SELECT g, aggregate(l, 0L, (acc, x) -> acc + x) r, "
                    "filter(l, x -> x % 2 = 0) e FROM (SELECT g, "
                    "collect_list(k) l FROM lam GROUP BY g)",
    "golden_map": "SELECT id, transform_values(tags, (key, v) -> v + id) a, "
                  "map_filter(tags, (key, v) -> key = 'x') b FROM nested",
    "golden_array": "SELECT id, transform(nums, x -> x * 2) a, "
                    "exists(nums, x -> x > 2) b, zip_with(nums, nums, "
                    "(p, q) -> p * q) c FROM nested",
    "in_where": "SELECT id FROM lam WHERE exists(arr, x -> x = k)",
}


def table() -> pa.Table:
    """arr, arr2: int64 arrays, some NULL, some with NULL elements, some
    empty; m, m2: string -> int64 maps; k an int64 column the lambdas
    capture; g a small key."""
    rng = np.random.default_rng(23)

    def arr():
        out = []
        for _ in range(N):
            r = rng.random()
            if r < 0.1:
                out.append(None)
            elif r < 0.2:
                out.append([])
            else:
                xs = rng.integers(-3, 9, rng.integers(1, 6)).tolist()
                out.append([None if rng.random() < 0.15 else x for x in xs])
        return pa.array(out, pa.list_(pa.int64()))

    def mp():
        out = []
        for _ in range(N):
            if rng.random() < 0.1:
                out.append(None)
                continue
            keys = rng.choice(["a", "b", "c", "d"], rng.integers(0, 4),
                              replace=False)
            out.append([(str(kk), int(rng.integers(0, 6))) for kk in keys])
        return pa.array(out, pa.map_(pa.string(), pa.int64()))

    return pa.table({"id": np.arange(N, dtype=np.int64),
                     "g": rng.integers(0, 5, N),
                     "k": rng.integers(1, 4, N),
                     "arr": arr(), "arr2": arr(), "m": mp(), "m2": mp()})


def _rows(tb: pa.Table) -> list:
    def norm(v):
        if isinstance(v, list) and v and isinstance(v[0], tuple):
            return sorted(v)   # a map's entries: order is not the value
        if isinstance(v, list):
            return [norm(x) for x in v]
        return v

    return sorted((tuple(norm(v) for v in r) for r in
                   zip(*[c.to_pylist() for c in tb.columns])), key=repr)


@pytest.fixture(scope="module")
def engines():
    j = TpuSession("lambdas-reference", dict(JAX_CONF))
    t = TorchSession("lambdas", dict(CONF, **{TIER: "operator"}),
                     device="cpu")
    for s in (j, t):
        s.createDataFrame(table()).createOrReplaceTempView("lam")
        s.createDataFrame(nested_table()).createOrReplaceTempView("nested")
    yield j, t
    j.stop()
    t.stop()


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_lambda_matches_reference(engines, name):
    j, t = engines
    text = STATEMENTS[name]
    want = j.sql(text).toArrow()
    assert want.num_rows > 0
    for tier in ("operator", "stage", "whole"):
        t.conf.set(TIER, tier)
        try:
            df = t.sql(text)
            got = df.toArrow()
        finally:
            t.conf.set(TIER, "operator")
        assert got.column_names == want.column_names, tier
        assert _rows(got) == _rows(want), tier
        if tier == "whole":
            j.conf.set(TIER, "whole")
            j.conf.set("spark.tpu.fusion.enabled", "true")
            try:
                assert _tier(df) == _tier(j.sql(text))
            finally:
                j.conf.set(TIER, "operator")
                j.conf.set("spark.tpu.fusion.enabled", "false")


def test_lambda_names_cover_the_registry():
    from spark_tpu_torch.expr import registry as TR

    names = {"transform", "filter", "exists", "forall", "any_match",
             "all_match", "aggregate", "reduce", "zip_with",
             "transform_keys", "transform_values", "map_filter",
             "map_zip_with"}
    assert names <= set(TR.registered_names())
    used = {n for n in names for text in STATEMENTS.values()
            if f"{n}(" in text}
    assert used == names


def test_dictionary_domain_lane_matches_per_row_path(engines):
    """A lambda with no capture evaluates once per distinct array entry
    (the widened lane; the metric counts it), and gives what the per-row
    path gives (encoding off takes that path)."""
    _, t = engines
    text = ("SELECT id, transform(arr, x -> x * 3) a, aggregate(arr2, 0L, "
            "(acc, x) -> acc + coalesce(x, 1)) b, map_filter(m, (key, v) -> "
            "v > 1) c FROM lam")
    before = t.metrics.get("udf.dict_domain_evals", 0)
    lane = t.sql(text).toArrow()
    assert t.metrics.get("udf.dict_domain_evals", 0) > before
    t.conf.set("spark.tpu.encoding.enabled", "false")
    try:
        per_row = t.sql(text).toArrow()
    finally:
        t.conf.unset("spark.tpu.encoding.enabled")
    assert _rows(lane) == _rows(per_row)


def test_lambda_errors_match_reference(engines):
    """A lambda over a non-collection and a lambda of too many parameters
    fail in both engines with the same error class."""
    j, t = engines
    for text in ("SELECT transform(k, x -> x) FROM lam",
                 "SELECT transform(arr, (a, b, c) -> a) FROM lam"):
        errs = []
        for s in (j, t):
            with pytest.raises(Exception) as err:
                s.sql(text).toArrow()
            errs.append(type(err.value).__name__)
        assert errs[0] == errs[1], (text, errs)
