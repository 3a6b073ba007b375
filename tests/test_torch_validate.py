"""Batch validation (`spark_tpu_torch/columnar/validate.py`, the debug mode
behind spark.tpu.debug.validateBatches) against the JAX reference's
`spark_tpu/columnar/validate.py`: each invariant `validate_batch` checks,
broken on purpose in a small batch, raises ExecutionError in both engines,
and a sound batch, or a bad code on a masked or NULL row, passes. The port
also bounds the codes of array, map and struct columns, which the
reference does not check. A session with the key set validates every stage's result
(ROADMAP.md C22: the port accepted the key and validated nothing): the
reference's tests/test_kernels.py case gives the same result in both, a
tile broken on purpose at ingest raises, and the construct statements of
tests/test_torch_cuda.py run with it set to the same results."""

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu.columnar.batch as JB  # noqa: E402
import spark_tpu.types as JT  # noqa: E402
import spark_tpu_torch.api.functions as F  # noqa: E402
import spark_tpu_torch.columnar.arrow as arrow  # noqa: E402
import spark_tpu_torch.columnar.batch as TB  # noqa: E402
import spark_tpu_torch.types as TT  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu.columnar.validate import validate_batch as jax_validate  # noqa: E402,E501
from spark_tpu.errors import ExecutionError as JaxExecutionError  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from spark_tpu_torch.columnar.validate import validate_batch  # noqa: E402
from spark_tpu_torch.errors import ExecutionError  # noqa: E402
from tests.test_torch_cuda import SQL_CONSTRUCTS, WINDOW_CONSTRUCTS  # noqa: E402,E501
from tests.test_torch_cuda import construct_rows, construct_tables  # noqa: E402,E501
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401

ENGINES = {
    "port": (TB, TT, torch.from_numpy, validate_batch, ExecutionError),
    "reference": (JB, JT, jnp.asarray, jax_validate, JaxExecutionError),
}


def _batch(engine, s_type=None, s_dict=None):
    """A sound 4-slot batch: k int64 with a NULL, s string with a NULL
    (dictionary a, b), the last slot dead."""
    B, T, arr, _, _ = ENGINES[engine]
    s_type = s_type or T.string
    schema = T.StructType([T.StructField("k", T.int64, True),
                           T.StructField("s", s_type, True)])
    cols = [B.Column(T.int64, arr(np.array([1, 2, 3, 0], np.int64)),
                     arr(np.array([True, True, False, False]))),
            B.Column(s_type, arr(np.array([0, 1, 0, 0], np.int32)),
                     arr(np.array([True, True, False, True])),
                     B.StringDict(s_dict or ["a", "b"]))]
    return B.ColumnarBatch(schema, cols,
                           arr(np.array([True, True, True, False])), 3)


def _set(batch, i, **kw):
    import dataclasses

    batch.columns[i] = dataclasses.replace(batch.columns[i], **kw)


# name -> (how to break a sound batch, what the message says)
BROKEN = {
    "column_count": (lambda b, arr: b.columns.pop(), "column count"),
    "mask_dtype": (lambda b, arr: setattr(
        b, "row_mask", arr(np.array([1, 1, 1, 0], np.int32))),
        "bad row mask"),
    "mask_shape": (lambda b, arr: setattr(
        b, "row_mask", arr(np.ones((4, 2), bool))), "bad row mask"),
    "column_shape": (lambda b, arr: _set(
        b, 0, data=arr(np.zeros(5, np.int64))), "shape"),
    "column_dtype": (lambda b, arr: _set(
        b, 0, data=arr(np.zeros(4, np.int32))), "dtype"),
    "validity_dtype": (lambda b, arr: _set(
        b, 0, validity=arr(np.ones(4, np.int8))), "bad validity"),
    "validity_shape": (lambda b, arr: _set(
        b, 0, validity=arr(np.ones(3, bool))), "bad validity"),
    "code_past_dictionary": (lambda b, arr: _set(
        b, 1, data=arr(np.array([0, 2, 0, 0], np.int32))), "out of range"),
    "negative_code": (lambda b, arr: _set(
        b, 1, data=arr(np.array([-1, 1, 0, 0], np.int32))), "out of range"),
    "missing_dictionary": (lambda b, arr: _set(b, 1, dictionary=None),
                           "missing dictionary"),
}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", list(BROKEN))
def test_broken_batch_raises(engine, name):
    _, _, arr, validate, error = ENGINES[engine]
    validate(_batch(engine), "sound")
    b = _batch(engine)
    breaker, what = BROKEN[name]
    breaker(b, arr)
    with pytest.raises(error, match=what):
        validate(b, "test")


# bad codes the check must let pass: on a dead slot, on a NULL row
PASSING = {
    "dead_slot": np.array([0, 1, 0, 7], np.int32),
    "null_row": np.array([0, 1, 9, 0], np.int32),
}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", list(PASSING))
def test_bad_code_on_a_dead_or_null_row_passes(engine, name):
    _, _, arr, validate, _ = ENGINES[engine]
    b = _batch(engine)
    _set(b, 1, data=arr(PASSING[name]))
    validate(b, "test")


@pytest.mark.parametrize("kind", ["binary", "array", "map", "struct"])
def test_port_bounds_codes_of_other_dictionary_types(kind):
    """The port bounds the codes of every dictionary-encoded type; the
    reference checks strings, binary among them (a StringType there),
    and lets the same batch pass over an array, map or struct column."""
    entries = {"binary": [b"x", b"y"], "array": [[1], [2, 3]],
               "map": [{"a": 1}, {"b": 2}],
               "struct": [{"f": 1}, {"f": 2}]}[kind]
    for engine in ENGINES:
        _, T, arr, validate, error = ENGINES[engine]
        typ = {"binary": lambda: T.binary,
               "array": lambda: T.ArrayType(T.int32),
               "map": lambda: T.MapType(T.string, T.int32),
               "struct": lambda: T.StructType(
                   [T.StructField("f", T.int32, True)])}[kind]()
        b = _batch(engine, typ, entries)
        validate(b, "sound")
        _set(b, 1, data=arr(np.array([0, 5, 0, 0], np.int32)))
        if engine == "port" or kind == "binary":
            with pytest.raises(error, match="out of range"):
                validate(b, "test")
        else:
            validate(b, "test")


def test_validation_key_is_registered():
    """C22: the key is the port's own, typed as the reference's; before,
    the port kept it as an unknown string and validated nothing."""
    s = TorchSession("v", {"spark.tpu.debug.validateBatches": "true"},
                     device="cpu")
    assert s.conf.get("spark.tpu.debug.validateBatches") is True
    assert TorchSession("w", device="cpu").conf.get(
        "spark.tpu.debug.validateBatches") is False


def test_batch_validation_mode_matches_reference():
    """tests/test_kernels.py:180 in both engines."""
    conf = {"spark.sql.shuffle.partitions": 4,
            "spark.tpu.batch.capacity": 1 << 12,
            "spark.tpu.debug.validateBatches": "true"}
    tbl = pa.table({"k": ["a", "b", "a"], "v": [1, 2, 3]})
    out = []
    for s, fn in ((TpuSession("r", dict(conf)), JF),
                  (TorchSession("p", dict(conf), device="cpu"), F)):
        out.append(s.createDataFrame(tbl).repartition(3).groupBy("k")
                   .agg(fn.sum("v").alias("s")).orderBy("k")
                   .toArrow().to_pydict())
        s.stop()
    assert out[0] == out[1] == {"k": ["a", "b"], "s": [4, 2]}


@pytest.mark.parametrize("tier", ["operator", "stage", "whole"])
def test_broken_tile_raises_in_a_validating_session(monkeypatch, tier):
    """A tile whose string codes run past its dictionary (made at ingest
    on purpose) raises ExecutionError from the stage that produced it when
    the key is set, and goes unnoticed when it is not."""
    real = arrow.table_to_batches

    def corrupt(*args, **kw):
        for b in real(*args, **kw):
            c = b.columns[0]
            b.columns[0] = TB.Column(c.dtype, c.data + 7, c.validity,
                                     c.dictionary)
            yield b

    monkeypatch.setattr(arrow, "table_to_batches", corrupt)
    tbl = pa.table({"s": ["a", "b", "a"], "v": [1, 2, 3]})
    for validate in ("false", "true"):
        s = TorchSession("broken", {
            "spark.tpu.debug.validateBatches": validate,
            "spark.tpu.compile.tier": tier}, device="cpu")
        df = s.createDataFrame(tbl).filter(F.col("v") > 0)
        if validate == "true":
            with pytest.raises(ExecutionError, match="out of range"):
                df.toArrow()
        else:
            df.toArrow()
        s.stop()


@pytest.fixture(scope="module")
def validating_pair():
    tables = construct_tables()
    base = {"spark.sql.shuffle.partitions": 4,
            "spark.tpu.batch.capacity": 1 << 10,
            "spark.sql.autoBroadcastJoinThreshold": 1024,
            "spark.tpu.fusion.minRows": 0}
    out = []
    for validate in ("false", "true"):
        s = TorchSession(f"validate-{validate}", dict(
            base, **{"spark.tpu.debug.validateBatches": validate}),
            device="cpu")
        for name, tb in tables.items():
            s.createDataFrame(tb).createOrReplaceTempView(name)
        out.append(s)
    yield out
    for s in out:
        s.stop()


CONSTRUCTS = dict(SQL_CONSTRUCTS, **WINDOW_CONSTRUCTS)


@pytest.mark.parametrize("name", list(CONSTRUCTS))
def test_constructs_pass_validation(validating_pair, name):
    """Every construct statement at the default tier with the key set:
    no stage's result breaks an invariant, and the result equals the
    same statement's without validation."""
    plain, checked = validating_pair
    text, ordered = CONSTRUCTS[name]
    assert construct_rows(checked.sql(text).toArrow(), ordered) == \
        construct_rows(plain.sql(text).toArrow(), ordered)
