"""The port's VARIANT codec (`spark_tpu_torch/utils/variant.py`) against the
JAX package's (`spark_tpu/utils/variant.py`) on the three cases of
tests/test_sketch.py: a round trip of a nested value with a Decimal, JSON
parsing with path lookups, and the metadata dictionary that stores a
repeated key once. Both packages must produce the same bytes."""

from decimal import Decimal

import pytest

from spark_tpu.utils.variant import Variant as JaxVariant
from spark_tpu_torch.utils.variant import Variant

PAIR = [Variant, JaxVariant]


@pytest.mark.parametrize("cls", PAIR, ids=["port", "reference"])
def test_variant_roundtrip(cls):
    obj = {"name": "spark", "n": 42, "pi": 3.5, "ok": True,
           "tags": ["a", "b", {"deep": None}],
           "price": Decimal("12.34")}
    v = cls.of(obj)
    assert v.to_python() == obj
    assert isinstance(v.metadata, bytes) and isinstance(v.value, bytes)
    ref = JaxVariant.of(obj)
    assert (v.metadata, v.value) == (ref.metadata, ref.value)


@pytest.mark.parametrize("cls", PAIR, ids=["port", "reference"])
def test_variant_parse_json_and_get(cls):
    text = '{"a": {"b": [10, 20, {"c": "x"}]}, "z": false}'
    v = cls.parse_json(text)
    assert v.get("$.a.b[1]") == 20
    assert v.get("$.a.b[2].c") == "x"
    assert v.get("$.z") is False
    assert v.get("$.missing") is None
    assert v.get("$.a.b[9]") is None
    ref = JaxVariant.parse_json(text)
    assert (v.metadata, v.value) == (ref.metadata, ref.value)


@pytest.mark.parametrize("cls", PAIR, ids=["port", "reference"])
def test_variant_metadata_dictionary_shares_keys(cls):
    v = cls.of([{"k": 1}, {"k": 2}, {"k": 3}])
    # one dictionary entry regardless of repetitions
    assert v.metadata.count(b"k") == 1
    assert v.to_python() == [{"k": 1}, {"k": 2}, {"k": 3}]
    ref = JaxVariant.of([{"k": 1}, {"k": 2}, {"k": 3}])
    assert (v.metadata, v.value) == (ref.metadata, ref.value)
