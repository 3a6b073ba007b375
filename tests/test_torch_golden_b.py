"""The reference's golden SQL corpus in the port, result files 'j'-'z'
(tests/torch_golden.py says how each statement is held to its committed
result or to an out-of-scope construct; tests/test_torch_golden_a.py runs
the rest)."""

import os

import pytest

pytest.importorskip("torch")

from tests import torch_golden as G  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def corpus():
    c = G.Corpus()
    yield c
    c.close()


@pytest.mark.parametrize("path,index", G.cases("j", "z"))
def test_golden_statement(corpus, path, index):
    corpus.check(path, index)


@pytest.mark.parametrize("key", sorted(G.REFERENCE_RESULTS))
def test_reference_fault_blocks_pinned(key):
    """The committed blocks that SPARK_RESULTS overrides are still the
    reference's wrong results: `lead` as `lag`, the default dropped."""
    path = os.path.join(G.RESULTS, key[0])
    assert G.blocks(path)[key[1]][1] == G.REFERENCE_RESULTS[key]
    assert G.SPARK_RESULTS[key] != G.REFERENCE_RESULTS[key]
