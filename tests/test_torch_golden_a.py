"""The reference's golden SQL corpus in the port, result files 'a'-'i'
(tests/torch_golden.py says how each statement is held to its committed
result or to an out-of-scope construct; tests/test_torch_golden_b.py runs
the rest)."""

import pytest

pytest.importorskip("torch")

from tests import torch_golden as G  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def corpus():
    c = G.Corpus()
    yield c
    c.close()


@pytest.mark.parametrize("path,index", G.cases("a", "i"))
def test_golden_statement(corpus, path, index):
    corpus.check(path, index)
