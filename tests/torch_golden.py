"""The reference's golden SQL corpus (`tests/sql-tests/results/*.out`) run
in the port: the machinery of tests/test_torch_golden_a.py and _b.py.

Each `.out` file holds `-- !query` / `-- !result` blocks, the statements
the reference ran and their rendered results. Each statement runs in a CPU
`TorchSession` holding the views of tests/test_golden.py's `_setup`:
`tpcds_mini`'s tables and the `nested` view of struct, map and array
columns (the table `_setup` builds, made here by `nested_table`). The
result is rendered with test_golden.py's `_render`/`_fmt` rules and held
to the committed block.

Four blocks hold the reference's faults (its `lead` computes `lag`, and it
drops lag/lead's default): there the port is held to Spark's result,
`SPARK_RESULTS`, and the committed block is pinned as the reference's.

A statement may instead raise NotPortedError for a construct of another
slice: `OUT_OF_SCOPE` maps each such construct to its ROADMAP.md item. A
CREATE TEMP VIEW statement runs through the port's command and is held to
its committed block like any other; where its query raises
NotPortedError at parse time, the view is not made, and a statement over
it counts under the construct that kept the view from being made. Anything else (a wrong result, another error, an in-scope
construct that raises) fails. The committed results are the reference's
and are never regenerated here.

`python -m tests.torch_golden` prints the tally: statements that pass,
and those that raise, by ROADMAP.md item and construct."""

from __future__ import annotations

import glob
import os
import re

import pytest

from spark_tpu_torch import NotPortedError, TorchSession
from spark_tpu_torch.errors import AnalysisException

HERE = os.path.dirname(os.path.abspath(__file__))
RESULTS = os.path.join(HERE, "sql-tests", "results")

# construct named by NotPortedError -> the ROADMAP.md item that ports it
# (empty: the port builds every statement of the corpus)
OUT_OF_SCOPE: dict[str, str] = {}

# Blocks whose committed result is the reference's fault, ROADMAP.md C18
# (its `lead` computes `lag`) and "lag/lead drop their default value": the
# port is held to Spark's result (SPARK_RESULTS), and the committed block
# is pinned as the reference's (REFERENCE_RESULTS). Keyed by (file, block).
SPARK_RESULTS = {
    ("window-basic.out", 3): "-- i_item_id\tlg\tld\n"
                             "ITEM000000\tNULL\t44.17\n"
                             "ITEM000001\t77.51\t85.93\n"
                             "ITEM000002\t44.17\t69.89\n"
                             "ITEM000003\t85.93\t9.87\n"
                             "ITEM000004\t69.89\t97.57",
    ("window-lead-lag.out", 1): "-- i\tlag1\tlead1\n"
                                "1\tNULL\t20\n"
                                "2\t10\t30\n"
                                "3\t20\tNULL",
    ("window-lead-lag.out", 2): "-- i\tlag2\tlead_default\n"
                                "1\tNULL\t20\n"
                                "2\tNULL\t30\n"
                                "3\t10\t-1",
    ("window-frames.out", 2): "-- x\tld\tlg\tnt\n"
                              "10\t20\t-1\t1\n"
                              "20\t30\t10\t1\n"
                              "30\tNULL\t20\t2",
}
REFERENCE_RESULTS = {
    ("window-basic.out", 3): "-- i_item_id\tlg\tld\n"
                             "ITEM000000\tNULL\tNULL\n"
                             "ITEM000001\t77.51\t77.51\n"
                             "ITEM000002\t44.17\t44.17\n"
                             "ITEM000003\t85.93\t85.93\n"
                             "ITEM000004\t69.89\t69.89",
    ("window-lead-lag.out", 1): "-- i\tlag1\tlead1\n"
                                "1\tNULL\tNULL\n"
                                "2\t10\t10\n"
                                "3\t20\t20",
    ("window-lead-lag.out", 2): "-- i\tlag2\tlead_default\n"
                                "1\tNULL\tNULL\n"
                                "2\tNULL\t10\n"
                                "3\t10\t20",
    ("window-frames.out", 2): "-- x\tld\tlg\tnt\n"
                              "10\tNULL\tNULL\t1\n"
                              "20\t10\t10\t1\n"
                              "30\t20\t20\t2",
}

_CREATE_VIEW = re.compile(
    r"^\s*CREATE\s+(?:OR\s+REPLACE\s+)?(?:GLOBAL\s+)?TEMP(?:ORARY)?\s+VIEW"
    r"\s+(\w+)", re.IGNORECASE)
_MISSING_VIEW = re.compile(r"Table or view not found: (\w+)")


def nested_table():
    """tests/test_golden.py's `nested` view: a struct, a map and an array
    column over three rows."""
    import pyarrow as pa

    return pa.table({
        "id": [1, 2, 3],
        "person": pa.array(
            [{"name": "ann", "age": 31}, {"name": "bob", "age": 25}, None],
            pa.struct([("name", pa.string()), ("age", pa.int64())])),
        "tags": pa.array([[("x", 1), ("y", 2)], [("x", 9)], []],
                         pa.map_(pa.string(), pa.int64())),
        "nums": pa.array([[3, 1, 2], [5], None], pa.list_(pa.int64())),
    })


def blocks(path: str) -> list[tuple[str, str]]:
    """(statement, rendered result) of each block of a `.out` file."""
    with open(path) as f:
        text = f.read()
    out = []
    for chunk in text.split("-- !query\n")[1:]:
        q, res = chunk.split("\n-- !result\n", 1)
        out.append((q, res.rstrip("\n")))
    return out


def files(first: str, last: str) -> list[str]:
    """The `.out` files whose names start in [first, last]."""
    return [p for p in sorted(glob.glob(os.path.join(RESULTS, "*.out")))
            if first <= os.path.basename(p)[0] <= last]


def cases(first: str, last: str) -> list:
    return [pytest.param(p, i, id=f"{os.path.basename(p)[:-4]}-{i}")
            for p in files(first, last) for i in range(len(blocks(p)))]


def item_of(what: str) -> str | None:
    """The ROADMAP.md item of an out-of-scope construct, else None."""
    w = what.lower()
    for key, item in OUT_OF_SCOPE.items():
        k = key.lower()
        if w == k or w.startswith(k + " ") or w.startswith(k + "(") or (
                not k.startswith("function ") and k in w):
            return item
    return None


class Corpus:
    """One CPU session over the golden views, with each file's unmade
    views (statements run in file order within a test module)."""

    def __init__(self):
        from tests.test_golden import _render
        from tests.tpcds_mini import register_tpcds

        self.render = _render
        self.session = TorchSession(
            "golden", {"spark.sql.shuffle.partitions": 4,
                       "spark.tpu.batch.capacity": 1 << 12}, device="cpu")
        register_tpcds(self.session)
        self.session.createDataFrame(nested_table()) \
            .createOrReplaceTempView("nested")
        self.unmade: dict[str, str] = {}

    def close(self):
        self.session.stop()

    def check(self, path: str, index: int) -> str:
        """Run one block; returns "pass" or the out-of-scope construct it
        raised on. Fails on anything else."""
        q, want = blocks(path)[index]
        want = SPARK_RESULTS.get((os.path.basename(path), index), want)
        try:
            got = self.render(self.session.sql(q).toArrow()).rstrip("\n")
        except NotPortedError as e:
            m = _CREATE_VIEW.match(q)
            if m:
                self.unmade[m.group(1).lower()] = e.what
            item = item_of(e.what)
            assert item is not None, f"{q!r} raised NotPortedError for " \
                f"{e.what!r}, which is in scope"
            return e.what
        except AnalysisException as e:
            m = _MISSING_VIEW.search(str(e))
            assert m and m.group(1).lower() in self.unmade, \
                f"{q!r} raised {e!r}"
            return self.unmade[m.group(1).lower()]
        assert got == want, f"{q!r}\ngot:\n{got}\nwant:\n{want}"
        return "pass"


if __name__ == "__main__":
    import collections

    corpus = Corpus()
    tally: collections.Counter = collections.Counter()
    for path in files("a", "z"):
        for i in range(len(blocks(path))):
            try:
                what = corpus.check(path, i)
            except AssertionError as e:
                print("FAILS", os.path.basename(path), i, str(e)[:400])
                what = "FAILS"
            tally["pass" if what == "pass" else
                  f"{item_of(what)}: {what}"] += 1
    corpus.close()
    print(f"statements {sum(tally.values())}, pass {tally.pop('pass')}")
    for key, n in sorted(tally.items()):
        print(f"{n:4d}  {key}")
