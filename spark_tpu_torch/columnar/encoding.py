"""Encoded-column metadata: run-length segments of integral columns (the
port's copy of `spark_tpu/columnar/encoding.py`).

Columns carry cheap host-side metadata harvested while an ingested plane is
still a numpy array, and the operators pick encoding-native paths from it
without reading the device:

  * `RunInfo`: the run-length structure of an integral column
    (sortedness, first and last value; the reference's run count has no
    reader in the port and is not computed). A SORTED single grouping key
    reduces per run boundary (`ops/grouping.group_rows_presorted`, the
    hand-written run-layout kernel on the card) instead of paying the
    grouping sort.
  * dictionary codes: a string column's int32 codes are a dense group
    domain [0, len(dict)) known on the host (`HashAggregateExec._try_dense`
    keys on them directly; `columnar/arrow.py` seeds the dense-range memo
    with their span).

Everything here is numpy: no kernel launch, no device read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["RunInfo", "column_runs", "configure", "encoding_enabled",
           "runs_harvest_enabled"]

# rows whose order column_runs checks before the full sortedness pass
_SORT_PROBE_ROWS = 4096

# a process-wide switch rather than a per-call conf read: the harvest sits
# on the ingest path (every integral column of every tile); set by
# configure() from each session's conf
_ENCODING_ON = True


def configure(conf) -> None:
    """Apply a session's conf to the process-global harvest switch
    (spark.tpu.encoding.enabled). The decision sites read their session's
    conf themselves; this only gates the ingest-time harvest."""
    global _ENCODING_ON

    _ENCODING_ON = encoding_enabled(conf)


def runs_harvest_enabled() -> bool:
    return _ENCODING_ON


class RunInfo(NamedTuple):
    """Host-side run-length summary of one ingested column's live prefix.

    Computed on the host array at ingest (O(n) numpy, no device work) for
    integral and date columns without a validity plane. `is_sorted`
    licenses the run-boundary (sort-free) grouped aggregate: mask-only
    filters never reorder rows, so sortedness survives every mask-based
    operator; a column written anew (a gather, a concatenation, a kernel's
    output) has none."""

    is_sorted: bool
    first: int
    last: int


def column_runs(data: np.ndarray, n: int) -> RunInfo | None:
    """RunInfo over the first `n` (live) rows of a host integral array,
    or None for an empty or non-integral one."""
    if n <= 0 or data.dtype.kind not in "iu":
        return None
    live = data[:n]
    # neighbours compared, not differenced: no int64 temporary, and no
    # wrap-around where a difference would overflow; a descent among the
    # first rows settles an unsorted column without the full pass
    after, before = live[1:], live[:-1]
    head = _SORT_PROBE_ROWS
    is_sorted = bool((after[:head] >= before[:head]).all()) and \
        bool((after >= before).all())
    return RunInfo(is_sorted, int(live[0]), int(live[-1]))


def encoding_enabled(conf) -> bool:
    """spark.tpu.encoding.enabled: the compressed-execution switch (off:
    the decode-at-boundary paths)."""
    from ..config import ENCODING_ENABLED

    return bool(conf.get(ENCODING_ENABLED))
