"""Process-global memo of host-synced scalars derived from device tensors
(the port's copy of `spark_tpu/utils/device_memo.py`: `memo_device_scalars`
and `seed_dense_range_memo`).

A read of a device value stalls the host until the card catches up. The
memo, keyed by the IDENTITY of the source tensors, makes such reads once per
tensor instead of once per batch: a broadcast build probed from every probe
partition, or range-exchange samples of device-cached scan tiles. Entries
hold weakrefs and verify identity, since id() values recycle after GC. An
entry whose source tensor dies can never hit again: the weakref's callback
queues its key and the next call drops it, so dead entries do not pile up
until LRU eviction.
"""

from __future__ import annotations

import collections
import threading
import weakref

__all__ = ["DENSE_RANGE_KIND", "memo_device_scalars",
           "seed_dense_range_memo"]

# the memo kind of physical/operators.dense_range_stats: (kmin, kmax,
# any_live) of a column under a row mask
DENSE_RANGE_KIND = ("dense_range",)

_MEMO: "collections.OrderedDict" = collections.OrderedDict()
_LOCK = threading.Lock()
_MAX = 4096
# (key, token) of entries whose source tensors died. Weakref callbacks only
# append here (they may run inside a garbage collection that interrupts a
# memo update, so they take no lock and touch no dict); the next call drops
# the entries under the lock. The token tells a dead entry from a newer one
# under a recycled id.
_DEAD: list = []


def _drop_dead() -> None:
    while _DEAD:
        key, token = _DEAD.pop()
        ent = _MEMO.get(key)
        if ent is not None and ent[2] is token:
            del _MEMO[key]


def memo_device_scalars(kind: tuple, arrays: tuple, compute):
    """Memoized `compute()` keyed by `kind` + identity of `arrays` (None
    entries allowed). Treat returned values as immutable."""
    live = tuple(a for a in arrays if a is not None)
    key = (kind, tuple(id(a) if a is not None else None for a in arrays))
    with _LOCK:
        _drop_dead()
        ent = _MEMO.get(key)
        if ent is not None:
            refs, value, _ = ent
            if all(r() is a for r, a in zip(refs, live)):
                _MEMO.move_to_end(key)
                return value
            del _MEMO[key]
    value = compute()
    token = object()

    def died(_ref, entry=(key, token)):
        _DEAD.append(entry)

    refs = tuple(weakref.ref(a, died) for a in live)
    with _LOCK:
        _MEMO[key] = (refs, value, token)
        while len(_MEMO) > _MAX:
            _MEMO.popitem(last=False)
    return value


def seed_dense_range_memo(col, row_mask, value: tuple) -> None:
    """Pre-populate the dense-range memo from stats computed on the host
    while the column was still a numpy array (the Arrow ingest,
    columnar/arrow.record_batch_to_columnar): the dense aggregate's and
    dense join's decision over that tile then reads nothing from the
    device, even on a cold first run. `value` = (kmin, kmax, any_live)
    under the tile's row mask and validity, the dense_range_stats
    contract."""
    memo_device_scalars(DENSE_RANGE_KIND,
                        (col.data, col.validity, row_mask), lambda: value)
