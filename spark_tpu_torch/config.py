"""Typed configuration (the port's copy of `spark_tpu/config.py`: the
`ConfigEntry` registry and `SQLConf`, with the keys the port reads).

Keys shared with the JAX package keep its names, so one conf dict drives
both engines in a differential test. `spark.torch.device` is the port's
own: where the session runs.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class ConfigEntry:
    key: str
    default: Any
    doc: str = ""
    value_type: Callable[[str], Any] = str


_REGISTRY: dict[str, ConfigEntry] = {}


def _register(entry: ConfigEntry) -> ConfigEntry:
    _REGISTRY[entry.key] = entry
    return entry


SHUFFLE_PARTITIONS = _register(ConfigEntry(
    "spark.sql.shuffle.partitions", 8,
    "Default number of partitions for exchanges.", int))

BATCH_CAPACITY = _register(ConfigEntry(
    "spark.tpu.batch.capacity", 1 << 16,
    "Largest row capacity of a ColumnarBatch tile; tiles are sized to a "
    "power-of-two bucket of their rows.", int))

AGG_BLOCK_ROWS = _register(ConfigEntry(
    "spark.tpu.agg.blockRows", 1 << 22,
    "A grouped aggregate over more tile rows than this folds chunk by "
    "chunk: partial-aggregate each chunk, then merge the partials.", int))

AUTO_BROADCAST_THRESHOLD = _register(ConfigEntry(
    "spark.sql.autoBroadcastJoinThreshold", 10 * 1024 * 1024,
    "Max estimated build-side bytes for a broadcast hash join.", int))

ENCODING_ENABLED = _register(ConfigEntry(
    "spark.tpu.encoding.enabled", True,
    "Compressed execution: a single dictionary-encoded (string) grouping "
    "key aggregates by direct scatter over its dense code domain, and a "
    "single sorted integral key (its ingest RunInfo, "
    "columnar/encoding.py) reduces per run without sorting.",
    lambda s: str(s).lower() == "true"))


def _bool(s) -> bool:
    return str(s).lower() == "true"


VALIDATE_BATCHES = _register(ConfigEntry(
    "spark.tpu.debug.validateBatches", False,
    "Validate every operator's output batches (shape/dtype/mask "
    "invariants; columnar/validate.py). Debug only — syncs per batch.",
    _bool))


DPP_ENABLED = _register(ConfigEntry(
    "spark.sql.dynamicPartitionPruning.enabled", True,
    "Prune probe-side scan splits from the join build side's distinct keys "
    "(reference: sqlx/dynamicpruning/PartitionPruning.scala).", _bool))

DPP_BUILD_THRESHOLD = _register(ConfigEntry(
    "spark.sql.dynamicPartitionPruning.buildThreshold", 4 << 20,
    "Max build-side rows for which distinct join-key values are collected "
    "for dynamic partition pruning.", int))

PARQUET_FILTER_PUSHDOWN = _register(ConfigEntry(
    "spark.sql.parquet.filterPushdown", True,
    "Prune parquet splits by hive partition values and row-group min/max "
    "statistics (reference: ParquetFileFormat/ParquetFilters).", _bool))

DSV2_FILTER_PUSHDOWN = _register(ConfigEntry(
    "spark.tpu.datasource.filterPushdown", True,
    "Negotiate predicate pushdown with SupportsPushDownFilters sources "
    "(V2ScanRelationPushDown role).", _bool))

DSV2_AGG_PUSHDOWN = _register(ConfigEntry(
    "spark.tpu.datasource.aggPushdown", True,
    "Push whole group-by aggregates into SupportsPushDownAggregation "
    "sources.", _bool))

DEFAULT_PARALLELISM = _register(ConfigEntry(
    "spark.default.parallelism", 8,
    "Default partition count of spark.range.", int))

NESTED_LOOP_TILE_FACTOR = 8
"""A nested-loop join forms its pairs in tiles of at most
spark.tpu.batch.capacity times this many rows."""

FUSION_ENABLED = _register(ConfigEntry(
    "spark.tpu.fusion.enabled", True,
    "Whole-stage fusion: collapse each exchange-free chain of fusable "
    "operators (filter/project feeding a partial aggregate, limit, "
    "hash-join probe or shuffle write) into ONE program per batch "
    "(reference: WholeStageCodegenExec produce/consume splicing, "
    "sqlx/WholeStageCodegenExec.scala:673). On the card the program is "
    "a captured CUDA graph replayed per batch; on the CPU it runs "
    "eagerly. Off = operator-at-a-time execution, kept as the "
    "differential-testing oracle.", _bool))

FUSION_MIN_ROWS = _register(ConfigEntry(
    "spark.tpu.fusion.minRows", 1 << 17,
    "Partition tile-capacity floor for running the whole-stage FUSED "
    "program. A fused program is captured per (stage structure, "
    "signature, capacity) while the operator-at-a-time kernels are "
    "shared across query structures: below this many rows the capture "
    "costs more than the dispatches it saves, so small partitions take "
    "the unfused kernels (same plan, runtime dispatch). 0 = always "
    "fuse.", int))

FUSION_DENSE_KEYS = _register(ConfigEntry(
    "spark.tpu.fusion.denseKeys", True,
    "Allow the fused partial aggregate to take the dense-range direct "
    "scatter path when the grouping key is a pass-through integral column "
    "whose (memoized) range fits a capacity bucket.", _bool))

FUSION_EXCHANGE = _register(ConfigEntry(
    "spark.tpu.fusion.exchange", True,
    "Exchange map-side fusion: a stage whose terminal is a shuffle "
    "exchange runs its filter/project pipeline AND the partition-id "
    "computation (hash/range/round-robin) as ONE program per map batch "
    "that emits the pid-grouped pipeline output; shuffle writes consume "
    "it directly: no intermediate materialized batch, one dispatch per "
    "map batch. Requires spark.tpu.fusion.enabled; subject to the "
    "spark.tpu.fusion.minRows size gate.", _bool))

COMPILE_TIER = _register(ConfigEntry(
    "spark.tpu.compile.tier", "auto",
    "Compilation tier: 'whole' runs the query, exchanges lowered to "
    "in-program gathers, as ONE program per query step "
    "(physical/whole_query.py: a captured CUDA graph on the card, eager "
    "on the CPU); 'stage' runs one program per stage per batch "
    "(whole-stage fusion, with the per-partition minRows runtime gate as "
    "the stage->operator fallback); 'operator' forces the shared "
    "operator-at-a-time kernels (the differential oracle). 'auto' "
    "(default) chooses as the reference's cost model does: 'whole' for a "
    "plan with exchange round-trips whose operators all lower, whose "
    "leaf rows are known and whose volume reaches "
    "spark.tpu.compile.whole.minRows scaled by program depth, else "
    "'stage', with the reason on the plan's tier decision. 'mesh-whole' "
    "raises NotPortedError (physical/mesh_whole.py).", str))

WHOLE_MIN_ROWS = _register(ConfigEntry(
    "spark.tpu.compile.whole.minRows", 1 << 17,
    "Leaf-row volume floor for the auto tier to choose whole-query "
    "compilation (scaled up with program depth: deeper programs need "
    "more volume to amortize the bigger capture). The whole-query analog "
    "of spark.tpu.fusion.minRows. Forced tier=whole ignores the floor "
    "(structural admission still applies).", int))

ADAPTIVE_PARQUET_STATS = _register(ConfigEntry(
    "spark.tpu.adaptive.parquetStats", True,
    "Admit external parquet scans to the whole compile tier from footer "
    "statistics (row-group row counts) instead of excluding every "
    "external scan.", _bool))

ADAPTIVE_ENABLED = _register(ConfigEntry(
    "spark.sql.adaptive.enabled", True,
    "Re-optimize at exchange boundaries from runtime stats: the stage "
    "scheduler demotes a shuffled join whose materialised build side is "
    "under the broadcast threshold (exec/scheduler.py, "
    "physical/adaptive.py).", _bool))

COALESCE_PARTITIONS_ENABLED = _register(ConfigEntry(
    "spark.sql.adaptive.coalescePartitions.enabled", True,
    "AQE partition coalescing: blocking consumers of an exchange merge "
    "adjacent small partitions.", _bool))

ADVISORY_PARTITION_BYTES = _register(ConfigEntry(
    "spark.sql.adaptive.advisoryPartitionSizeInBytes", 64 * 1024 * 1024,
    "Target partition size for AQE coalescing.", int))

SKEW_JOIN_ENABLED = _register(ConfigEntry(
    "spark.sql.adaptive.skewJoin.enabled", True,
    "Split a shuffled join's probe partitions over 4x the median.", _bool))

BLOOM_JOIN_FILTER = _register(ConfigEntry(
    "spark.tpu.join.runtimeFilter.bloom", False,
    "Bloom-filter the probe rows of an inner or semi hash join against a "
    "bitset of the build keys' hashes before the probe (the hand-written "
    "kernel of ops/bloom.py).", _bool))

MINMAX_JOIN_FILTER = _register(ConfigEntry(
    "spark.tpu.join.runtimeFilter", False,
    "Min-max runtime join filter on a single integral, date or decimal "
    "key of an inner or semi hash join.", _bool))

JOIN_RF_MIN_CAPACITY = _register(ConfigEntry(
    "spark.tpu.join.runtimeFilter.minCapacity", 1 << 20,
    "Probe batches below this capacity skip the runtime min-max join "
    "filter (the probe is already cheap).", int))

MEMORY_BUDGET = _register(ConfigEntry(
    "spark.tpu.memory.budget", 0,
    "Per-query device-memory admission budget in bytes (0 = unlimited). "
    "Not ported: setting it raises (see UNPORTED_KEYS); the whole-tier "
    "chooser reads the default, so its over-budget fallback never "
    "fires.", int))

# keys of the reference's fusion, tier and memory families the port does
# not implement: setting one raises rather than being ignored
UNPORTED_KEYS = {
    "spark.tpu.fusion.mesh": "mesh stage fusion (parallel/mesh_exchange.py)",
    "spark.tpu.memory.budget":
        "the memory budget's pre-flight (analysis/plan_lint.py memory "
        "model, obs/resources.py MemoryBudgetExceeded)",
}

# switches of the reference's adaptive family that are off by default and
# not ported: setting one to true raises, false is the default's behaviour
UNPORTED_WHEN_TRUE = {
    "spark.tpu.adaptive.runtimeFilter":
        "the adaptive runtime filter (physical/adaptive.py "
        "install_runtime_filters, A6)",
    "spark.tpu.adaptive.readmission":
        "stage-boundary tier re-admission (physical/adaptive.py "
        "maybe_readmit, A6)",
}

WAREHOUSE_DIR = _register(ConfigEntry(
    "spark.sql.warehouse.dir", "",
    "Directory of the persistent warehouse: saved tables live there as "
    "Parquet (plan/warehouse.py). Empty: no warehouse.", str))

DEVICE = _register(ConfigEntry(
    "spark.torch.device", "cuda",
    "torch device the session runs on: 'cuda' (default; raises when no "
    "card is present) or 'cpu'. There is no fallback between them.", str))


def _check_ported(key: str, value: Any = None) -> None:
    what = UNPORTED_KEYS.get(key)
    if what is None and _bool(value):
        what = UNPORTED_WHEN_TRUE.get(key)
    if what is not None:
        from .errors import NotPortedError

        raise NotPortedError(f"{key}: {what}")


class SQLConf:
    """Session-local config with string overrides over typed defaults.

    Thread-safe; `get` accepts either a ConfigEntry or a string key.
    """

    def __init__(self, overrides: dict[str, Any] | None = None):
        self._lock = threading.RLock()
        self._values: dict[str, Any] = dict(overrides or {})
        for k, v in self._values.items():
            _check_ported(k, v)

    def unset(self, key: str | ConfigEntry) -> "SQLConf":
        k = key.key if isinstance(key, ConfigEntry) else key
        with self._lock:
            self._values.pop(k, None)
        return self

    def set(self, key: str | ConfigEntry, value: Any) -> "SQLConf":
        k = key.key if isinstance(key, ConfigEntry) else key
        _check_ported(k, value)
        with self._lock:
            self._values[k] = value
        return self

    def overrides(self) -> dict:
        """Snapshot of the explicit overrides."""
        with self._lock:
            return dict(self._values)

    def get(self, key: str | ConfigEntry, default: Any = None) -> Any:
        entry = key if isinstance(key, ConfigEntry) else _REGISTRY.get(key)
        k = entry.key if entry else key
        with self._lock:
            if k in self._values:
                raw = self._values[k]
                if entry is not None and isinstance(raw, str):
                    return entry.value_type(raw)
                return raw
        if entry is not None:
            return entry.default
        return default

    @property
    def shuffle_partitions(self) -> int:
        return int(self.get(SHUFFLE_PARTITIONS))

    @property
    def batch_capacity(self) -> int:
        return int(self.get(BATCH_CAPACITY))


def registry() -> dict[str, ConfigEntry]:
    return dict(_REGISTRY)
