"""Typed configuration (``spark.rapids.tpu.*``), the entries the port reads.

Counterpart of ``spark_rapids_tpu/conf.py``: the same keys, defaults and
validation, so one conf dict drives both packages. Unknown
``spark.rapids.tpu.*`` keys are rejected, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

_REGISTRY: Dict[str, "ConfEntry"] = {}


@dataclasses.dataclass
class ConfEntry:
    key: str
    default: Any
    doc: str
    conf_type: type
    valid_values: Optional[Sequence[Any]] = None
    #: None when ``v`` is allowed, else the reason it is not
    check: Optional[Callable[[Any], Optional[str]]] = None

    def convert(self, raw: Any) -> Any:
        if raw is None:
            return self.default
        if self.conf_type is bool:
            if isinstance(raw, bool):
                v: Any = raw
            else:
                s = str(raw).strip().lower()
                if s not in ("true", "false"):
                    raise ValueError(f"{self.key}: expected boolean, "
                                     f"got {raw!r}")
                v = s == "true"
        elif self.conf_type in (int, float):
            v = self.conf_type(raw)
        else:
            v = str(raw)
        if self.valid_values is not None and v not in self.valid_values:
            raise ValueError(f"{self.key}: {v!r} not in allowed values "
                             f"{list(self.valid_values)}")
        if self.check is not None:
            why = self.check(v)
            if why is not None:
                raise ValueError(f"{self.key}: {why}")
        return v


def conf(key, default, doc, valid_values=None, check=None,
         conf_type=None) -> ConfEntry:
    if key in _REGISTRY:
        raise ValueError(f"duplicate conf key {key}")
    entry = ConfEntry(key, default, doc, conf_type or type(default),
                      valid_values, check)
    _REGISTRY[key] = entry
    return entry


def _positive(v) -> Optional[str]:
    return None if v > 0 else "must be positive"


# ---------------------------------------------------------------------------
# General: the session, the planner's tagging and its type checks
# ---------------------------------------------------------------------------
SQL_ENABLED = conf(
    "spark.rapids.tpu.sql.enabled", True,
    "Enable or disable TPU acceleration of SQL operators entirely.")
EXPLAIN = conf(
    "spark.rapids.tpu.sql.explain", "NONE",
    "Explain why parts of a query were or were not placed on the TPU. "
    "NONE/ALL/NOT_ON_TPU.", valid_values=("NONE", "ALL", "NOT_ON_TPU"))
ENABLE_CAST_STRING_TO_FLOAT = conf(
    "spark.rapids.tpu.sql.castStringToFloat.enabled", False,
    "String-to-float casts can differ in last-ulp from Spark.")
ENABLE_CAST_STRING_TO_TIMESTAMP = conf(
    "spark.rapids.tpu.sql.castStringToTimestamp.enabled", False,
    "String-to-timestamp casts support a subset of formats.")
ENABLE_CAST_FLOAT_TO_TIMESTAMP = conf(
    "spark.rapids.tpu.sql.castFloatToTimestamp.enabled", False,
    "Float-to-timestamp casts round differently from Spark.")
ENABLE_CAST_STRING_TO_INTEGER = conf(
    "spark.rapids.tpu.sql.castStringToInteger.enabled", False,
    "String-to-integral casts can differ from Spark on malformed-input "
    "edge cases.")
DECIMAL_ENABLED = conf(
    "spark.rapids.tpu.sql.decimalType.enabled", True,
    "Enable DECIMAL(<=18) columns on the device (stored as int64 "
    "unscaled).")
UDF_COMPILER_ENABLED = conf(
    "spark.rapids.tpu.sql.udfCompiler.enabled", False,
    "Compile Python scalar UDF bytecode into engine expression trees. "
    "The compiler is not ported yet: a plan with a PythonUDF raises when "
    "this is on.")
MAX_READER_BATCH_SIZE_ROWS = conf(
    "spark.rapids.tpu.sql.reader.batchSizeRows", 1 << 20,
    "Soft cap on rows per batch produced by scans.", check=_positive)
MAX_READER_BATCH_SIZE_BYTES = conf(
    "spark.rapids.tpu.sql.reader.batchSizeBytes", 2147483647,
    "Soft cap on bytes per batch produced by scans.", check=_positive)
AUTO_BROADCAST_JOIN_THRESHOLD = conf(
    "spark.rapids.tpu.sql.autoBroadcastJoinThreshold", 10 * 1024 * 1024,
    "Build sides estimated below this size broadcast instead of paying two "
    "hash exchanges: a join with a side of more than one partition runs "
    "as a broadcast hash join (exec/exchange.TpuBroadcastExchangeExec) "
    "when its build side's estimate is at most this, else co-partitions "
    "both sides through hash exchanges. -1 disables.",
    conf_type=int)
SHUFFLE_PARTITIONS = conf(
    "spark.rapids.tpu.sql.shuffle.partitions", 0,
    "Number of reduce partitions for exchanges; 0 keeps the child's "
    "partition count (reference: spark.sql.shuffle.partitions).")
AQE_ENABLED = conf(
    "spark.rapids.tpu.sql.adaptive.enabled", True,
    "Re-plan exchange reads from materialized per-partition stats: "
    "coalesce small partitions, split skewed join probes (reference: "
    "GpuCustomShuffleReaderExec + ShuffledBatchRDD partition specs).")
AQE_TARGET_ROWS = conf(
    "spark.rapids.tpu.sql.adaptive.targetPartitionRows", 1 << 20,
    "Advisory rows per post-AQE partition (coalesce/split target).",
    check=_positive)
AQE_SKEW_FACTOR = conf(
    "spark.rapids.tpu.sql.adaptive.skewedPartitionFactor", 4.0,
    "A join probe partition is skewed when its rows exceed this multiple "
    "of the median (and the target rows).")
SHUFFLE_MESH_SIZE = conf(
    "spark.rapids.tpu.shuffle.meshSize", 0,
    "Number of devices in the exchange mesh (0 = all local devices). "
    "Superseded by spark.rapids.tpu.mesh.devices when both are set.")
MESH_DEVICES = conf(
    "spark.rapids.tpu.mesh.devices", 0,
    "Shard count for mesh execution (parallel/mesh.get_mesh): caps or "
    "forces how many local devices the mesh spans (0 = all). A value "
    "above the visible device count raises at mesh construction instead "
    "of silently truncating; meshes are memoized per count so every "
    "stage at one width shares a single Mesh.",
    check=lambda v: None if v >= 0 else "must be >= 0")
MESH_WHOLE_PLAN = conf(
    "spark.rapids.tpu.shuffle.mesh.wholePlan.enabled", True,
    "Absorb fixed-width filter/project chains between a mesh stage and "
    "its source INTO the stage's per-shard program (the execs' "
    "lower_batch hooks run per shard), and feed the stage from a sharded "
    "scan (io/mesh_stage.py) when the source supports it. Off: children "
    "execute on the plan's device and staging gathers their batches "
    "onto the shards.")
MESH_EXCHANGE_BUCKET_FACTOR = conf(
    "spark.rapids.tpu.shuffle.mesh.exchangeBucketFactor", 2.0,
    "Mesh SORT exchange granule as a multiple of the fair per-target "
    "share (cap / n_shards): sampled range bounds spread rows roughly "
    "evenly, so a ~2x granule keeps the all_to_all receive surface "
    "O(cap) instead of O(n_shards x cap); a skewed distribution "
    "overflows the block and the stage retries with the granule "
    "doubled. 0 disables (always-fits full-capacity granule).",
    check=lambda v: None if v >= 0 else "must be >= 0")
MESH_AGG_EXCHANGE_CAP = conf(
    "spark.rapids.tpu.shuffle.mesh.aggExchangeCapacity", 4096,
    "Starting per-shard row capacity for the mesh aggregate's post-PARTIAL "
    "all_to_all: partial aggregates are compacted and sliced to this many "
    "groups per shard before they cross to their target shard, so the "
    "exchange surface is sized to the GROUP cardinality, not the input "
    "row capacity. A shard with more groups than the cap reports "
    "overflow and the stage retries with the cap doubled.",
    check=_positive)
SHUFFLE_MODE = conf(
    "spark.rapids.tpu.shuffle.mode", "auto",
    "Exchange lowering: 'ici' lowers shuffle-bounded stages (aggregate, "
    "sort, equi-join, window) to the mesh stages of exec/mesh.py, one "
    "program per shard over the device mesh with the collectives of "
    "parallel/collective.py between them; 'host' uses the single-process "
    "exchange (exec/exchange.py); 'auto' picks ici when more than one "
    "device is visible (parallel/mesh.device_count: the CUDA cards, or "
    "the SRTPU_TORCH_VIRTUAL_DEVICES shards).",
    valid_values=("auto", "host", "ici"))
SHUFFLE_TRANSPORT_CLASS = conf(
    "spark.rapids.tpu.shuffle.transport.class", "device",
    "Transport for exchange pieces: 'device' (pieces stay on the card as "
    "slices of the partitioned batch), 'host' (serialized host bytes in "
    "the TPUB wire format, the fallback-serializer analog), or 'network' "
    "(the TCP block server/client of shuffle/network.py across worker "
    "processes, the RapidsShuffleServer/Client analog: this process's "
    "server holds its map output and fetches merge every peer's "
    "pieces).",
    valid_values=("device", "host", "network"))
SHUFFLE_NETWORK_PEERS = conf(
    "spark.rapids.tpu.shuffle.network.peers", "",
    "Comma-separated host:port list of the OTHER workers' shuffle "
    "servers; fetches merge local pieces with every peer's (reference: "
    "RapidsCachingReader splits local catalog hits from transport "
    "fetches, RapidsCachingReader.scala:60-155).")
SHUFFLE_NETWORK_LISTEN_PORT = conf(
    "spark.rapids.tpu.shuffle.network.listenPort", 0,
    "TCP port for this process's shuffle block server; 0 picks an "
    "ephemeral port (the chosen address is in the transport's "
    "server.address).")
SHUFFLE_COMPRESSION_CODEC = conf(
    "spark.rapids.tpu.shuffle.compression.codec", "none",
    "Codec for host-path shuffle payloads: none/zstd/lz4. zstd needs the "
    "zstandard module; lz4 is the native C++ block codec "
    "(native/src/lz4.cpp, the nvcomp-LZ4 analog) and requires the "
    "g++-built library (spark_rapids_tpu_torch/native.py).",
    valid_values=("none", "zstd", "lz4"))
SHUFFLE_PARTITIONING_MAX_PARTITIONS = conf(
    "spark.rapids.tpu.shuffle.maxPartitions", 1 << 16,
    "Upper bound on shuffle partitions.", check=_positive)
TEST_CONF = conf(
    "spark.rapids.tpu.sql.test.enabled", False,
    "Fail instead of falling back to CPU when an operator is unsupported.")
TEST_ALLOWED_NONTPU = conf(
    "spark.rapids.tpu.sql.test.allowedNonTpu", "",
    "Comma-separated operator class names allowed to stay on CPU when "
    "test.enabled is set.")

# ---------------------------------------------------------------------------
# IO: the parquet scan and its device cache
# ---------------------------------------------------------------------------
PARQUET_ENABLED = conf(
    "spark.rapids.tpu.sql.format.parquet.enabled", True,
    "Enable the device parquet scan.")
PARQUET_READER_TYPE = conf(
    "spark.rapids.tpu.sql.format.parquet.reader.type", "AUTO",
    "PERFILE, COALESCING, MULTITHREADED or AUTO.",
    valid_values=("AUTO", "PERFILE", "COALESCING", "MULTITHREADED"))
PARQUET_MULTITHREAD_READ_NUM_THREADS = conf(
    "spark.rapids.tpu.sql.format.parquet.multiThreadedRead.numThreads", 4,
    "Threads for the cloud multithreaded reader.", check=_positive)
PARQUET_DEVICE_DECODE = conf(
    "spark.rapids.tpu.sql.format.parquet.deviceDecode.enabled", True,
    "Decode parquet pages on the device (dictionary/RLE expansion as "
    "torch ops) so the host uploads encoded bytes instead of raw "
    "columns. Columns with unsupported encodings fall back to the host "
    "arrow decoder per column.")
PARQUET_PIPELINE_MAX_IN_FLIGHT = conf(
    "spark.rapids.tpu.sql.format.parquet.pipeline.maxInFlight", 8,
    "Row groups the pipelined device-decode reader keeps in flight: while "
    "row group N's upload and device unpack run, up to this many row "
    "groups (N included) host-decode on the shared decode pool.",
    check=_positive)
PARQUET_DICT_STRINGS = conf(
    "spark.rapids.tpu.sql.format.parquet.dictStrings.enabled", True,
    "Keep dictionary-encoded BYTE_ARRAY columns encoded on the device "
    "(late materialization): int32 codes plus the file's dictionary, "
    "string kernels running once per dictionary entry. With it off, such "
    "chunks decode to the expanded Arrow layout.")
SCAN_DEVICE_CACHE = conf(
    "spark.rapids.tpu.scan.deviceCache.enabled", True,
    "Keep decoded scan columns resident in device memory keyed by "
    "(file, mtime, size, row group) so hot files upload once; evicted "
    "LRU under scan.deviceCache.maxBytes.")
SCAN_DEVICE_CACHE_MAX_BYTES = conf(
    "spark.rapids.tpu.scan.deviceCache.maxBytes", 2 << 30,
    "LRU byte budget for the device scan cache.", check=_positive)
CLOUD_SCHEMES = conf(
    "spark.rapids.tpu.cloudSchemes", "abfs,abfss,dbfs,gs,s3,s3a,s3n,wasbs",
    "URI schemes treated as high-latency cloud stores.")
CSV_ENABLED = conf(
    "spark.rapids.tpu.sql.format.csv.enabled", True,
    "Enable the device CSV scan (not ported yet).")
ORC_ENABLED = conf(
    "spark.rapids.tpu.sql.format.orc.enabled", True,
    "Enable the device ORC scan (not ported yet).")


IMPROVED_FLOAT_OPS = conf(
    "spark.rapids.tpu.sql.variableFloatAgg.enabled", False,
    "Allow floating-point aggregations whose result may differ in "
    "last-ulp ordering from CPU Spark.")
SHAPE_BUCKET_MIN = conf(
    "spark.rapids.tpu.sql.shapeBucket.minRows", 128,
    "Row counts are padded up to power-of-two buckets >= this.",
    check=_positive)
AGG_STRATEGY = conf(
    "spark.rapids.tpu.sql.agg.strategy", "AUTO",
    "Lowering strategy for grouped-aggregation reductions. SCATTER "
    "(torch index_add_/scatter_reduce_), MATMUL (one-hot limb matmuls in "
    "full f32) and PALLAS (the hand-written bucket kernels K1-K3) reduce "
    "over the hash-bucket tiers; SORT radix-sorts by the keys and "
    "reduces sums and counts as prefix differences; RADIX reduces every "
    "aggregate over the sorted order on the hand-written RADIX segment "
    "kernel, which PALLAS's sort fallback runs too. AUTO picks PALLAS on "
    "a CUDA device when the plan has no exact float sum, else SCATTER; "
    "on the CPU it picks RADIX at or above 2^21 rows with no exact float "
    "sum, else SCATTER, as the reference does.",
    valid_values=("AUTO", "MATMUL", "SCATTER", "SORT", "RADIX", "PALLAS"))
AGG_FUSED_PLAN = conf(
    "spark.rapids.tpu.sql.agg.fusedPlan", "AUTO",
    "Run the aggregate's whole update+merge(+result projection) over all "
    "of a partition's input batches as ONE call: every batch's update, a "
    "padded concat of the partials at capacity and the merge, with no "
    "host sync between them beyond the tiers' own. ON always fuses "
    "(fixed-width buffer schemas only), OFF runs one update per batch "
    "plus a separate merge, AUTO fuses except multi-batch runs on the "
    "CPU (the fused merge stacks partials at capacity to stay sync-free, "
    "the right trade only on a device; the CPU merges at real row "
    "counts instead).", valid_values=("AUTO", "ON", "OFF"))
STAGE_FUSION = conf(
    "spark.rapids.tpu.sql.stageFusion", "AUTO",
    "Fuse parquet scan->aggregate stages into ONE call: each row group's "
    "page decode runs inside the aggregate's fused update+merge. ON "
    "always fuses, OFF never does, AUTO fuses except on the CPU: the "
    "fusion saves the separate decode's batches and dispatches, but it "
    "decodes the pages again on EVERY execution (the stage cache holds "
    "the staged arguments, not decoded batches). On the CPU the separate "
    "decode plus the device scan cache decode once and reuse, so AUTO "
    "prefers that.", valid_values=("AUTO", "ON", "OFF"))
ANALYSIS_ENABLED = conf(
    "spark.rapids.tpu.sql.analysis.enabled", True,
    "Run the static plan analyzer (plugin/plananalysis.py) and render its "
    "report — per-operator batch layouts, nullability, predicted peak "
    "device-memory footprint, and the reference's forecast of distinct "
    "compile signatures per pipeline cache site — in explain(). The "
    "analysis walks the bound plan without lowering or executing "
    "anything. With the event log, the live plane or serving on, each "
    "query is analyzed too (the plan_analysis event, the progress "
    "denominators, the admission forecast).")
ANALYSIS_CROSS_CHECK = conf(
    "spark.rapids.tpu.sql.analysis.crossCheck.enabled", False,
    "Debug: analyze every query and hold the forecasts to what ran — "
    "measured bytesTouched never exceeds the analyzer's byte bound, and "
    "nullability-elided execution matches the mask-carrying path "
    "exactly. The reference's third check (compile-cache misses against "
    "the compile forecast) has no counterpart: eager PyTorch compiles no "
    "programs.")
ANALYSIS_NULL_ELISION = conf(
    "spark.rapids.tpu.sql.analysis.nullElision.enabled", True,
    "Elide validity-plane reads for statically NON_NULL columns at "
    "fused-pipeline entries: a declared non-null column's validity is "
    "exactly the liveness mask (padding rows invalid, live rows valid), "
    "so the mask derived from the row count replaces the stored plane "
    "bit for bit. Disable to force the mask-carrying path.")


JOIN_PALLAS_PROBE = conf(
    "spark.rapids.tpu.sql.join.pallasProbe.enabled", False,
    "Legacy toggle: lower single-fixed-width-key hash-join probes to the "
    "hand-written probe kernel (K4). Superseded by "
    "spark.rapids.tpu.sql.join.strategy=PALLAS; when join.strategy is "
    "AUTO, this flag still selects the PALLAS tier for the GENERAL probe "
    "path while the DIRECT fused fast path keeps pre-empting it where "
    "its table fits. A forced join.strategy=PALLAS disables the fast "
    "path too.")
JOIN_STRATEGY = conf(
    "spark.rapids.tpu.sql.join.strategy", "AUTO",
    "Lowering strategy for equi-join probes (ops/join.py). SEARCH runs "
    "the vectorized lexicographic binary search over the sorted build "
    "words; DIRECT builds direct-address (first, count) tables when the "
    "single fixed-width key's value range fits 4x the build capacity "
    "(else SEARCH), and the whole join can then fuse into its consumer "
    "chain; RADIX co-sorts build and probe rows by the shared "
    "order-preserving key words and derives every [lo, hi) range from "
    "prefix sums over that order; PALLAS runs the probe as the "
    "hand-written kernel K4 (csrc/join_kernels.cu; its plain version on "
    "the CPU), keys wider than two words going to SEARCH. The tiers "
    "agree on match counts and on lo wherever a row matched; an "
    "unmatched live row reports its insertion point under SEARCH and "
    "RADIX and (0, 0) under DIRECT and PALLAS. AUTO picks per plan from "
    "the build capacity, key widths and the build's device, against "
    "spark.rapids.tpu.roofline.peakHbmGBps, and records its reason in "
    "describe().",
    valid_values=("AUTO", "SEARCH", "DIRECT", "RADIX", "PALLAS"))


def _non_negative(v) -> Optional[str]:
    return None if v >= 0 else "must be >= 0"


ROOFLINE_PEAK_HBM_GBPS = conf(
    "spark.rapids.tpu.roofline.peakHbmGBps", 0.0,
    "Peak device-memory bandwidth (GB/s) the join chooser prices its "
    "tiers at. 0.0 (the default) picks a per-device peak "
    "(:data:`DEVICE_PEAKS`).", check=_non_negative)
ROOFLINE_PEAK_TFLOPS = conf(
    "spark.rapids.tpu.roofline.peakTflops", 0.0,
    "Peak compute throughput (TFLOP/s). Kept for parity with the "
    "reference's conf keys; no chooser of the port reads it yet.",
    check=_non_negative)

#: per-device-type peak device-memory GB/s when peakHbmGBps is 0.0.
#: "cuda" is one NVIDIA H100 SXM at its 700 W limit, from NVIDIA's H100
#: data sheet: 3.35 TB/s of HBM3. "cpu" is the reference's nominal figure
#: for its CPU backend, kept so the CPU chooser prices the same way.
DEVICE_PEAKS: Dict[str, float] = {"cuda": 3350.0, "cpu": 100.0}


def roofline_peak_bps(rconf: "RapidsConf", device_type: str) -> float:
    """Peak bytes/s for the join chooser: the conf-declared peak when
    set, else the device type's default (reference
    ``exec/aggregate._roofline_peaks``)."""
    gbps = rconf.get(ROOFLINE_PEAK_HBM_GBPS) or DEVICE_PEAKS.get(
        device_type, DEVICE_PEAKS["cpu"])
    return gbps * 1e9


# ---------------------------------------------------------------------------
# Memory: the semaphore, the spill catalog, the ledger, OOM retry and the
# fault injector (reference ``conf.py:188-265``, ``memory/catalog.py``,
# ``memory/ledger.py``, ``memory/retry.py`` and ``faults.py``)
# ---------------------------------------------------------------------------
def _fraction(v) -> Optional[str]:
    return None if 0.0 <= v <= 1.0 else "must be in [0, 1]"


CONCURRENT_TPU_TASKS = conf(
    "spark.rapids.tpu.sql.concurrentTpuTasks", 1,
    "Number of tasks that may hold the TPU concurrently "
    "(reference GpuSemaphore: GpuSemaphore.scala:27-66).", check=_positive)
SEMAPHORE_ACQUIRE_TIMEOUT_MS = conf(
    "spark.rapids.tpu.sql.semaphore.acquireTimeoutMs", 0,
    "Give up acquiring the TPU concurrency semaphore after this many "
    "milliseconds and raise TpuSemaphoreTimeout naming the current "
    "holder threads and the wait duration, instead of blocking forever. "
    "0 (the default) waits indefinitely, matching the reference "
    "GpuSemaphore.", conf_type=int, check=_non_negative)
HBM_POOL_FRACTION = conf(
    "spark.rapids.tpu.memory.hbm.allocFraction", 0.9,
    "Fraction of HBM to consider available to the pool.", check=_fraction)
HBM_RESERVE = conf(
    "spark.rapids.tpu.memory.hbm.reserve", 1 << 28,
    "Bytes of HBM to hold back from the pool for XLA scratch.",
    check=_positive)
HOST_SPILL_STORAGE_SIZE = conf(
    "spark.rapids.tpu.memory.host.spillStorageSize", 1 << 30,
    "Bytes of host memory for spilled buffers before going to disk.",
    check=_positive)
SPILL_ENABLED = conf(
    "spark.rapids.tpu.memory.spill.enabled", True,
    "Enable tiered DEVICE->HOST->DISK spill of cached batches.")
MEMORY_DEBUG = conf(
    "spark.rapids.tpu.memory.debug", False,
    "Log allocation/spill events (reference: spark.rapids.memory.gpu.debug).")
HBM_BUDGET_BYTES = conf(
    "spark.rapids.tpu.memory.hbm.budgetBytes", 0,
    "Explicit spill budget for catalog-tracked device buffers; 0 derives "
    "it from allocFraction * device memory (or unlimited when the backend "
    "reports no memory stats).")
LEAK_SENTINEL_ENABLED = conf(
    "spark.rapids.tpu.memory.ledger.leakSentinel.enabled", True,
    "Flag spillable buffers that outlive their owning query at query "
    "end. Requires the ledger.")
OOM_RETRY_ENABLED = conf(
    "spark.rapids.tpu.memory.oomRetry.enabled", True,
    "Wrap per-batch exec dispatches in the OOM retry + split-and-retry "
    "harness (memory/retry.py): a device allocation failure spills "
    "spillable buffers, drops scan-cache residency, and re-attempts "
    "with backoff; exhausted retries split the input batch in half and "
    "recurse (bounded depth), so operators complete on half-capacity "
    "batches instead of dying. Off restores the raw-failure behavior.")
OOM_RETRY_MAX_ATTEMPTS = conf(
    "spark.rapids.tpu.memory.oomRetry.maxAttempts", 2,
    "Attempts per split level before the harness escalates to "
    "split-and-retry (each failed attempt spills + backs off first).",
    check=_positive)
OOM_RETRY_BACKOFF_MS = conf(
    "spark.rapids.tpu.memory.oomRetry.backoffMs", 5,
    "Base backoff before re-attempting after an OOM (doubles per "
    "attempt; gives concurrent queries a window to release memory). "
    "0 disables the sleep.", conf_type=int, check=_non_negative)
OOM_RETRY_MAX_SPLIT_DEPTH = conf(
    "spark.rapids.tpu.memory.oomRetry.maxSplitDepth", 4,
    "Split-and-retry recursion bound: each level halves the batch, so "
    "depth 4 reaches 1/16 capacity before TpuSplitAndRetryOOM surfaces.",
    check=_non_negative)
FAULTS_ENABLED = conf(
    "spark.rapids.tpu.test.faults.enabled", False,
    "Install the deterministic fault injector (chaos testing; see the "
    "channel confs test.faults.oom/transfer/fetch). Off, the default, "
    "keeps every injection site a single module-global boolean read. "
    "Setting any channel spec implies this key.")
FAULTS_SEED = conf(
    "spark.rapids.tpu.test.faults.seed", 0,
    "Seed for the '?K' spec form: the firing arrival is derived "
    "deterministically from (seed, channel, site), so a chaos schedule "
    "replays exactly.")
FAULTS_OOM = conf(
    "spark.rapids.tpu.test.faults.oom", "",
    "Synthetic device-OOM specs for the retry-harness channel: "
    "'site[@N|%K|>C|?K]' entries, comma-separated; sites are exec node "
    "names (fnmatch patterns allowed).")
FAULTS_TRANSFER = conf(
    "spark.rapids.tpu.test.faults.transfer", "",
    "Host-link transfer failure specs (site 'packed_upload').")
FAULTS_FETCH = conf(
    "spark.rapids.tpu.test.faults.fetch", "",
    "Shuffle network fetch failure specs (site 'network_fetch'); the "
    "injected error is a ConnectionError, so the client's backoff retry "
    "path handles it like a real peer reset.")
LEDGER_ENABLED = conf(
    "spark.rapids.tpu.memory.ledger.enabled", True,
    "Per-buffer HBM ledger (owner attribution, lifecycle events, leak "
    "sentinel). Only ever active while the event log or live metrics "
    "are on (or a bench/test force-arms it) — with both off the ledger "
    "costs one boolean read per buffer registration.")


# ---------------------------------------------------------------------------
# Observability: operator tracing, the device lane, the event log
# (``events.py``), the live plane (``obs/``: metrics registry, /metrics +
# /status HTTP exporter, watchdog); reference ``conf.py:201-214`` and
# ``:555-625``, ``events.py:35-63``
# ---------------------------------------------------------------------------
ENABLE_TRACE = conf(
    "spark.rapids.tpu.sql.trace.enabled", False,
    "Wrap operator hot sections in torch.profiler record_function ranges "
    "(reference: NvtxWithMetrics.scala).")
METRICS_DEVICE_SYNC = conf(
    "spark.rapids.tpu.metrics.deviceSync.enabled", False,
    "Device-accurate operator timing: every operator blocks until its "
    "output batch's device work is done and records the wait in its "
    "opTimeDevice metric (reference: the GpuMetric op-time/CUDA-event "
    "pairs in NvtxWithMetrics.scala). With the conf on for the whole "
    "plan, upstream outputs are already fenced when an operator "
    "dispatches, so each wait isolates that operator's own device work. "
    "Costs one host sync per batch per operator — profiling runs only; "
    "read the result with TpuSession.explain_metrics().")
ANALYSIS_STORM_THRESHOLD = conf(
    "spark.rapids.tpu.sql.analysis.recompileStorm.threshold", 8,
    "Warn in explain() when the analyzer forecasts at least this many "
    "distinct compile signatures for ONE pipeline cache site — the "
    "static recompile-storm detector (the profiler's cache-miss footer "
    "reports the same storms after the fact). The port compiles no "
    "programs; the watchdog's recompile-storm rule reads the count.",
    check=_positive)
EVENT_LOG_ENABLED = conf(
    "spark.rapids.tpu.eventLog.enabled", False,
    "Enable the structured query event log (typed JSONL events covering "
    "the full query lifecycle: plan tagging, analysis forecasts, per-op "
    "spans, compile misses, transfers, spills, shuffle, scan cache). With "
    "no eventLog.dir the events land only in the in-memory ring buffer "
    "backing TpuSession.export_trace(); setting eventLog.dir implies this "
    "key. Off by default — the emit fast path is a single boolean check.")
EVENT_LOG_DIR = conf(
    "spark.rapids.tpu.eventLog.dir", "",
    "Directory for JSONL event-log files (one tpu-events-<pid>-<n>.jsonl "
    "per session, append-only, thread-safe). Setting a directory turns "
    "event logging on. Consume the files offline with "
    "tools/tpu_profile.py, or open TpuSession.export_trace() output in "
    "Perfetto.")
EVENT_LOG_RING_SIZE = conf(
    "spark.rapids.tpu.eventLog.ringBuffer.size", 65536,
    "Events retained in the in-memory ring buffer that backs "
    "TpuSession.export_trace() (oldest dropped first). The JSONL sink is "
    "unbounded; the ring only bounds in-process memory.")
EVENT_LOG_FLIGHT_RECORDER = conf(
    "spark.rapids.tpu.eventLog.flightRecorder.enabled", False,
    "Run the event log as a flight recorder: with eventLog.dir set, "
    "events land ONLY in the in-memory ring buffer (no streaming JSONL "
    "file), and each watchdog alert episode (obs/watchdog.py) dumps the "
    "ring to eventLog.dir as one tpu-flightrec-<pid>-<episode>.jsonl — "
    "post-hoc diagnosis of a misbehaving run without the volume of full "
    "logging. Requires the watchdog (spark.rapids.tpu.watchdog.enabled) "
    "for the trigger; TpuSession.export_trace() still reads the ring.")
LIVE_METRICS_ENABLED = conf(
    "spark.rapids.tpu.metrics.live.enabled", False,
    "Install the process-global live metrics registry (obs/): per-op "
    "host/device time and bytes, the BufferCatalog HBM watermark, "
    "shuffle transport traffic, scan-cache hit rate, per-query "
    "progress. Implied by metrics.http.enabled and watchdog.enabled. "
    "Off by default — the engine's emit fast path is a single boolean "
    "check (the event-log zero-overhead contract).")
METRICS_HTTP_ENABLED = conf(
    "spark.rapids.tpu.metrics.http.enabled", False,
    "Start the stdlib-HTTP exporter daemon thread serving /metrics "
    "(Prometheus text exposition 0.0.4 of the whole metric catalog) and "
    "/status (JSON: live queries with per-op progress, HBM watermark vs "
    "budget, watchdog alerts — the payload tools/tpu_top.py renders). "
    "Implies metrics.live.enabled.")
METRICS_HTTP_PORT = conf(
    "spark.rapids.tpu.metrics.http.port", 0,
    "TCP port for the metrics exporter; 0 picks an ephemeral port "
    "(read the chosen address from TpuSession.obs_address).")
METRICS_HTTP_HOST = conf(
    "spark.rapids.tpu.metrics.http.host", "127.0.0.1",
    "Bind address for the metrics exporter (localhost by default; bind "
    "0.0.0.0 only behind your own auth/network policy).")
WATCHDOG_ENABLED = conf(
    "spark.rapids.tpu.watchdog.enabled", False,
    "Start the watchdog sampler thread: raises typed alerts — operator "
    "span open past watchdog.stallThresholdMs (stall), HBM watermark "
    "above watchdog.hbmPressureFraction of the derived budget "
    "(hbm_pressure), at least sql.analysis.recompileStorm.threshold "
    "compile misses on one site inside watchdog.recompileStorm.windowMs "
    "(recompile_storm) — surfaced as log warnings, 'alert' events in "
    "the event log, and the /status alerts list. Implies "
    "metrics.live.enabled. Tune thresholds offline with "
    "tools/tpu_profile.py --alerts over a recorded event log.")
WATCHDOG_INTERVAL_MS = conf(
    "spark.rapids.tpu.watchdog.intervalMs", 1000,
    "Watchdog sample interval.", check=_positive)
WATCHDOG_STALL_MS = conf(
    "spark.rapids.tpu.watchdog.stallThresholdMs", 30000,
    "An operator span still open after this long raises a stall alert "
    "(a hung device dispatch, a wedged host decode).", check=_positive)
WATCHDOG_PRESSURE_FRACTION = conf(
    "spark.rapids.tpu.watchdog.hbmPressureFraction", 0.85,
    "Raise an hbm_pressure alert when the BufferCatalog device-byte "
    "watermark reaches this fraction of the derived HBM budget (the "
    "SAME derive_hbm_budget the spiller uses).", check=_fraction)
WATCHDOG_STORM_WINDOW_MS = conf(
    "spark.rapids.tpu.watchdog.recompileStorm.windowMs", 10000,
    "Sliding window for the LIVE recompile-storm alert; the per-site "
    "miss-count threshold is sql.analysis.recompileStorm.threshold (one "
    "storm definition engine-wide).", check=_positive)
WATCHDOG_RETRY_STORM_THRESHOLD = conf(
    "spark.rapids.tpu.watchdog.retryStorm.threshold", 8,
    "Raise a retry_storm alert when one operator logs at least this "
    "many OOM recovery actions (memory/retry.py oom_retry events) "
    "inside watchdog.recompileStorm.windowMs: the queries still "
    "complete, but every batch is paying spill + backoff — the "
    "memory.hbm.budgetBytes needs attention.", check=_positive)


class RapidsConf:
    """Immutable snapshot of settings; unknown keys rejected, typed access."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = {}
        for key, raw in dict(settings or {}).items():
            entry = _REGISTRY.get(key)
            if entry is None:
                if key.startswith("spark.rapids.tpu."):
                    raise ValueError(f"unknown config key {key}")
                continue  # non-rapids keys are ignored, as in Spark
            self._values[key] = entry.convert(raw)

    def get(self, entry: ConfEntry):
        return self._values.get(entry.key, entry.default)

    @property
    def shape_bucket_min(self) -> int:
        return self.get(SHAPE_BUCKET_MIN)


