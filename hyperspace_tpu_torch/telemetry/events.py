"""Typed telemetry event model (counterpart of
``hyperspace_tpu/telemetry/events.py``, trimmed to the events this package
emits).

One event class per action (start/success/failure carried in
``message``), the index-usage event of the rewrite rules, and the events
of the read, serving, streaming, robustness, advisor, adaptive and
cluster tiers, and the mesh tier's fallback, sharded-execution and
exchange events, the program bank's, the artifact store's, and
``KernelCompileEvent``, which counts the kernel libraries a plan's
execution built with nvcc (the JAX package's counts XLA compiles).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class HyperspaceEvent:
    """Base event. ``app_id`` identifies the session; ``message`` carries
    RUNNING/SUCCESS/FAILURE details.

    ``trace_id``/``span_id`` correlate the event with the query that
    emitted it: auto-stamped from the ACTIVE trace span
    (telemetry/trace.py) at construction time — which IS emission time,
    events are built at their emit sites — and empty outside a traced
    execution, so tracing-off event streams are byte-identical to
    pre-trace ones."""

    app_id: str = ""
    message: str = ""
    emitted_on_ms: int = field(default_factory=lambda: int(time.time() * 1000))
    trace_id: str = ""
    span_id: str = ""

    def __post_init__(self):
        if not self.trace_id:
            from .trace import active_ids
            self.trace_id, self.span_id = active_ids()
        # Flight-recorder feed (telemetry/flight_recorder.py): every
        # event construction — which IS emission — rings the recorder
        # and runs its anomaly/tail-keep classifier. Bounded, lock +
        # append; failures must never reach the emit site.
        try:
            from .flight_recorder import note_event
            note_event(self)
        except Exception:
            pass

    @property
    def event_name(self) -> str:
        return type(self).__name__


@dataclass
class HyperspaceIndexCRUDEvent(HyperspaceEvent):
    index_name: str = ""
    log_entry_json: Optional[str] = None


@dataclass
class CreateActionEvent(HyperspaceIndexCRUDEvent):
    index_config: Optional[object] = None


@dataclass
class DeleteActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class RestoreActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class VacuumActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class CancelActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class RefreshActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class RefreshIncrementalActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class RefreshQuickActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class OptimizeActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class DistributedFallbackEvent(HyperspaceEvent):
    """A distributed path (the mesh build, an SPMD query) ran single-device
    instead. ``where`` is "index_build" or "spmd_query"; ``reason`` the
    cause ("fault: ..." when the degradation ladder absorbed a fault)."""

    where: str = ""
    reason: str = ""


@dataclass
class ShardedExecutionEvent(HyperspaceEvent):
    """One successful SPMD dispatch (execution/spmd.py): the mesh it ran
    over, the layout of its inputs and outputs, whether the leaf sharded
    on file boundaries, the collectives its body issued ("all-to-all" the
    exchanges, "all-reduce" the psum/pmin/pmax merges, "all-gather" the
    sort's samples) and its capacity attempts (always 1: shards are sized
    exactly)."""

    mode: str = ""            # global-agg | grouped-agg | stream | sort
    mesh_axes: Optional[List[str]] = None
    mesh_shape: Optional[List[int]] = None
    mesh_platform: str = ""
    shard_rows: int = 0
    file_aligned_scan: bool = False
    in_specs: str = ""
    out_specs: str = ""
    collectives: Optional[dict] = None
    cap_attempts: int = 1


@dataclass
class SpmdExchangeEvent(HyperspaceEvent):
    """One join stage (or the sort's range exchange) of an SPMD dispatch:
    the strategy (``broadcast``, ``exchange`` or ``sort-route``), the
    largest block one device sent one device (``capacity``), the largest
    per-device output (``output_slots``) and the all-to-alls the stage
    asked for."""

    stage: int = -1
    join_type: str = ""
    strategy: str = ""        # broadcast | exchange | sort-route
    capacity: int = 0
    output_slots: int = 0
    all_to_all: int = 0


@dataclass
class HyperspaceIndexUsageEvent(HyperspaceEvent):
    """Emitted when a rewrite rule applies indexes to a plan
    (parity: rules/FilterIndexRule.scala:69-78)."""

    index_names: List[str] = field(default_factory=list)
    plan_string: str = ""


@dataclass
class ResultCacheEvent(HyperspaceEvent):
    """Base of the serving-layer result-cache events (no reference
    analogue; see serving/result_cache.py). ``key_digest`` is the stable
    short form of the cache key; ``tier`` is "device" | "host"."""

    key_digest: str = ""
    tier: str = ""
    nbytes: int = 0


@dataclass
class ResultCacheHitEvent(ResultCacheEvent):
    pass


@dataclass
class ResultCacheMissEvent(ResultCacheEvent):
    """``reason`` distinguishes robustness misses ("spill-corrupt" — a
    truncated/corrupt spill file was evicted and served as a miss) from
    plain cold misses ("", byte-compatible with the pre-robustness
    event stream)."""

    reason: str = ""


@dataclass
class ResultCacheAdmitEvent(ResultCacheEvent):
    pass


@dataclass
class ResultCacheEvictionEvent(ResultCacheEvent):
    """``demoted`` — a device-tier victim that moved to the host tier
    (still servable) rather than leaving the cache entirely."""

    demoted: bool = False


@dataclass
class IoReadEvent(HyperspaceEvent):
    """Emitted per pooled multi-file read fan-out (parallel/io.py
    imap_ordered): how many file tasks ran, their summed size estimate,
    the summed in-worker read+decode time, and the pool width used.
    Sequential reads (pool off / threads=1 / single file) are silent."""

    files: int = 0
    nbytes: int = 0
    seconds: float = 0.0
    threads: int = 0


@dataclass
class IoWaitEvent(HyperspaceEvent):
    """Emitted per completed prefetch stream (parallel/io.py
    prefetch_iter): ``wait_seconds`` is consumer time blocked on the
    queue (I/O-bound share), ``read_seconds`` the producer's read+decode
    time — their gap is the decode/compute overlap the pipeline bought.
    ``where`` labels the stream (dataset_chunks, sketch_build, ...)."""

    where: str = ""
    wait_seconds: float = 0.0
    read_seconds: float = 0.0
    items: int = 0


@dataclass
class JoinReorderEvent(HyperspaceEvent):
    """Emitted when the cost-based join reorderer
    (optimizer/join_order.py) re-linearizes an inner-equi-join chain:
    ``tables`` in the original (text) order, ``order`` as chosen, and
    the per-step estimated intermediate cardinalities. Diagnostic
    passes (explain) are silent."""

    tables: List[str] = field(default_factory=list)
    order: List[str] = field(default_factory=list)
    estimated_rows: List[float] = field(default_factory=list)


@dataclass
class CardinalityEstimateEvent(HyperspaceEvent):
    """One cardinality estimate the reorderer committed to (per join
    step of a reordered chain). ``subject`` is the join condition repr —
    the same key the executor records actual inner-join output rows
    under, so estimate and observation can be paired for q-error."""

    subject: str = ""
    estimated_rows: float = 0.0


@dataclass
class AdvisorWhatIfEvent(HyperspaceEvent):
    """Emitted per user-facing what-if analysis (advisor/whatif.py):
    ``index_names`` the hypothetical configs, ``applied_names`` those the
    plan would use. The passes inside ``recommend`` emit none."""

    index_names: List[str] = field(default_factory=list)
    applied_names: List[str] = field(default_factory=list)


@dataclass
class AdvisorRecommendationEvent(HyperspaceEvent):
    """Emitted per ``Hyperspace.recommend`` run (advisor/recommend.py): the
    ranked index names and the evidence behind them."""

    recommended: List[str] = field(default_factory=list)
    candidates_evaluated: int = 0
    records_considered: int = 0


@dataclass
class ReplanEvent(HyperspaceEvent):
    """Emitted per mid-query re-plan (adaptive/feedback.py): a join
    boundary observed ``actual_rows`` against the reorderer's
    ``est_rows`` for the key, past the re-plan threshold (``adaptive/constants.REPLAN_ERROR_THRESHOLD``); the
    query planned again with the fresh correction and ran once more."""

    key: str = ""
    est_rows: float = 0.0
    actual_rows: int = 0
    threshold: float = 0.0


@dataclass
class AdaptiveActionEvent(HyperspaceEvent):
    """One control-plane decision (adaptive/): ``action`` is
    ``builder.build`` / ``builder.retire`` / ``builder.maintain`` (the
    builder) or ``admission.engage`` / ``admission.recover`` (SLO
    admission); ``subject`` the index, table or mode acted on."""

    action: str = ""
    subject: str = ""
    detail: str = ""


@dataclass
class ServingAdmitEvent(HyperspaceEvent):
    """Emitted per query the serving frontend admits
    (serving/frontend.py). ``estimated_bytes`` is the admission-control
    recompute-input estimate; ``queue_depth`` the queue length after the
    enqueue."""

    client: str = ""
    estimated_bytes: int = 0
    queue_depth: int = 0


@dataclass
class ServingRejectEvent(HyperspaceEvent):
    """Emitted per submission admission control refuses (queue at
    ``serving.queueDepth`` or in-flight bytes past
    ``serving.admission.maxBytes``); the caller sees a
    ServingRejectedError carrying the same ``reason``."""

    client: str = ""
    estimated_bytes: int = 0
    reason: str = ""


@dataclass
class ServingBatchEvent(HyperspaceEvent):
    """Emitted per executed literal-sweep batch (serving/frontend.py):
    ``size`` member queries over ``shared_scans`` shared source reads;
    ``positions`` is how many Filter positions the template swept.
    ``sweep_invocations`` counts stacked predicate invocations, which this
    package does not make (each member evaluates its own mask): always 0."""

    size: int = 0
    positions: int = 0
    sweep_invocations: int = 0
    shared_scans: int = 0


@dataclass
class RetryEvent(HyperspaceEvent):
    """Emitted per retried sequence (robustness/retry.py — pooled
    reader tasks, op-log store writes): how many attempts ran, whether
    the sequence recovered, and the ORIGINAL transient error (the one
    surfaced on exhaustion). Sequences that succeed first try are
    silent — a healthy system emits no retry telemetry."""

    where: str = ""
    attempts: int = 0
    succeeded: bool = False
    error: str = ""


@dataclass
class QueryCancelledEvent(HyperspaceEvent):
    """Emitted ONCE per query cancelled at a cooperative deadline check
    (serving/context.check_deadline): which boundary the cancellation
    struck and how long the query had been running. The caller sees the
    typed QueryDeadlineError; the serving worker slot is freed."""

    query_id: int = 0
    where: str = ""
    elapsed_ms: float = 0.0


@dataclass
class SloBreachEvent(HyperspaceEvent):
    """Emitted per healthy->breached transition of one named SLO
    objective (telemetry/slo.py): which objective, the configured
    threshold, the observed value, and the sliding window it was
    evaluated over. Recoveries re-arm silently; Hyperspace.health()
    carries the live verdict."""

    objective: str = ""
    threshold: float = 0.0
    observed: float = 0.0
    window_s: float = 0.0
    count: int = 0


@dataclass
class StreamingAppendEvent(HyperspaceEvent):
    """Emitted per staged batch (streaming/ingest.py append): how many
    rows landed in staging, the batch's parquet size, and how many
    covering/skipping index deltas were prebuilt on-device at load time
    (the aggressive-elephants contract: index work rides the upload)."""

    table: str = ""
    rows: int = 0
    nbytes: int = 0
    covering_deltas: int = 0
    sketch_deltas: int = 0
    seconds: float = 0.0


@dataclass
class StreamingCommitEvent(HyperspaceEvent):
    """Emitted per commit() publishing staged batches through the
    op-log protocol: batches/files/rows landed, which indexes received
    prebuilt deltas, and the commit's wall-clock (metadata + renames —
    the index build already happened at append time)."""

    table: str = ""
    batches: int = 0
    files: int = 0
    rows: int = 0
    indexes_updated: List[str] = field(default_factory=list)
    seconds: float = 0.0


@dataclass
class StreamingIndexDeltaEvent(HyperspaceIndexCRUDEvent):
    """One prebuilt index delta landed by a streaming commit (the
    load-time analogue of RefreshIncrementalActionEvent — its presence
    with ZERO RefreshActionEvents is the 'fresh with no refresh pass'
    telemetry assertion)."""


@dataclass
class StreamingCompactionEvent(HyperspaceEvent):
    """Emitted per op-log compacted by compact() (streaming/
    compaction.py): how many superseded entries folded into the
    checkpoint, the new compaction generation (pinned into the
    checkpoint entry bytes so result-cache keys can never alias across
    a compaction), and data versions vacuumed."""

    subject: str = ""
    entries_folded: int = 0
    generation: int = 0
    versions_vacuumed: int = 0


@dataclass
class StreamingWaveEvent(HyperspaceEvent):
    """Emitted per group-commit publication wave (streaming/ingest.py
    CommitCoordinator): how many staged batches the wave coalesced into
    one op-log entry per table, how many concurrent ``commit()``
    callers rode the wave instead of publishing themselves, and how
    many bounded sub-waves drained a deeper queue."""

    table: str = ""
    batches: int = 0
    rows: int = 0
    joined: int = 0
    sub_waves: int = 0
    seconds: float = 0.0


@dataclass
class StreamingSourceEvent(HyperspaceEvent):
    """Emitted per productive continuous-source poll (streaming/
    sources.py): the tailer appended ``batches`` new input batches
    (``rows`` rows) and drove ``commits`` group commits itself;
    ``waits`` counts blocking-backpressure stalls this poll."""

    source: str = ""
    table: str = ""
    batches: int = 0
    rows: int = 0
    commits: int = 0
    waits: int = 0


@dataclass
class StandingQueryEvent(HyperspaceEvent):
    """Emitted per standing-query fire wave (streaming/
    subscriptions.py): a commit re-fired ``fired`` subscribed plans
    through the serving worker pool (``rejected`` were shed by
    admission control and delivered as errors). ``groups`` counts the
    same-template groups routed through the literal batcher as shared
    scans (0 = every fire ran as its own submission)."""

    table: str = ""
    fired: int = 0
    rejected: int = 0
    groups: int = 0


@dataclass
class IndexCacheProbeEvent(HyperspaceEvent):
    """Base of the device index-table-cache probe events: the executor emits
    one per IndexScan cache lookup (execution/index_cache.py)."""

    index_name: str = ""


@dataclass
class IndexCacheHitEvent(IndexCacheProbeEvent):
    pass


@dataclass
class IndexCacheMissEvent(IndexCacheProbeEvent):
    pass


@dataclass
class BufferPoolEvent(HyperspaceEvent):
    """Base of the tiered columnar buffer-pool events
    (execution/buffer_pool.py): ``namespace`` is the key family
    ("scan" | "stream" | "index" | "blocks"), ``tier`` where the probe
    landed ("device" | "host"), ``nbytes`` the entry's residency cost."""

    namespace: str = ""
    tier: str = ""
    nbytes: int = 0


@dataclass
class BufferPoolHitEvent(BufferPoolEvent):
    """A decoded, padded buffer served from the pool — a parquet decode
    and (on the device tier) a host→device transfer that did NOT
    happen."""


@dataclass
class BufferPoolMissEvent(BufferPoolEvent):
    """``reason`` is "" (cold/evicted key — the caller re-reads) or
    "fault" (the ``buffer.load`` point struck and the degrade contract
    dropped the entry: a silent miss, never a wrong answer)."""

    reason: str = ""


@dataclass
class BufferPoolEvictEvent(BufferPoolEvent):
    """One entry moved down the device→host→drop ladder: ``demoted``
    means it survived to the host tier; otherwise it was dropped."""

    demoted: bool = False


@dataclass
class ClusterEvent(HyperspaceEvent):
    """Base of the serving-cluster events (cluster/worker.py).
    ``worker_id`` is the emitting worker's identity, the label the
    OpenMetrics exposition stamps on its samples."""

    worker_id: str = ""


@dataclass
class ClusterJoinEvent(ClusterEvent):
    """This worker registered its membership record and started its
    heartbeat (``host``/``port`` are its transport address)."""

    host: str = ""
    port: int = 0


@dataclass
class ClusterLeaveEvent(ClusterEvent):
    """This worker removed its membership record (a clean stop; a crashed
    worker leaves by staleness instead)."""


@dataclass
class ClusterForwardEvent(ClusterEvent):
    """One routed submission shipped to its shard ``owner``. ``ok`` False:
    the owner did not answer or refused (a fingerprint mismatch) and the
    query ran locally; ``hit`` True: the owner answered from its result
    cache without executing."""

    owner: str = ""
    key_digest: str = ""
    ok: bool = False
    hit: bool = False
    millis: float = 0.0


@dataclass
class ClusterBroadcastEvent(ClusterEvent):
    """One commit notice sent to the live peers, so standing queries fire
    on every worker (``delivered`` of ``peers`` acknowledged). ``batches``
    is the wave's width: group commit sends one notice a wave."""

    table: str = ""
    peers: int = 0
    delivered: int = 0
    batches: int = 0


@dataclass
class KernelCompileEvent(HyperspaceEvent):
    """Kernel-library builds of one plan execution (ops/cuda_kernels.py):
    ``count`` libraries built with nvcc by this execution, ``seconds``
    their summed build time, ``total`` the process-lifetime build count.
    Loads from the artifact store are not builds; an execution that built
    nothing emits no event."""

    count: int = 0
    seconds: float = 0.0
    total: int = 0


@dataclass
class ProgramBankEvent(HyperspaceEvent):
    """Base of the program-bank events (serving/program_bank.py).
    ``stage_digest`` identifies the stage fingerprint; ``shape_vec`` the
    shape-class vector; ``hits``/``misses`` are the bank's running totals
    at emission time."""

    stage_digest: str = ""
    shape_vec: List[int] = field(default_factory=list)
    hits: int = 0
    misses: int = 0


@dataclass
class ProgramBankMissEvent(ProgramBankEvent):
    """A new (stage, shape-class vector) program registered."""


@dataclass
class ProgramBankHitEvent(ProgramBankEvent):
    """A program's FIRST reuse (later reuses only bump the counters)."""


@dataclass
class ArtifactEvent(HyperspaceEvent):
    """Base of the artifact store events (artifacts/store.py).
    ``key_digest`` is the blob filename digest; ``kind`` is "kernel";
    ``nbytes`` the payload size where the store knows it."""

    key_digest: str = ""
    kind: str = ""
    nbytes: int = 0


@dataclass
class ArtifactHitEvent(ArtifactEvent):
    """A kernel library loaded from the lake: an nvcc build that did NOT
    happen."""


@dataclass
class ArtifactMissEvent(ArtifactEvent):
    """``reason`` is "absent" (cold key, or an injected read failure) or
    "corrupt" (header, checksum or load failure: the blob was quarantined
    and the kernel is built instead)."""

    reason: str = ""


@dataclass
class ArtifactPersistEvent(ArtifactEvent):
    """One built library published put-if-absent (this process won the
    publication race)."""


@dataclass
class ArtifactEvictEvent(ArtifactEvent):
    """A blob deleted to fit ``artifacts.maxBytes`` (coldest first by the
    persisted usage order)."""
