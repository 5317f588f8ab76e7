"""The fault-point names (counterpart of
``hyperspace_tpu/robustness/fault_names.py``, the points this package
places). Every ``faults.fault_point(...)`` site names one of these; a
conf key naming any other point is refused. The reference's
``spmd.compile`` has no site here: eager torch compiles no mesh program.
"""

from __future__ import annotations

# One pooled reader task (parallel/io.py imap_ordered): fires inside the
# retried read, so a transient injection runs the retry path on worker
# threads and on the sequential loop alike.
IO_POOLED_READ = "io.pooled_read"

# The prefetch producer advancing its source one item (parallel/io.py
# prefetch_iter): an error crosses the queue and raises at the consumer.
IO_PREFETCH_PRODUCE = "io.prefetch_produce"

# The entry of the multi-file scan decode (execution/columnar.read_parquet;
# every format funnels through it).
SCAN_PARQUET_DECODE = "scan.parquet_decode"

# Result-cache residency moves (serving/result_cache.py): the copy onto the
# device at device-tier admission (a failure puts the entry in the host
# tier), and the spill read-back (a failure is a miss, never a wrong
# answer).
RESULT_CACHE_DEVICE_PUT = "result_cache.device_put"
RESULT_CACHE_SPILL_READ = "result_cache.spill_read"

# Op-log writes (index/log_manager.py): the conditional entry put and the
# latestStable overwrite.
LOG_WRITE = "log.write"
LOG_STABLE = "log.stable"

# The start of an action's op() body (actions/action.py): a crash here
# leaves the transient log state with partial (or no) index data.
ACTION_OP = "action.op"

# A serving worker between popping an entry and executing it
# (serving/frontend._drain): its death releases the held members to run
# alone. The point fires under the head entry's submit-time context, so
# arm it with ``faults.scope(registry)`` around the submits; a query's
# own conf arms its execution, which comes after this point.
SERVING_WORKER = "serving.worker"

# Streaming ingestion (streaming/ingest.py). INGEST_STAGE fires inside
# append() before the staged batch's parquet is written; INGEST_PUBLISH
# inside the commit action's op(), after the transient table-log entry
# landed and before any batch file moves.
INGEST_STAGE = "ingest.stage"
INGEST_PUBLISH = "ingest.publish"

# A continuous source's poll body (streaming/sources.py): an injected
# error costs only that poll.
STREAMING_SOURCE = "streaming.source"

# The serving cluster (cluster/worker.py). CLUSTER_FORWARD fires at the
# sender before a routed submission ships to its shard owner (an error
# runs the query locally, to the same bytes); CLUSTER_BROADCAST before
# each peer's commit notice (an error costs that peer one standing-query
# fire, never the commit).
CLUSTER_FORWARD = "cluster.forward"
CLUSTER_BROADCAST = "cluster.broadcast"

# The SPMD mesh dispatch (execution/spmd._run/_run_stream), before any
# mesh work: a failure here runs the executor's SPMD -> single-device
# degradation ladder.
SPMD_DISPATCH = "spmd.dispatch"

# The buffer pool's probe (execution/buffer_pool.py get()): a load
# failure drops the entry and reports a miss, so the caller reads the
# files again; with degrade off it raises.
BUFFER_LOAD = "buffer.load"

# Program-bank wrapper construction (serving/program_bank.lookup): a
# failure runs the stage uncached (degraded_bank_compile).
BANK_COMPILE = "bank.compile"

# Artifact-store boundaries (artifacts/store.py). ARTIFACTS_WRITE fires
# between the publication temp write and the link into place, so a kill
# there leaves only whole blobs (vacuum sweeps the temp); an error costs
# only persistence. ARTIFACTS_READ fires before the blob read: an error is
# a miss, and the kernel is built with nvcc.
ARTIFACTS_WRITE = "artifacts.write"
ARTIFACTS_READ = "artifacts.read"

FAULT_NAMES = frozenset({
    IO_POOLED_READ, IO_PREFETCH_PRODUCE, SCAN_PARQUET_DECODE,
    RESULT_CACHE_DEVICE_PUT, RESULT_CACHE_SPILL_READ,
    LOG_WRITE, LOG_STABLE, ACTION_OP, SERVING_WORKER,
    INGEST_STAGE, INGEST_PUBLISH, STREAMING_SOURCE,
    CLUSTER_FORWARD, CLUSTER_BROADCAST, BUFFER_LOAD, SPMD_DISPATCH,
    BANK_COMPILE, ARTIFACTS_WRITE, ARTIFACTS_READ,
})
