"""Conf keys of the serving cluster (counterpart of
``hyperspace_tpu/cluster/constants.py``). Imports nothing: config.py
reads it at import time."""

from __future__ import annotations

# The roster's directory under the index system path. It holds no
# _hyperspace_log, so the op-log sweeps pass it by.
CLUSTER_DIR_NAME = "_hst_cluster"

# Fixed where the JAX package has a conf key, at its default: virtual nodes
# a member puts on the hash ring, the transport's attempts per request
# (transient errors retry with backoff), and how long a rank of the host
# gather waits for the whole stack. The commit broadcast follows
# ``cluster.enabled``.
VNODES = 64
TRANSPORT_ATTEMPTS = 2
GATHER_TIMEOUT_S = 60.0


class ClusterConstants:
    # The switch. Off (the default) nothing binds a socket, writes a
    # membership record or routes a query.
    ENABLED = "hyperspace.tpu.cluster.enabled"
    ENABLED_DEFAULT = "false"

    # The worker's identity; empty means ``<host>-<pid>``. It is in the
    # membership record, the Cluster* events and the OpenMetrics
    # ``worker`` label.
    WORKER_ID = "hyperspace.tpu.cluster.worker.id"
    WORKER_ID_DEFAULT = ""

    # The transport's bind address and port ("0": an ephemeral port; the
    # bound one is what membership publishes).
    BIND = "hyperspace.tpu.cluster.bind"
    BIND_DEFAULT = "127.0.0.1"
    PORT = "hyperspace.tpu.cluster.port"
    PORT_DEFAULT = "0"

    # The roster directory; empty means ``<system path>/_hst_cluster``.
    DIR = "hyperspace.tpu.cluster.dir"
    DIR_DEFAULT = ""

    # The heartbeat's period, and the age past which a member counts as
    # dead and is routed around.
    HEARTBEAT_MS = "hyperspace.tpu.cluster.heartbeat.ms"
    HEARTBEAT_MS_DEFAULT = "2000"
    STALENESS_MS = "hyperspace.tpu.cluster.staleness.ms"
    STALENESS_MS_DEFAULT = "10000"

    # The frontend's router: a submission goes to the owner of its plan's
    # result-cache shard. Takes effect only with the cluster enabled.
    ROUTING_ENABLED = "hyperspace.tpu.cluster.routing.enabled"
    ROUTING_ENABLED_DEFAULT = "true"

    # A forward's time limit; an owner that does not answer in it leaves
    # the query to run locally.
    FORWARD_TIMEOUT_MS = "hyperspace.tpu.cluster.forward.timeoutMs"
    FORWARD_TIMEOUT_MS_DEFAULT = "2000"

    # The host allgather's path: "auto" takes "host" while
    # torch.distributed has no initialized process group; "host" forces
    # the star over the transport; "native" belongs to the mesh tier and
    # raises until it lands.
    GATHER = "hyperspace.tpu.cluster.gather"
    GATHER_DEFAULT = "auto"
