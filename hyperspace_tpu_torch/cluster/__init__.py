"""Shared-nothing serving cluster (counterpart of
``hyperspace_tpu/cluster/``): N processes over one lake, one serving
system.

Modules, bottom up:

- :mod:`.transport`: length-framed pickle request/response over TCP, one
  round trip a connection, retried through robustness/retry.py;
- :mod:`.membership`: the lake-resident ``_hst_cluster/`` roster (register
  put-if-absent, heartbeat by rewrite, expiry by staleness);
- :mod:`.hashring`: consistent hashing of the result cache by
  plan-fingerprint digest (about 1/N of the keys move per membership
  change);
- :mod:`.gather`: the host allgather (a single process gets its array
  back; several use the star through rank 0's hub);
- :mod:`.worker`: the node (server dispatch, router, commit broadcast,
  fleet metrics).

The ``hyperspace.tpu.cluster.*`` conf governs it all; disabled (the
default) it does nothing. Only host data crosses processes: a forwarded
answer travels as CPU tensors and the sender puts it back on its own
device.
"""

from .constants import ClusterConstants  # noqa: F401
