"""Parallelism: the pooled ordered reader and the prefetcher (``io``), and
the mesh tier (``mesh``, ``sharding``, ``distributed_build``,
``distributed_query``, ``multihost``)."""
