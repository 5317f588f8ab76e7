"""buffer pool and index cache: the pool's hits over its probes (hits and
misses), counter deltas over the window."""


def read(r):
    probes = r.pool.get("hits", 0) + r.pool.get("misses", 0)
    return 100.0 * r.pool.get("hits", 0) / probes if probes else None
