"""Device-resident index tables: a view on the buffer pool's ``"index"``
namespace (counterpart of ``hyperspace_tpu/execution/index_cache.py``).

Once a query reads an index version, its columns stay on the device and
later queries filter them there instead of decoding the bucket files
again. The tables share the pool's budgets and eviction ladder with the
source scans.

The executor keys an entry by (log id, index name, the index files'
signatures, columns, device). The signatures are the port's addition to
the JAX package's key: after a vacuum, a recreated index of the same name
writes the same file paths, and only their sizes and mtimes tell the
versions apart. The cache follows ``bufferPool.enabled``; the JAX
package's environment switches (``HST_INDEX_CACHE``,
``HST_INDEX_CACHE_BYTES``) are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

from . import buffer_pool
from .buffer_pool import BufferPool, index_key


class IndexTableCache:
    """Get, put and clear over a buffer pool's ``"index"`` namespace, and
    its hit, miss and byte counts."""

    def __init__(self, pool: BufferPool):
        self._pool = pool

    def get(self, key: Tuple):
        return self._pool.get(index_key(key))

    def put(self, key: Tuple, table) -> None:
        self._pool.put(index_key(key), table)

    def clear(self) -> None:
        self._pool.clear("index")

    @property
    def hits(self) -> int:
        return self._pool.ns_counts("index")[0]

    @property
    def misses(self) -> int:
        return self._pool.ns_counts("index")[1]

    @property
    def nbytes(self) -> int:
        return self._pool.ns_nbytes("index")


_cache: Optional[IndexTableCache] = None


def enabled() -> bool:
    return buffer_pool.enabled()


def get_cache() -> IndexTableCache:
    """The view on the process pool (its budgets refreshed from the session
    in scope)."""
    global _cache
    pool = buffer_pool.get_pool()
    if _cache is None:
        _cache = IndexTableCache(pool)
    return _cache


def table_nbytes(table) -> int:
    """Bytes a table keeps alive, as every residency cache counts them (the
    buffer pool's measure)."""
    return buffer_pool.table_nbytes(table)
