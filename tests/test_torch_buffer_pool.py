"""The buffer pool and the index-table cache (``execution/buffer_pool.py``,
``execution/index_cache.py``) against the JAX package's, on the same
numpy-seeded files:

- hits, misses, admissions, rejections, demotions, promotions and
  evictions under tiny budgets, counter for counter;
- a warm replay equals the cold read: the bulk scan's table, a chunk
  stream chunk for chunk, the index-table cache's route;
- an abandoned chunk stream is not admitted;
- no stale hit after an append, a refresh, an optimize, or a delete,
  vacuum and recreate under one name;
- the cache route against the pruned route, and ``prefers_pruned_read``
  equal across packages.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.execution import buffer_pool as jbuffer_pool
from hyperspace_tpu.execution import columnar as jcolumnar
from hyperspace_tpu.execution import pushdown as jpushdown
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu_torch.execution import buffer_pool as tbuffer_pool
from hyperspace_tpu_torch.execution import columnar as tcolumnar
from hyperspace_tpu_torch.execution import index_cache as tindex_cache
from hyperspace_tpu_torch.execution import pushdown as tpushdown
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.parallel import io as tio
from hyperspace_tpu_torch.plan import expr as TE

# conftest gives JAX 8 virtual devices, which would take its mesh build.
JAX_CONF = {"hyperspace.tpu.distributed.enabled": "false",
            "hyperspace.tpu.execution.fusion.enabled": "false",
            IndexConstants.INDEX_NUM_BUCKETS: "4",
            IndexConstants.TPU_IO_THREADS: "2"}
ROWS = 200


def write_file(path: str, seed: int, rows: int = ROWS) -> None:
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, 500, rows).astype(np.int64)),
        "v": pa.array(np.round(rng.uniform(-10, 10, rows), 4)),
        "w": pa.array(rng.integers(0, 50, rows).astype(np.int32)),
    }), path, row_group_size=50)


def fresh_pools() -> None:
    for bp in (jbuffer_pool, tbuffer_pool):
        bp.get_pool().clear()
        bp.get_pool().reset_stats()


def pool_delta(before: dict, after: dict) -> dict:
    keys = ("hits", "misses", "transfers", "admissions")
    out = {k: after[k] - before[k] for k in keys}
    for ns in set(before["namespaces"]) | set(after["namespaces"]):
        a = after["namespaces"].get(ns, {"hits": 0, "misses": 0})
        b = before["namespaces"].get(ns, {"hits": 0, "misses": 0})
        out[ns] = (a["hits"] - b["hits"], a["misses"] - b["misses"])
    return out


# ---------------------------------------------------------------------------
# The pool alone.
# ---------------------------------------------------------------------------

def tables(pkg: str, n: int):
    """n tables of one int64 column of 100 rows: 800 bytes each in both
    packages' accounting."""
    out = []
    for i in range(n):
        at = pa.table({"x": pa.array(np.arange(100, dtype=np.int64) + i)})
        out.append(jcolumnar.Table.from_arrow(at) if pkg == "jax"
                   else tcolumnar.Table.from_arrow(at, "cpu"))
    return out


STAT_KEYS = ("device_hits", "host_hits", "misses", "admissions", "rejections", "loads",
             "promotions", "transfers", "demotions", "evictions", "decode_bytes_saved",
             "device_entries", "host_entries", "device_nbytes", "host_nbytes", "namespaces")


def ladder(pkg: str) -> list:
    """One sequence of puts and probes over a pool of 2.5 entries on the
    device and 1.5 on the host; the observations after each step."""
    bp = jbuffer_pool if pkg == "jax" else tbuffer_pool
    pool = bp.BufferPool(device_bytes=2000, host_bytes=1200)
    a, b, c, d, big = tables(pkg, 4) + [None]
    big = (jcolumnar.Table.from_arrow(pa.table({"x": np.arange(300, dtype=np.int64)}))
           if pkg == "jax" else tcolumnar.Table.from_arrow(
               pa.table({"x": np.arange(300, dtype=np.int64)}), "cpu"))
    key = {name: bp.PoolKey("scan", (name,), 100 + i) for i, name in enumerate("abcde")}
    seen = []

    def rows(payload):
        if payload is None:
            return None
        if isinstance(payload, list):  # a chunk stream.
            return [rows(t) for t in payload]
        return np.asarray(payload.column("x").data).tolist()

    def look(got, want=None):
        seen.append((rows(got) == rows(want), {k: pool.stats()[k] for k in STAT_KEYS}))

    pool.put(key["a"], a)
    pool.put(key["b"], b)
    look(pool.get(key["a"]), a)          # device hit
    pool.put(key["c"], c)                # b demoted (a was touched)
    look(pool.get(key["b"]), b)          # host hit, promoted; a demoted
    pool.put(key["d"], d)                # c demoted; host over: a evicted
    look(pool.get(key["a"]))             # miss
    look(pool.get(key["c"]), c)          # host hit, promoted
    pool.put(key["e"], big)              # above the device budget: rejected
    look(pool.get(key["e"]))
    pool.put(bp.PoolKey("stream", ("s",), 0), [a], nbytes=900, device_only=True)
    look(pool.get(bp.PoolKey("stream", ("s",), 0)), [a])
    pool.put(key["a"], a)
    pool.put(key["b"], b)                # the stream entry drops, never demoted
    seen.append(pool.ns_nbytes("stream"))
    look(pool.get(bp.PoolKey("stream", ("s",), 0)))
    pool.clear("scan")
    look(pool.get(key["c"]))
    seen.append(pool.ns_counts("scan") + pool.ns_counts("stream") + (pool.ns_nbytes("scan"),))
    return seen


def test_eviction_ladder_counts_what_the_jax_package_counts():
    got, want = ladder("torch"), ladder("jax")
    assert got == want
    assert all(ok for ok, _ in got[:6]) and got[6] == 0
    last = got[-2][1]
    assert (last["device_hits"], last["host_hits"], last["misses"], last["rejections"],
            last["promotions"], last["demotions"], last["evictions"]) == (2, 2, 4, 1, 2, 6, 4)


def test_nbytes_counts_the_storage_behind_a_view():
    t = tcolumnar.Table.from_arrow(pa.table({"x": np.arange(1000, dtype=np.int64)}), "cpu")
    assert tbuffer_pool.table_nbytes(t) == 8000
    assert tbuffer_pool.table_nbytes(t.slice(0, 10)) == 8000


def test_index_cache_is_a_view_on_the_index_namespace():
    pool = tbuffer_pool.BufferPool(10_000, 0)
    cache = tindex_cache.IndexTableCache(pool)
    (t,) = tables("torch", 1)
    assert cache.get(("id", 1)) is None
    cache.put(("id", 1), t)
    assert cache.get(("id", 1)) is t
    assert (cache.hits, cache.misses, cache.nbytes) == (1, 1, 800)
    assert pool.stats()["namespaces"] == {"index": {"hits": 1, "misses": 1}}
    cache.clear()
    assert cache.nbytes == 0 and pool.stats()["device_entries"] == 0


# ---------------------------------------------------------------------------
# Through the executor.
# ---------------------------------------------------------------------------

class Lake:
    def __init__(self, root, conf=None):
        self.root = root
        self.src = str(root / "src")
        for i in range(3):
            write_file(os.path.join(self.src, f"p{i}.parquet"), 10 + i)
        c = dict(JAX_CONF, **(conf or {}))
        self.sessions = {
            "jax": hst.Session(conf=dict(c), system_path=str(root / "sys_jax")),
            "torch": ht.Session(conf=dict(c), system_path=str(root / "sys_torch"),
                                device="cpu")}

    def pkg(self, n):
        return hst if n == "jax" else ht

    def df(self, n):
        return self.sessions[n].read.parquet(self.src)

    def hs(self, n):
        return self.pkg(n).Hyperspace(self.sessions[n])

    def query(self, n, shape: str):
        col = self.pkg(n).col
        df = self.df(n)
        if shape == "leading":    # constrains the leading indexed column: a pruned read.
            return df.filter(col("k") < 120).select("k", "v")
        if shape == "other":      # pushable, yet constrains no column alone: the cache route.
            return df.filter((col("k") < 120) | (col("w") == 7)).select("k", "v")
        return df.filter(col("v") > 0).select("k", "w")  # scanned, no index applies.

    def run(self, n, shape: str, indexed: bool = True) -> pa.Table:
        s = self.sessions[n]
        s.enable_hyperspace() if indexed else s.disable_hyperspace()
        try:
            return self.query(n, shape).to_arrow().sort_by([("k", "ascending"),
                                                           (self.query(n, shape).plan
                                                            .schema.names[1], "ascending")])
        finally:
            s.disable_hyperspace()


def torch_stats() -> dict:
    return tbuffer_pool.pool_stats()


@pytest.mark.parametrize("shape", ["leading", "other", "scan"])
def test_warm_replay_equals_cold_and_the_jax_package(tmp_path, shape):
    lake = Lake(tmp_path)
    for n in lake.sessions:
        lake.hs(n).create_index(lake.df(n), lake.pkg(n).IndexConfig("kv", ["k"], ["v", "w"]))
    want = lake.run("torch", shape, indexed=False)
    fresh_pools()
    before = torch_stats()
    cold = lake.run("torch", shape)
    mid = torch_stats()
    warm = lake.run("torch", shape)
    after = torch_stats()
    assert cold.equals(want) and warm.equals(cold)
    assert cold.equals(lake.run("jax", shape))
    ns = {"leading": "scan", "other": "index", "scan": "scan"}[shape]
    assert pool_delta(before, mid)[ns] == (0, 1)
    assert pool_delta(mid, after)[ns] == (1, 0)
    assert pool_delta(mid, after)["transfers"] == 0


def test_stream_replay_is_chunk_for_chunk(tmp_path):
    lake = Lake(tmp_path)
    files = sorted(os.path.join(lake.src, f) for f in os.listdir(lake.src))
    fresh_pools()
    flt = pc.field("w") < 40
    with tio.use_session(lake.sessions["torch"]):
        # An abandoned stream is not admitted.
        next(iter(tcolumnar.iter_dataset_chunks(files, ["k", "w"], 70, "cpu", flt)))
        cold = [c.to_arrow() for c in tcolumnar.iter_dataset_chunks(files, ["k", "w"], 70,
                                                                    "cpu", flt)]
        warm = [c.to_arrow() for c in tcolumnar.iter_dataset_chunks(files, ["k", "w"], 70,
                                                                    "cpu", flt)]
    assert torch_stats()["namespaces"]["stream"] == {"hits": 1, "misses": 2}
    assert len(warm) == len(cold) > 1 and all(a.equals(b) for a, b in zip(warm, cold))
    with tio.use_session(lake.sessions["torch"]):
        lake.sessions["torch"].conf.set(IndexConstants.TPU_BUFFER_POOL_STREAM_ADMIT_BYTES, 64)
        big = [c.to_arrow() for c in tcolumnar.iter_dataset_chunks(files, ["k"], 70, "cpu")]
        again = [c.to_arrow() for c in tcolumnar.iter_dataset_chunks(files, ["k"], 70, "cpu")]
    # Above streamAdmitBytes: streamed, not kept.
    assert torch_stats()["namespaces"]["stream"] == {"hits": 1, "misses": 4}
    assert all(a.equals(b) for a, b in zip(big, again))


@pytest.mark.parametrize("shape", ["other", "scan"])
def test_pool_off_reads_around_the_pool(tmp_path, shape):
    """The index-table cache follows the pool's switch too."""
    lake = Lake(tmp_path, {IndexConstants.TPU_BUFFER_POOL_ENABLED: "false"})
    lake.hs("torch").create_index(lake.df("torch"), ht.IndexConfig("kv", ["k"], ["v", "w"]))
    fresh_pools()
    a, b = lake.run("torch", shape), lake.run("torch", shape)
    assert a.equals(b) and a.equals(lake.run("torch", shape, indexed=False))
    assert torch_stats()["hits"] + torch_stats()["misses"] == 0


def index_versions(lake, n, name):
    return sorted(os.listdir(os.path.join(lake.root, f"sys_{n}", name)))


@pytest.mark.parametrize("mutation", ["append", "refresh", "optimize", "recreate"])
def test_no_stale_hit_after_a_mutation(tmp_path, mutation):
    lake = Lake(tmp_path, {IndexConstants.INDEX_LINEAGE_ENABLED: "true",
                           IndexConstants.INDEX_CACHE_EXPIRY_DURATION_SECONDS: "0"})
    n = "torch"
    hs = lake.hs(n)
    hs.create_index(lake.df(n), ht.IndexConfig("kv", ["k"], ["v", "w"]))
    fresh_pools()
    for shape, indexed in (("other", True), ("leading", True), ("scan", False)):
        lake.run(n, shape, indexed)  # warm every route.
    old_files = {f: os.stat(os.path.join(lake.root, "sys_torch", "kv", "v__=0", f)).st_mtime_ns
                 for f in os.listdir(os.path.join(lake.root, "sys_torch", "kv", "v__=0"))}
    if mutation == "append":
        write_file(os.path.join(lake.src, "p9.parquet"), 99)
    elif mutation == "refresh":
        write_file(os.path.join(lake.src, "p9.parquet"), 99)
        hs.refresh_index("kv", "full")
    elif mutation == "optimize":
        write_file(os.path.join(lake.src, "p9.parquet"), 99)
        hs.refresh_index("kv", "incremental")
        hs.optimize_index("kv", "full")
    else:
        hs.delete_index("kv")
        hs.vacuum_index("kv")
        for i in range(3):  # new rows, the same file sizes.
            write_file(os.path.join(lake.src, f"p{i}.parquet"), 50 + i)
        hs.create_index(lake.df(n), ht.IndexConfig("kv", ["k"], ["v", "w"]))
        # Give the rewritten index files their predecessors' mtimes, as two
        # writes within one coarse mtime tick would: the log id in the key
        # still tells the versions apart.
        for f, mtime in old_files.items():
            path = os.path.join(lake.root, "sys_torch", "kv", "v__=0", f)
            if os.path.exists(path):
                os.utime(path, ns=(mtime, mtime))
    for shape, indexed in (("other", True), ("leading", True), ("scan", False)):
        before = torch_stats()
        got = lake.run(n, shape, indexed)
        delta = pool_delta(before, torch_stats())
        assert delta["hits"] == 0, (shape, delta)
        assert got.equals(lake.run(n, shape, indexed=False)), shape
    if mutation in ("refresh", "optimize"):
        assert len(index_versions(lake, n, "kv")) > 2


def test_prefers_pruned_read_is_the_jax_packages(tmp_path):
    lake = Lake(tmp_path)
    entries = {}
    for n in lake.sessions:
        lake.hs(n).create_index(lake.df(n), lake.pkg(n).IndexConfig("kw", ["k", "w"], ["v"]))
        entries[n] = lake.hs(n).index_manager.get_index("kw") if n == "torch" else \
            lake.sessions[n].index_collection_manager.get_index("kw")
    for E, n, mod in ((JE, "jax", jpushdown), (TE, "torch", tpushdown)):
        schema = entries[n].schema
        conds = [E.col("k") < 5, E.col("w") == 3, (E.col("k") > 1) & (E.col("v") < 0),
                 E.col("k").isin([1, 2]), E.col("k") + E.col("w") > 3,
                 (E.col("k") == 1) | (E.col("w") == 2), E.col("v") > 0]
        entries[n + "_verdicts"] = [
            (mod.prefers_pruned_read(entries[n], c, schema),
             mod.pruned_index_read_filter(entries[n], c, schema) is not None,
             mod.filter_constrains(c, schema, "w")) for c in conds]
    assert entries["torch_verdicts"] == entries["jax_verdicts"]
    assert [v[0] for v in entries["torch_verdicts"]] == \
        [True, False, True, True, False, False, False]
