"""The reader pool and the prefetcher (``parallel/io.py``) against the JAX
package's, and the reads built on them, on the same numpy-seeded files:

- ``map_ordered`` and ``imap_ordered`` keep the items' order when the
  tasks finish out of order, at any thread count;
- ``prefetch_iter`` raises a producer's error at the consumer, and stops
  its producer when the consumer stops early;
- the pooled multi-file read equals the sequential read and the JAX
  package's, and chunk streams keep the sequential order and provenance;
- sketch tables and covering and chunked-build bucket files are
  byte-equal at ``io.threads`` 1 and 4, and ``run_all``, which writes
  them, ends every call before it raises and counts no read;
- a string column's dictionary and codes equal the JAX package's;
- explain's I/O section counts the same fan-outs as the JAX package's
  after the same reads.
"""

import os
import random
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.execution import buffer_pool as jbuffer_pool
from hyperspace_tpu.execution import columnar as jcolumnar
from hyperspace_tpu.parallel import io as jio
from hyperspace_tpu.plananalysis.explain import explain_string as jax_explain_string
from hyperspace_tpu_torch.execution import buffer_pool as tbuffer_pool
from hyperspace_tpu_torch.execution import columnar as tcolumnar
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.parallel import io as tio
from hyperspace_tpu_torch.plananalysis.explain import explain_string as torch_explain_string

# conftest gives JAX 8 virtual devices, which would take its mesh build.
JAX_CONF = {"hyperspace.tpu.distributed.enabled": "false",
            "hyperspace.tpu.execution.fusion.enabled": "false"}
THREADS = IndexConstants.TPU_IO_THREADS
IO = {"jax": jio, "torch": tio}
FILES = 7


def write_files(src: str, n: int = FILES, rows: int = 300) -> list:
    os.makedirs(src, exist_ok=True)
    paths = []
    for i in range(n):
        rng = np.random.default_rng(300 + i)
        path = os.path.join(src, f"f{i:02d}.parquet")
        pq.write_table(pa.table({
            "k": pa.array(rng.integers(0, 1000, rows).astype(np.int64)),
            "v": pa.array(np.round(rng.uniform(-10, 10, rows), 4)),
            "s": pa.array(rng.choice(["a", "bb", "c", "dd"], rows), mask=rng.random(rows) < 0.1),
        }), path, row_group_size=64)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_files(str(tmp_path_factory.mktemp("io") / "src"))


def session(pkg: str, root, threads: int, **conf):
    c = dict(JAX_CONF, **{THREADS: str(threads)}, **conf)
    if pkg == "jax":
        return hst.Session(conf=c, system_path=str(root / "sys_jax"))
    return ht.Session(conf=c, system_path=str(root / "sys_torch"), device="cpu")


# ---------------------------------------------------------------------------
# The primitives.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["map", "imap"])
@pytest.mark.parametrize("threads", [1, 2, 4, 9])
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_ordered_maps_keep_order_under_uneven_tasks(pkg, threads, form):
    io = IO[pkg]
    rng = random.Random(threads)
    delays = [rng.uniform(0, 0.01) for _ in range(24)]

    def task(i):
        time.sleep(delays[i])
        return i * i

    params = io.IoParams(threads=threads, prefetch_depth=2)
    got = io.map_ordered(task, range(24), params=params) if form == "map" \
        else list(io.imap_ordered(task, range(24), params=params))
    assert got == [i * i for i in range(24)]
    pairs = list(io.zip_prefetch(range(5), task, params=params))
    assert pairs == [(i, i * i) for i in range(5)]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_nested_fan_out_runs_in_the_worker(pkg):
    io = IO[pkg]
    params = io.IoParams(threads=3)

    def outer(i):
        assert io.in_worker()
        return io.map_ordered(lambda j: (i, j), range(3), params=params)

    assert not io.in_worker()
    assert io.map_ordered(outer, range(4), params=params) == \
        [[(i, j) for j in range(3)] for i in range(4)]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_prefetch_raises_the_producers_error_at_the_consumer(pkg, threads):
    io = IO[pkg]

    def source():
        for i in range(3):
            yield i
        raise ValueError("read failed")

    got = []
    with pytest.raises(ValueError, match="read failed"):
        for x in io.prefetch_iter(source(), params=io.IoParams(threads=threads)):
            got.append(x)
    assert got == [0, 1, 2]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_prefetch_stops_its_producer_when_the_consumer_stops(pkg):
    io = IO[pkg]
    produced, closed = [], threading.Event()

    def source():
        try:
            for i in range(10 ** 6):
                produced.append(i)
                yield i
        finally:
            closed.set()

    stream = io.prefetch_iter(source(), params=io.IoParams(threads=4, prefetch_depth=2))
    got = [x for _, x in zip(range(3), stream)]
    stream.close()
    assert got == [0, 1, 2]
    assert closed.wait(10)
    # Depth 2: at most two buffered items and one in production past the three taken.
    assert len(produced) <= 3 + 2 + 1
    assert not [t for t in threading.enumerate() if "prefetch" in t.name and t.is_alive()]


# ---------------------------------------------------------------------------
# Reads.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pushed", [False, True])
@pytest.mark.parametrize("threads", [1, 2, 4, 16])
def test_pooled_read_equals_the_sequential_read(files, tmp_path, threads, pushed):
    flt = (pc.field("k") < 300) if pushed else None
    want = pq.read_table(files, columns=["k", "v", "s"], filters=flt, use_threads=False)
    reads = {}
    for pkg in ("jax", "torch"):
        with IO[pkg].use_session(session(pkg, tmp_path, threads)):
            reads[pkg] = tcolumnar._read_parquet_pooled(files, ["k", "v", "s"], flt) \
                if pkg == "torch" else \
                jcolumnar._read_parquet_pooled(files, ["k", "v", "s"], flt, None)
            if pkg == "torch":
                table = tcolumnar.read_parquet(files, ["k", "v", "s"], "cpu", filters=flt)
            else:
                table = jcolumnar.read_parquet(files, ["k", "v", "s"], filters=flt)
            reads[pkg + "_table"] = table.to_arrow()
    assert reads["torch"].equals(want)
    assert reads["jax"].equals(want)
    assert reads["torch_table"].equals(reads["jax_table"])


@pytest.mark.parametrize("threads", [1, 4])
def test_chunk_streams_keep_order_and_provenance(files, tmp_path, threads):
    chunks = {}
    for pkg in ("jax", "torch"):
        with IO[pkg].use_session(session(pkg, tmp_path, threads)):
            if pkg == "torch":
                stream = tcolumnar.iter_parquet_chunks(files, ["k", "s"], 97, "cpu")
            else:
                stream = jcolumnar.iter_parquet_chunks(files, ["k", "s"], 97)
            chunks[pkg] = [(t.to_arrow(), prov) for t, prov in stream]
    assert [p for _, p in chunks["torch"]] == [p for _, p in chunks["jax"]]
    for (a, _), (b, _) in zip(chunks["torch"], chunks["jax"]):
        assert a.equals(b)
    whole = pa.concat_tables([t for t, _ in chunks["torch"]])
    assert whole.equals(pq.read_table(files, columns=["k", "s"]).combine_chunks()
                        .cast(whole.schema))


def file_bytes(directory: str) -> dict:
    out = {}
    for root, _, names in os.walk(directory):
        for n in names:
            if n.endswith(".parquet"):
                with open(os.path.join(root, n), "rb") as f:
                    out[os.path.relpath(os.path.join(root, n), directory)] = f.read()
    return out


def test_sketch_tables_are_byte_equal_at_any_thread_count(files, tmp_path):
    tables = {}
    for threads in (1, 4):
        s = session("torch", tmp_path / f"t{threads}", threads)
        ht.Hyperspace(s).create_index(s.read.parquet(os.path.dirname(files[0])),
                                      ht.DataSkippingIndexConfig(
                                          "sk", [ht.MinMaxSketch("k"),
                                                 ht.BloomFilterSketch("k", expected_items=300)]))
        tables[threads] = file_bytes(str(tmp_path / f"t{threads}" / "sys_torch" / "sk"))
    assert tables[1] and tables[1] == tables[4]
    s = session("jax", tmp_path / "j", 4)
    hst.Hyperspace(s).create_index(
        s.read.parquet(os.path.dirname(files[0])),
        hst.DataSkippingIndexConfig("sk", [hst.MinMaxSketch("k"),
                                           hst.BloomFilterSketch("k", expected_items=300)]))
    want = pq.read_table(os.path.join(str(tmp_path / "j" / "sys_jax" / "sk"), "v__=0",
                                      "sketches.parquet"), partitioning=None)
    got = pq.read_table(os.path.join(str(tmp_path / "t4" / "sys_torch" / "sk"), "v__=0",
                                     "sketches.parquet"), partitioning=None)
    # The _file column holds each lake's own paths.
    assert got.drop(["_file"]).equals(want.drop(["_file"]))


@pytest.mark.parametrize("lineage", [False, True])
def test_chunked_build_files_are_byte_equal_at_any_thread_count(files, tmp_path, lineage):
    trees = {}
    for threads in (1, 4):
        s = session("torch", tmp_path / f"t{threads}", threads, **{
            IndexConstants.TPU_MAX_CHUNK_ROWS: "250", IndexConstants.INDEX_NUM_BUCKETS: "5",
            IndexConstants.INDEX_LINEAGE_ENABLED: str(lineage).lower()})
        ht.Hyperspace(s).create_index(s.read.parquet(os.path.dirname(files[0])),
                                      ht.IndexConfig("ci", ["k"], ["v", "s"]))
        trees[threads] = file_bytes(str(tmp_path / f"t{threads}" / "sys_torch" / "ci"))
    assert len(trees[1]) == 5 and trees[1] == trees[4]


def test_covering_build_files_are_byte_equal_at_any_thread_count(files, tmp_path):
    trees = {}
    for threads in (1, 4):
        s = session("torch", tmp_path / f"t{threads}", threads,
                    **{IndexConstants.INDEX_NUM_BUCKETS: "5"})
        ht.Hyperspace(s).create_index(s.read.parquet(os.path.dirname(files[0])),
                                      ht.IndexConfig("ci", ["k"], ["v", "s"]))
        trees[threads] = file_bytes(str(tmp_path / f"t{threads}" / "sys_torch" / "ci"))
    assert len(trees[1]) == 5 and trees[1] == trees[4]


@pytest.mark.parametrize("threads", [1, 4])
def test_run_all_ends_every_call_and_raises_the_first_error(threads):
    done = []

    def task(i):
        time.sleep(0.002 * (5 - i % 5))
        if i in (3, 7):
            raise ValueError(f"write {i} failed")
        done.append(i)

    tio.reset_stats()
    before = tio.pool_stats()
    with pytest.raises(ValueError, match="write 3 failed"):
        tio.run_all(task, range(10), params=tio.IoParams(threads=threads))
    # The pool lets the other calls end; the loop stops at the error.
    assert sorted(done) == ([i for i in range(10) if i not in (3, 7)] if threads > 1
                            else [0, 1, 2])
    # Writes count in no read statistic, nor do they size the reader pool.
    assert tio.pool_stats() == before


STRING_CASES = {
    "mixed": ["b", "a", None, "", "\u00e4", "z", "a", "\u65e5\u672c", "Z", "aa", "\U0001F600"],
    "trailing_nul": ["a\x00", "a", "b", None],
    "all_null": [None, None],
    "empty": [],
    "blank": ["", None, ""],
}


@pytest.mark.parametrize("case", sorted(STRING_CASES))
def test_string_encoding_equals_the_jax_package(case):
    """The dictionary and the codes of a string column: pyarrow's sort and
    lookup in the port, numpy's in the JAX package (and in the port where a
    trailing NUL leaves numpy's strings unable to tell two values apart)."""
    rng = np.random.default_rng(7)
    values = STRING_CASES[case] + (list(rng.choice(STRING_CASES["mixed"][:4], 500))
                                   if case == "mixed" else [])
    at = pa.table({"s": pa.array(values, pa.string())})
    got = tcolumnar.Table.from_arrow(at, "cpu").column("s")
    want = jcolumnar.Table.from_arrow(at).column("s")
    assert got.dictionary.tolist() == np.asarray(want.dictionary).tolist()
    assert got.data.numpy().tolist() == np.asarray(want.data).tolist()
    assert (got.validity is None) == (want.validity is None)
    assert tcolumnar.Table.from_arrow(at, "cpu").to_arrow().equals(
        jcolumnar.Table.from_arrow(at).to_arrow())


# ---------------------------------------------------------------------------
# explain's I/O section.
# ---------------------------------------------------------------------------

def io_section(text: str) -> list:
    lines = text.splitlines()
    start = lines.index("I/O:")
    out = []
    for line in lines[start + 2:]:
        if line.startswith("=") or not line:
            break
        out.append(line.split(" resident=")[0])
    return out


def test_explain_io_section_counts_what_the_jax_package_counts(files, tmp_path):
    texts = {}
    for pkg in ("jax", "torch"):
        s = session(pkg, tmp_path, 2)
        df = s.read.parquet(os.path.dirname(files[0]))
        col = hst.col if pkg == "jax" else ht.col
        q = df.filter(col("k") < 500).select("k", "v")
        for io_mod, bp in ((jio, jbuffer_pool), (tio, tbuffer_pool)):
            io_mod.reset_stats()
            bp.get_pool().clear()
            bp.get_pool().reset_stats()
        cold, warm = q.to_arrow(), q.to_arrow()
        assert cold.equals(warm)
        texts[pkg] = (jax_explain_string if pkg == "jax" else torch_explain_string)(
            s, q.plan, diagnostics=True)
        assert "I/O:" not in (jax_explain_string if pkg == "jax" else torch_explain_string)(
            s, q.plan, diagnostics=False)
    section = io_section(texts["torch"])
    assert section[0] == "reader pool: on (threads=2 prefetchDepth=2 maxInflightBytes=268435456)"
    assert section[1].startswith("pooled reads: 1 fan-out(s), 2 file task(s), ")
    assert section[3].startswith("buffer pool: hits=1 misses=1 transfers=1 ")
    jax_section = io_section(texts["jax"])
    assert [section[i] for i in (0, 1, 3)] == [jax_section[i] for i in (0, 1, 3)]
