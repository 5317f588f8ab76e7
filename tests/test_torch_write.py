"""``df.write`` through both packages on the same numpy-seeded sources:
every mode (error, overwrite, append), every format (parquet, csv, json,
avro), ``bucket_by`` and ``partition_by`` with their guards, and
``BucketUnion``. ``uuid.uuid4`` is drawn from one seeded sequence for each
package's write, so file names are equal too: the directory listings must
be equal and every file's bytes equal (exact), and every refusal must
carry the JAX package's message (exact).

The oracles are the JAX package's tests/test_write_api.py,
test_bucketed_write.py, test_partitioned_write.py and test_bucket_union.py.
"""

import json
import os
import random
import sys
import uuid

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu.plan.expr import col as jcol, sum_ as jsum
from hyperspace_tpu.plan.nodes import BucketUnion as JBucketUnion, Project as JProject
from hyperspace_tpu_torch.execution.columnar import Table
from hyperspace_tpu_torch.index.constants import IndexConstants
from hyperspace_tpu_torch.ops import index_build as tindex_build
from hyperspace_tpu_torch.plan.expr import sum_ as tsum
from hyperspace_tpu_torch.plan.nodes import (BucketSpec, BucketUnion, Project, Union)
from hyperspace_tpu_torch.serving import fingerprint as tfingerprint

CONF = {"hyperspace.tpu.distributed.enabled": "false",
        "hyperspace.tpu.execution.fusion.enabled": "false",
        IndexConstants.INDEX_NUM_BUCKETS: "4"}
PKGS = ("jax", "torch")


@pytest.fixture()
def lake(tmp_path):
    rng = np.random.default_rng(21)
    n = 3000
    src = tmp_path / "src"
    src.mkdir()
    for i in range(2):
        pq.write_table(pa.table({
            "query": pa.array(rng.choice(["donde", "bolsa", "santander", "fitbit"], n)),
            "clicks": pa.array(rng.integers(0, 500, n).astype(np.int64)),
            "ts": pa.array(rng.integers(0, 10_000, n).astype(np.int64)),
            "price": pa.array(np.round(rng.uniform(0, 100, n), 2)),
            "day": pa.array(rng.integers(9000, 9100, n).astype(np.int32), pa.int32()).cast(
                pa.date32()),
        }), src / f"p{i}.parquet")
    ss = {"jax": hst.Session(conf=dict(CONF), system_path=str(tmp_path / "sys_jax")),
          "torch": ht.Session(conf=dict(CONF), system_path=str(tmp_path / "sys_torch"),
                              device="cpu")}
    return tmp_path, str(src), ss


def col(pkg):
    return jcol if pkg == "jax" else ht.col


_REAL_UUID4 = uuid.uuid4
_WRITERS = ("hyperspace_tpu.session", "hyperspace_tpu_torch.session")


def seed_uuids(monkeypatch, seed: int) -> None:
    """``uuid.uuid4`` from a seeded sequence for the writers' calls (the
    JAX package also draws uuids elsewhere while a query runs)."""
    rnd = random.Random(seed)

    def uuid4():
        if sys._getframe(1).f_globals.get("__name__") in _WRITERS:
            return uuid.UUID(int=rnd.getrandbits(128), version=4)
        return _REAL_UUID4()

    monkeypatch.setattr(uuid, "uuid4", uuid4)


def write_both(lake, monkeypatch, write, seed=7):
    """Run ``write(session, pkg, out_dir)`` for each package with the same
    uuid sequence; return {pkg: out_dir}."""
    root, _, ss = lake
    outs = {}
    for pkg in PKGS:
        seed_uuids(monkeypatch, seed)
        outs[pkg] = str(root / f"out_{pkg}")
        write(ss[pkg], pkg, outs[pkg])
    return outs


def listing(d):
    out = []
    for base, _, files in os.walk(d):
        out.extend(os.path.relpath(os.path.join(base, f), d) for f in files)
    return sorted(out)


def assert_dirs_equal(a, b):
    assert listing(a) == listing(b)
    for f in listing(a):
        with open(os.path.join(a, f), "rb") as x, open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


def errors_of(lake, monkeypatch, write):
    """The messages both packages raise for ``write``; they must refuse."""
    messages = []

    def run(s, pkg, out):
        with pytest.raises(Exception) as e:
            write(s, pkg, out)
        messages.append(str(e.value).replace(out, "<out>"))

    write_both(lake, monkeypatch, run)
    return messages


# ---------------------------------------------------------------------------
# Formats and modes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ("parquet", "csv", "json", "avro"))
def test_format_outputs_equal_jax_bytes(lake, monkeypatch, fmt):
    _, src, _ = lake

    def write(s, pkg, out):
        df = s.read.parquet(src).filter(col(pkg)("clicks") < 100).select(
            "query", "clicks", "price", "day")
        getattr(df.write, fmt)(out)

    outs = write_both(lake, monkeypatch, write)
    assert_dirs_equal(outs["jax"], outs["torch"])
    files = listing(outs["torch"])
    assert len(files) == 1 and files[0].startswith("part-") and files[0].endswith("." + fmt)
    _, _, ss = lake
    back = {pkg: getattr(ss[pkg].read, fmt)(outs[pkg]).to_arrow() for pkg in PKGS}
    assert back["torch"].equals(back["jax"])


def test_modes_equal_jax(lake, monkeypatch):
    _, src, _ = lake

    def write(s, pkg, out):
        df = s.read.parquet(src).select("query", "clicks")
        df.write.parquet(out)
        df.filter(col(pkg)("clicks") > 400).write.mode("append").parquet(out)
        df.filter(col(pkg)("clicks") < 3).write.mode("append").csv(out + "_csv")
        df.filter(col(pkg)("clicks") < 5).write.mode("overwrite").csv(out + "_csv")

    outs = write_both(lake, monkeypatch, write)
    assert_dirs_equal(outs["jax"], outs["torch"])
    assert_dirs_equal(outs["jax"] + "_csv", outs["torch"] + "_csv")
    assert len(listing(outs["torch"])) == 2 and len(listing(outs["torch"] + "_csv")) == 1
    _, _, ss = lake
    assert ss["torch"].read.parquet(outs["torch"]).count() == \
        ss["jax"].read.parquet(outs["jax"]).count()


def test_error_mode_and_file_path_refused_as_jax(lake, monkeypatch):
    _, src, _ = lake

    def non_empty(s, pkg, out):
        s.read.parquet(src).select("query").write.json(out)
        s.read.parquet(src).select("query").write.json(out)

    msgs = errors_of(lake, monkeypatch, non_empty)
    assert msgs[0] == msgs[1] and msgs[0].startswith("Path not empty: <out>")

    def file_path(s, pkg, out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out + "f", "w") as f:
            f.write("x")
        s.read.parquet(src).write.mode("overwrite").parquet(out + "f")

    msgs = errors_of(lake, monkeypatch, file_path)
    assert msgs[0] == msgs[1] and "Path is a file, not a dir" in msgs[0]

    def bad_mode(s, pkg, out):
        s.read.parquet(src).write.mode("ignore")

    msgs = errors_of(lake, monkeypatch, bad_mode)
    assert msgs[0] == msgs[1] == "Unknown write mode: ignore"


def test_overwrite_a_query_over_its_own_source(lake, monkeypatch):
    root, src, ss = lake
    for pkg in PKGS:
        d = root / f"self_{pkg}"
        os.makedirs(d)
        for f in os.listdir(src):
            with open(os.path.join(src, f), "rb") as a, open(d / f, "wb") as b:
                b.write(a.read())

    def write(s, pkg, out):
        d = str(root / f"self_{pkg}")
        s.read.parquet(d).filter(col(pkg)("clicks") < 50).write.mode("overwrite").parquet(d)

    write_both(lake, monkeypatch, write)
    got = {pkg: ss[pkg].read.parquet(str(root / f"self_{pkg}")).to_arrow() for pkg in PKGS}
    assert got["torch"].equals(got["jax"])
    assert got["torch"].num_rows == int(pa.compute.sum(pa.compute.less(
        pq.read_table(src).column("clicks"), 50)).as_py())


# ---------------------------------------------------------------------------
# bucket_by.
# ---------------------------------------------------------------------------

def check_bucket_layout(out, num_buckets, cols):
    """Every file holds only its bucket's rows (the port's hash on the CPU),
    sorted by the bucketing columns; returns the rows."""
    total = 0
    for f in sorted(f for f in os.listdir(out) if f.endswith(".parquet")):
        b = tindex_build.bucket_id_from_file(f)
        assert b is not None and 0 <= b < num_buckets, f
        t = pq.read_table(os.path.join(out, f))
        total += t.num_rows
        ids = tindex_build.bucket_ids_for(Table.from_arrow(t, "cpu"), cols, num_buckets)
        assert bool((ids == b).all()), f
        assert t.equals(t.sort_by([(c, "ascending") for c in cols]))
    return total


@pytest.mark.parametrize("cols", (["clicks"], ["query", "ts"]))
def test_bucketed_write_equals_jax(lake, monkeypatch, cols):
    _, src, ss = lake

    def write(s, pkg, out):
        df = s.read.parquet(src)
        df.write.bucket_by(8, *cols).parquet(out)
        df.filter(col(pkg)("clicks") < 10).write.mode("append").bucketBy(8, *cols).parquet(out)

    outs = write_both(lake, monkeypatch, write)
    assert_dirs_equal(outs["jax"], outs["torch"])
    with open(os.path.join(outs["torch"], "_bucket_spec.json")) as f:
        assert json.load(f) == {"numBuckets": 8, "columns": cols}
    n = ss["torch"].read.parquet(src).count()
    n_small = ss["torch"].read.parquet(src).filter(ht.col("clicks") < 10).count()
    assert check_bucket_layout(outs["torch"], 8, cols) == n + n_small
    names = [f for f in listing(outs["torch"]) if f.endswith(".parquet")]
    suffixes = {f.rsplit("-", 1)[1] for f in names}
    assert len(suffixes) == 2  # one per write
    assert ss["torch"].read.parquet(outs["torch"]).to_arrow().equals(
        ss["jax"].read.parquet(outs["jax"]).to_arrow())


def test_bucket_append_guards_equal_jax(lake, monkeypatch):
    _, src, _ = lake

    def other_spec(s, pkg, out):
        s.read.parquet(src).write.bucket_by(4, "clicks").parquet(out)
        s.read.parquet(src).write.mode("append").bucket_by(8, "clicks").parquet(out)

    msgs = errors_of(lake, monkeypatch, other_spec)
    assert msgs[0] == msgs[1] and "does not match the existing layout" in msgs[0]

    def unbucketed_dir(s, pkg, out):
        s.read.parquet(src).write.parquet(out + "_u")
        s.read.parquet(src).write.mode("append").bucket_by(4, "clicks").parquet(out + "_u")

    msgs = errors_of(lake, monkeypatch, unbucketed_dir)
    assert msgs[0] == msgs[1] and "not written with bucket_by" in msgs[0]

    def plain_into_bucketed(s, pkg, out):
        s.read.parquet(src).write.bucket_by(4, "clicks").parquet(out + "_b")
        s.read.parquet(src).write.mode("append").parquet(out + "_b")

    msgs = errors_of(lake, monkeypatch, plain_into_bucketed)
    assert msgs[0] == msgs[1] and "holds a bucketed dataset" in msgs[0]


@pytest.mark.parametrize("case", ("zero", "no_cols", "missing", "with_partition",
                                  "csv", "json", "avro"))
def test_bucket_by_refusals_equal_jax(lake, monkeypatch, case):
    _, src, _ = lake

    def write(s, pkg, out):
        w = s.read.parquet(src).select("query", "clicks").write
        if case == "zero":
            w.bucket_by(0, "clicks")
        elif case == "no_cols":
            w.bucket_by(4)
        elif case == "missing":
            w.bucket_by(4, "nope")
        elif case == "with_partition":
            w.partition_by("query").bucket_by(4, "clicks")
        else:
            getattr(w.bucket_by(4, "clicks"), case)(out)

    msgs = errors_of(lake, monkeypatch, write)
    assert msgs[0] == msgs[1]


def test_empty_bucketed_result_keeps_its_schema(lake, monkeypatch):
    _, src, ss = lake

    def write(s, pkg, out):
        s.read.parquet(src).filter(col(pkg)("clicks") < 0).write.bucket_by(
            4, "clicks").parquet(out)

    outs = write_both(lake, monkeypatch, write)
    assert_dirs_equal(outs["jax"], outs["torch"])
    back = ss["torch"].read.parquet(outs["torch"]).to_arrow()
    assert back.num_rows == 0 and back.column_names == ["query", "clicks", "ts", "price", "day"]


def test_bucketed_output_joins_like_jax(lake, monkeypatch):
    """Bucketed outputs read back and join as any source does."""
    root, src, ss = lake

    def write(s, pkg, out):
        s.read.parquet(src).select("ts", "clicks").write.bucket_by(4, "ts").parquet(out)

    outs = write_both(lake, monkeypatch, write)
    got = {}
    for pkg in PKGS:
        s = ss[pkg]
        c = col(pkg)
        left = s.read.parquet(outs[pkg]).select(c("ts").alias("k"), "clicks")
        right = s.read.parquet(src).select("ts", "price")
        got[pkg] = left.join(right, c("k") == c("ts")).group_by("k").agg(
            (jsum if pkg == "jax" else tsum)(c("price")).alias("p")).sort("k").to_arrow()
    assert got["torch"].equals(got["jax"])


# ---------------------------------------------------------------------------
# partition_by.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cols", (["query"], ["query", "day"]))
def test_partitioned_write_equals_jax(lake, monkeypatch, cols):
    _, src, ss = lake

    def write(s, pkg, out):
        df = s.read.parquet(src).select("query", "clicks", "day", "price")
        df.write.partition_by(*cols).parquet(out)
        df.filter(col(pkg)("clicks") < 20).write.mode("append").partitionBy(*cols).parquet(out)

    outs = write_both(lake, monkeypatch, write)
    assert_dirs_equal(outs["jax"], outs["torch"])
    back = {}
    for pkg in PKGS:
        df = ss[pkg].read.parquet(outs[pkg])
        back[pkg] = (df.schema, df.to_arrow(),
                     df.filter(col(pkg)("query") == "bolsa").select("clicks").to_arrow())
    assert [(f.name, f.dtype) for f in back["torch"][0].fields] == \
        [(f.name, f.dtype) for f in back["jax"][0].fields]
    assert back["torch"][1].equals(back["jax"][1])
    assert back["torch"][2].equals(back["jax"][2])


def test_empty_partitioned_result_writes_one_schema_file(lake, monkeypatch):
    _, src, ss = lake

    def write(s, pkg, out):
        s.read.parquet(src).filter(col(pkg)("clicks") < 0).write.partition_by(
            "query").parquet(out)

    outs = write_both(lake, monkeypatch, write)
    assert_dirs_equal(outs["jax"], outs["torch"])
    assert len(listing(outs["torch"])) == 1


@pytest.mark.parametrize("case", ("no_cols", "missing", "repeat", "every", "csv", "json",
                                  "avro", "with_bucket"))
def test_partition_by_refusals_equal_jax(lake, monkeypatch, case):
    _, src, _ = lake

    def write(s, pkg, out):
        w = s.read.parquet(src).select("query", "clicks").write
        if case == "no_cols":
            w.partition_by()
        elif case == "missing":
            w.partition_by("nope")
        elif case == "repeat":
            w.partition_by("query", "query")
        elif case == "every":
            w.partition_by("query", "clicks")
        elif case == "with_bucket":
            w.bucket_by(4, "clicks").partition_by("query")
        else:
            getattr(w.partition_by("query"), case)(out)

    msgs = errors_of(lake, monkeypatch, write)
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# BucketUnion.
# ---------------------------------------------------------------------------

def test_bucket_union_construction_as_jax(lake):
    _, src, ss = lake
    a, b = ss["torch"].read.parquet(src), ss["torch"].read.parquet(src)
    with pytest.raises(ht.HyperspaceException, match="BucketUnion requires children"):
        BucketUnion([], None)
    renamed = b.select(ht.col("query").alias("q"), "clicks", "ts", "price", "day")
    with pytest.raises(ht.HyperspaceException, match="BucketUnion children must share schema"):
        BucketUnion([a.plan, renamed.plan], None)
    spec = BucketSpec(8, ("clicks",), ("clicks",))
    bu = BucketUnion([a.plan, b.plan], spec)
    rebuilt = bu.with_children(bu.children)
    assert isinstance(rebuilt, BucketUnion) and rebuilt.bucket_spec == spec
    assert bu.schema.names == a.schema.names
    assert bu.tree_string().splitlines()[0] == "BucketUnion"


def test_bucket_union_executes_as_jax(lake):
    _, src, ss = lake
    got = {}
    for pkg in PKGS:
        s = ss[pkg]
        c = col(pkg)
        a = s.read.parquet(src).filter(c("clicks") < 50).select("query", "clicks")
        b = s.read.parquet(src).filter(c("clicks") > 450).select("query", "clicks")
        BU, P = (JBucketUnion, JProject) if pkg == "jax" else (BucketUnion, Project)
        bu = BU([a.plan, b.plan, a.plan], None)
        whole = s.create_dataframe(bu)
        pruned = s.create_dataframe(P([c("clicks")], bu))
        agg = whole.group_by("query").agg((jsum if pkg == "jax" else tsum)(
            c("clicks")).alias("n")).sort("query")
        got[pkg] = (whole.to_arrow(), pruned.to_arrow(), agg.to_arrow(),
                    whole.optimized_plan().tree_string())
    for x, y in zip(got["torch"], got["jax"]):
        assert x == y if isinstance(x, str) else x.equals(y)
    assert got["torch"][1].column_names == ["clicks"]


def test_bucket_union_fingerprint_differs_from_union(lake):
    _, src, ss = lake
    a = ss["torch"].read.parquet(src).plan
    keys = {tfingerprint.plan_fingerprint(p) for p in (BucketUnion([a, a], None), Union([a, a]))}
    assert len(keys) == 2 and None not in keys


def test_escaped_partition_value_reads_back_escaped_as_jax(lake, monkeypatch):
    """ROADMAP queue C 16: pyarrow escapes "a b" as the directory
    "p=a%20b", and neither package's discovery unescapes it."""
    root, _, ss = lake
    src = root / "spaces"
    src.mkdir()
    pq.write_table(pa.table({"p": ["a b", "c", "a b"], "v": [1, 2, 3]}), src / "p0.parquet")

    def write(s, pkg, out):
        s.read.parquet(str(src)).write.partition_by("p").parquet(out)

    outs = write_both(lake, monkeypatch, write)
    assert_dirs_equal(outs["jax"], outs["torch"])
    assert sorted(os.listdir(outs["torch"])) == ["p=a%20b", "p=c"]
    back = {pkg: ss[pkg].read.parquet(outs[pkg]).sort("v").to_arrow() for pkg in PKGS}
    assert back["torch"].equals(back["jax"])
    assert back["torch"].column("p").to_pylist() == ["a%20b", "c", "a%20b"]
