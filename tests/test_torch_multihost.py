"""Two processes, one mesh (``parallel/multihost.py``): a 2-process gloo
job on the CPU, one device per process.

Each process joins the job with ``initialize_multihost``, builds its own
disjoint rows (an int key and a string column whose values differ between
the processes) through ``distributed_build_sorted_buckets`` over
``global_mesh("cpu")``, and reports what it holds. The parent checks row
conservation, bucket agreement with the single-process hash, single
ownership of every bucket, the global string dictionary (the same on both
processes, every string kept), each collective across the two processes,
and that ``cluster.gather=native`` gathers over the group.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
rank, port, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
from hyperspace_tpu_torch.cluster import gather
from hyperspace_tpu_torch.execution.columnar import Column, Table
from hyperspace_tpu_torch.parallel import distributed_build as db
from hyperspace_tpu_torch.parallel import mesh as pm
from hyperspace_tpu_torch.parallel import multihost
from hyperspace_tpu_torch.schema import INT64, STRING

info = multihost.initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo")
mesh = multihost.global_mesh("cpu")
rng = np.random.default_rng(100 + rank)
n = 700 + 300 * rank
keys = rng.integers(0, 5000, n).astype(np.int64)
words = np.array([f"r{rank}-w{i}" for i in range(5 + rank)] + ["shared"], dtype=object)
codes = rng.integers(0, len(words), n).astype(np.int32)
table = Table({"k": Column(INT64, torch.from_numpy(keys)),
               "s": Column(STRING, torch.from_numpy(codes), None, np.array(sorted(words),
                                                                          dtype=object))})
sorted_words = np.array(sorted(words), dtype=object)
local_strings = sorted(sorted_words[codes].tolist())
tables, bids = db.distributed_build_sorted_buckets(table, ["k"], 16, mesh,
                                                   process_local_rows=True)
got = tables[0]
dic = got.column("s").dictionary.tolist()
gather.force_mode("native")
gathered = gather.allgather(np.array([rank, n], np.int64)).tolist()
json.dump({"info": info, "rows_in": n, "keys_in": keys.tolist(),
           "strings_in": local_strings,
           "keys": got.column("k").data.tolist(), "bids": bids[0].tolist(),
           "dictionary": dic,
           "strings": [dic[c] for c in got.column("s").data.tolist()],
           "union_count": db.DICT_UNION_COUNT, "gathered": gathered}, open(out, "w"))
# Leave the group before exit: a live group's threads at interpreter
# shutdown can abort the process.
torch.distributed.destroy_process_group()
"""

SPMD_CHILD = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
rank, port, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
from hyperspace_tpu_torch.parallel import mesh as pm
from hyperspace_tpu_torch.parallel import multihost
from hyperspace_tpu_torch.parallel.sharding import device_view
multihost.initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo")
mesh = multihost.global_mesh("cpu")
x = torch.arange(10 * rank, 10 * rank + 6 + rank, dtype=torch.int64)
shards, valid = pm.pad_and_shard(mesh, {"x": x}, int(x.shape[0]), process_local=True)
counts = {}

def body(ax, arrs, v):
    xs = torch.where(v, arrs["x"], torch.zeros_like(arrs["x"]))
    dst = (arrs["x"] % 2).to(torch.int64)
    blocks = [arrs["x"][v & (dst == j)] for j in range(ax.size)]
    return {"sum": int(ax.psum(xs.sum())), "max": int(ax.pmax(arrs["x"].max())),
            "gathered": ax.all_gather(v.sum()).tolist(),
            "routed": torch.cat(ax.all_to_all(blocks)).tolist(), "index": ax.index}

res = device_view(body, mesh, ("sharded", "sharded"), counts)(shards, valid)[0]
res["counts"] = counts
json.dump(res, open(out, "w"))
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _job(tmp_path, code):
    script = tmp_path / "child.py"
    script.write_text(code)
    port = _free_port()
    outs = [str(tmp_path / f"out{r}.json") for r in range(2)]
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, str(script), REPO, str(r), str(port), outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
             for r in range(2)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)[-4000:]
    return [json.load(open(o)) for o in outs]


def test_two_process_mesh_build(tmp_path):
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.parallel import mesh as pm
    res = _job(tmp_path, CHILD)
    assert [r["info"]["process_count"] for r in res] == [2, 2]
    assert [r["info"]["process_index"] for r in res] == [0, 1]
    # Row conservation.
    assert sorted(res[0]["keys"] + res[1]["keys"]) == sorted(res[0]["keys_in"]
                                                             + res[1]["keys_in"])
    for rank, r in enumerate(res):
        keys = torch.tensor(r["keys"], dtype=torch.int64)
        host_bids = kernels.bucket_ids(kernels.hash32_values(keys, "int64"), 16)
        # Bucket agreement with the single-process hash, single ownership,
        # and each bucket sorted by key.
        assert host_bids.tolist() == r["bids"]
        assert (pm.bucket_owner(host_bids, 2, 16) == rank).all()
        pairs = list(zip(r["bids"], r["keys"]))
        assert pairs == sorted(pairs)
    # The string union: one dictionary, every string kept.
    assert res[0]["dictionary"] == res[1]["dictionary"]
    assert set(res[0]["dictionary"]) == set(res[0]["strings_in"]) | set(res[1]["strings_in"])
    assert sorted(res[0]["strings"] + res[1]["strings"]) == \
        sorted(res[0]["strings_in"] + res[1]["strings_in"])
    assert [r["union_count"] for r in res] == [1, 1]
    # cluster.gather=native gathers over the group.
    want = [[0, res[0]["rows_in"]], [1, res[1]["rows_in"]]]
    assert res[0]["gathered"] == res[1]["gathered"] == want


def test_two_process_collectives(tmp_path):
    res = _job(tmp_path, SPMD_CHILD)
    xs = list(range(0, 6)) + list(range(10, 17))
    for rank, r in enumerate(res):
        assert r["index"] == rank
        assert r["sum"] == sum(xs)
        assert r["max"] == 16
        assert r["gathered"] == [6, 7]
        assert r["routed"] == [v for v in xs if v % 2 == rank]
    assert res[0]["counts"] == {"all-reduce": 2, "all-gather": 1, "all-to-all": 1}


def test_native_gather_needs_a_process_group():
    from hyperspace_tpu_torch.cluster import gather
    try:
        gather.init_process(0, 2, "no-group")
        gather.force_mode("native")
        with pytest.raises(gather.NativeGatherUnavailable, match="process group"):
            gather.allgather(np.array([1]))
    finally:
        gather.reset_for_tests()


def test_multi_process_mesh_refuses_a_full_copy():
    from hyperspace_tpu_torch.parallel import mesh as pm
    mesh = pm.Mesh([torch.device("cpu")], processes=2, rank=0)
    assert mesh.size == 2 and mesh.multiprocess
    with pytest.raises(NotImplementedError, match="process-local"):
        pm.pad_and_shard(mesh, {"x": torch.arange(4)}, 4)


def test_single_process_needs_no_group():
    from hyperspace_tpu_torch.parallel import multihost
    info = multihost.initialize_multihost()
    assert info["initialized"] is False and info["process_count"] == 1
    assert multihost.global_mesh("cpu").size == 1
    if not torch.cuda.is_available():
        with pytest.raises(Exception, match="no CUDA device"):
            multihost.global_mesh()
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize_multihost("127.0.0.1:1", 1)


def _cards(monkeypatch, n: int, current: list) -> None:
    """``n`` visible cards without a card: what CUDA's device calls report."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: current.append(int(d)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[-1])


def test_global_mesh_is_every_card_without_a_group(monkeypatch):
    """One process: the mesh is ``make_mesh()``, every visible card, as
    the reference's ``global_mesh()`` is every device."""
    from hyperspace_tpu_torch.parallel import multihost
    _cards(monkeypatch, 2, [0])
    mesh = multihost.global_mesh()
    assert mesh.platform == "cuda"
    assert mesh.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert not mesh.multiprocess


@pytest.mark.parametrize("backend,local_rank,card", [("nccl", None, 1), ("gloo", None, 1),
                                                     ("nccl", 0, 0)])
def test_each_rank_drives_its_own_card(monkeypatch, backend, local_rank, card):
    """Under a group, rank 3 of a job on 2-card hosts drives card 3 % 2
    (or ``local_rank``), whatever the backend: its mesh, and so its
    collectives and the native gather, are on that card."""
    import torch.distributed as dist

    from hyperspace_tpu_torch.cluster import gather
    from hyperspace_tpu_torch.parallel import multihost
    current = [0]
    _cards(monkeypatch, 2, current)
    joined = {}

    def init(b, init_method, world_size, rank):
        joined.update(backend=b, world=world_size, rank=rank)

    monkeypatch.setattr(dist, "is_initialized", lambda: bool(joined))
    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(dist, "get_rank", lambda: joined["rank"])
    monkeypatch.setattr(dist, "get_world_size", lambda: joined["world"])
    monkeypatch.setattr(gather, "init_process", lambda *a: None)
    monkeypatch.setattr(multihost, "_COORDINATOR", "")
    info = multihost.initialize_multihost("127.0.0.1:1", 4, 3, backend=backend,
                                          local_rank=local_rank)
    assert joined == {"backend": backend, "world": 4, "rank": 3}
    assert info["process_index"] == 3 and info["process_count"] == 4
    assert current[-1] == card
    mesh = multihost.global_mesh()
    assert mesh.platform == "cuda" and mesh.devices == [torch.device("cuda", card)]
    assert (mesh.processes, mesh.rank, mesh.size) == (4, 3, 4)
