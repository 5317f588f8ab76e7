"""The port's mesh and launcher (``parallel/mesh.py``, ``parallel/
sharding.py``) and the SPMD path's leaf sharding, against the JAX
package's where both compute the same thing.

``pad_and_shard`` and ``pad_and_shard_blocks`` must give each device the
rows and the validity mask the JAX package's give it (compared shard by
shard with the JAX global arrays); the file-aligned bounds must be the
JAX package's; a per-device body's collectives combine in device order;
and the collective counts hold the properties the JAX tests assert.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax
import jax.numpy as jnp

from hyperspace_tpu.execution import spmd as jspmd
from hyperspace_tpu.parallel import mesh as jmesh
from hyperspace_tpu.parallel import sharding as jsharding
from hyperspace_tpu_torch import shapes as tshapes
from hyperspace_tpu_torch.execution import spmd as tspmd
from hyperspace_tpu_torch.parallel import mesh as tmesh
from hyperspace_tpu_torch.parallel import sharding as tsharding

CPU = torch.device("cpu")


def _tmesh(n):
    return tmesh.Mesh([CPU] * n)


@pytest.mark.parametrize("n_dev,rows,pad_rows", [(8, 1000, None), (8, 5, None), (2, 7, 64),
                                                 (8, 6000, 8192), (3, 10, None), (1, 9, 16)])
def test_pad_and_shard_equals_jax(n_dev, rows, pad_rows):
    x = np.arange(rows, dtype=np.int64) * 3 - 7
    jm = jmesh.make_mesh(jax.devices()[:n_dev])
    jarrs, jvalid = jmesh.pad_and_shard(jm, {"x": jnp.asarray(x)}, rows, pad_rows=pad_rows)
    tarrs, tvalid = tmesh.pad_and_shard(_tmesh(n_dev), {"x": torch.from_numpy(x)}, rows,
                                        pad_rows=pad_rows)
    jx = np.asarray(jarrs["x"]).reshape(n_dev, -1)
    jv = np.asarray(jvalid).reshape(n_dev, -1)
    assert len(tarrs["x"]) == len(tvalid) == n_dev
    for d in range(n_dev):
        np.testing.assert_array_equal(tarrs["x"][d].numpy(), jx[d])
        np.testing.assert_array_equal(tvalid[d].numpy(), jv[d])


@pytest.mark.parametrize("bounds,shard_rows", [([0, 3, 3, 9, 12], None), ([0, 4, 8, 10, 12], 6)])
def test_pad_and_shard_blocks_equals_jax(bounds, shard_rows):
    x = np.arange(12, dtype=np.float64) + 0.5
    jm = jmesh.make_mesh(jax.devices()[:4])
    jarrs, jvalid = jmesh.pad_and_shard_blocks(jm, {"x": jnp.asarray(x)}, bounds, shard_rows)
    tarrs, tvalid = tmesh.pad_and_shard_blocks(_tmesh(4), {"x": torch.from_numpy(x)}, bounds,
                                               shard_rows)
    jx = np.asarray(jarrs["x"]).reshape(4, -1)
    jv = np.asarray(jvalid).reshape(4, -1)
    for d in range(4):
        np.testing.assert_array_equal(tarrs["x"][d].numpy(), jx[d])
        np.testing.assert_array_equal(tvalid[d].numpy(), jv[d])


@pytest.mark.parametrize("n", [0, 1, 1000, 1024, 1025, 3000, 5_000_000, 6_000_000])
def test_length_classes_equal_jax(n):
    from hyperspace_tpu.execution.shapes import padded_length
    assert tshapes.padded_length(n) == padded_length(n)


@pytest.mark.parametrize("n_dev,buckets", [(8, 32), (3, 10), (8, 5)])
def test_bucket_ranges_and_owners_equal_jax(n_dev, buckets):
    ids = np.arange(buckets, dtype=np.int32)
    owners = tmesh.bucket_owner(torch.from_numpy(ids), n_dev, buckets).numpy()
    np.testing.assert_array_equal(owners, np.asarray(jmesh.bucket_owner(
        jnp.asarray(ids), n_dev, buckets)))
    for d in range(n_dev):
        assert tmesh.device_bucket_range(d, n_dev, buckets) == \
            jmesh.device_bucket_range(d, n_dev, buckets)


@pytest.mark.parametrize("counts", [[1000] * 6, [3000, 10, 10, 10, 10, 10],
                                    [700, 800, 900, 1000, 1100, 1200, 1300], [5, 5]])
def test_file_aligned_bounds_equal_jax(tmp_path, counts):
    from hyperspace_tpu_torch import Session as TSession
    import hyperspace_tpu as hj
    d = tmp_path / "t"
    d.mkdir()
    for i, c in enumerate(counts):
        pq.write_table(pa.table({"x": np.arange(c, dtype=np.int64)}), str(d / f"p{i}.parquet"))
    total = sum(counts)
    jleaf = hj.Session(system_path=str(tmp_path / "j")).read.parquet(str(d)).plan
    tleaf = TSession(system_path=str(tmp_path / "t2"), device="cpu").read.parquet(str(d)).plan
    fake = type("T", (), {"num_rows": total})()
    for n_dev in (2, 4, 8):
        assert tspmd._file_aligned_bounds(tleaf, fake, n_dev) == \
            jspmd._file_aligned_bounds(jleaf, fake, n_dev)


def test_psum_and_routing_semantics():
    """psum/pmax are replicated, all_to_all routes block j to device j, in
    source-device order (test_spmd_sharding.py's body, over 8 devices)."""
    n_dev, rows = 8, 64
    mesh = _tmesh(n_dev)
    x = torch.arange(rows, dtype=torch.int64)
    shards, valid = tmesh.pad_and_shard(mesh, {"x": x}, rows)
    counts = {}

    def body(ax, arrs, v):
        xs = arrs["x"]
        tot = ax.psum(torch.where(v, xs, torch.zeros_like(xs)).sum())
        mx = ax.pmax(xs.max())
        dst = xs % n_dev
        blocks = [xs[dst == j] for j in range(n_dev)]
        got = torch.cat(ax.all_to_all(blocks))
        return {"tot": tot, "mx": mx, "got": got, "idx": ax.index}

    outs = tsharding.device_view(body, mesh, ("sharded", "sharded"), counts)(shards, valid)
    for d, o in enumerate(outs):
        assert o["idx"] == d
        assert int(o["tot"]) == rows * (rows - 1) // 2
        assert int(o["mx"]) == rows - 1
        assert o["tot"].shape == ()
        assert o["got"].tolist() == [v for v in range(rows) if v % n_dev == d]
    assert counts == {"all-reduce": 2, "all-to-all": 1}


def test_float_psum_adds_in_device_order():
    """A float psum is the left fold of the devices' values in device
    order, whatever order the threads reach it in."""
    vals = [1e16, 1.0, -1e16, 1.0, 3.5, -2.25, 1e-3, 7.0]
    mesh = _tmesh(len(vals))
    shards = [torch.tensor([v], dtype=torch.float64) for v in vals]

    def body(ax, x):
        import time
        time.sleep(0.001 * (len(vals) - ax.index))
        return ax.psum(x[0])

    want = 0.0
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v
    want = acc
    outs = tsharding.device_view(body, mesh, ("sharded",))(shards)
    assert all(float(o) == want for o in outs)


def test_one_device_collectives_are_the_identity():
    mesh = _tmesh(1)

    def body(ax, x):
        return ax.psum(x), ax.all_gather(x), ax.all_to_all([x])

    (s, g, a), = tsharding.device_view(body, mesh, ("sharded",))([torch.tensor([4, 5])])
    assert s.tolist() == [4, 5] and g.tolist() == [[4, 5]] and a[0].tolist() == [4, 5]


def test_an_error_on_one_device_raises_without_hanging():
    mesh = _tmesh(4)

    def body(ax, x):
        if ax.index == 2:
            raise ValueError("device 2 failed")
        return ax.psum(x)

    with pytest.raises(ValueError, match="device 2 failed"):
        tsharding.device_view(body, mesh, ("sharded",))([torch.ones(1)] * 4)


def test_mesh_signature_distinguishes_meshes():
    full, half = _tmesh(8), _tmesh(4)
    assert tsharding.mesh_signature(full) != tsharding.mesh_signature(half)
    assert tsharding.mesh_signature(full) == (("d",), (8,), "cpu")
    jfull = jsharding.mesh_signature(jmesh.make_mesh(jax.devices()[:8]))
    assert tsharding.mesh_signature(full) == jfull


def test_make_mesh_needs_cuda_or_devices():
    assert tmesh.make_mesh([CPU, CPU]).size == 2
    if not torch.cuda.is_available():
        with pytest.raises(Exception, match="no CUDA device"):
            tmesh.make_mesh()


@pytest.mark.parametrize("devices,sort_on_mesh", [
    ([torch.device("cuda", 0)], False),
    ([torch.device("cuda", 0), torch.device("cuda", 1)], True),
    ([CPU] * 8, False),
])
def test_sample_sort_needs_a_cuda_mesh_of_several_devices(monkeypatch, devices, sort_on_mesh):
    """One card sorts the gathered rows once (the sample sort would sort
    the shard for splitters, exchange with itself and sort again); a CPU
    mesh sorts on the host; a mesh of several cards takes the sample sort
    (ROADMAP queue C item 23)."""
    monkeypatch.setattr(tmesh, "mesh_devices", lambda session=None: list(devices))
    assert tspmd._use_spmd_sort(None) is sort_on_mesh


@pytest.mark.parametrize("n_dev,rows", [(1, 1000), (1, 5000), (8, 1000), (2, 5000)])
def test_one_device_shard_is_the_leaf_unpadded(n_dev, rows):
    """Several devices pad the leaf to the reference's length class, so
    their shard boundaries are the reference's; one device has no boundary
    to match, and its shard is the leaf itself, not a padded copy."""
    mesh = _tmesh(n_dev)
    x = torch.arange(rows, dtype=torch.int64)
    shards, valid = tmesh.pad_and_shard(mesh, {"x": x}, rows,
                                        pad_rows=tspmd._pad_rows(mesh, rows))
    if n_dev == 1:
        assert tspmd._pad_rows(mesh, rows) is None
        assert shards["x"][0].data_ptr() == x.data_ptr() and shards["x"][0].shape[0] == rows
        assert bool(valid[0].all())
    else:
        assert tspmd._pad_rows(mesh, rows) == tshapes.padded_length(rows)
        assert sum(int(s.shape[0]) for s in shards["x"]) == tshapes.padded_length(rows)


def test_session_mesh_lists_the_session_devices(monkeypatch, tmp_path):
    """``session_mesh`` is the mesh over ``mesh_devices``, the one function
    the tests replace: a CPU session's mesh is its one CPU device, and a
    replaced list is the mesh the dispatch and the mesh build take."""
    import hyperspace_tpu_torch as ht
    s = ht.Session(system_path=str(tmp_path), device="cpu")
    assert tmesh.session_mesh(s).devices == [CPU]
    monkeypatch.setattr(tmesh, "mesh_devices", lambda session=None: [CPU] * 8)
    assert tmesh.session_mesh(s).size == 8
