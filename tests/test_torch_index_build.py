"""The port's index build against the JAX package's, on the same
numpy-seeded inputs: bucket ids, the (bucket, indexed columns) sort
permutation and the bucket boundaries are equal exactly.

JAX side runs with its Pallas kernels on (interpret mode) and off, so both
of its boundary paths -- histogram + cumsum and searchsorted -- are held
against the port's histogram + cumsum.
"""

import numpy as np
import pyarrow as pa
import pytest

from hyperspace_tpu.execution.columnar import Table as JTable
from hyperspace_tpu.ops import index_build as jib
from hyperspace_tpu.ops import kernels as jk
from hyperspace_tpu.ops import pallas_kernels
from hyperspace_tpu_torch.execution.columnar import Table as TTable
from hyperspace_tpu_torch.ops import index_build as tib
from hyperspace_tpu_torch.ops import kernels as tk


@pytest.fixture(params=["on", "off"])
def pallas_mode(request):
    pallas_kernels.set_mode(request.param)
    yield request.param
    pallas_kernels.set_mode("auto")


def arrow_table(n: int, seed: int) -> pa.Table:
    """Lineitem-shaped keys with collisions (so within-bucket ties and the
    stable order matter), negative int64s, float -0.0/NaN, strings and
    NULLs."""
    rng = np.random.default_rng(seed)
    okey = rng.integers(-50, max(n // 3, 4), n).astype(np.int64)
    price = np.round(rng.uniform(-10, 10, n), 0)
    price[: min(n, 4)] = np.array([-0.0, 0.0, np.nan, -np.inf])[: n]
    nulls = rng.random(n) < 0.1
    return pa.table({
        "l_orderkey": pa.array(okey),
        "l_shipdate": pa.array(rng.integers(9000, 9100, n).astype(np.int32),
                               type=pa.int32()).cast(pa.date32()),
        "l_extendedprice": pa.array(price),
        "l_discount": pa.array(np.round(rng.uniform(0, 0.1, n), 2)),
        "s": pa.array(rng.choice(["x", "yy", "z", ""], n), mask=nulls),
        "i32": pa.array(rng.integers(-5, 5, n).astype(np.int32), mask=nulls),
        "row": pa.array(np.arange(n, dtype=np.int64)),
    })


COLUMN_SETS = [["l_orderkey"], ["l_shipdate"], ["l_extendedprice"], ["s"],
               ["l_shipdate", "l_orderkey"], ["s", "i32", "l_extendedprice"]]


@pytest.mark.parametrize("n", [3, 130, 4099])
@pytest.mark.parametrize("num_buckets", [4, 8, 37])
@pytest.mark.parametrize("cols", COLUMN_SETS)
def test_bucket_ids_for_matches(pallas_mode, cols, num_buckets, n):
    at = arrow_table(n, seed=n + num_buckets)
    want = np.asarray(jib.bucket_ids_for(JTable.from_arrow(at), cols, num_buckets))
    got = tib.bucket_ids_for(TTable.from_arrow(at, "cpu"), cols, num_buckets)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_buckets", [4, 8, 32, 37])
@pytest.mark.parametrize("cols", COLUMN_SETS)
def test_build_sorted_buckets_matches(pallas_mode, cols, num_buckets):
    at = arrow_table(2000, seed=num_buckets)
    jt, tt = JTable.from_arrow(at), TTable.from_arrow(at, "cpu")
    j_sorted, j_bounds = jib.build_sorted_buckets(jt, cols, num_buckets)
    t_sorted, t_bounds = tib.build_sorted_buckets(tt, cols, num_buckets)
    np.testing.assert_array_equal(t_bounds, np.asarray(j_bounds))
    # The "row" column carries the source position: equal rows mean the
    # same permutation, stable ties included.
    np.testing.assert_array_equal(t_sorted.column("row").data.numpy(),
                                  np.asarray(j_sorted.column("row").data))
    assert t_bounds[-1] == 2000 and t_bounds[0] == 0


@pytest.mark.parametrize("cols", COLUMN_SETS)
def test_lex_sort_indices_matches(cols):
    at = arrow_table(3000, seed=1)
    jt, tt = JTable.from_arrow(at), TTable.from_arrow(at, "cpu")
    jbids = jib.bucket_ids_for(jt, cols, 8)
    tbids = tib.bucket_ids_for(tt, cols, 8)
    want = jk.lex_sort_indices([jbids] + [jt.column(c).data for c in cols], pad=False)
    got = tk.lex_sort_indices([tbids] + [tt.column(c).data for c in cols])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bucket", [0, 7, 199, 12345])
def test_bucket_file_names_match(bucket):
    name = tib.bucket_file_name(bucket)
    assert name == jib.bucket_file_name(bucket)
    assert tib.bucket_id_from_file(f"/x/v__=0/{name}") == bucket
    assert tib.bucket_id_from_file("/x/other.parquet") is None
