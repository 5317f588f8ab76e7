"""The TPC-DS texts of ``tests/goldstandard/tpcds_real.py`` -- every one
the SQL grammar covers -- through both packages' ``session.sql`` on the
same files, compared on answers: keys, counts and strings exact, float64
values bit for bit against the JAX package's staged path
(``hyperspace.tpu.execution.fusion.enabled=false``), indexes off. With
indexes on, the port's answer equals its scanned one: keys, counts and
strings exact, float64 within 1e-9 relative, since an index scan reads
the rows in bucket order and a sum adds them in that order (the JAX
package's indexed answers differ from its scanned ones in the same way).

The port's optimized plans are also held to the JAX package's golden
files (``tests/resources/golden_plans/{enabled,disabled}/``, normalized by
``tests/test_tpcds_real.normalize_plan``): one case per file, exact.

The JAX side runs on the CPU with its distributed tier off; the port runs
its plain torch paths on CPU tensors.
"""

import os

import numpy as np
import pyarrow as pa
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from goldstandard import tpcds_real
from hyperspace_tpu_torch.index.constants import IndexConstants
from test_torch_sql import assert_same
from test_tpcds_real import GOLDEN_DIR, normalize_plan

CONF = {IndexConstants.INDEX_NUM_BUCKETS: "4", "hyperspace.tpu.distributed.enabled": "false",
        "hyperspace.tpu.execution.fusion.enabled": "false"}


@pytest.fixture(scope="module")
def lakes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_tpcds"))
    jax_session = hst.Session(conf=dict(CONF), system_path=os.path.join(root, "jax"))
    tpcds_real.register_tables(jax_session, os.path.join(root, "data"))
    # The golden files name the index root ".../indexes/".
    torch_session = ht.Session(conf=dict(CONF), system_path=os.path.join(root, "indexes"),
                               device="cpu")
    for name in sorted(os.listdir(os.path.join(root, "data"))):
        torch_session.create_temp_view(
            name, torch_session.read.parquet(os.path.join(root, "data", name)))
    hs = ht.Hyperspace(torch_session)
    for table, cfg in tpcds_real.index_configs():
        hs.create_index(torch_session.table(table), ht.IndexConfig(
            cfg.index_name, list(cfg.indexed_columns), list(cfg.included_columns)))
    return {"jax": jax_session, "torch": torch_session}


@pytest.mark.parametrize("name", tpcds_real.QUERY_NAMES)
def test_tpcds_text_equals_jax(lakes, name):
    text = tpcds_real.QUERY_TEXTS[name]
    want = lakes["jax"].sql(text).to_arrow()
    session = lakes["torch"]
    got = session.sql(text).to_arrow()
    assert_same(got, want)
    session.enable_hyperspace()
    try:
        indexed = session.sql(text).to_arrow()
    finally:
        session.disable_hyperspace()
    assert indexed.schema == got.schema and indexed.num_rows == got.num_rows
    for column in got.column_names:
        a, b = indexed.column(column), got.column(column)
        if pa.types.is_float64(b.type):
            x = a.to_numpy(zero_copy_only=False)
            y = b.to_numpy(zero_copy_only=False)
            assert np.array_equal(np.isnan(x), np.isnan(y)), column
            assert np.allclose(x, y, rtol=1e-9, atol=0.0, equal_nan=True), column
        else:
            assert a.equals(b), column


@pytest.mark.parametrize("mode", ["disabled", "enabled"])
@pytest.mark.parametrize("name", tpcds_real.QUERY_NAMES)
def test_tpcds_plan_equals_golden_file(lakes, name, mode):
    session = lakes["torch"]
    (session.enable_hyperspace if mode == "enabled" else session.disable_hyperspace)()
    try:
        plan = session.sql(tpcds_real.QUERY_TEXTS[name]).optimized_plan().tree_string()
    finally:
        session.disable_hyperspace()
    with open(os.path.join(GOLDEN_DIR, mode, f"{name}.txt")) as f:
        assert normalize_plan(plan) == f.read()
