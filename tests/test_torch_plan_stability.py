"""The plan-stability query set of ``tests/test_plan_stability.py`` (68
TPC-H and TPC-DS shaped DataFrame queries over ``tests/goldstandard/tpc.py``'s
tables) through the port: every optimized plan, with hyperspace disabled
and with its indexes enabled, must equal the golden file
(``tests/resources/golden_plans/{disabled,enabled}/<name>.txt``, normalized
as that test normalizes it), exactly. The answers must equal the JAX
package's staged path (fusion and the distributed tier off) bit for bit,
hyperspace disabled; and the port's indexed answers must equal its scanned
ones after sorting rows (keys exact, float64 within 1e-9 relative: an index
scan adds sums in bucket order), as the JAX test holds them.

``tpc.queries`` builds the queries with the JAX package's expression
builders. Its torch twin is the same function body with the builders
imported from ``hyperspace_tpu_torch.plan.expr``; the test asserts its query
names equal ``tpc.QUERY_NAMES``.
"""

import datetime
import inspect

import numpy as np
import pyarrow as pa
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from goldstandard import tpc
from hyperspace_tpu_torch.index.constants import IndexConstants
from test_plan_stability import GOLDEN_DIR, normalize_plan
from test_torch_sql import assert_same

JAX_CONF = {"hyperspace.tpu.distributed.enabled": "false",
            "hyperspace.tpu.execution.fusion.enabled": "false",
            IndexConstants.INDEX_NUM_BUCKETS: "4"}


def torch_queries(dfs):
    """``tpc.queries`` over port DataFrames, with the port's builders."""
    source = inspect.getsource(tpc.queries).replace(
        "from hyperspace_tpu.plan.expr import", "from hyperspace_tpu_torch.plan.expr import")
    namespace = {"datetime": datetime, "QUERY_NAMES": tpc.QUERY_NAMES}
    exec(compile(source, tpc.__file__, "exec"), namespace)
    return namespace["queries"](dfs)


def torch_index_config(cfg):
    if isinstance(cfg, hst.DataSkippingIndexConfig):
        return ht.DataSkippingIndexConfig(cfg.index_name, [
            ht.MinMaxSketch(s.column) for s in cfg.sketches])
    return ht.IndexConfig(cfg.index_name, list(cfg.indexed_columns),
                          list(cfg.included_columns))


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_tpc")
    session = ht.Session(system_path=str(root / "indexes"), device="cpu")
    session.conf.set(IndexConstants.INDEX_NUM_BUCKETS, 4)
    dfs = tpc.register_tables(session, str(root / "data"))
    hs = ht.Hyperspace(session)
    for cfg in tpc.index_configs():
        hs.create_index(dfs[tpc.INDEXED_TABLES[cfg.index_name]], torch_index_config(cfg))
    jax_session = hst.Session(conf=dict(JAX_CONF), system_path=str(root / "jax_indexes"))
    jax_queries = tpc.queries(tpc.register_tables(jax_session, str(root / "data")))
    return session, torch_queries(dfs), jax_queries


def test_twin_builds_every_query(harness):
    _, queries, jax_queries = harness
    assert sorted(queries) == sorted(tpc.QUERY_NAMES) == sorted(jax_queries)


def sorted_rows(table: pa.Table) -> pa.Table:
    return table.sort_by([(c, "ascending") for c in table.column_names])


@pytest.mark.parametrize("name", tpc.QUERY_NAMES)
class TestTorchPlanStability:
    def test_disabled(self, harness, name):
        session, queries, _ = harness
        session.disable_hyperspace()
        with open(f"{GOLDEN_DIR}/disabled/{name}.txt") as f:
            assert normalize_plan(queries[name].optimized_plan().tree_string()) == f.read()

    def test_enabled(self, harness, name):
        session, queries, _ = harness
        session.enable_hyperspace()
        try:
            plan = queries[name].optimized_plan().tree_string()
        finally:
            session.disable_hyperspace()
        with open(f"{GOLDEN_DIR}/enabled/{name}.txt") as f:
            assert normalize_plan(plan) == f.read()

    def test_answers_equal_jax(self, harness, name):
        session, queries, jax_queries = harness
        session.disable_hyperspace()
        without = queries[name].to_arrow()
        assert_same(without, jax_queries[name].to_arrow())
        session.enable_hyperspace()
        try:
            with_idx = queries[name].to_arrow()
        finally:
            session.disable_hyperspace()
        a, b = sorted_rows(with_idx), sorted_rows(without)
        assert a.column_names == b.column_names and a.num_rows == b.num_rows
        for column in a.column_names:
            x, y = a.column(column), b.column(column)
            if pa.types.is_floating(x.type):
                np.testing.assert_allclose(x.to_numpy(zero_copy_only=False),
                                           y.to_numpy(zero_copy_only=False), rtol=1e-9)
            else:
                assert x.equals(y), column


class TestTorchExplainGolden:
    """The port's rendered explain against the explain golden files
    (``tests/resources/golden_plans/explain/{plaintext,console,html}/``),
    as ``tests/test_plan_stability.py``'s TestExplainGolden holds the JAX
    package's: the plan-only explain (``diagnostics=False``: the runtime
    sections read process-wide counters), verbose, in every display mode."""

    CASES = ["tpch_q6", "tpch_q3", "groupby_index", "tpch_q1"]

    @pytest.mark.parametrize("name", CASES)
    @pytest.mark.parametrize("mode", ["plaintext", "console", "html"])
    def test_rendered_explain(self, harness, name, mode):
        from hyperspace_tpu_torch.plananalysis.explain import explain_string

        session, queries, _ = harness
        out = explain_string(session, queries[name].plan, verbose=True, mode=mode,
                             diagnostics=False)
        with open(f"{GOLDEN_DIR}/explain/{mode}/{name}.txt") as f:
            assert normalize_plan(out) == f.read()
