"""The program bank (``hyperspace_tpu_torch/serving/program_bank.py``)
against the JAX package's (``hyperspace_tpu/serving/program_bank.py``).

Each case starts both packages with a fresh bank and runs the same query
sequence through each on the same numpy-seeded files, the JAX package on
the CPU, the port with ``device="cpu"``: staged filters, projections and
aggregate children (the fused predicate and arithmetic stages), fused
regions, a ``shapeBucketing`` change, and mesh programs on the 8-device
CPU mesh. The bank's ``stats()`` must be equal, and so must the sequence
of its events by (event, stage kind, shape vector). The LRU eviction, the
``bank.compile`` fault (same rows, ``degraded_bank_compile`` moves), and
explain's "program bank:" and explain_analyze's "bank:" lines are held to
the reference's too.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as hj
import hyperspace_tpu_torch as ht
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.serving import program_bank as jbank
from hyperspace_tpu_torch.index.constants import IndexConstants as IC
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.serving import program_bank as tbank

PKGS = {"jax": (hj, JE, jbank), "torch": (ht, TE, tbank)}
FUSION = IC.TPU_FUSION_ENABLED
DIST = IC.TPU_DISTRIBUTED_ENABLED


@pytest.fixture()
def banks(monkeypatch):
    """Fresh banks in both packages, each recording (event, stage kind,
    shape vector) per emitted event, and empty buffer pools (a pooled read
    keeps the length class it was read at in the JAX package)."""
    from hyperspace_tpu.execution import buffer_pool as jbp
    from hyperspace_tpu_torch.execution import buffer_pool as tbp
    jbp.get_pool().clear()
    tbp.get_pool().clear()
    seen = {"jax": [], "torch": []}
    for pkg, (_, _, mod) in PKGS.items():
        monkeypatch.setattr(mod, "_BANK", None)
        orig = mod.ProgramBank._emit

        def emit(self, stage_key, shape_vec, hit, first_reuse, _orig=orig, _log=seen[pkg]):
            if not hit or first_reuse:
                _log.append(("hit" if hit else "miss", stage_key[0], tuple(shape_vec)))
            return _orig(self, stage_key, shape_vec, hit, first_reuse)
        monkeypatch.setattr(mod.ProgramBank, "_emit", emit)
    return seen


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = tmp_path_factory.mktemp("bank_lake")
    rng = np.random.default_rng(19)
    n = 3000
    fact = pa.table({
        "k": rng.integers(0, 200, n).astype(np.int64),
        "qty": rng.integers(1, 50, n).astype(np.int64),
        "v": np.round(rng.uniform(1, 100, n), 2),
        "d": pa.array(np.round(rng.uniform(0, 0.1, n), 3), mask=rng.random(n) < 0.1),
        "tag": rng.choice(["a", "b", "c"], n),
    })
    dim = pa.table({"dk": np.arange(200, dtype=np.int64),
                    "w": rng.integers(0, 9, 200).astype(np.int64)})
    dirs = {}
    for name, table, parts in (("fact", fact, 3), ("dim", dim, 1)):
        d = root / name
        d.mkdir()
        step = -(-table.num_rows // parts)
        for i in range(parts):
            pq.write_table(table.slice(i * step, step), str(d / f"p{i}.parquet"))
        dirs[name] = str(d)
    return {"root": root, "dirs": dirs}


def _session(pkg, path, conf):
    mod = PKGS[pkg][0]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return mod.Session(conf=dict(conf), system_path=str(path), **kw)


def _queries(s, E, dirs):
    fact = s.read.parquet(dirs["fact"])
    dim = s.read.parquet(dirs["dim"])
    return [
        fact.filter(E.col("qty") > 25).select("k", "v"),
        fact.filter(E.col("qty") > 30).select("k", "v"),
        fact.filter((E.col("tag") == "b") & (E.col("d") < 0.05)).select("v"),
        fact.select((E.col("v") * (1 - E.col("d"))).alias("rev"), "k"),
        fact.filter(E.col("k") < 100).agg(E.sum_(E.col("v") * E.col("qty")).alias("s")),
        fact.filter(E.col("k") < 50).agg(E.sum_(E.col("v") * E.col("qty")).alias("s")),
        fact.join(dim, on=E.col("k") == E.col("dk")).filter(E.col("w") > 3).agg(
            E.sum_(E.col("v")).alias("s")),
    ]


def run_sequence(pkg, root, dirs, steps):
    """Run ``steps`` ([(conf, query index)]) through one session of
    ``pkg``; returns the answers and the bank's stats."""
    mod, E, bankmod = PKGS[pkg]
    s = _session(pkg, root / pkg, {})
    answers = []
    for conf, qi in steps:
        for k, v in conf.items():
            s.conf.set(k, v)
        answers.append(_queries(s, E, dirs)[qi].to_arrow())
    return answers, bankmod.get_bank().stats()


STAGED = {FUSION: "false", DIST: "false"}
FUSED = {FUSION: "true", DIST: "false"}
SEQUENCES = {
    "staged": [(STAGED, i) for i in (0, 1, 0, 2, 3, 4, 5, 4, 6)],
    "fused": [(FUSED, i) for i in (4, 5, 6, 6, 0, 3)],
    "mixed": [(STAGED, 0), (FUSED, 4), (STAGED, 4), (FUSED, 5), (STAGED, 1)],
    # Each conf change reads anew (another pushed literal), and the last
    # repeats a read made under the same conf: the JAX package's buffer
    # pool keeps a read at the class it was padded to (ROADMAP queue C).
    "bucketing": [(STAGED, 0), ({IC.TPU_SHAPE_BUCKETING_GROWTH_FACTOR: "1.5"}, 1),
                  ({IC.TPU_SHAPE_BUCKETING_ENABLED: "false"}, 2),
                  ({IC.TPU_SHAPE_BUCKETING_ENABLED: "true",
                    IC.TPU_SHAPE_BUCKETING_GROWTH_FACTOR: "2.0"}, 0), (FUSED, 4)],
}


def assert_same(got, want):
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        if name in ("s", "rev", "v"):
            np.testing.assert_allclose(np.array(g, dtype=float), np.array(w, dtype=float),
                                       rtol=1e-12)
        else:
            assert g == w


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_bank_counts_equal_jax(banks, lake, tmp_path, name):
    out = {pkg: run_sequence(pkg, tmp_path, lake["dirs"], SEQUENCES[name]) for pkg in PKGS}
    for got, want in zip(out["torch"][0], out["jax"][0]):
        assert_same(got, want)
    assert out["torch"][1] == out["jax"][1]
    assert banks["torch"] == banks["jax"]
    assert out["torch"][1]["misses"] > 0 and out["torch"][1]["hits"] > 0


MESH_CONF = {DIST: "true", IC.TPU_DISTRIBUTED_MIN_STREAM_ROWS: "0"}


def test_mesh_program_counts_equal_jax(banks, lake, tmp_path, monkeypatch):
    """The SPMD dispatch on the 8-device CPU mesh (the JAX package's 8
    virtual devices; the port's mesh of 8 CPU entries): one "exec" stage
    per program structure, one program per argument shape signature."""
    monkeypatch.setattr("hyperspace_tpu_torch.parallel.mesh.mesh_devices",
                        lambda session=None: [torch.device("cpu")] * 8)
    steps = [(MESH_CONF, 4), (MESH_CONF, 4), (MESH_CONF, 5), (MESH_CONF, 0)]
    out = {pkg: run_sequence(pkg, tmp_path, lake["dirs"], steps) for pkg in PKGS}
    for got, want in zip(out["torch"][0], out["jax"][0]):
        assert_same(got, want)
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][1]["stages_by_kind"].get("spmd", 0) > 0
    assert [e[:2] for e in banks["torch"]] == [e[:2] for e in banks["jax"]]


@pytest.mark.parametrize("max_stages", [1, 2, 3])
def test_lru_eviction_equals_jax(max_stages):
    keys = [("fused-predicate", i % 4) for i in (0, 1, 0, 2, 3, 1, 0, 2)]
    stats = {}
    for pkg, (_, _, mod) in PKGS.items():
        bank = mod.ProgramBank(max_stages=max_stages)
        for i, k in enumerate(keys):
            bank.lookup(k, (1024 * (i % 2),), lambda: len)
        stats[pkg] = bank.stats()
    assert stats["torch"] == stats["jax"]
    assert stats["torch"]["evictions"] > 0 and stats["torch"]["stages"] == max_stages


@pytest.mark.parametrize("degrade", ["true", "false"])
def test_bank_compile_fault_equals_jax(banks, lake, tmp_path, degrade):
    """Armed ``bank.compile``: with degrade on the stage runs uncached (same
    rows) and ``degraded_bank_compile`` moves; off, the query raises in
    both packages."""
    from hyperspace_tpu.robustness import faults as jfaults
    from hyperspace_tpu_torch.robustness import faults as tfaults
    conf = dict(STAGED, **{"hyperspace.tpu.robustness.faults.bank.compile": "error:nth=1",
                           "hyperspace.tpu.robustness.degrade.enabled": degrade})
    got = {}
    for pkg, faults in (("jax", jfaults), ("torch", tfaults)):
        mod, E, bankmod = PKGS[pkg]
        s = _session(pkg, tmp_path / pkg, conf)
        before = faults.stats()["degraded_bank_compile"]
        q = _queries(s, E, lake["dirs"])[0]
        if degrade == "false":
            with pytest.raises(Exception, match="bank.compile"):
                q.to_arrow()
            got[pkg] = (None, faults.stats()["degraded_bank_compile"] - before)
            continue
        table = q.to_arrow()
        got[pkg] = (table, faults.stats()["degraded_bank_compile"] - before,
                    bankmod.get_bank().stats())
    if degrade == "true":
        assert_same(got["torch"][0], got["jax"][0])
        assert got["torch"][1:] == got["jax"][1:]
        assert got["torch"][1] == 1
    else:
        assert got["torch"][1] == got["jax"][1] == 0


def test_explain_and_analyze_bank_lines_equal_jax(banks, lake, tmp_path):
    conf = dict(STAGED, **{"hyperspace.tpu.serving.enabled": "true"})
    lines = {}
    for pkg in PKGS:
        mod, E, _ = PKGS[pkg]
        s = _session(pkg, tmp_path / pkg, conf)
        hs = mod.Hyperspace(s)
        q = _queries(s, E, lake["dirs"])
        q[0].to_arrow()
        analyze = [hs.explain_analyze(df) for df in (q[1], q[4], q[4])]
        text = hs.explain(q[0]) if pkg == "torch" else None
        if pkg == "jax":
            from hyperspace_tpu.plananalysis.explain import explain_string
            text = explain_string(s, q[0].plan)
        else:
            from hyperspace_tpu_torch.plananalysis.explain import explain_string
            text = explain_string(s, q[0].plan)
        lines[pkg] = ([ln for ln in text.splitlines() if ln.startswith("program bank:")],
                      [[ln for ln in a.splitlines() if ln.startswith("bank:")] for a in analyze])
    assert lines["torch"] == lines["jax"]
    assert len(lines["torch"][0]) == 1
    assert lines["torch"][1][0] == ["bank: hits=+1"]
    assert lines["torch"][1][2] != ["bank: no traffic"]


def test_metrics_and_serving_stats_carry_the_bank(banks, lake, tmp_path):
    s = _session("torch", tmp_path / "t", STAGED)
    _queries(s, TE, lake["dirs"])[0].to_arrow()
    hs = ht.Hyperspace(s)
    want = tbank.get_bank().stats()
    assert hs.metrics()["collectors"]["program_bank"] == want
    assert hs.serving_stats()["program_bank"] == want
    assert want["stages_by_kind"] == {"fused-predicate": 1}
