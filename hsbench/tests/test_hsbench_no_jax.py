"""Nothing the benchmark runs imports JAX or the JAX package: every
module of hsbench/ and a whole run of a cell (on the CPU, tiny) leave no
module whose top-level name is jax, jaxlib, flax or hyperspace_tpu in
``sys.modules``. Names are compared whole, before the first dot:
hyperspace_tpu_torch is the system under test."""

import ast
import os
import subprocess
import sys
import textwrap

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "hyperspace_tpu"}


def test_no_source_imports_them():
    for base, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(base, f)).read())
            for node in ast.walk(tree):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                    [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level \
                    else []
                assert not {n.split(".")[0] for n in names} & FORBIDDEN, (f, names)


def test_a_run_loads_none_of_them():
    probe = textwrap.dedent('''
        import importlib, pkgutil, sys
        sys.path.insert(0, sys.argv[1])
        import hsbench
        for m in pkgutil.walk_packages(hsbench.__path__, "hsbench."):
            if ".tests" not in m.name:
                importlib.import_module(m.name)
        from hsbench import harness
        r = harness.run_cell("tpch_sf10.join_indexed", 5, 1.0, True, device="cpu",
                             scale=0.002, overrides={"warmup_s": 0.3})
        assert r["correct"], r
        print(sorted({m.split(".")[0] for m in sys.modules}))
    ''')
    out = subprocess.run([sys.executable, "-c", probe, ROOT], capture_output=True, text=True,
                         cwd=ROOT, timeout=600, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "hyperspace_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
