"""What the benchmark may import: nothing of JAX, the JAX package or the
root ``bench.py`` anywhere under ``benchmark/`` (top-level module names
compared whole), and nothing of the program in the reference."""

import ast
import os
import subprocess
import sys

from benchmark.catalog import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "doppelspeller_tpu", "bench"}


def _modules():
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_the_jax_package_or_bench():
    found = {(os.path.relpath(p, ROOT), m) for p in _modules() for m in _imports(p) if m in FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH_DIR, "reference")
    found = {(p, m) for p in _modules() if p.startswith(ref) for m in _imports(p)
             if m == "doppelspeller_tpu_torch"}
    assert not found


def test_a_rehearsal_loads_no_jax(tmp_path):
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        "from benchmark.tests.helpers import tiny_catalog\n"
        "from benchmark.drive import run_cell, forbidden_modules\n"
        f"cat = tiny_catalog({str(tmp_path)!r})\n"
        "run_cell('tiny-exact.batch', 12345, 0.5, False, device='cpu', catalog=cat, log=lambda s: None)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'doppelspeller_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
