"""Nothing the benchmark runs loads JAX or the JAX package; the references
load nothing of the port."""

import ast
import os
import subprocess
import sys

from bench_port.lib import registry

HERE = os.path.join(registry.ROOT, "bench_port")
FORBIDDEN = {"jax", "jaxlib", "flax", "incrementalinference"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_imports_jax_or_the_jax_package():
    found = {(p, m) for p in _sources() for m in _imports(p)
             if m.split(".")[0] in FORBIDDEN}
    assert not found


def test_the_references_import_nothing_of_the_port():
    ref = os.path.join(HERE, "reference")
    found = {(p, m) for p in _sources() if p.startswith(ref)
             for m in _imports(p)
             if m.split(".")[0] == "incrementalinference_torch"}
    assert not found


def test_a_run_leaves_no_jax_module_loaded():
    script = (
        "import sys, torch\n"
        f"sys.path.insert(0, {registry.ROOT!r})\n"
        "from bench_port import run\n"
        "from bench_port.lib import registry\n"
        "b = registry.benchmark()\n"
        "for w in [w['name'] for w in b['workloads']]:\n"
        "    cell = registry.cell(b, w)\n"
        "    cell['cfg']['N'] = 24\n"
        "    a = run.parse(['--workload', w, '--seed', '9', '--seconds',"
        " '0.01', '--trace', '0'])\n"
        "    assert run.execute(a, b, cell, torch.device('cpu')) == 0\n"
        "print('FORBIDDEN', run.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600, cwd=registry.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "FORBIDDEN []"
