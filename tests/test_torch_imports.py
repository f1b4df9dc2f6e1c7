"""The port stands alone: no module of incrementalinference_torch, nor
chip_smoke.py, the scripts of examples_torch/ or docs/gen_api_torch.py,
imports JAX or the JAX package."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sources():
    pkg = os.path.join(ROOT, "incrementalinference_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    examples = os.path.join(ROOT, "examples_torch")
    for f in sorted(os.listdir(examples)):
        if f.endswith(".py"):
            yield os.path.join(examples, f)
    yield os.path.join(ROOT, "docs", "gen_api_torch.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "incrementalinference")


def test_no_jax_imports_in_the_port():
    bad = []
    files = list(_sources())
    assert len(files) > 20
    names = [os.path.relpath(f, ROOT) for f in files]
    assert "docs/gen_api_torch.py" in names
    assert len([n for n in names if n.startswith("examples_torch/")]) == 6
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), n)
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, incrementalinference_torch, "
            "incrementalinference_torch.ops.kernels.row_lse, "
            "incrementalinference_torch.convert; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'incrementalinference')))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
