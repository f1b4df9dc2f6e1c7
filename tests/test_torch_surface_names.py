"""The port's public surface against the JAX package's, by name.

The names ``incrementalinference/jl_tpu/__init__.py`` imports by name, with
the star exports of ``fgos`` and ``tree/accessors``, less those the port's
``__init__`` imports and star-exports, must be exactly the list ROADMAP.md
queues for the slices still to port, so that the roadmap's count cannot
drift from the code.  Since slice 9b that list is empty: every public name
of the JAX package has a counterpart in the port.  The same holds, since
slice 8a, for the names of ``parallel/`` (its ``__init__``, ``mesh`` and
``precompile``) and, since slice 8b, of ``parallel/multihost.py``, whose
missing names ROADMAP.md's slice-8b block lists (none)."""

import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imported_names(path):
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names
                      if a.name != "*"}
    return names


def _all_of(path):
    for node in ast.parse(open(path).read()).body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "__all__"):
            return set(ast.literal_eval(node.value))
    raise AssertionError(f"no literal __all__ in {path}")


def _public_defs(path):
    """Top-level functions and classes whose names do not start with _."""
    return {node.name for node in ast.parse(open(path).read()).body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))
            and not node.name.startswith("_")}


def _module_names(path):
    """A module's ``__all__`` and public top-level definitions; nothing for
    a module the package does not have."""
    if not os.path.exists(path):
        return set()
    try:
        names = _all_of(path)
    except AssertionError:
        names = set()
    return names | _public_defs(path) | _imported_names(path)


def _surface(pkg):
    base = os.path.join(ROOT, *pkg.split("/"))
    return (_imported_names(os.path.join(base, "__init__.py"))
            | _all_of(os.path.join(base, "fgos.py"))
            | _all_of(os.path.join(base, "tree", "accessors.py")))


def _roadmap_list():
    text = open(os.path.join(ROOT, "ROADMAP.md")).read()
    m = re.search(r"<!-- missing-names -->(.*?)<!-- /missing-names -->",
                  text, re.S)
    assert m, "ROADMAP.md lost its <!-- missing-names --> block"
    return set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", m.group(1)))


def test_missing_names_are_the_roadmap_queue():
    missing = (_surface("incrementalinference/jl_tpu")
               - _surface("incrementalinference_torch"))
    queued = _roadmap_list()
    assert missing == queued, {"missing but not queued": sorted(
        missing - queued), "queued but present": sorted(queued - missing)}
    assert not missing, sorted(missing)


def test_port_star_exports_match_jax():
    """fgos and tree/accessors export the JAX modules' names, all of them
    and no more."""
    for mod in ("fgos.py", os.path.join("tree", "accessors.py")):
        assert (_all_of(os.path.join(ROOT, "incrementalinference_torch", mod))
                == _all_of(os.path.join(ROOT, "incrementalinference",
                                        "jl_tpu", mod))), mod


def test_every_port_name_resolves():
    """Every name the port's __init__ lists in __all__ is bound."""
    import incrementalinference_torch as it
    missing = [n for n in it.__all__ if not hasattr(it, n)]
    assert not missing, missing


def _parallel(pkg, mod):
    return os.path.join(ROOT, *pkg.split("/"), "parallel", mod)


@pytest.mark.parametrize("mod,names", [("__init__.py", _all_of),
                                       ("mesh.py", _all_of),
                                       ("precompile.py", _public_defs)])
def test_parallel_names_have_counterparts(mod, names):
    """Every name of the JAX package's parallel/__init__ and mesh
    ``__all__``, and every public function of its precompile module, is a
    name of the port's module of the same file name."""
    want = names(_parallel("incrementalinference/jl_tpu", mod))
    have = _module_names(_parallel("incrementalinference_torch", mod))
    assert want and not want - have, sorted(want - have)


def _slice_8b_queue():
    text = open(os.path.join(ROOT, "ROADMAP.md")).read()
    m = re.search(r"<!-- slice-8b-names -->(.*?)<!-- /slice-8b-names -->",
                  text, re.S)
    assert m, "ROADMAP.md lost its <!-- slice-8b-names --> block"
    return set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", m.group(1)))


def test_multihost_names_are_the_slice_8b_queue():
    """parallel/multihost.py's names that the port lacks are exactly the
    list ROADMAP.md queues for slice 8b, and since slice 8b that list is
    empty."""
    jax_mod = _parallel("incrementalinference/jl_tpu", "multihost.py")
    missing = ((_all_of(jax_mod) | _public_defs(jax_mod))
               - _module_names(_parallel("incrementalinference_torch",
                                         "multihost.py")))
    assert missing == _slice_8b_queue(), sorted(missing)
    assert not missing, sorted(missing)
