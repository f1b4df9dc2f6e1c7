"""The port's public surface against the JAX package's, by name.

The names ``incrementalinference/jl_tpu/__init__.py`` imports by name, with
the star exports of ``fgos`` and ``tree/accessors``, less those the port's
``__init__`` imports and star-exports, must be exactly the list ROADMAP.md
queues for the slices still to port, so that the roadmap's count cannot
drift from the code.  Since slice 9b that list is empty: every public name
of the JAX package has a counterpart in the port."""

import ast
import os
import re

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
