"""The port's elimination order and Bayes tree against the JAX package's:
host-side and deterministic, so they must agree exactly.  Both native
(C++) orderings must be loaded, or the two sides would compare a native
order against a Python fallback."""

import pytest

from torch_port_helpers import (  # noqa: F401
    jax_native_ordering, jax_native_ordering_available)

from incrementalinference.jl_tpu import canonical as jcan
from incrementalinference.jl_tpu.tree.bayestree import build_tree as j_build
from incrementalinference_torch import canonical as tcan
from incrementalinference_torch.native import native_available as t_native
from incrementalinference_torch.tree.bayestree import build_tree as t_build


def _shape(tree):
    return {cid: (c.frontals, c.separator, c.parent, c.children,
                  c.potentials, c.direct_vars, c.iter_vars, c.msgskip_vars)
            for cid, c in tree.cliques.items()}


@pytest.mark.parametrize("graph", ["line_step_20", "kaess"])
def test_same_order_and_cliques_as_jax(graph):
    assert jax_native_ordering_available(), \
        "JAX package's native ordering did not build"
    assert t_native(), "port's native ordering did not build"
    if graph == "kaess":
        fj, ft = jcan.generate_kaess(), tcan.generate_kaess(device="cpu")
    else:
        fj = jcan.generate_line_step(20)
        ft = tcan.generate_line_step(20, device="cpu")
    tj, tt = j_build(fj), t_build(ft)
    assert tt.elimination_order == tj.elimination_order
    assert _shape(tt) == _shape(tj)
    assert tt.levels() == tj.levels()


def test_python_fallback_order_matches_jax_fallback(monkeypatch):
    """With both natives off, the Python min-degree heuristics agree."""
    import incrementalinference.jl_tpu.native as jn
    import incrementalinference_torch.native as tn

    monkeypatch.setattr(jn, "native_ccolamd", lambda *a, **k: None)
    monkeypatch.setattr(tn, "native_ccolamd", lambda *a, **k: None)
    fj = jcan.generate_line_step(12)
    ft = tcan.generate_line_step(12, device="cpu")
    assert (t_build(ft).elimination_order
            == j_build(fj, method="ccolamd").elimination_order)
