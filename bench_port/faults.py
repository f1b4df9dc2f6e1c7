"""Faults planted under a step's timed path, by name, for the readings a
cell's limits are set from (``control.py --fault``) and for the tests that
see `correct` come out false.  ``patch(name)`` gives (object, attribute,
replacement) for a monkeypatch; the benchmark's own runs plant none.

- ``unsolved``: the solve returns at once, the state as it was.
- ``half_stale``: the solve refreshes half of each belief's particles; the
  other half keeps the particles the belief held before it.
- ``dropped_factor``: a product leaves out its last proposal (x0's prior,
  in the order the port gives them).
- ``inverted_rows``: the kernel's row log-partitions come back negated, so
  the product's rows are drawn with the wrong weights.
- ``wide_bw``: every bandwidth 1.5 times its leave-one-out value.
- ``shifted_mean``: the mean estimate moved by one bandwidth.
"""

from __future__ import annotations


def _unsolved():
    import incrementalinference_torch as it

    return it, "solve_tree", lambda fg, **kw: None


def _half_stale():
    import incrementalinference_torch as it

    real = it.solve_tree

    def solve(fg, **kw):
        before = {lbl: v.beliefs["default"].points.clone()
                  for lbl, v in fg.variables.items()
                  if v.beliefs.get("default") is not None}
        tree = real(fg, **kw)
        for lbl, old in before.items():
            b = fg.variables[lbl].beliefs["default"]
            pts = b.points.clone()
            n = pts.shape[0] // 2
            pts[n:] = old[n:]
            fg.variables[lbl].beliefs["default"] = b._replace(points=pts)
        return tree

    return it, "solve_tree", solve


def _dropped_factor():
    from incrementalinference_torch.ops import fused

    real = fused._product_members

    def members(manifold, pts_list, bw_list, static_masks, *rest):
        if len(pts_list) >= 2:
            pts_list, bw_list = pts_list[:-1], bw_list[:-1]
            static_masks = static_masks[:-1]
        return real(manifold, pts_list, bw_list, static_masks, *rest)

    return fused, "_product_members", members


def _inverted_rows():
    from incrementalinference_torch.ops import product

    real = product.pair_row_logsumexp
    return product, "pair_row_logsumexp", lambda *a: -real(*a)


def _wide_bw():
    from incrementalinference_torch.ops import fused

    real = fused.loo_bandwidth
    return fused, "loo_bandwidth", lambda *a, **kw: 1.5 * real(*a, **kw)


def _shifted_mean():
    from incrementalinference_torch import api

    real = api.calc_ppe

    def ppe(manifold, belief):
        est = dict(real(manifold, belief))
        est["mean"] = manifold.exp(est["mean"], belief.bw)
        return est

    return api, "calc_ppe", ppe


FAULTS = {"unsolved": _unsolved, "half_stale": _half_stale,
          "dropped_factor": _dropped_factor, "inverted_rows": _inverted_rows,
          "wide_bw": _wide_bw, "shifted_mean": _shifted_mean}


def patch(name: str):
    """(object, attribute, replacement) that plants the fault ``name``."""
    return FAULTS[name]()
