"""Tree diagnostics.

Counterpart of the two pieces of ``incrementalinference/jl_tpu/debugging.py``
that the clique accessors read: the clique association matrix (reference
compCliqAssocMatrices!) and the status colour scheme of the tree drawings.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .tree.bayestree import BayesTree, CliqStatus

__all__ = ["clique_assoc_matrix"]

#: clique status -> draw colour (reference drawTree clique colouring)
_STATUS_COLOR = {
    CliqStatus.NULL: "gray", CliqStatus.NO_INIT: "orange",
    CliqStatus.INITIALIZED: "green", CliqStatus.UPSOLVED: "lightblue",
    CliqStatus.MARGINALIZED: "blue", CliqStatus.DOWNSOLVED: "lightgreen",
    CliqStatus.UPRECYCLED: "purple", CliqStatus.ERROR_STATUS: "red",
}


def clique_assoc_matrix(fg, tree: BayesTree, cid: int
                        ) -> Tuple[List[str], List[str], np.ndarray]:
    """Potential-factor rows × clique-variable columns, plus one row per
    child up-message (reference compCliqAssocMatrices! cliqAssocMat and
    cliqMsgMat).  Returns (row labels, column labels, bool matrix)."""
    cl = tree.clique(cid)
    cols = cl.all_vars
    col_idx = {v: j for j, v in enumerate(cols)}
    rows, mat = [], []

    def row_of(labels):
        row = np.zeros(len(cols), bool)
        for v in labels:
            if v in col_idx:
                row[col_idx[v]] = True
        return row

    for fl in cl.potentials:
        rows.append(fl)
        mat.append(row_of(fg.factor(fl).variables))
    for ch in tree.children(cid):
        rows.append(f"msg:cliq{ch.cid}")
        mat.append(row_of(ch.separator))
    M = np.stack(mat) if mat else np.zeros((0, len(cols)), bool)
    return rows, cols, M
