"""Clique messages, the Bayes-tree sweep schedule, and distribution over a
device mesh (the exports of the JAX package's ``parallel/__init__.py``)."""

from .messages import LikelihoodMessage, add_msg_factors, delete_msg_factors
from .precompile import precompile_updates  # noqa: F401
from .scheduler import (CliqueTrace, build_clique_subgraph, down_solve_clique,
                        solve_tree_sweeps, transfer_update_subgraph,
                        up_solve_clique)

__all__ = [
    "LikelihoodMessage", "add_msg_factors", "delete_msg_factors",
    "CliqueTrace", "build_clique_subgraph", "transfer_update_subgraph",
    "up_solve_clique", "down_solve_clique", "solve_tree_sweeps",
    "precompile_updates",
]
