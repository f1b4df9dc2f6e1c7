"""Elimination ordering, Bayes net and Bayes tree (host-side structure)."""

from .bayesnet import Conditional, build_bayes_net
from .bayestree import BayesTree, Clique, CliqStatus, build_tree
from .ordering import get_elimination_order

__all__ = ["get_elimination_order", "Conditional", "build_bayes_net",
           "BayesTree", "Clique", "CliqStatus", "build_tree"]
