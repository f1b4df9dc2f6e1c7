"""Elimination ordering, Bayes net and Bayes tree (host-side structure),
and the clique accessor surface."""

from .bayesnet import Conditional, build_bayes_net
from .bayestree import (BayesTree, Clique, CliqStatus, build_tree,
                        build_tree_reset)
from .ordering import get_elimination_order
from . import accessors
from .accessors import *  # noqa: F401,F403 — clique accessor surface

__all__ = ["get_elimination_order", "Conditional", "build_bayes_net",
           "BayesTree", "Clique", "CliqStatus", "build_tree",
           "build_tree_reset"] + list(accessors.__all__)
