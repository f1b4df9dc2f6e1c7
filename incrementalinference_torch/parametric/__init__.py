"""Parametric (Gaussian nonlinear least squares) solver stack."""

from .cliques import GaussianMessage, solve_tree_parametric
from .solver import (ParametricProblem, autoinit_parametric,
                     init_parametric_from, solve_conditionals_parametric,
                     solve_graph_parametric, solve_problems_batched)

__all__ = ["ParametricProblem", "solve_graph_parametric",
           "solve_conditionals_parametric", "autoinit_parametric",
           "init_parametric_from", "solve_problems_batched",
           "solve_tree_parametric", "GaussianMessage"]
