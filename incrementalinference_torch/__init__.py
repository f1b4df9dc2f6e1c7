"""incrementalinference_torch — the nonparametric solve in PyTorch.

The PyTorch and CUDA port of :mod:`incrementalinference.jl_tpu` (which stays
the reference).  Graphs live on a device, CUDA unless the caller passes
``device="cpu"``; the pair-product row-logsumexp runs as a hand-written
CUDA kernel (ops/kernels/csrc/row_lse.cu).
"""

from .api import solve_graph, solve_tree
from .beliefs import Belief, make_belief
from .canonical import generate_kaess, generate_line_step
from .config import SolverParams, resolve_device
from .convert import graph_from_arrays, graph_to_arrays
from .distributions import MvNormal, Normal
from .graph import (ContinuousEuclid, ContinuousScalar, FactorGraph,
                    initfg)
from .models import LinearRelative, MsgPrior, Prior

__version__ = "0.1.0"

__all__ = ["solve_tree", "solve_graph", "Belief", "make_belief",
           "generate_kaess", "generate_line_step", "SolverParams",
           "resolve_device", "graph_from_arrays", "graph_to_arrays",
           "Normal", "MvNormal", "ContinuousScalar", "ContinuousEuclid",
           "FactorGraph", "initfg", "Prior", "LinearRelative", "MsgPrior"]
