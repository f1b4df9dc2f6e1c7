"""incrementalinference_torch — the nonparametric and parametric solves in
PyTorch.

The PyTorch and CUDA port of :mod:`incrementalinference.jl_tpu` (which stays
the reference).  Graphs live on a device, CUDA unless the caller passes
``device="cpu"``; the pair-product row-logsumexp runs as a hand-written
CUDA kernel (ops/kernels/csrc/row_lse.cu).  Graphs and trees save and load
in the JAX package's file formats (``serialization``).
"""

from .api import (approx_cliq_marginal_up, fifo_freeze, set_ppe,
                  solve_cliq_down, solve_cliq_up,
                  solve_cliq_with_state_machine, solve_graph, solve_tree,
                  warmup)
from . import manifolds
from .beliefs import (Belief, kde_logpdf, kde_sample, make_belief, mean_cov,
                      ppe)
from . import canonical
from . import debugging
from . import serialization
from .canonical import (fourdoor_sequence, generate_caesar_ring1d,
                        generate_euclid_distance, generate_hexagonal,
                        generate_kaess, generate_line_step,
                        generate_test_symbolic)
from .config import SolverParams, full_precision, resolve_device
from .convert import graph_from_arrays, graph_to_arrays
from .distributions import (AliasingScalarSampler, Categorical,
                            ManifoldKernelDensity, MvNormal, Normal, Rayleigh,
                            Uniform, manikde)
from .graph import (Circular, ContinuousEuclid, ContinuousScalar, Factor,
                    FactorGraph, Position, Position1, Position2, Position3,
                    Position4, Variable, VariableType, initfg)
from .graphinit import doautoinit, init_all, init_variable, \
    reset_initial_values
from .manifolds import SE2, SE3, SO2, SO3, Circle, Euclidean
from .models import (CircularCircular, DERelative, EuclidDistance,
                     FactorModel, FluxModelsDistribution, GaussianJoint,
                     GenericMarginal, HeatmapGridDensity, LevelSetGridNormal,
                     LinearRelative, ManifoldFactor, ManifoldPrior,
                     MetaPrior, Mixture, MixtureFluxModels, MsgPrior,
                     PartialPrior, PartialPriorPassThrough, Prior,
                     PriorCircular, PriorModel, SequentialNet, nn_init,
                     register_factor_model)
from .ops.convolve import approx_conv_belief, eval_factor, sample_factor
from .ops.deconv import approx_deconv, approx_deconv_belief, mmd
from .ops.gradients import FactorGradientsCached, factor_jacobian
from .ops.graphops import (approx_conv_path, find_shortest_path_dijkstra,
                           is_path_factors_homogeneous, local_product,
                           propagate_belief)
from .ops.product import manifold_product
from .parallel.scheduler import CliqueTrace
from .parametric import (autoinit_parametric, init_parametric_from,
                         solve_conditionals_parametric,
                         solve_graph_parametric, solve_tree_parametric)
from .serialization import (load_dfg_archive, load_graph, load_tree,
                            save_dfg_archive, save_graph, save_tree)
from .tether import (accumulate_factor_means, rebase_factor_variable,
                     solve_factor_parametric)
from .tree import (BayesTree, CliqStatus, build_tree, build_tree_reset,
                   get_elimination_order)
from .utils import (compare_all_special, compare_beliefs, compare_factors,
                    compare_graphs, compare_variables, incr_suffix,
                    select_factor_type)
from . import fgos
from .fgos import *  # noqa: F401,F403 — graph accessor surface
from . import compat
from .compat import (AbstractBayesTree, AbstractFactor,
                     AbstractManifoldMinimize, AbstractPrior,
                     AbstractRelative, AbstractRelativeMinimize, BeliefArray,
                     CalcFactor, CliqStateMachineContainer,
                     CommonConvWrapper, DFGFactorSummary, DFGVariableSummary,
                     GraphsDFG, InferenceVariable, LocalDFG,
                     PackedAliasingScalarSampler, PackedBayesTreeNodeData,
                     PackedCategorical, PackedDiagNormal,
                     PackedFluxModelsDistribution, PackedFullNormal,
                     PackedFunctionNodeData, PackedGenericMarginal,
                     PackedHeatmapGridDensity, PackedLevelSetGridNormal,
                     PackedManifoldKernelDensity, PackedMixture,
                     PackedMsgPrior, PackedNormal, PackedPartialPrior,
                     PackedPrior, PackedRayleigh, PackedSamplableBelief,
                     PackedUniform, PackedZeroMeanDiagNormal,
                     PackedZeroMeanFullNormal, TreeBelief, diagm,
                     factor_summary, get_solver_params, variable_summary)
from . import datastore
from .datastore import (BlobEntry, FolderStore, InMemoryBlobStore, add_blob,
                        add_blob_store, add_data, delete_data,
                        fetch_data_json, get_blob, get_blob_store, get_data,
                        list_blob_entries, list_blob_stores,
                        list_data_entries)
from .tree import accessors as tree_accessors
from .tree.accessors import *  # noqa: F401,F403 — clique accessor surface

__version__ = "0.1.0"

__all__ = ["solve_tree", "solve_graph", "solve_cliq_up", "solve_cliq_down",
           "solve_cliq_with_state_machine", "approx_cliq_marginal_up",
           "fifo_freeze", "set_ppe", "Belief", "make_belief",
           "generate_kaess", "generate_line_step", "generate_test_symbolic",
           "generate_caesar_ring1d", "generate_euclid_distance",
           "generate_hexagonal", "fourdoor_sequence", "SolverParams", "resolve_device",
           "full_precision",
           "graph_from_arrays", "graph_to_arrays", "Normal", "MvNormal",
           "Uniform", "Rayleigh", "Categorical", "AliasingScalarSampler",
           "ManifoldKernelDensity", "manikde", "ContinuousScalar",
           "ContinuousEuclid", "FactorGraph", "initfg", "init_all",
           "init_variable", "reset_initial_values", "Prior",
           "LinearRelative", "EuclidDistance", "Mixture", "MsgPrior",
           "FactorModel", "register_factor_model", "CliqueTrace",
           "BayesTree", "CliqStatus", "build_tree", "build_tree_reset",
           "manifolds", "SE2", "SE3", "SO2", "SO3", "Circle", "Euclidean",
           "Circular", "Position", "Variable", "Factor", "VariableType",
           "doautoinit", "PriorModel", "PriorCircular", "CircularCircular",
           "PartialPrior", "ManifoldFactor", "ManifoldPrior", "MetaPrior",
           "GenericMarginal", "approx_conv_belief", "eval_factor",
           "sample_factor", "approx_deconv", "approx_deconv_belief", "mmd",
           "FactorGradientsCached", "factor_jacobian", "approx_conv_path",
           "find_shortest_path_dijkstra", "is_path_factors_homogeneous",
           "local_product", "propagate_belief", "manifold_product",
           "select_factor_type", "GaussianJoint", "solve_graph_parametric",
           "solve_conditionals_parametric", "autoinit_parametric",
           "init_parametric_from", "solve_tree_parametric",
           "solve_factor_parametric", "accumulate_factor_means",
           "rebase_factor_variable", "kde_logpdf", "kde_sample", "mean_cov",
           "ppe", "canonical", "Position1", "Position2", "Position3",
           "Position4", "DERelative", "FluxModelsDistribution",
           "HeatmapGridDensity", "LevelSetGridNormal", "MixtureFluxModels",
           "PartialPriorPassThrough", "SequentialNet", "nn_init",
           "get_elimination_order", "compare_all_special",
           "compare_beliefs", "compare_factors", "compare_graphs",
           "compare_variables", "incr_suffix", "fgos", "tree_accessors",
           "warmup", "debugging", "serialization", "load_dfg_archive",
           "load_graph", "load_tree", "save_dfg_archive", "save_graph",
           "save_tree", "compat", *compat.__all__, "datastore",
           *datastore.__all__, *fgos.__all__, *tree_accessors.__all__]
