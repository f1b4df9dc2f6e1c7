"""Packed JSON serialization (graph, tree, distributions, beliefs) and
reference-ecosystem (DFG saveDFG) archive import and export, in the file
formats of ``incrementalinference/jl_tpu/serialization``."""

from .packed import (register_fn,  # noqa: F401
                     load_graph, load_tree, pack_belief, pack_distribution,
                     pack_factor_model, pack_manifold, save_graph, save_tree,
                     unpack_belief, unpack_distribution, unpack_factor_model,
                     unpack_manifold)
from .dfg_import import load_dfg_archive  # noqa: F401
from .dfg_export import save_dfg_archive  # noqa: F401

__all__ = [
    "pack_distribution", "unpack_distribution", "pack_belief",
    "unpack_belief", "pack_manifold", "unpack_manifold",
    "pack_factor_model", "unpack_factor_model",
    "save_graph", "load_graph", "save_tree", "load_tree", "register_fn",
    "load_dfg_archive", "save_dfg_archive",
]
