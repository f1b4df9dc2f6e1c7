"""Small helpers: comparisons, the default factor type of a variable pair,
label suffixes."""

from .compare import (compare_all_special, compare_beliefs, compare_factors,
                      compare_graphs, compare_variables)
from .defaults import select_factor_type
from .labels import incr_suffix

__all__ = ["compare_beliefs", "compare_variables", "compare_graphs",
           "compare_factors", "compare_all_special",
           "select_factor_type", "incr_suffix"]
