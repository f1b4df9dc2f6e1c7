"""Small helpers (the default factor type of a variable pair)."""

from .defaults import select_factor_type

__all__ = ["select_factor_type"]
