"""Manifold coordinate functions (Euclidean and circle; Lie groups later)."""

from .base import Circle, Euclidean, Manifold, wrap_angle

__all__ = ["Manifold", "Euclidean", "Circle", "wrap_angle"]
