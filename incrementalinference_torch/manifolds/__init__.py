"""Manifold coordinate functions on tensors."""

from .base import Circle, Euclidean, Manifold, wrap_angle
from .lie import (SE2, SE3, SO2, SO3, Sphere2, quat_conj, quat_from_rotvec,
                  quat_mul, quat_normalize, quat_rotate, rotvec_from_quat)
from .product import Product

__all__ = [
    "Manifold", "Euclidean", "Circle", "wrap_angle",
    "SO2", "SE2", "SO3", "SE3", "Sphere2", "Product",
    "quat_mul", "quat_conj", "quat_rotate", "quat_normalize",
    "quat_from_rotvec", "rotvec_from_quat",
]
