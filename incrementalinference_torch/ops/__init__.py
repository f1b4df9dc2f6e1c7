"""Numerical operators of the nonparametric solve."""
