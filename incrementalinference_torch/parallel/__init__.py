"""Clique messages and the Bayes-tree sweep schedule."""
