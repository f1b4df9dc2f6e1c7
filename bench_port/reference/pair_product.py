"""The exact product of two Gaussian kernel densities, materialised, at a
test's size.

A density is a mixture of diagonal Gaussians: means (N, d), precisions
(N, d) (0 where the component leaves a dimension free) and, optionally,
log-weights (N,).  The product of two mixtures A and B is the mixture
over the pairs (i, j) whose weight is w_i w_j times the overlap of the two
components, N(a_i; b_j, 1/pa + 1/pb) in each dimension both constrain,
and whose component is their precision-weighted merge.  A pair product
draws the pairs from these weights as two draws: the row by its
log-partition (the log of the row's total weight), then the column within
the row; the law of the pair is the pair weight over the sum of all.

Every number here is float64 and every pair is built: Na x Nb is small.
Where one side's precisions are the same for every component (a kernel
density's shared bandwidth) the overlap's normaliser is one constant and
drops out of the law."""

from __future__ import annotations

import math

import torch


def log_weights(muA, precA, muB, precB, logwB=None):
    """(Na, Nb) log pair weights, the log overlap of each pair plus B's
    log-weight."""
    a, b = muA.double()[:, None, :], muB.double()[None, :, :]
    pa, pb = precA.double()[:, None, :], precB.double()[None, :, :]
    both = (pa > 0) & (pb > 0)
    var = torch.where(both, 1.0 / pa.clamp(min=1e-300)
                      + 1.0 / pb.clamp(min=1e-300), torch.ones_like(a - b))
    per_dim = -0.5 * (a - b) ** 2 / var - 0.5 * torch.log(2 * math.pi * var)
    lw = torch.where(both, per_dim, torch.zeros_like(per_dim)).sum(dim=-1)
    return lw if logwB is None else lw + logwB.double()[None, :]


def pair_law(muA, precA, muB, precB, logwB=None):
    """(Na, Nb) probabilities of the drawn pair: the row by its
    log-partition, then the column given the row."""
    lw = log_weights(muA, precA, muB, precB, logwB)
    rows = torch.logsumexp(lw, dim=1)             # row log-partitions
    p_row = torch.softmax(rows, dim=0)
    return p_row[:, None] * torch.exp(lw - rows[:, None])
