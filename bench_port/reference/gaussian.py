"""The Gaussian (Laplace) posterior of a factor graph of priors and
relative factors on one manifold: the maximum a posteriori point by
Gauss-Newton, and the covariance as the inverse of the normal equations
there, in the right-perturbation tangent of each variable.

Residuals, each over its sigma, per dimension: a prior at point p,
``log(p, x)``; a relative factor measuring the tangent z from a to b,
``log(a, b) - z`` (upstream's ``ManifoldPrior`` and ``ManifoldFactor``).
The Jacobians are central differences in float64.  For the two-pose graph
the point is exact (x0 at the prior's point, x1 at x0 o Exp(z)) and the
covariance the linearised one."""

from __future__ import annotations

import torch

_H = 1e-6


def _residuals(M, labels, factors, points):
    idx = {lbl: k for k, lbl in enumerate(labels)}
    out = []
    for vs, value, sigma in factors:
        v = torch.as_tensor(value, dtype=torch.float64)
        s = torch.as_tensor(sigma, dtype=torch.float64)
        if len(vs) == 1:
            r = M.log(v, points[idx[vs[0]]])
        else:
            r = M.log(points[idx[vs[0]]], points[idx[vs[1]]]) - v
        out.append(r / s)
    return torch.cat(out)


def _jacobian(M, labels, factors, points):
    n, d = len(labels), M.dof
    cols = []
    for k in range(n):
        for j in range(d):
            e = torch.zeros(d, dtype=torch.float64)
            e[j] = _H
            plus, minus = points.clone(), points.clone()
            plus[k] = M.exp(points[k], e)
            minus[k] = M.exp(points[k], -e)
            cols.append((_residuals(M, labels, factors, plus)
                         - _residuals(M, labels, factors, minus)) / (2 * _H))
    return torch.stack(cols, dim=1)


def posterior(M, labels, factors, start, iters: int = 30):
    """(points (n, point size), covariance (n·dof, n·dof)) of the graph;
    ``start`` (n, point size) is where Gauss-Newton begins."""
    x = torch.as_tensor(start, dtype=torch.float64).clone()
    d = M.dof
    for _ in range(iters):
        r = _residuals(M, labels, factors, x)
        J = _jacobian(M, labels, factors, x)
        step = torch.linalg.lstsq(J, -r[:, None]).solution[:, 0]
        for k in range(len(labels)):
            x[k] = M.exp(x[k], step[k * d:(k + 1) * d])
        if float(step.abs().max()) < 1e-13:
            break
    J = _jacobian(M, labels, factors, x)
    return x, torch.linalg.inv(J.T @ J)


def chain_start(M, labels, factors):
    """A start for Gauss-Newton: each prior's point, then each relative
    factor's measurement composed onto a variable already placed."""
    idx = {lbl: k for k, lbl in enumerate(labels)}
    x = torch.zeros((len(labels), M.dof), dtype=torch.float64)
    placed = set()
    for vs, value, _ in factors:
        if len(vs) == 1:
            x[idx[vs[0]]] = torch.as_tensor(value, dtype=torch.float64)
            placed.add(vs[0])
    for _ in range(len(labels)):
        for vs, value, _ in factors:
            if len(vs) == 2 and vs[0] in placed and vs[1] not in placed:
                x[idx[vs[1]]] = M.exp(
                    x[idx[vs[0]]], torch.as_tensor(value, dtype=torch.float64))
                placed.add(vs[1])
    return x
