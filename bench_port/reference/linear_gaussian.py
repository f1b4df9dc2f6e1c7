"""The exact posterior of a graph of scalar priors and linear relatives, in
information form.

A ``Prior`` on x_i with mean m and sigma s adds 1/s² to Λ_ii and m/s² to
η_i.  A ``LinearRelative`` from x_i to x_j measuring z with sigma s
(upstream's x_j = x_i + z) adds 1/s² to Λ_ii and Λ_jj, -1/s² to Λ_ij and
Λ_ji, -z/s² to η_i and z/s² to η_j.  The posterior is Gaussian with
covariance Λ⁻¹ and mean Λ⁻¹ η: exact, since the graph is linear-Gaussian.
The solve is a Cholesky factorisation written out by hand, so that it runs
in any precision (bfloat16 included) with every operation in it."""

from __future__ import annotations

import torch

from .precision import dtype_of


def information(labels, factors, precision: str = "float64"):
    """(Λ (n, n), η (n,)) of the graph; ``factors`` are (variables, value,
    sigma), each value and sigma a number or a list of one."""
    dt = dtype_of(precision)
    idx = {lbl: k for k, lbl in enumerate(labels)}
    n = len(labels)
    L = torch.zeros((n, n), dtype=dt)
    eta = torch.zeros(n, dtype=dt)
    one = lambda v: torch.as_tensor(v, dtype=dt).reshape(-1)[0]
    for vs, value, sigma in factors:
        z, w = one(value), 1.0 / one(sigma) ** 2
        if len(vs) == 1:
            i = idx[vs[0]]
            L[i, i] += w
            eta[i] += z * w
        else:
            i, j = idx[vs[0]], idx[vs[1]]
            L[i, i] += w
            L[j, j] += w
            L[i, j] -= w
            L[j, i] -= w
            eta[i] -= z * w
            eta[j] += z * w
    return L, eta


def _cholesky(A):
    n = A.shape[0]
    C = torch.zeros_like(A)
    for j in range(n):
        d = A[j, j] - (C[j, :j] * C[j, :j]).sum()
        C[j, j] = torch.sqrt(d)
        for i in range(j + 1, n):
            C[i, j] = (A[i, j] - (C[i, :j] * C[j, :j]).sum()) / C[j, j]
    return C


def _solve_lower(C, b):
    x = torch.zeros_like(b)
    for i in range(C.shape[0]):
        x[i] = (b[i] - (C[i, :i] * x[:i]).sum()) / C[i, i]
    return x


def _solve_upper(U, b):
    n = U.shape[0]
    x = torch.zeros_like(b)
    for i in range(n - 1, -1, -1):
        x[i] = (b[i] - (U[i, i + 1:] * x[i + 1:]).sum()) / U[i, i]
    return x


def posterior(labels, factors, precision: str = "float64"):
    """(mean (n,), covariance (n, n)) of the graph, in ``precision``."""
    L, eta = information(labels, factors, precision)
    C = _cholesky(L)
    solve = lambda b: _solve_upper(C.T, _solve_lower(C, b))
    cov = torch.stack([solve(e) for e in torch.eye(L.shape[0],
                                                   dtype=L.dtype)], dim=1)
    return solve(eta), cov


def marginal_samples(mean, var, n: int, seed: int,
                     precision: str = "float64"):
    """``n`` draws of the Gaussian marginal (mean, var), formed in
    ``precision`` from a CPU generator seeded by ``seed``: the reference
    put in the place of a solve's particles."""
    dt = dtype_of(precision)
    g = torch.Generator().manual_seed(int(seed))
    e = torch.randn(n, generator=g, dtype=torch.float64).to(dt)
    m = torch.as_tensor(mean, dtype=torch.float64).to(dt)
    s = torch.sqrt(torch.as_tensor(var, dtype=torch.float64).to(dt))
    return m + s * e
