"""The port's row-logsumexp (ops/kernels/row_lse.py) against the JAX
package's Pallas kernel in interpret mode and against the dense
logsumexp.  On the CPU the wrapper runs the kernel's plain version; the
CUDA kernel itself is held against that version on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import rng, t

from incrementalinference.jl_tpu.ops.kernels import pallas_product as jk
from incrementalinference.jl_tpu.ops.product import _pair_logW as jax_logW
from incrementalinference_torch.ops.kernels import row_lse as K


def _inputs(na, nb, dof, seed):
    r = rng(seed)
    muA = r.normal(size=(na, dof)).astype(np.float32)
    muB = (r.normal(size=(nb, dof)) + 0.5).astype(np.float32)
    precA = (np.abs(r.normal(size=(na, dof))) + 0.5).astype(np.float32)
    precB = np.broadcast_to(
        np.abs(r.normal(size=(dof,))).astype(np.float32) + 0.5,
        (nb, dof)).copy()
    return muA, precA, muB, precB


@pytest.mark.parametrize("na,nb,dof", [(300, 200, 8), (257, 130, 1),
                                       (100, 700, 3)])
def test_plain_matches_jax_pallas_and_dense(na, nb, dof):
    muA, precA, muB, precB = _inputs(na, nb, dof, seed=na + dof)
    got = K.pair_row_logsumexp(t(muA), t(precA), t(muB), t(precB)).numpy()
    pallas = np.asarray(jk.pair_row_logsumexp(
        jnp.asarray(muA), jnp.asarray(precA), jnp.asarray(muB),
        jnp.asarray(precB), interpret=True))
    dense = np.asarray(jax.scipy.special.logsumexp(
        jax_logW(muA, precA, muB, precB), axis=1))
    # the bar of tests/test_pallas_kernels.py: float32 sums in another
    # order (column blocks vs tiles vs one dense reduction)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)


def test_partial_dims_zero_precision():
    muA = np.asarray([[0.0, 5.0]], np.float32)
    muB = np.asarray([[0.0, -5.0], [3.0, 100.0]], np.float32)
    precA = np.asarray([[1.0, 0.0]], np.float32)     # dim 1 unconstrained
    precB = np.ones((2, 2), np.float32)
    got = K.pair_row_logsumexp(t(muA), t(precA), t(muB), t(precB)).numpy()
    pallas = np.asarray(jk.pair_row_logsumexp(
        jnp.asarray(muA), jnp.asarray(precA), jnp.asarray(muB),
        jnp.asarray(precB), interpret=True))
    # same bar as tests/test_pallas_kernels.py (two pairs, exact math)
    np.testing.assert_allclose(got, pallas, atol=1e-5)


def test_plain_column_blocks_do_not_change_the_result():
    muA, precA, muB, precB = _inputs(64, 1000, 2, seed=7)
    a2, iva, ivm = K.pair_row_terms(t(muA), t(precA), t(muB), t(precB))
    whole = K.row_logsumexp_plain(a2, iva, ivm, t(muB))
    blocked = K.row_logsumexp_plain(a2, iva, ivm, t(muB), max_elems=64 * 37)
    # only the order of float32 sums changes between the two
    torch.testing.assert_close(blocked, whole, rtol=1e-6, atol=1e-5)


def test_wrapper_checks_inputs():
    a2 = torch.zeros(4)
    with pytest.raises(TypeError):
        K.row_logsumexp(a2, torch.zeros((4, 2), dtype=torch.float64),
                        torch.zeros((4, 2)), torch.zeros((3, 2)))
    with pytest.raises(ValueError):
        K.row_logsumexp(a2, torch.zeros((4, 3)), torch.zeros((4, 3)),
                        torch.zeros((3, 2)))


def test_cuda_path_never_falls_back(monkeypatch, tmp_path):
    """Without CUDA the entry points refuse the card, and the kernel path
    raises instead of taking the plain version."""
    from incrementalinference_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device(None)                 # the default is the card
    # the kernel route itself: no kernel library, no result
    monkeypatch.setattr(K, "_LIB", None)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(K, "_nvcc", no_nvcc)
    monkeypatch.setattr(K, "_SO", str(tmp_path / "librow_lse.so"))
    muA, precA, muB, precB = _inputs(8, 8, 2, seed=1)
    a2, iva, ivm = K.pair_row_terms(t(muA), t(precA), t(muB), t(precB))
    before = dict(K.counts)
    with pytest.raises(RuntimeError):
        K._row_logsumexp_cuda(a2, iva, ivm, t(muB))
    assert K.counts["launches"] == before["launches"]
    # a device that is neither CPU nor CUDA is refused, not computed
    with pytest.raises(ValueError):
        K.row_logsumexp(a2.to("meta"), iva.to("meta"), ivm.to("meta"),
                        t(muB).to("meta"))
