"""The port's row-logsumexp (ops/kernels/row_lse.py) against the JAX
package's Pallas kernel in interpret mode and against the dense
logsumexp.  On the CPU the wrapper runs the kernel's plain version; the
CUDA kernel itself is held against that version on the card by
chip_smoke.py.
"""

import dataclasses

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

    monkeypatch.setattr(K, "LIBRARY", dataclasses.replace(
        K.LIBRARY, compiler=no_nvcc, build_dir=str(tmp_path)))
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


# --- the CUDA kernel's recurrence, step by step ---------------------------

_LOG2E = np.float32(1.4426950408889634)
_LN2 = np.float32(0.6931471805599453)
_TAU = 32.0


def _fma(a, b, c):
    """float32 fused multiply-add: the product of two float32s is exact in
    float64, so one rounding remains."""
    return (a.double() * b.double() + c.double()).float()


def emulate_row_lse(a2, iva, ivmuA, muB, lane_cols=8, cols_per_split=512):
    """What csrc/row_lse.cu does to every row, in float32 torch ops.

    Base-2 row terms; per column split a reference m_ref that starts from
    the row's log2-weight at the split's first column; 32 lanes, each with
    ``lane_cols`` columns of every 32 * lane_cols-column chunk (groups of 4
    adjacent columns, 128 apart); chunk max, lazy move of m_ref when the
    max rises more than tau above it, tree sum of exp2; merge of the lanes,
    merge of the splits, times ln 2.  Returns (out, moves of m_ref)."""
    na, dof = iva.shape
    nb = muB.shape[0]
    c = np.float32(-0.5) * _LOG2E * a2
    p = np.float32(-0.5) * _LOG2E * iva
    q = _LOG2E * ivmuA
    chunk = 32 * lane_cols
    lane = torch.arange(32)
    # column offsets of (lane, k) inside a chunk
    offs = torch.stack([(k // 4) * 128 + 4 * lane + (k % 4)
                        for k in range(lane_cols)], dim=1)      # (32, C)

    def l2(cm, cols):                  # cm (na, 32), cols (32, C) -> (na,32,C)
        acc = cm[:, :, None].expand(na, 32, cols.shape[1])
        for d in range(dof):
            b = muB[cols, d][None]
            pd, qd = p[:, d, None, None], q[:, d, None, None]
            acc = _fma(_fma(pd, b, qd), b, acc)
        return acc

    moves = 0
    part_m, part_s = [], []
    for cb in range(0, nb, cols_per_split):
        ce = min(nb, cb + cols_per_split)
        first = torch.full((32, 1), cb)
        mref = l2(c[:, None].expand(na, 32), first)[:, :, 0]    # (na, 32)
        cm = c[:, None] - mref
        s = torch.zeros((na, 32))
        for base in range(cb, ce, chunk):
            cols = base + offs
            valid = cols < ce
            v = l2(cm, torch.where(valid, cols, cb))
            v = torch.where(valid[None], v, torch.tensor(-np.inf))
            w = v
            while w.shape[2] > 1:                               # max tree
                h = w.shape[2] // 2
                w = torch.maximum(w[:, :, :h], w[:, :, h:])
            mx = w[:, :, 0]
            rose = mx > _TAU
            moves += int(rose.sum())
            shift = torch.where(rose, mx, torch.zeros(()))
            s = torch.where(rose, s * torch.exp2(-mx), s)
            mref = mref + shift
            cm = cm - shift
            e = torch.exp2(v - shift[:, :, None])
            while e.shape[2] > 1:                               # sum tree
                h = e.shape[2] // 2
                e = e[:, :, :h] + e[:, :, h:]
            s = s + e[:, :, 0]
        m = mref.max(dim=1).values                              # lane merge
        t_ = s * torch.exp2(mref - m[:, None])
        for off in (16, 8, 4, 2, 1):                            # xor shuffles
            t_ = t_ + t_[:, lane ^ off]
        part_m.append(m)
        part_s.append(t_[:, 0])
    pm, ps = torch.stack(part_m), torch.stack(part_s)
    mx = pm.max(dim=0).values
    total = torch.zeros(na)
    for k in range(pm.shape[0]):
        total = total + ps[k] * torch.exp2(pm[k] - mx)
    return (mx + torch.log2(torch.clamp(total, min=1e-30))) * _LN2, moves


def _extreme_case(name):
    """(muA, precA, muB, precB) of the cases the new arithmetic can get
    wrong; the same recipes chip_smoke.py runs through the kernel."""
    r = rng(11)
    if name.startswith("far_rows"):
        dof = int(name[-1])
        muA = np.where(r.random((70, dof)) < 0.5, -1e3, 1e3)
        muB = r.normal(size=(600, dof))
        prec = 11.0
    elif name.startswith("near_"):
        # one B kernel beside half of the rows, every other one 30 sigma
        # away (2^-6000 of its weight); the other half of the rows is far
        # from all of B.  The expanded form carries terms of ivar * 30^2,
        # so float32 leaves ~1e-3 absolute on every row, in the plain
        # version too: the far half sets the scale of the relative bar.
        # Lane 3 of a chunk of 256 owns columns 12..15, 140..143, 268..:
        # column 12 is the first it meets, 140 the middle of its stride.
        where = {"near_first": 0, "near_lane_first": 12,
                 "near_lane_middle": 140, "near_last": 599}[name]
        dof = 1
        muA = np.concatenate([30 + 0.3 * r.normal(size=(35, dof)),
                              -30 + 0.3 * r.normal(size=(35, dof))])
        muB = r.normal(size=(600, dof))
        muB[where] = 30.0
        prec = 11.0
    elif name == "nb_under_a_warp_dof8":
        dof = 8
        muA = 3 * r.normal(size=(37, dof))
        muB = r.normal(size=(19, dof))
        prec = 1.5
    elif name.startswith("zero_precision"):
        dof = int(name[-1])
        muA = r.normal(size=(40, dof))
        muB = r.normal(size=(300, dof))
        prec = 0.0
    else:
        raise KeyError(name)
    muA, muB = muA.astype(np.float32), muB.astype(np.float32)
    return (muA, np.full_like(muA, prec), muB, np.full_like(muB, prec))


EXTREME_CASES = ["far_rows_dof1", "far_rows_dof8", "near_first",
                 "near_lane_first", "near_lane_middle", "near_last",
                 "nb_under_a_warp_dof8", "zero_precision_dof1",
                 "zero_precision_dof8"]


@pytest.mark.parametrize("lane_cols", [8, 4])
@pytest.mark.parametrize("name", EXTREME_CASES)
def test_kernel_recurrence_matches_plain(name, lane_cols):
    muA, precA, muB, precB = _extreme_case(name)
    a2, iva, ivm = K.pair_row_terms(t(muA), t(precA), t(muB), t(precB))
    ref = K.row_logsumexp_plain(a2, iva, ivm, t(muB))
    got, moves = emulate_row_lse(a2, iva, ivm, t(muB), lane_cols=lane_cols)
    assert bool(torch.isfinite(got).all())
    # chip_smoke.py's formula and bar.  What differs from the plain version:
    # float32 sums in another order (lanes, chunks, splits), the base-2 row
    # terms' own rounding, and on the card ex2.approx at 2^-22 relative
    err = float((got - ref).abs().max() / ref.abs().max().clamp(min=1.0))
    assert err <= 1e-5, err
    if name.startswith("zero_precision"):
        torch.testing.assert_close(
            got, torch.full_like(got, float(np.log(muB.shape[0]))))
    if name in ("near_lane_middle", "near_last"):
        assert moves > 0          # the late rise really moved m_ref


@pytest.mark.parametrize("na,nb,rows,chunk,resident", [
    (50_000, 50_000, 64, 256, 264), (65_536, 65_536, 64, 256, 264),
    (33_000, 33_000, 32, 128, 264), (16_384, 65_536, 64, 256, 264),
    (1037, 19, 32, 128, 264), (3000, 40_000, 64, 256, 264)])
def test_split_plan_covers_the_columns(na, nb, rows, chunk, resident):
    splits, cols = K.split_plan(na, nb, rows, chunk, resident)
    assert cols % chunk == 0                    # whole chunks per split
    assert (splits - 1) * cols < nb <= splits * cols   # cover, none empty
    # never so many splits that a block is mostly its fixed cost
    assert splits == 1 or cols >= K._MIN_SPLIT_COLS
