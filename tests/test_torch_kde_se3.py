"""The KDE read on SE(3): the kernel's SE(3) instantiation
(``ops/kernels/csrc/kde_lse.cu``, ``struct SE3``), its plain version
(``kde_lse.se3_log``, ``kde_lse.se3_row_logsumexp``), the float64 reference
the ``se3pair-n33k`` cell is judged by (``bench_port/reference/se3.py``) and
the cell itself on the CPU.

On the CPU: which SE(3) reads reach the kernel and what each route counts;
the plain version against the eager chunked route and against the
reference in float64 (relative angles under lie.py's 1e-8 Taylor
threshold, near pi/2, and batched members), and in float32 against
float64, where it keeps what the eager float32 ``SE3.log`` loses at small
relative angles; the reference against the port's ``SE3`` and the JAX
package's ``lie.SE3`` in float64 (JAX is imported inside that test only);
the cell at N=200 through the harness's ``Runner`` and checks, correct, and
not correct with ``half_stale`` planted.

The tests marked ``card`` need an NVIDIA card and skip here; on the card:
``python -m pytest --noconftest tests/test_torch_kde_se3.py -m card``.
There the kernel is held against the eager chunked route in float64.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import incrementalinference_torch as it
from incrementalinference_torch import beliefs, tracing
from incrementalinference_torch.manifolds import lie
from incrementalinference_torch.ops.kernels import kde_lse

#: the cell's two beliefs: x0 under the sigma-0.01 prior, x1 at the step
#: [10, 0, 0, 0, 0, pi/2] with sigmas 0.5 and 0.05
SPREADS = {"x0": ([0.01] * 6, [0.0] * 6),
           "x1": ([0.5] * 3 + [0.05] * 3,
                  [10.0, 0.0, 0.0, 0.0, 0.0, math.pi / 2])}

#: the kernel against the eager chunked route in float64, in log-density:
#: float32 rounds a dominant kernel's exponent (|log k| up to ~30) at ~2e-6
#: and the result (|log p| up to ~20) at ~1e-6, ex2.approx adds 2^-22 a
#: term, and the log map's own float32 rounding reads 3e-7-8e-7 in its
#: plain version on the cell's spreads (here, below); a bfloat16 log map
#: reads 1.7e-2 and more (below), the eager float32 route 6e-3-3e-2
BAR = 2e-5


def _cloud(n, spread, base, gen, lead=()):
    """SE(3) particles (lead..., n, 7) in float64: Exp(base) moved by
    Gaussian tangents of ``spread``."""
    M = it.SE3()
    X = torch.randn(tuple(lead) + (n, 6), generator=gen,
                    dtype=torch.float64) * torch.tensor(spread,
                                                        dtype=torch.float64)
    return M.exp(M.Exp(torch.tensor(base, dtype=torch.float64)), X)


def _tiny_angles(n, gen):
    """Particles whose relative rotations lie under lie.py's 1e-8 Taylor
    threshold: rotation vectors of 1e-11..3e-9 about a fixed axis."""
    M = it.SE3()
    X = torch.zeros(n, 6, dtype=torch.float64)
    X[:, :3] = 0.3 * torch.randn(n, 3, generator=gen, dtype=torch.float64)
    X[:, 3:] = 10.0 ** (-11 + 2.5 * torch.rand(n, 1, generator=gen,
                                               dtype=torch.float64)) \
        * torch.tensor([0.6, 0.0, 0.8], dtype=torch.float64)
    return M.exp(M.identity()[None].double(), X)


def _near_half_pi(n, gen):
    """Particles half of which are turned by pi/2 about the axis (1, 2, 2)
    / 3 against the other half: relative angles near pi/2."""
    M = it.SE3()
    pts = _cloud(n, [0.4] * 3 + [0.05] * 3, [0.0] * 6, gen)
    turn = torch.tensor([0.0, 0.0, 0.0, 1 / 3, 2 / 3, 2 / 3],
                        dtype=torch.float64) * (math.pi / 2)
    pts[n // 2:] = M.exp(pts[n // 2:], turn.expand(n - n // 2, 6))
    return pts


def _lse64(pts, bw, query, lead=()):
    return beliefs._kde_lse_chunked(it.SE3(), pts.double(), bw.double(),
                                    query.double(), lead)


# -- which SE(3) reads reach the kernel ---------------------------------------

class _SE3Like(lie.SE3):
    """A subclass may redefine ``log``: it keeps the eager route."""


def test_se3_is_a_kernel_instance_and_its_subclass_is_not():
    assert kde_lse.manifold_code(it.SE3()) == (2, 6)
    assert kde_lse.manifold_code(_SE3Like()) is None
    pts = _cloud(8, [0.1] * 6, [0.0] * 6, torch.Generator().manual_seed(1))
    bw = torch.full((6,), 0.2)
    # a CPU tensor never takes the kernel; the wrapper refuses it
    assert not kde_lse.takes(it.SE3(), pts.float(), pts.float(), bw)
    with pytest.raises(ValueError, match="CUDA"):
        kde_lse.kde_row_logsumexp(it.SE3(), pts.float(), pts.float(), bw)


def test_an_eager_se3_read_counts_its_pairs_and_names_its_manifold():
    M = it.SE3()
    pts = _cloud(30, [0.3] * 6, [0.0] * 6, torch.Generator().manual_seed(2),
                 lead=(2,)).float()
    bw = torch.full((2, 6), 0.2)
    with tracing.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        beliefs.kde_logpdf(M, beliefs.Belief(pts, bw, bw), pts[:, :5])
    snap = tracing.snapshot()
    assert snap["counters"] == {"kde_eager_pairs": 2 * 5 * 30}
    span, = [s for s in snap["spans"] if s["name"] == "kde_logpdf"]
    assert span["attrs"] == {"N": 30, "Q": 5, "manifold": "SE3"}


# -- the plain version, in float64 and float32 ---------------------------------

@pytest.mark.parametrize("case", ["x0", "x1", "tiny", "half_pi"])
def test_the_plain_version_is_the_eager_route_and_the_reference(case):
    """In float64 the plain version (the kernel's expressions) reads what
    the eager chunked route (the port's ``SE3.log``) reads, to 1e-9 in
    log-density: the eager route's 1 - cos(s) loses ~1e-16 / s^2 of V^-1's
    coefficient at the cell's relative angles (s ~ 1e-3 at x0), the plain
    version's half-angle form does not.  Against ``reference/se3.py`` the
    log maps agree to 1e-9 of a bandwidth; the reference's principal-angle
    ``Log`` and series are written apart from both."""
    from bench_port.reference.se3 import SE3 as RefSE3

    gen = torch.Generator().manual_seed(7)
    n = 300
    if case in SPREADS:
        pts = _cloud(n, *SPREADS[case], gen)
    elif case == "tiny":
        pts = _tiny_angles(n, gen)
    else:
        pts = _near_half_pi(n, gen)
    bw = beliefs.loo_bandwidth(it.SE3(), pts)
    if case == "tiny":
        bw[3:] = 1e-9
    q = pts[: n // 3]
    got = kde_lse.se3_row_logsumexp(pts, q, bw)
    want = _lse64(pts, bw, q)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) < 1e-9
    X = kde_lse.se3_log(pts[None], q[:, None])
    ref = RefSE3().log(pts[None], q[:, None])
    assert float(((X - ref) / bw).abs().max()) < 1e-9


def test_the_plain_version_reads_batched_members():
    """points (2, 3, N, 7), query (2, 3, Q, 7), bw (3, 6) shared by the
    first axis: each member as its own read, in rows of a few pairs."""
    gen = torch.Generator().manual_seed(8)
    pts = _cloud(120, *SPREADS["x1"], gen, lead=(2, 3))
    q = _cloud(17, *SPREADS["x1"], gen, lead=(2, 3))
    bw = torch.stack([beliefs.loo_bandwidth(it.SE3(), pts[0, j])
                      for j in range(3)])
    got = kde_lse.se3_row_logsumexp(pts, q, bw, chunk_pairs=5 * 120 * 6)
    assert got.shape == (2, 3, 17)
    for i in range(2):
        for j in range(3):
            want = _lse64(pts[i, j], bw[j], q[i, j])
            assert float((got[i, j] - want).abs().max()) < 1e-9


@pytest.mark.parametrize("case", ["x0", "x1"])
def test_float32_keeps_what_the_eager_log_loses(case):
    """On the cell's spreads the plain version in float32 reads within
    2e-6 of float64 in log-density (the card's ``BAR`` leaves room for the
    kernel's ex2.approx and sums); a bfloat16 log map misses ``BAR`` by
    far, and so does the eager float32 ``SE3.log``, whose 1 - cos(s) loses
    V^-1's coefficient at small relative angles."""
    gen = torch.Generator().manual_seed(9)
    pts = _cloud(600, *SPREADS[case], gen).float()
    bw = beliefs.loo_bandwidth(it.SE3(), pts)
    want = _lse64(pts, bw, pts)
    f32 = kde_lse.se3_row_logsumexp(pts, pts, bw).double()
    bf16 = kde_lse.se3_row_logsumexp(pts.bfloat16(), pts.bfloat16(),
                                     bw.bfloat16()).double()
    eager = beliefs._kde_lse_chunked(it.SE3(), pts, bw, pts, ()).double()
    assert float((f32 - want).abs().max()) < 2e-6
    assert float((bf16 - want).abs().max()) > 100 * BAR
    assert float((eager - want).abs().max()) > 10 * BAR


# -- the float64 reference against the port and the JAX package -------------

def _ref_and_port_points(n=400, seed=10):
    gen = torch.Generator().manual_seed(seed)
    X = torch.randn(n, 6, generator=gen, dtype=torch.float64) \
        * torch.tensor([3.0] * 3 + [0.9] * 3, dtype=torch.float64)
    Y = torch.randn(n, 6, generator=gen, dtype=torch.float64) \
        * torch.tensor([3.0] * 3 + [0.9] * 3, dtype=torch.float64)
    # rotation vectors of 1e-10 and 1e-6 under and across the series'
    # thresholds
    X[:4, 3:] = torch.tensor([1e-10, 1e-6, 5e-5, 2e-4])[:, None] \
        * torch.tensor([0.0, 0.6, 0.8], dtype=torch.float64)
    return X, Y


def _same_pose(a, b):
    """Largest gap of two point arrays, a quaternion and its negative
    being one rotation."""
    dt = (a[..., :3] - b[..., :3]).abs().amax(-1)
    dq = torch.minimum((a[..., 3:] - b[..., 3:]).abs().amax(-1),
                       (a[..., 3:] + b[..., 3:]).abs().amax(-1))
    return float(torch.maximum(dt, dq).max())


def test_the_reference_is_the_ports_se3_in_float64():
    """Group operations to 1e-12; ``Exp`` to 1e-9, since the port's
    closed form (1 - cos t) / t^2 keeps 1e-16 / t^2 of itself, which the
    reference's series does not lose (4e-10 at t = 1e-6, translations of
    ~4); ``log`` of rotations inside the principal ball to 1e-9."""
    from bench_port.reference.se3 import SE3 as RefSE3

    R, P = RefSE3(), it.SE3()
    X, Y = _ref_and_port_points()
    p, q = P.Exp(X), P.Exp(Y)
    assert _same_pose(R.Exp(X), p) < 1e-9
    assert _same_pose(R.Exp(X[4:]), p[4:]) < 1e-12
    assert _same_pose(R.compose(p, q), P.compose(p, q)) < 1e-12
    assert _same_pose(R.inverse(p), P.inverse(p)) < 1e-12
    assert _same_pose(R.exp(p, Y), P.exp(p, Y)) < 1e-9
    small = Y.clone()
    small[:, 3:] *= 0.3                  # inside the principal ball
    r = R.exp(p, small)
    assert float((R.log(p, r) - P.log(p, r)).abs().max()) < 1e-9
    assert float((R.log(p, r) - small).abs().max()) < 1e-9
    # the principal log whatever the sign of w: 4 rad about z is -2.28
    th = torch.tensor([4.0], dtype=torch.float64)
    flip = torch.cat([torch.zeros(3, dtype=torch.float64), torch.cos(th / 2),
                      torch.zeros(2, dtype=torch.float64), torch.sin(th / 2)])
    assert float(flip[3]) < 0
    for L in (R.Log(flip), P.Log(flip)):
        torch.testing.assert_close(L[3:], torch.tensor(
            [0.0, 0.0, 4.0 - 2 * math.pi], dtype=torch.float64))
    pts = P.exp(p[:1].expand(len(Y), 7), 0.2 * Y)
    assert _same_pose(R.mean(pts), P.mean(pts)) < 1e-9


def test_the_reference_is_the_jax_packages_se3_in_float64():
    import jax
    import jax.numpy as jnp

    from bench_port.reference.se3 import SE3 as RefSE3
    from incrementalinference.jl_tpu.manifolds import lie as jlie

    R, J = RefSE3(), jlie.SE3()
    X, Y = _ref_and_port_points(seed=12)
    Y[:, 3:] *= 0.3
    with jax.enable_x64(True):
        jp = J.Exp(jnp.asarray(X.numpy()))
        jq = J.exp(jp, jnp.asarray(Y.numpy()))
        jlog = np.asarray(J.log(jp, jq))
        p, q = torch.from_numpy(np.asarray(jp)), torch.from_numpy(
            np.asarray(jq))
    assert p.dtype == torch.float64
    assert _same_pose(R.Exp(X), p) < 1e-9
    assert _same_pose(R.exp(p, Y), q) < 1e-9
    assert float((R.log(p, q) - torch.from_numpy(jlog)).abs().max()) < 1e-9


# -- the cell on the CPU -------------------------------------------------------

#: one step of the cell at N=200 on the CPU, as ``run.execute`` makes it,
#: then again with half of every belief's particles kept from before the
#: solve; in a process of its own, since a run refuses a process that has
#: loaded JAX, as this file's conftest does
_CELL_SCRIPT = """
import json, sys, torch
sys.path.insert(0, {root!r})
from bench_port import faults, run
from bench_port.lib import registry
from bench_port.tests.helpers import TEST_POSE_LIMITS, cpu_run
cell = registry.cell(registry.benchmark(), "se3pair-n33k.mmisam-ppe")
cell["cfg"]["N"] = 200
cell["limits"].update(TEST_POSE_LIMITS)
for fault in (None, "half_stale"):
    if fault:
        obj, attr, new = faults.patch(fault)
        setattr(obj, attr, new)
    rc, line, err = cpu_run(cell)
    print(json.dumps({{"rc": rc, "line": line, "err": err[-2000:]}}))
"""


def test_the_cell_is_correct_on_the_cpu_and_not_with_a_stale_half():
    """The cell at N=200 through ``run.execute`` (the ``Runner``, its
    phases and the SE(3) checks), held to the cell's limits with the pose
    limits of a test's size (``bench_port/tests/helpers.py``): correct;
    then not correct with the ``half_stale`` fault, which ``stale_share``
    reads."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c",
                        _CELL_SCRIPT.format(root=root)], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    sound, stale = (json.loads(x) for x in p.stdout.strip().splitlines()[-2:])
    assert sound["rc"] == 0 and sound["line"]["correct"] is True, \
        sound["err"]
    assert set(sound["line"]["checks"]) == {
        "unsolved", "bad_particles", "bw_base_gap", "ppe_mean_gap",
        "ppe_max_gap", "pose_mean_z", "pose_log_sd", "stale_share"}
    assert stale["rc"] == 0 and stale["line"]["correct"] is False
    c = stale["line"]["checks"]["stale_share"]
    assert c["value"] > c["limit"]


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    """Skips where no CUDA card is present (decided here, when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    kde_lse.build()
    return torch.device("cuda", 0)


def _card_cloud(case, n, gen):
    if case in SPREADS:
        return _cloud(n, *SPREADS[case], gen)
    if case == "tiny":
        return _tiny_angles(n, gen)
    return _near_half_pi(n, gen)


@pytest.mark.card
@pytest.mark.parametrize("n", [300, 4096, 33_000])
@pytest.mark.parametrize("case", ["x0", "x1", "half_pi"])
def test_kernel_matches_the_plain_route_in_float64(card, case, n):
    gen = torch.Generator().manual_seed(n + len(case))
    pts = _card_cloud(case, n, gen).float().to(card)
    M = it.SE3()
    bw = beliefs.loo_bandwidth(M, pts)
    b = beliefs.Belief(pts, bw, bw)
    queries = {"one": pts[7:8],
               "other": _card_cloud(case, 997, gen).float().to(card),
               "self": pts}
    for label, q in queries.items():
        kde_lse.reset_counts()
        got = beliefs.kde_logpdf(M, b, q)
        assert kde_lse.counts["launches"] == 1, label
        want = beliefs.kde_logpdf(M, beliefs.Belief(
            pts.double(), bw.double(), bw.double()), q.double())
        err = float((got.double() - want).abs().max())
        print(f"SE3 {case} N={n} Q={q.shape[0]} ({label}): kernel "
              f"{err:.2e} from float64")
        assert bool(torch.isfinite(got).all())
        assert err <= BAR, (label, err)


@pytest.mark.card
def test_kernel_matches_under_the_taylor_threshold_and_in_a_batch(card):
    """Relative rotations under 1e-8 (lie.py's Taylor forms), and a batch
    of 2 x 3 members sharing bandwidths along the first axis: one launch,
    each member as its own read."""
    M = it.SE3()
    gen = torch.Generator().manual_seed(31)
    pts = _tiny_angles(4096, gen).float().to(card)
    bw = beliefs.loo_bandwidth(M, pts)
    bw[3:] = 1e-3
    got = beliefs.kde_logpdf(M, beliefs.Belief(pts, bw, bw), pts)
    want = beliefs.kde_logpdf(M, beliefs.Belief(
        pts.double(), bw.double(), bw.double()), pts.double())
    assert float((got.double() - want).abs().max()) <= BAR
    pts = _cloud(2048, *SPREADS["x1"], gen, lead=(2, 3)).float().to(card)
    q = _cloud(130, *SPREADS["x1"], gen, lead=(2, 3)).float().to(card)
    bw = torch.stack([beliefs.loo_bandwidth(M, pts[0, j]) for j in range(3)])
    kde_lse.reset_counts()
    got = beliefs.kde_logpdf(M, beliefs.Belief(pts, bw, bw), q)
    assert got.shape == (2, 3, 130)
    assert kde_lse.counts == {"launches": 1, "problems": 6, "calls": 1}
    for i in range(2):
        for j in range(3):
            want = beliefs.kde_logpdf(M, beliefs.Belief(
                pts[i, j].double(), bw[j].double(), bw[j].double()),
                q[i, j].double())
            assert float((got[i, j].double() - want).abs().max()) <= BAR


@pytest.mark.card
def test_a_row_alone_is_the_row_of_the_full_read(card):
    M = it.SE3()
    n = 33_000
    pts = _cloud(n, *SPREADS["x1"], torch.Generator().manual_seed(4)
                 ).float().to(card)
    bw = beliefs.loo_bandwidth(M, pts)
    b = beliefs.Belief(pts, bw, bw)
    full = beliefs.kde_logpdf(M, b, pts)
    assert torch.equal(full, beliefs.kde_logpdf(M, b, pts))
    for i in (0, 1, 31, 32, 1000, n - 1):
        assert torch.equal(beliefs.kde_logpdf(M, b, pts[i:i + 1])[0],
                           full[i]), i
