#!/usr/bin/env python3
"""Smoke run of the PyTorch port (incrementalinference_torch) on one GPU.

Usage, from the root of the repository, on a machine with an H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line; none is caught):
1. build the row-logsumexp CUDA kernel from ops/kernels/csrc/row_lse.cu,
   check that the native elimination ordering built (without it the tree,
   and so the walls, would be those of the Python heuristic), print the
   seconds of each compiler run (nvcc, g++; "cached" where the
   content-addressed library existed), and count the instruction slots
   per pair of the kernel's inner loop in its SASS;
2. hold the kernel against its plain PyTorch version on the card, at the
   reference's check points (n, dof) of benchmarks/pallas_tpu_check.py, a
   zero-precision partial-dims case, n = 65536, the N = 50k solve's shape,
   and the cases its base-2 lazy-rescale arithmetic could get wrong (rows
   far from every B kernel, one near column among far ones, Nb under a
   warp at dof 8, all precisions zero), and tangent coordinates of real
   SE(2) and SE(3) proposals at dof 3 and dof 6 (those far from their
   reference point are held against float64 instead, see
   phase_conditioning); bar:
   max|kernel - plain| / max(max|plain|, 1) <= 1e-5, every output finite;
3. solve LineStep(20) at N = 100 through ``solve_tree`` on CUDA, with the
   bars of tests/test_fused_chain.py (|mean(x_i) - i| < 1.5);
4. solve the two-variable N = 50,000 graph of
   benchmarks/pallas_e2e_solve.py through ``solve_tree`` on CUDA: every
   two-proposal product is 50k x 50k pairs and goes through the kernel
   (its launch count must grow); bars |mean - mu| < 0.2, 0.4 < std < 1.5;
   Then the warm start (phase_warmstart, budget 90 s): the pack written
   from phase 1's libraries; two fresh processes, one after the other, on
   a copy of the package without build directories solve phases 3 and
   4's graphs at their bars: one seeds from the pack (3 hits, no miss, no
   compiler run), the other from a pack whose only entry is a kernel
   carrying another source's digest, never looked up (both compilers run,
   3 misses); their walls from launch side by side. condense_mixture
   (phase_condense): 50 runs at N = 20,000, dof 1 and 3, k = 256,
   bit-equal, timed beside the index_add_ form it replaced; the
   two-variable graph at N = 4,096 through the condensed product stages
   at phase 4's bars.  The precision pin (phase_precision): the N = 4,096
   and N = 50,000 two-variable graphs solved twice at the default setting
   and once under a caller's set_float32_matmul_precision("high"), the
   posteriors bit-equal, every _pair_logW and condense_mixture call in
   "ieee", "high" given back; the TF32 - IEEE gap of condense_mixture on
   the N = 4,096 solve's inputs, of _pair_logW on 2,048-row blocks of the
   N = 50,000 solve's large pair products (whose kernels run no matmul),
   and of _pair_logW at dof 2, 3, 6 and 8, where the pinned call under
   "high" must equal IEEE.
   Concurrent solves, one graph per thread (phase_threads, budget 45 s):
   (a) two threads each build and solve the N = 50,000 two-variable graph
   (seeds 1 and 2) on the default stream, released by one barrier: 12 + 12
   launches, each thread's posteriors bit-equal to its graph solved alone
   before, each thread's first row log-partitions against the plain
   version (<= 1e-5); (d) beside them a third thread's own
   vmap(jacfwd(f)) on a CUDA tensor, every Jacobian equal to its
   one-thread value; (b) the same two solves, each thread on its own CUDA
   stream, at phase 4's bars, the largest difference from alone printed;
   (c) the two-pose SE(2) graph at N = 4,096 on one thread beside the
   parametric LineStep(1000) dense solve on another, each at its bars and
   bit-equal to its solve alone;
5. the six scripts of examples_torch/ (phase_examples, budget 240 s),
   each through its main() at its bars: the fourdoor story (a four-mode
   Mixture prior seen three times along a chain; build, solve, grow,
   re-solve with ``old_tree``) at N = 100 and at N = 50,000, where its
   products go through the kernel, with the bars of
   tests/test_solve.py:23-39 after each solve (phase_fourdoor), and once
   as `python3 examples_torch/fourdoor.py` in a fresh process that
   imports nothing of JAX; the range-only graph (EuclidDistance, dof 2,
   the LM branch of the convolution) at the bars of
   tests/test_solve.py:181-193 (phase_euclid), then a third range; the
   golden saveDFG archive loaded, solved, saved and loaded back; the
   incremental SE(2) SLAM example with its parametric cross-check; the
   ODE example (three DERelatives, then the n-ary decay-rate factor of
   tests/test_extensions.py:229-254 at 16 RK4 steps, |mean(k) - 0.7| <
   0.15); two processes on the card (examples_torch/multihost.py); then a
   chain that grows by six poses three times, re-solved with clique
   recycling, once with the wildfire gate off and once at tolerance 0.6
   (|mean(x_i) - i| < 0.5, the recycled count grows; ``wildfire_stats`` of
   both printed);
6. curved manifolds: the SE(2) hexagon (7 poses, a landmark, a loop
   closure) at N = 100, one solve (Karcher means of x1, x3, x6 within
   1.5 of the ideal hexagon's poses); the circular chain of
   tests/test_manifold_solves.py:14-33 at its bars; the two-variable graph
   on SE(2) at N = 50,000 and on SE(3) at N = 33,000 (a ManifoldPrior on
   each pose, a ManifoldFactor between them), whose products go through the
   kernel at dof 3 and dof 6 (launches must grow; Karcher means within 0.2
   of truth, per-dof tangent std within (0.2, 1.5) x the prior's);
   posterior estimates on those two solved graphs (phase_ppe, budget
   60 s): every variable's lazy ppe read once, its peak device memory
   under the chunk's bar (beliefs._KDE_CHUNK_PAIRS x 256 B) and its wall
   printed, every estimate finite, mean = M.mean(points), max the tie
   average of the particles of highest KDE density, mean within 0.2 of
   truth; the chunked eager kde_logpdf and _ppe_core against the
   one-pass form at SE(2) N = 8,192 (log-density within 1e-6, mean
   bit-equal, the same particles chosen), and the KDE kernel
   (ops/kernels/kde_lse.py) on SE(2) and SE(3) against the one-pass form in
   float64 (2e-5; the chosen particle within 1e-5 of the best); that kernel
   at 50k x 50k on SE(2) and Euclidean(1) and at 33k x 33k on SE(3), timed
   by CUDA events beside its eager chunks and held to the float64 read
   (phase_kde_kernel, 2e-5); the large pair
   product's column-draw kernel (ops/kernels/pair_draw.py) at 50k x 50k,
   dof 1 and 3, timed beside its plain version and the eager block draw it
   replaced, the rows where kernel and plain version part on the same
   uniforms at most 1e-4 (phase_draw_kernel);
   LineStep(20) once more with joint up-messages (use_msg_likelihoods);
   Then the model families and the graph and tree surfaces, each solve
   through ``solve_tree`` on CUDA at N = 50,000 with the kernel's launch
   count asserted to grow: the two-variable graph with a network-ensemble
   mixture relative (MixtureFluxModels over an 8-member conv
   SequentialNet), the forced ODE of tests/test_extensions.py:178-226 (a
   DERelative with the ramp as ``data``; one proposal for each variable
   is counted first: its LM iterations and Jacobian passes, calls of
   ops/convolve.py's vmap(jacrev); the solve's peak memory) and a landmark
   with a HeatmapGridDensity prior seen from a pose on R² (products at dof
   2); deepcopy_graph,
   remove_variable and a re-solve on the card, ppe_batched against ppe on
   the hexagon's poses, and the clique accessors over its tree;
   Then persistence and diagnostics (phase_persistence): warmup; the
   N = 50,000 two-variable graph solved, saved, loaded onto the card (every
   belief float32 there and bit-equal to the saved one, the tree clique for
   clique) and re-solved with the loaded tree as ``old_tree`` through the
   kernel at the bars of phase 4; its saveDFG archive round trip and the
   golden archive of tests/fixtures solved at its bars; skip_cliques,
   timeout and delay_cliques, the history files and replay_clique_up on
   LineStep(20) at N = 100;
   Then the batched level and distribution (phase_batched, budget 90 s):
   the kernel's batched launch (8 members in one launch, the member from
   blockIdx.z) at 50k x 50k, dof 1 and dof 3, against its plain version
   looped over the members (rel err <= 1e-5) and against 8 single launches
   (<= 1e-6), timed against those 8 launches, the library route looped
   over the members and 8 x the bound; a forest of eight copies of the
   two-variable graph at N = 50,000 (one level of 8 cliques: the default
   batch_cliques="auto" batches it) solved cold and warm batched and once
   with batch_cliques=False, every branch at phase 4's bars, held to 54
   launches of 96 problems batched (the up stages one launch for all 8)
   and 96 of 96 per clique, with the peak memory;
   bench.py's 32-branch forest at N = 100 batched and per clique (walls)
   and profiled batched; fourdoor at N = 100 with batch_cliques=True;
   LineStep(20) with fuse_sweep=True (API parity only: clique by
   clique); a mesh of the one card (make_mesh()) and Mesh([cuda:0] * 4)
   under "particles", "cliques" and "auto" and for the parametric tree
   solve, at the bars of tests/test_multichip*.py; dryrun_multichip(1),
   entry() and the Kaess solve with precompile=True;
   Then the multi-process tree solve (phase_multihost, budget 150 s):
   fifty scans of keys.cdf and ten row draws of keys.categorical from one
   key over 50,000 logits are equal; two processes share the card (collectives over gloo on host
   bytes: NCCL refuses two ranks on one GPU) and solve the anchored forest
   of parallel/multihost.py (an anchor and 4 branches of 3) at N = 50,000
   cold and warm through launch_multihost, each launching the kernel; the
   same fixture in this process through solve_tree_multihost (no process
   group: the partition owns everything, no top) and solve_tree with
   batch_cliques=False; the bars of tests/test_multihost.py:244-261 (each
   process's max |mean - truth| under max(1, 3 x the one-process error),
   the processes' posteriors within 1e-6), the warm solve's launch
   identity p0 + p1 = one process + the top (the top's count equal in
   both), the kernel against its plain version on the inputs the solve
   handed it; per process the phase walls, cut and sync bytes, the
   collectives and their latency at 8 B and 16 kB; then at N = 64 the
   fault flood (both processes end in "error" within 200 s) and the
   parametric variant (max error < 0.35, the processes within 1e-6, no
   launch);
7. time the kernel, its plain version and one library route
   (torch.addmm-built logW + torch.logsumexp) at 50k x 50k, dof 1, the
   same three on the inputs the SE(2), SE(3) and heatmap (dof 2) solves
   handed the kernel,
   and the kernel beside its bound at four more (n, dof);
8. the parametric stack (no kernel on its path: each phase asserts that
   the row-logsumexp launched 0 times): solve_graph_parametric on
   LineStep(1000) without graphinit (752 scalar variables, the rows of
   benchmarks/parametric_scale.py), cold and warm on fresh builds, max
   |x_i - i| < 1e-2 and every covariance finite and positive, with the
   split of a warm solve; the same with solver="cg" (within 1e-2 of the
   dense solve); the SE(3) chain of benchmarks/parametric_scale.py, cut
   from 200 poses to 30 (autoinit's rounds take 1.3-2.4 s a pose on the
   card's host, PERF.md), through autoinit_parametric and the solve, and
   the solve alone on a fresh graph seeded with the autoinit points
   (translation error < 2.0 against the composed step, covariance blocks
   finite, symmetric and positive definite); the time of one Jacobian of
   the chain's relative-factor group by vmap(jacrev) (the solver's),
   vmap(jacfwd) and one batched backward pass (they agree to 1e-3); the
   wide 32-branch
   forest of bench.py through solve_tree(algorithm="parametric"), fresh
   twice and re-solved (the bars of tests/test_parametric.py:139-144, the
   problems each batched LM call held); the SE(2) hexagon phase 6 solved,
   parametric (|x6[:2]| < 1.5; phase 6 also holds its nonparametric means
   within 1.5 of the port's parametric optimum), and the 8 -> 9 chain of
   tests/test_parametric.py:219-262 re-solved with old_tree (>= 3 recycled
   cliques, within 1e-3 of a solve from scratch);
9. profile one more warm solve of the LineStep, the two-variable, and the
   SE(2) and SE(3) configurations, and of the parametric LineStep(1000) and
   forest (torch.profiler): device busy share, the ten device operations
   and the ten host operators with the most time.

The last three lines are the card's name and power limit (nvidia-smi), a
JSON object of per-kernel numbers (with the batched launch's under
"batched"), and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import collections
import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# H100 SXM published rates (NVIDIA data sheet):
# HBM bytes/s, FP32 (non-tensor) FLOP/s, boost clock for the MUFU rate
_HBM_BPS = 3.35e12
_FP32_FLOPS = 67e12
_BOOST_HZ = 1.98e9
_MUFU_PER_SM_CLK = 16
_TOL = 1e-5


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel_err(a, b) -> float:
    """The error formula of benchmarks/pallas_tpu_check.py."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1.0))


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        st = torch.cuda.Event(enable_timing=True)
        en = torch.cuda.Event(enable_timing=True)
        st.record()
        fn()
        en.record()
        torch.cuda.synchronize()
        times.append(st.elapsed_time(en))
    return statistics.median(times)


def inputs(gen, n, dof, dev):
    """The input recipe of benchmarks/pallas_tpu_check.py."""
    muA = torch.randn((n, dof), generator=gen, device=dev) * 3
    muB = torch.randn((n, dof), generator=gen, device=dev)
    precA = torch.randn((n, dof), generator=gen, device=dev).abs() + 0.5
    precB = torch.randn((n, dof), generator=gen, device=dev).abs() + 0.5
    return muA, precA, muB, precB


def extreme_cases(gen, dev):
    """Inputs that stress the kernel's reference-and-rescale arithmetic
    (the recipes of tests/test_torch_kernels.py, at the card's sizes)."""
    def full(like, value):
        return torch.full_like(like, value)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    cases = []
    # every log2-weight far below the exp range: the answer lives in m_ref
    for dof in (1, 8):
        sign = torch.where(randn(3000, dof) < 0, -1.0, 1.0)
        muA, muB = 1e3 * sign, randn(5000, dof)
        cases.append((muA, full(muA, 11.0), muB, full(muB, 11.0),
                      f"far-rows dof {dof}"))
    # one B kernel beside half of the rows, the rest 30 sigma away; the
    # other half of the rows far from all of B.  Lane 3 owns columns
    # 12..15, 140..143, 268.. of a 256-column chunk
    n = 40_000
    for where, tag in ((0, "first"), (12, "lane-first"), (140, "lane-middle"),
                       (n // 2 + 141, "middle"), (n - 1, "last")):
        muA = torch.cat([30 + 0.3 * randn(1500, 1), -30 + 0.3 * randn(1500, 1)])
        muB = randn(n, 1)
        muB[where] = 30.0
        cases.append((muA, full(muA, 11.0), muB, full(muB, 11.0),
                      f"near-column {tag}"))
    # Nb under a warp, Na no multiple of the rows per block, dof 8
    muA, muB = 3 * randn(1037, 8), randn(19, 8)
    cases.append((muA, full(muA, 1.5), muB, full(muB, 1.5),
                  "nb-under-a-warp dof 8"))
    # all precisions zero: every weight is 1, the answer log Nb
    for dof in (1, 8):
        muA, muB = randn(1000, dof), randn(3000, dof)
        cases.append((muA, full(muA, 0.0), muB, full(muB, 0.0),
                      f"zero-precision dof {dof}"))
    return cases


_SE2_STEP = [10.0, 0.0, math.pi / 3]
_SE2_SIGMA = [0.5, 0.5, 0.05]
_SE3_STEP = [10.0, 0.0, 0.0, 0.0, 0.0, math.pi / 3]
_SE3_SIGMA = [0.5] * 3 + [0.05] * 3


def _manifold_setups():
    from incrementalinference_torch.manifolds import SE2, SE3
    return ((SE2(), "Pose2", _SE2_STEP, _SE2_SIGMA, 50_000),
            (SE3(), "Pose3", _SE3_STEP, _SE3_SIGMA, 33_000))


def manifold_cases(gen, dev):
    """Kernel inputs made as the cascade makes them (ops/fused.py
    _product_members) from SE(2) and SE(3) proposals: tangent coordinates
    at a reference point and LOO bandwidths.  Returns (cases, probes).
    Cases, held to the kernel's bar: the two proposals the two-variable
    solves multiply at x1 (a prior at the composed pose; the other pose's
    prior pushed through the step) seen from their pooled Karcher mean, at
    the solves' particle counts; and the same two proposals under a weak
    prior (sigma 30 in translation, 1 or 0.5 rad in rotation), where angles
    of order 1 sit beside translations of order 10 to 100.  Probes: poses on
    the corners of the hexagonal graph's hexagon (side 10, and side 50)
    seen from the identity: several modes, each many bandwidths from the
    reference point (see phase_conditioning)."""
    from incrementalinference_torch.beliefs import loo_bandwidth

    def randn(n, sigma):
        return torch.randn((n, len(sigma)), generator=gen, device=dev) \
            * torch.tensor(sigma, device=dev)

    def terms(M, ref, ptsA, ptsB):
        out = []
        for pts in (ptsA, ptsB):
            t = M.log(ref[None, :], pts)
            prec = 1.0 / torch.clamp(loo_bandwidth(M, pts) ** 2, min=1e-12)
            out += [t, prec.expand(t.shape).contiguous()]
        return out

    cases, probes = [], []
    for M, name, step, sigma, n in _manifold_setups():
        step_t = torch.tensor(step, device=dev)
        x1 = M.exp(M.identity(dev), step_t)

        def product_at_x1(n, prior_sigma):
            ident = M.identity(dev).expand(n, M.point_dim)
            prior = M.exp(x1.expand(n, M.point_dim), randn(n, prior_sigma))
            pushed = M.exp(M.exp(ident, randn(n, prior_sigma)),
                           step_t + randn(n, sigma))
            ref = M.mean(torch.cat([prior, pushed]))
            return terms(M, ref, prior, pushed)

        m = 8192
        weak = {"Pose2": [30.0, 30.0, 1.0],
                "Pose3": [30.0] * 3 + [0.5] * 3}[name]
        cases.append((*product_at_x1(n, sigma),
                      f"{name} product at x1, n {n}, dof {M.dof}"))
        cases.append((*product_at_x1(m, weak),
                      f"{name} product under a weak prior, n {m}, "
                      f"dof {M.dof}"))
        for side in (step[0], 5.0 * step[0]):
            corners, p = [], M.identity(dev)
            for _ in range(6):
                p = M.exp(p, torch.tensor([side] + step[1:], device=dev))
                corners.append(p)
            which = torch.randint(0, 6, (m,), generator=gen, device=dev)
            big = [4.0 * x for x in sigma]
            ptsA = M.exp(torch.stack(corners)[which], randn(m, big))
            ptsB = M.exp(torch.stack(corners)[which.flip(0)], randn(m, big))
            probes.append((*terms(M, M.identity(dev), ptsA, ptsB),
                           f"{name} hexagon of side {side:g} seen from the "
                           f"identity, n {m}, dof {M.dof}"))
    return cases, probes


def phase_conditioning(K, probes):
    """Where float32 ends for the expanded form of the weights.  logW is
    -0.5 (a2 + iva.b^2 - 2 ivmuA.b): three terms of size max(a2) that cancel
    to a difference of order 1, so coordinates far from their reference
    point (in bandwidths) cost digits in the kernel and in its plain
    version alike.  The cascade never does that (it takes tangents at the
    pooled mean, ops/fused.py _product_members); this phase shows what a
    caller who did would get.  Each is held against the difference form
    -0.5 sum ivar (a - b)^2 in float64; bar: absolute error of the kernel
    at most 16 float32 roundings of max(a2)."""
    eps = torch.finfo(torch.float32).eps
    for muA, precA, muB, precB, tag in probes:
        a2, iva, ivm = K.pair_row_terms(muA, precA, muB, precB)
        got = K.row_logsumexp(a2, iva, ivm, muB.contiguous())
        plain = K.row_logsumexp_plain(a2, iva, ivm, muB)
        ivar = iva.double()
        truth = torch.empty_like(got, dtype=torch.float64)
        for i in range(0, muA.shape[0], 1024):
            d = muA[i:i + 1024, None, :].double() - muB[None].double()
            truth[i:i + 1024] = torch.logsumexp(
                -0.5 * (ivar[i:i + 1024, None, :] * d * d).sum(-1), dim=1)
        err_k = float((got.double() - truth).abs().max())
        err_p = float((plain.double() - truth).abs().max())
        bar = 16 * eps * float(a2.max())
        check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
        check(err_k <= bar, f"{tag}: kernel off the float64 difference form "
                            f"by {err_k:.3e} (bar {bar:.3e})")
        print(f"conditioning {tag}: max a2 {float(a2.max()):.1f}, max |lse| "
              f"{float(truth.abs().max()):.1f}; abs err against the float64 "
              f"difference form: kernel {err_k:.3e}, plain {err_p:.3e} (bar "
              f"{bar:.3e}); kernel vs plain rel err "
              f"{rel_err(got, plain):.3e}", flush=True)


def phase_compare(K, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = 0.0
    cases = [inputs(gen, n, dof, dev) + ((n, dof),)
             for n, dof in ((1000, 1), (1024, 2), (5000, 3), (8192, 6),
                            (33000, 3), (50000, 1))]
    cases.append((torch.tensor([[0.0, 5.0]], device=dev),
                  torch.tensor([[1.0, 0.0]], device=dev),
                  torch.tensor([[0.0, -5.0], [3.0, 100.0]], device=dev),
                  torch.ones((2, 2), device=dev), "partial-dims"))
    muA = torch.randn((65536, 3), generator=gen, device=dev)
    ones = torch.ones((65536, 3), device=dev)
    cases.append((muA, ones, muA + 0.5, ones, (65536, 3)))
    # the range graph's width, Na != Nb, Nb no multiple of a column chunk
    muA, precA, _, _ = inputs(gen, 3000, 2, dev)
    _, _, muB, precB = inputs(gen, 5003, 2, dev)
    cases.append((muA, precA, muB, precB, "dof 2, Na 3000, Nb 5003"))
    cases.extend(extreme_cases(gen, dev))
    manifold, probes = manifold_cases(gen, dev)
    cases.extend(manifold)
    for muA, precA, muB, precB, tag in cases:
        a2, iva, ivm = K.pair_row_terms(muA, precA, muB, precB)
        t0 = time.time()
        got = K.row_logsumexp(a2, iva, ivm, muB.contiguous())
        torch.cuda.synchronize()
        dt = time.time() - t0
        ref = K.row_logsumexp_plain(a2, iva, ivm, muB)
        err = rel_err(got, ref)
        check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
        worst = max(worst, err)
        print(f"kernel vs plain {tag}: rel err {err:.3e} "
              f"({dt * 1e3:.2f} ms first call)", flush=True)
    check(worst <= _TOL, f"kernel disagrees with plain: {worst:.3e}")
    print(f"PASS kernel vs plain: worst rel err {worst:.3e} <= {_TOL} over "
          f"{len(cases)} cases")
    phase_conditioning(K, probes)


def phase_linestep(it, K):
    from incrementalinference_torch.canonical import generate_line_step

    walls = []
    for _ in range(2):
        K.reset_counts()
        t_build = time.time()
        fg = generate_line_step(20, graphinit=True, device="cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        it.solve_tree(fg)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    print(f"LineStep(20) graph build with graphinit: "
          f"{t0 - t_build:.3f} s (warm)")
    means = {i: float(fg.points(f"x{i}").mean()) for i in range(0, 21, 2)}
    for i, m in means.items():
        check(abs(m - i) < 1.5, f"LineStep x{i}: mean {m} (bar 1.5)")
    print(f"PASS LineStep(20) N=100 solve_tree on CUDA: cold "
          f"{walls[0]:.3f} s, warm {walls[1]:.3f} s; kernel launches "
          f"{K.counts['launches']} (no pair product reaches the "
          f"threshold at N=100); pose means "
          f"{ {k: round(v, 3) for k, v in means.items()} }", flush=True)
    return walls


def _two_var_graph(it, N, device="cuda", **params):
    fg = it.initfg(it.SolverParams(N=N, batch_cliques=False, **params),
                   device=device)
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)))
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0", "x1"], it.LinearRelative(it.Normal(10.0, 1.0)))
    fg.add_factor(["x1"], it.Prior(it.Normal(10.0, 1.0)))
    return fg


def _check_two_var(fg, what):
    """The bars of benchmarks/pallas_e2e_solve.py: |mean - mu| < 0.2 and
    0.4 < std < 1.5 for x0 (mu 0) and x1 (mu 10)."""
    stats = {}
    for v, mu in (("x0", 0.0), ("x1", 10.0)):
        pts = fg.points(v)[:, 0]
        stats[v] = (float(pts.mean()), float(pts.std()))
        check(abs(stats[v][0] - mu) < 0.2, f"{what} {v}: {stats[v]}")
        check(0.4 < stats[v][1] < 1.5, f"{what} {v}: {stats[v]}")
    return stats


def phase_large(it, K):
    from incrementalinference_torch.ops import product

    N = 50_000
    check(N * N >= product.LARGE_PAIR_THRESHOLD,
          "fixture no longer exceeds the large-pair threshold")
    walls, launches = [], []
    for _ in range(2):
        K.reset_counts()
        fg = _two_var_graph(it, N)
        torch.cuda.synchronize()
        t0 = time.time()
        it.solve_tree(fg)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        launches.append(K.counts["launches"])
        check(K.counts["launches"] > 0,
              "the N=50k solve never launched the row_logsumexp kernel")
        stats = _check_two_var(fg, f"N={N}")
    print(f"PASS N={N} solve_tree on CUDA through the kernel: cold "
          f"{walls[0]:.3f} s, warm {walls[1]:.3f} s; launches per solve "
          f"{launches}; posteriors (mean, std) {stats}", flush=True)
    return walls, launches[-1]


# The fresh process of phase_warmstart: seeds from its copy's pack, counts
# the loaders' hits and misses, and solves phases 3 and 4's graphs.  Its
# walls run from the parent's clock reading just before the launch.
_WARM_CHILD = r"""
import json, os, sys, time
t_launch = float(sys.argv[1])
import torch
import incrementalinference_torch as it
from incrementalinference_torch import native, warmstart
from incrementalinference_torch.ops.kernels import pair_draw as D
from incrementalinference_torch.ops.kernels import row_lse as K

report = {}
out = {"package": os.path.dirname(os.path.abspath(it.__file__)),
       "seeded": warmstart.seed_cache(report=report), "report": report}
counts = warmstart.install_hit_counter()
out["ready_s"] = time.time() - t_launch
K.reset_counts()
torch.empty(1, device="cuda")
torch.cuda.synchronize()
out["context_s"] = time.time() - t_launch
fg = it.generate_line_step(20, graphinit=True, device="cuda")
torch.cuda.synchronize()
out["linestep_graph_s"] = time.time() - t_launch
it.solve_tree(fg)
torch.cuda.synchronize()
out["linestep_s"] = time.time() - t_launch
out["linestep_means"] = {i: float(fg.points(f"x{i}").mean())
                         for i in range(0, 21, 2)}
fg = it.initfg(it.SolverParams(N=50_000, batch_cliques=False),
               device="cuda")
fg.add_variable("x0", it.ContinuousScalar)
fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)))
fg.add_variable("x1", it.ContinuousScalar)
fg.add_factor(["x0", "x1"], it.LinearRelative(it.Normal(10.0, 1.0)))
fg.add_factor(["x1"], it.Prior(it.Normal(10.0, 1.0)))
torch.cuda.synchronize()
out["two_var_graph_s"] = time.time() - t_launch
it.solve_tree(fg)
torch.cuda.synchronize()
out["two_var_s"] = time.time() - t_launch
out["two_var"] = {v: [float(fg.points(v)[:, 0].mean()),
                      float(fg.points(v)[:, 0].std())]
                  for v in ("x0", "x1")}
out["launches"] = K.counts["launches"]
out["build_seconds"] = [K.build_seconds, D.build_seconds,
                        native.build_seconds]
out["kernel_path"] = K.LIBRARY.path()
out["kernel_dir"] = sorted(os.listdir(K.LIBRARY.build_dir))
out["counts"] = counts
print(json.dumps(out))
"""


def _warm_child(root):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t_launch = time.time()
    r = subprocess.run([sys.executable, "-c", _WARM_CHILD, repr(t_launch)],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=300)
    check(r.returncode == 0, f"warm-start process failed:\n"
          f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    check(res["package"] == os.path.join(root, "incrementalinference_torch"),
          f"the warm-start process imported {res['package']}")
    check(res["launches"] > 0,
          "warm start: the N=50k solve never launched the kernel")
    for i, m in res["linestep_means"].items():
        check(abs(m - int(i)) < 1.5, f"warm LineStep x{i}: mean {m}")
    for v, mu in (("x0", 0.0), ("x1", 10.0)):
        mean, std = res["two_var"][v]
        check(abs(mean - mu) < 0.2 and 0.4 < std < 1.5,
              f"warm N=50000 {v}: {res['two_var'][v]}")
    return res


def _mismatch_pack(pack, kernel, others, root):
    """Leave in ``pack`` only the kernel's entry, renamed to the name a
    build of another source would carry, file and manifest (the
    ``others`` libraries' entries removed); returns it."""
    edited = os.path.join(root, "row_lse.cu")
    shutil.copyfile(kernel.src, edited)
    with open(edited, "a") as fp:
        fp.write("// another source\n")
    other = os.path.basename(dataclasses.replace(kernel, src=edited).path())
    name = os.path.basename(kernel.path())
    os.rename(os.path.join(pack, name), os.path.join(pack, other))
    for lib in others:
        os.remove(os.path.join(pack, os.path.basename(lib.path())))
    with open(os.path.join(pack, "MANIFEST.json")) as fp:
        man = json.load(fp)
    entry = man["entries"].pop(name)
    with open(edited, "rb") as fp:
        entry["source_sha256"] = hashlib.sha256(fp.read()).hexdigest()
    man["entries"] = {other: entry}
    man["n_entries"] = 1
    with open(os.path.join(pack, "MANIFEST.json"), "w") as fp:
        json.dump(man, fp)
    return other


def phase_warmstart(it, K):
    """The port's warm start (budget 90 s), an A/B of two fresh processes on
    a copy of the package without its build directories, one after the
    other.  The pack is written from the libraries phase 1 built (no second
    compiler run in this process).  A: the copy seeds from the pack and
    solves LineStep(20) at N = 100 and the two-variable graph at N = 50,000
    on the card at the bars of phases 3 and 4; the three libraries the
    solves need (the row-logsumexp and column-draw kernels, the ordering)
    load from the seeded files (3 hits, 0 misses, no compiler run) and the
    kernel launches.  B: the same, from empty build directories and a pack
    that holds only a kernel entry carrying another source's digest (file
    and manifest renamed by hand): that entry is seeded and never looked
    up, so both compilers run (0 hits, 3 misses).  Each process's walls run
    from its launch to the end of each first solve; A's against B's is
    what the pack saves a fresh process."""
    from incrementalinference_torch import native, warmstart
    from incrementalinference_torch.ops.kernels import pair_draw

    t_phase = time.time()
    here = os.path.dirname(os.path.abspath(it.__file__))
    pack = os.path.join(here, "aotcache", warmstart._PACKS["cuda"])
    built = [K.LIBRARY.path(), pair_draw.LIBRARY.path(),
             native.LIBRARY.path()]
    for path in built:
        check(os.path.exists(path), f"phase 1 left no {path}")
    warmstart.write_pack(pack, built)
    root = tempfile.mkdtemp(prefix="iitpu-warmstart-")
    try:
        pkg = os.path.join(root, "incrementalinference_torch")
        shutil.copytree(here, pkg, ignore=shutil.ignore_patterns(
            "build", "__pycache__"))
        builds = [os.path.join(pkg, "native", "build"),
                  os.path.join(pkg, "ops", "kernels", "build")]
        check(not any(map(os.path.exists, builds)),
              "the copied package holds a build directory")
        a = _warm_child(root)
        check(a["report"] == {"copied": 3, "present": 0,
                              "pack_entries": 3, "version_match": True},
              f"warm start: seed report {a['report']}")
        check(a["counts"] == {"hits": 3, "misses": 0},
              f"warm start: loads {a['counts']} (want 3 hits, no miss)")
        check(a["build_seconds"] == [None, None, None],
              f"warm start: a compiler ran: {a['build_seconds']}")

        for d in builds:
            shutil.rmtree(d, ignore_errors=True)
        other = _mismatch_pack(
            os.path.join(pkg, "aotcache", warmstart._PACKS["cuda"]),
            K.LIBRARY, (pair_draw.LIBRARY, native.LIBRARY), root)
        b = _warm_child(root)
        name = os.path.basename(built[0])
        check(b["report"]["copied"] == 1 and other in b["kernel_dir"],
              f"mismatched pack not seeded: {b['report']}, "
              f"{b['kernel_dir']}")
        check(os.path.basename(b["kernel_path"]) == name,
              f"the kernel loaded from {b['kernel_path']}, not {name}")
        check(b["counts"] == {"hits": 0, "misses": 3}
              and None not in b["build_seconds"],
              f"unseeded: loads {b['counts']}, compiler seconds "
              f"{b['build_seconds']} (want both compilers to run)")
        walls = [(label, a[key], b[key]) for label, key in (
            ("imported and seeded", "ready_s"),
            ("CUDA context", "context_s"),
            ("LineStep(20) N=100 built", "linestep_graph_s"),
            ("solved", "linestep_s"),
            ("two-variable N=50000 built", "two_var_graph_s"),
            ("solved", "two_var_s"))]
        print(f"PASS warm start: two fresh processes, from launch (s), "
              f"seeded (3 hits, 0 misses, no compiler) | unseeded (0 hits, "
              f"3 misses: nvcc {b['build_seconds'][0]:.3f} and "
              f"{b['build_seconds'][1]:.3f} s, g++ "
              f"{b['build_seconds'][2]:.3f} s): "
              + ", ".join(f"{w} {x:.3f} | {y:.3f}" for w, x, y in walls)
              + f"; launches {a['launches']} | {b['launches']}; the pack "
              f"saved {b['two_var_s'] - a['two_var_s']:.3f} s to the end "
              f"of the first N=50k solve", flush=True)
        print(f"PASS warm start, mismatched kernel entry ({other}): seeded, "
              f"never looked up; the unseeded process built and loaded "
              f"{name}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    dt = time.time() - t_phase
    check(dt < 90, f"phase_warmstart took {dt:.1f} s (budget 90 s)")
    print(f"# phase_warmstart: {dt:.1f} s", flush=True)
    return a, b


def _condense_index_add(mu, prec, k, iters):
    """condense_mixture as the port wrote it before its cluster sums became
    one-hot products: scatter-adds by ``index_add_``, which add with
    atomics on CUDA.  Timed and run here only, for contrast."""
    n = mu.shape[0]
    lam = prec[0]
    x = mu * (lam > 0).to(mu.dtype)
    stride = max(1, n // k)
    c = x[::stride][:k]
    if c.shape[0] < k:
        c = torch.cat([c, x[:k - c.shape[0]]], dim=0)
    x2 = torch.sum(x * x, 1)

    def assign(c):
        d2 = x2[:, None] - 2.0 * (x @ c.T) + torch.sum(c * c, 1)[None, :]
        return torch.argmin(d2, dim=1)

    def stats(lab, v):
        out = torch.zeros((k, v.shape[1]), dtype=v.dtype, device=v.device)
        return out.index_add_(0, lab, v)

    ones = torch.ones((n, 1), dtype=mu.dtype, device=mu.device)
    for _ in range(iters):
        lab = assign(c)
        cnt = stats(lab, ones)
        c = torch.where(cnt > 0, stats(lab, x) / torch.clamp(cnt, min=1.0),
                        c)
    lab = assign(c)
    cnt = stats(lab, ones)
    mean = stats(lab, mu) / torch.clamp(cnt, min=1.0)
    var = torch.clamp(stats(lab, mu * mu) / torch.clamp(cnt, min=1.0)
                      - mean * mean, min=0.0)
    prec_c = torch.where(lam[None, :] > 0,
                         1.0 / (1.0 / torch.clamp(lam[None, :], min=1e-30)
                                + var), torch.zeros_like(var))
    cnt = cnt[:, 0]
    logw = torch.where(cnt > 0, torch.log(torch.clamp(cnt, min=1.0)),
                       torch.full_like(cnt, -1e30))
    return mean, prec_c, logw


def phase_condense(it, K, dev):
    """condense_mixture on the card: 50 runs of one input bit-equal at
    N = 20,000, dof 1 and dof 3, k = 256 (the cluster sums are one-hot
    matrix products), timed beside the index_add_ form it replaced, whose
    distinct results in 50 runs are counted.  Then the two-variable graph
    at N = 4,096, whose product stages take the condensed path (Nb >= 768
    and 2^24 pairs < 2^30), at phase 4's bars with its condense calls
    counted."""
    from incrementalinference_torch.ops import product

    gen = torch.Generator(device=dev).manual_seed(11)
    iters = product._CONDENSE_ITERS
    for dof in (1, 3):
        mu = torch.randn((20_000, dof), generator=gen, device=dev) * 3
        prec = torch.full((20_000, dof), 4.0, device=dev)
        ref = product.condense_mixture(mu, prec, 0, k=256)
        same = sum(all(torch.equal(a, b) for a, b in zip(
            product.condense_mixture(mu, prec, 0, k=256), ref))
            for _ in range(50))
        check(same == 50, f"condense_mixture dof {dof}: {50 - same} of 50 "
              f"runs differ from the first")
        old = {b"".join(t.cpu().numpy().tobytes() for t in
                        _condense_index_add(mu, prec, 256, iters))
               for _ in range(50)}
        ms = cuda_ms(lambda: product.condense_mixture(mu, prec, 0, k=256),
                     20)
        old_ms = cuda_ms(lambda: _condense_index_add(mu, prec, 256, iters),
                         20)
        print(f"PASS condense_mixture N=20000 dof {dof} k=256 on {dev}: 50 "
              f"runs bit-equal, {ms:.3f} ms (median); the index_add_ form "
              f"on the same input {old_ms:.3f} ms, {len(old)} distinct "
              f"results in 50", flush=True)
    N = 4096
    check(N >= product.CONDENSE_MIN_NB
          and N * N < product.LARGE_PAIR_THRESHOLD,
          "the condense fixture no longer takes the condensed path")
    with _Counting(product, "condense_mixture") as c:
        fg = _two_var_graph(it, N, device=dev)
        K.reset_counts()
        _sync(dev)
        t0 = time.time()
        it.solve_tree(fg)
        _sync(dev)
        wall = time.time() - t0
    check(c.calls > 0, f"the N={N} solve never condensed")
    stats = _check_two_var(fg, f"condense path N={N}")
    print(f"PASS two-variable N={N} through the condensed product: "
          f"{wall:.3f} s, {c.calls} condense calls, {K.counts['launches']} "
          f"kernel launches; posteriors (mean, std) {stats}", flush=True)


def _mode_mass(fg, v, center, tol=20.0):
    return float(((fg.points(v)[:, 0] - center).abs() < tol).float().mean())


def _check_fourdoor(fg, step):
    """The bars of tests/test_solve.py:23-39 after solve ``step``."""
    if step == 1:
        for c in (-100, 0, 100, 300):
            check(_mode_mass(fg, "x1", c) > 0.08, f"step 1: door {c} lost")
    elif step == 2:
        m = {(v, c): _mode_mass(fg, v, c)
             for v, c in (("x1", -100), ("x1", 0), ("x1", 300), ("x3", 0),
                          ("x3", 100))}
        check(m["x1", -100] + m["x1", 0] > 0.8, f"step 2: x1 {m}")
        check(m["x1", 300] < 0.1, f"step 2: x1 at 300 {m}")
        check(m["x3", 0] + m["x3", 100] > 0.8, f"step 2: x3 {m}")
    else:
        for v, c in (("x1", 0.0), ("x2", 50.0), ("x3", 100.0),
                     ("x4", 300.0)):
            mean = float(fg.points(v).mean())
            check(_mode_mass(fg, v, c) >= 0.8, f"step 3: {v} mass at {c}")
            check(abs(mean - c) < 10.0, f"step 3: {v} mean {mean}")


_ROOT = os.path.dirname(os.path.abspath(__file__))
_PRECISION_LEAVES = (torch.backends, torch.backends.cuda.matmul,
                     torch.backends.cudnn.conv, torch.backends.cudnn.rnn,
                     torch.backends.mkldnn.matmul, torch.backends.mkldnn.conv,
                     torch.backends.mkldnn.rnn)


def _precision():
    """Every per-backend float32 precision setting (the new API only)."""
    return tuple(m.fp32_precision for m in _PRECISION_LEAVES)


def _restore_precision(saved):
    torch.set_float32_matmul_precision("highest")
    for m, v in zip(_PRECISION_LEAVES, saved):
        m.fp32_precision = v
    check(_precision() == saved, "the precision settings were not restored")


def _tf32_gap(f, pinned, args):
    """max |TF32 - IEEE| of f(*args) under a caller's "high" (f is a
    function outside the pin), and whether the pinned function under that
    "high" gives the default setting's result bit for bit."""
    ieee = f(*args)
    torch.set_float32_matmul_precision("high")
    try:
        tf32, held = f(*args), pinned(*args)
    finally:
        torch.set_float32_matmul_precision("highest")
    return float((tf32 - ieee).abs().max()), torch.equal(held, ieee)


def phase_precision(it, K):
    """Full float32 precision on the port's own terms (config.full_precision
    pins each entry point's span): the two-variable graph at N = 4,096 (its
    product stages condense) and at N = 50,000 (its products run the
    row-logsumexp and column-draw kernels, no matmul) solved twice at the
    default setting and once with a caller's
    torch.set_float32_matmul_precision("high") set before the graph is
    built; each call of _pair_logW and condense_mixture asserts that matmul
    precision reads "ieee" where it is called, the three posteriors
    bit-equal, and the caller's setting back after the solve.  Then the
    size of the fault this closes, outside the pin: max |TF32 - IEEE| of
    _pair_logW on the first 2,048 rows of each large pair product of the
    N = 50,000 solve (products with K = dof = 1; the eager column draw
    took such blocks before the draw kernel) and of condense_mixture on
    the N = 4,096 solve's (one-hot sums), and of _pair_logW at dof 2, 3, 6
    and 8 on 4,096 x 4,096 inputs (K = dof), where the pinned call under
    "high" must equal the IEEE result bit for bit."""
    from incrementalinference_torch.ops import product

    dev, small, large = "cuda", 4096, 50_000
    default = _precision()
    calls, condensed, seen = [], [], []
    keep = {"N": None}                 # whose inputs to keep: the first run's
    orig, orig_condense = product._pair_logW, product.condense_mixture
    orig_large = product.pair_product_tangent_large

    def recorded(*a):
        seen.append(torch.backends.cuda.matmul.fp32_precision)
        return orig(*a)

    def recorded_large(muA, precA, muB, precB, key, n_out):
        if keep["N"] == large:
            calls.append((muA[..., :2048, :], precA[..., :2048, :], muB,
                          precB))
        return orig_large(muA, precA, muB, precB, key, n_out)

    def recorded_condense(*a, **k):
        seen.append(torch.backends.cuda.matmul.fp32_precision)
        if keep["N"] == small:
            condensed.append((a, k))
        return orig_condense(*a, **k)

    for N in (small, large):
        posts, walls = [], []
        for run in ("default", "default", "high"):
            if run == "high":
                torch.set_float32_matmul_precision("high")
                caller = _precision()
            fg = _two_var_graph(it, N, device=dev)
            seen.clear()
            keep["N"] = N if not posts else None
            product._pair_logW = recorded
            product.condense_mixture = recorded_condense
            product.pair_product_tangent_large = recorded_large
            try:
                _sync(dev)
                t0 = time.time()
                it.solve_tree(fg)
                _sync(dev)
                walls.append(time.time() - t0)
            finally:
                product._pair_logW = orig
                product.condense_mixture = orig_condense
                product.pair_product_tangent_large = orig_large
            check((seen or N == large) and set(seen) <= {"ieee"},
                  f"N={N} {run}: matmul precision where the products run "
                  f"{sorted(set(seen))} ({len(seen)} calls), not 'ieee'")
            if run == "high":
                check(_precision() == caller
                      and torch.backends.cuda.matmul.fp32_precision == "tf32"
                      and torch.get_float32_matmul_precision() == "high",
                      f"N={N}: the caller's 'high' was not given back: "
                      f"{_precision()}")
                _restore_precision(default)
            _check_two_var(fg, f"precision N={N} {run}")
            posts.append({v: fg.points(v).clone() for v in fg.ls()})
        for other in posts[1:]:
            for v, p in posts[0].items():
                check(torch.equal(p, other[v]),
                      f"N={N}: {v}'s posterior differs between the "
                      f"default and the 'high' solves")
        print(f"PASS precision pin N={N} on {dev}: two default solves and "
              f"one under the caller's 'high' bit-equal, every product "
              f"call ({len(seen)} in the last) in 'ieee', 'high' given back "
              f"after the solve; walls {[round(w, 3) for w in walls]} s",
              flush=True)

    check(calls, f"the N={large} solve took no large pair product")
    check(condensed, f"the N={small} solve never condensed")
    raw = product._pair_logW.__wrapped__       # outside the pin
    raw_condense = product.condense_mixture.__wrapped__
    gap, scale = 0.0, 0.0
    cgap = [0.0, 0.0, 0.0]                     # means, precisions, log w
    torch.set_float32_matmul_precision("high")
    try:
        for a in calls:
            tf32 = raw(*a)
            ieee = product._pair_logW(*a)
            gap = max(gap, float((tf32 - ieee).abs().max()))
            scale = max(scale, float(ieee.abs().max()))
            del tf32, ieee
        for a, k in condensed:
            for i, (x, y) in enumerate(zip(raw_condense(*a, **k),
                                           product.condense_mixture(*a,
                                                                    **k))):
                rel = ((x - y).abs() / y.abs().clamp(min=1e-30)).max()
                cgap[i] = max(cgap[i], float(rel))
    finally:
        _restore_precision(default)
    print(f"PASS the fault closed: max |TF32 - IEEE| of _pair_logW over the "
          f"first rows of the {len(calls)} large pair products of the "
          f"N={large} solve ({tuple(calls[0][0].shape)}"
          f" x {tuple(calls[0][2].shape)} each) = {gap:.6g}, against "
          f"max |logW| {scale:.6g}; of condense_mixture over the "
          f"{len(condensed)} calls of the N={small} solve, max relative "
          f"|TF32 - IEEE| of the cluster means {cgap[0]:.6g}, precisions "
          f"{cgap[1]:.6g}, log weights {cgap[2]:.6g}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(12)
    gaps = {}
    for dof in (2, 3, 6, 8):
        muA, muB = (torch.randn((small, dof), generator=gen, device=dev) * 3
                    + 10 for _ in range(2))
        precA = torch.full((small, dof), 156.0, device=dev)
        precB = torch.full((small, dof), 156.0, device=dev)
        args = (muA, precA, muB, precB)
        gaps[dof], held = _tf32_gap(raw, product._pair_logW, args)
        check(held, f"_pair_logW dof {dof}: the pinned call under 'high' "
                    f"differs from the IEEE result")
        _restore_precision(default)
    print(f"PASS _pair_logW at dof 2, 3, 6, 8 on {small} x {small} inputs "
          f"(x ~ 10 +- 3, precision 156): the pinned call under 'high' "
          f"bit-equal to IEEE; max |TF32 - IEEE| outside the pin by dof "
          f"{ {d: float(f'{g:.6g}') for d, g in gaps.items()} }", flush=True)
    return gap, cgap, gaps


def _concurrently(*fns):
    """Each of ``fns`` on its own thread, all released by one barrier (30 s
    timeout); their results in order.  A thread's exception is raised here
    and breaks the barrier, so no thread waits for one that failed; a thread
    still running 120 s after the start fails the phase."""
    import threading

    barrier = threading.Barrier(len(fns), timeout=30)
    out, errors = [None] * len(fns), []

    def run(i, fn):
        try:
            barrier.wait()
            out[i] = fn()
        except BaseException as e:             # noqa: BLE001 - re-raised
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for th in threads:
        th.start()
    deadline = time.time() + 120.0
    for th in threads:
        th.join(max(0.0, deadline - time.time()))
    check(not any(th.is_alive() for th in threads),
          "a thread still ran after 120 s")
    if errors:
        raise errors[0]
    return out


def _on_stream(stream, fn):
    """fn() under ``stream`` (the thread's current stream) when one is
    given, waiting for the stream's work before returning."""
    if stream is None:
        return fn()
    with torch.cuda.stream(stream):
        out = fn()
    stream.synchronize()
    return out


def phase_threads(it, K):
    """Concurrent solves in one process, one graph per thread (budget 45 s).
    (a) two threads each build and solve the two-variable graph at
    N = 50,000 (seeds 1 and 2) on the default stream, released by one
    barrier, beside a third thread running a user's own
    ``vmap(jacfwd(f))`` loop on a CUDA tensor (d): the launches are the two alone solves' (12 + 12), each
    thread's posteriors are bit-equal to its graph solved alone before the
    threads start, each thread's first row log-partitions agree with the
    plain version (<= 1e-5), and every user Jacobian equals its one-thread
    value; (b) the same two solves, each thread under its own
    ``torch.cuda.Stream``, at the bars of benchmarks/pallas_e2e_solve.py,
    with the largest difference from the alone solve printed (cuBLAS
    documents that results may differ across streams unless its workspace
    is pinned); (c) the reverse-mode Jacobian paths: the two-pose SE(2)
    graph at N = 4,096 on one thread while the parametric LineStep(1000)
    dense solve runs on the other, each at its bars and bit-equal to its
    solve alone.  Returns the launches of (a) and (b) by path."""
    import threading

    from torch.func import jacfwd, vmap

    from incrementalinference_torch.canonical import generate_line_step
    from incrementalinference_torch.manifolds import SE2
    from incrementalinference_torch.ops import product

    N = 50_000
    t_phase = time.time()
    wrapper = product.pair_row_logsumexp
    stages = {}             # thread -> (inputs, output) of its first call

    def recording(*args):
        out = wrapper(*args)
        tid = threading.get_ident()
        if tid not in stages:
            stages[tid] = ([a.clone() for a in args], out.clone())
        return out

    def two_var(seed, stream=None):
        def solve():
            fg = _two_var_graph(it, N, seed=seed)
            it.solve_tree(fg)
            return fg
        return _on_stream(stream, solve)

    def points(fg):
        return [fg.points(v).clone() for v in ("x0", "x1")]

    def stage_errors():
        errs = []
        for args, out in stages.values():
            a2, iva, ivm = K.pair_row_terms(*args)
            ref = K.row_logsumexp_plain(a2, iva, ivm, args[2])
            errs.append(rel_err(out, ref))
        return errs

    seeds = (1, 2)
    alone, alone_launches = [], []
    for seed in seeds:                          # one after the other
        K.reset_counts()
        alone.append(points(two_var(seed)))
        alone_launches.append(K.counts["launches"])

    # (a) and (d)
    def user_f(x):
        return torch.stack([torch.sin(x[0]) * x[1], x[0] * x[0] - x[1]])

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    xu = torch.randn((1000, 2), generator=gen, device="cuda")
    user_jac = vmap(jacfwd(user_f))
    user_want = user_jac(xu)
    solving, solving_lock = [len(seeds)], threading.Lock()

    def solver(seed, stream=None):
        def run():
            try:
                return points(two_var(seed, stream))
            finally:
                with solving_lock:
                    solving[0] -= 1
        return run

    def user():
        wrong = calls = 0
        while solving[0] > 0 or calls < 20:
            wrong += not torch.equal(user_jac(xu), user_want)
            calls += 1
        return wrong, calls

    product.pair_row_logsumexp = recording
    try:
        K.reset_counts()
        t0 = time.time()
        (wrong, calls), *got = _concurrently(
            user, *(solver(s) for s in seeds))
        torch.cuda.synchronize()
        wall_a = time.time() - t0
        launches_a = K.counts["launches"]
        errs_a = stage_errors()

        streams = [torch.cuda.Stream() for _ in seeds]
        stages.clear()
        K.reset_counts()
        t0 = time.time()
        graphs = _concurrently(*(lambda s=s, st=st: two_var(s, st)
                                 for s, st in zip(seeds, streams)))
        torch.cuda.synchronize()
        wall_b = time.time() - t0
        launches_b = K.counts["launches"]
        errs_b = stage_errors()
    finally:
        product.pair_row_logsumexp = wrapper

    check(launches_a == sum(alone_launches),
          f"(a) launched {launches_a} times, the solves alone "
          f"{alone_launches}")
    for seed, g, w in zip(seeds, got, alone):
        check(all(torch.equal(a, b) for a, b in zip(g, w)),
              f"(a) seed {seed}: the posteriors differ from the solve alone")
    check(len(errs_a) == len(seeds) and max(errs_a) <= _TOL,
          f"(a) kernel vs plain on each thread's first stage: {errs_a}")
    check(wrong == 0, f"(d) {wrong} of {calls} user Jacobians changed")
    print(f"PASS threads (a): two threads each built and solved the "
          f"two-variable graph at N={N} on the default stream at once, "
          f"{wall_a:.3f} s (alone, one after the other, before); launches "
          f"{launches_a} = {alone_launches}; posteriors bit-equal to the "
          f"solves alone; each thread's first row log-partitions against "
          f"the plain version: rel err {[f'{e:.3e}' for e in errs_a]}; (d) "
          f"a user's vmap(jacfwd) on a third thread: {calls} calls, all "
          f"equal to the one-thread value", flush=True)

    diff = 0.0
    for seed, fg, w in zip(seeds, graphs, alone):
        _check_two_var(fg, f"(b) seed {seed}")
        diff = max(diff, max(float((a - b).abs().max())
                             for a, b in zip(points(fg), w)))
    check(len(errs_b) == len(seeds) and max(errs_b) <= _TOL,
          f"(b) kernel vs plain on each thread's first stage: {errs_b}")
    print(f"PASS threads (b): the same two solves, each thread on its own "
          f"CUDA stream, {wall_b:.3f} s, at the bars of "
          f"benchmarks/pallas_e2e_solve.py; launches {launches_b}; largest "
          f"difference from the solves alone {diff:.3e}; kernel vs plain "
          f"{[f'{e:.3e}' for e in errs_b]}", flush=True)

    # (c) the reverse-mode Jacobian paths on two threads at once
    M = SE2()

    def se2():
        fg, truth = _two_pose_graph(it, M, "Pose2", _SE2_STEP, _SE2_SIGMA,
                                    4096)
        it.solve_tree(fg)
        torch.cuda.synchronize()
        return fg, truth

    def param():
        fg = generate_line_step(1000, graphinit=False, device="cuda")
        it.solve_graph_parametric(fg)
        torch.cuda.synchronize()
        return fg

    def se2_state(fg):
        return [fg.points(v).clone() for v in ("x0", "x1")]

    def param_state(fg):
        return [_param_points(fg),
                torch.stack([fg.var(v).parametric_cov for v in fg.ls()])]

    t0 = time.time()
    se2_alone = se2_state(se2()[0])
    t_se2 = time.time() - t0
    t0 = time.time()
    param_alone = param_state(param())
    t_param = time.time() - t0
    t0 = time.time()
    (fg_se2, truth), fg_param = _concurrently(se2, param)
    wall_c = time.time() - t0
    stats = _check_two_pose(fg_se2, M, "(c) Pose2", truth, _SE2_SIGMA)
    line = _param_points(fg_param)[:, 0]
    worst = float((line - _line_truth(fg_param, "cuda")).abs().max())
    covs = param_state(fg_param)[1][:, 0, 0]
    check(worst < 1e-2, f"(c) LineStep(1000) parametric: max |x_i - i| "
                        f"{worst}")
    check(bool(torch.isfinite(covs).all() and (covs > 0).all()),
          "(c) LineStep(1000) parametric: a covariance not finite and > 0")
    for what, got_c, want_c in (("SE(2)", se2_state(fg_se2), se2_alone),
                                ("parametric", param_state(fg_param),
                                 param_alone)):
        check(all(torch.equal(a, b) for a, b in zip(got_c, want_c)),
              f"(c) {what}: differs from its solve alone")
    dt = time.time() - t_phase
    print(f"PASS threads (c): the two-pose SE(2) graph N=4096 "
          f"(solve_tree, alone {t_se2:.3f} s) and the parametric "
          f"LineStep(1000) dense solve (alone {t_param:.3f} s) on two "
          f"threads at once, {wall_c:.3f} s, each bit-equal to its solve "
          f"alone; SE(2) (dist of the Karcher mean from truth, tangent std "
          f"/ prior std) {stats}; parametric max |x_i - i| {worst:.3e}",
          flush=True)
    check(dt < 45, f"phase_threads took {dt:.1f} s (budget 45 s)")
    print(f"PASS phase_threads: {dt:.1f} s (budget 45 s)", flush=True)
    return {f"threads (a): two two-variable N={N} solves at once, default "
            f"stream": launches_a,
            f"threads (b): the same, each thread on its own stream":
            launches_b}


def _example(name):
    """examples_torch/<name>.py, imported as a module."""
    import importlib.util

    path = os.path.join(_ROOT, "examples_torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _ExampleSolves:
    """Wraps an example module's ``solve_tree`` while entered: the wall of
    each solve, the kernel's launches since the solve before it (the graph
    growth between them included; the counts are set to 0 on entry), the
    recycled cliques, and ``after(fg, k)``, a check after solve k."""

    def __init__(self, mod, K, dev, after=None):
        self.mod, self.K, self.dev, self.after = mod, K, dev, after
        self.walls, self.launches, self.recycled = [], [], []

    def __enter__(self):
        self.orig, self.seen = self.mod.solve_tree, 0
        self.K.reset_counts()
        self.mod.solve_tree = self.solve
        return self

    def solve(self, fg, **kw):
        _sync(self.dev)
        t0 = time.time()
        tree = self.orig(fg, **kw)
        _sync(self.dev)
        self.walls.append(time.time() - t0)
        n = self.K.counts["launches"]
        self.launches.append(n - self.seen)
        self.seen = n
        self.recycled.append(sum(c.is_recycled
                                 for c in tree.cliques.values()))
        if self.after is not None:
            self.after(fg, len(self.walls))
        return tree

    def __exit__(self, *exc):
        self.mod.solve_tree = self.orig


def _fourdoor_script():
    """`python3 examples_torch/fourdoor.py` in a fresh process, run with
    -X importtime to list every module it imports.  Returns its wall, its
    imports and its last line."""
    env = dict(os.environ, PYTHONPATH=_ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime",
         os.path.join("examples_torch", "fourdoor.py")], cwd=_ROOT, env=env,
        capture_output=True, text=True, timeout=180)
    wall = time.time() - t0
    check(proc.returncode == 0, f"examples_torch/fourdoor.py exited "
          f"{proc.returncode}: {proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    imported = [ln.rsplit("|", 1)[-1].strip()
                for ln in proc.stderr.splitlines()
                if ln.startswith("import time:")]
    jaxlike = [m for m in imported
               if m.split(".")[0] in ("jax", "jaxlib", "incrementalinference")]
    check(len(imported) > 100 and not jaxlike and "x4: mean=" in proc.stdout,
          f"examples_torch/fourdoor.py: {len(imported)} imports, JAX's "
          f"{jaxlike[:5]}; output {proc.stdout[-500:]}")
    return wall, len(imported), proc.stdout.strip().splitlines()[-1]


def _beside():
    """The two examples that start processes of their own, run on a thread
    beside the in-process ones: the fourdoor script, then multihost.
    Returns their walls and the thread's span (start, end) on time.time()."""
    t_start, walls = time.time(), {}
    wall, n_imports, last = _fourdoor_script()
    walls["python3 examples_torch/fourdoor.py"] = wall
    print(f"PASS python3 examples_torch/fourdoor.py in a fresh process: "
          f"exit 0 in {wall:.3f} s, {n_imports} modules imported, none of "
          f"JAX or the JAX package; its last line: {last}", flush=True)
    ex = _example("multihost")
    t0 = time.time()
    reps, reps_p = ex.main(device="cuda")
    walls["multihost"] = time.time() - t0
    print(f"PASS examples_torch/multihost.py, two processes on the card: "
          f"{walls['multihost']:.3f} s; warm max errs "
          f"{[r['warm']['max_err'] for r in reps]}, incremental recycled "
          f"{[r['incr']['n_recycled'] for r in reps]} of "
          f"{reps[0]['incr']['n_cliques']}; parametric max errs "
          f"{[r['warm']['max_err'] for r in reps_p]}", flush=True)
    return walls, (t_start, time.time())


def phase_examples(it, K):
    """The six scripts of examples_torch/ on the card (budget 240 s), each
    through its main(), which asserts its bars.  In this process: fourdoor
    at N = 100 and at N = 50,000 (phase_fourdoor: the kernel must launch on
    solves 2 and 3) and range_only (phase_euclid), alone on the card and
    its host; then, with a thread beside them, migrate_from_reference (the
    golden archive solved, saved and loaded back), se2_slam, and
    ode_smoothing with its decay-rate factor at 16 RK4 steps (32 in the
    example; 85 s on the card's host, PERF.md).  The thread runs the two
    that start processes of their own: fourdoor once more as
    `python3 examples_torch/fourdoor.py` (exit code 0, no module of JAX or
    the JAX package imported, read from -X importtime), then multihost (two
    processes on the card).  The walls that overlapped the thread's span
    are printed as such: they shared the card and its host.  Returns the
    fourdoor N = 50,000 launches per solve."""
    from concurrent.futures import ThreadPoolExecutor

    dev, large = "cuda", 50_000
    t_phase = time.time()
    walls, spans = {}, {}

    def timed(name, f):
        t0 = time.time()
        out = f()
        spans[name] = (t0, time.time())
        walls[name] = spans[name][1] - t0
        return out

    timed("fourdoor", lambda: phase_fourdoor(it, K, 100, dev))
    fd_launches = timed(f"fourdoor --n {large}",
                        lambda: phase_fourdoor(it, K, large, dev))
    check(fd_launches[1] > 0 and fd_launches[2] > 0,
          f"the N={large} fourdoor solves never launched the "
          f"row_logsumexp kernel: {fd_launches}")
    timed("range_only", lambda: phase_euclid(it, K, dev))

    with ThreadPoolExecutor(max_workers=1) as pool:
        beside = pool.submit(_beside)
        for name, kw in (("migrate_from_reference", {}), ("se2_slam", {}),
                         ("ode_smoothing", {"nary_steps": 16})):
            ex = _example(name)
            with _ExampleSolves(ex, K, dev) as s:
                timed(name, lambda: ex.main(device=dev, **kw))
            print(f"PASS examples_torch/{name}.py on {dev} at its bars"
                  f"{f' {kw}' if kw else ''}: {walls[name]:.3f} s; solve "
                  f"walls {[round(w, 3) for w in s.walls]} s; kernel "
                  f"launches {s.launches}; recycled cliques {s.recycled}",
                  flush=True)
        walls["in this process"] = time.time() - t_phase
        thread_walls, (a, b) = beside.result()
        walls.update(thread_walls)

    overlapped = [n for n, (t0, t1) in spans.items() if t0 < b and t1 > a]
    dt = time.time() - t_phase
    print(f"# phase_examples: {dt:.1f} s; walls "
          f"{ {k: round(v, 3) for k, v in walls.items()} }; the thread ran "
          f"{a - t_phase:.1f}-{b - t_phase:.1f} s into the phase, beside "
          f"{overlapped} (those walls shared the card and its host)",
          flush=True)
    check(dt < 240, f"phase_examples took {dt:.1f} s (budget 240 s)")
    return fd_launches


def phase_fourdoor(it, K, N, dev):
    """The fourdoor story through examples_torch/fourdoor.py, whose main()
    grows the graph three times and ``solve_tree(fg, old_tree=tree)``s
    after each; its solves are wrapped to assert _check_fourdoor after
    each and to count the kernel's launches of each step (the counts set
    to 0 before the example starts, read after each solve: a step's count
    holds its graph growth).  Returns those launches."""
    ex = _example("fourdoor")
    with _ExampleSolves(ex, K, dev, after=_check_fourdoor) as s:
        fg, tree = ex.main(device=dev, n=N)
    means = {v: round(float(fg.points(v).mean()), 2) for v in fg.ls()}
    print(f"PASS fourdoor N={N} on {dev} (examples_torch/fourdoor.py), "
          f"three solves with old_tree: walls "
          f"{[round(w, 3) for w in s.walls]} s; kernel launches per step "
          f"{s.launches}; recycled cliques per step {s.recycled} of "
          f"{tree.num_cliques()}; final means {means}", flush=True)
    return s.launches


def phase_growing_chain(it, dev, wildfire_tol):
    """tests/test_solve.py:264-286: a prior, then three times six more
    poses and a re-solve that recycles the cliques of the last tree."""
    fg = it.initfg(it.SolverParams(wildfire_tol=wildfire_tol), device=dev)
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 0.5)))
    tree, i, walls, recycled = None, 0, [], []
    for _ in range(3):
        for _ in range(6):
            i += 1
            fg.add_variable(f"x{i}", it.ContinuousScalar)
            fg.add_factor([f"x{i - 1}", f"x{i}"],
                          it.LinearRelative(it.Normal(1.0, 0.1)))
        torch.cuda.synchronize()
        t0 = time.time()
        tree = it.solve_tree(fg, old_tree=tree)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        recycled.append(sum(c.is_recycled for c in tree.cliques.values()))
        for j in range(i + 1):
            m = float(fg.points(f"x{j}").mean())
            check(abs(m - j) < 0.5, f"chain x{j}: mean {m} (tol "
                                    f"{wildfire_tol}, {i} poses)")
    check(0 < recycled[1] < recycled[2], f"recycled counts {recycled}")
    print(f"PASS growing chain N=100, wildfire_tol={wildfire_tol}: walls "
          f"{[round(w, 3) for w in walls]} s; recycled {recycled} of "
          f"{tree.num_cliques()} cliques; wildfire_stats of the last solve "
          f"{tree.wildfire_stats} (stat_syncs = device-to-host reads)",
          flush=True)


def phase_euclid(it, K, dev):
    """The range-only landmark graph through examples_torch/range_only.py:
    two rings of radius 100 around (100, 0) and (0, 100) meet at (0, 0)
    and (100, 100); then a third range from (100, 100) leaves (0, 0).  The
    bars of tests/test_solve.py:181-193 after the first solve (asserted by
    the example and again here), the example's own after the second."""
    ex = _example("range_only")

    def after(fg, k):
        if k == 1:
            _check_rings(fg)

    with _ExampleSolves(ex, K, dev, after=after) as s:
        _, out = ex.main(device=dev)
    a, b = out["shares_30m"]
    print(f"PASS range-only graph N=100 on {dev} "
          f"(examples_torch/range_only.py): walls "
          f"{[round(w, 3) for w in s.walls]} s; two ranges: mode shares "
          f"{a:.2f} at (0,0), {b:.2f} at (100,100), on the rings "
          f"{out['rings'][0]:.2f}, {out['rings'][1]:.2f}; three ranges: "
          f"{out['three']}", flush=True)
    return s.walls


def _check_rings(fg):
    pts = fg.points("l1")

    def near(x, y, r):
        return float(((pts - torch.tensor([x, y], device=pts.device))
                      .norm(dim=1) < r).float().mean())

    def on_ring(x, y):
        d = (pts - torch.tensor([x, y], device=pts.device)).norm(dim=1)
        return float(((d - 100.0).abs() < 15).float().mean())

    a, b = near(0.0, 0.0, 30), near(100.0, 100.0, 30)
    r1, r2 = on_ring(100.0, 0.0), on_ring(0.0, 100.0)
    check(a > 0.04 and b > 0.04 and a + b > 0.6, f"ring modes {a}, {b}")
    check(r1 > 0.85 and r2 > 0.85, f"on the rings {r1}, {r2}")


def phase_hexagonal(it):
    """The SE(2) hexagon with its landmark loop closure at N = 100, solved
    once (cold and warm took 33-54 s each; cut for the script's time,
    PERF.md).  The Karcher means of x1, x3 and x6 within 1.5 (SE(2)
    dist) of the ideal hexagon, composed from the noiseless step, and of
    the port's parametric optimum of the same graph (the JAX package's
    test and bar).  Returns (wall, the solved graph, its tree)."""
    se2 = it.SE2()
    step = torch.tensor(_SE2_STEP, device="cuda")
    ideal, p = {}, se2.identity("cuda")
    for i in range(1, 7):
        p = se2.exp(p, step)
        ideal[f"x{i}"] = p
    t_build = time.time()
    fg = it.generate_hexagonal(graphinit=True, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    tree = it.solve_tree(fg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    dists = {}
    for v in ("x1", "x3", "x6"):
        mu = se2.mean(fg.points(v))
        dists[v] = float(se2.dist(mu, ideal[v]))
        check(dists[v] < 1.5, f"hexagonal {v}: {dists[v]} from the ideal "
                              f"pose (bar 1.5)")
    fp = it.generate_hexagonal(graphinit=False, device="cuda")
    torch.cuda.synchronize()
    t_p = time.time()
    it.solve_graph_parametric(fp)
    torch.cuda.synchronize()
    t_p = time.time() - t_p
    to_opt = {}
    for v in ("x1", "x3", "x6"):
        to_opt[v] = float(se2.dist(se2.mean(fg.points(v)),
                                   fp.var(v).parametric_point))
        check(to_opt[v] < 1.5, f"hexagonal {v}: {to_opt[v]} from the "
                               f"parametric optimum (bar 1.5)")
    print(f"PASS hexagonal N=100 solve_tree on CUDA: {wall:.3f} s (graph "
          f"build with graphinit "
          f"{t0 - t_build:.3f} s); SE(2) dist of the Karcher means from the "
          f"ideal hexagon { {k: round(v, 3) for k, v in dists.items()} }, "
          f"from the port's parametric optimum "
          f"{ {k: round(v, 3) for k, v in to_opt.items()} } (its "
          f"solve_graph_parametric from the identity {t_p:.3f} s)",
          flush=True)
    return wall, fg, tree


def phase_circular(it):
    """tests/test_manifold_solves.py:14-33: five steps of 2 pi / 5 around
    the circle; estimates wrap instead of running past pi."""
    fg = it.initfg(device="cuda")
    fg.add_variable("c0", it.Circular)
    fg.add_factor(["c0"], it.PriorCircular(it.Normal(0.0, 0.05)))
    step = 2.0 * math.pi / 5.0
    for i in range(1, 6):
        fg.add_variable(f"c{i}", it.Circular)
        fg.add_factor([f"c{i - 1}", f"c{i}"],
                      it.CircularCircular(it.Normal(step, 0.05)))
    torch.cuda.synchronize()
    t0 = time.time()
    it.solve_tree(fg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    shares = []
    for i in range(6):
        d = it.manifolds.wrap_angle(fg.points(f"c{i}")[:, 0] - i * step)
        shares.append(float((d.abs() < 0.5).float().mean()))
        check(shares[-1] > 0.85, f"circular c{i}: {shares[-1]} within 0.5")
    print(f"PASS circular chain N=100 on CUDA: {wall:.3f} s; share within "
          f"0.5 rad of i * 2 pi / 5 (wrapped): {shares}", flush=True)


def _two_pose_graph(it, M, name, step, sigma, N):
    """_two_var_graph on a group manifold: a ManifoldPrior on each pose and
    a ManifoldFactor between them, so every variable has two proposals."""
    vt = it.VariableType(name, M)
    fg = it.initfg(it.SolverParams(N=N, batch_cliques=False), device="cuda")
    ident = M.identity()
    x1 = M.exp(ident, torch.tensor(step))
    noise = it.MvNormal([0.0] * M.dof, sigma)
    fg.add_variable("x0", vt)
    fg.add_factor(["x0"], it.ManifoldPrior(M, ident, noise))
    fg.add_variable("x1", vt)
    fg.add_factor(["x0", "x1"], it.ManifoldFactor(M, it.MvNormal(step,
                                                                sigma)))
    fg.add_factor(["x1"], it.ManifoldPrior(M, x1, noise))
    return fg, {"x0": ident.cuda(), "x1": x1.cuda()}


def _one_member(*ts):
    """The product hands the wrapper a leading member axis; a solve of one
    clique hands a batch of one, recorded without that axis (a larger
    batch keeps it and fails the shape checks that read this)."""
    return [t[0] if t.dim() == 3 and t.shape[0] == 1 else t for t in ts]


def _check_two_pose(fg, M, name, truth, sigma):
    """The two-pose graph's bars: each pose's Karcher mean within 0.2 of
    truth, its tangent std within (0.2, 1.5) x the prior's."""
    stats = {}
    for v, want in truth.items():
        pts = fg.points(v)
        check(bool(torch.isfinite(pts).all()), f"{name} {v}: "
              "non-finite particles")
        mu = M.mean(pts)
        ratio = (M.log(mu[None, :], pts).std(0)
                 / torch.tensor(sigma, device="cuda"))
        stats[v] = (round(float(M.dist(mu, want)), 4),
                    [round(float(r), 3) for r in ratio])
        check(stats[v][0] < 0.2, f"{name} {v}: Karcher mean "
                                 f"{stats[v][0]} from truth")
        check(0.2 < min(stats[v][1]) and max(stats[v][1]) < 1.5,
              f"{name} {v}: tangent std / prior std {stats[v][1]}")
    return stats


def phase_manifold_large(it, K, M, name, step, sigma, N):
    """The two-pose graph at a size where every product is a large pair
    product at dof 3 (SE(2)) or 6 (SE(3)).  Returns (walls, launches of the
    warm solve, the last inputs the solve handed the kernel's wrapper, the
    warm solve's graph and its truth)."""
    from incrementalinference_torch.ops import product

    check(N * N >= product.LARGE_PAIR_THRESHOLD,
          f"{name}: N={N} no longer exceeds the large-pair threshold")
    handed = []
    wrapper = product.pair_row_logsumexp

    def recording(muA, precA, muB, precB):
        handed[:] = _one_member(muA, precA, muB, precB)
        return wrapper(muA, precA, muB, precB)

    walls, launches = [], []
    product.pair_row_logsumexp = recording
    try:
        for _ in range(2):
            K.reset_counts()
            fg, truth = _two_pose_graph(it, M, name, step, sigma, N)
            torch.cuda.synchronize()
            t0 = time.time()
            it.solve_tree(fg)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            launches.append(K.counts["launches"])
            check(launches[-1] > 0, f"the {name} N={N} solve never launched "
                                    f"the row_logsumexp kernel")
            stats = _check_two_pose(fg, M, name, truth, sigma)
    finally:
        product.pair_row_logsumexp = wrapper
    check(handed and handed[0].shape == (N, M.dof),
          f"{name}: the kernel was not handed ({N}, {M.dof}) inputs")
    print(f"PASS {name} two-pose graph N={N} (dof {M.dof}) solve_tree on "
          f"CUDA through the kernel: cold {walls[0]:.3f} s, warm "
          f"{walls[1]:.3f} s; launches per solve {launches}; (dist of the "
          f"Karcher mean from truth, tangent std / prior std) {stats}",
          flush=True)
    return walls, launches[-1], [t.clone() for t in handed], (fg, truth)


def _kde_whole(M, pts, bw):
    """beliefs.kde_logpdf at the particles themselves in one pass, the
    reference for its chunks: (N, N, dof) tangents at once (in float64
    where the inputs are)."""
    X = M.log(pts[None, :, :], pts[:, None, :])
    z = X / bw
    logk = -0.5 * torch.sum(z * z, dim=-1)
    lognorm = (torch.sum(torch.log(bw))
               + 0.5 * bw.shape[-1] * math.log(2.0 * math.pi))
    return (torch.logsumexp(logk, dim=-1) - math.log(float(pts.shape[0]))
            - lognorm)


def _kde_chunked(M, pts, bw):
    """beliefs.kde_logpdf's eager route at the particles themselves, the
    chunks that every manifold without the kernel reads by."""
    from incrementalinference_torch import beliefs

    lognorm = (torch.sum(torch.log(bw))
               + 0.5 * bw.shape[-1] * math.log(2.0 * math.pi))
    return (beliefs._kde_lse_chunked(M, pts, bw, pts, ())
            - math.log(float(pts.shape[0])) - lognorm)


def _tie_gap(est, pts, lp):
    """How far ``est`` lies from the average of the particles whose
    log-density ``lp`` is the maximum, relative to max(1, |average|)
    (several tied particles may be summed in another order); and the
    mask of those particles."""
    sel = lp == lp.max()
    tie = pts[sel].mean(0)
    return float((est - tie).abs().max() / tie.abs().max().clamp(min=1.0)), \
        sel


def phase_ppe(it, solved):
    """Posterior estimates at the sizes the port solves (budget 60 s).

    ``solved``: [(M, name, N, fg, truth)], the warm graphs of
    phase_manifold_large (SE(2) N=50,000, SE(3) N=33,000), not solved
    again.  Every variable's unread ``ppe["default"]`` is read once, its
    peak device memory above what was held before (under
    ``beliefs._KDE_CHUNK_PAIRS`` x ``beliefs._KDE_BYTES_PER_PAIR``) and its
    wall printed; every estimate finite, ``mean`` bit-equal to
    ``M.mean(points)``, ``max`` and ``suggested`` the tie average of the
    particles of highest KDE log-density (``kde_logpdf``, 1e-6), ``mean``
    within 0.2 of truth.  Then, for each graph, the chunked ``kde_logpdf``
    and ``_ppe_core`` against the one-pass form on the first particles of
    x1 (LOO bandwidth), SE(2) at 8,192 (2,048 rows a chunk, 4
    chunks) and SE(3) at 5,000 (2 chunks; the one pass ~5 GB): each row's
    log-density within 1e-6, ``mean`` bit-equal, the same chosen
    particles.  Where ``kde_logpdf`` reads by the kernel (SE(2), SE(3)), the
    chunks are its eager route called directly, and the kernel is held
    to the one-pass form in float64: each row within 2e-5, its chosen
    particle's float64 log-density within 1e-5 of the best."""
    from incrementalinference_torch import beliefs

    n_whole = {"Pose2": 8192, "Pose3": 5000}
    t_all = time.time()
    bar = beliefs._KDE_CHUNK_PAIRS * beliefs._KDE_BYTES_PER_PAIR
    for M, name, N, fg, truth in solved:
        rows = max(1, beliefs._KDE_CHUNK_PAIRS // N)
        for v in fg.ls():
            lazy = fg.var(v).ppe["default"]
            check(isinstance(lazy, beliefs.LazyPPE) and not lazy._done,
                  f"{name} {v}: the estimate was read before phase_ppe")
            b = fg.get_belief(v)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            est = {k: lazy[k] for k in ("mean", "max", "suggested")}
            torch.cuda.synchronize()
            wall = time.time() - t0
            peak = torch.cuda.max_memory_allocated() - held
            check(peak <= bar, f"{name} {v}: one estimate read peaked "
                  f"{peak} B above the graph, over the bar {bar} B")
            check(all(bool(torch.isfinite(x).all()) for x in est.values()),
                  f"{name} {v}: a non-finite estimate")
            check(torch.equal(est["mean"], M.mean(b.points)),
                  f"{name} {v}: mean is not M.mean(points)")
            err, sel = _tie_gap(est["max"], b.points,
                                it.kde_logpdf(M, b, b.points))
            check(err <= 1e-6 and torch.equal(est["max"], est["suggested"]),
                  f"{name} {v}: max is {err} from the tie average of the "
                  f"particles of highest density")
            dist = float(M.dist(est["mean"], truth[v]))
            check(dist < 0.2, f"{name} {v}: mean {dist} from truth")
            print(f"PASS ppe {name} N={N} {v}: one read {wall:.3f} s, peak "
                  f"{peak / 2**20:.1f} MiB above the graph (bar "
                  f"{bar / 2**20:.0f} MiB; {rows} rows a chunk, "
                  f"{-(-N // rows)} chunks); mean {dist:.4f} from truth; "
                  f"{int(sel.sum())} particle(s) at the maximum",
                  flush=True)
        n = n_whole[name]
        pts = fg.get_belief("x1").points[:n].contiguous()
        bw = beliefs.loo_bandwidth(M, pts)
        lp = _kde_chunked(M, pts, bw)
        mu, pmax = beliefs._ppe_core(M, pts, bw)
        kernel = beliefs.kde_lse.takes(M, pts, pts, bw)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lp_whole = _kde_whole(M, pts, bw)
        torch.cuda.synchronize()
        peak_whole = torch.cuda.max_memory_allocated() - held
        err = float((lp - lp_whole).abs().max())
        check(err <= 1e-6, f"{name} N={n}: chunked log-density {err} "
              "from the one-pass form")
        check(torch.equal(mu, M.mean(pts)), f"{name} N={n}: mean")
        check(torch.equal(lp_whole == lp_whole.max(), lp == lp.max()),
              f"{name} N={n}: the chunked and one-pass forms chose "
              "different particles")
        if kernel:
            lp64 = _kde_whole(M, pts.double(), bw.double())
            lpk = it.kde_logpdf(M, beliefs.Belief(pts, bw, bw), pts)
            kerr = float((lpk.double() - lp64).abs().max())
            check(kerr <= 2e-5, f"{name} N={n}: the kernel's log-density "
                  f"{kerr} from the one-pass form in float64")
            gap, _ = _tie_gap(pmax, pts, lpk)
            check(gap <= 1e-6, f"{name} N={n}: max is {gap} from the "
                  "kernel's particle")
            gap = float(lp64.max() - lp64[lpk == lpk.max()].min())
            check(gap <= 1e-5, f"{name} N={n}: the kernel's max lies {gap} "
                  "below the best particle in float64")
            print(f"PASS ppe kernel vs one pass in float64, {name} N={n}: "
                  f"log-density within {kerr:.2e}, the chosen particle "
                  f"{gap:.2e} below the best", flush=True)
            del lp64
        else:
            gap, _ = _tie_gap(pmax, pts, lp_whole)
            check(gap <= 1e-6, f"{name} N={n}: max is {gap} from the "
                  "one-pass form's particle")
        sel = lp == lp.max()
        rows = max(1, beliefs._KDE_CHUNK_PAIRS // n)
        print(f"PASS ppe chunked vs one pass, {name} N={n} ({rows} rows a "
              f"chunk, {-(-n // rows)} chunks): log-density within "
              f"{err:.2e}, mean bit-equal, the same {int(sel.sum())} "
              f"particle(s) chosen; the one-pass form peaked "
              f"{peak_whole / 2**20:.1f} MiB", flush=True)
        del lp_whole
    dt = time.time() - t_all
    check(dt < 60, f"phase_ppe took {dt:.1f} s (budget 60 s)")
    print(f"PASS phase_ppe: {dt:.1f} s (budget 60 s)", flush=True)


def phase_kde_kernel(n=50_000, reps=20, n_se3=33_000):
    """The KDE read's kernel (ops/kernels/kde_lse.py) at n x n on SE(2)
    (the se2pair cell's x1 spread) and Euclidean(1) (two modes), and at
    n_se3 x n_se3 on SE(3) (the se3pair cell's x1 spread): CUDA-event
    times of ``kde_logpdf`` at the particles themselves (kernel) and of its
    eager chunks on the same inputs (plain), medians of three windows, and
    each route's largest gap to the plain route in float64.  Alone:
    ``python3 -c "import chip_smoke as cs; cs.phase_kde_kernel()"``."""
    import incrementalinference_torch as it
    from incrementalinference_torch import beliefs
    from incrementalinference_torch.ops.kernels import kde_lse

    kde_lse.build(verbose=False)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    for name, M in (("SE(2)", it.SE2()), ("Euclidean(1)", it.Euclidean(1)),
                    ("SE(3)", it.SE3())):
        if name == "SE(2)":
            X = torch.randn(n, 3, generator=gen, dtype=torch.float64) \
                * torch.tensor([0.5, 0.5, 0.05], dtype=torch.float64)
            pts = M.exp(torch.tensor([[10.0, 0.0, math.pi / 2]],
                                     dtype=torch.float64), X)
        elif name == "SE(3)":
            X = torch.randn(n_se3, 6, generator=gen, dtype=torch.float64) \
                * torch.tensor([0.5] * 3 + [0.05] * 3, dtype=torch.float64)
            pts = M.exp(M.Exp(torch.tensor(
                [10.0, 0.0, 0.0, 0.0, 0.0, math.pi / 2],
                dtype=torch.float64))[None], X)
        else:
            pts = torch.randn(n, 1, generator=gen, dtype=torch.float64)
            pts[: n // 3] += 6.0
        pts = pts.float().to(dev)
        bw = beliefs.loo_bandwidth(M, pts)
        b = beliefs.Belief(pts, bw, bw)
        walls = {}
        for route, fn, k in (
                ("kernel", lambda: beliefs.kde_logpdf(M, b, pts), reps),
                ("plain", lambda: _kde_chunked(M, pts, bw), 3)):
            out = fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(3):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(k):
                    fn()
                e1.record()
                torch.cuda.synchronize()
                ts.append(e0.elapsed_time(e1) / k)
            walls[route] = (statistics.median(ts), out)
        lp64 = beliefs.kde_logpdf(M, beliefs.Belief(
            pts.double(), bw.double(), bw.double()), pts.double())
        gaps = {r: float((o.double() - lp64).abs().max())
                for r, (_, o) in walls.items()}
        check(gaps["kernel"] <= 2e-5, f"KDE kernel {name}: {gaps['kernel']} "
              "from the plain route in float64")
        m = pts.shape[0]
        print(f"PASS KDE kernel {name} {m} x {m}: kernel "
              f"{walls['kernel'][0]:.3f} ms, plain "
              f"{walls['plain'][0]:.1f} ms (CUDA events, medians of 3); "
              f"largest gap to float64: kernel {gaps['kernel']:.2e}, plain "
              f"{gaps['plain']:.2e}", flush=True)


def _draw_inputs(dof, n, gen, dev):
    """(muA, precA, muB, precB) of a 50k x 50k product on the card: at dof
    1 the line2-n50k cell's (a sigma-1 prior's kernels at bandwidth 0.12
    against a sigma-10 message's at 1.2), at dof 3 the se2pair-n50k cell's
    x0 product (the sigma-0.01 prior's kernels at 0.0013 against the
    message's spread 0.5, 0.5, 0.05 at bandwidths 0.12 of it)."""
    if dof == 1:
        sa, ba = torch.ones(1), torch.full((1,), 0.12)
        sb, bb = torch.full((1,), 10.0), torch.full((1,), 1.2)
    else:
        sb = torch.tensor([0.5, 0.5, 0.05])
        sa, ba, bb = torch.full((3,), 0.01), torch.full((3,), 0.0013), \
            0.12 * sb
    muA = (torch.randn(n, dof, generator=gen) * sa).to(dev)
    muB = (torch.randn(n, dof, generator=gen) * sb).to(dev)
    return (muA, (1.0 / ba ** 2).expand(n, dof).to(dev), muB,
            (1.0 / bb ** 2).expand(n, dof).to(dev))


def _eager_block_draw(muA_s, precA_s, muB, precB, key):
    """The column draw of the large pair product before its kernel: the
    pair log-weights of 2,048 selected rows at a time, Gumbel noise and an
    argmax (``keys.categorical_rows``).  Timed here only, as a yardstick."""
    from incrementalinference_torch import keys
    from incrementalinference_torch.ops import product

    n_out, blk = muA_s.shape[0], 2048
    nblk = -(-n_out // blk)
    ks = keys.split(key, nblk)
    return torch.cat([keys.categorical_rows(ks[j], product._pair_logW(
        muA_s[j * blk:(j + 1) * blk], precA_s[j * blk:(j + 1) * blk], muB,
        precB)) for j in range(nblk)])


def phase_draw_kernel(n=50_000, reps=10):
    """The large pair product's column draw (ops/kernels/pair_draw.py) at n
    drawn rows x n columns, dof 1 and dof 3 (_draw_inputs): CUDA-event
    medians of three windows of the kernel's draw, of its plain version on
    the card and of the eager block draw it replaced, beside the least time
    (one exponential a pair on the lanes and SFUs, bench_port/lib/
    peaks.json's rates); and the share of rows where the kernel and the
    plain version part on the same uniforms.  Alone: ``python3 -c "import
    chip_smoke as cs; cs.phase_draw_kernel()"``."""
    from incrementalinference_torch.ops.kernels import pair_draw
    from incrementalinference_torch.ops.kernels.row_lse import \
        pair_row_terms

    pair_draw.build(verbose=False)
    dev = torch.device("cuda")
    t_phase = time.time()
    least_ms = 1e3 * n * n / (132 * (128 + 16) * 1.98e9)
    gen = torch.Generator().manual_seed(22)
    for dof in (1, 3):
        muA, precA, muB, precB = _draw_inputs(dof, n, gen, dev)
        ia = torch.randint(0, n, (n,), generator=gen).to(dev)
        muA_s, precA_s = muA[ia], precA[ia]
        a2, iva, ivmuA = (t.contiguous() for t in pair_row_terms(
            muA_s, precA_s, muB, precB))
        u = torch.rand(n, 2, generator=gen).to(dev)
        args = (a2, iva, ivmuA, muB.contiguous(), u)
        walls = {}
        for route, fn, k in (
                ("kernel", lambda: pair_draw.pair_column_draw(*args), reps),
                ("plain", lambda: pair_draw.pair_column_draw_plain(
                    *args, max_elems=1 << 26), 1),
                ("eager", lambda: _eager_block_draw(
                    muA_s, precA_s, muB, precB, 7), 2)):
            out = fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(3):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(k):
                    fn()
                e1.record()
                torch.cuda.synchronize()
                ts.append(e0.elapsed_time(e1) / k)
            walls[route] = (statistics.median(ts), out)
        got, want = walls["kernel"][1], walls["plain"][1]
        parted = float((got != want).double().mean())
        check(torch.equal(got, pair_draw.pair_column_draw(*args)),
              f"draw kernel dof {dof}: two launches differ")
        check(parted <= 1e-4, f"draw kernel dof {dof}: {parted:.2e} of the "
              f"rows part from the plain version")
        print(f"PASS draw kernel dof {dof} {n} x {n}: kernel "
              f"{walls['kernel'][0]:.3f} ms, plain "
              f"{walls['plain'][0]:.1f} ms, eager block draw "
              f"{walls['eager'][0]:.1f} ms (CUDA events, medians of 3), "
              f"least {least_ms:.3f} ms ({100 * least_ms / walls['kernel'][0]:.2f} "
              f"% of it); rows parted from the plain version {parted:.2e}",
              flush=True)
    print(f"# phase_draw_kernel: {time.time() - t_phase:.1f} s", flush=True)


def phase_joint(it):
    """LineStep(20) with joint up-messages: solved up messages carry
    relative likelihoods between separator pairs (use_msg_likelihoods)."""
    fg = it.generate_line_step(
        20, graphinit=True, device="cuda",
        params=it.SolverParams(use_msg_likelihoods=True))
    torch.cuda.synchronize()
    t0 = time.time()
    tree = it.solve_tree(fg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    joint = [m.jointmsg for m in tree.up_msgs.values()
             if m.jointmsg is not None]
    check(joint, "no up message carried a joint payload")
    means = {i: float(fg.points(f"x{i}").mean()) for i in range(0, 21, 2)}
    for i, m in means.items():
        check(abs(m - i) < 1.5, f"joint LineStep x{i}: mean {m} (bar 1.5)")
    print(f"PASS LineStep(20) N=100 with joint up-messages on CUDA: "
          f"{wall:.3f} s; {len(joint)} up messages with a joint payload, "
          f"{sum(len(j.relatives) for j in joint)} relatives and "
          f"{sum(len(j.priors) for j in joint)} priors in them; pose means "
          f"{ {k: round(v, 3) for k, v in means.items()} }", flush=True)


# -- slices 7 and 9a: the model families and the graph and tree surfaces ----

#: the conv ensemble of tests/test_extensions.py:306-307
_CONV_SPEC = (("conv2d", 1, 4, 3), ("relu",), ("maxpool2d", 2),
              ("flatten",), ("dense", 4 * 4 * 4, 1))
#: the forcing grid of tests/test_extensions.py:188-195: u(t) = 2t sampled
#: at t = 0, 0.25, ..., 2
_RAMP_T0, _RAMP_DT, _RAMP_N = 0.0, 0.25, 9


def _forced(t, x, u):
    """ẋ = −x/2 + u(t), u linearly interpolated in the ``data`` rows
    (tgrid, ugrid): jnp.interp's values on this uniform grid.  The cell is
    found from the Python float ``t`` on the host, and −x/2 is an
    alpha-add: under torch.func's forward mode a product with a constant
    takes a Python decomposition of the host's time."""
    s = min(max((t - _RAMP_T0) / _RAMP_DT, 0.0), _RAMP_N - 1.0)
    i = min(int(s), _RAMP_N - 2)
    return torch.add(torch.lerp(u[1, i], u[1, i + 1], s - i), x, alpha=-0.5)


def _solve_timed(it, fg):
    torch.cuda.synchronize()
    t0 = time.time()
    tree = it.solve_tree(fg)
    torch.cuda.synchronize()
    return time.time() - t0, tree


def phase_flux_mixture(it, K, N=50_000):
    """_two_var_graph with a network-ensemble mixture as its relative:
    MixtureFluxModels(LinearRelative, an 8-member conv ensemble on an
    8×8×1 image, [Normal(10, 1)], [0.5, 0.5]); every product of x1 is a
    large pair product.  Bars: finite points, at least 5 % of x1 in (5, 15)
    (tests/test_extensions.py:290-325).  Returns the kernel launches."""
    from incrementalinference_torch import keys

    params = it.nn_init(keys.generator(7, "cuda"), _CONV_SPEC, n_models=8)
    nn = it.FluxModelsDistribution(it.SequentialNet(_CONV_SPEC), params,
                                   torch.full((8, 8, 1), 0.1), out_dim=1)
    K.reset_counts()
    fg = it.initfg(it.SolverParams(N=N, batch_cliques=False), device="cuda")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)))
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0", "x1"], it.MixtureFluxModels(
        it.LinearRelative, nn, [it.Normal(10.0, 1.0)], [0.5, 0.5]))
    fg.add_factor(["x1"], it.Prior(it.Normal(10.0, 1.0)))
    wall, _ = _solve_timed(it, fg)
    launches = K.counts["launches"]
    check(launches > 0, "the flux mixture N=50k solve never launched the "
                        "row_logsumexp kernel")
    x1 = fg.points("x1")[:, 0]
    check(bool(torch.isfinite(fg.points("x0")).all())
          and bool(torch.isfinite(x1).all()), "flux mixture: non-finite")
    near10 = float(((x1 > 5.0) & (x1 < 15.0)).float().mean())
    near0 = float(((x1 > -3.0) & (x1 < 3.0)).float().mean())
    check(near10 >= 0.05, f"flux mixture: {near10} of x1 in (5, 15)")
    print(f"PASS flux mixture N={N} (8-member conv ensemble) solve_tree on "
          f"CUDA through the kernel: {wall:.3f} s (graph build with "
          f"graphinit included in no wall); launches {launches}; x1 share "
          f"in (5, 15) {near10:.3f}, in (-3, 3) {near0:.3f}; ensemble "
          f"outputs {nn.all_outputs('cuda')[:, 0].tolist()}", flush=True)
    return launches


def phase_forced_ode(it, K, N=50_000, steps=32):
    """The forced ODE of tests/test_extensions.py:178-226 at N = 50,000:
    a prior Normal(1, 0.05) on x0, the DERelative with the ramp as its
    ``data``, a prior Normal(x1_truth, 0.05) on x1.  First one proposal for
    each variable alone (its LM iterations, Jacobian and residual passes,
    and wall), then the solve, whose products go through the kernel.  Bars
    |mean(x1) − x1_truth| < 0.25, |mean(x0) − 1| < 0.25.  (The n-ary
    decay-rate graph of tests/test_extensions.py:229-254 is solved by
    examples_torch/ode_smoothing.py in phase_examples, at its bar.)
    Returns the kernel launches of the N = 50k solve."""
    from incrementalinference_torch.ops import convolve

    tgrid = torch.linspace(_RAMP_T0, _RAMP_T0 + _RAMP_DT * (_RAMP_N - 1),
                           _RAMP_N)
    de = it.DERelative(_forced, t0=0.0, t1=2.0, Z=it.MvNormal([0.0], [0.01]),
                       dim=1, steps=steps,
                       data=torch.stack([tgrid, 2.0 * tgrid]))
    x1_truth = float(de.flow(torch.tensor([1.0], device="cuda"))[0])
    analytic = 4 * 2.0 - 8.0 + 9.0 * math.exp(-1.0)
    check(abs(x1_truth - analytic) < 1e-3, f"flow {x1_truth} vs {analytic}")
    K.reset_counts()
    fg = it.initfg(it.SolverParams(N=N, batch_cliques=False), device="cuda")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(1.0, 0.05)))
    fg.add_variable("x1", it.ContinuousScalar)
    f = fg.add_factor(["x0", "x1"], de)
    fg.add_factor(["x1"], it.Prior(it.Normal(x1_truth, 0.05)))
    build_launches = K.counts["launches"]

    counted = {"jac": 0, "res": 0}
    orig_jacrev, orig_res = convolve.jacrev, de.residual

    def jacrev(fn, *a, **k):
        g = orig_jacrev(fn, *a, **k)

        def h(*x, **y):
            counted["jac"] += 1
            return g(*x, **y)
        return h

    def residual(*a):
        counted["res"] += 1
        return orig_res(*a)

    probes = {}
    convolve.jacrev, de.residual = jacrev, residual
    try:
        for target in ("x1", "x0"):
            counted.update(jac=0, res=0)
            spec = convolve.make_conv_spec(fg, f, target)
            torch.cuda.synchronize()
            t0 = time.time()
            convolve.eval_factor(fg, f, target)
            torch.cuda.synchronize()
            probes[target] = (spec.cycles * spec.iters, counted["jac"],
                              counted["res"] - counted["jac"],
                              round(time.time() - t0, 3))
    finally:
        convolve.jacrev = orig_jacrev
        del de.residual
    print(f"one DERelative proposal at N={N}, {steps} RK4 steps (cycles x "
          f"LM iterations, Jacobian passes, residual-only passes, s): "
          f"{probes}", flush=True)

    K.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    wall, _ = _solve_timed(it, fg)
    peak = torch.cuda.max_memory_allocated() - base
    launches = K.counts["launches"]
    check(launches > 0, "the forced ODE N=50k solve never launched the "
                        "row_logsumexp kernel")
    m0 = float(fg.points("x0").mean())
    m1 = float(fg.points("x1").mean())
    check(abs(m1 - x1_truth) < 0.25, f"forced ODE x1 {m1} vs {x1_truth}")
    check(abs(m0 - 1.0) < 0.25, f"forced ODE x0 {m0}")
    print(f"PASS forced ODE N={N} ({steps} RK4 steps) solve_tree on CUDA "
          f"through the kernel: {wall:.3f} s; launches {launches} (graph "
          f"build with graphinit {build_launches}); mean x0 {m0:.4f} "
          f"(1), x1 {m1:.4f} ({x1_truth:.4f}); peak memory above the "
          f"graph's {peak / 2**20:.1f} MiB (reverse mode keeps the RK4 "
          f"steps' tape)", flush=True)
    return launches


def phase_heatmap(it, K, N=50_000):
    """A pose x0 on R² with prior MvNormal([60, 30], [2, 2]), a landmark l
    with a HeatmapGridDensity prior (the Gaussian bump at (70, 30), sigma
    5, on the 50 × 40 grid over [0, 100]² of tests/test_extensions.py:
    29-31) and LinearRelative(MvNormal([10, 0], [1, 1])) between them:
    every product of l is a large pair product at dof 2.  Bar: each
    coordinate of mean(l) within 2 of (70, 30).  Returns (launches, the
    last inputs the solve handed the kernel's wrapper)."""
    from incrementalinference_torch.ops import product

    xs = torch.linspace(0.0, 100.0, 50)
    ys = torch.linspace(0.0, 100.0, 40)
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    bump = torch.exp(-((X - 70.0) ** 2 + (Y - 30.0) ** 2) / (2 * 5.0 ** 2))
    handed, wrapper = [], product.pair_row_logsumexp

    def recording(muA, precA, muB, precB):
        handed[:] = _one_member(muA, precA, muB, precB)
        return wrapper(muA, precA, muB, precB)

    K.reset_counts()
    product.pair_row_logsumexp = recording
    try:
        fg = it.initfg(it.SolverParams(N=N, batch_cliques=False),
                       device="cuda")
        fg.add_variable("x0", it.ContinuousEuclid(2))
        fg.add_factor(["x0"], it.Prior(it.MvNormal([60.0, 30.0],
                                                   [2.0, 2.0])))
        fg.add_variable("l", it.ContinuousEuclid(2))
        fg.add_factor(["l"], it.Prior(it.HeatmapGridDensity(bump,
                                                            (xs, ys))))
        fg.add_factor(["x0", "l"], it.LinearRelative(
            it.MvNormal([10.0, 0.0], [1.0, 1.0])))
        wall, _ = _solve_timed(it, fg)
    finally:
        product.pair_row_logsumexp = wrapper
    launches = K.counts["launches"]
    check(launches > 0, "the heatmap N=50k solve never launched the "
                        "row_logsumexp kernel")
    check(handed and handed[0].shape == (N, 2),
          f"heatmap: the kernel was not handed ({N}, 2) inputs")
    mean_l = fg.points("l").mean(0).tolist()
    check(abs(mean_l[0] - 70.0) < 2.0 and abs(mean_l[1] - 30.0) < 2.0,
          f"heatmap landmark mean {mean_l}")
    print(f"PASS heatmap landmark N={N} (dof 2) solve_tree on CUDA through "
          f"the kernel: {wall:.3f} s; launches {launches}; mean(l) "
          f"{[round(v, 3) for v in mean_l]} (70, 30), mean(x0) "
          f"{[round(v, 3) for v in fg.points('x0').mean(0).tolist()]}",
          flush=True)
    return launches, [t.clone() for t in handed]


def phase_surfaces(it, K, hexagon, hex_tree, N=50_000):
    """The graph and tree surfaces on CUDA: deepcopy_graph of the N = 50k
    two-variable graph keeps every tensor on the card, remove_variable and
    a re-solve of what is left, ppe_batched of the hexagon's poses against
    ppe one by one (1e-5), and the clique accessors over the hexagon's
    solved tree."""
    from incrementalinference_torch import beliefs

    t_all = time.time()
    fg = _two_var_graph(it, N)
    cp = it.deepcopy_graph(fg)
    tensors = [t for v in cp.variables.values() for b in v.beliefs.values()
               for t in b]
    check(cp.device.type == "cuda" and tensors
          and all(t.device.type == "cuda" for t in tensors),
          "deepcopy_graph left a tensor off the card")
    K.reset_counts()
    cp.remove_variable("x1")
    check(cp.ls() == ["x0"] and len(cp.lsf()) == 1 and fg.exists("x1"),
          "remove_variable: the copy or the original is wrong")
    wall, _ = _solve_timed(it, cp)
    m0 = float(cp.points("x0").mean())
    check(abs(m0) < 0.2, f"after remove_variable: mean(x0) {m0}")

    poses = [v for v in hexagon.ls() if v.startswith("x")]
    se2 = hexagon.var(poses[0]).manifold
    bel = [hexagon.get_belief(v) for v in poses]
    batched = beliefs.ppe_batched(se2, bel)
    err = max(float((a[k] - b[k]).abs().max())
              for a, b in zip(batched, (beliefs.ppe(se2, x) for x in bel))
              for k in ("mean", "max"))
    check(err <= 1e-5, f"ppe_batched vs ppe: {err}")

    depths = {}
    for cid, cl in hex_tree.cliques.items():
        d = it.get_cliq_depth(hex_tree, cl)
        check(hex_tree.is_root(cid) == (d == 0) == (it.get_parent(
            hex_tree, cl) is None), f"clique {cid}: root and depth disagree")
        depths[cid] = d
    total, marg, reused, both = it.calc_cliques_recycled(hex_tree)
    check(total == hex_tree.num_cliques(), "calc_cliques_recycled total")
    check(it.is_tree_solved(hex_tree), "the hexagon's tree is not solved")
    print(f"PASS graph and tree surfaces on CUDA: deepcopy_graph of N={N} "
          f"kept {len(tensors)} tensors on the card; remove_variable and "
          f"re-solve {wall:.3f} s (mean(x0) {m0:.4f}, launches "
          f"{K.counts['launches']}); ppe_batched of {len(poses)} SE(2) "
          f"poses within {err:.2e} of ppe; hexagon tree depths {depths}, "
          f"calc_cliques_recycled {(total, marg, reused, both)}; "
          f"{time.time() - t_all:.3f} s", flush=True)


def phase_persistence(it, K, N=50_000):
    """Persistence and diagnostics on CUDA: warmup; the N = 50k two-variable
    graph solved, saved (graph and tree), loaded onto the card (every
    belief tensor float32 there, points, bw and ipc bit-equal to the saved
    ones, the tree clique for clique) and re-solved with the loaded tree as
    ``old_tree`` through the kernel (launch count grows, the bars of
    phase_large); its saveDFG archive round trip onto the card (point
    blocks equal) and the golden archive of tests/fixtures solved at the
    bars of tests/test_dfg_import.py:58-76; fault injection on LineStep(20)
    at N = 100 with record_cliques (a skipped clique left untouched, a
    timeout that must raise and one that must not, the history files, and
    a replayed up-solve from the captured child messages)."""
    import tempfile

    from incrementalinference_torch.canonical import generate_line_step

    t_all = time.time()
    t0 = time.time()
    it.warmup(device="cuda")
    torch.cuda.synchronize()
    t_warm = time.time() - t0

    fg = _two_var_graph(it, N)
    _, tree = _solve_timed(it, fg)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        gpath = it.save_graph(fg, os.path.join(tmp, "fg.json"))
        tpath = it.save_tree(tree, os.path.join(tmp, "bt.json"))
        t_save = time.time() - t0
        nbytes = os.path.getsize(gpath)
        t0 = time.time()
        fg2 = it.load_graph(gpath, device="cuda")
        tree2 = it.load_tree(tpath)
        torch.cuda.synchronize()
        t_load = time.time() - t0
        n_tensors = 0
        for v in fg.ls():
            saved, loaded = fg.var(v).beliefs, fg2.var(v).beliefs
            check(sorted(saved) == sorted(loaded), f"{v}: solve keys differ")
            for key in saved:
                for a, b in zip(saved[key], loaded[key]):
                    check(b.device.type == "cuda"
                          and b.dtype == torch.float32,
                          f"loaded {v}/{key}: {b.dtype} on {b.device}")
                    check(torch.equal(a, b), f"loaded {v}/{key}: not "
                          f"bit-equal to the saved belief")
                    n_tensors += 1
        check(tree2.elimination_order == tree.elimination_order
              and sorted(tree2.cliques) == sorted(tree.cliques)
              and all(tree2.cliques[c].frontals == cl.frontals
                      and tree2.cliques[c].separator == cl.separator
                      for c, cl in tree.cliques.items()),
              "the loaded tree differs from the saved one")

        K.reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        tree3 = it.solve_tree(fg2, old_tree=tree2)
        torch.cuda.synchronize()
        t_resolve = time.time() - t0
        launches = K.counts["launches"]
        check(launches > 0, "the re-solve of the loaded graph never "
              "launched the row_logsumexp kernel")
        recycled = sum(c.is_recycled for c in tree3.cliques.values())
        stats = _check_two_var(fg2, "re-solved")

        t0 = time.time()
        apath = it.save_dfg_archive(fg2, os.path.join(tmp, "g.tar.gz"))
        fa = it.load_dfg_archive(apath, device="cuda")
        torch.cuda.synchronize()
        t_dfg = time.time() - t0
        abytes = os.path.getsize(apath)
        for v in fg2.ls():
            check(fa.points(v).device.type == "cuda"
                  and torch.equal(fa.points(v), fg2.points(v)),
                  f"saveDFG round trip: {v}'s points differ")
        fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "fixtures", "dfg_archive")
        fx = it.load_dfg_archive(fixture, device="cuda")
        it.solve_tree(fx)
        p0 = fx.points("x0")[:, 0]
        m0 = float(((p0 + 100).abs() < 20).float().mean()
                   + (p0.abs() < 20).float().mean())
        l1 = fx.points("l1").mean(0)
        th = float(((fx.points("theta")[:, 0] - 3.0).abs() < 0.5)
                   .float().mean())
        check(m0 > 0.8 and float(((p0 - 300).abs() < 20).float().mean()) < 0.1
              and abs(float(l1[0]) - 3.2) < 0.5
              and abs(float(l1[1]) + 2.0) < 0.5 and th > 0.9,
              f"golden archive solve: x0 mass {m0}, l1 {l1.tolist()}, "
              f"theta {th}")

        fl = generate_line_step(20, graphinit=True, device="cuda")
        fl.params.record_cliques = True
        fl.params.logpath = os.path.join(tmp, "logs")
        tree0 = it.solve_tree(fl)
        some = list(tree0.cliques)[-1]
        before = {v: fl.points(v).clone()
                  for v in tree0.clique(some).frontals}
        t = it.solve_tree(fl, skip_cliques=[some])
        check(all(torch.equal(fl.points(v), p) for v, p in before.items())
              and [e[1] for e in t.traces[some].events] == ["skip"]
              and t.clique(some).status != it.CliqStatus.ERROR_STATUS,
              "skip_cliques: the skipped clique was touched")
        leafish = tree0.levels()[-1][0]
        raised = None
        try:
            it.solve_tree(fl, timeout=0.4, delay_cliques={leafish: 1.0})
        except RuntimeError as e:
            raised = e
        check(raised is not None
              and isinstance(raised.__cause__, TimeoutError),
              f"timeout=0.4 with a 1 s delay did not time out: {raised!r}")
        t = it.solve_tree(fl, timeout=120.0)
        check(all(c.status == it.CliqStatus.DOWNSOLVED
                  for c in t.cliques.values()), "timeout=120 interfered")
        logs = fl.params.logpath
        n_logs = len(os.listdir(os.path.join(logs, "logs")))
        check(any(f.startswith("HistoryAll_") for f in os.listdir(logs))
              and n_logs == t.num_cliques(), "history files missing")
        target = next(c for c in t.cliques.values()
                      if c.children and c.separator)
        msg = it.debugging.replay_clique_up(fl, t, target.cid, t.traces)
        check(bool(msg.beliefs) and all(
            b.points.device.type == "cuda" and bool(b.points.isfinite().all())
            for b in msg.beliefs.values()),
            "replay_clique_up: a non-finite or off-card message")
    print(f"PASS persistence on CUDA: warmup {t_warm:.3f} s; N={N} graph "
          f"saved in {t_save:.3f} s ({nbytes} bytes of JSON), loaded onto "
          f"the card in {t_load:.3f} s, {n_tensors} belief tensors "
          f"bit-equal; re-solve with the loaded tree {t_resolve:.3f} s, "
          f"{recycled} of {tree3.num_cliques()} cliques recycled, kernel "
          f"launches {launches}, posteriors (mean, std) {stats}; saveDFG "
          f"round trip {t_dfg:.3f} s ({abytes} bytes); golden archive "
          f"solved (x0 mass {m0:.3f}); skip, timeout, {n_logs} clique logs "
          f"and a replay of clique {target.cid} on LineStep(20); "
          f"{time.time() - t_all:.3f} s", flush=True)
    return launches


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _batched_inputs(K, B, n, dof, dev, seed):
    """Row terms of B members of one shape, each member its own random
    particles (bandwidth ~ 0.3, as timing_inputs)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    muA = torch.randn((B, n, dof), generator=gen, device=dev)
    muB = torch.randn((B, n, dof), generator=gen, device=dev) + 0.1 * \
        torch.arange(B, device=dev, dtype=torch.float32)[:, None, None]
    prec = torch.full((B, n, dof), 11.0, device=dev)
    a2, iva, ivm = K.pair_row_terms(muA, prec, muB, prec)
    return a2.contiguous(), iva.contiguous(), ivm.contiguous(), \
        muB.contiguous()


def phase_batched_kernel(K, dev, B=8, n=50_000):
    """The kernel's batched launch (one launch for B members, the member
    from blockIdx.z) at the batched level's shape: against its plain
    version looped over the members (bar 1e-5 by rel_err) and against B
    single launches (bar 1e-6), timed against B single launches, the
    library route looped over the members and the bound of B problems.
    Returns the entries (dof 1 and 3) for the kernels line."""
    out = []
    for dof in (1, 3):
        a2, iva, ivm, muB = _batched_inputs(K, B, n, dof, dev, seed=dof)
        before = dict(K.counts)
        got = K.row_logsumexp(a2, iva, ivm, muB)
        _sync(dev)
        check(K.counts["launches"] - before["launches"] == 1
              and K.counts["problems"] - before["problems"] == B,
              f"batched call at dof {dof}: {before} -> {K.counts}")
        plain = torch.stack([K.row_logsumexp_plain(a2[b], iva[b], ivm[b],
                                                   muB[b])
                             for b in range(B)])
        singles = torch.stack([K.row_logsumexp(a2[b], iva[b], ivm[b],
                                               muB[b]) for b in range(B)])
        check(bool(torch.isfinite(got).all()), "batched: not finite")
        err_plain, err_single = rel_err(got, plain), rel_err(got, singles)
        max_abs = float((got - plain).abs().max())
        check(err_plain <= _TOL, f"batched dof {dof} vs plain {err_plain}")
        check(err_single <= 1e-6,
              f"batched dof {dof} vs {B} single launches {err_single}")
        del plain, singles
        k_ms = cuda_ms(lambda: K.row_logsumexp(a2, iva, ivm, muB), reps=10)
        s_ms = cuda_ms(lambda: [K.row_logsumexp(a2[b], iva[b], ivm[b],
                                                muB[b]) for b in range(B)],
                       reps=5)
        p_ms = cuda_ms(lambda: [K.row_logsumexp_plain(
            a2[b], iva[b], ivm[b], muB[b]) for b in range(B)], reps=2,
            warmup=1)
        # the library route has no member axis that fits in memory (B
        # (Na, Nb) matrices): looped over the members, as the plain one
        lib = torch.stack([library_row_logsumexp(a2[b], iva[b], ivm[b],
                                                 muB[b]) for b in range(B)])
        err_lib = rel_err(lib, got)
        check(err_lib <= _TOL, f"batched dof {dof}: library route "
                               f"disagrees {err_lib}")
        del lib
        l_ms = cuda_ms(lambda: [library_row_logsumexp(
            a2[b], iva[b], ivm[b], muB[b]) for b in range(B)], reps=2,
            warmup=1)
        torch.cuda.empty_cache()
        one, t_bytes, t_flops, t_exp = bound_ms(n, dof)
        print(f"PASS row_logsumexp batched, {B} members of {n} x {n} dof "
              f"{dof}, one launch: {k_ms:.4f} ms; {B} single launches "
              f"{s_ms:.4f} ms; plain (looped) {p_ms:.4f} ms; library "
              f"(looped) {l_ms:.4f} ms; bound {B * one:.4f} ms ({B} x "
              f"{one:.4f}); rel err vs plain {err_plain:.3e}, vs single "
              f"launches {err_single:.3e}", flush=True)
        out.append({"members": B, "n": n, "dof": dof,
                    "problems_per_launch": B, "max_abs_err": max_abs,
                    "rel_err_vs_single_launches": err_single, "ms": k_ms,
                    "single_launches_ms": s_ms, "plain_ms": p_ms,
                    "bound_ms": B * one,
                    "bound_by": "bytes" if t_bytes >= max(t_flops, t_exp)
                    else "operations", "library_ms": l_ms})
        del a2, iva, ivm, muB
        torch.cuda.empty_cache()
    return out


def _wide_two_var(it, N, dev, branches=8, **params):
    """Eight copies of _two_var_graph side by side, branch b offset by
    100 b: one level of eight isomorphic cliques."""
    fg = it.initfg(it.SolverParams(N=N, **params), device=dev)
    for b in range(branches):
        o = 100.0 * b
        fg.add_variable(f"b{b}x0", it.ContinuousScalar)
        fg.add_factor([f"b{b}x0"], it.Prior(it.Normal(o, 1.0)))
        fg.add_variable(f"b{b}x1", it.ContinuousScalar)
        fg.add_factor([f"b{b}x0", f"b{b}x1"],
                      it.LinearRelative(it.Normal(10.0, 1.0)))
        fg.add_factor([f"b{b}x1"], it.Prior(it.Normal(o + 10.0, 1.0)))
    return fg


def _check_wide(fg, what, branches=8):
    """_check_two_var's bars on every branch."""
    worst = 0.0
    for b in range(branches):
        for v, mu in ((f"b{b}x0", 100.0 * b), (f"b{b}x1", 100.0 * b + 10)):
            pts = fg.points(v)[:, 0]
            m, sd = float(pts.mean()), float(pts.std())
            check(abs(m - mu) < 0.2 and 0.4 < sd < 1.5,
                  f"{what} {v}: mean {m}, std {sd}")
            worst = max(worst, abs(m - mu))
    return worst


def _bench_forest(it, dev, **params):
    """bench.py:119-130's wide forest: 32 branches of a Prior and a
    LinearRelative, at N=100."""
    fg = it.initfg(it.SolverParams(**params), device=dev)
    for b in range(32):
        fg.add_variable(f"b{b}x0", it.ContinuousScalar)
        fg.add_factor([f"b{b}x0"], it.Prior(it.Normal(float(b), 0.5)))
        fg.add_variable(f"b{b}x1", it.ContinuousScalar)
        fg.add_factor([f"b{b}x0", f"b{b}x1"],
                      it.LinearRelative(it.Normal(1.0, 0.5)))
    return fg


def phase_batched_solves(it, K, dev, N=50_000):
    """The batched level end to end.  The eight-branch N=50k forest with
    the default batch_cliques ("auto", width 8) cold and warm, and with
    batch_cliques=False: launches and problems a solve, peak memory, the
    bars of every branch.  Then, at N=100: bench.py's 32-branch forest
    batched and per clique; fourdoor with batch_cliques=True; LineStep(20)
    with fuse_sweep=True, which solves clique by clique (the field is kept
    for API parity only).  Returns the launches of the warm batched
    solve."""
    import incrementalinference_torch.parallel.scheduler as sched
    from incrementalinference_torch.canonical import generate_line_step

    on_cuda = torch.device(dev).type == "cuda"
    rows = []
    for label, params in (("batched, cold", {}), ("batched, warm", {}),
                          ("per clique", {"batch_cliques": False})):
        fg = _wide_two_var(it, N, dev, **params)
        if on_cuda:
            torch.cuda.reset_peak_memory_stats()
        with _Counting(sched, "up_solve_level") as levels:
            K.reset_counts()
            _sync(dev)
            t0 = time.time()
            it.solve_tree(fg)
            _sync(dev)
            wall = time.time() - t0
        counts = dict(K.counts)
        peak = torch.cuda.max_memory_allocated() if on_cuda else 0
        worst = _check_wide(fg, f"forest N={N} {label}")
        check((levels.calls > 0) == (label != "per clique"),
              f"forest {label}: up_solve_level calls {levels.calls}")
        if on_cuda:
            # every clique solves 6 large-pair stages up and 6 down: 96
            # problems a solve.  Per clique each is its own launch; the
            # batched level runs its up stages as one launch for all 8
            # members (6) and the down sweep stays per clique (48)
            want = 96 if label == "per clique" else 6 + 48
            check(counts["problems"] == 96 and counts["launches"] == want,
                  f"forest {label}: {counts['launches']} launches of "
                  f"{counts['problems']} problems, not {want} of 96")
        rows.append((label, wall, counts, peak, worst))
        print(f"PASS forest of 8 two-variable branches N={N} {label}: "
              f"wall {wall:.3f} s; launches {counts['launches']}, problems "
              f"{counts['problems']}, wrapper calls {counts['calls']}; peak "
              f"memory {peak / 2**30:.2f} GiB; worst |mean - mu| "
              f"{worst:.3f}", flush=True)
        del fg

    walls = {}
    for label, params in (("batched", {}), ("per clique",
                                            {"batch_cliques": False})):
        for _ in range(2):
            fg = _bench_forest(it, dev, **params)
            _sync(dev)
            t0 = time.time()
            it.solve_tree(fg)
            _sync(dev)
            walls.setdefault(label, []).append(time.time() - t0)
        for b in range(32):
            m = float(fg.points(f"b{b}x1").mean())
            check(abs(m - (b + 1)) < 1.5, f"bench forest {label} b{b}: {m}")
    print(f"PASS bench.py forest of 32 at N=100: batched walls "
          f"{[round(w, 3) for w in walls['batched']]} s, per clique "
          f"{[round(w, 3) for w in walls['per clique']]} s", flush=True)

    fg, steps = it.fourdoor_sequence(it.SolverParams(batch_cliques=True),
                                     device=dev)
    tree = None
    for s in steps:
        s()
        tree = it.solve_tree(fg, old_tree=tree)
    for v, c in (("x1", 0.0), ("x3", 100.0), ("x4", 300.0)):
        m = float(fg.points(v)[:, 0].mean())
        check(abs(m - c) < 10.0, f"fourdoor batched {v}: {m}")
    fg = generate_line_step(20, graphinit=True, device=dev,
                            params=it.SolverParams(fuse_sweep=True))
    it.solve_tree(fg)
    for i in range(0, 21, 2):
        m = float(fg.points(f"x{i}").mean())
        check(abs(m - i) < 1.5, f"fuse_sweep LineStep x{i}: {m}")
    print(f"PASS fourdoor N=100 batch_cliques=True at the bars of "
          f"tests/test_solve.py:218-229; LineStep(20) fuse_sweep=True at "
          f"the bars of tests/test_fused_chain.py:19-26", flush=True)
    return rows[1][2]["launches"], rows[1][2]["problems"], rows


def _doors(it, dev, N=128):
    fg = it.initfg(it.SolverParams(N=N), device=dev)
    door = it.Mixture(it.Prior, [it.Normal(-100, 3), it.Normal(0, 3),
                                 it.Normal(100, 3), it.Normal(300, 3)])
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x1"], door)
    fg.add_variable("x2", it.ContinuousScalar)
    fg.add_factor(["x1", "x2"], it.LinearRelative(it.Normal(50.0, 2.0)))
    fg.add_variable("x3", it.ContinuousScalar)
    fg.add_factor(["x2", "x3"], it.LinearRelative(it.Normal(50.0, 4.0)))
    fg.add_factor(["x3"], door)
    return fg


def phase_mesh(it, dev, meshes):
    """Distribution over a mesh on the card, at the bars of
    tests/test_multichip.py and tests/test_multichip_policy.py: under
    "particles" the door graph, under "cliques" and "auto" the 6-branch
    forest and the 10-variable chain, and the parametric tree solve of 16
    branches with ``mesh=``; then dryrun_multichip(1), entry() and the
    Kaess solve with precompile=True."""
    from incrementalinference_torch.graft_entry import dryrun_multichip, \
        entry

    t0 = time.time()
    for name, mesh in meshes:
        fg = _doors(it, dev)
        it.solve_tree(fg, mesh=mesh)
        for v, cs in (("x1", (-100, 0)), ("x3", (0, 100))):
            m = sum(_mode_mass(fg, v, c) for c in cs)
            check(m > 0.7, f"{name} particles {v}: {m}")
        for dist in ("cliques", "auto"):
            fg = it.initfg(it.SolverParams(N=128, batch_cliques="auto",
                                           batch_min_width=2), device=dev)
            for b in range(6):
                fg.add_variable(f"b{b}x0", it.ContinuousScalar)
                fg.add_factor([f"b{b}x0"], it.Prior(it.Normal(float(b), 0.5)))
                fg.add_variable(f"b{b}x1", it.ContinuousScalar)
                fg.add_factor([f"b{b}x0", f"b{b}x1"],
                              it.LinearRelative(it.Normal(1.0, 0.5)))
            it.solve_tree(fg, mesh=mesh, distribute=dist)
            for b in range(6):
                m = float(fg.points(f"b{b}x1").mean())
                check(abs(m - (b + 1)) < 1.5, f"{name} {dist} b{b}: {m}")
            fg = it.initfg(it.SolverParams(N=64), device=dev)
            prev = None
            for i in range(10):
                fg.add_variable(f"x{i}", it.ContinuousScalar)
                if prev is None:
                    fg.add_factor([f"x{i}"], it.Prior(it.Normal(0.0, 0.5)))
                else:
                    fg.add_factor([prev, f"x{i}"],
                                  it.LinearRelative(it.Normal(3.0, 0.5)))
                prev = f"x{i}"
            it.solve_tree(fg, mesh=mesh, distribute=dist)
            for i in range(10):
                m = float(fg.points(f"x{i}")[:, 0].mean())
                check(abs(m - 3.0 * i) < 1.0, f"{name} {dist} x{i}: {m}")
        fg = it.initfg(device=dev)
        for b in range(16):
            fg.add_variable(f"b{b}x0", it.ContinuousScalar)
            fg.add_factor([f"b{b}x0"], it.Prior(it.Normal(float(b), 0.5)),
                          graphinit=False)
            fg.add_variable(f"b{b}x1", it.ContinuousScalar)
            fg.add_factor([f"b{b}x0", f"b{b}x1"],
                          it.LinearRelative(it.Normal(1.0, 0.5)),
                          graphinit=False)
        it.solve_tree(fg, algorithm="parametric", mesh=mesh)
        for b in range(16):
            e1 = float(fg.var(f"b{b}x1").parametric_point[0])
            check(abs(e1 - (b + 1)) < 1e-3, f"{name} parametric b{b}: {e1}")
        print(f"PASS mesh {name}: particles (doors), cliques and auto "
              f"(6-branch forest, 10-variable chain), parametric tree of "
              f"16 branches at their tests' bars; {time.time() - t0:.1f} s",
              flush=True)
    dryrun_multichip(1, device=dev)
    fn, args = entry(device=dev)
    mu, _ = fn(*args)
    _sync(dev)
    check(mu.shape == (128, 2) and bool(torch.isfinite(mu).all()),
          f"entry(): {tuple(mu.shape)}")
    tree = it.solve_tree(it.generate_kaess(graphinit=True, device=dev),
                         precompile=True)
    check(tree.num_cliques() >= 1, "Kaess with precompile=True")
    print(f"PASS dryrun_multichip(1), entry() {tuple(mu.shape)}, Kaess "
          f"solve with precompile=True; mesh phase {time.time() - t0:.1f} s",
          flush=True)


def phase_batched(it, K, dev):
    """Slice 8a on the card (budget 90 s): the batched kernel launch, the
    batched N=50k forest and the N=100 batched paths, the mesh."""
    from incrementalinference_torch.parallel.mesh import Mesh, make_mesh

    t0 = time.time()
    kernel = phase_batched_kernel(K, dev)
    launches, problems, _ = phase_batched_solves(it, K, dev)
    phase_profile(it, "bench.py forest of 32, batched, N=100",
                  lambda: _bench_forest(it, dev))
    phase_mesh(it, dev, (("make_mesh() (1 device)", make_mesh()),
                         ("Mesh([cuda:0] * 4)",
                          Mesh([torch.device("cuda", 0)] * 4))))
    print(f"# phase_batched: {time.time() - t0:.1f} s", flush=True)
    return launches, problems, kernel


def _mh_single(it, mh, K, dev, scale, params, solve):
    """One solve of the anchored forest in this process: (wall, counts of
    the kernel's wrapper, |mean - truth| per variable)."""
    truth = mh.fixture_truth("anchored_forest", scale)
    fg = mh.build_fixture("anchored_forest", scale, params=params,
                          device=dev)
    K.reset_counts()
    _sync(dev)
    t0 = time.time()
    solve(fg)
    _sync(dev)
    wall = time.time() - t0
    counts = dict(K.counts)
    errs = {v: abs(float(fg.points(v)[:, 0].mean()) - mu)
            for v, mu in truth.items()}
    for v in truth:
        check(bool(torch.isfinite(fg.points(v)).all()),
              f"anchored forest {v}: non-finite particles")
    return wall, counts, errs


def _categorical_repeats(dev, n):
    """The replicated top is bit-identical in every process only if every
    draw is: keys.cdf fifty times over n probabilities, and keys.categorical
    ten times from one key, each equal bit for bit.  Beside it, what one
    whole-tensor torch.cumsum gives over the same fifty runs (the port does
    not use it), and the times of the two scans and of a host round trip."""
    from incrementalinference_torch import keys

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    logits = 3.0 * torch.randn(n, generator=gen, device=dev)
    p = torch.softmax(logits, dim=0)
    cdfs = [keys.cdf(p) for _ in range(50)]
    check(all(torch.equal(c, cdfs[0]) for c in cdfs),
          "keys.cdf: fifty scans of one input differ")
    draws = [keys.categorical(keys.make_key(9, 1), logits, n)
             for _ in range(10)]
    check(all(torch.equal(d, draws[0]) for d in draws),
          "keys.categorical: ten draws from one key differ")
    whole = len({torch.cumsum(p, dim=0).cpu().numpy().tobytes()
                 for _ in range(50)})
    ms = {"keys.cdf": cuda_ms(lambda: keys.cdf(p), 50),
          "torch.cumsum": cuda_ms(lambda: torch.cumsum(p, dim=0), 50),
          "host round trip": cuda_ms(
              lambda: torch.cumsum(p.cpu(), dim=0).to(dev), 50)}
    print(f"PASS keys.cdf over {n}: 50 scans bit-equal, ten draws of one key "
          f"equal; a whole-tensor torch.cumsum gave {whole} distinct "
          f"result(s) in 50 runs; median ms "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)


def phase_multihost(it, K, dev):
    """Slice 8b on the card (budget 150 s): two processes share the card
    and solve the anchored forest (an anchor and 4 branches of three) at
    N = 50,000 particles through parallel/multihost.py, their collectives
    over gloo on host bytes (NCCL refuses two ranks on one device);
    against the same fixture solved in this process by
    solve_tree_multihost (no process group: the partition owns everything
    and there is no top) and by solve_tree with batch_cliques=False.  Bars
    of tests/test_multihost.py:244-261: each process's max |mean - truth|
    under max(1, 3 x the one-process error), the processes within 1e-6 of
    each other, every process launching the kernel; and the launch
    identity of the warm solve, p0 + p1 = one process + the top (the top
    is solved by both, the same count in each).  Then, at N=64, the fault
    flood (both processes end in "error" within 200 s) and the parametric
    variant (max error < 0.35, the processes within 1e-6, no launch), on
    the card too.  Returns the launches by path."""
    from incrementalinference_torch.ops import product
    from incrementalinference_torch.parallel import multihost as mh

    N, scale = 50_000, 4
    t_phase = time.time()
    check(N * N >= product.LARGE_PAIR_THRESHOLD,
          f"multihost: N={N} no longer exceeds the large-pair threshold")
    truth = mh.fixture_truth("anchored_forest", scale)
    torch.cuda.empty_cache()
    _categorical_repeats(dev, N)

    t0 = time.time()
    reps = mh.launch_multihost(2, "anchored_forest", scale=scale, N=N,
                               devices_per_proc=1, device=str(dev),
                               timeout=600)
    launch_wall = time.time() - t0
    reps.sort(key=lambda r: r["pid"])
    check([r["pid"] for r in reps] == [0, 1], "multihost: two reports")

    # the same fixture in this process, recording what the solve hands the
    # kernel's wrapper (held against the plain version below)
    handed = []
    wrapper = product.pair_row_logsumexp

    def recording(muA, precA, muB, precB):
        handed[:] = _one_member(muA, precA, muB, precB)
        return wrapper(muA, precA, muB, precB)

    product.pair_row_logsumexp = recording
    try:
        w_mh, c_mh, errs = _mh_single(it, mh, K, dev, scale,
                                      it.SolverParams(N=N),
                                      mh.solve_tree_multihost)
    finally:
        product.pair_row_logsumexp = wrapper
    w_st, c_st, errs_st = _mh_single(
        it, mh, K, dev, scale, it.SolverParams(N=N, batch_cliques=False),
        it.solve_tree)
    single = max(errs.values())
    bar = max(1.0, 3.0 * single)
    print(f"PASS anchored forest N={N} ({len(truth)} variables) in this "
          f"process: solve_tree_multihost {w_mh:.3f} s, "
          f"{c_mh['launches']} launches, max err {single:.4f}; "
          f"solve_tree(batch_cliques=False) {w_st:.3f} s, "
          f"{c_st['launches']} launches, max err "
          f"{max(errs_st.values()):.4f}", flush=True)
    check(c_mh["launches"] > 0,
          "the one-process multihost solve launched no kernel")

    for r in reps:
        for phase in ("cold", "warm"):
            rp = r[phase]
            tm = rp["timings"]
            check(rp["max_err"] < bar, f"multihost p{r['pid']} {phase}: "
                  f"max err {rp['max_err']} over the bar {bar}")
            check(sum(tm["kernel_launches"].values()) > 0,
                  f"multihost p{r['pid']} {phase}: no kernel launch")
            check(r["device"].startswith("cuda"),
                  f"multihost p{r['pid']} ran on {r['device']}")
            print(f"multihost p{r['pid']} {phase}: total {tm['total_s']:.3f}"
                  f" s (local up {tm['local_up_s']:.3f}, exchange "
                  f"{tm['exchange_up_s']:.4f}, top {tm['top_s']:.3f}, local "
                  f"down {tm['local_down_s']:.3f}, sync {tm['sync_s']:.4f});"
                  f" {tm['local_cliques']} local cliques, {tm['init_passes']}"
                  f" init pass(es); bytes cut {tm.get('bytes_cut')}, sync "
                  f"{tm.get('bytes_sync')}; collectives "
                  f"{rp['collectives']['count']} in "
                  f"{rp['collectives']['wall_s']:.4f} s; kernel launches "
                  f"{tm['kernel_launches']}; max err {rp['max_err']:.4f}",
                  flush=True)
        print(f"multihost p{r['pid']} collective latency (median of 20): "
              f"8 B {r['collective_latency_s']['8B'] * 1e3:.3f} ms, 16 kB "
              f"{r['collective_latency_s']['16kB'] * 1e3:.3f} ms",
              flush=True)
    for phase in ("cold", "warm"):
        diff = abs(reps[0][phase]["max_err"] - reps[1][phase]["max_err"])
        check(diff < 1e-6, f"multihost {phase}: the processes' max errors "
                           f"differ by {diff}")
    for v, m in reps[0]["warm"]["means"].items():
        check(abs(m - reps[1]["warm"]["means"][v]) < 1e-6,
              f"multihost warm {v}: the processes' means differ")

    # the launch identity of the warm solve
    per = [reps[i]["warm"]["timings"]["kernel_launches"] for i in (0, 1)]
    top = [p["top"] for p in per]
    check(top[0] == top[1], f"multihost: the top's launches differ between "
                            f"the processes: {top}")
    both = sum(sum(p.values()) for p in per)
    one = c_mh["launches"]
    check(both == one + top[0],
          f"multihost: p0 + p1 = {both} launches, one process {one} + the "
          f"top {top[0]} = {one + top[0]}")
    print(f"PASS two processes on one card solve the "
          f"anchored forest N={N} at the bars of tests/test_multihost.py "
          f"(bar {bar:.3f}; max errs warm {reps[0]['warm']['max_err']:.4f},"
          f" {reps[1]['warm']['max_err']:.4f}); warm launches: p0 "
          f"{per[0]}, p1 {per[1]}, sum {both} = one process {one} + top "
          f"{top[0]}; launch wall {launch_wall:.1f} s", flush=True)

    check(handed, "multihost: the kernel was handed nothing")
    if handed:
        a2, iva, ivm = K.pair_row_terms(*handed)
        muB = handed[2].contiguous()
        got = K.row_logsumexp(a2.contiguous(), iva.contiguous(),
                              ivm.contiguous(), muB)
        ref = K.row_logsumexp_plain(a2, iva, ivm, muB)
        rel = rel_err(got, ref)
        check(bool(torch.isfinite(got).all()) and rel <= _TOL,
              f"multihost: kernel vs plain on the solve's inputs, rel err "
              f"{rel:.3e}")
        print(f"PASS kernel vs plain on the inputs the anchored forest's "
              f"solve handed it ({muB.shape[0]} x {muB.shape[0]}, dof "
              f"{muB.shape[1]}): rel err {rel:.3e}", flush=True)

    # two small checks at N=64
    fg = mh.build_fixture("anchored_forest", 6, device=dev)
    from incrementalinference_torch.graphinit import ensure_solvable, init_all
    ensure_solvable(fg)
    init_all(fg)
    part = mh.partition_tree(it.build_tree_reset(fg), 2)
    victim = next(c for c in part.cut_roots if part.owner[c] == 0)
    t0 = time.time()
    reps_f = mh.launch_multihost(2, "anchored_forest", scale=6,
                                 devices_per_proc=1, timeout=200,
                                 fail_clique=victim, device=str(dev))
    flood = time.time() - t0
    outcomes = {r["pid"]: r["fault"]["outcome"] for r in reps_f}
    check(outcomes == {0: "error", 1: "error"} and flood < 200,
          f"multihost fault flood: {outcomes} in {flood:.1f} s")
    t0 = time.time()
    reps_p = mh.launch_multihost(2, "anchored_forest", scale=6,
                                 devices_per_proc=1, timeout=300,
                                 algorithm="parametric",
                                 device=str(dev))
    param_wall = time.time() - t0
    for r in reps_p:
        check(r["warm"]["max_err"] < 0.35,
              f"multihost parametric p{r['pid']}: {r['warm']['max_err']}")
        check(sum(r["cold"]["timings"]["kernel_launches"].values()) == 0
              and sum(r["warm"]["timings"]["kernel_launches"].values()) == 0,
              "multihost parametric launched the kernel")
    check(abs(reps_p[0]["warm"]["max_err"] - reps_p[1]["warm"]["max_err"])
          < 1e-6, "multihost parametric: the processes differ")
    print(f"PASS multihost at N=64 on the card: fault at clique {victim} "
          f"flooded both processes to 'error' in {flood:.1f} s; parametric "
          f"max err {reps_p[0]['warm']['max_err']:.4f}, "
          f"{reps_p[1]['warm']['max_err']:.4f}, no launch ({param_wall:.1f}"
          f" s)", flush=True)
    print(f"# phase_multihost: {time.time() - t_phase:.1f} s", flush=True)
    return {f"multihost anchored forest N={N}, 2 processes, warm solve "
            f"(p0, p1; the top {top[0]} in each)":
                [sum(p.values()) for p in per],
            f"multihost anchored forest N={N}, one process "
            f"(solve_tree_multihost; solve_tree per clique)":
                [one, c_st["launches"]]}


def timing_inputs(K, n, dof, dev):
    """Row terms shaped like the solve's products: unit-scale particles,
    bandwidth ~ 0.3."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    muA = torch.randn((n, dof), generator=gen, device=dev)
    muB = torch.randn((n, dof), generator=gen, device=dev)
    prec = torch.full((n, dof), 11.0, device=dev)
    a2, iva, ivm = K.pair_row_terms(muA, prec, muB, prec)
    return a2.contiguous(), iva.contiguous(), ivm.contiguous(), muB


def bound_ms(n, dof):
    """Least milliseconds the card could take for n x n pairs: the larger
    of bytes over the memory rate, FP32 operations over the FP32 rate and
    one exp per pair over the MUFU rate.  Returns (bound, bytes, fp32, exp)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pairs = n * n
    bytes_moved = 4 * (n * (1 + 2 * dof) + n * dof + n)
    flops = pairs * (4 * dof + 4)
    t_bytes = bytes_moved / _HBM_BPS * 1e3
    t_flops = flops / _FP32_FLOPS * 1e3
    t_exp = pairs / (sms * _MUFU_PER_SM_CLK * _BOOST_HZ) * 1e3
    return max(t_bytes, t_flops, t_exp), t_bytes, t_flops, t_exp


def library_row_logsumexp(a2, iva, ivm, muB):
    """The library route to the same function: the (Na, Nb) weights by two
    addmm calls, then torch.logsumexp.  Timed only, never used by the
    port."""
    w = torch.addmm(a2[:, None], iva, (muB * muB).T)
    w.addmm_(ivm, muB.T, alpha=-2.0).mul_(-0.5)
    return torch.logsumexp(w, dim=1)


def time_three_ways(K, a2, iva, ivm, muB, tag):
    """Kernel, plain version and library route on one set of row terms:
    their agreement and CUDA-event times, beside the bound of the shape."""
    n, dof = muB.shape
    got = K.row_logsumexp(a2, iva, ivm, muB)
    ref = K.row_logsumexp_plain(a2, iva, ivm, muB)
    max_abs = float((got - ref).abs().max())
    rel = rel_err(got, ref)
    check(rel <= _TOL, f"{tag}: kernel vs plain rel err {rel:.3e}")

    k_ms = cuda_ms(lambda: K.row_logsumexp(a2, iva, ivm, muB), reps=20)
    p_ms = cuda_ms(lambda: K.row_logsumexp_plain(a2, iva, ivm, muB), reps=5)

    def library():
        return library_row_logsumexp(a2, iva, ivm, muB)

    lib_out = library()
    check(rel_err(lib_out, ref) <= _TOL, f"{tag}: library route disagrees")
    del lib_out
    l_ms = cuda_ms(library, reps=3, warmup=1)
    torch.cuda.empty_cache()

    bound, t_bytes, t_flops, t_exp = bound_ms(n, dof)
    print(f"row_logsumexp {tag}: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, library {l_ms:.4f} ms; bound {bound:.4f} ms "
          f"(bytes {t_bytes:.5f}, fp32 {t_flops:.4f}, exp {t_exp:.4f} ms); "
          f"max abs err {max_abs:.3e}, rel {rel:.3e}", flush=True)
    return {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= max(t_flops, t_exp)
            else "operations",
            "library_ms": l_ms}


def phase_timing(K, dev, launches, launches_by_path, handed_by_path):
    """Kernel, plain and library times at the main path's shape and on the
    inputs the SE(2) and SE(3) solves handed the kernel, and the kernel
    beside its bound at four more shapes."""
    main = time_three_ways(K, *timing_inputs(K, 50_000, 1, dev),
                           "50k x 50k dof 1")
    by_shape = []
    for path, (n_launches, handed) in handed_by_path.items():
        a2, iva, ivm = K.pair_row_terms(*handed)
        muB = handed[2].contiguous()
        entry = time_three_ways(
            K, a2.contiguous(), iva.contiguous(), ivm.contiguous(), muB,
            f"{path}, {muB.shape[0]} x {muB.shape[0]} dof {muB.shape[1]} "
            f"(the solve's own inputs)")
        by_shape.append({"path": path, "n": muB.shape[0],
                         "dof": muB.shape[1], "launches": n_launches,
                         **entry})
    for n2, dof2 in ((50_000, 3), (65_536, 3), (33_000, 6), (50_000, 8)):
        args = timing_inputs(K, n2, dof2, dev)
        ms = cuda_ms(lambda: K.row_logsumexp(*args), reps=20)
        b2, _, f2, e2 = bound_ms(n2, dof2)
        print(f"row_logsumexp {n2} x {n2} dof {dof2}: kernel {ms:.4f} ms; "
              f"bound {b2:.4f} ms (fp32 {f2:.4f}, exp {e2:.4f} ms)",
              flush=True)
    return {"name": "row_logsumexp", "route": "cuda",
            "source": "incrementalinference_torch/ops/kernels/csrc/"
                      "row_lse.cu",
            "replaces": "incrementalinference/jl_tpu/ops/kernels/"
                        "pallas_product.py:27",
            "launches": launches, "launches_by_path": launches_by_path,
            **main, "by_shape": by_shape}


def phase_sass(K, dof=1):
    """Instruction slots per pair in the kernel's inner loop, counted in the
    SASS of the built library: the instructions of the innermost loop that holds
    MUFU.EX2, less those a forward branch skips (the rare move of m_ref),
    over the pairs a lane covers per trip."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("SASS inner loop: not measured (no cuobjdump)")
        return
    sass = subprocess.run([tool, "-sass", K.LIBRARY.path()], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass)[1:]
                if f"row_lse_partialILi{dof}E" in f.split("\n", 1)[0])
    ops = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    index = {addr: i for i, (addr, _) in enumerate(ops)}

    def target(op):
        m = re.search(r"BRA (0x[0-9a-f]+)", op)
        return index.get(int(m.group(1), 16)) if m else None

    loops = [(target(op), i) for i, (_, op) in enumerate(ops)
             if target(op) is not None and target(op) <= i]
    loops = [(a, b) for a, b in loops
             if any("MUFU.EX2" in op for _, op in ops[a:b + 1])]
    check(loops, "no loop with MUFU.EX2 in the kernel's SASS")
    a, b = min(loops, key=lambda ab: ab[1] - ab[0])
    hot, i = [], a
    while i <= b:
        op = ops[i][1]
        hot.append(op)
        t = target(op)
        i = t if (t is not None and i < t <= b and op.startswith("@")) \
            else i + 1
    mix = collections.Counter(
        op.split()[1 if op.startswith("@") else 0].split(".")[0]
        for op in hot)
    lib = K.build()
    # rows a warp owns (8 warps a block) x columns a lane owns per chunk
    pairs = (lib.row_lse_rows_per_block(dof) // 8
             * lib.row_lse_chunk_cols(dof) // 32)
    print(f"SASS inner loop dof {dof}: {len(hot)} instructions on the "
          f"common path ({b - a + 1} in the loop) for {pairs} pairs a lane "
          f"= {len(hot) / pairs:.2f} instruction slots per pair; "
          f"{dict(mix.most_common(8))}", flush=True)


def _device_busy_us(spans):
    """Microseconds covered by the union of (start, end) spans."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def phase_profile(it, name, make_graph, host=True, solve=None):
    """One more warm solve under torch.profiler: the share of the window
    in which the device was busy, and where device and host time went.
    The profiler's own hooks slow the host, so the window is longer than
    the warm wall printed above.  ``host=False`` traces the device only:
    a solve of several hundred thousand launches stays near its own wall,
    and the host operators are not listed.  ``solve`` (default
    ``it.solve_tree``) is the entry point the graph goes through."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fg = make_graph()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.time()
        (solve or it.solve_tree)(fg)
        torch.cuda.synchronize()
        window_us = (time.time() - t0) * 1e6
    device, spans = {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        spans.append((s, e))
        calls, total = device.get(ev.name, (0, 0.0))
        device[ev.name] = (calls + 1, total + (e - s))
    check(spans, f"{name}: the profiler saw no device operation")
    busy_us = _device_busy_us(spans)
    print(f"PROFILE {name}: window {window_us / 1e3:.1f} ms under the "
          f"profiler, device busy {busy_us / 1e3:.1f} ms = "
          f"{100 * busy_us / window_us:.1f} %, {len(spans)} device "
          f"operations", flush=True)
    print(f"  top device operations of {name} (calls, total ms):")
    for op, (calls, total) in sorted(device.items(),
                                     key=lambda kv: -kv[1][1])[:10]:
        print(f"    {calls:7d} {total / 1e3:10.3f}  {op[:100]}")
    if host:
        ops = [a for a in prof.key_averages()
               if a.device_type == DeviceType.CPU]
        print(f"  top host operators of {name} by self CPU time "
              f"(calls, self ms):")
        for a in sorted(ops, key=lambda a: -a.self_cpu_time_total)[:10]:
            print(f"    {a.count:7d} {a.self_cpu_time_total / 1e3:10.3f}  "
                  f"{a.key[:100]}")
    sys.stdout.flush()


class _Counting:
    """Counts the calls of one function of a module while it is entered
    (here: the parametric solver's Jacobian evaluations, one an LM
    iteration, and its residual-only evaluations)."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls = owner, name, 0

    def __enter__(self):
        fn = self.orig = getattr(self.owner, self.name)

        def counted(*a, **k):
            self.calls += 1
            return fn(*a, **k)

        setattr(self.owner, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def _line_truth(fg, dev):
    """A LineStep variable's id is its position."""
    return torch.tensor([float(v[1:] if v[0] == "x" else v[2:])
                         for v in fg.ls()], device=dev)


def _param_points(fg):
    return torch.stack([fg.var(v).parametric_point for v in fg.ls()])


def phase_param_linestep(it, K, dev, n=1000):
    """LineStep(n) without graphinit through solve_graph_parametric: cold
    (the first parametric solve of the process) and warm, each on a fresh
    build; a warm solve split into problem build, LM and covariance; then
    the CG solve.  Returns the kernel launches of the phase (0)."""
    from incrementalinference_torch.canonical import generate_line_step
    from incrementalinference_torch.parametric import solver as ps

    K.reset_counts()
    # the first calls of the linear algebra the solve uses, where they
    # stand in the process (earlier phases may have loaded the libraries)
    t0 = time.time()
    a = 2.0 * torch.eye(4, device=dev)
    torch.linalg.cholesky(a)
    torch.linalg.inv(a)
    torch.linalg.solve_ex(a, a[:, :1])
    torch.cuda.synchronize()
    t_linalg = time.time() - t0
    walls = []
    with _Counting(ps._Batch, "res_jac") as jac:
        for _ in range(2):
            fg = generate_line_step(n, graphinit=False, device=dev)
            torch.cuda.synchronize()
            t0 = time.time()
            it.solve_graph_parametric(fg)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
    truth = _line_truth(fg, dev)
    dense = _param_points(fg)[:, 0]
    worst = float((dense - truth).abs().max())
    covs = torch.stack([fg.var(v).parametric_cov[0, 0] for v in fg.ls()])
    check(worst < 1e-2, f"LineStep({n}) parametric: max |x_i - i| {worst}")
    check(bool(torch.isfinite(covs).all() and (covs > 0).all()),
          f"LineStep({n}) parametric: a covariance not finite and > 0")

    fg = generate_line_step(n, graphinit=False, device=dev)
    torch.cuda.synchronize()
    split = [time.time()]
    prob = ps.ParametricProblem(fg)
    torch.cuda.synchronize()
    split.append(time.time())
    prob.solve(compute_cov=False)
    torch.cuda.synchronize()
    split.append(time.time())
    bt = ps._Batch([prob])
    bt.cov(bt.p0s)
    torch.cuda.synchronize()
    split.append(time.time())

    fc = generate_line_step(n, graphinit=False, device=dev)
    torch.cuda.synchronize()
    with _Counting(ps, "_cg") as steps:
        t0 = time.time()
        it.solve_graph_parametric(fc, solver="cg", compute_cov=False)
        torch.cuda.synchronize()
        t_cg = time.time() - t0
    cg = _param_points(fc)[:, 0]
    to_dense = float((cg - dense).abs().max())
    check(to_dense < 1e-2, f"LineStep({n}) CG: {to_dense} from the dense "
                           f"solve (bar 1e-2)")
    launches = K.counts["launches"]
    check(launches == 0, f"the parametric LineStep launched the kernel "
                         f"{launches} times")
    print(f"PASS parametric LineStep({n}) solve_graph_parametric on CUDA "
          f"({prob.total_dof} tangent dims, {prob.n_residuals} residuals): "
          f"cold {walls[0]:.3f} s, warm {walls[1]:.3f} s ({jac.calls} "
          f"Jacobian evaluations in the two: LM iterations and the "
          f"covariance); first linear-algebra calls at the start of the "
          f"phase {t_linalg:.3f} s; a warm solve split: problem build "
          f"{split[1] - split[0]:.3f} s, LM {split[2] - split[1]:.3f} s, "
          f"covariance {split[3] - split[2]:.3f} s; "
          f"max |x_i - i| {worst:.3e}; kernel launches {launches}",
          flush=True)
    print(f"PASS parametric LineStep({n}) solver='cg', compute_cov=False: "
          f"{t_cg:.3f} s ({steps.calls} LM iterations of up to 200 CG "
          f"iterations each); max |cg - dense| "
          f"{to_dense:.3e}, max |x_i - i| "
          f"{float((cg - truth).abs().max()):.3e}", flush=True)
    return launches


_SE3_CHAIN_STEP = [1.0, 0.0, 0.05, 0.0, 0.0, 0.02]


def _se3_chain(it, n, dev):
    """benchmarks/parametric_scale.py's SE(3) chain: a ManifoldPrior at the
    identity, then n - 1 ManifoldFactor steps, sigma 0.01 everywhere."""
    import numpy as np

    M = it.SE3()
    vt = it.VariableType("Pose3", M)
    fg = it.initfg(it.SolverParams(N=8, graphinit=False), device=dev)
    fg.add_variable("x0", vt)
    fg.add_factor(["x0"], it.ManifoldPrior(M, M.identity(), it.MvNormal(
        np.zeros(6), [0.01] * 6)), graphinit=False)
    for i in range(1, n):
        fg.add_variable(f"x{i}", vt)
        fg.add_factor([f"x{i - 1}", f"x{i}"], it.ManifoldFactor(
            M, it.MvNormal(_SE3_CHAIN_STEP, [0.01] * 6)), graphinit=False)
    return fg


def phase_param_se3(it, K, dev, n=30):
    """The SE(3) chain through autoinit_parametric and solve_graph_parametric,
    then the solve alone on a fresh graph seeded with the autoinit points.
    Returns the kernel launches of the phase (0)."""
    from incrementalinference_torch.parametric import solver as ps

    M = it.SE3()
    K.reset_counts()
    fg = _se3_chain(it, n, dev)
    torch.cuda.synchronize()
    with _Counting(ps, "_solve_batch") as rounds, \
            _Counting(ps._Batch, "res_jac") as auto_jac:
        t0 = time.time()
        it.autoinit_parametric(fg)
        torch.cuda.synchronize()
        t_auto = time.time() - t0
    seeds = {v: fg.var(v).parametric_point.clone() for v in fg.ls()}
    t0 = time.time()
    it.solve_graph_parametric(fg)
    torch.cuda.synchronize()
    t_solve = time.time() - t0
    fresh = _se3_chain(it, n, dev)
    for v, p in seeds.items():
        fresh.var(v).parametric_point = p
    torch.cuda.synchronize()
    with _Counting(ps._Batch, "res_jac") as jac:
        t0 = time.time()
        it.solve_graph_parametric(fresh)
        torch.cuda.synchronize()
        t_lm = time.time() - t0
    cur, worst, asym = M.identity(dev), 0.0, 0.0
    step = torch.tensor(_SE3_CHAIN_STEP, device=dev)
    for i in range(n):
        v = f"x{i}"
        worst = max(worst, float(torch.linalg.norm(
            fresh.var(v).parametric_point[:3] - cur[:3])))
        C = fresh.var(v).parametric_cov
        check(bool(torch.isfinite(C).all()), f"SE(3) chain {v}: covariance "
                                             f"not finite")
        asym = max(asym, float((C - C.T).abs().max() / C.abs().max()))
        check(bool((torch.linalg.eigvalsh(0.5 * (C + C.T)) > 0).all()),
              f"SE(3) chain {v}: covariance not positive definite")
        cur = M.exp(cur, step)
    check(asym < 1e-4, f"SE(3) chain: covariance asymmetry {asym}")
    check(worst < 2.0, f"SE(3) chain: translation error {worst} (bar 2.0)")
    launches = K.counts["launches"]
    check(launches == 0, f"the SE(3) chain launched the kernel {launches} "
                         f"times")
    print(f"PASS parametric SE(3) chain of {n} poses on CUDA: "
          f"autoinit_parametric {t_auto:.3f} s ({rounds.calls} LM solves, "
          f"{auto_jac.calls} Jacobian evaluations), "
          f"then solve_graph_parametric {t_solve:.3f} s; the solve alone "
          f"from the autoinit points {t_lm:.3f} s ({jac.calls} Jacobian "
          f"evaluations); max translation error against the composed step "
          f"{worst:.4f} over {float(torch.linalg.norm(cur[:3])):.1f} units "
          f"end to end; covariance asymmetry {asym:.2e}; kernel launches "
          f"{launches}", flush=True)
    return launches


def _param_forest(it, dev, branches=32):
    """bench.py's wide forest: 32 branches of a Prior and a LinearRelative."""
    fg = it.initfg(it.SolverParams(batch_cliques=False), device=dev)
    for b in range(branches):
        fg.add_variable(f"b{b}x0", it.ContinuousScalar)
        fg.add_factor([f"b{b}x0"], it.Prior(it.Normal(float(b), 0.5)))
        fg.add_variable(f"b{b}x1", it.ContinuousScalar)
        fg.add_factor([f"b{b}x0", f"b{b}x1"],
                      it.LinearRelative(it.Normal(1.0, 0.5)))
    return fg


def phase_param_forest(it, K, dev, branches=32):
    """The forest through solve_tree(algorithm="parametric"): two fresh
    graphs, then the second one re-solved.  Returns the kernel launches of
    the phase (0)."""
    K.reset_counts()
    walls, batches = [], []
    for fresh in (True, True, False):
        if fresh:
            fg = _param_forest(it, dev, branches)
        torch.cuda.synchronize()
        t0 = time.time()
        tree = it.solve_tree(fg, algorithm="parametric")
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        batches.append(list(tree.param_batches))
        for b in range(branches):
            e0 = float(fg.var(f"b{b}x0").parametric_point[0])
            e1 = float(fg.var(f"b{b}x1").parametric_point[0])
            check(abs(e0 - b) < 1e-3 and abs(e1 - (b + 1)) < 1e-3,
                  f"forest branch {b}: {e0}, {e1}")
    launches = K.counts["launches"]
    check(launches == 0, f"the parametric forest launched the kernel "
                         f"{launches} times")
    print(f"PASS parametric forest of {branches} branches "
          f"solve_tree(algorithm='parametric') on CUDA: fresh graph "
          f"{walls[0]:.3f} s (first), {walls[1]:.3f} s; same-graph re-solve "
          f"{walls[2]:.3f} s; {tree.num_cliques()} cliques; problems per "
          f"batched LM call, in order: {batches[1]}; kernel launches "
          f"{launches}", flush=True)
    return launches


def phase_param_jacobians(it, dev, n=60):
    """What a Jacobian of the SE(3) chain's relative-factor group (n - 1
    ManifoldFactor rows) costs three ways: through
    vmap(jacrev(..., has_aux=True)), as the solver takes it; through
    vmap(jacfwd(..., has_aux=True)), the forward mode it took before its
    Jacobians left PyTorch's process-wide forward-AD level; and by reverse
    mode with the residual's rows batched on a leading axis (one backward
    pass).  Median milliseconds of host clock around synchronized calls,
    and the largest difference from the solver's."""
    from torch.func import jacfwd, jacrev, vmap

    M = it.SE3()
    F, z = n - 1, M.dof
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    a = M.exp(M.identity(dev).expand(F, 7),
              0.3 * torch.randn((F, 6), generator=gen, device=dev))
    b = M.exp(a, torch.randn((F, 6), generator=gen, device=dev))
    meas = torch.randn((F, 6), generator=gen, device=dev)
    xl = torch.zeros((F, 12), device=dev)

    def res(x, p1, p2, zz):
        return M.log(M.exp(p1, x[..., :6]), M.exp(p2, x[..., 6:])) - zz

    def with_aux(x, p1, p2, zz):
        r = res(x, p1, p2, zz)
        return r, r

    solver = vmap(jacrev(with_aux, has_aux=True))
    forward = vmap(jacfwd(with_aux, has_aux=True))

    def batched():
        X = xl.expand(z, F, 12).clone().requires_grad_(True)
        with torch.enable_grad():
            out = res(X, a, b, meas)                           # (z, F, z)
            (g,) = torch.autograd.grad(
                torch.diagonal(out, dim1=0, dim2=2).sum(), X)
        return g.permute(1, 0, 2)

    times = {}
    for name, fn in (("vmap(jacrev)", lambda: solver(xl, a, b, meas)[0]),
                     ("vmap(jacfwd)", lambda: forward(xl, a, b, meas)[0]),
                     ("batched reverse", batched)):
        fn()
        runs = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.time()
            J = fn()
            torch.cuda.synchronize()
            runs.append((time.time() - t0) * 1e3)
        times[name] = (statistics.median(runs), J)
    ref = times["vmap(jacrev)"][1]
    diffs = {k: float((v[1] - ref).abs().max()) for k, v in times.items()
             if k != "vmap(jacrev)"}
    check(max(diffs.values()) < 1e-3, f"the Jacobians differ by {diffs}")
    print(f"SE(3) relative-factor group Jacobian, {F} factors, on CUDA: "
          + ", ".join(f"{k} {v[0]:.2f} ms" for k, v in times.items())
          + f" (median of 10); max difference from vmap(jacrev) "
          f"{ {k: float(f'{d:.2e}') for k, d in diffs.items()} }",
          flush=True)


def phase_param_tree(it, K, dev, hexagon):
    """The parametric tree solve of the hexagon phase 6 solved (seeded from
    its beliefs), and the chain of tests/test_parametric.py:219-262 grown
    from 8 to 9 poses and re-solved with old_tree.  Returns the kernel
    launches of the phase (0)."""
    K.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    it.solve_tree(hexagon, algorithm="parametric")
    torch.cuda.synchronize()
    t_hex = time.time() - t0
    x6 = hexagon.var("x6").parametric_point
    r6 = float(torch.linalg.norm(x6[:2]))
    check(r6 < 1.5, f"parametric hexagon: |x6[:2]| = {r6} (bar 1.5)")

    def chain(n):
        fg = it.initfg(it.SolverParams(incremental=True, graphinit=False),
                       device=dev)
        fg.add_variable("x0", it.ContinuousScalar)
        fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 0.5)), graphinit=False)
        for i in range(n):
            fg.add_variable(f"x{i + 1}", it.ContinuousScalar)
            fg.add_factor([f"x{i}", f"x{i + 1}"],
                          it.LinearRelative(it.Normal(1.0, 0.1)),
                          graphinit=False)
        return fg

    fg = chain(8)
    tree = it.solve_tree(fg, algorithm="parametric")
    fg.add_variable("x9", it.ContinuousScalar)
    fg.add_factor(["x8", "x9"], it.LinearRelative(it.Normal(1.0, 0.1)),
                  graphinit=False)
    torch.cuda.synchronize()
    t0 = time.time()
    tree = it.solve_tree(fg, algorithm="parametric", old_tree=tree)
    torch.cuda.synchronize()
    t_grow = time.time() - t0
    recycled = sum(cl.is_recycled for cl in tree.cliques.values())
    check(recycled >= 3, f"parametric chain: {recycled} recycled cliques")
    fresh = chain(9)
    it.solve_tree(fresh, algorithm="parametric")
    diff = float((_param_points(fg) - _param_points(fresh)).abs().max())
    check(diff < 1e-3, f"parametric chain: {diff} from a solve from scratch")
    launches = K.counts["launches"]
    check(launches == 0, f"the parametric tree solves launched the kernel "
                         f"{launches} times")
    print(f"PASS parametric tree solves on CUDA: hexagon {t_hex:.3f} s, "
          f"|x6[:2]| = {r6:.4f}; chain 8 -> 9 with old_tree {t_grow:.3f} s, "
          f"{recycled} of {tree.num_cliques()} cliques recycled, max "
          f"{diff:.2e} from a solve from scratch; kernel launches "
          f"{launches}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import incrementalinference_torch as it
    from incrementalinference_torch.ops.kernels import row_lse as K

    t_all = time.time()
    dev = torch.device("cuda")
    print(f"# device {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from incrementalinference_torch import native

    t0 = time.time()
    K.build(verbose=True)
    nvcc_s = "cached" if K.build_seconds is None else \
        f"{K.build_seconds:.3f}"
    print(f"PASS build: {time.time() - t0:.2f} s (nvcc {nvcc_s} s, "
          f"{os.path.basename(K.LIBRARY.path())})", flush=True)
    check(native.native_available(), "the native elimination ordering did "
          "not build: the solves would run on the Python heuristic's tree")
    gxx_s = "cached" if native.build_seconds is None else \
        f"{native.build_seconds:.3f}"
    print(f"PASS native ordering built (g++ {gxx_s} s, "
          f"{os.path.basename(native.LIBRARY.path())})", flush=True)
    from incrementalinference_torch.ops.kernels import pair_draw

    t0 = time.time()
    pair_draw.build(verbose=True)
    draw_s = "cached" if pair_draw.build_seconds is None else \
        f"{pair_draw.build_seconds:.3f}"
    print(f"PASS build of the column draw: {time.time() - t0:.2f} s (nvcc "
          f"{draw_s} s, {os.path.basename(pair_draw.LIBRARY.path())})",
          flush=True)
    phase_sass(K)

    phase_compare(K, dev)
    phase_linestep(it, K)
    _, launches = phase_large(it, K)
    phase_warmstart(it, K)
    phase_condense(it, K, dev)
    phase_precision(it, K)
    threads_by_path = phase_threads(it, K)
    fd_launches = phase_examples(it, K)
    for tol in (0.0, 0.6):
        phase_growing_chain(it, "cuda", tol)
    _, hexagon, hex_tree = phase_hexagonal(it)
    phase_circular(it)
    by_path, handed_by_path, solved = dict(threads_by_path), {}, []
    for M, name, step, sigma, N in _manifold_setups():
        _, n_launches, handed, (fg, truth) = phase_manifold_large(
            it, K, M, name, step, sigma, N)
        path = f"{name} two-pose N={N}, one solve"
        by_path[path] = n_launches
        handed_by_path[path] = (n_launches, handed)
        solved.append((M, name, N, fg, truth))
    phase_ppe(it, solved)
    phase_kde_kernel()
    phase_draw_kernel()
    del solved, fg
    phase_joint(it)
    t_new = time.time()
    by_path["flux mixture N=50000 (dof 1), one solve"] = \
        phase_flux_mixture(it, K)
    by_path["forced ODE N=50000 (dof 1), one solve"] = \
        phase_forced_ode(it, K)
    n_heat, handed = phase_heatmap(it, K)
    path = "heatmap landmark N=50000 (dof 2), one solve"
    by_path[path] = n_heat
    handed_by_path[path] = (n_heat, handed)
    phase_surfaces(it, K, hexagon, hex_tree)
    del hex_tree
    print(f"# slices 7 and 9a phases: {time.time() - t_new:.1f} s",
          flush=True)
    by_path["persistence: loaded N=50000 graph re-solved with the loaded "
            "tree"] = phase_persistence(it, K)
    b_launches, b_problems, batched = phase_batched(it, K, dev)
    by_path["batched level: forest of 8 two-variable branches N=50000, "
            f"one warm solve ({b_problems} problems)"] = b_launches
    by_path.update(phase_multihost(it, K, dev))
    by_path["parametric LineStep(1000), dense and cg"] = \
        phase_param_linestep(it, K, dev)
    by_path["parametric SE(3) chain of 30, autoinit and solves"] = \
        phase_param_se3(it, K, dev)
    phase_param_jacobians(it, dev)
    by_path["parametric forest of 32, three tree solves"] = \
        phase_param_forest(it, K, dev)
    by_path["parametric hexagon and chain tree solves"] = \
        phase_param_tree(it, K, dev, hexagon)
    del hexagon
    entry = phase_timing(K, dev, launches, {
        "two-variable N=50000, one solve": launches,
        "fourdoor N=50000, solves 1-3": fd_launches, **by_path},
        handed_by_path)
    entry["batched"] = batched
    del handed_by_path
    from incrementalinference_torch.canonical import generate_line_step
    phase_profile(it, "LineStep(20) N=100", lambda: generate_line_step(
        20, graphinit=True, device="cuda"))
    phase_profile(it, "two-variable N=50000",
                  lambda: _two_var_graph(it, 50_000))
    for M, name, step, sigma, N in _manifold_setups():
        phase_profile(it, f"{name} two-pose N={N}", lambda: _two_pose_graph(
            it, M, name, step, sigma, N)[0], host=False)
    phase_profile(it, "parametric LineStep(1000) solve_graph_parametric",
                  lambda: generate_line_step(1000, graphinit=False,
                                             device="cuda"),
                  solve=it.solve_graph_parametric)
    phase_profile(it, "parametric forest of 32 solve_tree",
                  lambda: _param_forest(it, "cuda"),
                  solve=lambda fg: it.solve_tree(fg, algorithm="parametric"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"# total {time.time() - t_all:.1f} s")
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
