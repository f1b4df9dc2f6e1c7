#!/usr/bin/env python3
"""Smoke run of the PyTorch port (incrementalinference_torch) on one GPU.

Usage, from the root of the repository, on a machine with an H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line; none is caught):
1. build the row-logsumexp CUDA kernel from ops/kernels/csrc/row_lse.cu,
   check that the native elimination ordering built (without it the tree,
   and so the walls, would be those of the Python heuristic), and count
   the instruction slots per pair of the kernel's inner loop in its SASS;
2. hold the kernel against its plain PyTorch version on the card, at the
   reference's check points (n, dof) of benchmarks/pallas_tpu_check.py, a
   zero-precision partial-dims case, n = 65536, the N = 50k solve's shape,
   and the cases its base-2 lazy-rescale arithmetic could get wrong (rows
   far from every B kernel, one near column among far ones, Nb under a
   warp at dof 8, all precisions zero); bar:
   max|kernel - plain| / max(max|plain|, 1) <= 1e-5, every output finite;
3. solve LineStep(20) at N = 100 through ``solve_tree`` on CUDA, with the
   bars of tests/test_fused_chain.py (|mean(x_i) - i| < 1.5);
4. solve the two-variable N = 50,000 graph of
   benchmarks/pallas_e2e_solve.py through ``solve_tree`` on CUDA: every
   two-proposal product is 50k x 50k pairs and goes through the kernel
   (its launch count must grow); bars |mean - mu| < 0.2, 0.4 < std < 1.5;
5. time the kernel, its plain version and one library route
   (torch.addmm-built logW + torch.logsumexp) at 50k x 50k, dof 1, and the
   kernel beside its bound at four more (n, dof);
6. profile one more warm solve of each configuration (torch.profiler):
   device busy share, the ten device operations and the ten host operators
   with the most time.

The last three lines are the card's name and power limit (nvidia-smi), a
JSON object of per-kernel numbers, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import collections
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
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
    cases.extend(extreme_cases(gen, dev))
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
    print(f"PASS kernel vs plain: worst rel err {worst:.3e} <= {_TOL}")


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


def _two_var_graph(it, N):
    fg = it.initfg(it.SolverParams(N=N, batch_cliques=False), device="cuda")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)))
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0", "x1"], it.LinearRelative(it.Normal(10.0, 1.0)))
    fg.add_factor(["x1"], it.Prior(it.Normal(10.0, 1.0)))
    return fg


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
        stats = {}
        for v, mu in (("x0", 0.0), ("x1", 10.0)):
            pts = fg.points(v)[:, 0]
            stats[v] = (float(pts.mean()), float(pts.std()))
            check(abs(stats[v][0] - mu) < 0.2, f"{v}: {stats[v]}")
            check(0.4 < stats[v][1] < 1.5, f"{v}: {stats[v]}")
    print(f"PASS N={N} solve_tree on CUDA through the kernel: cold "
          f"{walls[0]:.3f} s, warm {walls[1]:.3f} s; launches per solve "
          f"{launches}; posteriors (mean, std) {stats}", flush=True)
    return walls, launches[-1]


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


def phase_timing(K, dev, launches):
    """Kernel, plain and library times at the main path's shape, and the
    kernel beside its bound at four more shapes."""
    n, dof = 50_000, 1
    a2, iva, ivm, muB = timing_inputs(K, n, dof, dev)

    got = K.row_logsumexp(a2, iva, ivm, muB)
    ref = K.row_logsumexp_plain(a2, iva, ivm, muB)
    max_abs = float((got - ref).abs().max())
    rel = rel_err(got, ref)
    check(rel <= _TOL, f"50k kernel vs plain rel err {rel:.3e}")

    k_ms = cuda_ms(lambda: K.row_logsumexp(a2, iva, ivm, muB), reps=20)
    p_ms = cuda_ms(lambda: K.row_logsumexp_plain(a2, iva, ivm, muB), reps=5)

    def library():
        w = torch.addmm(a2[:, None], iva, (muB * muB).T)
        w.addmm_(ivm, muB.T, alpha=-2.0).mul_(-0.5)
        return torch.logsumexp(w, dim=1)

    lib_out = library()
    check(rel_err(lib_out, ref) <= _TOL, "library route disagrees")
    del lib_out
    l_ms = cuda_ms(library, reps=3, warmup=1)
    torch.cuda.empty_cache()

    bound, t_bytes, t_flops, t_exp = bound_ms(n, dof)
    print(f"row_logsumexp 50k x 50k dof 1: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, library {l_ms:.4f} ms; bound {bound:.4f} ms "
          f"(bytes {t_bytes:.5f}, fp32 {t_flops:.4f}, exp {t_exp:.4f} ms); "
          f"max abs err {max_abs:.3e}, rel {rel:.3e}", flush=True)
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
            "launches": launches, "max_abs_err": max_abs, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= max(t_flops, t_exp)
            else "operations",
            "library_ms": l_ms}


def phase_sass(K, dof=1):
    """Instruction slots per pair in the kernel's inner loop, counted in the
    SASS of the built library: the instructions of the innermost loop that holds
    MUFU.EX2, less those a forward branch skips (the rare move of m_ref),
    over the pairs a lane covers per trip."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("SASS inner loop: not measured (no cuobjdump)")
        return
    sass = subprocess.run([tool, "-sass", K._SO], capture_output=True,
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


def phase_profile(it, name, make_graph):
    """One more warm solve under torch.profiler: the share of the window
    in which the device was busy, and where device and host time went.
    The profiler's own hooks slow the host, so the window is longer than
    the warm wall printed above."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fg = make_graph()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        it.solve_tree(fg)
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
    host = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CPU]
    print(f"  top host operators of {name} by self CPU time "
          f"(calls, self ms):")
    for a in sorted(host, key=lambda a: -a.self_cpu_time_total)[:10]:
        print(f"    {a.count:7d} {a.self_cpu_time_total / 1e3:10.3f}  "
              f"{a.key[:100]}")
    sys.stdout.flush()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import incrementalinference_torch as it
    from incrementalinference_torch.ops.kernels import row_lse as K

    t_all = time.time()
    dev = torch.device("cuda")
    it.resolve_device(dev)             # TF32 off for matmuls and cuDNN
    print(f"# device {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.time()
    K.build(verbose=True)
    print(f"PASS build: {time.time() - t0:.2f} s (nvcc "
          f"{K.build_seconds if K.build_seconds is not None else 'cached'}"
          f" s)", flush=True)

    from incrementalinference_torch.native import native_available
    check(native_available(), "the native elimination ordering did not "
          "build: the solves would run on the Python heuristic's tree")
    print("PASS native ordering built", flush=True)
    phase_sass(K)

    phase_compare(K, dev)
    phase_linestep(it, K)
    _, launches = phase_large(it, K)
    entry = phase_timing(K, dev, launches)
    from incrementalinference_torch.canonical import generate_line_step
    phase_profile(it, "LineStep(20) N=100", lambda: generate_line_step(
        20, graphinit=True, device="cuda"))
    phase_profile(it, "two-variable N=50000",
                  lambda: _two_var_graph(it, 50_000))

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
