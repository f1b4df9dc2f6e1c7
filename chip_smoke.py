#!/usr/bin/env python3
"""Smoke run of the PyTorch port (incrementalinference_torch) on one GPU.

Usage, from the root of the repository, on a machine with an H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
1. build the row-logsumexp CUDA kernel from ops/kernels/csrc/row_lse.cu;
2. hold the kernel against its plain PyTorch version on the card, at the
   reference's check points (n, dof) of benchmarks/pallas_tpu_check.py, a
   zero-precision partial-dims case, n = 65536 and the N = 50k solve's
   shape; bar: max|kernel - plain| / max(max|plain|, 1) <= 1e-5;
3. solve LineStep(20) at N = 100 through ``solve_tree`` on CUDA, with the
   bars of tests/test_fused_chain.py (|mean(x_i) - i| < 1.5);
4. solve the two-variable N = 50,000 graph of
   benchmarks/pallas_e2e_solve.py through ``solve_tree`` on CUDA: every
   two-proposal product is 50k x 50k pairs and goes through the kernel
   (its launch count must grow); bars |mean - mu| < 0.2, 0.4 < std < 1.5;
5. time the kernel, its plain version and one library route
   (torch.addmm-built logW + torch.logsumexp) at 50k x 50k, dof 1.

The last three lines are the card's name and power limit (nvidia-smi), a
JSON object of per-kernel numbers, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
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


def phase_timing(K, dev, launches):
    """Kernel, plain and library times at the main path's shape."""
    n, dof = 50_000, 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # shaped like the solve's products: unit-scale particles, bw ~ 0.3
    muA = torch.randn((n, dof), generator=gen, device=dev)
    muB = torch.randn((n, dof), generator=gen, device=dev)
    prec = torch.full((n, dof), 11.0, device=dev)
    a2, iva, ivm = K.pair_row_terms(muA, prec, muB, prec)
    a2, iva, ivm = a2.contiguous(), iva.contiguous(), ivm.contiguous()

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

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pairs = n * n
    bytes_moved = 4 * (n * (1 + 2 * dof) + n * dof + n)
    flops = pairs * (4 * dof + 4)
    t_bytes = bytes_moved / _HBM_BPS * 1e3
    t_flops = flops / _FP32_FLOPS * 1e3
    t_exp = pairs / (sms * _MUFU_PER_SM_CLK * _BOOST_HZ) * 1e3
    bound = max(t_bytes, t_flops, t_exp)
    print(f"row_logsumexp 50k x 50k dof 1: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, library {l_ms:.4f} ms; bound {bound:.4f} ms "
          f"(bytes {t_bytes:.5f}, fp32 {t_flops:.4f}, exp {t_exp:.4f} ms); "
          f"max abs err {max_abs:.3e}, rel {rel:.3e}", flush=True)
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

    phase_compare(K, dev)
    phase_linestep(it, K)
    _, launches = phase_large(it, K)
    entry = phase_timing(K, dev, launches)

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
