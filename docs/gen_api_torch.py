"""Generate docs/API_torch.md, the API reference of the PyTorch port.

The counterpart of docs/gen_api.py for ``incrementalinference_torch``: it
walks the port's exported surface (its ``__all__``) and emits, per module
group (the groups of docs/API.md), each symbol's signature and docstring
summary, then the module surfaces reached as ``<module>.<name>``, and ends
with the places where the port departs from the reference on purpose.  It
imports the port only, never JAX.

Usage: python docs/gen_api_torch.py   (rewrites docs/API_torch.md in place)
"""

from __future__ import annotations

import importlib
import inspect
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import incrementalinference_torch as pkg  # noqa: E402

P = "incrementalinference_torch"

# presentation order: user-facing layers first, as in docs/API.md
GROUPS = [
    ("Graph construction", f"{P}.graph"),
    ("Solver entry points", f"{P}.api"),
    ("Configuration", f"{P}.config"),
    ("Graph initialization", f"{P}.graphinit"),
    ("Beliefs & statistics", f"{P}.beliefs"),
    ("Distributions", f"{P}.distributions"),
    ("Factor & variable models", f"{P}.models"),
    ("Manifolds", f"{P}.manifolds"),
    ("Numerics (convolution / product / deconv / gradients)", f"{P}.ops"),
    ("Bayes tree", f"{P}.tree"),
    ("Tree accessors", f"{P}.tree.accessors"),
    ("Parametric solver", f"{P}.parametric"),
    ("Graph-ops utilities (FGOS)", f"{P}.fgos"),
    ("Serialization", f"{P}.serialization"),
    ("Dead-reckon tether", f"{P}.tether"),
    ("Canonical example graphs", f"{P}.canonical"),
    ("Debugging / tracing / visualization", f"{P}.debugging"),
    ("Comparison utilities", f"{P}.utils"),
    ("Compat shims", f"{P}.compat"),
]

# module surfaces reached as <module>.<name> rather than re-exported
MODULES = [
    ("Canonical example graphs (`canonical`)", f"{P}.canonical"),
    ("Debugging / tracing / visualization (`debugging`)", f"{P}.debugging"),
    ("Serialization module extras (`serialization`)", f"{P}.serialization"),
    ("Multi-process solve (`parallel.multihost`)", f"{P}.parallel.multihost"),
    ("Device mesh (`parallel.mesh`)", f"{P}.parallel.mesh"),
    ("Precompile (`parallel.precompile`)", f"{P}.parallel.precompile"),
    ("Warm start of the compiled libraries (`warmstart`)", f"{P}.warmstart"),
    ("The row-logsumexp kernel (`ops.kernels.row_lse`)",
     f"{P}.ops.kernels.row_lse"),
    ("The large pair product's column draw (`ops.kernels.pair_draw`)",
     f"{P}.ops.kernels.pair_draw"),
    ("The KDE read's kernel (`ops.kernels.kde_lse`)",
     f"{P}.ops.kernels.kde_lse"),
    ("Spans and counters (`tracing`)", f"{P}.tracing"),
]

DEPARTURES = [
    "**The device.** Every entry point takes `device=` and defaults to "
    "CUDA; asking for CUDA where there is none raises, nothing falls back "
    "to the CPU (`config.resolve_device`).",
    "**Full float32 precision.** Each device entry point pins float32 "
    "matmul and cuDNN convolutions to IEEE for its span and gives the "
    "caller's setting back on exit (`config.full_precision`); the JAX "
    "package asks for `Precision.HIGHEST` at each product instead.",
    "**Random streams.** Keys are derived from (seed, counter) as there, "
    "but torch's generators are not threefry: the same seed draws other "
    "particles, so sampled results agree at the reference's bars, not bit "
    "for bit (`keys`).",
    "**Parametric covariance.** It comes from a QR factor of the Jacobian, "
    "not from inverting JᵀJ in float32, which left an indefinite block on "
    "a 200-pose SE(3) chain (`parametric.solver`).",
    "**Factors of a batched level.** Each member's factors are matched one "
    "to one by canonical position (`_member_factors`), where the reference "
    "keeps one of two factors of one kind.",
    "**Categorical draws.** The running sum is `keys.cdf`, a scan of fixed "
    "order, because a whole-tensor `torch.cumsum` on CUDA is not the same "
    "from run to run.",
    "**Cluster sums.** `condense_mixture` sums its clusters with one-hot "
    "products, because `index_add_` on CUDA adds with atomics in an order "
    "that changes from run to run.",
    "**Unread estimates.** `LazyPPE` reads its estimate for `!=` as for "
    "`==`; the JAX class reads it only for `==`, so there an unread "
    "estimate is neither `== {}` nor `!= {}` (`beliefs.LazyPPE`).",
    "**Warm start.** The pack holds the four compiled libraries (the "
    "row-logsumexp kernel, the column draw's kernel, the KDE read's kernel "
    "and the native ordering), named by content, not XLA programs "
    "(`warmstart`, `libcache`).",
    "**The large pair product's column draw.** Where the JAX package draws "
    "each drawn row's column with `jax.random.categorical` (Gumbel noise "
    "and an argmax), `pair_product_tangent_large` draws it by inverse CDF "
    "on two uniforms a row from the member's key, through one hand-written "
    "CUDA kernel on the card and its plain version on the CPU "
    "(`ops.kernels.pair_draw`): the split of 2,048 columns by the first, "
    "the column inside it by the second, each against a running sum of "
    "fixed order. The law is the same, the random stream another; a "
    "member's columns do not depend on the batch, and the kernel and the "
    "plain version on the same uniforms pick the same columns except "
    "where a float32 rounding moves a running sum across its target.",
    "**The KDE read on the card.** `kde_logpdf` (and through it `ppe`, "
    "`ppe_batched`, `LazyPPE`, `set_ppe` and "
    "`ManifoldKernelDensity.logpdf`) reads `Euclidean(d)`, d up to 8, "
    "`SE2` and `SE3` by one hand-written CUDA kernel where the particles, "
    "queries and bandwidths are float32 CUDA tensors and no gradient is "
    "asked of them (`ops.kernels.kde_lse`); SO(3), the circle, the sphere, "
    "products, subclasses, other dtypes and the CPU keep the chunked eager "
    "route. On "
    "the kernel's route a row's value does not depend on the rest of the "
    "query: the column split depends on N alone and the splits merge in a "
    "fixed order, so a row read alone gives the bits it has in a read of "
    "every particle. Both routes agree to float32 rounding (2e-5 in "
    "log-density against the float64 read), not bit for bit, and the "
    "SE(2) kernel rotates the difference of the translations where the "
    "eager `compose(inverse(p), q)` subtracts two rotated points. The "
    "SE(3) kernel follows `SE3.log` with its small-angle forms and clamps, "
    "but takes V^-1's coefficient from the relative quaternion's half "
    "angle, so in float32 it keeps what the eager `SE3.log` loses at small "
    "relative angles (on the two-pose SE(3) graph's beliefs the eager "
    "float32 read lies up to 2e-3 from the float64 read, the kernel 1e-6); "
    "`kde_lse.se3_log` and `kde_lse.se3_row_logsumexp` are its plain "
    "version.",
    "**The convolution's CUDA graphs.** Where the JAX package jits the LM "
    "solve, the port (`ops.convolve.batched_gauss_newton`) solves eagerly "
    "at a signature's first call on the card, captures the whole solve as "
    "a CUDA graph at its second and replays it after, one cache a thread "
    "(`GRAPH_CACHE_SIZE` signatures, `solve_signature`). A capture waits "
    "for a call on a lone Python thread, since another thread's work on "
    "the device (a synchronize, a launch on the default stream) would "
    "break it; so in practice only the main thread captures, and a "
    "process with other threads alive (a Jupyter or IPython kernel, "
    "`debugging.draw_tree_async_loop`, a thread pool) solves eagerly and "
    "is warned once. Each call counts "
    "once under `conv_graph_replays`, `conv_graph_captures` or "
    "`conv_eager_solves` (`tracing`). A CPU tensor, a model outside "
    "`MODEL_REGISTRY` or whose residual parameters do not stack, and the "
    "mesh split of the particles over several devices solve eagerly. The "
    "damped normal equations go to `torch.linalg.solve_ex` with no check "
    "on the host, so no LM iteration waits for the device: a step that is "
    "not finite (a singular system) is rejected, in the LM loop and in "
    "the `linear` branch alike (the JAX package's `linear` branch keeps "
    "no such guard).",
]


# the spans and counters ``tracing`` records at the port's layer
# boundaries, while a ``torch.profiler`` session records
RECORDED = [
    "**Roots** (one a top-level API call): `solve_tree`, `set_ppe`, "
    "`add_variable`, `add_factor`.",
    "**Graph build and tree**: `graphinit`, `tree`.",
    "**Sweeps** (`parallel.scheduler`): `sweep.up`, `sweep.down`, "
    "`clique.up`, `clique.down`, `level.up`, `gibbs`, `update`, "
    "`message`.",
    "**Convolution** (`ops.convolve`): `convolve`; counters "
    "`jacobian_passes` (one an LM iteration or linear solve), and one of "
    "`conv_graph_replays`, `conv_graph_captures`, `conv_eager_solves` a "
    "`batched_gauss_newton` call.",
    "**Bandwidth and estimates**: `bandwidth`, `kde_logpdf` (attributes "
    "`N`, `Q` and `manifold`, the manifold's class name); counter "
    "`kde_pairs` where the kernel read and "
    "`kde_eager_pairs` where the chunked eager route did (members × Q × "
    "N).",
    "**Product** (`ops.product`, `ops.fused`): `product`; inside it one "
    "`product.draw` a pair product's call, around its draws (the rows and "
    "the columns) on every route (attributes `route`, `members`, `rows`, "
    "`na`, `nb`, `dof`), with stream marks on the card (`device_us`); "
    "counter `draw_pairs` (members × rows × Nb, the pairs the column draws "
    "weigh), and `draw_kernel_pairs` (the same count) where the column "
    "draw's kernel drew them.",
]


def first_para(doc: str | None) -> str:
    if not doc:
        return ""
    para = doc.strip().split("\n\n")[0]
    return " ".join(line.strip() for line in para.splitlines())


def sig_of(obj) -> str:
    """The signature, without the memory addresses of default values (a
    regeneration must give the same file)."""
    try:
        return re.sub(r" at 0x[0-9a-f]+", "", str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return "(…)"


def describe(name: str, obj, level: str = "###") -> str | None:
    if inspect.ismodule(obj):
        body = first_para(inspect.getdoc(obj))
        return f"{level} `{name}`\n\n" + (body + "\n" if body else "")
    if inspect.isclass(obj):
        head = f"{level} `{name}`\n\n"
        body = first_para(inspect.getdoc(obj))
        methods = []
        seen = set()
        for klass in inspect.getmro(obj):
            if klass is object:
                continue
            for mn, mo in sorted(vars(klass).items()):
                if mn.startswith("_") or mn in seen:
                    continue
                seen.add(mn)
                if isinstance(mo, property):
                    mdoc = first_para(inspect.getdoc(mo))
                    methods.append(f"- `.{mn}`" + (f" — {mdoc}" if mdoc
                                                   else " (property)"))
                    continue
                if isinstance(mo, (staticmethod, classmethod)):
                    mo = mo.__func__
                if not callable(mo):
                    continue
                mdoc = first_para(inspect.getdoc(mo))
                sig = sig_of(mo).replace("self, ", "").replace("(self)", "()")
                methods.append(f"- `.{mn}{sig}`" + (f" — {mdoc}"
                                                    if mdoc else ""))
        out = head + (body + "\n" if body else "")
        if methods:
            out += "\n" + "\n".join(methods) + "\n"
        return out
    if callable(obj):
        body = first_para(inspect.getdoc(obj))
        return (f"{level} `{name}{sig_of(obj)}`\n\n"
                + (body + "\n" if body else ""))
    return f"{level} `{name}`\n\nA `{type(obj).__name__}`.\n"


def group_of(obj) -> str | None:
    """The group whose module is the longest prefix of ``obj``'s module."""
    mod = getattr(obj, "__module__", "") or ""
    best = None
    for _, gm in GROUPS:
        if (mod == gm or mod.startswith(gm + ".")) and \
                (best is None or len(gm) > len(best)):
            best = gm
    return best


def render() -> str:
    exported = {n: getattr(pkg, n) for n in pkg.__all__}
    by_group: dict[str, list[str]] = {m: [] for _, m in GROUPS}
    modules, other = [], []
    for n in sorted(exported):
        o = exported[n]
        if inspect.ismodule(o):
            modules.append(n)
        elif group_of(o) is None:
            other.append(n)
        else:
            by_group[group_of(o)].append(n)

    lines = [
        f"# API reference — `{P}`",
        "",
        "The PyTorch port of `incrementalinference.jl_tpu`.  Generated by "
        "`docs/gen_api_torch.py` from the port's `__all__` "
        f"({len(exported)} symbols), in the groups of `docs/API.md`, the "
        "JAX package's reference, whose names and signatures the port "
        "keeps.  Docstrings cite reference behaviour as `file.jl:line`.  "
        "The last section lists where the port departs from the "
        "reference on purpose.  Regenerate with "
        "`python docs/gen_api_torch.py`.",
        "",
    ]
    primary: dict[int, str] = {}

    def entry(n, o, level="###"):
        if id(o) in primary:
            return f"{level} `{n}`\n\nAlias of `{primary[id(o)]}`.\n"
        primary[id(o)] = n
        return describe(n, o, level)

    sections = [(title, by_group[gm]) for title, gm in GROUPS]
    sections += [("Other exports", other), ("Modules", modules)]
    for title, names in sections:
        if names:
            lines.append(f"## {title}\n")
            lines.extend(entry(n, exported[n]) for n in names)
            lines.append("")

    for title, modname in MODULES:
        mod = importlib.import_module(modname)
        names = getattr(mod, "__all__", None)
        if names is None:
            names = [n for n in dir(mod) if not n.startswith("_")]
        entries = []
        for n in sorted(names):
            o = getattr(mod, n, None)
            if o is None or inspect.ismodule(o) or not (
                    getattr(o, "__module__", "") or "").startswith(P):
                continue
            entries.append(entry(n, o, "####"))
        if entries:
            lines.append(f"## {title}\n")
            lines.extend(entries)
            lines.append("")

    lines.append("## What the recorder records (`tracing`)\n")
    lines.extend(f"- {r}" for r in RECORDED)
    lines.append("")

    lines.append("## Where the port departs from the reference on purpose\n")
    lines.extend(f"- {d}" for d in DEPARTURES)
    lines.append("")
    return "\n".join(lines)


def main() -> None:
    dest = os.path.join(ROOT, "docs", "API_torch.md")
    with open(dest, "w") as f:
        f.write(render())
    print(f"wrote {dest}: {len(pkg.__all__)} symbols")


if __name__ == "__main__":
    main()
