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
    "**Warm start.** The pack holds the two compiled libraries (the "
    "row-logsumexp kernel and the native ordering), named by content, not "
    "XLA programs (`warmstart`, `libcache`).",
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
