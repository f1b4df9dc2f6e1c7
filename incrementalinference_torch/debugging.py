"""Scheduler forensics: trace printing, replay, tree and graph drawings.

Counterpart of ``incrementalinference/jl_tpu/debugging.py`` (reference
src/services/TreeDebugTools.jl: printCliqHistorySummary, printCSMHistory*,
repeatCSMStep!; drawTree and generateTexTree, JunctionTreeUtils.jl).  The
traces are those a solve keeps with ``SolverParams.record_cliques``
(``tree.traces``).  The two plots (:func:`spy_clique_matrix`,
:func:`animate_csm`) need matplotlib, which is imported when they are
called and nowhere else.  Files go under the temporary directory unless a
path is given.
"""

from __future__ import annotations

import os
import re
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .parallel.scheduler import CliqueTrace, up_solve_clique
from .tree.bayestree import BayesTree, CliqStatus

__all__ = ["print_clique_history", "print_history_sequential",
           "tree_to_dot", "save_tree_dot", "generate_tex_tree",
           "replay_clique_up",
           "graph_to_dot", "save_graph_dot", "clique_assoc_matrix",
           "spy_clique_matrix", "animate_csm", "print_clique_summary",
           "cliq_hist_filter_transitions", "filter_hist_all_to_array",
           "hist_state_machine_transitions", "sandbox_state_machine_step",
           "get_cliq_subgraph_from_history", "get_graph_from_history",
           "print_history_lanes", "draw_tree_async_loop",
           "animate_cliq_state_machines",
           "animate_state_machine_history_by_time",
           "exit_state_machine", "get_state_label",
           "draw_state_transition_step", "draw_state_machine_history",
           "animate_state_machine_history_by_time_compound"]


def print_clique_history(traces: Dict[int, CliqueTrace],
                         cid: Optional[int] = None) -> str:
    """Summarise one (or all) clique trace(s) (reference
    printCliqHistorySummary)."""
    lines = []
    for c, tr in sorted(traces.items()):
        if cid is not None and c != cid:
            continue
        lines.append(f"clique {c}:")
        t0 = tr.events[0][0] if tr.events else 0.0
        for ts, step, detail in tr.events:
            lines.append(f"  +{ts - t0:8.3f}s  {step:<18} {detail}")
    out = "\n".join(lines)
    print(out)
    return out


def print_clique_summary(fg, tree: BayesTree, cid: int) -> str:
    """One-glance clique summary: status, frontals/separator, per-variable
    init state (reference printCliqSummary, TreeDebugTools.jl)."""
    cl = tree.clique(cid)
    lines = [f"clique {cid}: status={cl.status.value}"
             f" recycled={cl.is_recycled} marginalized={cl.is_marginalized}",
             f"  frontals : {cl.frontals}",
             f"  separator: {cl.separator}",
             f"  potentials ({len(cl.potentials)}): {cl.potentials}"]
    for v in cl.all_vars:
        var = fg.var(v)
        lines.append(f"  var {v:<8} init={var.is_initialized()} "
                     f"solved×{var.get_solved_count()}")
    out = "\n".join(lines)
    print(out)
    return out


def cliq_hist_filter_transitions(trace: CliqueTrace, step: str):
    """Events of one clique trace matching a step name (reference
    cliqHistFilterTransitions, TreeDebugTools.jl)."""
    return [e for e in trace.events if e[1] == step]


def filter_hist_all_to_array(traces: Dict[int, CliqueTrace],
                             steps) -> list:
    """Flatten all cliques' events matching any of ``steps`` into one
    time-sorted array of (ts, cid, step, detail) (reference
    filterHistAllToArray)."""
    steps = {steps} if isinstance(steps, str) else set(steps)
    out = [(ts, c, step, detail) for c, tr in traces.items()
           for ts, step, detail in tr.events if step in steps]
    out.sort()
    return out


def hist_state_machine_transitions(traces: Dict[int, CliqueTrace]
                                   ) -> Dict[tuple, int]:
    """Histogram of step→step transitions across all clique traces
    (reference histStateMachineTransitions/histGraphStateMachineTransitions
    — the graphviz rendering reduces to these counts)."""
    counts: Dict[tuple, int] = {}
    for tr in traces.values():
        names = [s for _, s, _ in tr.events]
        for a, b in zip(names, names[1:]):
            counts[(a, b)] = counts.get((a, b), 0) + 1
    return counts


def print_history_sequential(traces: Dict[int, CliqueTrace]) -> str:
    """Global time-ordered event stream across cliques (reference
    printCSMHistorySequential)."""
    events = [(ts, c, step, detail) for c, tr in traces.items()
              for ts, step, detail in tr.events]
    events.sort()
    t0 = events[0][0] if events else 0.0
    lines = [f"+{ts - t0:8.3f}s  cliq{c:<4} {step:<18} {detail}"
             for ts, c, step, detail in events]
    out = "\n".join(lines)
    print(out)
    return out


def _default_path(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), "iitpu", name)


#: clique status -> draw colour (reference drawTree clique colouring)
_STATUS_COLOR = {
    CliqStatus.NULL: "gray", CliqStatus.NO_INIT: "orange",
    CliqStatus.INITIALIZED: "green", CliqStatus.UPSOLVED: "lightblue",
    CliqStatus.MARGINALIZED: "blue", CliqStatus.DOWNSOLVED: "lightgreen",
    CliqStatus.UPRECYCLED: "purple", CliqStatus.ERROR_STATUS: "red",
}


def tree_to_dot(tree: BayesTree) -> str:
    """Graphviz dot of the Bayes tree, clique colors encoding status
    (reference drawTree clique coloring, CliqueStateMachine.jl:314-315)."""
    lines = ["digraph BayesTree {", "  node [shape=ellipse];"]
    for c in tree.cliques.values():
        label = f"{c.cid}: {','.join(c.frontals)}"
        if c.separator:
            label += f" | {','.join(c.separator)}"
        color = _STATUS_COLOR.get(c.status, "gray")
        lines.append(f'  c{c.cid} [label="{label}", style=filled, '
                     f'fillcolor={color}];')
    for c in tree.cliques.values():
        if c.parent is not None:
            lines.append(f"  c{c.parent} -> c{c.cid};")
    lines.append("}")
    return "\n".join(lines)


def save_tree_dot(tree: BayesTree, path: Optional[str] = None) -> str:
    """Write the Bayes tree as graphviz dot (reference drawTree,
    src/services/JunctionTreeUtils.jl:578-668)."""
    path = path or _default_path("bt.dot")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(tree_to_dot(tree))
    return path


def _tex_label(name: str) -> str:
    """x1 → $x_{1}$, lm20 → $lm_{20}$ (reference generateTexTree label
    styling, JunctionTreeUtils.jl:685-751)."""
    m = re.match(r"([A-Za-z]+)(\d*)$", name)
    if not m:
        return name
    base, sub = m.groups()
    return f"$ {base}_{{{sub}}} $" if sub else f"$ {base} $"


def generate_tex_tree(tree: BayesTree, path: Optional[str] = None) -> str:
    """Standalone TikZ LaTeX rendering of the Bayes tree with math-styled
    frontal/separator labels (reference generateTexTree via dot2tex,
    JunctionTreeUtils.jl:685-751; test/testTexTreeIllustration.jl).
    Returns the written path; compile with pdflatex."""
    path = path or _default_path("bt.tex")
    lines = [r"\documentclass[tikz,border=6pt]{standalone}",
             r"\usetikzlibrary{graphs,graphdrawing}",
             r"\usegdlibrary{trees}",
             r"\begin{document}",
             r"\begin{tikzpicture}[every node/.style="
             r"{draw,ellipse,align=center}]",
             r"\graph[tree layout, sibling distance=14mm, "
             r"level distance=18mm]{"]
    def node(c):
        fr = ",\\,".join(_tex_label(v) for v in c.frontals)
        sep = ",\\,".join(_tex_label(v) for v in c.separator)
        body = fr + (f" $\\mid$ {sep}" if sep else "")
        return f'c{c.cid}/"{body}"'

    edges = []
    for c in tree.cliques.values():
        edges.append(node(c) + ";")
        if c.parent is not None:
            edges.append(f"c{c.parent} -> c{c.cid};")
    lines += ["  " + e for e in edges]
    lines += ["};", r"\end{tikzpicture}", r"\end{document}"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def replay_clique_up(fg, tree: BayesTree, cid: int,
                     traces: Dict[int, CliqueTrace],
                     solve_key: str = "default"):
    """Re-execute a recorded clique up-solve from its captured input
    messages (reference repeatCSMStep!, TreeDebugTools.jl:513-554)."""
    tr = traces.get(cid)
    if tr is None or tr.child_msgs is None:
        raise ValueError(f"no recorded messages for clique {cid} "
                         f"(run with record_cliques=True)")
    return up_solve_clique(fg, tree, tree.clique(cid), tr.child_msgs,
                           solve_key)


# reference sandboxStateMachineStep / sandboxCliqResolveStep — re-running a
# recorded step in isolation IS the replay above
sandbox_state_machine_step = replay_clique_up


def get_cliq_subgraph_from_history(traces: Dict[int, CliqueTrace],
                                   cid: int):
    """Reference ``getCliqSubgraphFromHistory`` — the clique subgraph
    snapshot captured during the recorded up-solve (record_cliques=True)."""
    tr = traces.get(cid)
    if tr is None or tr.subfg is None:
        raise ValueError(f"no recorded subgraph for clique {cid} "
                         f"(run with record_cliques=True)")
    return tr.subfg


# reference getGraphFromHistory — same capture, reference naming
get_graph_from_history = get_cliq_subgraph_from_history


def print_history_lanes(traces: Dict[int, CliqueTrace]) -> str:
    """Side-by-side lanes, one column per clique, rows = global event order
    (reference printCSMHistoryLogical / printHistoryLane,
    TreeDebugTools.jl:254-511)."""
    cids = sorted(traces)
    events = [(ts, c, step) for c in cids
              for ts, step, _ in traces[c].events]
    events.sort()
    width = max([12] + [len(s) + 2 for _, _, s in events])
    header = "      | " + " | ".join(f"cliq{c:<{width - 4}}" for c in cids)
    lines = [header, "-" * len(header)]
    for i, (ts, c, step) in enumerate(events):
        cells = [f"{step:<{width}}" if c == cc else " " * width
                 for cc in cids]
        lines.append(f"{i:5d} | " + " | ".join(cells))
    out = "\n".join(lines)
    print(out)
    return out


def draw_tree_async_loop(tree: BayesTree, path: Optional[str] = None,
                         rate_hz: float = 2.0):
    """Background redraw loop writing the tree's dot file at ``rate_hz``
    while a solve mutates clique statuses (reference drawTreeAsyncLoop /
    drawtreerate live visualization, JunctionTreeUtils.jl:648-669).
    Returns a zero-argument stop function."""
    path = path or _default_path("bt.dot")
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            try:
                save_tree_dot(tree, path)
            except OSError:
                pass                    # best effort: the next tick retries
            stop.wait(1.0 / max(rate_hz, 1e-3))

    th = threading.Thread(target=loop, daemon=True)
    th.start()

    def stopper():
        stop.set()
        th.join(timeout=2.0)

    return stopper


def graph_to_dot(fg) -> str:
    """Graphviz dot of the factor graph itself (reference drawGraph/
    drawGraphCliq helpers, src/services/AdditionalUtils.jl)."""
    lines = ["graph FactorGraph {", "  node [fontsize=10];"]
    for v in fg.ls():
        init = fg.var(v).is_initialized()
        lines.append(f'  "{v}" [shape=ellipse, style=filled, '
                     f'fillcolor={"lightblue" if init else "lightgray"}];')
    for fl in fg.lsf():
        lines.append(f'  "{fl}" [shape=box, style=filled, '
                     f'fillcolor=lightyellow, '
                     f'label="{type(fg.factor(fl).model).__name__}"];')
        for v in fg.factor(fl).variables:
            lines.append(f'  "{fl}" -- "{v}";')
    lines.append("}")
    return "\n".join(lines)


def save_graph_dot(fg, path: Optional[str] = None) -> str:
    """Write the factor graph as graphviz dot (reference drawGraph/
    drawGraphCliq, src/services/AdditionalUtils.jl)."""
    path = path or _default_path("fg.dot")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(graph_to_dot(fg))
    return path


def clique_assoc_matrix(fg, tree: BayesTree, cid: int
                        ) -> Tuple[List[str], List[str], np.ndarray]:
    """Potential-factor rows × clique-variable columns, plus one row per
    child up-message (reference compCliqAssocMatrices! cliqAssocMat and
    cliqMsgMat).  Returns (row labels, column labels, bool matrix)."""
    cl = tree.clique(cid)
    cols = cl.all_vars
    col_idx = {v: j for j, v in enumerate(cols)}
    rows, mat = [], []

    def row_of(labels):
        row = np.zeros(len(cols), bool)
        for v in labels:
            if v in col_idx:
                row[col_idx[v]] = True
        return row

    for fl in cl.potentials:
        rows.append(fl)
        mat.append(row_of(fg.factor(fl).variables))
    for ch in tree.children(cid):
        rows.append(f"msg:cliq{ch.cid}")
        mat.append(row_of(ch.separator))
    M = np.stack(mat) if mat else np.zeros((0, len(cols)), bool)
    return rows, cols, M


def spy_clique_matrix(fg, tree: BayesTree, cid: int,
                      path: Optional[str] = None):
    """Spy plot of a clique's association matrix (reference spyCliqMat,
    src/services/AdditionalUtils.jl — Gadfly there, matplotlib here).
    Returns the figure; saves a PNG when ``path`` is given."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows, cols, M = clique_assoc_matrix(fg, tree, cid)
    fig, ax = plt.subplots(
        figsize=(1.2 + 0.5 * len(cols), 1.0 + 0.35 * max(1, len(rows))))
    ax.imshow(M, cmap="Greys", aspect="auto", vmin=0, vmax=1)
    ax.set_xticks(range(len(cols)), cols, rotation=45, ha="right")
    ax.set_yticks(range(len(rows)), rows)
    cl = tree.clique(cid)
    nfr = len(cl.frontals)
    if nfr < len(cols):
        ax.axvline(nfr - 0.5, color="tab:red", lw=1.0)
    ax.set_title(f"clique {cid} association matrix")
    fig.tight_layout()
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=100)
    plt.close(fig)
    return fig


# matplotlib color names for the animation (same palette as tree_to_dot)
_MPL_STATUS_COLOR = {
    CliqStatus.NULL: "lightgray", CliqStatus.NO_INIT: "orange",
    CliqStatus.INITIALIZED: "green", CliqStatus.UPSOLVED: "lightblue",
    CliqStatus.MARGINALIZED: "blue", CliqStatus.DOWNSOLVED: "lightgreen",
    CliqStatus.UPRECYCLED: "violet", CliqStatus.ERROR_STATUS: "red",
}

# trace step → clique status at that instant (scheduler event vocabulary)
_STEP_STATUS = {
    "build_subgraph": CliqStatus.INITIALIZED,
    "add_msg_factors": CliqStatus.INITIALIZED,
    "no_init": CliqStatus.NO_INIT,
    "up_gibbs": CliqStatus.INITIALIZED,
    "up_done": CliqStatus.UPSOLVED,
    "recycle": CliqStatus.UPRECYCLED,
    "marginalized": CliqStatus.MARGINALIZED,
    "down_init": CliqStatus.UPSOLVED,
    "down_start": CliqStatus.UPSOLVED,
    "down_gibbs": CliqStatus.UPSOLVED,
    "down_done": CliqStatus.DOWNSOLVED,
    "skip": CliqStatus.NULL,
    "error": CliqStatus.ERROR_STATUS,
}


def animate_csm(tree: BayesTree, traces: Dict[int, CliqueTrace],
                path: Optional[str] = None, fps: int = 4) -> str:
    """Render the recorded solve as an animated GIF: one frame per trace
    event, cliques colored by their status at that instant (reference
    animateCSM/makeCsmMovie, TreeDebugTools.jl:596-840 — dot+ffmpeg there,
    matplotlib+Pillow here).  Returns the written path."""
    path = path or _default_path("csm.gif")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import PillowWriter

    # layered layout from the level schedule
    pos = {}
    for d, level in enumerate(tree.levels()):
        for i, cid in enumerate(sorted(level)):
            pos[cid] = (i - (len(level) - 1) / 2.0, -d)

    events = sorted((ts, c, step) for c, tr in traces.items()
                    for ts, step, _ in tr.events)
    status = {cid: CliqStatus.NULL for cid in tree.cliques}

    fig, ax = plt.subplots(figsize=(6, 4))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    writer = PillowWriter(fps=fps)
    with writer.saving(fig, path, dpi=80):
        frames = events or [(0.0, None, None)]
        for ts, cid, step in frames:
            if cid is not None and step in _STEP_STATUS:
                status[cid] = _STEP_STATUS[step]
            ax.clear()
            ax.set_axis_off()
            for c in tree.cliques.values():
                if c.parent is not None:
                    x0, y0 = pos[c.parent]
                    x1, y1 = pos[c.cid]
                    ax.plot([x0, x1], [y0, y1], "-", color="gray", zorder=1)
            for c, (x, y) in pos.items():
                ax.scatter([x], [y], s=600, zorder=2,
                           color=_MPL_STATUS_COLOR[status[c]],
                           edgecolors="black")
                ax.annotate(str(c), (x, y), ha="center", va="center",
                            zorder=3, fontsize=8)
            ax.set_title(f"cliq{cid}: {step}" if cid is not None else "CSM")
            writer.grab_frame()
    plt.close(fig)
    return path


# reference animateCliqStateMachines / animateStateMachineHistoryByTime —
# the recorded-trace GIF renderer above serves both
animate_cliq_state_machines = animate_csm
animate_state_machine_history_by_time = animate_csm


# ---------------------------------------------------------------------------
# FunctionalStateMachine.jl compatibility shims: the reference re-exports
# these FSM debug helpers (ExportAPI.jl:56-68).  The level sweeps record
# CliqueTrace events in place of live FSM states; these map the FSM
# vocabulary onto those traces.
# ---------------------------------------------------------------------------

class _ExitStateMachine:
    """Sentinel returned by a state to stop the machine (reference
    IncrementalInference.exitStateMachine)."""

    def __call__(self, *a, **k):
        return None

    def __repr__(self):
        return "exitStateMachine"


exit_state_machine = _ExitStateMachine()


def get_state_label(step) -> str:
    """Name of one recorded step (reference FSM getStateLabel).  Accepts a
    CliqueTrace event tuple ``(ts, step, detail)`` or a callable/state."""
    if isinstance(step, tuple) and len(step) >= 2:
        return str(step[1])
    return getattr(step, "__name__", str(step))


def draw_state_transition_step(traces: Dict[int, CliqueTrace], cid: int,
                               index: int) -> str:
    """One-line rendering of a single recorded transition (reference FSM
    drawStateTransitionStep)."""
    tr = traces[cid]
    ts, step, detail = tr.events[index]
    return f"cliq{cid}[{index}] {time.strftime('%H:%M:%S', time.localtime(ts))} {step} {detail}".rstrip()


def draw_state_machine_history(traces: Dict[int, CliqueTrace],
                               show: bool = False) -> str:
    """Text rendering of every recorded machine's transitions (reference FSM
    drawStateMachineHistory); same content as print_history_sequential."""
    out = print_history_sequential(traces)
    if show:
        print(out)
    return out


def animate_state_machine_history_by_time_compound(
        tree: BayesTree, traces: Dict[int, CliqueTrace],
        path: Optional[str] = None, fps: int = 4) -> str:
    """Compound (all cliques, one timeline) animation (reference FSM
    animateStateMachineHistoryByTimeCompound) — the trace GIF renderer
    already interleaves all cliques on the global event timeline."""
    return animate_csm(tree, traces,
                       path=path or _default_path("csm_compound.gif"),
                       fps=fps)
