"""Multi-process distribution of the Bayes-tree solve.

Counterpart of ``incrementalinference/jl_tpu/parallel/multihost.py``
(reference: clique subgraphs solved on Julia ``Distributed`` workers,
src/services/SolveTree.jl:4-19, CliqStateMachineUtils.jl:349-410, enabled
by ``SolverParams.multiproc``).

The Bayes tree is subtree-partitioned across processes once per solve.
Each process owns a set of bottom subtrees and runs the up/down sweeps on
them; the top residual tree (ancestors of every cut edge, the root
included) is replicated and solved identically on every process.  The
only traffic between processes is:

- one collective after the local up phase, carrying the cut-edge up
  messages (separator beliefs: particle blocks ``(N, point_dim)``,
  bandwidths and infoPerCoord), and
- one collective after the down phase, broadcasting each part's solved
  frontal beliefs, so that every process ends with the full posterior.

Both go through ``torch.distributed.all_gather`` on host byte buffers
over the gloo backend: the JAX package's ``process_allgather`` over gloo
on its CPU rigs.  Every process computes on its own device; two processes
may share one GPU (NCCL refuses two ranks on one device, gloo does not
care, and the payloads are host bytes in either design).  The replicated
top is made bit-identical across processes by restarting the graph's key
stream at the phase boundary and by starting it from process 0's decoded
beliefs.

The tree-init fixed point spans processes (NO_INIT cut messages carry
partial beliefs through the codec's presence flags, the top's down
messages down-initialize owned subtrees, and re-up passes repeat until no
clique anywhere down-initializes; CliqueStateMachine.jl:341-417,
:699-858), and joint up-messages (``use_msg_likelihoods``) cross cut edges
in fixed-shape slots of their own (TreeMessageUtils.jl:279-412).

Run the launcher's worker as ``python -m
incrementalinference_torch.parallel.multihost`` (:func:`launch_multihost`
does so for each process).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..beliefs import Belief
from ..ops.kernels import row_lse as _row_lse
from ..tree.bayestree import BayesTree, CliqStatus
from .messages import JointMsg, LikelihoodMessage
from .scheduler import (_particle_mesh as _sched_particle_mesh,
                        build_clique_subgraph, down_solve_clique,
                        up_solve_clique)

__all__ = ["TreePartition", "partition_tree", "solve_tree_multihost",
           "launch_multihost"]

logger = logging.getLogger("iitpu.multihost")


# --------------------------------------------------------------------------
# subtree partition
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TreePartition:
    """Deterministic subtree partition of a Bayes tree across ``n_parts``
    processes.

    ``owner`` maps every part-owned clique id to its part; cliques in
    ``top`` (ancestors of cut edges) are replicated on every process.
    ``cut_roots`` are the owned subtree roots whose parent lies in ``top``
    — their up messages are the only cross-process up traffic.
    """

    n_parts: int
    owner: Dict[int, int]
    top: List[int]
    cut_roots: List[int]                       # cut roots WITH a top parent
    part_cliques: List[List[int]]              # per part, all owned cids

    def part_of(self, cid: int) -> Optional[int]:
        return self.owner.get(cid)


def partition_tree(tree: BayesTree, n_parts: int) -> TreePartition:
    """Cut the tree into ≤``n_parts`` bottom subtrees of balanced size plus
    a replicated top.

    A clique roots a cut subtree when its subtree size fits the per-part
    target but its parent's does not (maximal fitting subtrees); the cut
    subtrees are then LPT-bin-packed into parts.  Deterministic given the
    tree (all processes compute the identical partition)."""
    cids = sorted(tree.cliques)
    total = len(cids)
    target = max(1, math.ceil(total / max(1, n_parts)))

    size: Dict[int, int] = {}
    for level in reversed(tree.levels()):
        for cid in level:
            cl = tree.clique(cid)
            size[cid] = 1 + sum(size[ch] for ch in cl.children)

    cut_subtree_roots: List[int] = []
    stack = list(sorted(tree.root_ids))
    while stack:
        cid = stack.pop(0)
        if size[cid] <= target:
            cut_subtree_roots.append(cid)
        else:
            stack.extend(sorted(tree.clique(cid).children))

    # LPT bin packing, deterministic tiebreak by cid
    cut_subtree_roots.sort(key=lambda c: (-size[c], c))
    loads = [0] * n_parts
    owner: Dict[int, int] = {}
    part_cliques: List[List[int]] = [[] for _ in range(n_parts)]
    for root in cut_subtree_roots:
        p = min(range(n_parts), key=lambda i: (loads[i], i))
        loads[p] += size[root]
        sub = [root]
        while sub:
            c = sub.pop()
            owner[c] = p
            part_cliques[p].append(c)
            sub.extend(tree.clique(c).children)

    top = sorted(c for c in cids if c not in owner)
    cut_roots = sorted(c for c in cut_subtree_roots
                       if tree.clique(c).parent is not None)
    for p in range(n_parts):
        part_cliques[p].sort()
    return TreePartition(n_parts=n_parts, owner=owner, top=top,
                         cut_roots=cut_roots, part_cliques=part_cliques)


# --------------------------------------------------------------------------
# fixed-shape message packing for the collectives
# --------------------------------------------------------------------------

_STATUS_CODE = {s: i for i, s in enumerate(CliqStatus)}
_CODE_STATUS = {i: s for s, i in _STATUS_CODE.items()}


def _msg_layout(fg, tree, cids) -> List[Tuple[int, List[str]]]:
    """Deterministic (cid, separator-vars) layout all processes agree on."""
    return [(cid, list(tree.clique(cid).separator)) for cid in sorted(cids)]


#: particle blocks ship as scaled float16 (half the cut and posterior
#: collective bytes); a per-slot scale rides in the buffer so coordinates
#: beyond the f16 range keep a bounded relative error.  Every process
#: adopts the DECODED values (owners included), so replicated phases stay
#: bit-identical across processes.
_F16_SAFE_MAX = 3.0e4


def _host(value) -> np.ndarray:
    """A flat float32 numpy copy of a tensor (on any device) or array."""
    if isinstance(value, torch.Tensor):
        value = value.detach().to("cpu", torch.float32).numpy()
    return np.asarray(value, np.float32).reshape(-1)


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(arr).to(device)


class _FlatLayout:
    """Deterministic flat-BYTE-buffer layout, so each exchange is ONE
    fixed-shape collective (a collective per leaf pays the collective's
    latency hundreds of times over on a posterior sync; one contiguous
    buffer amortizes it).  Every process computes the identical
    (name -> (offset, shape, f16)) table.  Slots are float32 by default;
    ``f16=True`` slots store scaled float16 after a float32 scale word."""

    def __init__(self):
        self.slots: Dict[object, Tuple[int, Tuple[int, ...], bool]] = {}
        self.size = 0                         # bytes

    def add(self, name, shape, f16: bool = False) -> None:
        n = int(np.prod(shape)) if shape else 1
        nbytes = (4 + 2 * n) if f16 else 4 * n
        self.slots[name] = (self.size, tuple(shape), f16)
        self.size += nbytes + (-nbytes) % 4   # keep 4-byte alignment

    def write(self, buf: np.ndarray, name, value) -> None:
        off, shape, f16 = self.slots[name]
        n = int(np.prod(shape)) if shape else 1
        v = _host(value)
        if f16:
            amax = float(np.max(np.abs(v))) if n else 0.0
            scale = max(1.0, amax / _F16_SAFE_MAX)
            buf[off:off + 4] = np.frombuffer(
                np.float32(scale).tobytes(), np.uint8)
            buf[off + 4:off + 4 + 2 * n] = np.frombuffer(
                (v / scale).astype(np.float16).tobytes(), np.uint8)
        else:
            buf[off:off + 4 * n] = np.frombuffer(v.tobytes(), np.uint8)

    def read(self, buf: np.ndarray, name) -> np.ndarray:
        off, shape, f16 = self.slots[name]
        n = int(np.prod(shape)) if shape else 1
        if f16:
            scale = float(np.frombuffer(
                buf[off:off + 4].tobytes(), np.float32)[0])
            v = np.frombuffer(buf[off + 4:off + 4 + 2 * n].tobytes(),
                              np.float16).astype(np.float32) * scale
        else:
            v = np.frombuffer(buf[off:off + 4 * n].tobytes(),
                              np.float32).copy()
        return v.reshape(shape)

    def write_belief(self, buf: np.ndarray, key, b: Belief) -> None:
        self.write(buf, (key, "points"), b.points)
        self.write(buf, (key, "bw"), b.bw)
        self.write(buf, (key, "ipc"), b.ipc)

    def read_belief(self, buf: np.ndarray, key, device) -> Belief:
        return Belief(points=_tensor(self.read(buf, (key, "points")), device),
                      bw=_tensor(self.read(buf, (key, "bw")), device),
                      ipc=_tensor(self.read(buf, (key, "ipc")), device))


def _belief_slots(flat: _FlatLayout, key, var) -> None:
    m = var.manifold
    # the particle block dominates the payload: scaled-f16 halves it
    flat.add((key, "points"), (var.N, m.point_dim), f16=True)
    flat.add((key, "bw"), (m.dof,))
    flat.add((key, "ipc"), (m.dof,))


def _joint_slot_plan(fg, seps):
    """Deterministic candidate slots for a joint up-message payload
    (reference _MsgJointLikelihood, TreeMessageUtils.jl:446): every
    same-manifold separator pair in the order generate_msg_joint visits
    them (descending dof, stable) may carry a deconv-derived relative, and
    every separator may carry a class-anchor prior.  All processes derive
    the identical plan from graph structure alone — actual presence rides
    per-slot flags.  Computed on every call (a few comparisons over a
    separator), so a label re-added with another manifold or N is read
    afresh."""
    order = sorted(seps, key=lambda s: -fg.var(s).manifold.dof)
    pairs = []
    for i, va in enumerate(order):
        for vb in order[i + 1:]:
            if fg.var(va).manifold == fg.var(vb).manifold:
                n = min(fg.var(va).N, fg.var(vb).N)
                pairs.append((va, vb, n, fg.var(va).manifold.dof))
    return pairs, list(seps)


def _msg_flat_layout(fg, layout, joint: bool = False) -> _FlatLayout:
    """``joint=True`` (use_msg_likelihoods) adds fixed-shape slots for the
    joint differential payload so it crosses cut edges losslessly instead
    of degrading to plain separator beliefs."""
    flat = _FlatLayout()
    for cid, seps in layout:
        flat.add((cid, "_meta"), (3,))       # status, has_priors, has_joint
        for v in seps:
            flat.add(((cid, v), "has"), (1,))
            _belief_slots(flat, (cid, v), fg.var(v))
        if joint:
            pairs, jseps = _joint_slot_plan(fg, seps)
            for va, vb, n, dof in pairs:
                flat.add((cid, "jrel", va, vb, "has"), (1,))
                flat.add((cid, "jrel", va, vb, "points"), (n, dof), f16=True)
                flat.add((cid, "jrel", va, vb, "bw"), (dof,))
                flat.add((cid, "jrel", va, vb, "ipc"), (dof,))
            for v in jseps:
                flat.add((cid, "jpri", v, "has"), (1,))
                _belief_slots(flat, (cid, "jpri", v), fg.var(v))
    flat.joint = joint
    return flat


def _pack_msgs(fg, layout, flat: _FlatLayout,
               msgs: Dict[int, LikelihoodMessage]) -> np.ndarray:
    """Pack owned messages into the flat buffer; non-owned slots stay zero
    (the gather selects the owner's row, so their values never matter).
    Per-belief presence flags keep partially-populated messages (NO_INIT
    during the distributed init dance) faithful through the codec."""
    buf = np.zeros((flat.size,), np.uint8)
    for cid, seps in layout:
        m = msgs.get(cid)
        if m is None:
            continue
        jm = m.jointmsg if getattr(flat, "joint", False) else None
        flat.write(buf, (cid, "_meta"),
                   [_STATUS_CODE[m.status], 1.0 if m.has_priors else 0.0,
                    1.0 if jm is not None else 0.0])
        for v in seps:
            if v in m.beliefs:
                flat.write(buf, ((cid, v), "has"), [1.0])
                flat.write_belief(buf, (cid, v), m.beliefs[v])
        if jm is not None:
            rel_of = {(va, vb): b for va, vb, b in jm.relatives}
            pairs, jseps = _joint_slot_plan(fg, seps)
            for va, vb, n, dof in pairs:
                b = rel_of.get((va, vb))
                if b is None:
                    continue
                flat.write(buf, (cid, "jrel", va, vb, "has"), [1.0])
                flat.write(buf, (cid, "jrel", va, vb, "points"),
                           b.points[:n])
                flat.write(buf, (cid, "jrel", va, vb, "bw"), b.bw)
                flat.write(buf, (cid, "jrel", va, vb, "ipc"), b.ipc)
            for v in jseps:
                b = jm.priors.get(v)
                if b is None:
                    continue
                flat.write(buf, (cid, "jpri", v, "has"), [1.0])
                flat.write_belief(buf, (cid, "jpri", v), b)
    return buf


def _unpack_msgs(fg, tree, layout, flat: _FlatLayout, gathered: np.ndarray,
                 owner_proc: Dict[int, int],
                 direction: str = "up") -> Dict[int, LikelihoodMessage]:
    """Rebuild messages from the gathered (n_proc, size) buffer, reading
    each message from its owning process's row; beliefs come back as
    float32 tensors on ``fg.device``."""
    dev = fg.device
    out: Dict[int, LikelihoodMessage] = {}
    for cid, seps in layout:
        row = np.asarray(gathered[owner_proc[cid]])
        meta = flat.read(row, (cid, "_meta"))
        msg = LikelihoodMessage(
            sender=cid, status=_CODE_STATUS[int(round(float(meta[0])))],
            direction=direction, has_priors=bool(meta[1] > 0.5))
        for v in seps:
            if float(flat.read(row, ((cid, v), "has"))[0]) <= 0.5:
                continue
            msg.beliefs[v] = flat.read_belief(row, (cid, v), dev)
        if getattr(flat, "joint", False) and bool(meta[2] > 0.5):
            jm = JointMsg()
            pairs, jseps = _joint_slot_plan(fg, seps)
            for va, vb, n, dof in pairs:
                if float(flat.read(row,
                                   (cid, "jrel", va, vb, "has"))[0]) <= 0.5:
                    continue
                jm.relatives.append((va, vb, Belief(*(
                    _tensor(flat.read(row, (cid, "jrel", va, vb, k)), dev)
                    for k in ("points", "bw", "ipc")))))
            for v in jseps:
                if float(flat.read(row, (cid, "jpri", v, "has"))[0]) <= 0.5:
                    continue
                jm.priors[v] = flat.read_belief(row, (cid, "jpri", v), dev)
            msg.jointmsg = jm
        out[cid] = msg
    return out


# --------------------------------------------------------------------------
# the collective layer
# --------------------------------------------------------------------------

def _process_index() -> int:
    """This process's rank in the default process group (0 without one)."""
    import torch.distributed as dist
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def _process_count() -> int:
    """The default process group's size (1 without one)."""
    import torch.distributed as dist
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


#: per-process collective counter and cumulative wall, read and reset by
#: the launcher's report: count × per-collective latency must explain the
#: measured exchange and sync phase walls
ALLGATHER_STATS = {"count": 0, "wall_s": 0.0}


def _allgather(arr: np.ndarray) -> np.ndarray:
    """One collective over the process group: (size,) -> (n_proc, size),
    through gloo on CPU tensors."""
    import torch.distributed as dist

    t0 = time.time()
    x = torch.from_numpy(np.ascontiguousarray(arr))
    if _process_count() > 1:
        parts = [torch.empty_like(x) for _ in range(_process_count())]
        dist.all_gather(parts, x)
        out = torch.stack(parts).numpy()
    else:
        out = x[None].numpy().copy()
    ALLGATHER_STATS["count"] += 1
    ALLGATHER_STATS["wall_s"] += time.time() - t0
    return out


def _wall(fg) -> float:
    """Host clock after the graph's device has finished its queued work, so
    that each phase's wall holds its own device time."""
    if fg.device.type == "cuda":
        torch.cuda.synchronize(fg.device)
    return time.time()


# --------------------------------------------------------------------------
# the distributed solve
# --------------------------------------------------------------------------

def _phase_clock(fg, tm: dict):
    """``start``/``stop`` closures that add a phase's wall to
    ``tm[phase + "_s"]`` and the row-logsumexp's launches in it to
    ``tm["kernel_launches"][phase]``."""
    tm["kernel_launches"] = dict.fromkeys(("local_up", "top",
                                           "local_down"), 0)

    def start():
        return _wall(fg), _row_lse.counts["launches"]

    def stop(key, began):
        t0, l0 = began
        tm[key + "_s"] += _wall(fg) - t0
        tm["kernel_launches"][key] += _row_lse.counts["launches"] - l0

    return start, stop


def solve_tree_multihost(fg, order=None, solve_key: str = "default",
                         partition: Optional[TreePartition] = None,
                         old_tree: Optional[BayesTree] = None,
                         timings: Optional[dict] = None,
                         fail_cliques: Optional[set] = None,
                         mesh=None) -> BayesTree:
    """Distributed ``solve_tree``: every process calls this with an
    identically-built graph (deterministic given ``params.seed``); the
    clique solves are partitioned by :func:`partition_tree`.

    Phases: local up sweeps over owned subtrees → cut-edge up-message
    exchange (one collective) → replicated top up+down (reseeded key
    stream, bit-identical everywhere) → local down sweeps → posterior
    belief broadcast (one collective).  Without a process group (or with
    one process) it is a partition-aware but collective-free solve, the
    one-process baseline of the scaling measurement.

    ``mesh`` (parallel/mesh.py): a Mesh over THIS process's devices —
    composes the two parallelism axes the reference composes via workers ×
    threads (src/services/SolveTree.jl:4-19 WORKERPOOL +
    parametric/services/ParametricUtils.jl:446-483 Threads.@threads):
    subtree partition ACROSS processes, and within each process either
    clique batching (owned levels ≥ ``batch_min_width``) or particle
    splitting (narrow levels) across the process's own devices.

    ``timings`` receives the phase walls, ``init_passes``,
    ``local_cliques``, ``bytes_cut``/``bytes_sync`` and, per phase
    (``local_up``, ``top``, ``local_down``), the row-logsumexp kernel's
    launches (``kernel_launches``)."""
    from ..graphinit import ensure_solvable, init_all
    from ..tree.bayestree import build_tree_reset

    pid = _process_index()
    nproc = _process_count()

    ensure_solvable(fg)
    if fg.params.graphinit:
        init_all(fg, solve_key=solve_key)

    # incremental recycling works unchanged across processes: after the
    # posterior-broadcast phase every process holds the FULL previous
    # solution, so a recycled clique re-emits its message from local
    # beliefs regardless of which process owned it last solve (the
    # partition may shift as the tree grows)
    tree = build_tree_reset(fg, order=order, old_tree=old_tree)
    part = partition or partition_tree(tree, nproc)
    my_cids = set(part.part_cliques[pid]) if pid < part.n_parts else set()
    top_set = set(part.top)
    levels = tree.levels()
    tm = timings if timings is not None else {}
    tm.update({"local_up_s": 0.0, "exchange_up_s": 0.0, "top_s": 0.0,
               "local_down_s": 0.0, "init_passes": 0})
    tm["local_cliques"] = len(my_cids)
    start, stop = _phase_clock(fg, tm)

    local_error: Optional[Exception] = None
    aborted = False
    up_msgs: Dict[int, LikelihoodMessage] = {}
    down_msgs: Dict[int, LikelihoodMessage] = {}

    # fixed per-solve exchange layout (identical on every process)
    layout = (_msg_layout(fg, tree, part.cut_roots)
              if part.cut_roots else [])
    flat = (_msg_flat_layout(fg, layout,
                             joint=bool(fg.params.use_msg_likelihoods))
            if layout and nproc > 1 else None)
    owner_proc = {cid: part.owner[cid] for cid in part.cut_roots}
    cut_set = set(part.cut_roots)

    # ---- distributed tree-init fixed point ------------------------------
    # The reference's CSM runs the full init dance per clique wherever the
    # clique lives (waitForUp/initUp/tryDownInit cycling,
    # CliqueStateMachine.jl:341-417/:699-858, over Distributed workers via
    # CliqStateMachineUtils.jl:349-410).  Here the same fixed point spans
    # processes: each pass runs local up sweeps (phase A), exchanges cut
    # messages (B — NO_INIT messages with partial beliefs ride the codec's
    # presence flags), solves the replicated top up+down (C — its down
    # messages cross the cut and down-init owned subtrees), local down
    # sweeps (D), then a tiny status collective (S) agrees on whether any
    # clique down-initialized anywhere; if so, the affected owned cliques
    # and their ancestors re-up and the loop repeats — bounded by
    # ``limit_treeinit_iters`` exactly like the single-process loop
    # (parallel/scheduler.py solve_tree_sweeps).
    limit = max(1, int(getattr(fg.params, "limit_treeinit_iters", 10)))
    affected: Optional[set] = None          # None => all owned (pass 0)
    for init_pass in range(limit):
        tm["init_passes"] = init_pass + 1

        # ---- phase A: local up sweeps over owned subtrees ---------------
        # A failing clique must NOT leave peer processes blocked at the
        # next collective (the cross-process analogue of the reference's
        # bruteForcePushErrorCSM flooding, CliqStateMachineUtils.jl:184-246):
        # on error this process keeps participating in every remaining
        # collective, floods ERROR_STATUS through its cut messages, skips
        # all further compute, and re-raises at the end; peers see the
        # flooded status after the exchange and abort symmetrically.
        began = start()
        min_width = getattr(fg.params, "batch_min_width", 8)
        for level in reversed(levels):
            act = [cid for cid in sorted(level)
                   if cid in my_cids and local_error is None
                   and (affected is None or cid in affected)]
            if not act:
                continue
            # process × device composition: wide OWNED levels run as one
            # batched clique-split solve on this process's mesh; narrow
            # ones fall through to per-clique solves with particle
            # splitting (the same width-aware policy as solve_tree_sweeps)
            if (mesh is not None and len(act) >= min_width
                    and bool(getattr(fg.params, "batch_cliques", False))
                    and not fail_cliques):
                from .scheduler import up_solve_level
                cls = [tree.clique(c) for c in act]
                cmo = {c: [up_msgs[ch] for ch in tree.clique(c).children
                           if ch in up_msgs] for c in act}
                try:
                    up_msgs.update(up_solve_level(fg, tree, cls, cmo,
                                                  solve_key, mesh=mesh))
                except Exception as e:        # noqa: BLE001
                    local_error = e
                    for c in act:
                        tree.clique(c).status = CliqStatus.ERROR_STATUS
                    logger.warning("multihost: batched level failed (%s); "
                                   "flooding ERROR to peers", e)
                continue
            pmesh = _sched_particle_mesh(fg.params, mesh)
            for cid in act:
                if local_error is not None:
                    continue
                cl = tree.clique(cid)
                child_msgs = [up_msgs[ch] for ch in cl.children
                              if ch in up_msgs]
                try:
                    if fail_cliques and cid in fail_cliques:
                        raise RuntimeError(
                            f"injected failure at clique {cid} (fault hook)")
                    up_msgs[cid] = up_solve_clique(fg, tree, cl, child_msgs,
                                                   solve_key, mesh=pmesh)
                except Exception as e:        # noqa: BLE001
                    local_error = e
                    cl.status = CliqStatus.ERROR_STATUS
                    logger.warning("multihost: clique %d failed (%s); "
                                   "flooding ERROR to peers", cid, e)
        if local_error is not None:
            for cid in part.cut_roots:
                if part.owner.get(cid) == pid:
                    up_msgs[cid] = LikelihoodMessage(
                        sender=cid, status=CliqStatus.ERROR_STATUS,
                        direction="up")
        stop("local_up", began)

        # ---- phase B: cut-edge up-message exchange ----------------------
        t0 = time.time()
        if layout and nproc > 1:
            gathered = _allgather(_pack_msgs(fg, layout, flat, up_msgs))
            up_msgs.update(_unpack_msgs(fg, tree, layout, flat, gathered,
                                        owner_proc))
            tm["bytes_cut"] = tm.get("bytes_cut", 0) + flat.size
        # one process: up_msgs already holds every cut message.
        # symmetric abort decision: every process sees the same flooded
        # statuses, so all take identical branches through the remaining
        # collectives (no peer ever blocks)
        remote_error = any(m.status == CliqStatus.ERROR_STATUS
                           for cid, m in up_msgs.items() if cid in cut_set)
        aborted = local_error is not None or remote_error
        tm["exchange_up_s"] += time.time() - t0

        # ---- phase C: replicated top (up then down), reseeded -----------
        began = start()
        down_msgs = {}
        top_down_inited = 0
        if top_set and not aborted:
            # every process consumed a different number of keys in phase A
            # — restart the deterministic stream (mixed with the pass
            # index) so the replicated top solves identically everywhere
            # (down messages at cut edges must agree)
            fg.reseed((fg.params.seed ^ 0x70B5EED) + 7919 * init_pass)
            if nproc > 1 and init_pass == 0:
                # adopt process 0's beliefs for every top-clique variable:
                # the replicated top is only bit-identical if its INPUT
                # beliefs are — and user-side graph mutations between
                # solves (add_factor graphinit) consume each process's
                # diverged key stream, so top-variable init beliefs can
                # differ.  Later passes start from the (already identical)
                # pass-0 top solution.
                _broadcast_top_beliefs(fg, tree, part, solve_key)
            # the top is replicated, so a data-driven failure here usually
            # hits every process identically — but an asymmetric one (e.g.
            # host OOM) must still reach the status collective, where the
            # error flag unblocks the peers
            try:
                for level in reversed(levels):
                    for cid in sorted(level):
                        if cid not in top_set:
                            continue
                        cl = tree.clique(cid)
                        child_msgs = [up_msgs[ch] for ch in cl.children
                                      if ch in up_msgs]
                        up_msgs[cid] = up_solve_clique(fg, tree, cl,
                                                       child_msgs, solve_key)
                for level in levels:
                    for cid in sorted(level):
                        if cid not in top_set:
                            continue
                        cl = tree.clique(cid)
                        child_up = [up_msgs[ch] for ch in cl.children
                                    if ch in up_msgs]
                        out = down_solve_clique(fg, tree, cl,
                                                down_msgs.get(cid),
                                                solve_key,
                                                child_msgs=child_up)
                        down_msgs.update(out)
                        if getattr(cl, "down_inited", False):
                            top_down_inited += 1
            except Exception as e:            # noqa: BLE001
                local_error = e
                aborted = True
        stop("top", began)

        # ---- phase D: local down sweeps into owned subtrees -------------
        began = start()
        local_down_inited: set = set()
        if not aborted:
            for level in levels:
                if local_error is not None:
                    # a failed down-solve poisons every descendant (their
                    # parent down message is missing): stop the whole
                    # phase, don't keep solving garbage or overwrite
                    # local_error with cascading secondary exceptions
                    break
                for cid in sorted(level):
                    if cid not in my_cids:
                        continue
                    cl = tree.clique(cid)
                    child_up = [up_msgs[ch] for ch in cl.children
                                if ch in up_msgs]
                    try:
                        out = down_solve_clique(
                            fg, tree, cl, down_msgs.get(cid), solve_key,
                            child_msgs=child_up,
                            mesh=_sched_particle_mesh(fg.params, mesh))
                        down_msgs.update(out)
                        if getattr(cl, "down_inited", False):
                            local_down_inited.add(cid)
                    except Exception as e:    # noqa: BLE001
                        local_error = e
                        cl.status = CliqStatus.ERROR_STATUS
                        break
        stop("local_down", began)

        # ---- phase S: symmetric continue/abort decision -----------------
        # one tiny collective: [n_down_inited, errored] per process; every
        # process computes the identical (continue, abort) branch so the
        # per-pass collective count always matches
        n_init = len(local_down_inited)
        if nproc > 1:
            st = _allgather(np.asarray(
                [float(n_init),
                 1.0 if local_error is not None else 0.0], np.float32))
            total_inited = int(round(float(st[:, 0].sum())))
            any_error = bool((st[:, 1] > 0.5).any())
        else:
            total_inited = n_init
            any_error = local_error is not None
        # top down-inits are replicated-deterministic: identical count on
        # every process, so adding them keeps the decision symmetric
        total_inited += top_down_inited
        if any_error or aborted:
            aborted = True
            break
        if total_inited == 0:
            break
        # next pass: re-up the down-inited owned cliques plus their owned
        # ancestors (the replicated top re-solves fully each pass)
        affected = set()
        for cid in local_down_inited:
            cur: Optional[int] = cid
            while cur is not None and cur not in affected:
                affected.add(cur)
                cur = tree.clique(cur).parent
        affected &= my_cids

    still_no_init = [c.cid for c in tree.cliques.values()
                     if (c.cid in my_cids or c.cid in top_set)
                     and c.status == CliqStatus.NO_INIT]
    if still_no_init and not aborted:
        logger.warning(
            "multihost tree init incomplete after %d passes; cliques %s "
            "remain NO_INIT (graph lacks initializing information)",
            tm["init_passes"], still_no_init)

    # ---- phase E: posterior broadcast (always participates) -------------
    t0 = time.time()
    error_pids: set = set()
    if nproc > 1:
        error_pids = _sync_beliefs(fg, tree, part, solve_key,
                                   errored=local_error is not None,
                                   solved=not aborted, timings=tm)
    tm["sync_s"] = _wall(fg) - t0

    tree.up_msgs = up_msgs
    tree.down_msgs = down_msgs
    if local_error is not None:
        raise RuntimeError(
            "multihost solve failed on this process") from local_error
    if aborted or error_pids:
        raise RuntimeError(
            f"multihost solve failed on peer process(es) "
            f"{sorted(error_pids) or '(flooded via cut messages)'}")
    for v in fg.variables.values():
        if v.solvable and v.is_initialized(solve_key):
            v.solved_count[solve_key] = v.get_solved_count(solve_key) + 1
    fg.solve_count += 1
    return tree


def _broadcast_top_beliefs(fg, tree, part: TreePartition,
                           solve_key: str) -> None:
    """Adopt process 0's beliefs for all variables of the replicated top
    cliques (one collective) so the top phase runs on identical inputs
    everywhere.  A presence flag handles vars process 0 has no belief for."""
    top_vars = sorted({v for cid in part.top
                       for v in tree.clique(cid).all_vars})
    if not top_vars:
        return
    pid = _process_index()
    flat = _FlatLayout()
    for v in top_vars:
        flat.add((v, "has"), (1,))
        _belief_slots(flat, v, fg.var(v))
    buf = np.zeros((flat.size,), np.uint8)
    if pid == 0:
        for v in top_vars:
            var = fg.var(v)
            if solve_key in var.beliefs:
                flat.write(buf, (v, "has"), [1.0])
                flat.write_belief(buf, v, var.beliefs[solve_key])
    row = _allgather(buf)[0]
    # process 0 adopts its own DECODED row too: with the scaled-f16 wire
    # encoding the decoded values differ from the local f32 originals at
    # ~1e-4, and the replicated top is only bit-identical across processes
    # if every process starts from the identical (decoded) inputs
    for v in top_vars:
        if float(flat.read(row, (v, "has"))[0]) > 0.5:
            fg.var(v).beliefs[solve_key] = flat.read_belief(row, v,
                                                            fg.device)
            fg.var(v).initialized[solve_key] = True


def _sync_beliefs(fg, tree, part: TreePartition, solve_key: str,
                  errored: bool = False, solved: bool = True,
                  timings: Optional[dict] = None) -> set:
    """Broadcast each part's solved frontal beliefs to every process (one
    collective); afterwards every process's graph holds the full
    posterior.  A per-process error flag rides in the same buffer so a
    failed process never contributes junk beliefs AND peers learn about
    failures even on partitions with no cut edges (pure forests); a
    per-variable presence flag (like :func:`_broadcast_top_beliefs`)
    ensures a process that aborted without a *local* error (``solved=
    False`` — e.g. a flooded remote failure left it with stale
    post-graphinit beliefs) never publishes those as the posterior.
    Returns the set of process ids that flagged an error."""
    # deterministic layout: (var, owning part) over all part-owned frontals
    layout: List[Tuple[str, int]] = []
    for p, cids in enumerate(part.part_cliques):
        for cid in sorted(cids):
            for v in tree.clique(cid).frontals:
                layout.append((v, p))
    pid = _process_index()
    flat = _FlatLayout()
    flat.add("__error__", (1,))
    for v, p in layout:
        flat.add((v, "has"), (1,))
        _belief_slots(flat, v, fg.var(v))
    if timings is not None:
        timings["bytes_sync"] = flat.size
    buf = np.zeros((flat.size,), np.uint8)
    flat.write(buf, "__error__", [1.0 if errored else 0.0])
    for v, p in layout:
        var = fg.var(v)
        if p == pid and solved and not errored and solve_key in var.beliefs:
            flat.write(buf, (v, "has"), [1.0])
            flat.write_belief(buf, v, var.beliefs[solve_key])
    gathered = _allgather(buf)
    error_pids = {p for p in range(gathered.shape[0])
                  if float(flat.read(gathered[p], "__error__")[0]) > 0.5}
    for v, p in layout:
        if p in error_pids:
            continue                       # junk row
        # owners adopt their own decoded row as well (f16 wire encoding:
        # every process must end with the IDENTICAL posterior bytes)
        row = gathered[p]
        if float(flat.read(row, (v, "has"))[0]) <= 0.5:
            continue                       # peer had no solved belief
        fg.var(v).beliefs[solve_key] = flat.read_belief(row, v, fg.device)
        fg.var(v).initialized[solve_key] = True
    return error_pids - {pid}


# --------------------------------------------------------------------------
# parametric multi-process solve (Gaussian messages over the same partition)
# --------------------------------------------------------------------------

def _param_msg_layout(fg, tree, cids):
    """(cid, seps, dof_total) layout for cut-edge Gaussian messages."""
    out = []
    for cid in sorted(cids):
        seps = list(tree.clique(cid).separator)
        dof = sum(fg.var(v).manifold.dof for v in seps)
        out.append((cid, seps, dof))
    return out


def _param_flat_layout(fg, layout) -> _FlatLayout:
    flat = _FlatLayout()
    for cid, seps, dof in layout:
        for v in seps:
            flat.add((cid, v, "point"), (fg.var(v).manifold.point_dim,))
        flat.add((cid, "cov"), (dof, dof))
    return flat


def solve_tree_parametric_multihost(fg, order=None,
                                    partition: Optional[TreePartition] = None,
                                    timings: Optional[dict] = None):
    """Distributed clique-wise parametric solve (reference
    solveTree!(…; algorithm=:parametric) under the WORKERPOOL axis):
    same subtree partition and phase structure as
    :func:`solve_tree_multihost`, with joint-Gaussian separator messages
    (means + covariance blocks — tiny fixed-shape payloads) as the only
    cross-process traffic.  The parametric LM is deterministic, so the
    replicated top needs no key-stream handling.  ``timings`` as for
    :func:`solve_tree_multihost`."""
    from ..parametric.cliques import (GaussianMessage, _attach_message,
                                      _finalize_clique, _marginal_message)
    from ..parametric.solver import (ParametricProblem, autoinit_parametric,
                                     init_parametric_from,
                                     solve_problems_batched)
    from ..tree.bayestree import build_tree_reset

    pid = _process_index()
    nproc = _process_count()
    tm = timings if timings is not None else {}
    tm.update({"local_up_s": 0.0, "top_s": 0.0, "local_down_s": 0.0})
    start, stop = _phase_clock(fg, tm)

    if any(fg.var(v).parametric_point is None for v in fg.ls()):
        init_parametric_from(fg, only_missing=True)
    if any(fg.var(v).parametric_point is None for v in fg.ls()):
        autoinit_parametric(fg)

    tree = build_tree_reset(fg, order=order)
    part = partition or partition_tree(tree, nproc)
    my_cids = set(part.part_cliques[pid]) if pid < part.n_parts else set()
    top_set = set(part.top)
    levels = tree.levels()
    up_msgs: Dict[int, GaussianMessage] = {}

    def frontals_back(sub, cl):
        for v in cl.frontals:
            fv = fg.var(v)
            fv.parametric_point = sub.var(v).parametric_point
            fv.parametric_cov = sub.var(v).parametric_cov

    def up_one(cl):
        sub = build_clique_subgraph(fg, cl)
        for ch in cl.children:
            if ch in up_msgs:
                _attach_message(sub, up_msgs[ch], "up")
        prob = ParametricProblem(sub)
        (points, cov, _), = solve_problems_batched([prob])
        _finalize_clique(prob, sub, points, cov)
        up_msgs[cl.cid] = _marginal_message(prob, sub, cl)
        cl.status = CliqStatus.UPSOLVED
        frontals_back(sub, cl)

    def down_one(cl):
        if cl.parent is None:
            cl.status = CliqStatus.DOWNSOLVED
            return
        sub = build_clique_subgraph(fg, cl)
        for ch in cl.children:
            if ch in up_msgs:
                _attach_message(sub, up_msgs[ch], "dwn")
        prob = ParametricProblem(sub, frozen=cl.separator)
        (points, cov, _), = solve_problems_batched([prob])
        _finalize_clique(prob, sub, points, cov)
        cl.status = CliqStatus.DOWNSOLVED
        frontals_back(sub, cl)

    began = start()
    for level in reversed(levels):
        for cid in sorted(level):
            if cid in my_cids:
                up_one(tree.clique(cid))
    stop("local_up", began)

    # cut-edge Gaussian message exchange (one collective)
    t0 = time.time()
    if part.cut_roots and nproc > 1:
        layout = _param_msg_layout(fg, tree, part.cut_roots)
        flat = _param_flat_layout(fg, layout)
        buf = np.zeros((flat.size,), np.uint8)
        for cid, seps, dof in layout:
            m = up_msgs.get(cid)
            if m is None:
                continue
            for v, p in zip(m.variables, m.points):
                flat.write(buf, (cid, v, "point"), p)
            flat.write(buf, (cid, "cov"), m.cov)
        gathered = _allgather(buf)
        for cid, seps, dof in layout:
            if cid in up_msgs:
                continue                      # owner keeps its own
            row = gathered[part.owner[cid]]
            pts = [_tensor(flat.read(row, (cid, v, "point")), fg.device)
                   for v in seps]
            cov = _tensor(flat.read(row, (cid, "cov")), fg.device)
            up_msgs[cid] = GaussianMessage(
                cid, seps, pts, cov, [fg.var(v).manifold.dof for v in seps])
    tm["exchange_up_s"] = time.time() - t0

    # replicated top (deterministic LM — no reseed needed), then local down
    began = start()
    for level in reversed(levels):
        for cid in sorted(level):
            if cid in top_set:
                up_one(tree.clique(cid))
    for level in levels:
        for cid in sorted(level):
            if cid in top_set:
                down_one(tree.clique(cid))
    stop("top", began)

    began = start()
    for level in levels:
        for cid in sorted(level):
            if cid in my_cids:
                down_one(tree.clique(cid))
    stop("local_down", began)

    # posterior broadcast: parametric point + covariance per owned frontal
    t0 = time.time()
    if nproc > 1:
        layout2: List[Tuple[str, int]] = []
        for p, cids in enumerate(part.part_cliques):
            for cid in sorted(cids):
                for v in tree.clique(cid).frontals:
                    layout2.append((v, p))
        if layout2:
            flat2 = _FlatLayout()
            for v, p in layout2:
                m = fg.var(v).manifold
                flat2.add((v, "point"), (m.point_dim,))
                flat2.add((v, "cov"), (m.dof, m.dof))
            buf2 = np.zeros((flat2.size,), np.uint8)
            for v, p in layout2:
                fv = fg.var(v)
                if p == pid and fv.parametric_point is not None:
                    flat2.write(buf2, (v, "point"), fv.parametric_point)
                    flat2.write(buf2, (v, "cov"), fv.parametric_cov)
            g2 = _allgather(buf2)
            for v, p in layout2:
                if p == pid:
                    continue
                row = g2[p]
                fg.var(v).parametric_point = _tensor(
                    flat2.read(row, (v, "point")), fg.device)
                fg.var(v).parametric_cov = _tensor(
                    flat2.read(row, (v, "cov")), fg.device)
    tm["sync_s"] = time.time() - t0
    tree.up_msgs = up_msgs
    fg.solve_count += 1
    return tree


# --------------------------------------------------------------------------
# localhost launcher
# --------------------------------------------------------------------------

_FIXTURES = ("chain", "forest", "anchored_forest", "se2_chain",
             "chain_end_prior", "anchored_forest_noinit",
             "multihypo_forest")


def build_fixture(name: str, scale: int = 8, params=None, device=None):
    """Deterministic multi-process test fixtures, on ``device`` (CUDA
    unless the caller names another, as ``initfg``).

    - ``chain``: LineStep-style pose chain (deep tree, cut edges on the
      critical path — exercises the exchange, poor scaling by design);
    - ``forest``: ``scale`` independent prior+relative branches (no top, no
      cut edges — pure clique-parallel scaling);
    - ``anchored_forest``: ``scale`` branches all tied to one anchor
      variable (top = anchor clique, one cut edge per branch — the
      realistic multi-session SLAM shape);
    - ``chain_end_prior``: chain whose ONLY prior sits at the root-side
      end with graphinit disabled — bottom subtrees cannot up-init, so
      the solve REQUIRES init information to flow down through the cut
      edges and back up (the distributed tree-init fixed point);
    - ``multihypo_forest``: anchored branches each carrying a 2-door
      multihypo data-association factor (HypoRecipe masks + nullSurplus
      under the partition)."""
    from .. import (ContinuousScalar, LinearRelative, Normal, Prior, initfg)
    from ..config import SolverParams

    if params is None and name in ("chain_end_prior",
                                   "anchored_forest_noinit"):
        # graph-level auto-init must stay off so initialization happens
        # INSIDE the tree solve (the reference's tryDownInit path)
        params = SolverParams(N=64, graphinit=False)
    if name == "anchored_forest_noinit":
        # same graph as anchored_forest, but with graphinit disabled EVERY
        # owned subtree is prior-less and NO_INIT after its local up pass:
        # initialization must flow from the replicated top (anchor prior)
        # down through every cut edge and back up, on every process
        return build_fixture("anchored_forest", scale, params=params,
                             device=device)
    fg = initfg(params or SolverParams(N=64), device=device)
    if name == "chain":
        fg.add_variable("x0", ContinuousScalar)
        fg.add_factor(["x0"], Prior(Normal(0.0, 0.5)))
        for i in range(1, scale):
            fg.add_variable(f"x{i}", ContinuousScalar)
            fg.add_factor([f"x{i-1}", f"x{i}"],
                          LinearRelative(Normal(1.0, 0.5)))
    elif name == "forest":
        for b in range(scale):
            fg.add_variable(f"b{b}x0", ContinuousScalar)
            fg.add_factor([f"b{b}x0"], Prior(Normal(float(b), 0.5)))
            for i in (1, 2):
                fg.add_variable(f"b{b}x{i}", ContinuousScalar)
                fg.add_factor([f"b{b}x{i-1}", f"b{b}x{i}"],
                              LinearRelative(Normal(1.0, 0.5)))
    elif name == "se2_chain":
        # SE(2) pose chain: manifold beliefs (point_dim != dof) through
        # the cut-edge codec and the replicated top
        from .. import ManifoldFactor, ManifoldPrior, MvNormal, VariableType
        from ..manifolds import SE2

        se2 = SE2()
        pose2 = VariableType("Pose2", se2)
        fg.add_variable("x0", pose2)
        fg.add_factor(["x0"], ManifoldPrior(
            se2, torch.zeros(3), MvNormal([0.0] * 3, [0.05, 0.05, 0.02])))
        z = MvNormal([1.0, 0.0, 0.1], [0.05, 0.05, 0.02])
        for i in range(1, scale):
            fg.add_variable(f"x{i}", pose2)
            fg.add_factor([f"x{i-1}", f"x{i}"], ManifoldFactor(se2, z))
    elif name == "anchored_forest":
        fg.add_variable("anchor", ContinuousScalar)
        fg.add_factor(["anchor"], Prior(Normal(0.0, 0.5)))
        for b in range(scale):
            fg.add_variable(f"b{b}x0", ContinuousScalar)
            fg.add_factor(["anchor", f"b{b}x0"],
                          LinearRelative(Normal(float(b), 0.5)))
            for i in (1, 2):
                fg.add_variable(f"b{b}x{i}", ContinuousScalar)
                fg.add_factor([f"b{b}x{i-1}", f"b{b}x{i}"],
                              LinearRelative(Normal(1.0, 0.5)))
    elif name == "chain_end_prior":
        # identical chain, but the ONLY prior anchors the LAST pose (the
        # root side of the elimination order) and graphinit is off: the
        # leaf-side subtrees emit NO_INIT up the cut until the replicated
        # top's down messages initialize them
        for i in range(scale):
            fg.add_variable(f"x{i}", ContinuousScalar)
            if i:
                fg.add_factor([f"x{i-1}", f"x{i}"],
                              LinearRelative(Normal(1.0, 0.5)),
                              graphinit=False)
        fg.add_factor([f"x{scale-1}"],
                      Prior(Normal(float(scale - 1), 0.5)), graphinit=False)
    elif name == "multihypo_forest":
        fg.add_variable("anchor", ContinuousScalar)
        fg.add_factor(["anchor"], Prior(Normal(0.0, 0.5)))
        for b in range(scale):
            for d, off in (("d0", 0.0), ("d1", 50.0)):
                fg.add_variable(f"b{b}{d}", ContinuousScalar)
                fg.add_factor([f"b{b}{d}"], Prior(Normal(b + off, 0.3)))
            fg.add_variable(f"b{b}mx", ContinuousScalar)
            fg.add_factor(["anchor", f"b{b}mx"],
                          LinearRelative(Normal(float(b), 1.0)))
            fg.add_factor([f"b{b}mx", f"b{b}d0", f"b{b}d1"],
                          LinearRelative(Normal(0.0, 0.3)),
                          multihypo=[1.0, 0.5, 0.5])
    else:
        raise ValueError(f"unknown fixture {name!r} (use {_FIXTURES})")
    return fg


def fixture_truth(name: str, scale: int = 8) -> Dict[str, object]:
    """Ground-truth posterior means of :func:`build_fixture` graphs
    (scalars for 1-D fixtures; (x, y) position arrays for se2_chain)."""
    if name == "chain":
        return {f"x{i}": float(i) for i in range(scale)}
    if name == "se2_chain":
        from ..manifolds import SE2

        se2 = SE2()
        truth = {}
        p = se2.identity()
        truth["x0"] = p[:2].numpy()
        for i in range(1, scale):
            p = se2.compose(p, se2.Exp(torch.tensor([1.0, 0.0, 0.1])))
            truth[f"x{i}"] = p[:2].numpy()
        return truth
    if name == "forest":
        return {f"b{b}x{i}": float(b + i)
                for b in range(scale) for i in range(3)}
    if name == "chain_end_prior":
        return {f"x{i}": float(i) for i in range(scale)}
    if name == "anchored_forest_noinit":
        return fixture_truth("anchored_forest", scale)
    if name == "multihypo_forest":
        truth = {"anchor": 0.0}
        for b in range(scale):
            truth[f"b{b}d0"] = float(b)
            truth[f"b{b}d1"] = float(b + 50)
            # posterior concentrates on the d0 association (the anchor
            # relative pins mx near b; d1 is 50 sigma away)
            truth[f"b{b}mx"] = float(b)
        return truth
    truth = {"anchor": 0.0}
    for b in range(scale):
        for i in range(3):
            truth[f"b{b}x{i}"] = float(b + i)
    return truth


def _np(x) -> np.ndarray:
    return x.detach().to("cpu").numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _worker_main(argv=None) -> None:
    """Entry point for one launched process: join the process group (gloo,
    meeting at the ``--store`` file; its sockets on loopback), build the
    fixture on ``--device``, run the multi-process solve twice (cold +
    warm), report truth errors, phase timings and kernel launches as one
    JSON line."""
    import argparse
    import datetime
    import json
    import sys

    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--store", required=True,
                    help="file the process group meets at (file://)")
    ap.add_argument("--fixture", default="anchored_forest")
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--N", type=int, default=64,
                    help="particles per variable")
    ap.add_argument("--device", default="cuda",
                    help="the device this process computes on")
    ap.add_argument("--devices-per-proc", type=int, default=1,
                    help="devices in this process's mesh (--mesh)")
    ap.add_argument("--pg-timeout", type=float, default=600.0,
                    help="seconds a collective may wait for a peer")
    ap.add_argument("--algorithm", default="default",
                    choices=("default", "parametric"))
    ap.add_argument("--grow", type=int, default=0)
    ap.add_argument("--fail-clique", type=int, default=-1)
    ap.add_argument("--use-joint", action="store_true",
                    help="use_msg_likelihoods=True (joint up-messages "
                         "through the cut-edge codec)")
    ap.add_argument("--mesh", action="store_true",
                    help="compose with an in-process device mesh of "
                         "--devices-per-proc copies of --device "
                         "(process x device axes)")
    ap.add_argument("--batch-min-width", type=int, default=0,
                    help="override SolverParams.batch_min_width (>0)")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)

    from ..config import resolve_device

    device = resolve_device(a.device)
    if device.type == "cpu":
        # every child of a launch computes with the same thread count (CPU
        # reductions split by it), and two keep a launch inside the cores
        # a test worker has
        torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", init_method=f"file://{a.store}",
        world_size=a.nproc, rank=a.pid,
        timeout=datetime.timedelta(seconds=a.pg_timeout))

    results = {"pid": a.pid, "nproc": a.nproc, "device": str(device),
               "N": a.N, "devices": a.nproc * a.devices_per_proc,
               "local_devices": a.devices_per_proc}

    local_mesh = None
    if a.mesh:
        from .mesh import Mesh
        local_mesh = Mesh([device] * a.devices_per_proc, ("d",))
        results["mesh_devices"] = len(local_mesh.devices)

    def finish():
        if a.out:
            with open(a.out, "w") as fp:
                json.dump(results, fp)
        print(json.dumps(results), flush=True)
        dist.barrier()
        dist.destroy_process_group()
        sys.stdout.flush()

    if a.fixture == "fourdoor":
        # the fourdoor incremental sequence (reference fourdoortest.jl:12-54)
        # across processes: 3 multihost solves with old_tree= recycling;
        # reports the reference's mode-mass bars
        from ..canonical import fourdoor_sequence
        from ..config import SolverParams

        p = SolverParams(N=128, use_msg_likelihoods=a.use_joint)
        fg, steps = fourdoor_sequence(p, device=device)
        tree = None
        t0 = time.time()
        for s in steps:
            s()
            tree = solve_tree_multihost(fg, old_tree=tree)

        def mass(v, c, tol=20.0):
            pts = _np(fg.points(v)[:, 0])
            return float(np.mean(np.abs(pts - c) < tol))

        results["fourdoor"] = {
            "x1_0": mass("x1", 0.0), "x2_50": mass("x2", 50.0),
            "x3_100": mass("x3", 100.0), "x4_300": mass("x4", 300.0),
            "means": {v: float(_np(fg.points(v)[:, 0]).mean())
                      for v in ("x1", "x2", "x3", "x4")},
            "n_recycled": sum(c.is_recycled
                              for c in tree.cliques.values()),
            "wall_s": time.time() - t0}
        finish()
        return

    truth = fixture_truth(a.fixture, a.scale)

    def fixture_params():
        from ..config import SolverParams

        # the per-fixture graphinit contract of build_fixture, at --N
        p = SolverParams(
            N=a.N, use_msg_likelihoods=a.use_joint,
            graphinit=(a.fixture not in ("chain_end_prior",
                                         "anchored_forest_noinit")))
        if a.batch_min_width > 0:
            p = p.replace(batch_min_width=a.batch_min_width,
                          batch_cliques="auto")
        return p

    def solve_and_report(fg, tree_in=None):
        tm: dict = {}
        t0 = _wall(fg)
        if a.algorithm == "parametric":
            tree = solve_tree_parametric_multihost(fg, timings=tm)
        else:
            tree = solve_tree_multihost(fg, timings=tm, old_tree=tree_in,
                                        mesh=local_mesh)
        tm["total_s"] = _wall(fg) - t0
        errs = {}
        means = {}
        for v, mu in truth.items():
            if a.algorithm == "parametric":
                est = _np(fg.var(v).parametric_point)
            else:
                est = _np(fg.points(v)).mean(0)
            means[v] = float(est[0])
            if isinstance(mu, np.ndarray):       # manifold truth: position
                errs[v] = float(np.linalg.norm(est[:len(mu)] - mu))
            else:
                errs[v] = abs(float(est[0]) - mu)
        return tree, {
            "timings": tm, "max_err": max(errs.values()),
            "mean_err": float(np.mean(list(errs.values()))),
            "n_cliques": tree.num_cliques(),
            "n_recycled": sum(c.is_recycled for c in tree.cliques.values()),
            "means": means,
        }

    if a.fail_clique >= 0:
        # fault-injection mode: one solve with an injected clique failure;
        # record how this process exited (local error vs flooded peer
        # error) — the launcher's caller asserts BOTH processes aborted
        # promptly
        fg = build_fixture(a.fixture, a.scale, params=fixture_params(),
                           device=device)
        t0 = time.time()
        try:
            solve_tree_multihost(fg, fail_cliques={a.fail_clique})
            results["fault"] = {"outcome": "no-error"}
        except RuntimeError as e:
            results["fault"] = {"outcome": "error", "message": str(e),
                                "wall_s": time.time() - t0}
        finish()
        return

    for phase in ("cold", "warm"):
        fg = build_fixture(a.fixture, a.scale, params=fixture_params(),
                           device=device)
        ALLGATHER_STATS.update(count=0, wall_s=0.0)
        tree, results[phase] = solve_and_report(fg)
        results[phase]["collectives"] = dict(ALLGATHER_STATS)
    if a.nproc > 1:
        # per-collective latency probes: median wall of a bare allgather
        # at two payload sizes, so collective cost = count x latency can
        # be checked against the measured exchange/sync phases
        import statistics
        probes = {}
        for label, size in (("8B", 2), ("16kB", 4096)):
            buf = np.zeros((size,), np.float32)
            ts = []
            for _ in range(20):
                t0 = time.time()
                _allgather(buf)
                ts.append(time.time() - t0)
            probes[label] = statistics.median(ts)
        results["collective_latency_s"] = probes
    if a.grow and a.algorithm == "default":
        # incremental phase: extend the warm fixture's graph and re-solve
        # with old_tree= — recycling must engage across the partition
        from .. import ContinuousScalar, LinearRelative, Normal
        base = "b0x2" if a.fixture != "chain" else f"x{a.scale-1}"
        prev = base
        for g in range(a.grow):
            lbl = f"g{g}"
            fg.add_variable(lbl, ContinuousScalar)
            fg.add_factor([prev, lbl], LinearRelative(Normal(1.0, 0.5)))
            prev = lbl
        truth = dict(truth)
        base_mu = truth[base]
        for g in range(a.grow):
            truth[f"g{g}"] = base_mu + g + 1
        _, results["incr"] = solve_and_report(fg, tree_in=tree)
    finish()


def launch_multihost(n_procs: int, fixture: str = "anchored_forest",
                     scale: int = 8, devices_per_proc: int = 2,
                     timeout: float = 600.0,
                     algorithm: str = "default",
                     grow: int = 0, fail_clique: int = -1,
                     use_joint: bool = False,
                     mesh: bool = False,
                     batch_min_width: int = 0,
                     N: int = 64, device: str = "cuda") -> List[dict]:
    """Spawn ``n_procs`` localhost processes that jointly solve the fixture
    with :func:`solve_tree_multihost` on ``device`` (several may share one
    GPU); returns each process's JSON report.  The reference's
    ``addprocs(2)`` + multiproc ``solveTree!`` test
    (test/testMultiprocess.jl:4-13).

    ``devices_per_proc`` is the size of each process's mesh (``mesh=True``:
    that many copies of ``device``); ``N`` the particles per variable.
    Each process's collectives time out after ``timeout`` seconds, and
    every child still running when ``timeout`` has passed since the launch
    is killed, so a dead peer cannot hang the caller."""
    import json
    import os
    import shutil
    import subprocess
    import sys
    import tempfile

    outdir = tempfile.mkdtemp(prefix="iitorch_mh_")
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs, outs = [], []
    try:
        for pid in range(n_procs):
            out = os.path.join(outdir, f"p{pid}.json")
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "incrementalinference_torch.parallel.multihost",
                 "--pid", str(pid), "--nproc", str(n_procs),
                 "--store", os.path.join(outdir, "store"),
                 "--fixture", fixture,
                 "--scale", str(scale), "--N", str(N),
                 "--device", str(device),
                 "--devices-per-proc", str(devices_per_proc),
                 "--pg-timeout", str(timeout),
                 "--algorithm", algorithm,
                 "--grow", str(grow), "--fail-clique", str(fail_clique),
                 "--out", out] + (["--use-joint"] if use_joint else [])
                + (["--mesh"] if mesh else [])
                + (["--batch-min-width", str(batch_min_width)]
                   if batch_min_width > 0 else []),
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        deadline = time.time() + timeout
        reports, errors = [], []
        for pid, p in enumerate(procs):
            try:
                stdout, _ = p.communicate(
                    timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, _ = p.communicate()
                errors.append(f"process {pid} timed out:\n"
                              + stdout.decode(errors="replace")[-2000:])
                continue
            if p.returncode != 0:
                errors.append(f"process {pid} rc={p.returncode}:\n"
                              + stdout.decode(errors="replace")[-2000:])
                continue
            with open(outs[pid]) as fp:
                reports.append(json.load(fp))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(outdir, ignore_errors=True)
    if errors:
        raise RuntimeError("multihost launch failed:\n" + "\n".join(errors))
    return reports


if __name__ == "__main__":
    _worker_main()
