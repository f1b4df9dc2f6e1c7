"""Spans and counters at the port's layer boundaries, recorded while a
``torch.profiler`` session records and at no other time.

The one tracing system of the port.  It has no switch of its own: each
boundary reads ``torch.autograd.profiler._is_profiler_enabled``, the flag
that ``torch.profiler.profile`` sets on entry and clears on exit, and
records only while it is set.  With the flag clear a boundary reads it and
marks the session ended, and does nothing else: no span object, no clock
read, no allocation, no lock.

- A **span** records its name, start and end on ``time.perf_counter_ns()``,
  its parent (the innermost span open on its thread), its root (the
  top-level API call that began it: every span of one ``solve_tree``
  shares it), its thread, and attributes.  :func:`spanned` puts a function
  in one (its attributes from the call's arguments); :func:`span` is the
  context manager for a block (``sp.attrs``; ``None`` is what the ``with``
  gives while nothing records).
- A **counter** (:func:`count`) adds to the innermost span open on its
  thread and to the session's total.
- A **session** begins at the first boundary that finds the flag set after
  one, or a :func:`snapshot`, that found it clear (or at the first boundary
  ever), and clears the session before it.  Where its first span names a
  CUDA device, it first launches one ``torch.cuda._sleep`` marker of
  ``MARKER_CYCLES`` on that device's current stream, keeps the host time
  of the launch, and records a timing ``torch.cuda.Event`` behind it.  A
  reader puts the spans on the device trace's clock by the marker's
  start: its start in the trace less :func:`snapshot`'s ``marker_ns`` is
  the offset.  The event reads the marker's end, since the host records
  it while the marker still spins (an event recorded on an idle device
  reads the moment the host got to it, hundreds of microseconds late in
  a fresh profiler session): it is the origin of the stream marks below.
- A span opened with ``marks=True`` on the marker's CUDA device also
  records a timing event on the device's current stream as it begins and
  as it ends.  Operations on one stream run in the order they were
  launched, so the operations the span launched on that stream are those
  that run between its two marks, whenever the device got to them.
  :func:`snapshot` gives each mark's device time after the marker's end
  (``device_us``).  The events' clock and the profiler trace's part: on
  an H100 by up to 600 parts per million over a session and by some tens
  of microseconds from one session to the next, so on the trace's clock a
  mark stands within that of the kernel boundary it follows.
- Everything stays in memory; :func:`snapshot` returns the current
  session.  Nothing is exported and nothing goes into the profiler's own
  events (no ``record_function``, no NVTX range): the marker is the only
  kernel the recorder adds, an event record is no operation of the
  trace, and a boundary never reads the device (no ``.item()``, no
  synchronize; only :func:`snapshot` waits for the marks it reads).

Each thread keeps its own stack of open spans, so graphs solved on several
threads at once nest their spans apart; session totals are taken under a
lock.

Operator's use::

    from torch.profiler import ProfilerActivity, profile
    import incrementalinference_torch as it

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        it.solve_tree(fg)
    spans = it.tracing.snapshot()["spans"]

Take the snapshot after the ``with`` and before the next session: a
session that follows with no port call and no snapshot between the two
(nothing saw the flag clear) adds to the one before.

The device events of ``prof.events()`` and the spans then share one clock
through the marker (``bench_port/lib/program_trace.py`` does this).
"""

from __future__ import annotations

import functools
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ["span", "spanned", "count", "snapshot", "wall_time", "Span"]

#: cycles the session's marker kernel spins: longer than the host takes to
#: record the timing event behind it, which at a profiler session's first
#: launch has exceeded 250 us on an H100 (2,000,000 cycles: about 1 ms at
#: its boost clock)
MARKER_CYCLES = 2_000_000

#: wall-clock seconds less perf_counter seconds, taken once at import: the
#: one conversion of a recorder time to the wall clock (:func:`wall_time`)
_WALL_OFFSET_S = time.time() - time.perf_counter()

_LOCK = threading.Lock()
_local = threading.local()


class _State:
    """The current session, and whether a boundary found the flag clear
    since it began (the next span then begins a new one)."""

    session = None
    stale = True


_state = _State()


class _Session:
    def __init__(self):
        self.spans = []
        self.totals = {}
        self.ids = itertools.count()
        self.marker_ns = None
        self.marker_device = None
        #: the index of the marker's device, and the timing event that
        #: reads the marker's end, the origin of every ``device_us``
        self.marker_index = None
        self.marker_event = None


class _Off:
    """What :func:`span` gives while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One recorded span; also the context manager :func:`span` gives
    while a session records."""

    __slots__ = ("session", "id", "name", "start_ns", "end_ns", "parent",
                 "root", "thread", "attrs", "counts", "marks")

    def __init__(self, session, name):
        self.session = session
        self.id = next(session.ids)
        self.name = name
        self.start_ns = self.end_ns = None
        self.parent = None
        self.root = self.id
        self.thread = threading.get_ident()
        self.attrs = {}
        self.counts = {}
        #: (stream, begin event, end event) of a span with marks, or None
        self.marks = None

    def __enter__(self):
        st = _stack()
        top = st[-1] if st else None
        if top is not None and top.session is self.session:
            self.parent, self.root = top.id, top.root
        st.append(self)
        self.session.spans.append(self)
        self.start_ns = time.perf_counter_ns()
        if self.marks is not None:
            self.marks[1].record(self.marks[0])
        return self

    def __exit__(self, *exc):
        if self.marks is not None:
            self.marks[2].record(self.marks[0])
        self.end_ns = time.perf_counter_ns()
        _stack().pop()
        return False

    def device_us(self):
        """(begin, end) of the span's marks in microseconds after the
        session marker's end on the device's clock, or None (no marks, or
        the span still open).  Waits for the end mark."""
        ref = self.session.marker_event
        if self.marks is None or self.end_ns is None or ref is None:
            return None
        self.marks[2].synchronize()
        return (1e3 * ref.elapsed_time(self.marks[1]),
                1e3 * ref.elapsed_time(self.marks[2]))

    def as_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "parent": self.parent,
                "root": self.root, "thread": self.thread,
                "attrs": dict(self.attrs), "counts": dict(self.counts),
                "device_us": self.device_us()}


def _session(device=None):
    """The session a boundary records into, begun here where the flag was
    clear at the last boundary; launches the marker where none is yet and
    ``device`` is a CUDA device."""
    s = _state.session
    if _state.stale or s is None or (
            s.marker_ns is None and getattr(device, "type", None) == "cuda"):
        with _LOCK:
            if _state.stale or _state.session is None:
                _state.session = _Session()
                _state.stale = False
            s = _state.session
            if s.marker_ns is None and \
                    getattr(device, "type", None) == "cuda":
                with torch.cuda.device(device):
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()         # makes the CUDA event beforehand
                    s.marker_ns = time.perf_counter_ns()
                    torch.cuda._sleep(MARKER_CYCLES)
                    ev.record()
                    s.marker_index = torch.cuda.current_device()
                s.marker_device = str(device)
                s.marker_event = ev
    return s


def _cuda_index(device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def span(name: str, device=None, marks: bool = False):
    """A context manager around one layer's work: a :class:`Span` while a
    profiler session records, else a shared no-op.  ``device`` (root spans:
    the graph's) lets the session's first span launch the marker; with
    ``marks`` on the marker's CUDA device the span records its two
    stream marks (not while the stream captures a CUDA graph)."""
    if not _profiler._is_profiler_enabled:
        _state.stale = True
        return _OFF
    sp = Span(_session(device), name)
    if marks and getattr(device, "type", None) == "cuda" and \
            sp.session.marker_index == _cuda_index(device) and \
            not torch.cuda.is_current_stream_capturing():
        sp.marks = (torch.cuda.current_stream(device),
                    torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
    return sp


def spanned(name: str, attrs=None, device=None):
    """Decorator: each call of the function runs inside span ``name``.
    ``attrs`` and ``device``, each called with the call's arguments and
    only while a session records, give the span's attributes (a dict) and
    the device of :func:`span`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                _state.stale = True
                return fn(*args, **kwargs)
            sp = Span(_session(device(*args, **kwargs) if device else None),
                      name)
            if attrs is not None:
                sp.attrs.update(attrs(*args, **kwargs))
            with sp:
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``: to the innermost span open on this
    thread and to the session's total (nothing while no session records)."""
    if not _profiler._is_profiler_enabled:
        _state.stale = True
        return
    s = _session()
    st = _stack()
    if st and st[-1].session is s:
        c = st[-1].counts
        c[name] = c.get(name, 0) + n
    with _LOCK:
        s.totals[name] = s.totals.get(name, 0) + n


def snapshot() -> dict:
    """The spans, counters and marker of the current session: profile a
    solve with ``torch.profiler.profile`` (any activities), then read the
    port's spans here, on the clock of the profile's device events (a CUDA
    session's marker is a ``spin_kernel`` event; its start in the trace
    less ``marker_ns`` is the offset between the two clocks).  Take it
    after the ``with`` block of the profile and before the next one: taken
    with the profiler's flag clear it ends the session, so that the next
    profile begins a session of its own.

    ``spans`` are dicts of :meth:`Span.as_dict`, in the order they began
    (``end_ns`` None while open; ``device_us`` the stream marks of a span
    opened with ``marks``, else None); ``counters`` the totals; ``marker_ns``
    the host time (``time.perf_counter_ns``) of the marker's launch, or
    None; ``marker_device`` its device.  Empty before the first
    session."""
    if not _profiler._is_profiler_enabled:
        _state.stale = True
    s = _state.session
    if s is None:
        return {"spans": [], "counters": {}, "marker_ns": None,
                "marker_device": None}
    with _LOCK:
        spans, totals = list(s.spans), dict(s.totals)
    return {"spans": [sp.as_dict() for sp in spans], "counters": totals,
            "marker_ns": s.marker_ns, "marker_device": s.marker_device}


def wall_time(perf_s: float) -> float:
    """Wall-clock seconds (``time.time()``) of a ``time.perf_counter()``
    reading, by the one offset taken when this module was imported."""
    return perf_s + _WALL_OFFSET_S
