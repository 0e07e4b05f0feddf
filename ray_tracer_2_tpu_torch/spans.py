"""The port's own spans and counters, recorded while a ``torch.profiler``
session records and at no other time.

A span site is ``with spans.span("engine.settle"): ...``. With no
profiler recording it costs one read of torch's flag
(``torch.autograd.profiler._is_profiler_enabled``, ``FLAG``) and returns
one shared no-op context. While a session records, a span opens a
profiler range of its name, its twin, so it lies on the trace's timeline
beside the kernels, and appends (name, parent, frame, start ns, end ns) to
an in-memory record. The twin is torch's C++ ``RecordFunction``
(``torch._C._profiler._RecordFunctionFast``: a ``cpu_op`` event of the
trace, about 1 us a span where ``torch.profiler.record_function``, a
``user_annotation`` that goes through the op dispatcher, takes about 10),
or ``record_function`` on a torch without it. The record's clock is the
Unix clock in nanoseconds (``time.time_ns``), the clock the profiler's
events are on: an exported Chrome trace gives an event's start as
``ts * 1000 + baseTimeNanoseconds``. The start is read once the twin is
open and the end before it closes, so each span lies inside its twin.

A session is the stretch in which span sites find the flag on. The first
span site of a session starts a new record, and the session ends at the
first span site, ``count`` or ``record`` that finds the flag off (two
profiler sessions with no call of this module between them are one
record). The record belongs to the process, not to an ``Engine``.

Counters: ``count(name, n)`` adds ``n`` to the session's counter ``name``.
At a session's start every CUDA kernel wrapper (``watch``, called by
``kernels/cuda_build.CudaKernel``) has its ``launches`` noted and its
device counts copied on the card (a ``clone`` queued in stream order, no
sync); at its end the same again. ``record()`` gives their differences,
read from the card once.

Span tree of one ``Engine.update``::

    engine.update
      engine.poll
      engine.camera          update_camera, refresh_camera, params.update
      engine.dispatch        the scene lock, for_render, the render
        renderer.render
          renderer.prepare
          megakernel.call    (plain version on the CPU, kernel on the card)
            megakernel.tables   kernel_tables and the launch checks
            megakernel.launch   launch_scratch and the launch
          renderer.blend
      engine.event           the frame's segment count copied to the host
                             and its settle events
      engine.settle          the settle of the frame before (on the CPU,
                             of this one)
        engine.settle.wait   the wait for its events
        engine.stats         its segment count read, its stats

Counters the program adds: ``device.interframe_gap_ms`` (the card's own
time from one frame's end event to the next frame's first launch call,
the mean over cards, added once a frame is settled),
``device.interframe_gaps`` (how many gaps it sums), ``engine.dispatches``
(frames dispatched by ``Engine.update``) and ``engine.dispatches_queued``
(those whose frame before had not finished on the card when their events
were recorded: the card reached them with no gap).
"""
from __future__ import annotations

import threading
import time
import weakref
from array import array

import torch
from torch.autograd import profiler as _profiler

try:
    from torch._C._profiler import _RecordFunctionFast as _twin
except ImportError:
    _twin = torch.profiler.record_function

#: the attribute of ``torch.autograd.profiler`` that is true while a
#: profiler session records (torch's own fast check, read as
#: ``_profiler._is_profiler_enabled`` on the span sites; a test pins it)
FLAG = "_is_profiler_enabled"


class _Null:
    """The shared context a span site gets when nothing records. Its
    ``__enter__`` and ``__exit__`` are ``type.__prepare__``, a C function
    that takes any arguments and returns an empty dict (false, so an
    exception goes on): a ``with`` on it runs no Python frame, half the
    cost of two Python methods."""

    __slots__ = ()
    __enter__ = __exit__ = type.__prepare__


NULL = _Null()

_session = None        # the record being written, while a session records
_last = None           # the last session's record, written or finished
_serial = 0            # sessions seen by this process
_kernels = weakref.WeakSet()
_local = threading.local()
_lock = threading.Lock()
_now = time.time_ns
_NAMES: list = []      # span names by id, and ids by name
_IDS: dict = {}


def on() -> bool:
    """Whether a profiler session records now."""
    return getattr(_profiler, FLAG)


class _Session:
    def __init__(self, serial: int):
        self.serial = serial
        # one column each, no Python object a span: the window's
        # collections have nothing more to walk
        self.names = array("i")     # index into _NAMES
        self.parents = array("q")
        self.frames = array("q")
        self.starts = array("q")
        self.ends = array("q")      # -1 while the span is open
        self.roots = 0
        self.counters: dict = {}
        self.launches: dict = {}    # card -> first launch's timing event
        self.base = _snapshot()
        self.end = None
        self.summary = None


def _snapshot() -> list:
    """(kernel, launches, {device: copy of its device counts})."""
    return [(k, k.launches, {d: c.clone() for d, c in k._counts.items()})
            for k in list(_kernels)]


def _open() -> _Session:
    global _session, _last, _serial
    with _lock:     # threads that find the flag on together open one
        if _session is None:
            _serial += 1
            _session = _last = _Session(_serial)
        return _session


def _close() -> None:
    global _session
    with _lock:
        s, _session = _session, None
    if s is not None:
        s.end = _snapshot()


def _current():
    """The session's record, opening one if the flag is on and none is
    open, closing the open one if the flag is off."""
    if getattr(_profiler, FLAG):
        return _session if _session is not None else _open()
    if _session is not None:
        _close()
    return None


class _Span:
    __slots__ = ("name", "session", "rf", "row", "stack")

    def __init__(self, name: str, session: _Session):
        self.name = name
        self.session = session

    def __enter__(self):
        rf = self.rf = _twin(self.name)
        rf.__enter__()
        s = self.session
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        name = _IDS.get(self.name)
        with _lock:     # a row's five columns, whatever thread opens one
            if name is None:
                name = _IDS.setdefault(self.name, len(_NAMES))
                _NAMES.append(self.name)
            if stack and stack[-1][0] is s:
                parent = stack[-1][1]
                frame = s.frames[parent]
            else:
                parent, frame = -1, s.roots
                s.roots += 1
            row = self.row = len(s.starts)
            s.names.append(name)
            s.parents.append(parent)
            s.frames.append(frame)
            s.ends.append(-1)
            s.starts.append(_now())
        stack.append((s, row))
        self.stack = stack

    def __exit__(self, exc_type, exc, tb):
        self.session.ends[self.row] = _now()
        stack = self.stack
        if stack and stack[-1][1] == self.row \
                and stack[-1][0] is self.session:
            stack.pop()
        self.rf.__exit__(exc_type, exc, tb)
        return None


def span(name: str):
    """A context that records the span ``name`` while a profiler session
    records, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        if _session is not None:
            _close()
        return NULL
    return _Span(name, _session if _session is not None else _open())


def count(name: str, n=1) -> None:
    """Add ``n`` to the session's counter ``name`` (nothing when no session
    records)."""
    s = _current()
    if s is not None:
        s.counters[name] = s.counters.get(name, 0) + n


def watch(kernel) -> None:
    """Note a kernel wrapper (``launches``, ``_counts`` by device, ``counts``
    naming their words, ``source``) for the session's count deltas."""
    _kernels.add(kernel)


def launch_started(device: torch.device) -> None:
    """Called just before a kernel launch call: while a session records,
    records a timing event on ``device``'s current stream, the first of the
    frame on that device (``take_starts`` hands them over)."""
    if not _profiler._is_profiler_enabled:
        return
    s = _current()
    card = card_of(device)
    if card not in s.launches:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(card))
        s.launches[card] = ev


def card_of(device: torch.device) -> torch.device:
    """``device`` with its index (``cuda`` read as the current card), the
    key of ``take_starts``."""
    if device.index is None:
        return torch.device(device.type, torch.cuda.current_device())
    return device


def take_starts() -> dict:
    """The timing events ``launch_started`` recorded since the last call,
    by card (``card_of``)."""
    s = _session
    if s is None or not s.launches:
        return {}
    out, s.launches = s.launches, {}
    return out


def _deltas(s: _Session) -> tuple[dict, dict]:
    """Launches and device counts by kernel name between the session's
    start and end (its end so far, if it records still)."""
    end = s.end if s.end is not None else _snapshot()
    start = {id(k): (n, c) for k, n, c in s.base}
    launches, counts = {}, {}
    for k, n, dev_counts in end:
        n0, c0 = start.get(id(k), (0, {}))
        name = k.source.stem
        launches[name] = launches.get(name, 0) + n - n0
        if not dev_counts:
            continue
        total = counts.setdefault(name, dict.fromkeys(k.counts, 0))
        for dev, c in dev_counts.items():
            d = c - c0[dev] if dev in c0 else c
            for key, v in zip(k.counts, d.tolist()):
                total[key] += v
    return launches, counts


def record() -> dict:
    """The last session's record: ``session`` (its ordinal in the process,
    0 before any), ``spans`` (name, parent row or -1, frame, start ns, end
    ns, the end None while it is open), ``frames`` (root spans), ``totals``
    by name (``n``, ``ms``, ``self_ms``: the duration less the part its
    children cover), ``counters``, ``launches`` and ``counts`` (device
    counts) by kernel, differences over the session. Reads the card once,
    after the session ended, and is kept from then on."""
    if _session is not None and not _profiler._is_profiler_enabled:
        _close()
    s = _last
    if s is None:
        return dict(session=0, spans=[], frames=0, totals={}, counters={},
                    launches={}, counts={})
    if s.summary is not None:
        return s.summary
    launches, counts = _deltas(s)
    spans = [(_NAMES[n], p, f, a, None if b < 0 else b) for n, p, f, a, b
             in zip(s.names, s.parents, s.frames, s.starts, s.ends)]
    child = [0] * len(spans)
    for _, parent, _, a, b in spans:
        if parent >= 0 and b is not None:
            child[parent] += b - a
    totals: dict = {}
    for i, (name, _, _, a, b) in enumerate(spans):
        if b is None:
            continue
        t = totals.setdefault(name, dict(n=0, ms=0.0, self_ms=0.0))
        t["n"] += 1
        t["ms"] += (b - a) / 1e6
        t["self_ms"] += (b - a - child[i]) / 1e6
    rec = dict(session=s.serial, spans=spans, frames=s.roots,
               totals=totals, counters=dict(s.counters), launches=launches,
               counts=counts)
    if s.end is not None:
        s.summary = rec
    return rec
