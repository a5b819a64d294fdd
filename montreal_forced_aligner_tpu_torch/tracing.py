"""Spans and counters inside the port, and its one phase clock.

``span(name)`` records ``Span(name, t0_ns, t1_ns, parent, request)`` on
``time.perf_counter_ns()``: ``parent`` is the index in ``recorded()["spans"]``
of the span around it (None at the top), ``request`` the number of the
top-level span it belongs to (one ``align_corpus``, ``export_textgrids``
or ``transcribe_corpus`` call), so a layer's self time is its span less
its children's. ``count(name, n)`` adds to a counter. ``recorded()`` returns
the spans, the counters and each name's summed self time; ``reset()``
clears them.

Recording is on while a ``torch.profiler`` collects
(``torch.autograd._profiler_enabled()``) or inside ``collect()``. While a
profiler collects, each span also opens a range of the profiler's under
its name, on the device trace's own timeline: a host-side range (a
``cpu_op`` event around the launches it made), or inside
``on_card_timeline()``, as ``--profile_dir`` runs, a
``torch.profiler.record_function`` user annotation, which the profiler
also lays over the kernels it launched as a device event of its own.
(The benchmark's traced run counts every device event as busy time, so
it gets the host-side ranges.) Off, ``span`` and ``count`` cost one check
and ``span`` returns a shared no-op: no range is opened (a
``record_function`` costs about 13 us a call, profiler or not).

:class:`PhaseClock` times a run's phases whether recording is on or not,
and records each phase as a span when it is.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: Optional[int]  # None while the span is open
    parent: Optional[int]  # index of the enclosing span in ``recorded()["spans"]``
    request: int  # the same for every span of one top-level span


_lock = threading.Lock()  # the counters' read-modify-write
_local = threading.local()
_collecting = 0  # open ``collect()`` blocks
_card_timeline = 0  # open ``on_card_timeline()`` blocks
_host_range = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_ids = itertools.count()
# closed spans as (id, name, t0_ns, t1_ns, parent id, request), and the open
# ones by id; ``recorded()`` orders them and turns ids into indices
_closed: List[tuple] = []
_running: Dict[int, "_Open"] = {}
_counters: Dict[str, int] = {}
_OFF = contextlib.nullcontext()


def recording() -> bool:
    return bool(_collecting or _profiler_enabled())


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span being recorded."""

    __slots__ = ("id", "name", "t0", "parent", "request", "rf")

    def __init__(self, name: str, t0: int):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, self.id
        self.name, self.t0, self.rf = name, t0, None
        _running[self.id] = self
        if _profiler_enabled():
            if _card_timeline:
                self.rf = torch.profiler.record_function(name)
            elif _host_range is not None:
                self.rf = _host_range(name)
            if self.rf is not None:
                self.rf.__enter__()
        stack.append(self)

    def close(self, t1: int) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _stack().pop()
        _running.pop(self.id, None)
        _closed.append((self.id, self.name, self.t0, t1, self.parent, self.request))


class _Span:
    __slots__ = ("name", "open")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.open = _Open(self.name, time.perf_counter_ns())
        return self

    def __exit__(self, *exc):
        self.open.close(time.perf_counter_ns())


def span(name: str):
    """A context that records a span named ``name`` while recording is on."""
    if _collecting or _profiler_enabled():
        return _Span(name)
    return _OFF


def traced(name: str):
    """Decorates a function so that each call is a span named ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while recording is on."""
    if _collecting or _profiler_enabled():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def collect():
    """Records spans and counters inside the block, with no profiler."""
    global _collecting
    with _lock:
        _collecting += 1
    try:
        yield
    finally:
        with _lock:
            _collecting -= 1


@contextlib.contextmanager
def on_card_timeline():
    """Spans recorded inside the block under a profiler are user
    annotations, drawn over their kernels on the card's timeline."""
    global _card_timeline
    with _lock:
        _card_timeline += 1
    try:
        yield
    finally:
        with _lock:
            _card_timeline -= 1


def recorded() -> dict:
    """``{"spans": [Span], "counters": {name: n}, "self_ns": {name: ns}}``:
    the spans in the order they opened (an open one has ``t1_ns`` None),
    and each name's summed self time over its closed spans."""
    closed = list(_closed)
    rows = sorted(closed + [(o.id, o.name, o.t0, None, o.parent, o.request)
                            for o in list(_running.values())])
    index = {row[0]: k for k, row in enumerate(rows)}
    spans = [Span(name, t0, t1, index.get(parent), request)
             for _, name, t0, t1, parent, request in rows]
    children: Dict[int, int] = {}
    for _, _, t0, t1, parent, _ in closed:
        if parent is not None:
            children[parent] = children.get(parent, 0) + t1 - t0
    self_ns: Dict[str, int] = {}
    for i, name, t0, t1, _, _ in closed:
        self_ns[name] = self_ns.get(name, 0) + t1 - t0 - children.get(i, 0)
    with _lock:
        counters = dict(_counters)
    return {"spans": spans, "counters": counters, "self_ns": self_ns}


def reset() -> None:
    _closed.clear()
    _running.clear()
    with _lock:
        _counters.clear()


class PhaseClock:
    """Host-clock seconds per phase, summed over a run (``seconds``, in the
    order the phases first opened), and each phase's (name, t0_ns, t1_ns)
    as it ended (``spans``). A phase entered inside another is charged to
    itself only. ``with clock(name):`` nests a phase inside the running
    one; ``clock.start(name)`` ends the phase the last ``start`` opened at
    this depth and opens ``name`` at the same instant, so a run of
    ``start`` s is contiguous; ``stop()`` ends it. With ``sync`` set, the
    card is synchronised at each phase boundary, so a phase's seconds hold
    its device work; without it they are dispatch times (the card runs
    behind the host). While recording is on, each phase is a span."""

    def __init__(self, device: torch.device, sync: bool = False):
        self.device = device
        self.sync = sync
        self.seconds: Dict[str, float] = {}
        self.spans: List[tuple] = []
        # [name, t0_ns, children's ns, recorded span or None, opened by start]
        self._stack: List[list] = []

    def _now(self) -> int:
        if self.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter_ns()

    def _open(self, name: str, t: int, started: bool) -> None:
        self.seconds.setdefault(name, 0.0)
        rec = _Open(name, t) if recording() else None
        self._stack.append([name, t, 0, rec, started])

    def _close(self, t: int) -> None:
        name, t0, child, rec, _ = self._stack.pop()
        if rec is not None:
            rec.close(t)
        self.seconds[name] += (t - t0 - child) / 1e9
        self.spans.append((name, t0, t))
        if self._stack:
            self._stack[-1][2] += t - t0

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._open(name, self._now(), False)
        depth = len(self._stack)
        try:
            yield
        finally:
            t = self._now()
            while len(self._stack) >= depth:
                self._close(t)

    def start(self, name: str) -> None:
        t = self._now()
        if self._stack and self._stack[-1][4]:
            self._close(t)
        self._open(name, t, True)

    def stop(self) -> None:
        if self._stack and self._stack[-1][4]:
            self._close(self._now())
