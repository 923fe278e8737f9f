"""The port's one record of what the host does: counters, spans and the
host's syncs by site.

* :func:`count` adds to a counter: to the calling thread's innermost open
  :func:`record`, and to the process's totals (:func:`totals`).  The
  kernel wrappers count their launches with it (``ops/kernels.py``:
  ``count_launches`` is a :func:`record` of the kernels' keys).
* :func:`record` is the calling thread's view of the counters: a dict of
  what this thread counts while it is entered.  A record nested in another
  adds its dict to the enclosing one when it closes.  Every key is flat
  and every value an integer, so a shallow copy of a record is a snapshot.
* :func:`span` times a stretch of host work.  Off (the default) it returns
  one shared object that does nothing, after a flag test and one call that
  asks whether a ``torch.profiler`` records on this thread.  Spans are on
  while :func:`enable` is in force, and by themselves while a profiler
  records the calling thread.  An open span then
  - opens a profiler range named ``name`` (``torch.profiler``'s fast
    ``RecordFunction``), so that a profiler that records the thread holds
    it as a host event, on the clock of the device's events, with the
    spans and operators it encloses nested inside it.  Not
    ``record_function``: its user-scope ranges are mirrored onto the
    device's timeline as ``gpu_user_annotation`` events, which a reading
    of the device trace would take for device work;
  - adds its wall time to the calling thread's record, as the counters
    ``span:<name>:ns`` and ``span:<name>:n`` (nanoseconds, entries).
  A span's self time is its time less that of the spans it encloses.
* :func:`sync` is the span ``sync.<site>`` around a point where the host
  waits for the device, and counts the site's waits as ``sync:<site>``
  whether spans are on or not.
* :class:`StageClock` turns spans on and reads the stage spans of the
  step as the timing report's per-frame stage times, with a device sync
  at each stage boundary.

The names of the spans and counters of the step, and the metrics that read
them, are listed in ``PERF.md`` §3.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, List, Optional

import torch

_lock = threading.Lock()
_totals: Dict[str, int] = {}


class _Local(threading.local):
    rec: Optional[dict] = None  # the innermost open record
    settle = None  # a StageClock's (device, span names)


_thread = _Local()
_enabled = 0  # the depth of enable() calls in force
_profiling = torch.autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


def count(key: str, k: int = 1) -> None:
    """Add ``k`` to counter ``key``: to the process's totals and to the
    calling thread's innermost open record, if any."""
    with _lock:
        _totals[key] = _totals.get(key, 0) + k
    rec = _thread.rec
    if rec is not None:
        rec[key] = rec.get(key, 0) + k


def totals(keys: Iterable[str]) -> Dict[str, int]:
    """The process's totals of every thread's counts of ``keys`` (0 for a
    key never counted)."""
    with _lock:
        return {key: _totals.get(key, 0) for key in keys}


def reset(keys: Iterable[str]) -> None:
    """Set the totals of ``keys`` back to 0."""
    with _lock:
        for key in keys:
            _totals.pop(key, None)


@contextlib.contextmanager
def record(keys: Iterable[str] = ()):
    """The calling thread's view of the counters: yields a dict {key:
    count} of what this thread counts while entered, ``keys`` present from
    the start at 0 (other threads' counts are not in it).  A nested record
    adds its dict to the enclosing one when it closes."""
    outer = _thread.rec
    rec = dict.fromkeys(keys, 0)
    _thread.rec = rec
    try:
        yield rec
    finally:
        _thread.rec = outer
        if outer is not None:
            for key, k in rec.items():
                outer[key] = outer.get(key, 0) + k


def enable() -> None:
    """Spans on in every thread until the matching :func:`disable`."""
    global _enabled
    with _lock:
        _enabled += 1


def disable() -> None:
    global _enabled
    with _lock:
        _enabled = max(_enabled - 1, 0)


@contextlib.contextmanager
def enabled():
    """Spans on while entered (:func:`enable`, then :func:`disable`)."""
    enable()
    try:
        yield
    finally:
        disable()


class _Off:
    """The span that does nothing: one object, shared by every call."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class Span:
    """One timed stretch of host work (see the module note).  ``on``: it
    records (a profiler event and the record's counters); a span made for
    its time alone (``span(name, timed=True)`` with spans off) only keeps
    its time in ``ns``."""
    __slots__ = ("name", "on", "ns", "_t0", "_fn")

    def __init__(self, name: str, on: bool = True):
        self.name = name
        self.on = on
        self.ns = 0
        self._fn = None

    @property
    def ms(self) -> float:
        return self.ns / 1e6

    def __enter__(self) -> "Span":
        settle = _thread.settle if self.on else None
        if settle is not None and self.name in settle[1]:
            _settle(settle[0])
        if self.on:
            self._fn = _Range(self.name)
            self._fn.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.on:
            settle = _thread.settle
            if settle is not None and self.name in settle[1]:
                _settle(settle[0])
        self.ns = time.perf_counter_ns() - self._t0
        if self._fn is not None:
            self._fn.__exit__(*exc)
            self._fn = None
        if self.on:
            count(f"span:{self.name}:ns", self.ns)
            count(f"span:{self.name}:n")
        return False


def span(name: str, timed: bool = False):
    """A context manager around host work named ``name`` (see the module
    note): the shared no-op while spans are off, unless ``timed`` asks for
    the stretch's time in any case (the returned :class:`Span`'s ``ns`` /
    ``ms`` after it closes)."""
    if _enabled or _profiling():
        return Span(name)
    if timed:
        return Span(name, on=False)
    return _OFF


def sync(site: str, waits: int = 1):
    """The span ``sync.<site>`` around a point where the host blocks on the
    device; adds ``waits``, the times the host blocks there (a library
    call may block more than once), to ``sync:<site>`` whether spans are
    on or not."""
    count(f"sync:{site}", waits)
    return span(f"sync.{site}")


def _settle(device: torch.device) -> None:
    with sync("stage"):
        torch.cuda.synchronize(device)


class StageClock:
    """The timing report's per-frame stage times, read from the spans of
    the step's stages: while entered, spans are on in every thread, and on
    this thread each span named in ``names`` starts and ends with a device
    sync (on a CUDA ``device``; none on the CPU), so that its time is its
    stage's host and device work alone, as the reference's report times a
    stage.  :meth:`lap` gives each name's milliseconds since the last lap,
    in the order of ``names``."""

    def __init__(self, device, names: Iterable[str]):
        self.device = torch.device(device)
        self.names = tuple(names)
        self._rec = None
        self._last: Dict[str, int] = {}
        self._stack = contextlib.ExitStack()

    def __enter__(self) -> "StageClock":
        self._stack.enter_context(enabled())
        self._rec = self._stack.enter_context(record())
        if self.device.type == "cuda":
            _thread.settle = (self.device, frozenset(self.names))
            self._stack.callback(setattr, _thread, "settle", None)
        self._last = {}
        return self

    def __exit__(self, *exc) -> bool:
        self._stack.close()
        return False

    def lap(self) -> List[float]:
        out = []
        for name in self.names:
            ns = self._rec.get(f"span:{name}:ns", 0)
            out.append((ns - self._last.get(name, 0)) / 1e6)
            self._last[name] = ns
        return out
