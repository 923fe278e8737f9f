"""One run of the program under test: ``MultiSeqPipeline.run`` over a
configuration's drives, with the measured window bracketed by its
``on_segment`` hook.

The hook fires at the end of each lockstep segment, after every block has
fetched its results (a sync).  There it reads the time and the launch
counters; after the window it reads the program's packed per-frame results
and ends the run.  The results are read from the running
``MultiSeqPipeline.run``'s ``blocks`` (each ``_Block`` keeps its fetched
``parts``): the one place the harness reads inside the program, named here
and in ``PERF.md``.

The window opens at the end of the ``warm_segments``-th segment (the first
segment runs the warm-up config) and closes at the end of the first
segment that ends ``seconds`` or more after it opened.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional

import numpy as np


class StopWindow(Exception):
    """Raised from the hook once the window has closed: it ends the run."""


class DrivesEnded(RuntimeError):
    """The drives ended before the window closed."""


def running_blocks() -> list:
    """The blocks of the ``MultiSeqPipeline.run`` that called the hook:
    the nearest caller's local ``blocks``, a list of objects with
    ``parts``."""
    f = sys._getframe(1)
    while f is not None:
        b = f.f_locals.get("blocks")
        if (isinstance(b, list) and b
                and all(hasattr(x, "parts") for x in b)):
            return b
        f = f.f_back
    raise RuntimeError("the on_segment hook found no running "
                       "MultiSeqPipeline.run blocks (parts) among its "
                       "callers' locals")


@dataclasses.dataclass
class Record:
    """What a run hands to the metrics and the comparison."""
    S: int
    segment: int
    seconds: float
    warm_segments: int
    marks: Dict[int, float] = dataclasses.field(default_factory=dict)
    resumed: Dict[int, float] = dataclasses.field(default_factory=dict)
    launches: Dict[int, dict] = dataclasses.field(default_factory=dict)
    vecs: Optional[np.ndarray] = None  # [S, frames done, 16]
    start: Optional[int] = None  # frames done when the window opened
    end: Optional[int] = None  # ... when it closed
    skip_segments: set = dataclasses.field(default_factory=set)
    trace: Optional[dict] = None

    def _spans(self) -> list:
        """(start, end) frame counts of the window's segments."""
        keys = sorted(k for k in self.marks if self.start <= k <= self.end)
        return list(zip(keys, keys[1:]))

    @property
    def window_s(self) -> float:
        """The window's time: its segments' times, each from the end of
        the hook's work at its start to its end (the harness's own work
        at the boundaries left out)."""
        return sum(self.marks[b] - self.resumed[a] for a, b in self._spans())

    @property
    def window_frames(self) -> int:
        return self.end - self.start

    def segment_rates(self) -> List[float]:
        """Sequence-frames per second of each whole segment in the window,
        from the end of the hook's work at its start to its end (segments
        that a trace slowed left out)."""
        out = []
        for a, b in self._spans():
            if a in self.skip_segments:
                continue
            out.append(self.S * (b - a) / (self.marks[b] - self.resumed[a]))
        return out


class Hook:
    """The ``on_segment`` hook (see the module note).  ``tracer``: the
    traced run's profiler, or None; ``counter``: the live launch record;
    ``probe``: a :class:`benchlib.probe.KernelProbe`, armed at every
    boundary."""

    def __init__(self, rec: Record, counter: dict, tracer=None, probe=None):
        self.rec = rec
        self.probe = probe
        self.counter = counter
        self.tracer = tracer

    def __call__(self, done: int) -> None:
        now = time.perf_counter()
        rec = self.rec
        if self.tracer is not None:
            self.tracer.stop(done, now)
        rec.marks[done] = now
        rec.launches[done] = dict(self.counter)
        if rec.start is None and done >= rec.warm_segments * rec.segment:
            rec.start = done
        elif (rec.start is not None
              and now - rec.marks[rec.start] >= rec.seconds
              and (self.tracer is None or not self.tracer.pending)):
            rec.end = done
            rec.vecs = np.concatenate(
                [np.concatenate(b.parts, 1) for b in running_blocks()], 0)
            raise StopWindow
        if self.probe is not None:
            self.probe.arm(done)
        if self.tracer is not None and rec.start is not None:
            self.tracer.start(done, rec)
        rec.resumed[done] = time.perf_counter()


def run_window(pipe, drives: list, draws: list, rec: Record,
               counter: dict, tracer=None, probe=None) -> Record:
    """Run ``pipe`` over ``drives`` until the window closes; ``counter``:
    the program's launch record, entered by the caller; ``probe``: a
    :class:`benchlib.probe.KernelProbe`, armed at the start and at every
    boundary."""
    hook = Hook(rec, counter, tracer, probe)
    if probe is not None:
        probe.arm(0)
    try:
        pipe.run(drives, draws=draws, on_segment=hook)
    except StopWindow:
        return rec
    raise DrivesEnded(f"the drives ({len(drives[0])} frames) ended before "
                      f"the window of {rec.seconds} s closed")
