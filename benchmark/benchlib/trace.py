"""The traced run: ``torch.profiler`` over one steady segment of the
window, the inputs of every call into the program's kernel wrappers in that
segment, and their reduction to the numbers that the per-layer metrics
read.

A trace counts only when it holds one device event of each kernel for each
launch that the program's counters saw in the segment; a trace that lost
events is reported and no number is taken from it, and the next segment is
traced instead (up to ``tries`` segments).  The summary holds:

* ``window_s``: the traced segment's wall time; ``busy_s``: the union of
  its device operations' intervals; ``device_ops``: their count;
* ``kernels``: per kernel name, its events' device seconds and the
  recorded calls (wrapper name and arguments) that the roofline readers
  turn into operations and bytes;
* ``breakdown``: the ten device operations that took the most time and
  the ten host operations during which the device sat idle longest.
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Sequence

import torch

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds for ``ops`` fp32 operations and ``nbytes`` bytes
    on one H100: the larger of the two."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def union_s(intervals: Sequence[tuple]) -> float:
    """Length of the union of (start, end) intervals in us, in seconds."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


class CallRecorder:
    """Wraps named functions of a module so that, while ``on``, each call
    is kept under the function's name, as what ``keep[name](args, kw)``
    picks of its arguments (by reference: no device work)."""

    def __init__(self, module, keep: Dict[str, object]):
        self.module = module
        self.keep = keep
        self.calls: List[tuple] = []
        self.on = False
        self._orig = {}
        for name in keep:
            fn = getattr(module, name)
            self._orig[name] = fn
            setattr(module, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        pick = self.keep[name]

        def wrapped(*args, **kw):
            if self.on:
                self.calls.append((name, pick(args, kw)))
            return fn(*args, **kw)
        wrapped.__name__ = fn.__name__
        wrapped.__doc__ = fn.__doc__
        for attr in ("launches",):
            if hasattr(fn, attr):
                setattr(wrapped, attr, getattr(fn, attr))
        return wrapped

    def restore(self) -> None:
        for name, fn in self._orig.items():
            setattr(self.module, name, fn)


class Tracer:
    """Profiles the first whole segment of the window whose trace is
    complete.  ``kernels``: {kernel name in the trace: [wrapper names]};
    ``launch_keys``: {kernel name: the program's launch counter}."""

    def __init__(self, recorder: CallRecorder, kernels: Dict[str, list],
                 launch_keys: Dict[str, str], counter: Dict[str, int],
                 tries: int = 3):
        self.recorder = recorder
        self.kernels = kernels
        self.launch_keys = launch_keys
        self.counter = counter
        self.tries = tries
        self.prof = None
        self.t0 = None
        self.at = None
        self.launch0 = None
        self.summary: Optional[dict] = None
        self.lost: List[dict] = []

    @property
    def pending(self) -> bool:
        """A complete trace is still to come."""
        return self.summary is None and len(self.lost) < self.tries

    def start(self, done: int, rec) -> None:
        if not self.pending:
            return
        from torch.profiler import ProfilerActivity, profile
        reserve_memory()
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.recorder.calls = []
        self.launch0 = dict(self.counter)
        self.at = done
        rec.skip_segments.add(done)
        self.prof.start()
        self.recorder.on = True
        self.t0 = time.perf_counter()

    def stop(self, done: int, now: float) -> None:
        if self.prof is None:
            return
        self.recorder.on = False
        self.prof.stop()
        window_s = now - self.t0
        launches = {k: self.counter[v] - self.launch0[v]
                    for k, v in self.launch_keys.items()}
        t = time.perf_counter()
        summary = summarize(self.prof, self.kernels, launches, window_s)
        summary["reduce_s"] = time.perf_counter() - t
        summary["calls"] = self.recorder.calls
        summary["segment"] = [self.at, done]
        self.recorder.calls = []
        self.prof = None
        if summary["complete"]:
            self.summary = summary
        else:
            self.lost.append({"segment": [self.at, done],
                              "kept": summary["kept"],
                              "launches": launches})


def _kernel_of(name: str, patterns: Dict[str, re.Pattern]) -> Optional[str]:
    for k, pat in patterns.items():
        if pat.search(name):
            return k
    return None


def summarize(prof, kernels: Dict[str, list], launches: Dict[str, int],
              window_s: float) -> dict:
    """The numbers of one profiled segment (see the module note), read
    from the profiler's raw events (``kineto_results``: no event tree)."""
    from torch.autograd import DeviceType
    patterns = {k: re.compile(r"(^|[^A-Za-z0-9_])" + re.escape(k)
                              + r"($|[^A-Za-z0-9_])") for k in kernels}
    per_kernel = {k: [] for k in kernels}
    by_name: Dict[str, float] = {}
    spans, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3  # us
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            spans.append((start, start + dur))
            k = _kernel_of(name, patterns)
            if k is not None:
                per_kernel[k].append(dur / 1e6)
            short = name if len(name) <= 120 else name[:117] + "..."
            by_name[short] = by_name.get(short, 0.0) + dur / 1e6
        elif e.device_type() == DeviceType.CPU:
            host.append((start, start + dur, e.name()))
    kept = {k: len(v) for k, v in per_kernel.items()}
    complete = bool(spans) and all(kept[k] == launches.get(k, 0)
                                   for k in kernels)
    spans.sort()
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"complete": complete, "kept": kept, "launches": launches,
            "window_s": window_s, "busy_s": union_s(spans),
            "device_ops": len(spans),
            "kernel_s": {k: sum(v) for k, v in per_kernel.items()},
            "breakdown": {"device_ops": [[n, s] for n, s in top_ops],
                          "idle_gaps": idle_gaps(spans, host)}}


def reserve_memory(large_gb: float = 4.0, small_mb: float = 512.0) -> None:
    """Leave cached free device memory behind, so that the traced segment,
    which keeps its kernel calls' inputs, finds blocks in the allocator's
    cache and makes no ``cudaMalloc`` of its own."""
    big = torch.empty(int(large_gb * (1 << 30)), dtype=torch.uint8,
                      device="cuda")
    small = [torch.empty(256 << 10, dtype=torch.uint8, device="cuda")
             for _ in range(int(small_mb * 4))]
    del big, small


def warm_profiler() -> None:
    """Start and stop the profiler once, so that its set-up (CUPTI's) is
    paid before the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device="cuda").sum().item()


def idle_gaps(spans: List[tuple], host: list, top: int = 10,
              scan: int = 20000) -> List[list]:
    """The device's idle gaps between its merged busy intervals, each
    named by the innermost host operation running at its midpoint, summed
    by name: the ``top`` names with the most idle seconds."""
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((b2[0] - b1[1], (b1[1] + b2[0]) / 2)
                   for b1, b2 in zip(merged, merged[1:])), reverse=True)
    gaps = gaps[:2000]  # the longest carry the idle time
    hs = sorted(host)
    starts = [h[0] for h in hs]
    total: Dict[str, float] = {}
    for length, mid in gaps:
        i = bisect.bisect_right(starts, mid) - 1
        name = "no host operation"
        for j in range(i, max(-1, i - scan), -1):
            if hs[j][1] >= mid:
                name = hs[j][2]
                break
        total[name] = total.get(name, 0.0) + length / 1e6
    return [[n, s] for n, s in sorted(total.items(),
                                      key=lambda kv: -kv[1])[:top]]
