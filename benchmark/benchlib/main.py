"""``run.py``'s body: one cell, one seed, one run.

Set-up (``setup_s``, from the process's start to the window's opening):
the card, the kernel library from the checkout's build cache, the drives
made on the card and moved to host memory, and the first two segments of
the run itself (the first runs the warm-up config).  Then the window
(:mod:`drive`), then, with ``--trace 1``, the per-layer metrics, and last
the comparison with the plain reference (:mod:`check`), which is not timed.
The last line of standard output is one JSON object; the numbers compared
are also the last lines of standard error.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
import traceback
from typing import Optional

import numpy as np

from benchlib import check, drive, traffic
from benchlib.catalog import Catalog, apply_overrides

FORBIDDEN = ("jax", "jaxlib", "flax", "mulls_tpu")
# the program's launch counters that count launches of distinct kernels
# (``nn_grouped``'s launches are also counted under ``nn``)
LAUNCH_KEYS = ("nn", "moments", "pca_moments", "count_within")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``mulls_tpu_torch`` is not ``mulls_tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
        return out.splitlines()[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


class Run:
    """What the per-layer metric readers read: the window's record, the
    traced segment's summary, and the bounds of the kernels' launches."""

    def __init__(self, rec: drive.Record, readers: dict, device):
        self.rec = rec
        self.S = rec.S
        self.trace = rec.trace
        self.readers = readers
        self.device = device
        self._bounds = {}

    def launches(self, keys=LAUNCH_KEYS) -> int:
        a, b = self.rec.launches[self.rec.start], self.rec.launches[self.rec.end]
        return sum(b[k] - a[k] for k in keys)

    def traced_seqframes(self) -> Optional[int]:
        if not self.trace:
            return None
        a, b = self.trace["segment"]
        return self.S * (b - a)

    def roofline(self, kernel: str, calls: tuple, work) -> Optional[tuple]:
        """(bound seconds, device seconds) of ``kernel``'s launches in the
        traced segment, ``work(calls)`` giving each launch's (operations,
        bytes); None without a complete trace or a launch."""
        if not self.trace:
            return None
        if kernel not in self._bounds:
            from benchlib.trace import bound_s
            mine = [c for c in self.trace["calls"] if c[0] in calls]
            device_s = self.trace["kernel_s"].get(kernel, 0.0)
            if not mine or device_s <= 0.0:
                self._bounds[kernel] = None
            else:
                bound = sum(bound_s(ops, nbytes)
                            for ops, nbytes in work(mine))
                self._bounds[kernel] = (bound, device_s)
        return self._bounds[kernel]


def compare(rec: drive.Record, drives: list, config: dict, limits: dict,
            device, kernel_calls: dict, kept: dict) -> tuple:
    """(correct, checks, seconds) of the comparison (see :mod:`check`):
    every sequence at the probed frames, and the kernels' first calls at
    every segment start."""
    t0 = time.perf_counter()
    cfg = check.reference_config(config)
    records = []
    for f in sorted(kept):
        for s in range(rec.S):
            records.append(check.stage_gaps(
                kept[f], s, f, drives[s][f], rec.vecs[s, f],
                rec.vecs[s, f - 1], cfg, limits, device))
    parts = [check.stage_numbers(records, limits)]
    parts += [check.kernel_gaps(c) for _, c in sorted(kernel_calls.items())
              if c]
    numbers = check.merge(parts)
    print(f"[bench] registrations {json.dumps(records)}", file=sys.stderr)
    print(f"[bench] numbers {json.dumps(numbers)}", file=sys.stderr)
    correct, checks = check.judge(numbers, limits)
    return correct, checks, time.perf_counter() - t0


def failures(rec: drive.Record, seqs: list, mix: dict) -> str:
    """The window's failed registrations by code, world and sequence."""
    codes = np.rint(rec.vecs[:, rec.start:rec.end, 13]).astype(int)
    worlds = [mix["sequence_world"].get(q, mix["default_world"])
              for q in seqs]
    by_code = {int(c): int((codes == c).sum()) for c in np.unique(codes)}
    by_world = {w: [int((codes[i] < 0).sum()), int(codes[i].size)]
                for w in sorted(set(worlds))
                for i in [[k for k, x in enumerate(worlds) if x == w]]}
    by_seq = {q: [int((codes[k] < 0).sum())]
              + [rec.start + int(i) for i in np.flatnonzero(codes[k] < 0)
                 [[0, -1]]] for k, q in enumerate(seqs)
              if (codes[k] < 0).any()}
    return (f"codes {json.dumps(by_code)}; failed/frames by world "
            f"{json.dumps(by_world)}; failed by sequence (count, first, "
            f"last frame) {json.dumps(by_seq)}")


def main(argv, root: str, t0: float, require_card: bool = True,
         device: str = "cuda", here: Optional[str] = None) -> int:
    """One run; returns the exit code.  ``require_card=False`` and
    ``device="cpu"`` run the rest of a run on the CPU (the tests);
    ``here``: the folder of the traffic mixes, limits and metrics (default:
    the harness's own)."""
    args = parse(argv)
    cat = Catalog(root, here) if here else Catalog(root)
    cell = cat.workload(args.workload)
    config = cat.config(cell["config"])
    mix = cat.traffic(cell["traffic"])
    limits = cat.limits(cell["config"])
    import torch
    if require_card:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < int(cell["chips"]):
            print(f"[bench] {args.workload} needs {cell['chips']} CUDA "
                  f"card(s); torch.cuda sees {have}", file=sys.stderr)
            return 2
    dev = torch.device(device)
    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.parallel.mesh import make_mesh
    from mulls_tpu_torch.parallel.multiseq import MultiSeqPipeline

    from mulls_ref.core.draws import GeneratorDraws

    cfg = apply_overrides(MullsConfig(), config.get("mulls_config", {}))
    seqs = list(config["sequences"])
    S, seg = len(seqs), int(config["segment"])
    if dev.type == "cuda":
        kernels.library()  # built once a checkout; set-up either way
    drives = traffic.make_drives(mix, seqs, cfg.shapes.n_raw, args.seed,
                                 dev)
    seq_seeds = [traffic.sequence_seed(args.seed, s, salt=1)
                 for s in range(S)]
    draws = [GeneratorDraws(x, dev) for x in seq_seeds]
    pipe = MultiSeqPipeline(cfg, make_mesh(1, device=device), segment=seg)
    rec = drive.Record(S=S, segment=seg, seconds=args.seconds,
                       warm_segments=2)
    readers = cat.readers(args.workload) if args.trace else {}
    tracer = recorder = None
    if args.trace:
        from benchlib.trace import CallRecorder, Tracer
        roof = [r for r in readers.values() if hasattr(r, "KERNEL")]
        recorder = CallRecorder(kernels, {
            c: (lambda a, k, c=c, r=r: r.keep(c, a, k))
            for r in roof for c in r.CALLS})
        if dev.type == "cuda":
            from benchlib.trace import warm_profiler
            warm_profiler()
    from benchlib.probe import KernelProbe, StageProbe
    from mulls_tpu_torch.parallel import multiseq
    from mulls_tpu_torch.pipeline import odometry
    probe = KernelProbe(kernels)
    # the start's segment and the window's, none between them
    stages = StageProbe(multiseq, odometry, check.probed_frames(
        args.seed, len(drives[0]), seg,
        cfg.map.local_map_recalculation_frequency,
        skip=range(1, rec.warm_segments)))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        with kernels.count_launches() as counter:
            if args.trace and dev.type == "cuda":
                tracer = Tracer(recorder, {r.KERNEL: list(r.CALLS)
                                           for r in roof},
                                {r.KERNEL: r.COUNTER for r in roof}, counter)
            drive.run_window(pipe, drives, draws, rec, counter, tracer,
                             probe)
    finally:
        probe.restore()
        stages.restore()
        if recorder is not None:
            recorder.restore()
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" \
        else 0
    rec.trace = tracer.summary if tracer is not None else None
    del pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    window = rec.vecs[:, rec.start:rec.end]
    attempted = int(window.shape[0] * window.shape[1])
    failed = int((np.rint(window[..., 13]) < 0).sum())
    rate = attempted / rec.window_s
    setup_s = rec.resumed[rec.start] - t0
    print(f"[bench] {args.workload} seed {args.seed}: window {rec.start}-"
          f"{rec.end} frames x {S} sequences in {rec.window_s:.3f} s: "
          f"{rate:.4f} sequence-frames/s; set-up {setup_s:.3f} s; "
          f"{failed} failed of {attempted}; segment rates "
          f"{[round(x, 4) for x in rec.segment_rates()]}", file=sys.stderr)
    print(f"[bench] failed registrations: {failures(rec, seqs, mix)}",
          file=sys.stderr, flush=True)

    metrics = {}
    summary = rec.trace
    if not args.trace:
        values = {"seq_frames_per_s": rate, "setup_s": setup_s}
        for m in cat.metrics(args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        t_read = time.perf_counter()
        run = Run(rec, readers, dev)
        for m in cat.metrics(args.workload, "per_layer"):
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tracer is not None and tracer.lost:
            print(f"[bench] traces that lost device events (no number "
                  f"taken from them): {tracer.lost}", file=sys.stderr)
        if summary is not None:
            print(f"[bench] traced segment {summary['segment']}: "
                  f"{summary['window_s']:.3f} s, {summary['device_ops']} "
                  f"device operations, busy {summary['busy_s']:.3f} s; "
                  f"reduced in {summary['reduce_s']:.1f} s; metrics read in "
                  f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
        del run
    if summary is not None:
        summary = {k: summary[k] for k in ("busy_s", "window_s",
                                           "breakdown")}
    rec.trace = None
    recorder = tracer = None
    gc.collect()

    found = forbidden_modules()
    if found:
        print(f"[bench] loaded after the window: {found}", file=sys.stderr)
        return 3
    try:
        correct, checks, check_s = compare(rec, drives, config, limits,
                                           dev, probe.calls, stages.kept)
    except Exception:  # the comparison could not be made: not correct
        traceback.print_exc()
        correct, check_s = False, 0.0
        checks = {name: {"value": None, "limit": limits[name]["limit"]}
                  for name in check.compared(limits)}
    device_rec = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(0)
                           if dev.type == "cuda" else "cpu"),
                  "count": 1, "memory_peak_bytes": peak}
    if dev.type == "cuda":
        device_rec["power_limit"] = power_limit()
    if summary is not None:
        device_rec["busy_s"] = summary["busy_s"]
        device_rec["window_s"] = summary["window_s"]
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_rec}
    if summary is not None:
        result["breakdown"] = summary["breakdown"]
    print(f"[bench] comparison with the reference: {check_s:.1f} s",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"[check] {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0
