"""Roofline probe of the port's kernels on the card, and the probe's two
kernels (port of ``tools/perf_mfu_roofline.py``).

The probe times the package kernels at fixed shapes against the card's
measured matmul peaks, then two kernels that split the cost of a
neighbourhood sum into its parts:

* :func:`count_within` — per-query count of valid support within the
  radius (replaces ``_variant`` with ``_kernel_dist_only``,
  ``tools/perf_mfu_roofline.py:69``).  CUDA: ``csrc/count_within.cu``,
  bound in :mod:`mulls_tpu_torch.ops.kernels` (the map assembly calls it
  too) and imported here.  Its first design formed every pair's distance
  and served as the dense distance floor of the package kernels; those
  three have since been redesigned for the card, and it is now a cell-grid
  count: its row times the kernel alone and the whole call (the index it
  walks is built by tensor ops in the same call), and bounds it by the
  bytes and 10 operations a hit; the candidate pairs of the 27 cells
  around each query, the walk's own work, are printed beside it.
* :func:`adj_stack` — the 0/1 adjacency times a [P, C] bf16 stack on the
  tensor cores, fp32 sums: the dense matmul form (replaces ``_variant``
  with ``_kernel_static_f``, ``tools/perf_mfu_roofline.py:84``).  CUDA:
  ``csrc/adj_stack.cu``.

Both wrappers follow :mod:`mulls_tpu_torch.ops.kernels`: the plain version
only for tensors on the CPU, the kernel or an error on CUDA, and a launch
count (``core/trace.py``'s counters ``count_within`` and ``adj_stack``).
The probe's :func:`reset_launch_counts` / :func:`launch_counts` cover these
two.

The probe's inputs are the TPU tool's: numpy ``default_rng(0)``, clouds
uniform in (-40, 40) m, r^2 = 1, the same shapes drawn in the same order.
Each row gives the kernel's device time (``torch.profiler``) and its time
per call with CUDA events, the port's useful operation count, the achieved
TFLOP/s and its share of the measured matmul peak of the same precision,
and its bound: the larger of bytes over 3.35 TB/s and operations over the
published peak (fp32 67 TFLOP/s outside the tensor cores; bf16 989
TFLOP/s dense).  On the CPU (``--device cpu``, for tests at small shapes)
the rows carry the host clock and no device time.

Usage:  python -m mulls_tpu_torch.tools.roofline [--device cuda] [--out FILE]

It writes JSON only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from mulls_tpu_torch.core import trace
from mulls_tpu_torch.core.device import resolve_device
from mulls_tpu_torch.ops import kernels
from mulls_tpu_torch.ops.kernels import (_check, _check_launch, _dispatch,
                                         _ptr, _stream,
                                         count_within, count_within_plain,
                                         sqdist_direct)

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
PEAK_BYTES_PER_S = 3.35e12

REPS = 16  # timed calls a row, as the TPU tool's PROBE_REPS
STACK_C = 128  # width of the static stack, as the TPU tool's


# --------------------------------------------------------------------------
# the probe's two kernels
# --------------------------------------------------------------------------

_CHUNK = 1024  # queries per block of the plain versions


def _adjacency(q_xyz, p_xyz, p_mask, r2, s: int) -> torch.Tensor:
    """The 0/1 adjacency of queries [s, s + _CHUNK)."""
    d2 = sqdist_direct(q_xyz[s:s + _CHUNK], p_xyz)
    return p_mask[None, :] & (d2 <= r2[s:s + _CHUNK, None])


def adj_stack_plain(q_xyz: torch.Tensor, p_xyz: torch.Tensor,
                    p_mask: torch.Tensor, r2: torch.Tensor,
                    stack: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``adj.float() @ stack.float()`` over [_CHUNK, P]
    blocks."""
    f = stack.to(torch.float32)
    return torch.cat([
        _adjacency(q_xyz, p_xyz, p_mask, r2, s).to(torch.float32) @ f
        for s in range(0, max(q_xyz.shape[0], 1), _CHUNK)])


def _check_cloud(q_xyz, p_xyz, p_mask, r2):
    dev = q_xyz.device
    qn, pn = q_xyz.shape[0], p_xyz.shape[0]
    _check("q_xyz", q_xyz, torch.float32, (qn, 3), dev)
    _check("p_xyz", p_xyz, torch.float32, (pn, 3), dev)
    _check("p_mask", p_mask, torch.bool, (pn,), dev)
    _check("r2", r2, torch.float32, (qn,), dev)
    return dev, qn, pn


def adj_stack(q_xyz: torch.Tensor, p_xyz: torch.Tensor, p_mask: torch.Tensor,
              r2: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    """float32 [Q, C] = adj @ stack: adj[q, p] = 1 for valid support within
    r2[q] (the distance of :func:`count_within`), ``stack`` a bf16 [P, C]
    with C a multiple of 16 up to 128, summed in fp32.

    CUDA kernel: ``csrc/adj_stack.cu`` (replaces ``_kernel_static_f``,
    ``tools/perf_mfu_roofline.py:84-99``): wgmma bf16 products with the
    adjacency formed in registers, the support streamed in by TMA, and its
    eight parts merged in a fixed order across a thread-block cluster, so
    two launches give the same bits."""
    dev, qn, pn = _check_cloud(q_xyz, p_xyz, p_mask, r2)
    cn = stack.shape[1] if stack.dim() == 2 else -1
    _check("stack", stack, torch.bfloat16, (pn, cn), dev)
    if not (16 <= cn <= kernels.ADJ_MAX_C and cn % 16 == 0):
        raise ValueError(f"adj_stack: stack width {cn} is not a multiple of "
                         f"16 in [16, {kernels.ADJ_MAX_C}]")
    if not _dispatch(dev):
        return adj_stack_plain(q_xyz, p_xyz, p_mask, r2, stack)
    if stack.data_ptr() % 16:
        raise ValueError("adj_stack: stack must be 16-byte aligned")
    sums = torch.empty((qn, cn), dtype=torch.float32, device=dev)
    if qn == 0:  # nothing to launch
        return sums
    # the support as float4 rows for the kernel's TMA copies; an invalid
    # point is NaN, which no compare counts
    p4 = torch.where(p_mask[:, None], p_xyz, float("nan"))
    p4 = torch.cat([p4, torch.zeros_like(p4[:, :1])], 1)
    _check_launch(kernels.library().mulls_adj_stack(
        _ptr(q_xyz), _ptr(r2), _ptr(p4), _ptr(stack), qn, pn, cn, _ptr(sums),
        _stream(q_xyz)), "adj_stack")
    trace.count("adj_stack")
    return sums


_LAUNCH_KEYS = ("count_within", "adj_stack")


def reset_launch_counts() -> None:
    trace.reset(_LAUNCH_KEYS)


def launch_counts() -> dict:
    return trace.totals(_LAUNCH_KEYS)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------

def time_ms(fn: Callable, iters: int, warmup: int = 2) -> float:
    """ms per call of ``fn`` with CUDA events around ``iters`` calls: the
    host's launch gaps between calls count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# the traces in which torch.profiler lost device events and device_ms took
# the mean of the launches it kept ("clock": "device") or CUDA events' time
# ("cuda_events"): {"kernel", "kept", "calls", "ms", "clock"}
PARTIAL_TRACES: list = []


def device_ms(fn: Callable, iters: int, kernel: Optional[str] = None
              ) -> tuple:
    """(device ms per call, device operations per call) of ``fn`` under
    ``torch.profiler``: the kernels' own time, without the host's launch
    gaps that CUDA events between calls of a short kernel also count.

    With ``kernel``, only the device events whose name holds it count: the
    time of that kernel alone, when ``fn`` also runs other device work
    (``count_within``'s index).  Every call launches at least one kernel
    (one of ``kernel``), so a trace with fewer such events than calls lost
    some (seen in the kernel and probe phases of
    ``chip_smoke.py`` and after its threaded SLAM runs, as few as 2 of 20
    launches kept; why is not known).  Such a trace is taken again, five
    times in all.  If all five lose events and the last one's all come
    from one kernel, the mean device time of the launches it kept is that
    kernel's time per call (one launch a call).  If they come from several
    kernels or there are none, the time is CUDA events' (host launch gaps
    included) and the device operations per call are None (not measured).
    Either way the trace is appended to :data:`PARTIAL_TRACES`, so that a
    report can mark the time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and (kernel is None or kernel in e.name)]
        if len(kern) >= iters:
            return (sum(e.time_range.elapsed_us() for e in kern) / 1e3
                    / iters, len(kern) / iters)
    names = sorted({e.name for e in kern})
    if len(names) == 1:
        ms, ops, how = (sum(e.time_range.elapsed_us() for e in kern) / 1e3
                        / len(kern), 1.0, "their mean device time")
    else:
        ms, ops, how = time_ms(fn, iters), None, "CUDA events' time instead"
    PARTIAL_TRACES.append({"kernel": " + ".join(names) or str(kernel),
                           "kept": len(kern), "calls": iters, "ms": ms,
                           "clock": "device" if ops else "cuda_events"})
    print(f"[timing] torch.profiler kept {len(kern)} device operations of "
          f"{len(names)} kernels for {iters} calls of "
          f"{PARTIAL_TRACES[-1]['kernel'][:60]}: {how}, {ms:.4f} ms",
          flush=True)
    return ms, ops


def call_device_ms(fn: Callable, iters: int, kernel: str
                   ) -> Optional[float]:
    """Device ms per call of ``fn`` with every device operation it runs:
    ``kernel`` and the wrapper's own tensor ops and copies.  A trace counts
    when it holds exactly ``iters`` events of ``kernel``, one a call; after
    three traces that do not, None (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if sum(kernel in e.name for e in ops) == iters:
            return sum(e.time_range.elapsed_us() for e in ops) / 1e3 / iters
    return None


def host_ms(fn: Callable, iters: int) -> float:
    """ms per call of ``fn`` on the host clock (CPU runs)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_ms(ops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    """(least ms for ``ops`` operations and ``nbytes`` bytes on one H100,
    "operations" or "bytes", whichever bounds it)."""
    t_ops = ops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def card_line(dev: torch.device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for a card, or the CPU."""
    if dev.type != "cuda":
        return "cpu (no card: host clock only)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[dev.index or 0] if lines else ""


# --------------------------------------------------------------------------
# the probe
# --------------------------------------------------------------------------

def probe_inputs(seed: int = 0, matmul_n: int = 8192, icp_q: int = 2560,
                 n: int = 20480, moments_q: int = 4096, moments_p: int = 8192,
                 moments_c: int = 8) -> dict:
    """The TPU tool's inputs (``tools/perf_mfu_roofline.py:133-206``), drawn
    in its order: two normal [matmul_n]^2 matrices, the ICP queries, the
    support, the map-side queries, then the moments clouds and features."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "a": rng.normal(size=(matmul_n, matmul_n)),
        "b": rng.normal(size=(matmul_n, matmul_n)),
        "q_icp": rng.uniform(-40, 40, (icp_q, 3)).astype(f32),
        "p": rng.uniform(-40, 40, (n, 3)).astype(f32),
        "q_map": rng.uniform(-40, 40, (n, 3)).astype(f32),
        "q_moments": rng.uniform(-40, 40, (moments_q, 3)).astype(f32),
        "p_moments": rng.uniform(-40, 40, (moments_p, 3)).astype(f32),
        "f_moments": rng.uniform(0, 1, (moments_p, moments_c)).astype(f32),
    }


def run_probe(device="cuda", inputs: Optional[dict] = None) -> dict:
    """Every row of the probe on ``device`` (``"cuda"`` unless the caller
    asks for the CPU) and on ``inputs`` (:func:`probe_inputs`'s), in the
    TPU tool's order, each printed as it is measured; returns the record
    that ``--out`` writes."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    x = probe_inputs() if inputs is None else inputs
    rec = {"device": (torch.cuda.get_device_name(dev) if on_card
                      else "cpu"),
           "clock": ("device (torch.profiler) and CUDA events" if on_card
                     else "host (perf_counter)"),
           "reps": REPS, "rows": []}

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    def row(name, shape, fn, ops, nbytes, precision="fp32",
            useful_ops=None, note="", kernel=None):
        """Times ``fn``.  ``ops`` at the peak of ``precision`` gives the
        achieved rate and the bound; where the kernel does more than the
        function needs (the dense form), ``useful_ops`` at the fp32 peak
        gives the bound and ``ops`` the tensor floor.  With ``kernel``,
        the device time is that kernel's alone, and the call's whole
        device time (the wrapper's own tensor ops too) is kept beside it."""
        call = None
        if on_card:
            ms, per_call = device_ms(fn, REPS, kernel)
            if kernel is not None:
                call = call_device_ms(fn, REPS, kernel)
            ev = time_ms(fn, REPS)
        else:
            ms, per_call, ev = host_ms(fn, REPS), None, None
        peak = PEAK_BF16_FLOPS if precision == "bf16" else PEAK_FP32_FLOPS
        if useful_ops is None:
            b, by = bound_ms(ops, nbytes, peak)
        else:
            b, by = bound_ms(useful_ops, nbytes)
        measured = rec.get(f"measured_peak_{precision}_tflops")
        r = {"kernel": name, "shape": shape, "precision": precision,
             "device_ms": ms if on_card else None, "event_ms": ev,
             "call_device_ms": call,
             "host_ms": None if on_card else ms,
             "device_ops_per_call": per_call, "gflop": ops / 1e9,
             "achieved_tflops": ops / ms / 1e9,
             # a matmul row is the measured peak itself
             "share_of_measured_peak": (ops / ms / 1e9 / measured
                                        if measured else 1.0),
             "bound_ms": b, "bound_by": by, "bound_share": b / ms,
             "note": note}
        if useful_ops is not None:
            r["tensor_floor_ms"], r["tensor_floor_by"] = bound_ms(
                ops, nbytes, peak)
        rec["rows"].append(r)
        print(f"[probe] {name:13s} {shape:24s} "
            + (f"{ms:9.4f} ms device, {ev:9.4f} ms events"
               if on_card else f"{ms:9.4f} ms host")
            + (f" (the call {call:.4f} ms device)" if call is not None
               else " (the call's device ms not measured)"
               if kernel is not None and on_card else "")
            + f"  {r['achieved_tflops']:8.3f} TFLOP/s {precision} "
            f"({100 * r['share_of_measured_peak']:5.1f} % of measured)  "
            f"bound {b:.5f} ms ({by}, {100 * r['bound_share']:.1f} %)"
            + (f", tensor floor {r['tensor_floor_ms']:.5f} ms"
               if useful_ops is not None else "")
            + (f"  {note}" if note else ""), flush=True)
        return r

    # measured matmul peaks: bf16 in (fp32 accumulation), then fp32 with the
    # package's flags (TF32 off)
    mn = x["a"].shape[0]
    a16, b16 = t(x["a"], torch.bfloat16), t(x["b"], torch.bfloat16)
    mm_ops = 2.0 * mn ** 3
    rec["measured_peak_bf16_tflops"] = row(
        "matmul bf16", f"{mn}^3", lambda: torch.matmul(a16, b16), mm_ops,
        3 * mn * mn * 2, "bf16")["achieved_tflops"]
    a32, b32 = a16.float(), b16.float()
    del a16, b16
    rec["measured_peak_fp32_tflops"] = row(
        "matmul fp32", f"{mn}^3", lambda: torch.matmul(a32, b32), mm_ops,
        3 * mn * mn * 4)["achieved_tflops"]
    del a32, b32

    # 1-NN at the ICP shape, then at the map-side 20k x 20k: 9 operations a
    # pair
    p = t(x["p"])
    pn = p.shape[0]
    pm = torch.ones(pn, dtype=torch.bool, device=dev)
    for key in ("q_icp", "q_map"):
        q = t(x[key])
        qn = q.shape[0]
        qm = torch.ones(qn, dtype=torch.bool, device=dev)
        row("nn", f"{qn} x {pn}", lambda: kernels.nn(q, qm, p, pm),
            9.0 * qn * pn, 21 * qn + 13 * pn)

    # PCA moments, count only and the static stack at 20k x 20k, r^2 = 1
    q = t(x["q_map"])
    qn = q.shape[0]
    r2 = torch.full((qn,), 1.0, dtype=torch.float32, device=dev)
    hits = float(count_within_plain(q, p, pm, r2).sum())
    pairs = float(qn) * pn
    shape = f"{qn} x {pn}"
    row("pca_moments", shape, lambda: kernels.pca_moments(q, p, pm, r2),
        10.0 * pairs + 15.0 * hits, 16 * qn + 13 * pn + 40 * qn,
        note=f"{hits / qn:.3f} hits a query")
    # the function needs the bytes and 10 operations a hit; the walk's
    # candidate pairs are its design's work, a diagnostic
    cand = kernels.candidate_pairs(q, p, pm, r2)
    row("count_within", shape, lambda: count_within(q, p, pm, r2),
        10.0 * hits, 16 * qn + 13 * pn + 4 * qn,
        note=f"cell-grid count, {cand / qn:.2f} candidates a query",
        kernel="count_within_kernel")["candidate_pairs"] = cand
    ones = torch.ones((pn, STACK_C), dtype=torch.bfloat16, device=dev)
    row("adj_stack", f"{shape}, C={STACK_C}",
        lambda: adj_stack(q, p, pm, r2, ones), 2.0 * STACK_C * pairs,
        16 * qn + 13 * pn + 2 * pn * STACK_C + 4 * qn * STACK_C, "bf16",
        useful_ops=10.0 * pairs + STACK_C * hits,
        note="dense tensor-core form, static ones stack",
        kernel="adj_stack_kernel")

    # moments (NCC descriptor counts) with C random features and close sums.
    # The tool passes no close radius (the TPU kernel then closes at d2 <=
    # 0); here 0.64 r^2, as tests/test_torch_kernels.py
    qv, pv, fs = t(x["q_moments"]), t(x["p_moments"]), t(x["f_moments"])
    qn, pn, cn = qv.shape[0], pv.shape[0], fs.shape[1]
    pmv = torch.ones(pn, dtype=torch.bool, device=dev)
    r2v = torch.full((qn,), 1.0, dtype=torch.float32, device=dev)
    cr2 = 0.64 * r2v
    hits = float(count_within_plain(qv, pv, pmv, r2v).sum())
    close = float(count_within_plain(qv, pv, pmv, cr2).sum())
    row("moments", f"{qn} x {pn}, C={cn} + close",
        lambda: kernels.moments(qv, pv, pmv, r2v, fs, cr2),
        10.0 * qn * pn + cn * (hits + close),
        20 * qn + 13 * pn + 4 * pn * cn + 8 * qn * cn,
        note="close r^2 = 0.64 r^2")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the plain "
                         "versions and is for small shapes only")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line(dev)
    print(card, flush=True)
    reset_launch_counts()
    rec = run_probe(dev)
    rec["card"] = card
    rec["launches"] = launch_counts()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
