"""What the per-layer metrics of the program's spans and sync counters
read: differences of the snapshots of the program's launch record.

``drive.Hook`` copies the record at every segment boundary into
``rec.launches[frames done]``.  Besides the kernels' launches, the program
adds to it (``mulls_tpu_torch/core/trace.py``) each span's wall time and
entries, ``span:<name>:ns`` and ``span:<name>:n``, while spans are on (on
the traced segment, while ``torch.profiler`` records), and each host sync
by site, ``sync:<site>``, always.  A program without them (no such key)
gives no number."""

from __future__ import annotations

from typing import Optional


def delta(a: dict, b: dict) -> dict:
    """The counts from snapshot ``a`` to snapshot ``b``."""
    return {k: v - a.get(k, 0) for k, v in b.items()}


def traced(run) -> Optional[dict]:
    """The record's counts over the traced segment; None without a
    complete trace."""
    if not run.trace:
        return None
    a, b = run.trace["segment"]
    return delta(run.rec.launches[a], run.rec.launches[b])


def span_ms_per_seqframe(run, name: str) -> Optional[float]:
    """Span ``name``'s milliseconds in the traced segment a
    sequence-frame."""
    d = traced(run)
    key = f"span:{name}:ns"
    if d is None or key not in d:
        return None
    return d[key] / 1e6 / run.traced_seqframes()


def span_pct_of_trace(run, names) -> Optional[float]:
    """100 x the spans ``names``' time in the traced segment over its wall
    time (``names``: a predicate on the span's name)."""
    d = traced(run)
    if d is None or run.trace["window_s"] <= 0:
        return None
    keys = [k for k in d if k.startswith("span:") and k.endswith(":ns")
            and names(k[len("span:"):-len(":ns")])]
    if not keys:
        return None
    return 100.0 * sum(d[k] for k in keys) / 1e9 / run.trace["window_s"]
