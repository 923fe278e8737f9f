"""The median of the window's per-segment rates (sequence-frames a second,
each segment from the end of the hook's work at its start to its end; a
traced segment left out): it stands beside the end-to-end rate, so that a
single stalled segment shows as a gap between the two."""

import statistics


def read(run):
    rates = run.rec.segment_rates()
    return statistics.median(rates) if rates else None
