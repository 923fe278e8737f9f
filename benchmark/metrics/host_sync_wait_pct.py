"""The share of the traced segment's wall time that the main thread spends
in the program's host syncs (the spans ``sync.<site>``: the host blocked
on the device), in per cent."""

from benchlib.spans import span_pct_of_trace


def read(run):
    return span_pct_of_trace(run, lambda name: name.startswith("sync."))
