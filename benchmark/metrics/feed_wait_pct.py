"""The share of the traced segment's wall time that the step waits on its
feeds (the program's span ``feed.wait``: the consumer blocked on the
prefetch queue), in per cent."""

from benchlib.spans import span_pct_of_trace


def read(run):
    return span_pct_of_trace(run, lambda name: name == "feed.wait")
