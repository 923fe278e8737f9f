"""The share of the traced segment in which no device operation ran:
100 x (1 - the union of the device operations' intervals / the segment's
wall time)."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
