"""The host's syncs with the device a batched frame over the window: the
program's sync counters (``sync:<site>``, counted at every site where the
host waits for the device, whether tracing is on or not), summed over
sites, a batched frame of the window."""

from benchlib.spans import delta


def read(run):
    if not run.trace:
        return None
    rec = run.rec
    d = delta(rec.launches[rec.start], rec.launches[rec.end])
    keys = [k for k in d if k.startswith("sync:")]
    if not keys or not rec.window_frames:
        return None
    return sum(d[k] for k in keys) / rec.window_frames
