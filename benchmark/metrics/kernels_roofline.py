"""The program's CUDA kernels together, over the traced segment: the sum
of the bounds of all their launches over the sum of their device times
(each kernel's bound as its own ``<kernel>_roofline`` reader counts it;
every reader with a ``KERNEL`` takes part)."""


def read(run):
    parts = [run.roofline(r.KERNEL, r.CALLS, r.work)
             for r in run.readers.values() if hasattr(r, "KERNEL")]
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    return 100.0 * sum(b for b, _ in parts) / sum(t for _, t in parts)
