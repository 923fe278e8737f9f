"""The pca_moments kernel's share of its roofline over the traced segment:
the sum of its launches' bounds over the sum of their device times.

A launch's bound is the larger of its bytes over 3.35 TB/s and its fp32
operations over 67 TFLOP/s (one H100 at 700 W).  Operations: 15 a hit (the
offset and the ten query-centred sums), on the hits that the benchmark
counts itself (``benchlib/work.py``); no operation is counted for a pair
outside the radius, so no search strategy is assumed.  Bytes: queries and
radii read once (16 bytes a query), support once (13 bytes a point), the
count and the nine sums written once (40 bytes a query)."""

from benchlib.work import hits

KERNEL = "pca_moments_kernel"
CALLS = ("pca_moments",)
COUNTER = "pca_moments"


def keep(name, args, kw):
    """The query and support clouds and the radii."""
    return tuple(args[:4])


def work(calls):
    out = []
    for _, (q_xyz, p_xyz, p_mask, r2) in calls:
        qn, pn = q_xyz.shape[-2], p_xyz.shape[-2]
        entries = q_xyz.numel() // (3 * qn) if qn else 0
        if entries == 0:
            continue
        h, _ = hits(q_xyz, p_xyz, p_mask, r2)
        out.append((15.0 * h, entries * (16.0 * qn + 13.0 * pn
                                         + 40.0 * qn)))
    return out


def read(run):
    b = run.roofline(KERNEL, CALLS, work)
    return None if b is None else 100.0 * b[0] / b[1]
