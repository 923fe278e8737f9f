"""The moments kernel's share of its roofline over the traced segment: the
sum of its launches' bounds over the sum of their device times.

A launch's bound is the larger of its bytes over 3.35 TB/s and its fp32
operations over 67 TFLOP/s (one H100 at 700 W).  Operations: C (the
feature width) a hit, and C more a hit of the close radius, on the hits
that the benchmark counts itself (``benchlib/work.py``); no operation is
counted for a pair outside the radius, so no search strategy is assumed.
Bytes: queries and radii read once (16 bytes a query, 4 more with a close
radius), support and features once (13 + 4 C bytes a point), sums written
once (4 C bytes a query, twice with a close radius)."""

from benchlib.work import hits

KERNEL = "moments_kernel"
CALLS = ("moments",)
COUNTER = "moments"


def keep(name, args, kw):
    """The query and support clouds, the radii and the feature width."""
    q_xyz, p_xyz, p_mask, r2, feat = args[:5]
    close_r2 = args[5] if len(args) > 5 else kw.get("close_r2")
    return q_xyz, p_xyz, p_mask, r2, feat.shape[-1], close_r2


def work(calls):
    out = []
    for _, (q_xyz, p_xyz, p_mask, r2, cn, close_r2) in calls:
        qn, pn = q_xyz.shape[-2], p_xyz.shape[-2]
        entries = q_xyz.numel() // (3 * qn) if qn else 0
        if entries == 0:
            continue
        h, hc = hits(q_xyz, p_xyz, p_mask, r2, close_r2)
        two = close_r2 is not None
        nbytes = entries * (qn * (16.0 + 4.0 * two) + pn * (13.0 + 4.0 * cn)
                            + qn * 4.0 * cn * (1 + two))
        out.append((cn * (h + hc), nbytes))
    return out


def read(run):
    b = run.roofline(KERNEL, CALLS, work)
    return None if b is None else 100.0 * b[0] / b[1]
