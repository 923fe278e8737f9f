"""The nn kernel's share of its roofline over the traced segment: the sum
of its launches' bounds over the sum of their device times.

A launch's bound is the larger of its bytes over 3.35 TB/s and its fp32
operations over 67 TFLOP/s (one H100 at 700 W).  Operations: 9 a pair of
valid query and valid support point, the pairs of an exact 1-NN by brute
force; an implementation that needs fewer pairs needs a benchmark change to
recount.  Bytes: each entry's queries and support read once (12 bytes of
coordinates and a mask byte a point), its index and distance written once
(8 bytes a query)."""

KERNEL = "nn_grouped_kernel"
CALLS = ("nn", "nn_grouped")
COUNTER = "nn"


def keep(name, args, kw):
    """The masks of each problem of a call (no device work)."""
    problems = [args[:4]] if name == "nn" else [tuple(p) for p in args[0]]
    return [(pr[1], pr[3]) for pr in problems]


def work(calls):
    out = []
    for _, problems in calls:
        for q_mask, p_mask in problems:
            qn, pn = q_mask.shape[-1], p_mask.shape[-1]
            entries = q_mask.numel() // qn if qn else 0
            if entries == 0:
                continue
            pairs = float((q_mask.reshape(entries, qn).sum(-1).double()
                           * p_mask.reshape(entries, pn).sum(-1).double()
                           ).sum())
            out.append((9.0 * pairs, entries * (13.0 * qn + 13.0 * pn
                                                + 8.0 * qn)))
    return out


def read(run):
    b = run.roofline(KERNEL, CALLS, work)
    return None if b is None else 100.0 * b[0] / b[1]
