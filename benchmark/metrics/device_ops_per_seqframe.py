"""Device operations (kernels, copies, sets) in the traced steady segment,
a sequence-frame: how much separate device work the batched step issues."""


def read(run):
    n = run.traced_seqframes()
    return run.trace["device_ops"] / n if n else None
