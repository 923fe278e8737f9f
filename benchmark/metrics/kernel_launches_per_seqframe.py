"""Launches of the program's own CUDA kernels (nn, moments, pca_moments,
count_within; the program's launch counters) over the window, a
sequence-frame."""


def read(run):
    seqframes = run.S * run.rec.window_frames
    return run.launches() / seqframes if seqframes else None
