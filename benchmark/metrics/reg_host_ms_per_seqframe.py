"""Host milliseconds of the batched step's registration stage (the
program's span ``step.reg``: scan-to-map MULLS-ICP and the pose, its
host syncs included) over the traced segment, a sequence-frame."""

from benchlib.spans import span_ms_per_seqframe


def read(run):
    return span_ms_per_seqframe(run, "step.reg")
