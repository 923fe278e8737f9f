"""Host milliseconds of the batched step's map stage (the program's span
``step.map``: undistortion, insertion, the periodic refresh) over the
traced segment, a sequence-frame."""

from benchlib.spans import span_ms_per_seqframe


def read(run):
    return span_ms_per_seqframe(run, "step.map")
