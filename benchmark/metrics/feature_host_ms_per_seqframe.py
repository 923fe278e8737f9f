"""Host milliseconds of the batched step's feature stage (the program's
span ``step.feature``: extraction, its device work when the host waits on
it included) over the traced segment, a sequence-frame."""

from benchlib.spans import span_ms_per_seqframe


def read(run):
    return span_ms_per_seqframe(run, "step.feature")
