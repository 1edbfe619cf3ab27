"""Host clock around ``InferenceModel.__call__``, ending in a synchronise
(traced run), the mean over the window's requests."""

from portbench.readers import span_ms


def read(run):
    return span_ms(run, "forward")
