"""Host clock around ``InferenceModel.decode``: the greedy decode and the
copy of its ids to the host, the mean over the window's requests."""

from portbench.readers import span_ms


def read(run):
    return span_ms(run, "decode")
