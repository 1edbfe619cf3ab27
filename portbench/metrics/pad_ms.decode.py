"""Host clock around ``pad_batch`` up to its copy's completion (the traced
run synchronises after it), the mean over the window's requests."""

from portbench.readers import span_ms


def read(run):
    return span_ms(run, "pad")
