"""Host time inside each ``train_step`` call before it returns, the mean
over the window's steps: whether the host stays ahead of the card."""

from portbench.readers import span_ms


def read(run):
    return span_ms(run, "train_step")
