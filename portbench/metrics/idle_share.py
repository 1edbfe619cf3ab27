"""``idle_share.train`` / ``idle_share.decode``: one minus the union of
the device's operation intervals over the traced window, in %."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)
