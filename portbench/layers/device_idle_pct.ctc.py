"""Device: the share of the traced window in which no operation ran on the card, %."""

from portbench.layers.common import idle_pct


def read(trace):
    return idle_pct(trace)
