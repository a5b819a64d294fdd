"""Whisper decoder loop: the counted work of its steps' least time over the card's busy time inside each window's greedy loop in the traced window, %."""

from portbench.layers.common import span_roofline_pct


def read(trace):
    return span_roofline_pct(trace, "decoder", "greedy loop")
