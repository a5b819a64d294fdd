"""wav2vec2 encoder: its counted work's least time over the card's busy time inside the encoder calls in the traced window, %."""

from portbench.layers.common import span_roofline_pct


def read(trace):
    return span_roofline_pct(trace, "encoder", "encode")
