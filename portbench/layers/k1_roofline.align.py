"""K1 (csrc/band_viterbi.cu): its counted work's least time over its device time in the traced window, %."""

from portbench.layers.common import roofline_pct


def read(trace):
    return roofline_pct(trace, "k1")
