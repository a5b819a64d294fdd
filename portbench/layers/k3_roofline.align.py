"""K3 (csrc/state_emission.cu): its counted work's least time over its device time in the traced window, %."""

from portbench.layers.common import roofline_pct


def read(trace):
    return roofline_pct(trace, "k3")
