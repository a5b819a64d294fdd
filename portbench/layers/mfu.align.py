"""The whole step: K3's and K1's counted operations over the window and the float32-accurate peak, %."""

from portbench.layers.common import mfu_pct


def read(trace):
    return mfu_pct(trace, ["k3", "k1"])
