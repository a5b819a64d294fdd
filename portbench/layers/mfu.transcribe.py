"""The whole step: the counted operations of every encoder call, cross-attention projection and decoder step over the window and the float32-accurate peak, %."""

from portbench.layers.common import mfu_pct


def read(trace):
    return mfu_pct(trace, ["encoder", "cross_kv", "decoder"])
