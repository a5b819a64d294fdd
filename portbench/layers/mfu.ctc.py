"""The whole step: the counted operations of every utterance's feature encoder, encoder and CTC head over the window and the float32-accurate peak, %."""

from portbench.layers.common import mfu_pct


def read(trace):
    return mfu_pct(trace, ["feature_encoder", "encoder", "ctc_head"])
