"""wav2vec2 feature encoder: its counted work's least time over the card's busy time inside the feature-encoder calls in the traced window, %."""

from portbench.layers.common import span_roofline_pct


def read(trace):
    return span_roofline_pct(trace, "feature_encoder", "feature encoder")
