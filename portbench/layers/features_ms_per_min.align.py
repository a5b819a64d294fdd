"""Features (ops/mfcc.py, ops/feats.py, ops/tiles.py): phases phase_a_dispatch and graph_ship_and_final_feats, ms a minute of audio."""

from portbench.layers.common import ms_per_audio_min


def read(trace):
    return ms_per_audio_min(trace, ["phase_a_dispatch", "graph_ship_and_final_feats"])
