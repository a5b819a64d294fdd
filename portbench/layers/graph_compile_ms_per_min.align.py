"""Graph compile (graph/, native/graph_assembly.cc): phase graph_compile, ms a minute of audio."""

from portbench.layers.common import ms_per_audio_min


def read(trace):
    return ms_per_audio_min(trace, ["graph_compile"])
