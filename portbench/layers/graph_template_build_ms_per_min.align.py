"""Graph compile (graph/compiler.py): the program's spans graph_template_build, each expansion template frozen on a cache miss, ms a minute of audio."""

from portbench.layers.program import ms_per_audio_min


def read(trace):
    return ms_per_audio_min(trace, ["graph_template_build"])
