"""Audio load (corpus/corpus.py, io/): phase audio_load, ms a minute of audio."""

from portbench.layers.common import ms_per_audio_min


def read(trace):
    return ms_per_audio_min(trace, ["audio_load"])
