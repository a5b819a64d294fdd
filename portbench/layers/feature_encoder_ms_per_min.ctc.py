"""wav2vec2 feature encoder (wav2vec2/model.py extract): the program's spans wav2vec2.feature_encoder (normalisation, convolutions, projection), ms a minute of audio."""

from portbench.layers.program import ms_per_audio_min


def read(trace):
    return ms_per_audio_min(trace, ["wav2vec2.feature_encoder"])
