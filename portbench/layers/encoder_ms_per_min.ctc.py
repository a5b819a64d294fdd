"""wav2vec2 encoder (wav2vec2/model.py encode): the program's spans wav2vec2.encode (positional convolution, blocks, final LayerNorm), ms a minute of audio."""

from portbench.layers.program import ms_per_audio_min


def read(trace):
    return ms_per_audio_min(trace, ["wav2vec2.encode"])
