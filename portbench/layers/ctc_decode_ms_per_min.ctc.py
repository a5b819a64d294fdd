"""CTC head and decode (wav2vec2/model.py log_probs, wav2vec2/ctc.py): the program's spans wav2vec2.ctc_head and ctc.decode (argmax, its fetch, the text), ms a minute of audio."""

from portbench.layers.program import ms_per_audio_min


def read(trace):
    return ms_per_audio_min(trace, ["wav2vec2.ctc_head", "ctc.decode"])
