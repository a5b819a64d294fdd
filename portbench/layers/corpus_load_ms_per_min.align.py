"""Audio load (corpus/corpus.py): the program's span corpus_load around Corpus.load (the directory walk and the transcripts), ms a minute of audio."""

from portbench.layers.program import ms_per_audio_min


def read(trace):
    return ms_per_audio_min(trace, ["corpus_load"])
