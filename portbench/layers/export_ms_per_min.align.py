"""Output (align/aligner.py, io/textgrid.py): the program's span export_textgrids (the WAV re-read for each file's length, export_read_durations, inside it), ms a minute of audio."""

from portbench.layers.program import ms_per_audio_min


def read(trace):
    return ms_per_audio_min(trace, ["export_textgrids"])
