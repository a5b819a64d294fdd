"""Whisper encoder (whisper/generate.py, model.py): the program's spans whisper.encode over its counter whisper.windows, ms a decoding window."""

from portbench.layers.program import ms_per_count


def read(trace):
    return ms_per_count(["whisper.encode"], "whisper.windows")
