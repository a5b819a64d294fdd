"""Whisper decoder loop (whisper/generate.py): the program's spans whisper.token_fetch (the argmax to a Python int: the host waits on the card) over its counter whisper.decoder_steps, ms a decoded token."""

from portbench.layers.program import ms_per_count


def read(trace):
    return ms_per_count(["whisper.token_fetch"], "whisper.decoder_steps")
