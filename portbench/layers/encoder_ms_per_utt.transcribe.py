"""Whisper encoder (transcription/whisper/model.py): the benchmark's synchronised timer around the encoder call, ms an utterance."""

from portbench.layers.common import timer_ms


def read(trace):
    return timer_ms(trace, "encoder_s", "encoder_calls")
