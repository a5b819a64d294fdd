"""Whisper decoder loop (whisper/generate.py, model.py): the benchmark's synchronised timer around each window's greedy loop (decoder steps and logits processors), ms a decoded token."""

from portbench.layers.common import timer_ms


def read(trace):
    return timer_ms(trace, "decoder_s", "decoder_steps")
