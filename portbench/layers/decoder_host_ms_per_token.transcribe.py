"""Whisper decoder loop (whisper/generate.py): self time of the program's spans whisper.decoder_step (the step's launches) and whisper.logits_processors over its counter whisper.decoder_steps, ms a decoded token."""

from portbench.layers.program import ms_per_count


def read(trace):
    return ms_per_count(["whisper.decoder_step", "whisper.logits_processors"],
                        "whisper.decoder_steps", self_time=True)
