"""Whisper decoder loop (whisper/generate.py): the program's counter whisper.decoder_graph_replays (greedy steps replayed as a CUDA graph) over its counter whisper.decoder_steps, %. None where the program keeps no replay counter."""

from portbench.layers.program import recording


def read(trace):
    rec = recording()
    if rec is None:
        return None
    counters = rec["counters"]
    steps = counters.get("whisper.decoder_steps")
    if "whisper.decoder_graph_replays" not in counters or not steps:
        return None
    return 100.0 * counters["whisper.decoder_graph_replays"] / steps
