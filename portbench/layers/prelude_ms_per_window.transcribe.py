"""Whisper encoder (torch_models.py, whisper/generate.py): the program's spans whisper.features (log-mel), whisper.cross_kv and whisper.detect_language over its counter whisper.windows, ms a decoding window."""

from portbench.layers.program import ms_per_count


def read(trace):
    return ms_per_count(["whisper.features", "whisper.cross_kv", "whisper.detect_language"],
                        "whisper.windows")
