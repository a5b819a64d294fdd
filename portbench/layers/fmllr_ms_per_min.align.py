"""fMLLR (ops/transforms.py, native/fmllr_solve.cc): phases fmllr_pass1 (with the speaker-independent pass), fmllr_stats_fetch, fmllr_solve, fmllr_apply, ms a minute of audio."""

from portbench.layers.common import ms_per_audio_min


def read(trace):
    return ms_per_audio_min(trace, ["fmllr_pass1", "fmllr_stats_fetch", "fmllr_solve", "fmllr_apply"])
