"""Output (align/aligner.py, io/textgrid.py): phases path_fetch and ctm and the benchmark's span around export_textgrids, ms a minute of audio."""

from portbench.layers.common import ms_per_audio_min


def read(trace):
    return ms_per_audio_min(trace, ["path_fetch", "ctm", "export_textgrids"])
