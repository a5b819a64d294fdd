#!/usr/bin/env python3
"""Whisper's figures on a card, with and without the deterministic cuBLAS
workspace.

    python3 tools/whisper_card.py [RUNS]

Builds ``chip_smoke.py``'s 8-utterance corpus (3-6 s, 38.25 audio-s) and
runs its ``whisper`` phase (large-v3-turbo's widths and depth, random
weights written as float16 safetensors, ``transcribe_whisper`` on the
card, a warm run, the card against the CPU) in a process of its own
``RUNS`` times (default 3), alternating the environment: without
``CUBLAS_WORKSPACE_CONFIG``, with ``:4096:8`` (what ``chip_smoke.py`` sets
for its deterministic training run, which cuBLAS reads once a process),
without. Prints the card as ``nvidia-smi`` gives it and, for each run,
one JSON line of the phase's figures and one of the whisper-settings
phase's (the same checkpoint under ``chip_smoke.WHISPER_SETTINGS``: 4
beams, timestamps, conditioning on earlier windows, no repeated trigram).
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

FIGURES = ("cold_command_s", "load_s", "warm_s", "warm_audio_s_per_s",
           "encoder_ms_per_utterance", "decoder_ms_per_token", "tokens",
           "warm_peak_gib", "checkpoint_write_s", "card_vs_cpu")
SETTINGS_FIGURES = ("cold_command_s", "warm_s", "decoder_ms_per_step_4_beams",
                    "beam_steps", "windows", "warm_peak_gib", "phase_s",
                    "card_vs_cpu")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("whisper_card: no CUDA device", file=sys.stderr)
        return 2
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="whisper_card_") as d:
        tmp = Path(d)
        _model, _dict, words = chip_smoke.build_sat_scale_model(tmp)
        corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 8, min_s=3.0, max_s=6.0,
                                                seed=2, name="small2", num_speakers=2)
        for i in range(runs):
            workspace = ":4096:8" if i % 2 else None
            drop = () if workspace else ("CUBLAS_WORKSPACE_CONFIG",)
            if workspace:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = workspace
            (tmp / f"run{i}").mkdir()
            t0 = time.perf_counter()
            report = chip_smoke.CpuTask(
                "whisper_phase", (tmp / f"run{i}", corpus_dir, torch.device("cuda")),
                tmp / f"run{i}.pkl", daemon=False, drop_env=drop).result()
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            settings = report.pop("settings")
            print(json.dumps({"run": i, "cublas_workspace_config": workspace,
                              "phase_s": time.perf_counter() - t0,
                              **{k: report[k] for k in FIGURES}}), flush=True)
            print(json.dumps({"run": i, "path": "whisper-settings",
                              **{k: settings[k] for k in SETTINGS_FIGURES}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
