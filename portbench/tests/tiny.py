"""Tiny versions of the benchmark's cells, for runs on the CPU: the same
runners, references and checks at sizes a test can hold."""

from __future__ import annotations

import copy
import json
import tempfile
from pathlib import Path

import torch

from portbench import harness

BENCH = harness.BENCH_DIR
MANIFEST = harness.load_json(BENCH.parent / "BENCHMARK.json")


def config(name: str) -> dict:
    cfg = harness.load_json(BENCH / "configs" / f"{name}.json")
    if cfg["kind"] == "gmm_sat":
        cfg.update(name="tiny-gmm", num_phones=5, gauss_per_pdf=4, dim=12,
                   dictionary_words=60, word_phones=[2, 4])
    else:
        cfg.update(name="tiny-whisper", vocab_size=2000 + 2 + 100 + 6 + 1501, num_mel_bins=80,
                   d_model=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=128,
                   decoder_layers=2, decoder_attention_heads=4, decoder_ffn_dim=128,
                   max_target_positions=24,
                   text={"n_base": 2000, "n_languages": 100, "n_timestamps": 1501})
    return cfg


def traffic(name: str) -> dict:
    t = harness.load_json(BENCH / "traffic" / f"{name}.json")
    t.update(speakers=2, utterances_per_speaker=3 if t["runner"] == "align" else 2,
             jobs=2, length_s={"dist": "uniform", "min": 1.5, "max": 3.0})
    if t["runner"] == "align":
        t.update(batch_size=4, judge_speakers=2)
    else:
        t.update(judge_utterances=3)
    return t


def context(workload: str, tmp: Path, seed: int = 12345, trace: bool = False,
            seconds: float = 0.5) -> harness.Context:
    w = next(w for w in MANIFEST["workloads"] if w["name"] == workload)
    cfg_name = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])["name"]
    limits = harness.load_json(BENCH / "limits" / f"{workload}.json")
    work = Path(tempfile.mkdtemp(prefix=f"{workload}-", dir=tmp))
    return harness.Context(copy.deepcopy(MANIFEST), w, config(cfg_name), traffic(w["traffic"]),
                           limits, seed, seconds, trace, torch.device("cpu"),
                           Path(tmp) / "cache", work)


def result_line(result: dict) -> dict:
    """The result as the run prints it: one JSON object."""
    return json.loads(json.dumps(result))
