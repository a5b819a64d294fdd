"""``chip_smoke.py``'s adapt, graph-compile, pitch and fine-tune phases at a
tiny size on the CPU, where every kernel wrapper takes its plain version
(so no launches are counted): their reports, checks and the kernels line
with adapt's launches and checks."""

import sys
from pathlib import Path

import pytest
import torch

import montreal_forced_aligner_tpu_torch.align.aligner as PA
import montreal_forced_aligner_tpu_torch.training.base as PB

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smoke_phases")
    model_path, dict_path, words = chip_smoke.build_sat_scale_model(
        tmp, num_phones=5, gauss_per_pdf=3, num_words=15
    )
    corpus_dir, audio_s = chip_smoke.build_corpus(tmp, words, 6, 2.0, 3.0,
                                                  num_speakers=2)
    small_dir, _ = chip_smoke.build_corpus(tmp, words, 3, 1.5, 2.5, seed=1,
                                           name="small", num_speakers=2)
    tone_dir, _truths = chip_smoke.make_tone_corpus(tmp / "tone", n_utts=4)
    tone_dict = tmp / "tone.dict"
    tone_dict.write_text("".join(f"{w}\t{' '.join(p)}\n"
                                 for w, p in chip_smoke.WORD_PHONES.items()))
    return tmp, model_path, dict_path, corpus_dir, audio_s, small_dir, tone_dir, tone_dict


def test_adapt_phase_runs_on_cpu(fixture, monkeypatch):
    tmp, model_path, dict_path, corpus_dir, audio_s, small_dir, *_ = fixture
    # K3's plain version on this small model, so its check runs
    for mod in (PA, PB):
        monkeypatch.setattr(mod, "_emission_kernel_eligible", lambda P, G: True)
    cpu = torch.device("cpu")
    report, checks = chip_smoke.adapt_phase(model_path, dict_path, corpus_dir,
                                            small_dir, tmp, audio_s, cpu,
                                            warm_runs=1, batch_size=4)
    assert report["launches"] == {"band_forward": 0, "band_backtrace": 0,
                                  "state_emission": 0}
    assert report["batches"] == 2 and report["aligned_utterances"] == 6
    assert report["two_runs_identical"]
    assert report["card_vs_cpu"]["means_rel_err"] == {"final": 0.0,
                                                      "speaker_independent": 0.0}
    assert {"pass_1", "fmllr", "pass_2", "stats", "map_update", "si_stats",
            "si_map_update"} <= set(report["phases_synced_s"])
    assert set(checks) == {"band_forward", "band_backtrace", "state_emission"}
    for c in checks.values():
        assert c["max_abs_err"] == 0.0
    line = chip_smoke.kernels_line(checks, report["launches"],
                                   {"adapt": report["launches"]}, {"adapt": checks})
    for row in line["kernels"]:
        assert row["launches_by_path"] == {"adapt": 0}
        assert row["adapt_check"]["max_abs_err"] == 0.0


def test_graph_pitch_and_fine_tune_phases_run_on_cpu(fixture):
    (tmp, model_path, dict_path, corpus_dir, audio_s, small_dir, tone_dir,
     tone_dict) = fixture
    cpu = torch.device("cpu")
    kept = {}
    chip_smoke.train_mono_phase(tone_dir, tone_dict, 10.0, cpu, warm_runs=1,
                                batch_size=2, keep=kept)
    graphs = chip_smoke.graph_compile_phase(kept["trainer"], kept["corpus"],
                                            model_path, dict_path, corpus_dir, cpu,
                                            workers=2)
    assert graphs["train_mono_native"]["identical"]
    assert graphs["train_mono_native"]["utterances"] == 4
    assert graphs["sat_si_pool"]["identical"]
    pitch = chip_smoke.pitch_phase(tone_dir, tone_dict, small_dir, 10.0, cpu,
                                   batch_size=2)
    assert pitch["train_mono_pitch"]["feature_dim"] == 48
    assert pitch["card_vs_cpu"]["lag_path_agreement"] == 1.0
    assert pitch["card_vs_cpu"]["features_max_abs_diff"] == 0.0
    tuned = chip_smoke.fine_tune_phase(model_path, dict_path, corpus_dir, small_dir,
                                       cpu, batch_size=4)
    assert tuned["utterances"] == 6 and tuned["moved_off_grid"] > 0
    assert tuned["card_vs_cpu"]["max_boundary_diff_s"] == 0.0
