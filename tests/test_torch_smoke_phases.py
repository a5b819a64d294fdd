"""``chip_smoke.py``'s adapt, graph-compile, pitch, fine-tune,
transcription, segmentation, G2P, multi-GPU (with ``MFA`` and the parity
harness), transfer-features, pitch-paths, lvcsr-chain-major and speaker
statistics phases at a tiny size on the CPU, where
every kernel wrapper takes its plain version (so no launches are counted):
their reports, checks and the kernels line with adapt's, the dense
decode's and g2p-align's launches and checks."""

import sys

import numpy as np
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


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the decoders' small per-frame ops (see
    ``tests/test_torch_transcription.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_transcription_phases_run_on_cpu(fixture, monkeypatch, one_torch_thread):
    """transcribe-dense, -nbest, -lvcsr, -lvcsr-20k (at 200 junk words),
    phone-transcribe and the card-against-CPU check at a tiny size; the
    LVCSR threshold is lowered so the tiny corpus's vocabulary routes there."""
    import montreal_forced_aligner_tpu_torch.transcription.transcriber as PT

    tmp, model_path, dict_path, corpus_dir, audio_s, small_dir, *_ = fixture
    monkeypatch.setattr(PA, "_emission_kernel_eligible", lambda P, G: True)
    cpu = torch.device("cpu")
    words = [l.split()[0] for l in Path(dict_path).read_text().splitlines()]
    lms = chip_smoke.transcription_lms(words, n_words=8)
    dense, checks = chip_smoke.transcribe_dense_phase(
        model_path, dict_path, corpus_dir, audio_s, lms[0], cpu, batch_size=4,
        warm_runs=1, reps=1)
    assert dense["launches"] == {"band_forward": 0, "band_backtrace": 0,
                                 "state_emission": 0}
    assert dense["batches"] == 2 and dense["graph"]["words"] == 8
    assert {"fmllr_pass1", "decode_dispatch"} <= set(dense["phases_synced_s"])
    assert checks["state_emission"]["max_abs_err"] == 0.0
    # the batched graph pads S to a multiple of 64
    assert 0 <= checks["state_emission"]["shape"]["S"] - dense["graph"]["S"] < 64
    nbest = chip_smoke.transcribe_nbest_phase(model_path, dict_path, small_dir,
                                              lms, cpu, nbest=3, batch_size=4)
    assert max(nbest["alternatives_per_utterance"]) >= 2
    monkeypatch.setattr(PT.Transcriber, "LVCSR_WORD_THRESHOLD", 4)
    lvcsr, tr = chip_smoke.transcribe_lvcsr_phase(
        model_path, dict_path, corpus_dir, audio_s, cpu, batch_size=4)
    assert lvcsr["cross_word_fallback"] is False
    assert lvcsr["graph"]["S"] > 0 and len(lvcsr["warm_walls_s"]) == 1
    # the 20k recipe at 200 junk words, its graph built by a spawned worker
    task = chip_smoke.CpuTask("lvcsr_20k_graph",
                              (model_path, dict_path, corpus_dir, tmp, 200),
                              tmp / "g20k.pkl", threads=1)
    k20 = chip_smoke.transcribe_lvcsr_20k_phase(task.result(), model_path, cpu)
    assert not task.proc.is_alive() and not (tmp / "g20k.pkl").exists()
    assert k20["words"] == 200 and k20["graph_type"] == "LvcsrXwGraph"
    assert k20["graph_build_s"] > 0
    phone = chip_smoke.phone_transcribe_phase(model_path, dict_path, corpus_dir,
                                              small_dir, tmp, cpu, batch_size=4)
    assert phone["align --use_phone_model"]["evaluated_utterances"] == 6
    assert phone["align --use_phone_model"]["report"].startswith(
        "Phone-transcript evaluation")
    assert tr.lm.ngrams == chip_smoke.corpus_lm(model_path, dict_path,
                                                corpus_dir).ngrams
    cmp = chip_smoke.transcribe_card_vs_cpu(model_path, dict_path, small_dir,
                                            (lms[0], lms[0], tr.lm), cpu, nbest=3)
    for name in ("dense", "nbest", "lvcsr"):
        assert cmp[name]["max_score_diff"] == 0.0
    assert cmp["dense"]["state_path_agreement"] == 1.0
    assert cmp["lvcsr"]["state_path_agreement"] == 1.0
    # the same check stands in for sat-2pass's three
    base = {k: checks["state_emission"] for k in dense["launches"]}
    line = chip_smoke.kernels_line(base, dense["launches"],
                                   {"transcribe-dense": dense["launches"]},
                                   {"transcribe_dense": checks})
    row = {r["name"]: r for r in line["kernels"]}["state_emission"]
    assert row["launches_by_path"] == {"transcribe-dense": 0}
    assert row["transcribe_dense_check"]["max_abs_err"] == 0.0


def test_segmentation_phases_run_on_cpu(fixture, tmp_path, monkeypatch):
    """train-ivector, diarize, vad and create-segments at a tiny size (8
    Gaussians, 4 dimensions; the long path forced at 100 frames), and the
    card-against-CPU check on two CPU runs (one in a spawned worker)."""
    import montreal_forced_aligner_tpu_torch.online.alignment as PO
    import montreal_forced_aligner_tpu_torch.ops.long_viterbi as LV

    _tmp, model_path, dict_path, _corpus, _audio_s, small_dir, *_ = fixture
    cpu = torch.device("cpu")
    none = {"band_forward": 0, "band_backtrace": 0, "state_emission": 0}
    spk_dir, spk_s = chip_smoke.build_speaker_corpus(tmp_path, per_speaker=3,
                                                     min_s=2.0, max_s=3.0)
    subset_dir = chip_smoke.subset_corpus(spk_dir, tmp_path / "sub", 2)
    vad_dir, pauses, vad_s = chip_smoke.build_vad_set(tmp_path, num_files=2,
                                                      seconds=12.0)
    joined_dir, joined_s = chip_smoke.build_joined_utterance(small_dir, tmp_path)
    assert len(list(subset_dir.rglob("*.wav"))) == 16 and 5.0 < joined_s < 10.0
    args = (subset_dir, vad_dir, joined_dir, model_path, dict_path, "cpu", 8, 4)
    task = chip_smoke.CpuTask("segmentation_references", args, tmp_path / "seg.pkl",
                              threads=1)
    cmp = chip_smoke.segmentation_card_vs_cpu(
        chip_smoke.segmentation_references(*args), task.result())
    assert not task.proc.is_alive()
    assert cmp["ivector"]["utterances"] == 16 and cmp["ivector"]["min_cosine"] >= 0.999
    assert cmp["create_segments"]["segments"] >= 1

    ivec, model = chip_smoke.train_ivector_phase(spk_dir, tmp_path, spk_s, cpu,
                                                 num_gauss=8, ivector_dim=4,
                                                 num_iterations=2)
    assert ivec["launches"] == none and ivec["two_runs_identical"]
    assert ivec["utterances"] == 24 and ivec["speakers"] == 8
    assert {"features", "ubm", "stats", "em", "plda", "save"} == set(
        ivec["phases_synced_s"])
    diar = chip_smoke.diarize_phase(spk_dir, model, tmp_path / "diar", cpu)
    assert diar["launches"] == none and set(diar["runs"]) == set(chip_smoke.DIARIZE_RUNS)
    for run in diar["runs"].values():
        assert run["utterances"] == 24 and 0.0 < run["purity"] <= 1.0
    assert "purity" in diar["runs"]["cluster-cosine"]["output"]
    vad = chip_smoke.vad_phase(vad_dir, pauses, tmp_path / "vad_out", vad_s, cpu)
    assert vad["launches"] == none and vad["segments"] > 0
    assert vad["pauses_found_share"] > 0.5 and vad["median_boundary_error_s"] < 0.1

    long_dir, _ = chip_smoke.build_corpus(tmp_path, [l.split()[0] for l in
                                                     Path(dict_path).read_text().splitlines()],
                                          1, 4.0, 4.0, seed=3, name="long",
                                          num_speakers=1)
    monkeypatch.setattr(PA, "_emission_kernel_eligible", lambda P, G: True)
    monkeypatch.setattr(PO, "LONG_UTTERANCE_FRAMES", 100)
    monkeypatch.setattr(LV, "CHUNK_FRAMES", 90)
    segs = chip_smoke.create_segments_phase(model_path, dict_path, long_dir,
                                            tmp_path / "seg_out", cpu, reps=1)
    assert segs["launches"] == none and segs["chunks"] == 5
    assert segs["segments"] >= 1 and segs["words"] == 10
    for k in ("state_emission", "band_forward", "band_backtrace"):
        assert segs["last_chunk"][f"{k}_max_abs_err"] == 0.0
    line = chip_smoke.kernels_line(
        {k: {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 1.0, "bound_ms": 1.0,
             "bound_by": "bytes", "library_ms": None} for k in none}, none,
        {"train-ivector": ivec["launches"], "diarize": diar["launches"],
         "vad": vad["launches"], "create-segments": segs["launches"]})
    for row in line["kernels"]:
        assert row["launches_by_path"] == {"train-ivector": 0, "diarize": 0,
                                           "vad": 0, "create-segments": 0}


def test_g2p_phases_run_on_cpu(fixture, tmp_path, monkeypatch):
    """g2p-align (the FLAC writer, ``cli train_g2p``, the native decode,
    ``cli align`` with G2P, rules and the English tokenizer, the API runs,
    the kernels on pass 2's first batch), its card-against-CPU check (the
    CPU half in a spawned worker), the plain FLAC decode and train-g2p, at a
    tiny size."""
    _tmp, model_path, _d, corpus_dir, audio_s, *_ = fixture
    monkeypatch.setattr(PA, "_emission_kernel_eligible", lambda P, G: True)
    cpu = torch.device("cpu")
    none = {"band_forward": 0, "band_backtrace": 0, "state_emission": 0}
    build = chip_smoke.build_g2p_fixture
    monkeypatch.setattr(chip_smoke, "build_g2p_fixture",
                        lambda *a: build(*a, subset=3, num_words=40, held_out=10))
    fx = chip_smoke.g2p_prepare(tmp_path / "g2p", [f"p{i:02d}" for i in range(5)],
                                corpus_dir)
    assert len(fx["written"]) == 6 and abs(fx["audio_s"] - audio_s) < 1e-3
    assert len(list(fx["small_dir"].rglob("*.flac"))) == 3
    assert not list(fx["flac_dir"].rglob("*.wav"))
    assert fx["g2p_train_s"] > 0 and fx["g2p_path"].exists()
    report, checks = chip_smoke.g2p_align_phase(
        model_path, fx, tmp_path / "out", cpu, batch_size=6, warm_runs=1)
    small = chip_smoke.g2p_align_run(model_path, fx, fx["small_dir"], cpu)
    assert report["launches"] == report["expected_launches"] == none
    assert report["utterances"] == 6 and report["batches"] == 1
    assert report["flac_files"] == 6 and report["rule_variants"] > 0
    assert report["held_out_tokens_aligned_by_g2p"] == report["held_out_tokens"] > 0
    assert report["oov_tokens"] == 0
    assert 0.0 <= report["g2p_held_out_word_accuracy"] <= 1.0
    assert {"audio_load", "graph_compile", "fmllr_pass1"} <= set(
        report["phases_synced_s"])
    assert set(checks) == set(none)
    for c in checks.values():
        assert c["max_abs_err"] == 0.0
    assert checks["band_forward"]["plain_calls_timed"] == 1
    task = chip_smoke.CpuTask("g2p_align_run",
                              (model_path, fx, fx["small_dir"], "cpu"),
                              tmp_path / "g2p_cpu.pkl", threads=1)
    cmp = chip_smoke.g2p_card_vs_cpu(small, task.result())
    assert cmp["utterances"] == 3 and cmp["frame_agreement"] == 1.0
    plain = chip_smoke.flac_plain_check(
        fx, chip_smoke.flac_plain_decode(sorted(fx["written"])))
    assert plain == {"files": 6, "identical": True}
    line = chip_smoke.kernels_line(checks, report["launches"],
                                   {"g2p-align": report["launches"]},
                                   {"g2p_align": checks})
    for row in line["kernels"]:
        assert row["launches_by_path"] == {"g2p-align": 0}
        assert row["g2p_align_check"]["max_abs_err"] == 0.0
    train = chip_smoke.train_g2p_phase(tmp_path / "tone", cpu, n_utts=4)
    assert train["card_runs_identical"] and train["card_cpu_lexicon_identical"]
    assert 0.0 < train["g2p_share_of_stage"] <= 1.0


def test_distributed_phases_run_on_cpu(fixture, tmp_path):
    """The multi-GPU phases with the CPU for the card: one gloo rank for
    NCCL's (NCCL carries card tensors only), two spawned gloo ranks, the
    CLI under ``torch.distributed.run``, the dry run; then MFA and the
    parity harness; and the kernels line's multi-GPU launches by rank."""
    (_tmp, model_path, dict_path, corpus_dir, _audio_s, small_dir, *_) = fixture
    cpu = torch.device("cpu")
    zero = {"band_forward": 0, "band_backtrace": 0, "state_emission": 0}
    nccl = chip_smoke.nccl_one_rank_phase(model_path, dict_path, corpus_dir,
                                          tmp_path, cpu)
    assert nccl["sat-2pass"]["identical"] and nccl["sat-si"]["identical"]
    assert nccl["train-mono"]["bit_identical"]
    assert nccl["train-mono"]["launches"] == zero
    gloo = chip_smoke.gloo_two_ranks_phase(model_path, dict_path, corpus_dir, cpu)
    assert gloo["train-mono"]["two_runs_bit_identical"]
    assert gloo["sat-si"]["utterances"] == 6
    assert gloo["sat-2pass"]["frame_agreement"] >= 0.999
    assert [r["rank"] for r in gloo["ranks"]] == [0, 1]
    assert sum(r["train_utterances"] for r in gloo["ranks"]) == 6
    trun = chip_smoke.torchrun_align_phase(model_path, dict_path, corpus_dir,
                                           tmp_path / "torchrun", cpu)
    assert trun["files"] == 6 and trun["frame_agreement"] >= 0.999
    assert [r["launches"] for r in trun["ranks"]] == [zero, zero]
    dry = chip_smoke.dryrun_phase(cpu)
    assert [r["rank"] for r in dry["ranks"]] == [0, 1]
    mfa = chip_smoke.mfa_phase(model_path, dict_path, small_dir, cpu,
                               chip_smoke.mfa_run(model_path, dict_path, small_dir,
                                                  "cpu"))
    assert mfa["records"] == 4 and mfa["frame_agreement"] == 1.0
    harness = chip_smoke.parity_harness_phase(model_path, dict_path, corpus_dir, cpu)
    assert harness["utterances"] == 4 and harness["frames"] > 0
    assert 0.0 <= harness["frame_agreement"] <= 1.0
    checks = {n: {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 1.0, "bound_ms": 1.0,
                  "bound_by": "bytes", "library_ms": None} for n in zero}
    by_rank = {k: [0, 0] for k in zero}
    line = chip_smoke.kernels_line(checks, zero, {"dryrun": by_rank})
    for row in line["kernels"]:
        assert row["launches_by_path"] == {"dryrun": [0, 0]}


def test_transfer_pitch_and_chain_major_phases_run_on_cpu(fixture, tmp_path,
                                                          monkeypatch,
                                                          one_torch_thread):
    """transfer-features, pitch-paths and lvcsr-chain-major at a tiny size:
    features against waves and card (here the CPU) against the CPU, the
    pitch recipe's 40 x 112 LDA and its paths, each row's pitch and each
    utterance's alignment alike in a batch and alone, the production LVCSR routes
    against the chain-major and record-based decoders; the LVCSR threshold
    is lowered so the tiny vocabulary routes there."""
    import montreal_forced_aligner_tpu_torch.transcription.transcriber as PT

    _tmp, model_path, dict_path, corpus_dir, _audio_s, small_dir, *_ = fixture
    cpu = torch.device("cpu")
    words = [l.split()[0] for l in Path(dict_path).read_text().splitlines()]
    lm = chip_smoke.transcription_lms(words, n_words=8)[0]
    transfer = chip_smoke.transfer_features_phase(
        model_path, dict_path, corpus_dir, small_dir, small_dir, lm, tmp_path, cpu,
        batch_size=4)
    assert transfer["auto_resolves_to"] == "waves" and transfer["probe_MBps"] is None
    assert len(transfer["batches"]) == 2
    b = transfer["batches"][0]
    assert b["features_bytes"] == b["B"] * b["T"] * 13 * 2
    assert transfer["sat-2pass"]["against_waves"]["same_phone_sequences"] <= 6
    assert all(b["max_err_over_f16_bound"] <= 1.0 for b in transfer["batches"])
    assert transfer["sat-2pass"]["tone_mono_against_waves"]["utterances"] == 14
    assert transfer["sat-2pass"]["card_vs_cpu"]["frame_agreement"] == 1.0
    assert transfer["sat-2pass"]["launches"] == {
        "band_forward": 0, "band_backtrace": 0, "state_emission": 0}
    assert transfer["transcribe-dense"]["utterances"] == 3
    recipe = [("monophone", "mono", 2, 40, 0), ("triphone", "tri", 3, 64, 48),
              ("lda", "lda", 3, 64, 48), ("sat", "sat", 3, 64, 48)]
    pitch = chip_smoke.pitch_paths_phase(dict_path, tmp_path, cpu, recipe=recipe,
                                         batch_size=4, require_k3=False,
                                         corpus_size=(6, 2.0, 3.0))
    assert pitch["recipe"]["lda_mat"] == [40, 112]
    assert pitch["align"]["utterances"] == 6
    assert pitch["adapt"]["means_rel_err"] == {"final": 0.0,
                                               "speaker_independent": 0.0}
    assert pitch["adapt"]["transforms_max_abs_diff"] == 0.0
    assert pitch["adapt"]["pitch_cpu_max_abs_diff"] == 0.0
    assert pitch["fine_tune"]["card_vs_cpu_max_boundary_diff_s"] == 0.0
    assert pitch["fine_tune"]["moved_off_grid"] > 0
    assert pitch["long_path"]["utterances"] == 4
    for label in ("single_pass", "two_pass"):
        assert pitch["long_path"][label]["against_corpus_path"][
            "frame_agreement"] == 1.0
    inv = pitch["batch_invariance"]
    assert inv["pitch"]["utterances"] == 6 and inv["pitch"]["batch_size"] == 4
    assert inv["pitch"]["rows_with_equal_lag_paths"] == 6
    assert inv["pitch"]["features_max_abs_diff"] == 0.0
    for label in ("two_pass", "single_pass"):
        a = inv["align"][label]
        assert a["utterances"] == 8 and a["batch_size"] == 8
        assert a["intervals_differ"] == 0
    assert inv["align"]["single_pass"]["max_score_diff"] <= 0.01
    monkeypatch.setattr(PT.Transcriber, "LVCSR_WORD_THRESHOLD", 4)
    corpus_lm = chip_smoke.corpus_lm(model_path, dict_path, corpus_dir)
    chain = chip_smoke.lvcsr_chain_major_phase(model_path, dict_path, small_dir,
                                               corpus_lm, cpu)
    assert chain["utterances"] == 3 and chain["rows"] >= 1
    assert chain["cross_word"]["ckpt_vs_host_score_diff"] <= 1e-4
    assert chain["word_internal"]["position_major_vs_host_score_diff"] <= 1e-4


def test_speaker_stats_invariance_runs_on_cpu(fixture):
    """The speaker statistics line at a tiny size: the fMLLR totals of the
    first pass's inputs rebatched at 1, 2 and 6, the CMVN sums of the
    batch-1 MFCC rows rebatched, and each batching's MFCC, CMVN means, LDA,
    fMLLR-applied and all-pdf rows bit for bit alike (the phase checks it);
    on the CPU the transforms are alike too."""
    _tmp, model_path, dict_path, corpus_dir, *_ = fixture
    out = chip_smoke.speaker_stats_invariance(model_path, dict_path, corpus_dir,
                                              torch.device("cpu"),
                                              batch_sizes=(1, 2, 6))
    assert out["utterances"] == 6 and out["speakers"] == 2
    assert out["fmllr_totals_bit_identical"] and out["cmvn_sums_bit_identical"]
    assert out["feature_rows_bit_identical"]
    for key in ("transforms_max_abs_diff", "mfcc_rows_max_abs_diff",
                "cmvn_means_max_abs_diff", "lda_rows_max_abs_diff",
                "fmllr_rows_max_abs_diff", "all_pdf_loglike_rows_max_abs_diff"):
        assert out[key] == {"2": 0.0, "6": 0.0}, key
    assert sorted(out["fmllr_stats_synced_s"]) == ["1", "2", "6"]
    assert sorted(out["feature_rows_synced_s"]) == ["1", "2", "6"]


# a Whisper at a tiny width, in large-v3's vocabulary layout cut down
TINY_WHISPER = {
    "vocab_size": 459, "num_mel_bins": 128, "d_model": 64, "encoder_layers": 2,
    "encoder_attention_heads": 4, "encoder_ffn_dim": 128, "decoder_layers": 2,
    "decoder_attention_heads": 4, "decoder_ffn_dim": 128,
    "max_source_positions": 1500, "max_target_positions": 40,
}
TINY_WHISPER_TEXT = {"n_base": 300, "n_languages": 100, "n_timestamps": 51}


NO_LAUNCHES = {"band_forward": 0, "band_backtrace": 0, "state_emission": 0}


@pytest.fixture(scope="module")
def whisper_run(fixture, tmp_path_factory):
    """The whisper phase (and the whisper-settings phase inside it) at a
    tiny width with the CPU in the card's place, in a process of its own
    without CUBLAS_WORKSPACE_CONFIG, which spawns the CPU reference in
    turn, as chip_smoke.main runs it."""
    _tmp, _model, _dict, _corpus, _audio_s, small_dir, *_ = fixture
    tmp = tmp_path_factory.mktemp("whisper_phase")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        w = chip_smoke.CpuTask("whisper_phase", (tmp, small_dir, torch.device("cpu"),
                                                 TINY_WHISPER, TINY_WHISPER_TEXT),
                               tmp / "whisper.pkl", threads=1, daemon=False,
                               drop_env=("CUBLAS_WORKSPACE_CONFIG",)).result()
        assert chip_smoke.os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    return w


def test_neural_phases_run_on_cpu(fixture, whisper_run, tmp_path, one_torch_thread):
    """The whisper phase at a tiny width and the speechbrain-paths phase,
    with the CPU in the card's place: no launches, every file transcribed,
    the CPU reference (a worker) equal to the run, the same texts,
    segments and labels on both runs."""
    _tmp, _model, _dict, _corpus, _audio_s, small_dir, *_ = fixture
    cpu = torch.device("cpu")
    none = NO_LAUNCHES
    w = whisper_run
    assert w["launches"] == none and w["utterances"] == 3
    assert w["parameters"] > 0 and w["tokens"] >= 3 and w["windows"] == 3
    assert w["decoder_ms_per_token"] > 0 and w["encoder_ms_per_utterance"] > 0
    assert len(w["card_vs_cpu"]) == chip_smoke.WHISPER_COMPARE_UTTS
    for row in w["card_vs_cpu"]:
        # the worker runs 4 threads, which may split the products otherwise
        assert row["mel_max_abs_err"] <= 1e-6 and row["encoder_max_abs_err"] <= 1e-5
        assert row["steps_equal"] + (row["stopped_at_near_tie"] is not None) >= 1
        assert row["logits_max_abs_err"] <= 1e-5
    spk_dir, _ = chip_smoke.build_speaker_corpus(tmp_path, num_speakers=2,
                                                 per_speaker=3, min_s=2.0, max_s=3.0)
    vad_dir, _pauses, _vad_s = chip_smoke.build_vad_set(tmp_path, num_files=2,
                                                        seconds=12.0)
    sb = chip_smoke.speechbrain_paths_phase(tmp_path, small_dir, vad_dir, spk_dir,
                                            2, cpu)
    assert sb["card_equals_cpu"] and sb["files_transcribed"] == 3
    assert sb["segment_files"] == 2 and sb["segments"] >= 2
    assert sb["utterances_diarized"] == 6
    assert all(v == {"parameters": ["cpu"], "input": "cpu"} for v in sb["on_card"].values())


def test_whisper_settings_phase_runs_on_cpu(whisper_run):
    """The whisper-settings phase at a tiny width with the CPU in the
    card's place: the second generation config read, no launches, both
    utterances transcribed, the CPU reference (a worker) equal to the run
    over every compared beam step, and the chosen hypothesis equal."""
    w = whisper_run["settings"]
    assert w["path"] == "whisper-settings" and w["launches"] == NO_LAUNCHES
    assert w["settings"] == chip_smoke.WHISPER_SETTINGS
    assert w["utterances"] == chip_smoke.WHISPER_COMPARE_UTTS
    assert w["beam_steps"] >= w["windows"] >= w["utterances"]
    assert w["decoder_ms_per_step_4_beams"] > 0 and w["phase_s"] > 0
    assert w["gpu"] == "not measured (CPU)"
    assert len(w["card_vs_cpu"]) == chip_smoke.WHISPER_COMPARE_UTTS
    for row in w["card_vs_cpu"]:
        assert not row["language_close"]
        # the worker runs other threads, which may split the products otherwise
        assert row["log_probs_max_abs_err"] <= 1e-5
        assert row["beam_steps_equal"] + (row["stopped_at_near_tie"] is not None) >= 1
        assert row["stopped_at_near_tie"] is not None or row["chosen_equal"]


def test_smoke_beam_agreement():
    """The card-against-CPU rule for beams: log-probabilities within the
    bar and the running beams equal up to the CPU's first near-tie; a
    disagreement before it fails."""
    inf = -np.inf
    scores = np.array([[[0.0, -1.0, inf], [-0.5, -2.0, inf]]] * 3)
    cpu = {"scores": scores, "tokens": [[0, 0], [1, 0], [0, 1]],
           "sources": [[0, 0], [1, 0], [0, 0]], "margins": [0.5, 1e-5, 0.5]}
    card = {**cpu, "scores": scores + 2e-4 * (scores > -1.5)}
    assert chip_smoke.beam_agreement(cpu, card, 1e-3) == (1, 1, pytest.approx(2e-4))
    with pytest.raises(RuntimeError, match="beam step 0"):
        chip_smoke.beam_agreement(cpu, {**card, "tokens": [[1, 0]] * 3}, 1e-3)
    with pytest.raises(RuntimeError, match="suppressed"):
        chip_smoke.beam_agreement(cpu, {**card, "scores": scores[:, :, ::-1]}, 1e-3)
    # other suppressions at the near-tie step (a timestamp rule decided
    # within the bar) stop the comparison there
    flipped = card["scores"].copy()
    flipped[1] = flipped[1, :, ::-1]
    assert chip_smoke.beam_agreement(cpu, {**card, "scores": flipped}, 1e-3) == (
        1, 1, pytest.approx(2e-4))


def test_smoke_vocabulary_layout():
    """The synthetic vocabulary puts large-v3's special tokens at their
    published ids."""
    vocab, added, ids, lang_to_id = chip_smoke.whisper_text_layout(
        **chip_smoke.WHISPER_TURBO_TEXT)
    assert len(vocab) + len(added) == chip_smoke.WHISPER_TURBO["vocab_size"] == 51866
    assert (ids["endoftext"], ids["startoftranscript"], ids["en"]) == (50257, 50258, 50259)
    assert (ids["translate"], ids["transcribe"], ids["startofprev"],
            ids["nospeech"], ids["notimestamps"]) == (50359, 50360, 50362, 50363, 50364)
    assert added[-1] == (51865, "<|30.00|>", False)
    assert len(lang_to_id) == 100 and lang_to_id["<|yue|>"] == 50358
    assert sorted(vocab.values()) == list(range(50257))


def test_smoke_greedy_agreement():
    """The card-against-CPU rule: arg-max equal up to the CPU's first
    near-tie; a disagreement before it fails."""
    inf = -np.inf
    cpu = np.array([[0.0, 1.0, inf], [2.0, 1.9995, inf], [0.0, 1.0, inf]])
    card = np.array([[0.0, 1.0002, inf], [1.9990, 2.0, inf], [1.0, 0.0, inf]])
    assert chip_smoke.greedy_agreement(cpu, card, 1e-3) == (1, 1, pytest.approx(2e-4))
    with pytest.raises(RuntimeError, match="step 0"):
        chip_smoke.greedy_agreement(cpu[2:], card[2:], 1e-3)
    with pytest.raises(RuntimeError, match="suppressed"):
        chip_smoke.greedy_agreement(cpu, card[:, ::-1].copy(), 1e-3)
