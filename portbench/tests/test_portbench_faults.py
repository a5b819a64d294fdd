"""The check catches a broken timed path: a tiny run on the CPU with a
fault planted in the program under the harness, once for each fault a
cell can have, comes out not correct. (One chip: no exchange between
chips to leave out.)"""

import pytest
import torch

from portbench import harness

import tiny


def _run(cell, tmp, seed=4242):
    return harness.run_cell(tiny.context(cell, tmp, seed=seed))


def test_align_sound_run_is_correct(bench_tmp):
    assert _run("align-sat-librispeech", bench_tmp)["correct"]


def test_align_fmllr_apply_returns_features_unchanged(bench_tmp, monkeypatch):
    import montreal_forced_aligner_tpu_torch.align.aligner as aligner

    monkeypatch.setattr(aligner, "apply_per_speaker_transform", lambda ff, spk, t: ff)
    r = _run("align-sat-librispeech", bench_tmp)
    assert not r["correct"]
    assert r["compared"]["score_error_per_frame"]["value"] > \
        r["compared"]["score_error_per_frame"]["limit"]


def test_align_fmllr_transform_left_at_identity(bench_tmp, monkeypatch):
    """Every speaker's fMLLR estimate returned as the identity."""
    import numpy as np

    import montreal_forced_aligner_tpu_torch.align.aligner as aligner

    def identity(K, G, beta, **kw):
        S, D = K.shape[0], K.shape[1]
        return np.tile(np.hstack([np.eye(D), np.zeros((D, 1))]), (S, 1, 1)).astype(np.float32)

    monkeypatch.setattr(aligner, "estimate_speaker_fmllr", identity)
    r = _run("align-sat-librispeech", bench_tmp)
    assert not r["correct"]
    assert r["compared"]["fmllr_objective_gap"]["value"] > \
        r["compared"]["fmllr_objective_gap"]["limit"]


def test_align_fmllr_stats_over_half_the_frames(bench_tmp, monkeypatch):
    """The speaker-independent pass's fMLLR statistics taken over every
    other frame of each utterance."""
    import montreal_forced_aligner_tpu_torch.align.aligner as aligner

    real = aligner.accumulate_fmllr_stats

    def half(feats, lengths, frame_pdf, speakers, weight, *a, **kw):
        weight = weight.clone()
        weight[:, 1::2] = 0
        return real(feats, lengths, frame_pdf, speakers, weight, *a, **kw)

    monkeypatch.setattr(aligner, "accumulate_fmllr_stats", half)
    r = _run("align-sat-librispeech", bench_tmp)
    assert not r["correct"]
    assert r["compared"]["fmllr_stats_error"]["value"] > \
        r["compared"]["fmllr_stats_error"]["limit"]


def test_align_cmvn_over_half_the_batch(bench_tmp, monkeypatch):
    """Each speaker's CMVN mean taken over half of each batch's rows."""
    import montreal_forced_aligner_tpu_torch.align.aligner as aligner

    real = aligner.add_to_speakers

    def half(total, sums, spk):
        sums = sums.clone()
        sums[1::2] = 0
        sums[0::2] *= 2
        return real(total, sums, spk)

    monkeypatch.setattr(aligner, "add_to_speakers", half)
    r = _run("align-sat-librispeech", bench_tmp)
    assert not r["correct"]
    assert r["compared"]["score_error_per_frame"]["value"] > \
        r["compared"]["score_error_per_frame"]["limit"]


def test_align_half_the_batch_left_out(bench_tmp, monkeypatch):
    """Every other utterance's alignment left out of the results."""
    import montreal_forced_aligner_tpu_torch.align.aligner as aligner

    real = aligner.PretrainedAligner.align_corpus

    def half(self, corpus):
        return {k: v for k, v in real(self, corpus).items() if k % 2 == 0}

    monkeypatch.setattr(aligner.PretrainedAligner, "align_corpus", half)
    r = _run("align-sat-librispeech", bench_tmp)
    assert not r["correct"] and r["failed"] > 0


def test_align_answer_altered(bench_tmp, monkeypatch):
    """A word's label changed where the intervals are made."""
    import montreal_forced_aligner_tpu_torch.align.aligner as aligner

    real = aligner.frames_to_alignment

    def altered(*a, **kw):
        out = real(*a, **kw)
        out.words[0].label = "w00059"
        return out

    monkeypatch.setattr(aligner, "frames_to_alignment", altered)
    r = _run("align-sat-librispeech", bench_tmp)
    assert not r["correct"] and r["compared"]["words_wrong"]["value"] > 0


def test_align_boundary_moved(bench_tmp, monkeypatch):
    """A phone boundary moved by two frames where the intervals are made."""
    import montreal_forced_aligner_tpu_torch.align.aligner as aligner

    real = aligner.frames_to_alignment

    def moved(utt, graph_words, phones, words, instances, *a, **kw):
        inst = instances.copy()
        cut = int((inst != inst[0]).argmax())
        inst[cut:cut + 2] = inst[0]
        phones, words = phones.copy(), words.copy()
        phones[cut:cut + 2], words[cut:cut + 2] = phones[0], words[0]
        return real(utt, graph_words, phones, words, inst, *a, **kw)

    monkeypatch.setattr(aligner, "frames_to_alignment", moved)
    r = _run("align-sat-librispeech", bench_tmp)
    assert not r["correct"]
    assert r["compared"]["score_gap_per_frame"]["value"] > \
        r["compared"]["score_gap_per_frame"]["limit"]


def test_whisper_sound_run_is_correct(bench_tmp):
    assert _run("whisper-turbo-greedy", bench_tmp)["correct"]


def test_whisper_cache_returned_unchanged(bench_tmp, monkeypatch):
    """The decoder step returns the key/value cache it was given."""
    from montreal_forced_aligner_tpu_torch.transcription.whisper import generate

    real = generate._decoder_step

    def stale(model, ids, cross, past=None):
        logits, new = real(model, ids, cross, past)
        return logits, (new if past is None else past)

    monkeypatch.setattr(generate, "_decoder_step", stale)
    r = _run("whisper-turbo-greedy", bench_tmp)
    assert not r["correct"]
    assert r["compared"]["token_gap"]["value"] > r["compared"]["token_gap"]["limit"]


def test_whisper_token_altered(bench_tmp, monkeypatch):
    """A served token changed where the greedy loop produces it."""
    from montreal_forced_aligner_tpu_torch.transcription.whisper import generate

    real = generate._greedy_window

    def altered(*a, **kw):
        tokens = real(*a, **kw)
        tokens[3] = (tokens[3] + 1) % 2000
        return tokens

    monkeypatch.setattr(generate, "_greedy_window", altered)
    r = _run("whisper-turbo-greedy", bench_tmp)
    assert not r["correct"]
    assert r["compared"]["token_gap"]["value"] > r["compared"]["token_gap"]["limit"]


def test_whisper_encoder_over_half_the_frames(bench_tmp, monkeypatch):
    """The encoder fed half of its window's frames, the rest zero."""
    from montreal_forced_aligner_tpu_torch.transcription.whisper.model import Whisper

    real = Whisper.encode

    def half(self, features):
        features = features.clone()
        features[..., features.shape[-1] // 2:] = 0
        return real(self, features)

    monkeypatch.setattr(Whisper, "encode", half)
    r = _run("whisper-turbo-greedy", bench_tmp)
    assert not r["correct"]
    assert r["compared"]["encoder_error"]["value"] > r["compared"]["encoder_error"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["align-sat-librispeech", "whisper-turbo-greedy"])
def test_control_is_not_correct(cell, bench_tmp):
    """The control (the reference in TF32 in the program's place) fails a
    compared number, at a small size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    ctx = tiny.context(cell, bench_tmp, seed=31337)
    ctx.device = torch.device("cuda")
    ctx.config = harness.load_json(harness.BENCH_DIR / "configs" / f"{ctx.workload['config']}.json")
    r = harness.run_cell(ctx, control=True)
    assert r["correct"]
    assert any(r["control"][k] > c["limit"] for k, c in r["compared"].items())
