"""The port's Whisper ``generate`` under the generation config's settings,
against the JAX package's ``transformers`` wrapper on the CPU.

Checkpoints: ``tests/test_torch_whisper.py``'s 2+2-layer one with 100
timestamp tokens and an end of text that often wins (``stamps``), the same
without them (``detect``), and ``tests/helpers.py``'s 1+1-layer one whose
generation config is made from the model config (``tiny``). Each setting
of ``return_timestamps``, ``max_initial_timestamp_index``,
``condition_on_prev_tokens``, ``force_unique_generate_call``,
``num_beams`` (with ``length_penalty`` and ``early_stopping``),
``repetition_penalty``, ``no_repeat_ngram_size``, ``min_new_tokens`` and
``min_length`` is written into a copy of a checkpoint's
``generation_config.json``, alone and then together: the ids and the text
equal the JAX package's on waves made from a seed, each step's processed
scores (greedy) or log-probabilities (beam search) and the best beam's
score within 1e-4, the running beams equal. A key the port does not
implement raises ``NotImplementedError`` naming it; keys that change no
token decode as the config without them. Every test runs on one torch
thread.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from montreal_forced_aligner_tpu.transcription.torch_models import (
    WhisperTranscriber as JWhisper,
)
from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
    WhisperTranscriber as PWhisper,
)
from montreal_forced_aligner_tpu_torch.transcription.whisper import checkpoint as PC
from montreal_forced_aligner_tpu_torch.transcription.whisper import generate as PG

from helpers import build_tiny_whisper_checkpoint
from test_torch_whisper import _jax_features, build_detecting_checkpoint, waves

SCORE_ATOL = 1e-4

# each setting alone, on ``stamps``
SETTINGS = {
    "return_timestamps": {"return_timestamps": True},
    "max_initial_timestamp_index": {"return_timestamps": True,
                                    "max_initial_timestamp_index": 2},
    "condition_on_prev_tokens": {"condition_on_prev_tokens": True},
    "force_unique_generate_call": {"force_unique_generate_call": True},
    "num_beams": {"num_beams": 3},
    "length_penalty": {"num_beams": 4, "length_penalty": 0.3,
                       "early_stopping": True},
    "early_stopping_never": {"num_beams": 2, "length_penalty": 2.0,
                             "early_stopping": "never"},
    "repetition_penalty": {"repetition_penalty": 1.5},
    "no_repeat_ngram_size": {"no_repeat_ngram_size": 2},
    "min_new_tokens": {"min_new_tokens": 6},
    "min_length": {"min_length": 12},
}
TOGETHER = {"return_timestamps": True, "condition_on_prev_tokens": True,
            "num_beams": 3, "no_repeat_ngram_size": 3, "repetition_penalty": 1.2,
            "min_new_tokens": 2, "length_penalty": 0.8}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def variant(tmp_path_factory):
    """``variant(name, extra)``: a copy of checkpoint ``name`` whose
    generation config has ``extra``'s keys set (a None value deletes)."""
    tmp = tmp_path_factory.mktemp("whisper_gen")
    bases = {
        "stamps": build_detecting_checkpoint(tmp, timestamps=100, eos_like=1.3,
                                             name="stamps_whisper"),
        "detect": build_detecting_checkpoint(tmp),
        "tiny": build_tiny_whisper_checkpoint(tmp),
    }
    # <|0.00|> suppressed: a window that ends with a pair of them seeks
    # nowhere, and without conditioning the reference decodes it again
    # without end
    path = bases["stamps"] / "generation_config.json"
    data = json.loads(path.read_text())
    data["suppress_tokens"].append(data["no_timestamps_token_id"] + 1)
    path.write_text(json.dumps(data))
    made = {}

    def get(name, extra=None):
        key = (name, json.dumps(extra or {}, sort_keys=True))
        if not extra:
            return bases[name]
        if key not in made:
            out = tmp / f"{name}_{len(made)}"
            shutil.copytree(bases[name], out)
            path = out / "generation_config.json"
            data = json.loads(path.read_text())
            for k, v in extra.items():
                if v is None:
                    data.pop(k, None)
                else:
                    data[k] = v
            path.write_text(json.dumps(data))
            made[key] = out
        return made[key]

    return get


def _pair(path, language=None):
    return JWhisper(path, language=language), PWhisper(path, language=language,
                                                       device="cpu")


def _jax_ids(j, wave, **kw):
    if j.language:
        kw["language"] = j.language
    with torch.no_grad():
        return j.model.generate(_jax_features(j, wave), **kw)


def _assert_decodes_alike(j, p, wave):
    want = _jax_ids(j, wave)[0].tolist()
    d = p.decode(wave)
    assert d.ids == want
    assert p.tokenizer.decode(d.ids).strip() == j.transcribe(wave)
    return d


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_setting_alone_matches_jax(variant, setting):
    """Each setting alone: the ids and text of the JAX package's
    transcriber, and (so the case tests something) ids other than the
    config's without it on at least one wave."""
    j, p = _pair(variant("stamps", SETTINGS[setting]))
    plain = PWhisper(variant("stamps"), device="cpu")
    changed = False
    for wave in waves(3)[:2]:
        d = _assert_decodes_alike(j, p, wave)
        changed = changed or d.ids != plain.decode(wave).ids
    assert changed, setting


@pytest.mark.parametrize("language", [None, "german"])
def test_settings_together_match_jax(variant, language):
    j, p = _pair(variant("stamps", TOGETHER), language)
    for wave in waves(4)[:2]:
        d = _assert_decodes_alike(j, p, wave)
        assert d.windows >= 1
    if language == "german":
        assert d.prompt[1] == p.generation.lang_to_id["<|de|>"]
    # timestamps: the prompt has no <|notimestamps|>
    assert p.generation.no_timestamps_token_id not in d.prompt


@pytest.mark.parametrize("name,extra,language", [
    ("detect", {"num_beams": 3, "repetition_penalty": 1.3}, "german"),
    ("detect", {"no_repeat_ngram_size": 1, "force_unique_generate_call": True}, None),
    # made from the model config: the Whisper keys are dropped, the
    # standard ones kept, on both sides
    ("tiny", {"num_beams": 2, "return_timestamps": True,
              "condition_on_prev_tokens": True}, "english"),
])
def test_test_whisper_checkpoints_match_jax(variant, name, extra, language):
    j, p = _pair(variant(name, extra), language)
    for wave in waves(5):
        _assert_decodes_alike(j, p, wave)
    if name == "tiny":
        assert p.generation.num_beams == 2
        assert p.generation.return_timestamps is None
        assert not hasattr(j.model.generation_config, "return_timestamps")


class _Recorder:
    """A logits processor ``generate`` runs last: every step's rows and
    processed scores."""

    def __init__(self):
        self.calls = []

    def __call__(self, input_ids, scores):
        self.calls.append((input_ids.clone(), scores.clone()))
        return scores


@pytest.mark.parametrize("setting", ["num_beams", "length_penalty", "together",
                                     "return_timestamps", "repetition_penalty"])
def test_step_and_beam_scores_match(variant, setting):
    """Each step's processed scores (greedy) or log-probabilities (beam
    search, every beam) within 1e-4 with the same suppressed entries, the
    running beams the rows ``transformers`` extends, and the best
    hypothesis's score within 1e-4."""
    from transformers import LogitsProcessorList

    extra = TOGETHER if setting == "together" else SETTINGS[setting]
    j, p = _pair(variant("stamps", extra))
    beams = extra.get("num_beams", 1)
    for wave in waves(6)[:2]:
        rec = _Recorder()
        out = _jax_ids(j, wave, logits_processor=LogitsProcessorList([rec]),
                       return_dict_in_generate=True, output_scores=True)
        steps = min(len(rec.calls), 40)
        d = p.decode(wave, keep_scores=steps)
        assert len(d.scores) == steps
        for s in range(steps):
            ids, want = rec.calls[s]
            got = d.scores[s].reshape(want.shape)
            finite = torch.isfinite(want)
            assert torch.equal(finite, torch.isfinite(got)), s
            assert (got[finite] - want[finite]).abs().max() <= SCORE_ATOL, s
            if beams > 1 and s > 0 and ids.shape[1] == rec.calls[s - 1][0].shape[1] + 1:
                assert ids[:, -1].tolist() == d.beam_tokens[s - 1], s
        if beams > 1 and not extra.get("return_timestamps"):
            want_score = float(out["sequences_scores"][0])
            assert abs(d.beam_scores[-1] - want_score) <= SCORE_ATOL


@pytest.mark.parametrize("name,setting", [
    ("stamps", "num_beams"), ("stamps", "length_penalty"),
    ("stamps", "early_stopping_never"), ("detect", "num_beams")])
def test_beam_and_detection_keep_the_growing_cache(variant, monkeypatch, name, setting):
    """Beam search and language detection keep their own eager path over
    the growing cache: with greedy decoding's static step out of reach
    they decode the JAX package's ids, detect its language, and each
    step's log-probabilities (every beam) lie within 1e-4 of its own."""
    from transformers import LogitsProcessorList

    def unreachable(*a, **kw):
        raise AssertionError("greedy decoding's static step reached")

    monkeypatch.setattr(PG, "greedy_step", unreachable)
    j, p = _pair(variant(name, SETTINGS[setting]))
    for wave in waves(6)[:2]:
        d = _assert_decodes_alike(j, p, wave)
        want_lang = int(j.model.detect_language(_jax_features(j, wave))[0])
        assert d.prompt[1] == want_lang
        rec = _Recorder()
        _jax_ids(j, wave, logits_processor=LogitsProcessorList([rec]))
        steps = min(len(rec.calls), 40)
        d = p.decode(wave, keep_scores=steps)
        for s in range(steps):
            want = rec.calls[s][1]
            got = d.scores[s].reshape(want.shape)
            finite = torch.isfinite(want)
            assert torch.equal(finite, torch.isfinite(got)), s
            assert (got[finite] - want[finite]).abs().max() <= SCORE_ATOL, s


def test_sampling_in_an_older_file_decodes_greedily(variant):
    """``do_sample`` comes back into ``generate``'s config only from files
    of transformers 4.50 on; an older file decodes greedily, on both
    sides."""
    j, p = _pair(variant("stamps", {"do_sample": True, "top_k": 3,
                                    "transformers_version": "4.40.0"}))
    for wave in waves(7)[:2]:
        _assert_decodes_alike(j, p, wave)


def test_inert_keys_decode_as_without_them(variant):
    inert = {"temperature": 0.7, "top_k": 5, "top_p": 0.9, "output_scores": True,
             "compression_ratio_threshold": 1.8, "use_cache": True,
             "alignment_heads": [[1, 0]], "num_assistant_tokens": 7,
             "_detect_timestamp_from_logprob": True}
    j, p = _pair(variant("stamps", inert))
    plain = PWhisper(variant("stamps"), device="cpu")
    for wave in waves(8)[:2]:
        d = _assert_decodes_alike(j, p, wave)
        assert d.ids == plain.decode(wave).ids


REFUSED = [("num_beam_groups", 2), ("diversity_penalty", 0.5),
           ("sequence_bias", [[[3], 1.0]]), ("bad_words_ids", [[3]]),
           ("force_words_ids", [[3]]), ("logprob_threshold", -1.0),
           ("no_speech_threshold", 0.6), ("do_sample", True),
           ("penalty_alpha", 0.6), ("encoder_repetition_penalty", 1.2),
           ("forced_eos_token_id", 5), ("guidance_scale", 1.5),
           ("prompt_lookup_num_tokens", 3), ("max_time", 1.0),
           ("num_return_sequences", 2), ("return_dict_in_generate", True),
           ("renormalize_logits", True), ("an_unknown_key", 1),
           ("an_unknown_flag", False), ("_detect_timestamp_from_logprob", False)]


@pytest.mark.parametrize("key,value", REFUSED)
def test_unimplemented_key_raises(variant, key, value):
    with pytest.raises(NotImplementedError, match=key):
        PWhisper(variant("stamps", {key: value}), device="cpu")


def test_logprob_threshold_raises_in_transformers(variant):
    """The refusal follows the reference: at one temperature
    ``transformers`` 4.57.6 cannot run a log-probability threshold."""
    j = JWhisper(variant("stamps", {"logprob_threshold": -1.0}))
    with pytest.raises((IndexError, TypeError)):
        _jax_ids(j, waves(3)[0])


def test_generation_keys_follow_transformers():
    """The port's table of ``GenerationConfig``'s keys is this
    ``transformers``' own, defaults included, and every key of it is read:
    held by the settings, known to change no token, or refused."""
    from transformers import GenerationConfig

    want = {k: v for k, v in GenerationConfig().to_dict().items()
            if k not in PC._METADATA_KEYS}
    assert PC.GENERATION_DEFAULTS == want
    held = set(PC._STANDARD_KEYS) | set(PC._WHISPER_KEYS)
    inert = PC._INERT_KEYS | PC._WHISPER_INERT_KEYS
    for key, default in want.items():
        value = 7 if default is None else (not default if isinstance(default, bool)
                                           else "x")
        if key in held or key in inert:
            continue
        with pytest.raises(NotImplementedError, match=key):
            PC.GenerationSettings.from_dict({key: value}, False)


def test_previous_tokens_follow_pad_to_max_length():
    from transformers.models.whisper.generation_whisper import _pad_to_max_length

    tb = 50
    rng = np.random.RandomState(2)
    for _ in range(60):
        segments = [list(rng.choice([1, 2, 51, 60, 75], rng.randint(0, 9)))
                    for _ in range(rng.randint(1, 4))]
        cut = int(rng.choice([3, 8, 23]))
        want = _pad_to_max_length(
            [[{"tokens": torch.tensor(s, dtype=torch.long)} for s in segments]],
            0, device="cpu", padding_side="left",
            bos_token_tensor=torch.tensor([99]), cut_off_length=cut,
            skip_ending_double_timestamps=True, timestamp_begin=tb)
        got = PG.previous_tokens([[int(t) for t in s] for s in segments], tb, cut, 99)
        assert got == want[0].tolist(), segments


def test_processors_follow_transformers():
    """The port's processors against ``transformers``' own, in the order
    ``generate`` merges them, on random scores and sequences (with
    timestamps, at a window's first step and later)."""
    from transformers.generation.logits_process import (
        MinLengthLogitsProcessor,
        MinNewTokensLengthLogitsProcessor,
        NoRepeatNGramLogitsProcessor,
        RepetitionPenaltyLogitsProcessor,
        SuppressTokensAtBeginLogitsProcessor,
        SuppressTokensLogitsProcessor,
        WhisperTimeStampLogitsProcessor,
    )
    from transformers import GenerationConfig

    vocab, eos, no_ts = 90, 30, 39
    tb = no_ts + 1
    gen = PC.GenerationSettings(
        eos_token_id=eos, bos_token_id=eos, suppress_tokens=[3, 7, 33],
        begin_suppress_tokens=[1, eos], repetition_penalty=1.7,
        no_repeat_ngram_size=2, min_new_tokens=3, min_length=2,
        return_timestamps=True, no_timestamps_token_id=no_ts,
        max_initial_timestamp_index=5)
    config = GenerationConfig(eos_token_id=eos, bos_token_id=eos,
                              no_timestamps_token_id=no_ts,
                              max_initial_timestamp_index=5)
    rng = np.random.RandomState(3)
    procs = PG.LogitsProcessors(gen, vocab, tb, "cpu")
    for begin in (3, 5):
        reference = [RepetitionPenaltyLogitsProcessor(1.7), NoRepeatNGramLogitsProcessor(2),
                     MinLengthLogitsProcessor(3 + begin, eos),
                     MinNewTokensLengthLogitsProcessor(begin, 3, eos),
                     SuppressTokensLogitsProcessor([3, 7, 33]),
                     SuppressTokensAtBeginLogitsProcessor([1, eos], begin),
                     WhisperTimeStampLogitsProcessor(config, begin)]
        for length in range(begin, begin + 8):
            for _ in range(8):
                seqs = rng.choice(np.r_[np.arange(20), np.arange(tb, vocab)],
                                  (3, length)).tolist()
                scores = torch.from_numpy(rng.randn(3, vocab).astype(np.float32) * 3)
                want = scores.clone()
                ids = torch.tensor(seqs)
                for proc in reference:
                    want = proc(ids, want)
                got = procs(seqs, scores.clone(), begin)
                assert torch.equal(got, want), (begin, seqs)
