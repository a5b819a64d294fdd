"""Whisper's ``generate`` for one utterance, under the checkpoint's
generation config.

Counterpart of ``WhisperForConditionalGeneration.generate(input_features,
language=...)`` (``transformers`` 4.57.6 ``models/whisper/
generation_whisper.py`` and ``generation/utils.py``), which the JAX
package's transcriber calls with no other argument:

- the prompt (``_retrieve_init_tokens``): ``decoder_start_token_id``, then
  ``forced_decoder_ids`` when neither a language nor a task is set, the
  language (given, or detected from one decoder step over ``lang_to_id``:
  ``detect_language``), the task (transcribe by default once a language
  is given) and ``no_timestamps_token_id`` unless ``return_timestamps``;
- the logits processors in ``generate``'s order: ``repetition_penalty``,
  ``no_repeat_ngram_size``, ``min_length``/``min_new_tokens``,
  ``suppress_tokens``, ``begin_suppress_tokens`` on a window's first step,
  and with ``return_timestamps`` the timestamp rules
  (``WhisperTimeStampLogitsProcessor``: pairs, no going back,
  ``max_initial_timestamp_index``, and a timestamp whenever their summed
  probability beats every text token's);
- greedy decoding, or beam search (``num_beams`` > 1: ``_beam_search``
  with ``length_penalty`` and ``early_stopping``, the beams a batch of
  rows through the decoder, the encoder's cross keys and values computed
  once and shared, the self-attention cache reordered by beam each step,
  the best finished hypothesis returned);
- a stop at ``eos_token_id`` or at the length ``generate`` sets
  (``max_new_tokens`` after the prompt, else ``max_length`` in all, 20
  after the prompt when left at its default);
- windows: where the decoder ends a window with two timestamp tokens in a
  row the window ends at the last such pair and decoding seeks on from its
  time (``_retrieve_segment``); with ``condition_on_prev_tokens`` the next
  window's prompt is ``prev_sot_token_id`` and the kept tokens before it,
  cut as ``_prepare_decoder_input_ids`` cuts them; ``force_unique_generate_
  call`` decodes one window and returns its whole sequence, prompt and end
  of text included;
- the returned ids are the windows' kept tokens, without the prompt and
  the final end of text.

There is one temperature (``generate``'s own argument, not the config's),
so nothing falls back to another; what the config sets that the port does
not decode as ``transformers`` does is refused when it is read
(:meth:`.checkpoint.GenerationSettings.from_dict`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from montreal_forced_aligner_tpu_torch import tracing
from montreal_forced_aligner_tpu_torch.transcription.whisper.checkpoint import (
    DEFAULT_MAX_LENGTH,
    GenerationSettings,
)

# Whisper's languages by code (``tokenization_whisper.LANGUAGES``)
LANGUAGES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese", "yue": "cantonese",
}
TO_LANGUAGE_CODE = {
    **{name: code for code, name in LANGUAGES.items()},
    "burmese": "my", "valencian": "ca", "flemish": "nl", "haitian": "ht",
    "letzeburgesch": "lb", "pushto": "ps", "panjabi": "pa", "moldavian": "ro",
    "moldovan": "ro", "sinhalese": "si", "castilian": "es", "mandarin": "zh",
}
TASKS = ("translate", "transcribe")


@dataclass
class Decoded:
    """One utterance's decode: ``ids`` is what ``generate`` returns.
    ``scores`` holds the processed scores of the decode's first
    ``keep_scores`` steps (greedy: the (vocab,) scores; beam search: the
    (num_beams, vocab) log-probabilities), ``language_scores`` the
    detection step's (on the host), when asked for. Beam search also keeps,
    for those steps, each running beam's new token and the beam it grew
    from (``beam_tokens``, ``beam_sources``), the smallest gap between the
    best candidates that chose them or between the two sides of the
    timestamp-versus-text rule (``beam_margins``), and each window's best
    finished score (``beam_scores``)."""

    ids: List[int]
    prompt: List[int]
    steps: int = 0
    windows: int = 0
    scores: List[torch.Tensor] = field(default_factory=list)
    language_scores: Optional[torch.Tensor] = None
    beam_tokens: List[List[int]] = field(default_factory=list)
    beam_sources: List[List[int]] = field(default_factory=list)
    beam_margins: List[float] = field(default_factory=list)
    beam_scores: List[float] = field(default_factory=list)


def language_token_id(language: str, gen: GenerationSettings) -> int:
    """``<|xx|>``'s id for a language token, name or code."""
    language = language.lower()
    if language in gen.lang_to_id:
        token = language
    elif language in TO_LANGUAGE_CODE:
        token = f"<|{TO_LANGUAGE_CODE[language]}|>"
    elif language in TO_LANGUAGE_CODE.values():
        token = f"<|{language}|>"
    else:
        raise ValueError(f"Unsupported language: {language}")
    if token not in gen.lang_to_id:
        raise ValueError(f"{token} is not supported by this model: it is not "
                         "in the generation config's lang_to_id")
    return gen.lang_to_id[token]


def _check_language(gen: GenerationSettings, language, task) -> None:
    if gen.is_multilingual is not None and not gen.is_multilingual and (
            language is not None or task is not None):
        raise ValueError("Cannot specify `task` or `language` for an "
                         "English-only model")
    if language is not None and gen.lang_to_id is None:
        raise ValueError("the generation config has no lang_to_id, so it "
                         "cannot condition on a language")
    if task is not None and task not in TASKS:
        raise ValueError(f"The `{task}` task is not supported: one of {TASKS}")
    if gen.return_timestamps and gen.no_timestamps_token_id is None:
        raise ValueError("return_timestamps needs the generation config's "
                         "no_timestamps_token_id")


def _decoder_step(model, ids, cross, past=None):
    states, past = model.model.decoder(ids, cross, past)
    return model.logits(states[:, -1]).float(), past


def init_tokens(model, cross, gen: GenerationSettings, language=None, task=None,
                config_forced_ids=None, keep_scores=False):
    """The decoder prompt, and the detection step's masked scores when the
    language was detected and ``keep_scores``."""
    _check_language(gen, language, task)
    language = language if language is not None else gen.language
    task = task if task is not None else gen.task
    tokens = [gen.decoder_start_token_id]
    if task is None and language is None:
        forced = gen.forced_decoder_ids or config_forced_ids
        if forced and forced[0][0] == 1:
            i = 1
            while forced and forced[0][0] == i:
                tokens.append(forced[0][1])
                forced = forced[1:]
                i += 1
            if forced:
                raise ValueError(f"forced_decoder_ids {forced} do not follow "
                                 "Whisper's prompt pattern")
    lang_undefined = len(tokens) <= 1 or tokens[1] is None
    lang_id, detected = None, None
    if language is not None:
        lang_id = language_token_id(language, gen)
    elif gen.lang_to_id is not None and lang_undefined:
        with tracing.span("whisper.detect_language"):
            device = cross[0][0].device
            start = torch.tensor([[gen.decoder_start_token_id]], device=device)
            logits, _ = _decoder_step(model, start, cross)
            mask = torch.ones(logits.shape[-1], dtype=torch.bool, device=device)
            mask[list(gen.lang_to_id.values())] = False
            logits[:, mask] = -float("inf")
            lang_id = int(logits.argmax(-1)[0])
            if keep_scores:
                detected = logits[0].cpu()
    if lang_id is not None:
        if len(tokens) > 1:
            tokens[1] = lang_id
        else:
            tokens.append(lang_id)
    if task is not None:
        tokens.append(gen.task_to_id[task])
    elif language is not None and gen.task_to_id is not None:
        if not any(t in gen.task_to_id.values() for t in tokens):
            tokens.append(gen.task_to_id["transcribe"])
    no_ts = gen.no_timestamps_token_id
    if no_ts is not None:
        if not gen.return_timestamps and tokens[-1] != no_ts:
            tokens.append(no_ts)
        elif gen.return_timestamps and tokens[-1] == no_ts:
            tokens = tokens[:-1]
    return [t for t in tokens if t is not None], detected


def max_length(gen: GenerationSettings, prompt_len: int, max_target_positions: int) -> int:
    """The whole sequence's length limit, prompt included."""
    if gen.max_new_tokens is not None:
        if gen.max_new_tokens + prompt_len > max_target_positions:
            raise ValueError(
                f"a prompt of {prompt_len} tokens and max_new_tokens "
                f"{gen.max_new_tokens} exceed max_target_positions "
                f"{max_target_positions}")
        return gen.max_new_tokens + prompt_len
    if gen.max_length == DEFAULT_MAX_LENGTH:
        return DEFAULT_MAX_LENGTH + prompt_len
    if prompt_len >= gen.max_length:
        raise ValueError(f"the prompt has {prompt_len} tokens, but max_length "
                         f"is {gen.max_length}")
    return gen.max_length


def _eos_list(gen: GenerationSettings) -> List[int]:
    eos = gen.eos_token_id
    if eos is None:
        return []
    return list(eos) if isinstance(eos, (list, tuple)) else [eos]


def _strip(tokens: List[int], gen: GenerationSettings) -> List[int]:
    """Trailing padding and the final end of text off a window's tokens
    (``generate_with_fallback``)."""
    if tokens and tokens[-1] == gen.pad_token_id:
        n = tokens.count(gen.pad_token_id)
        if gen.pad_token_id == gen.eos_token_id:
            n -= 1
        if n:
            tokens = tokens[:-n]
    if tokens and tokens[-1] == gen.eos_token_id:
        tokens = tokens[:-1]
    return tokens


def window_segments(tokens: List[int], timestamp_begin: int, window_frames: int,
                    input_stride: int = 2) -> Tuple[List[List[int]], int]:
    """(the window's segments, frames to seek on) (``_retrieve_segment``):
    the tokens split after each pair of timestamps, the last pair kept and
    what follows it dropped, unless a single timestamp ends the window."""
    is_ts = [t >= timestamp_begin for t in tokens]
    single_ending = is_ts[-2:] == [False, True]
    cuts = [i + 1 for i in range(len(tokens) - 1) if is_ts[i] and is_ts[i + 1]]
    if not cuts:
        return [tokens], window_frames
    if single_ending:
        cuts.append(len(tokens))
    else:
        cuts[-1] += 1
    segments = [tokens[a:b] for a, b in zip([0] + cuts[:-1], cuts)]
    if single_ending:
        return segments, window_frames
    return segments, (tokens[cuts[-1] - 2] - timestamp_begin) * input_stride


def previous_tokens(segments: List[List[int]], timestamp_begin: int,
                    cut_off: int, prev_sot: Optional[int]) -> List[int]:
    """The earlier windows' tokens a conditioned window's prompt starts
    with (``_pad_to_max_length`` with ``skip_ending_double_timestamps``): a
    segment's closing timestamp dropped where two end it, the last
    ``cut_off`` tokens, after ``prev_sot``."""
    kept = []
    for seg in segments:
        if len(seg) > 2 and seg[-2] >= timestamp_begin:
            seg = seg[:-1]
        kept.extend(seg)
    kept = kept[-cut_off:] if cut_off else []
    return ([prev_sot] if prev_sot is not None else []) + kept


class LogitsProcessors:
    """The generation config's processors, applied in the order
    ``GenerationMixin._get_logits_processor`` merges them with Whisper's
    (the standard ones first; the suppressions take the places of the
    standard ones they replace; the timestamp rules last). ``ids`` are the
    rows' whole sequences, prompt included, ``begin`` the window's prompt
    length."""

    def __init__(self, gen: GenerationSettings, vocab: int, timestamp_begin: int,
                 device):
        self.gen = gen
        self.eos = _eos_list(gen)
        arange = torch.arange(vocab, device=device)

        def mask(tokens):
            if tokens is None:
                return None
            return torch.isin(arange, torch.tensor(list(tokens), dtype=torch.long,
                                                   device=device))

        self.eos_mask = mask(self.eos) if self.eos else None
        self.suppress = mask(gen.suppress_tokens)
        self.begin_suppress = mask(gen.begin_suppress_tokens)
        self.timestamp_begin = timestamp_begin
        # each row's gap between the two sides of the last step's
        # timestamp-versus-text rule (kept on the device)
        self.stamp_gaps = torch.empty(0, device=device)
        # the timestamp rule's "text" ends where the end of text is
        self.text_end = gen.eos_token_id or gen.bos_token_id

    def __call__(self, seqs: List[List[int]], scores: torch.Tensor, begin: int
                 ) -> torch.Tensor:
        gen = self.gen
        length = len(seqs[0])
        if gen.repetition_penalty != 1.0:
            ids = torch.tensor(seqs, dtype=torch.long, device=scores.device)
            picked = torch.gather(scores, 1, ids)
            picked = torch.where(picked < 0, picked * gen.repetition_penalty,
                                 picked / gen.repetition_penalty)
            scores = scores.scatter(1, ids, picked)
        n = gen.no_repeat_ngram_size
        if n and length + 1 >= n:
            scores = scores.clone()
            for row, seq in enumerate(seqs):
                prefix = tuple(seq[length + 1 - n:])
                banned = [seq[i + n - 1] for i in range(length - n + 1)
                          if tuple(seq[i:i + n - 1]) == prefix]
                if banned:
                    scores[row, banned] = -float("inf")
        # ``min_new_tokens`` replaces ``min_length`` (``_prepare_generated_length``)
        floor = (gen.min_length if gen.min_new_tokens is None
                 else gen.min_new_tokens + begin)
        if self.eos_mask is not None and length < floor:
            scores = torch.where(self.eos_mask, -float("inf"), scores)
        if self.suppress is not None:
            scores = torch.where(self.suppress, -float("inf"), scores)
        if self.begin_suppress is not None and length == begin:
            scores = torch.where(self.begin_suppress, -float("inf"), scores)
        if gen.return_timestamps:
            scores = self._timestamps(seqs, scores, begin)
        return scores

    def _timestamps(self, seqs, scores, begin):
        """``WhisperTimeStampLogitsProcessor``."""
        gen, tb = self.gen, self.timestamp_begin
        inf = -float("inf")
        scores = scores.clone()
        scores[:, gen.no_timestamps_token_id] = inf
        for row, seq in enumerate(seqs):
            sampled = seq[begin:]
            last = len(sampled) >= 1 and sampled[-1] >= tb
            penultimate = len(sampled) < 2 or sampled[-2] >= tb
            if last:
                if penultimate:
                    scores[row, tb:] = inf
                else:
                    scores[row, :self.text_end] = inf
            stamps = [t for t in sampled if t >= tb]
            if stamps:
                floor = stamps[-1] if last and not penultimate else stamps[-1] + 1
                scores[row, tb:floor] = inf
        if len(seqs[0]) == begin:
            scores[:, :tb] = inf
            if gen.max_initial_timestamp_index is not None:
                scores[:, tb + gen.max_initial_timestamp_index + 1:] = inf
        logprobs = F.log_softmax(scores.float(), dim=-1)
        stamp = logprobs[:, tb:].logsumexp(dim=-1)
        text = logprobs[:, :tb].max(dim=-1).values
        self.stamp_gaps = (stamp - text).abs()
        for row in torch.nonzero(stamp > text).flatten().tolist():
            scores[row, :tb] = inf
        return scores


def _expand(cross, rows):
    return [(k.expand(rows, -1, -1, -1), v.expand(rows, -1, -1, -1)) for k, v in cross]


@tracing.traced("whisper.greedy_window")
def _greedy_window(model, cross, prompt, limit, procs, out, keep_scores):
    """One window decoded greedily: the generated tokens, end of text
    included (``GenerationMixin._sample`` without sampling). Each step's
    host work (the decoder step's launches, the logits processors) and its
    wait on the card (the argmax to a Python int) are spans of their own."""
    device = cross[0][0].device
    eos = set(procs.eos)
    seq = list(prompt)
    ids, past = [prompt], None
    while True:
        with tracing.span("whisper.decoder_step"):
            logits, past = _decoder_step(model, torch.tensor(ids, device=device), cross,
                                         past)
        with tracing.span("whisper.logits_processors"):
            scores = procs([seq], logits, len(prompt))
        with tracing.span("whisper.token_fetch"):
            token = int(scores.argmax(-1)[0])
        if len(out.scores) < keep_scores:
            out.scores.append(scores[0].cpu())
        seq.append(token)
        out.steps += 1
        tracing.count("whisper.decoder_steps")
        if token in eos or len(seq) >= limit:
            return seq[len(prompt):]
        ids = [[token]]


def _beam_window(model, cross, prompt, limit, procs, gen, out, keep_scores):
    """One window decoded by beam search (``GenerationMixin._beam_search``
    at batch 1, without sampling): the best finished hypothesis's generated
    tokens. The candidates are ranked on the device; the bookkeeping runs
    on the host in ``transformers``' own tensor operations."""
    device = cross[0][0].device
    beams = gen.num_beams
    vocab = model.dims.vocab_size
    eos = torch.tensor(procs.eos, dtype=torch.long)
    keep = max(2, 1 + len(procs.eos)) * beams
    top_beams = torch.cat((torch.ones(beams, dtype=torch.bool),
                           torch.zeros(keep - beams, dtype=torch.bool)))
    early_stopping, length_penalty = gen.early_stopping, gen.length_penalty
    prompt_len = cur_len = len(prompt)
    running = torch.full((1, beams, limit), -1, dtype=torch.long)
    running[:, :, :cur_len] = torch.tensor(prompt)
    sequences = running.clone()
    running_scores = torch.zeros((1, beams))
    running_scores[:, 1:] = -1e9
    beam_scores = torch.full((1, beams), -1e9)
    finished = torch.zeros((1, beams), dtype=torch.bool)
    improvable = torch.ones((1, 1), dtype=torch.bool)
    running_sources = torch.full((1, beams, limit - cur_len), -1, dtype=torch.int32)
    sources = running_sources.clone()

    def gather(t, index):
        while index.dim() < t.dim():
            index = index.unsqueeze(-1)
        return torch.take_along_dim(t, index, dim=1)

    cross = _expand(cross, beams)
    logits, past = _decoder_step(
        model, torch.tensor([prompt] * beams, device=device), cross)
    while True:
        seqs = running[0, :, :cur_len].tolist()
        log_probs = procs(seqs, F.log_softmax(logits, dim=-1), prompt_len)
        if len(out.scores) < keep_scores:
            out.scores.append(log_probs.cpu())
        out.steps += 1
        accumulated = (log_probs.reshape(1, beams, vocab)
                       + running_scores.to(device)[:, :, None]).reshape(1, beams * vocab)
        top_scores, top_index = torch.topk(accumulated, k=keep)
        top_scores, top_index = top_scores.cpu(), top_index.cpu()
        from_beam = top_index // vocab
        top_sources = gather(running_sources, from_beam)
        top_sequences = gather(running, from_beam)
        top_sequences[:, :, cur_len] = top_index % vocab
        top_sources[:, :, cur_len - prompt_len] = from_beam.to(torch.int32)
        last = top_sequences[:, :, cur_len]
        hits = torch.isin(last, eos) | (cur_len + 1 >= limit)
        # the best beams that did not finish run on
        running_top = top_scores + hits.to(torch.float32) * -1.0e9
        pick = torch.topk(running_top, k=beams)[1]
        running = gather(top_sequences, pick)
        running_scores = gather(running_top, pick)
        running_sources = gather(top_sources, pick)
        # the finished hypotheses, ranked with the length penalty
        just_finished = hits & top_beams[None, :]
        scored = top_scores / ((cur_len + 1 - prompt_len) ** length_penalty)
        full = torch.all(finished, dim=-1, keepdim=True) & (early_stopping is True)
        scored = scored + full.to(torch.float32) * -1.0e9
        scored = scored + (~improvable).to(torch.float32) * -1.0e9
        scored = scored + (~just_finished) * -1.0e9
        merged = torch.topk(torch.cat((beam_scores, scored), dim=1), k=beams)[1]
        sequences = gather(torch.cat((sequences, top_sequences), dim=1), merged)
        beam_scores = gather(torch.cat((beam_scores, scored), dim=1), merged)
        sources = gather(torch.cat((sources, top_sources), dim=1), merged)
        finished = gather(torch.cat((finished, just_finished), dim=1), merged)
        if len(out.beam_tokens) < keep_scores:
            ranked = torch.topk(accumulated[0], k=keep + 1).values
            gaps = torch.cat((ranked[:-1] - ranked[1:], procs.stamp_gaps))
            gaps = gaps[torch.isfinite(gaps)]
            out.beam_tokens.append(running[0, :, cur_len].tolist())
            out.beam_sources.append(running_sources[0, :, cur_len - prompt_len].tolist())
            out.beam_margins.append(float(gaps.min()) if gaps.numel() else float("inf"))
        # the cache follows its beams
        order = running_sources[0, :, cur_len - prompt_len].to(torch.long).to(device)
        past = [(k.index_select(0, order), v.index_select(0, order)) for k, v in past]
        cur_len += 1
        if early_stopping == "never" and length_penalty > 0.0:
            best_length = limit - prompt_len
        else:
            best_length = cur_len - prompt_len
        best_running = running_scores[:, :1] / (best_length ** length_penalty)
        worst_finished = torch.where(finished, torch.min(beam_scores, dim=1, keepdim=True)[0],
                                     -1.0e9)
        improvable = improvable & torch.any(best_running > worst_finished, dim=-1,
                                            keepdim=True)
        open_beam = not (bool(torch.all(finished)) and early_stopping is True)
        if not (bool(improvable.any()) and open_beam and not bool(torch.all(hits))):
            break
        step = running[0, :, cur_len - 1:cur_len].to(device)
        logits, past = _decoder_step(model, step, cross, past)
    out.beam_scores.append(float(beam_scores[0, 0]))
    generated = int(((sources[0, 0] + 1) != 0).sum())
    return sequences[0, 0, prompt_len:prompt_len + generated].tolist()


def generate(model, features: torch.Tensor, gen: GenerationSettings,
             language: Optional[str] = None, task: Optional[str] = None,
             config_forced_ids=None, keep_scores: int = 0,
             max_steps: Optional[int] = None) -> Decoded:
    """Decode one utterance's (1, num_mel_bins, frames) log-mel under
    ``gen``: greedily, or by beam search when ``num_beams`` > 1.
    ``keep_scores`` keeps the first steps' scores; ``max_steps`` ends the
    decode after that many decoder steps (for comparing runs): the window
    then ends as at its length limit and no further window is decoded."""
    dims = model.dims
    window = 2 * dims.max_source_positions
    device = features.device
    timestamp_begin = (gen.no_timestamps_token_id + 1
                       if gen.no_timestamps_token_id is not None
                       else dims.vocab_size + 1)
    procs = LogitsProcessors(gen, dims.vocab_size, timestamp_begin, device)
    beams = gen.num_beams if gen.num_beams is not None else 1
    prev_sot = gen.prev_sot_token_id
    if prev_sot is None and gen.suppress_tokens is not None and len(gen.suppress_tokens) >= 2:
        prev_sot = gen.suppress_tokens[-2]
    cut_off = dims.max_target_positions // 2 - 1
    total = features.shape[-1]
    out = Decoded(ids=[], prompt=[])
    segments: List[List[int]] = []
    seek = 0
    with torch.no_grad():
        while seek < total:
            num = min(total - seek, window)
            segment = features[:, :, seek:seek + num]
            if num < window:
                segment = F.pad(segment, (0, window - num))
            with tracing.span("whisper.encode"):
                encoded = model.encode(segment)
            with tracing.span("whisper.cross_kv"):
                cross = model.model.decoder.cross_kv(encoded)
            if out.windows == 0:
                # detection reads the whole input; one 30 s window here
                out.prompt, out.language_scores = init_tokens(
                    model, cross, gen, language, task, config_forced_ids,
                    keep_scores > 0)
            prompt = list(out.prompt)
            if gen.condition_on_prev_tokens and segments:
                prompt = previous_tokens(segments, timestamp_begin, cut_off,
                                         prev_sot) + prompt
            limit = max_length(gen, len(prompt), dims.max_target_positions)
            if max_steps is not None:
                limit = min(limit, len(prompt) + max_steps - out.steps)
            if beams > 1:
                tokens = _beam_window(model, cross, prompt, limit, procs, gen,
                                      out, keep_scores)
            else:
                tokens = _greedy_window(model, cross, prompt, limit, procs, out,
                                        keep_scores)
            out.windows += 1
            tracing.count("whisper.windows")
            if gen.force_unique_generate_call:
                out.ids = prompt + tokens
                break
            found, offset = window_segments(_strip(tokens, gen), timestamp_begin, num)
            segments.extend(found)
            out.ids.extend(t for s in found for t in s)
            if offset == 0 and not gen.condition_on_prev_tokens:
                raise RuntimeError(
                    "the decoder ended a window with a timestamp pair at 0 s; "
                    "the reference seeks nowhere and decodes the same window "
                    "with the same prompt again without end")
            seek += offset
            if max_steps is not None and out.steps >= max_steps:
                break
    return out


# a greedy config's :func:`generate` keeps its earlier name
greedy_generate = generate
