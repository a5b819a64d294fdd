"""Greedy decoding of one utterance, as Whisper's ``generate`` does it.

Counterpart of ``WhisperForConditionalGeneration.generate(input_features,
language=...)`` for one short-form input with the checkpoint's generation
config (``transformers`` ``models/whisper/generation_whisper.py``):

- the prompt (``_retrieve_init_tokens``): ``decoder_start_token_id``, then
  ``forced_decoder_ids`` when neither a language nor a task is set, the
  language (given, or detected from one decoder step over ``lang_to_id``:
  ``detect_language``), the task (transcribe by default once a language
  is given) and ``no_timestamps_token_id``;
- ``suppress_tokens`` on every step and ``begin_suppress_tokens`` on the
  first, then the arg-max;
- a stop at ``eos_token_id`` or at the length ``_set_max_new_tokens_and_
  length`` and ``generate`` set (``max_new_tokens`` after the prompt, else
  ``max_length`` in all, 20 after the prompt when left at its default);
- the returned ids are the generated tokens without the prompt and
  without the final end of text; should the decoder emit two timestamp
  tokens in a row, the window ends at the last such pair and decoding
  seeks on from its time (``_retrieve_segment``), as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch
import torch.nn.functional as F

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
    """One utterance's decode: ``ids`` is what ``generate`` returns;
    ``scores`` the processed scores of the first ``keep_scores`` steps of
    the first window and ``language_scores`` the detection step's (on the
    host), when asked for."""

    ids: List[int]
    prompt: List[int]
    steps: int = 0
    windows: int = 0
    scores: List[torch.Tensor] = field(default_factory=list)
    language_scores: Optional[torch.Tensor] = None


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


def _check_supported(gen: GenerationSettings, language, task) -> None:
    for name in ("return_timestamps", "condition_on_prev_tokens",
                 "force_unique_generate_call"):
        if getattr(gen, name):
            raise NotImplementedError(f"generation config sets {name}: only "
                                      "greedy short-form decoding without "
                                      "timestamps is supported")
    if gen.num_beams not in (None, 1):
        raise NotImplementedError("beam search: only greedy decoding is supported")
    if gen.is_multilingual is not None and not gen.is_multilingual and (
            language is not None or task is not None):
        raise ValueError("Cannot specify `task` or `language` for an "
                         "English-only model")
    if language is not None and gen.lang_to_id is None:
        raise ValueError("the generation config has no lang_to_id, so it "
                         "cannot condition on a language")
    if task is not None and task not in TASKS:
        raise ValueError(f"The `{task}` task is not supported: one of {TASKS}")


def _decoder_step(model, ids, cross, past=None):
    states, past = model.model.decoder(ids, cross, past)
    return model.logits(states[:, -1]).float(), past


def init_tokens(model, cross, gen: GenerationSettings, language=None, task=None,
                config_forced_ids=None, keep_scores=False):
    """The decoder prompt, and the detection step's masked scores when the
    language was detected and ``keep_scores``."""
    _check_supported(gen, language, task)
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
    if gen.no_timestamps_token_id is not None and tokens[-1] != gen.no_timestamps_token_id:
        tokens.append(gen.no_timestamps_token_id)
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
    return gen.max_length


def _eos_ids(gen: GenerationSettings) -> set:
    eos = gen.eos_token_id
    if eos is None:
        return set()
    return set(eos) if isinstance(eos, (list, tuple)) else {eos}


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


def window_tokens(tokens: List[int], timestamp_begin: int, window_frames: int,
                  input_stride: int = 2):
    """(tokens kept, frames to seek on) for one window (``_retrieve_segment``)."""
    is_ts = [t >= timestamp_begin for t in tokens]
    single_ending = is_ts[-2:] == [False, True]
    pairs = [i + 1 for i in range(len(tokens) - 1) if is_ts[i] and is_ts[i + 1]]
    if not pairs:
        return tokens, window_frames
    if single_ending:
        return tokens, window_frames
    end = pairs[-1] + 1
    return tokens[:end], (tokens[end - 2] - timestamp_begin) * input_stride


def greedy_generate(model, features: torch.Tensor, gen: GenerationSettings,
                    language: Optional[str] = None, task: Optional[str] = None,
                    config_forced_ids=None, keep_scores: int = 0,
                    max_steps: Optional[int] = None) -> Decoded:
    """Decode one utterance's (1, num_mel_bins, frames) log-mel greedily.
    ``max_steps`` cuts each window after that many decoder steps (for
    comparing runs); ``keep_scores`` keeps the first steps' scores."""
    dims = model.dims
    window = 2 * dims.max_source_positions
    device = features.device
    eos = _eos_ids(gen)
    timestamp_begin = (gen.no_timestamps_token_id + 1
                       if gen.no_timestamps_token_id is not None
                       else dims.vocab_size + 1)
    vocab = dims.vocab_size
    suppress = [t for t in (gen.suppress_tokens or []) if t < vocab]
    begin_suppress = [t for t in (gen.begin_suppress_tokens or []) if t < vocab]
    total = features.shape[-1]
    out = Decoded(ids=[], prompt=[])
    seek = 0
    with torch.no_grad():
        while seek < total:
            num = min(total - seek, window)
            segment = features[:, :, seek:seek + num]
            if num < window:
                segment = F.pad(segment, (0, window - num))
            cross = model.model.decoder.cross_kv(model.encode(segment))
            if out.windows == 0:
                # detection reads the whole input; one 30 s window here
                out.prompt, out.language_scores = init_tokens(
                    model, cross, gen, language, task, config_forced_ids,
                    keep_scores > 0)
            prompt = out.prompt
            limit = max_length(gen, len(prompt), dims.max_target_positions)
            seq = list(prompt)
            logits, past = _decoder_step(
                model, torch.tensor([prompt], device=device), cross)
            steps = 0
            while True:
                if begin_suppress and len(seq) == len(prompt):
                    logits[:, begin_suppress] = -float("inf")
                if suppress:
                    logits[:, suppress] = -float("inf")
                token = int(logits.argmax(-1)[0])
                if out.windows == 0 and steps < keep_scores:
                    out.scores.append(logits[0].cpu())
                seq.append(token)
                steps += 1
                if (token in eos or len(seq) >= limit
                        or (max_steps is not None and steps >= max_steps)):
                    break
                logits, past = _decoder_step(
                    model, torch.tensor([[token]], device=device), cross, past)
            out.steps += steps
            out.windows += 1
            tokens = _strip(seq[len(prompt):], gen)
            kept, offset = window_tokens(tokens, timestamp_begin, num)
            out.ids.extend(kept)
            if offset <= 0:
                raise RuntimeError(
                    "the decoder ended a window with a timestamp pair at 0 s; "
                    "the reference seeks nowhere and decodes the window again "
                    "without end")
            seek += offset
    return out
