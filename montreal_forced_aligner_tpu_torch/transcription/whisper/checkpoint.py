"""Read a local Hugging Face Whisper checkpoint directory.

The directory is what ``WhisperForConditionalGeneration.save_pretrained``
and ``WhisperProcessor.save_pretrained`` write: ``config.json``,
``generation_config.json``, ``preprocessor_config.json``, the tokenizer's
files and the weights as ``model.safetensors`` (or a sharded
``model.safetensors.index.json``) or ``pytorch_model.bin``. The weights
keep Hugging Face's parameter names (``model.encoder.layers.N.self_attn.
q_proj.weight``, ...) and are cast to float32 at load, as ``from_pretrained``
does without ``torch_dtype``; :class:`..model.Whisper` takes them with one
``load_state_dict``. Safetensors files are read here (an 8-byte header
length, a JSON header, then the raw tensors), so no ``safetensors`` or
``transformers`` package is needed.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.device import resolve_device

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


@dataclass(frozen=True)
class WhisperDims:
    """The model's shapes (``config.json``; missing keys take
    ``WhisperConfig``'s defaults)."""

    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    decoder_layers: int = 4
    decoder_attention_heads: int = 6
    decoder_ffn_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    pad_token_id: int = 50256
    activation_function: str = "gelu"

    @classmethod
    def from_config(cls, config: dict) -> "WhisperDims":
        return cls(**{k: config[k] for k in cls.__dataclass_fields__ if k in config})


# ``GenerationConfig``'s own attributes and their defaults (``transformers``
# 4.57.6 ``generation/configuration_utils.py``). A generation config made
# from the model config (``_from_model_config``) keeps only these, as
# ``GenerationConfig.__init__`` drops other keys then.
GENERATION_DEFAULTS = {
    "max_length": 20, "max_new_tokens": None, "min_length": 0,
    "min_new_tokens": None, "early_stopping": False, "max_time": None,
    "stop_strings": None, "do_sample": False, "num_beams": 1, "use_cache": True,
    "cache_implementation": None, "cache_config": None,
    "return_legacy_cache": None, "prefill_chunk_size": None, "temperature": 1.0,
    "top_k": 50, "top_p": 1.0, "min_p": None, "typical_p": 1.0,
    "epsilon_cutoff": 0.0, "eta_cutoff": 0.0, "repetition_penalty": 1.0,
    "encoder_repetition_penalty": 1.0, "length_penalty": 1.0,
    "no_repeat_ngram_size": 0, "bad_words_ids": None, "renormalize_logits": False,
    "forced_bos_token_id": None, "forced_eos_token_id": None,
    "remove_invalid_values": False, "exponential_decay_length_penalty": None,
    "suppress_tokens": None, "begin_suppress_tokens": None, "sequence_bias": None,
    "token_healing": False, "guidance_scale": None, "watermarking_config": None,
    "num_return_sequences": 1, "output_attentions": False,
    "output_hidden_states": False, "output_scores": False, "output_logits": None,
    "return_dict_in_generate": False, "pad_token_id": None, "bos_token_id": None,
    "eos_token_id": None, "encoder_no_repeat_ngram_size": 0,
    "decoder_start_token_id": None, "is_assistant": False,
    "num_assistant_tokens": 20, "num_assistant_tokens_schedule": "constant",
    "assistant_confidence_threshold": 0.4, "prompt_lookup_num_tokens": None,
    "max_matching_ngram_size": None, "assistant_early_exit": None,
    "assistant_lookbehind": 10, "target_lookbehind": 10, "disable_compile": False, "low_memory": None, "penalty_alpha": None,
    "dola_layers": None, "diversity_penalty": 0.0, "num_beam_groups": 1,
    "constraints": None, "force_words_ids": None,
}
# the file's bookkeeping, read by no decoding
_METADATA_KEYS = ("_from_model_config", "_commit_hash", "_original_object_hash",
                  "transformers_version")
# standard keys whose value changes no token: what ``generate`` returns
# beside the ids, caching and compilation, the sampling warpers (they act
# only when sampling, which is refused) and the assistant's settings (read
# only with an assistant model, which the transcriber never passes)
_INERT_KEYS = frozenset((
    "output_attentions", "output_hidden_states", "output_scores",
    "output_logits", "return_legacy_cache", "use_cache", "compile_config",
    "disable_compile", "temperature", "top_k", "top_p", "min_p", "typical_p",
    "epsilon_cutoff", "eta_cutoff", "num_assistant_tokens",
    "num_assistant_tokens_schedule", "assistant_confidence_threshold",
    "assistant_lookbehind", "target_lookbehind", "max_matching_ngram_size",
))
# Whisper's own keys (``generation_whisper.py``) that change no token in a
# short-form decode at one temperature: word-level timestamps are not
# asked for (``alignment_heads``, ``median_filter_width``,
# ``return_token_timestamps``, ``num_frames``); ``prompt_condition_type``
# is overwritten by ``generate``'s argument and read only with
# ``prompt_ids``; the compression-ratio threshold only asks for a fallback
# to the next temperature, and there is none (``generate_with_fallback``)
_WHISPER_INERT_KEYS = frozenset((
    "alignment_heads", "median_filter_width", "return_token_timestamps",
    "num_frames", "prompt_condition_type", "compression_ratio_threshold",
))
# Whisper's keys that the port holds only at their default
_WHISPER_DEFAULTS = {"_detect_timestamp_from_logprob": True}
# keys the port does not decode as ``transformers`` does, by why
_REFUSED = {
    "do_sample": "transformers samples (a random draw), so no run can be "
                 "held to it",
    "logprob_threshold": "transformers 4.57.6 raises on it in a decode at one "
                         "temperature (``_need_fallback``)",
    "no_speech_threshold": "transformers 4.57.6 reads it only beside "
                           "logprob_threshold, on which it raises",
    "return_dict_in_generate": "generate then returns a dict, which the "
                               "transcriber cannot decode to text",
    "num_return_sequences": "only one sequence an utterance is decoded",
    "_detect_timestamp_from_logprob": "the port always applies the "
                                      "timestamp-versus-text rule",
}
# the Whisper keys :class:`GenerationSettings` holds (besides the standard ones)
_WHISPER_KEYS = ("lang_to_id", "task_to_id", "is_multilingual",
                 "no_timestamps_token_id", "return_timestamps", "language",
                 "task", "condition_on_prev_tokens",
                 "force_unique_generate_call", "prev_sot_token_id",
                 "max_initial_timestamp_index")
# the standard keys :class:`GenerationSettings` holds
_STANDARD_KEYS = ("decoder_start_token_id", "eos_token_id", "pad_token_id",
                  "bos_token_id", "max_length", "max_new_tokens", "min_length",
                  "min_new_tokens", "suppress_tokens", "begin_suppress_tokens",
                  "forced_decoder_ids", "repetition_penalty",
                  "no_repeat_ngram_size", "num_beams", "length_penalty",
                  "early_stopping")
# GenerationConfig's default length: ``generate`` adds the prompt's length
# to it when it is left at this value
DEFAULT_MAX_LENGTH = GENERATION_DEFAULTS["max_length"]
# from this version of the file on, ``generate`` puts back into its working
# copy of the config every value the model's config sets away from the
# default (``_prepare_generation_config``): a ``do_sample`` that Whisper's
# loop cleared comes back
_MODEL_DEFAULTS_VERSION = (4, 50)


def _version(text) -> tuple:
    parts = []
    for piece in str(text).split(".")[:2]:
        digits = "".join(c for c in piece if c.isdigit())
        parts.append(int(digits) if digits else 0)
    return tuple(parts)


@dataclass
class GenerationSettings:
    """What ``generation_config.json`` sets. A Whisper key the file does not
    set is None (``hasattr`` false in the reference); every key of the file
    is read (:meth:`from_dict`)."""

    decoder_start_token_id: Optional[int] = None
    eos_token_id: object = None
    pad_token_id: Optional[int] = None
    bos_token_id: Optional[int] = None
    max_length: int = DEFAULT_MAX_LENGTH
    max_new_tokens: Optional[int] = None
    min_length: int = 0
    min_new_tokens: Optional[int] = None
    suppress_tokens: Optional[List[int]] = None
    begin_suppress_tokens: Optional[List[int]] = None
    forced_decoder_ids: Optional[list] = None
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    num_beams: Optional[int] = None
    length_penalty: float = 1.0
    early_stopping: object = False
    lang_to_id: Optional[Dict[str, int]] = None
    task_to_id: Optional[Dict[str, int]] = None
    is_multilingual: Optional[bool] = None
    no_timestamps_token_id: Optional[int] = None
    return_timestamps: Optional[bool] = None
    language: Optional[str] = None
    task: Optional[str] = None
    condition_on_prev_tokens: Optional[bool] = None
    force_unique_generate_call: Optional[bool] = None
    prev_sot_token_id: Optional[int] = None
    max_initial_timestamp_index: Optional[int] = None

    @classmethod
    def from_dict(cls, data: dict, from_model_config: bool) -> "GenerationSettings":
        """The settings of a generation config's keys. A key whose value
        changes no token is accepted (``_INERT_KEYS``,
        ``_WHISPER_INERT_KEYS``); any other key the port does not decode as
        ``transformers`` does raises ``NotImplementedError`` naming it,
        unless it holds its default. Made from the model config, only the
        standard keys count, as ``transformers`` drops the rest."""
        merges_defaults = (_version(data.get("transformers_version", "4.57.6"))
                           >= _MODEL_DEFAULTS_VERSION)
        kw = {}
        for key, value in data.items():
            if key in _METADATA_KEYS:
                continue
            standard = key in GENERATION_DEFAULTS
            if from_model_config and not standard:
                continue
            if key in _STANDARD_KEYS or key in _WHISPER_KEYS:
                if value is not None:
                    kw[key] = value
            elif (value is None or key in _INERT_KEYS or key in _WHISPER_INERT_KEYS
                  or (standard and value == GENERATION_DEFAULTS[key])
                  or (key in _WHISPER_DEFAULTS and value == _WHISPER_DEFAULTS[key])):
                continue
            elif key == "do_sample" and not merges_defaults:
                # Whisper's loop clears it, and a file older than 4.50
                # does not bring it back
                continue
            else:
                why = _REFUSED.get(key, "the port does not implement it")
                raise NotImplementedError(
                    f"generation config sets {key}={value!r}: {why}")
        settings = cls(**kw)
        settings.validate()
        return settings

    def validate(self) -> None:
        """The checks ``GenerationConfig`` and the logits processors make on
        the values the port reads."""
        if self.early_stopping not in (True, False, "never"):
            raise ValueError("`early_stopping` must be a boolean or 'never', "
                             f"but is {self.early_stopping!r}")
        beams = self.num_beams if self.num_beams is not None else 1
        if not isinstance(beams, int) or beams < 1:
            raise ValueError(f"`num_beams` must be a positive integer, but is {beams!r}")
        if self.repetition_penalty != 1.0 and not (
                isinstance(self.repetition_penalty, float) and self.repetition_penalty > 0):
            raise ValueError("`penalty` has to be a strictly positive float, "
                             f"but is {self.repetition_penalty!r}")
        for name in ("no_repeat_ngram_size", "min_length"):
            value = getattr(self, name)
            if not isinstance(value, int) or value < 0:
                raise ValueError(f"`{name}` has to be a non-negative integer, "
                                 f"but is {value!r}")


@dataclass
class WhisperCheckpoint:
    """One checkpoint directory's settings and float32 weights."""

    config: dict
    dims: WhisperDims
    generation: GenerationSettings
    preprocessor: dict
    state_dict: Dict[str, torch.Tensor] = field(repr=False)


def _read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, in its stored dtype. The
    tensors map the file copy-on-write (a tensor whose bytes do not start
    at a multiple of its item size is copied)."""
    path = Path(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: unsupported safetensors dtype "
                             f"{info['dtype']!r} for {name}")
        begin, end = info["data_offsets"]
        raw = data[begin:end]
        if begin % dtype.itemsize:
            raw = np.array(raw)
        out[name] = torch.from_numpy(raw).view(dtype).reshape(info["shape"])
    return out


def read_weights(path: Path, device="cuda") -> Dict[str, torch.Tensor]:
    """The checkpoint's tensors on ``device`` cast to float32 (moved in
    their stored dtype, then cast there), from ``model.safetensors``, its
    sharded index, or ``pytorch_model.bin``. Asking for the card without
    one raises."""
    device = resolve_device(device)
    path = Path(path)
    single = path / "model.safetensors"
    index = path / "model.safetensors.index.json"
    binary = path / "pytorch_model.bin"
    if single.exists():
        tensors = read_safetensors(single)
    elif index.exists():
        tensors = {}
        for shard in sorted(set(_read_json(index)["weight_map"].values())):
            tensors.update(read_safetensors(path / shard))
    elif binary.exists():
        tensors = torch.load(binary, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(
            f"no model.safetensors or pytorch_model.bin in {path}")
    out = {}
    for k, v in tensors.items():
        v = v.to(device, copy=True)
        out[k] = v.to(torch.float32) if v.is_floating_point() else v
    return out


def load_checkpoint(path, device="cuda") -> WhisperCheckpoint:
    """Read a checkpoint directory, its weights onto ``device`` (the card
    unless the CPU is asked for; without a card that raises). Without
    ``generation_config.json`` the generation settings come from
    ``config.json``, as ``GenerationConfig.from_model_config`` makes them."""
    device = resolve_device(device)
    path = Path(path)
    config = _read_json(path / "config.json")
    gen_path = path / "generation_config.json"
    if gen_path.exists():
        data = _read_json(gen_path)
        generation = GenerationSettings.from_dict(
            data, bool(data.get("_from_model_config", False)))
    else:
        generation = GenerationSettings.from_dict(config, True)
    pre_path = path / "preprocessor_config.json"
    preprocessor = _read_json(pre_path) if pre_path.exists() else {}
    return WhisperCheckpoint(
        config=config, dims=WhisperDims.from_config(config),
        generation=generation, preprocessor=preprocessor,
        state_dict=read_weights(path, device),
    )

