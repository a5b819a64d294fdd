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


# GenerationConfig's own attributes that greedy Whisper decoding reads; a
# generation config made from the model config (``_from_model_config``)
# keeps only these, as ``GenerationConfig.__init__`` drops other keys then
_STANDARD_KEYS = ("decoder_start_token_id", "eos_token_id", "pad_token_id",
                  "max_length", "max_new_tokens", "suppress_tokens",
                  "begin_suppress_tokens", "forced_decoder_ids")
# Whisper's own generation keys
_WHISPER_KEYS = ("lang_to_id", "task_to_id", "is_multilingual",
                 "no_timestamps_token_id", "return_timestamps", "language",
                 "task", "condition_on_prev_tokens", "num_beams",
                 "force_unique_generate_call")
# GenerationConfig's default length: ``generate`` adds the prompt's length
# to it when it is left at this value
DEFAULT_MAX_LENGTH = 20


@dataclass
class GenerationSettings:
    """What ``generation_config.json`` sets for greedy decoding. A Whisper
    key the file does not set is None (``hasattr`` false in the
    reference)."""

    decoder_start_token_id: Optional[int] = None
    eos_token_id: object = None
    pad_token_id: Optional[int] = None
    max_length: int = DEFAULT_MAX_LENGTH
    max_new_tokens: Optional[int] = None
    suppress_tokens: Optional[List[int]] = None
    begin_suppress_tokens: Optional[List[int]] = None
    forced_decoder_ids: Optional[list] = None
    lang_to_id: Optional[Dict[str, int]] = None
    task_to_id: Optional[Dict[str, int]] = None
    is_multilingual: Optional[bool] = None
    no_timestamps_token_id: Optional[int] = None
    return_timestamps: Optional[bool] = None
    language: Optional[str] = None
    task: Optional[str] = None
    condition_on_prev_tokens: Optional[bool] = None
    num_beams: Optional[int] = None
    force_unique_generate_call: Optional[bool] = None

    @classmethod
    def from_dict(cls, data: dict, from_model_config: bool) -> "GenerationSettings":
        keys = _STANDARD_KEYS if from_model_config else _STANDARD_KEYS + _WHISPER_KEYS
        kw = {k: data[k] for k in keys if data.get(k) is not None}
        return cls(**kw)


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


def read_weights(path: Path, device="cpu") -> Dict[str, torch.Tensor]:
    """The checkpoint's tensors on ``device`` cast to float32 (moved in
    their stored dtype, then cast there), from ``model.safetensors``, its
    sharded index, or ``pytorch_model.bin``."""
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
    device = torch.device(device)
    out = {}
    for k, v in tensors.items():
        v = v.to(device, copy=True)
        out[k] = v.to(torch.float32) if v.is_floating_point() else v
    return out


def load_checkpoint(path, device="cpu") -> WhisperCheckpoint:
    """Read a checkpoint directory, its weights onto ``device``. Without
    ``generation_config.json`` the generation settings come from
    ``config.json``, as ``GenerationConfig.from_model_config`` makes them."""
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

