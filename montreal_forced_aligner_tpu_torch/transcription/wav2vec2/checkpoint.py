"""Read a local Hugging Face ``Wav2Vec2ForCTC`` checkpoint directory.

The directory is what ``Wav2Vec2ForCTC.save_pretrained`` and
``Wav2Vec2Processor.save_pretrained`` write: ``config.json``
(``model_type: wav2vec2``), the weights as ``model.safetensors`` (or a
sharded index, or ``pytorch_model.bin``), ``vocab.json`` (the CTC
characters; ``<pad>`` is the blank) and ``preprocessor_config.json``
(``do_normalize``, ``sampling_rate``). The weights are read by Whisper's
reader (:func:`..whisper.checkpoint.read_weights`, float32 on the device)
and renamed to :class:`..model.Wav2Vec2ForCTC`'s names: each encoder block
to :class:`..whisper.model.EncoderLayer`'s, and the positional
convolution's weight norm (``weight_g``/``weight_v``, or the newer
``parametrizations.weight.original0``/``original1``) folded into one
weight.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Tuple

import torch

from montreal_forced_aligner_tpu_torch.device import resolve_device
from montreal_forced_aligner_tpu_torch.transcription.whisper.checkpoint import read_weights

PREFIX = "wav2vec2."
POS_CONV = "encoder.pos_conv_embed.conv."
# weight-norm parameter names: (gain, direction), old and new layouts
WEIGHT_NORM_NAMES = (("weight_g", "weight_v"),
                     ("parametrizations.weight.original0",
                      "parametrizations.weight.original1"))
# a stable-layer-norm block's names -> the shared encoder block's
BLOCK_NAMES = {
    "attention.": "self_attn.",
    "layer_norm.": "self_attn_layer_norm.",
    "feed_forward.intermediate_dense.": "fc1.",
    "feed_forward.output_dense.": "fc2.",
    "final_layer_norm.": "final_layer_norm.",
}
# stored for pre-training's masking only
UNUSED = ("masked_spec_embed",)


@dataclass(frozen=True)
class Wav2Vec2Dims:
    """The model's shapes and choices (``config.json``; missing keys take
    ``Wav2Vec2Config``'s defaults)."""

    vocab_size: int = 32
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    feat_extract_norm: str = "group"
    feat_extract_activation: str = "gelu"
    hidden_act: str = "gelu"
    do_stable_layer_norm: bool = False
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 0

    @classmethod
    def from_config(cls, config: dict) -> "Wav2Vec2Dims":
        kw = {k: config[k] for k in cls.__dataclass_fields__ if k in config}
        for k in ("conv_dim", "conv_kernel", "conv_stride"):
            if k in kw:
                kw[k] = tuple(kw[k])
        return cls(**kw)

    def check(self) -> None:
        """Raise for a variant the port does not run: the published
        large ("stable layer norm") layout is the one it implements."""
        wanted = {"feat_extract_norm": "layer", "feat_extract_activation": "gelu",
                  "hidden_act": "gelu", "do_stable_layer_norm": True,
                  "layer_norm_eps": 1e-5}
        for key, value in wanted.items():
            if getattr(self, key) != value:
                raise NotImplementedError(
                    f"wav2vec2 {key}={getattr(self, key)!r}: only {value!r} "
                    "(the large models' stable-layer-norm layout) is supported")
        if not len(self.conv_dim) == len(self.conv_kernel) == len(self.conv_stride):
            raise ValueError("conv_dim, conv_kernel and conv_stride differ in length")


@dataclass
class Wav2Vec2Checkpoint:
    dims: Wav2Vec2Dims
    vocab: Dict[str, int]
    preprocessor: dict
    state_dict: Dict[str, torch.Tensor] = field(repr=False)


def _read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def is_ctc_checkpoint(path) -> bool:
    """Whether ``path`` is a directory with a wav2vec 2.0 ``config.json``."""
    config = Path(path) / "config.json"
    if not config.is_file():
        return False
    try:
        return _read_json(config).get("model_type") == "wav2vec2"
    except (OSError, ValueError):
        return False


def fold_weight_norm(gain: torch.Tensor, direction: torch.Tensor, dim: int) -> torch.Tensor:
    """``direction * (gain / ||direction||)``, the norm taken over every
    dimension but ``dim`` (``torch.nn.utils.weight_norm``'s weight)."""
    others = [d for d in range(direction.dim()) if d != dim]
    return direction * (gain / direction.norm(dim=others, keepdim=True))


def port_state_dict(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A checkpoint's tensors under the port's names, the positional
    convolution's weight folded over dim 2."""
    out = {}
    for name, value in weights.items():
        key = name[len(PREFIX):] if name.startswith(PREFIX) else name
        if key in UNUSED:
            continue
        if key.startswith("encoder.layers."):
            i, rest = key[len("encoder.layers."):].split(".", 1)
            for old, new in BLOCK_NAMES.items():
                if rest.startswith(old):
                    rest = new + rest[len(old):]
                    break
            key = f"encoder.layers.{i}.{rest}"
        out[key] = value
    for gain, direction in WEIGHT_NORM_NAMES:
        g, v = POS_CONV + gain, POS_CONV + direction
        if g in out and v in out:
            out[POS_CONV + "weight"] = fold_weight_norm(out.pop(g), out.pop(v), dim=2)
    return {("encoder.pos_conv." + k[len(POS_CONV):] if k.startswith(POS_CONV) else k): v
            for k, v in out.items()}


def load_checkpoint(path, device="cuda") -> Wav2Vec2Checkpoint:
    """Read a checkpoint directory, its weights onto ``device`` (the card
    unless the CPU is asked for; without a card that raises)."""
    device = resolve_device(device)
    path = Path(path)
    dims = Wav2Vec2Dims.from_config(_read_json(path / "config.json"))
    dims.check()
    pre_path = path / "preprocessor_config.json"
    preprocessor = _read_json(pre_path) if pre_path.exists() else {}
    return Wav2Vec2Checkpoint(
        dims=dims, vocab=_read_json(path / "vocab.json"),
        preprocessor=preprocessor,
        state_dict=port_state_dict(read_weights(path, device)),
    )
