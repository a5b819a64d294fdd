"""wav2vec 2.0 with a CTC head as a PyTorch module.

Counterpart of ``Wav2Vec2ForCTC`` (``transformers``
``models/wav2vec2/modeling_wav2vec2.py``; Baevski et al. 2020) in the
large models' layout (``feat_extract_norm: "layer"``,
``do_stable_layer_norm: true``), inference only, one unpadded utterance a
call. The raw waveform, scaled to [-1, 1) and normalised to zero mean and
unit variance when the preprocessor asks, passes a stack of strided
convolutions (each followed by a LayerNorm over channels and GELU), a
LayerNorm and a linear projection to the model width, a grouped
convolutional positional embedding (trailing frame dropped, GELU, added),
pre-LN transformer blocks (Whisper's :class:`..whisper.model.EncoderLayer`
with a key bias), a final LayerNorm, and a linear head over the CTC
characters. Float32 throughout, with TF32 off for products and cuDNN's
convolutions (set at the package's import).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from montreal_forced_aligner_tpu_torch.transcription.wav2vec2.checkpoint import (
    Wav2Vec2Dims,
)
from montreal_forced_aligner_tpu_torch.transcription.whisper.model import EncoderLayer

INT16_SCALE = 32768.0
NORMALIZE_EPS = 1e-7  # ``Wav2Vec2FeatureExtractor.zero_mean_unit_var_norm``


def normalize(wave: torch.Tensor) -> torch.Tensor:
    """Zero mean and unit variance over the utterance (population
    variance, 1e-7 added before the root)."""
    return (wave - wave.mean()) / torch.sqrt(wave.var(correction=0) + NORMALIZE_EPS)


class ConvLayer(nn.Module):
    """A strided convolution, LayerNorm over its channels, then GELU."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, bias: bool):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride, bias=bias)
        self.layer_norm = nn.LayerNorm(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(self.conv(x).transpose(1, 2)).transpose(1, 2)
        return F.gelu(x)


class FeatureEncoder(nn.Module):
    def __init__(self, dims: Wav2Vec2Dims):
        super().__init__()
        c_in = (1,) + dims.conv_dim[:-1]
        self.conv_layers = nn.ModuleList(
            ConvLayer(a, b, k, s, dims.conv_bias)
            for a, b, k, s in zip(c_in, dims.conv_dim, dims.conv_kernel, dims.conv_stride))

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        """(B, samples) -> (B, conv_dim[-1], frames)."""
        x = wave[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, dims: Wav2Vec2Dims):
        super().__init__()
        self.layer_norm = nn.LayerNorm(dims.conv_dim[-1], eps=dims.layer_norm_eps)
        self.projection = nn.Linear(dims.conv_dim[-1], dims.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class Encoder(nn.Module):
    def __init__(self, dims: Wav2Vec2Dims):
        super().__init__()
        d, taps = dims.hidden_size, dims.num_conv_pos_embeddings
        self.pos_conv = nn.Conv1d(d, d, taps, padding=taps // 2,
                                  groups=dims.num_conv_pos_embedding_groups)
        # an even number of taps gives one frame more than it reads
        self.pos_trim = 1 if taps % 2 == 0 else 0
        self.layers = nn.ModuleList(
            EncoderLayer(d, dims.num_attention_heads, dims.intermediate_size, key_bias=True)
            for _ in range(dims.num_hidden_layers))
        self.layer_norm = nn.LayerNorm(d, eps=dims.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, hidden) projected features -> (B, T, hidden) states."""
        pos = self.pos_conv(x.transpose(1, 2))
        if self.pos_trim:
            pos = pos[:, :, :-self.pos_trim]
        x = x + F.gelu(pos).transpose(1, 2)
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x)


class Wav2Vec2ForCTC(nn.Module):
    """The model; ``state_dict`` keys are the port's names of the
    checkpoint's tensors (:func:`..checkpoint.port_state_dict`)."""

    def __init__(self, dims: Wav2Vec2Dims, do_normalize: bool = True):
        super().__init__()
        self.dims = dims
        self.do_normalize = do_normalize
        self.feature_extractor = FeatureEncoder(dims)
        self.feature_projection = FeatureProjection(dims)
        self.encoder = Encoder(dims)
        self.lm_head = nn.Linear(dims.hidden_size, dims.vocab_size)

    def extract(self, samples: torch.Tensor) -> torch.Tensor:
        """(samples,) int16-scaled float32 audio at the model's rate ->
        (1, T, hidden) projected features: scaled to [-1, 1), normalised
        when the preprocessor asks, the convolutions and the projection."""
        wave = samples / INT16_SCALE
        if self.do_normalize:
            wave = normalize(wave)
        feats = self.feature_extractor(wave[None])
        return self.feature_projection(feats.transpose(1, 2))

    def encode(self, features: torch.Tensor) -> torch.Tensor:
        return self.encoder(features)

    def log_probs(self, states: torch.Tensor) -> torch.Tensor:
        """(1, T, hidden) -> (T, vocab) log-softmax of the CTC head."""
        return F.log_softmax(self.lm_head(states[0]), dim=-1)

    @classmethod
    def from_weights(cls, dims: Wav2Vec2Dims, state_dict: Dict[str, torch.Tensor],
                     do_normalize: bool = True) -> "Wav2Vec2ForCTC":
        """The model holding the checkpoint's float32 tensors themselves
        (built on the meta device, so nothing is initialised first)."""
        with torch.device("meta"):
            model = cls(dims, do_normalize)
        model.load_state_dict(state_dict, strict=True, assign=True)
        return model.eval()
