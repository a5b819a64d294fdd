"""Whisper's encoder and decoder as PyTorch modules.

Counterpart of ``WhisperForConditionalGeneration`` (``transformers``
``models/whisper/modeling_whisper.py``), inference only, with the same
parameter names so a checkpoint's state dict loads as it is. The encoder
is two convolutions with GELU, the stored (sinusoidal) positions, pre-LN
self-attention blocks and a final LayerNorm; the decoder adds learned
positions to the token embeddings, runs pre-LN blocks of causal
self-attention (with a key/value cache), cross-attention to the encoder
(its keys and values computed once an utterance) and a feed-forward
layer, and takes its logits from the token embedding. The cache either
grows by a concatenation a step (:meth:`Decoder.forward`) or is a
:class:`StaticCache` preallocated at ``max_target_positions``, written in
place at a position held on the device (:meth:`Decoder.step`), so a step
has one shape for each attention length and a CUDA graph can hold it.
Attention is ``F.scaled_dot_product_attention`` on queries scaled before the product,
as the reference's SDPA path computes it; float32 throughout, with TF32
off (set at the package's import).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from montreal_forced_aligner_tpu_torch.transcription.whisper.checkpoint import (
    WhisperDims,
)

KV = Tuple[torch.Tensor, torch.Tensor]


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> torch.Tensor:
    """The encoder's positions as Whisper makes them (sin half, cos half);
    a checkpoint stores them as ``model.encoder.embed_positions.weight``."""
    increment = math.log(max_timescale) / (channels // 2 - 1)
    inv = torch.exp(-increment * torch.arange(channels // 2, dtype=torch.float32))
    scaled = torch.arange(length, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cat([scaled.sin(), scaled.cos()], dim=1)


class Attention(nn.Module):
    """Multi-head attention with biased query, value and output projections;
    the key projection has a bias only with ``key_bias`` (Whisper's has
    none, wav2vec 2.0's has one)."""

    def __init__(self, d_model: int, heads: int, key_bias: bool = False):
        super().__init__()
        self.heads = heads
        self.head_dim = d_model // heads
        if self.head_dim * heads != d_model:
            raise ValueError(f"d_model {d_model} is not divisible by {heads} heads")
        self.scaling = self.head_dim ** -0.5
        self.k_proj = nn.Linear(d_model, d_model, bias=key_bias)
        self.v_proj = nn.Linear(d_model, d_model)
        self.q_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.view(b, t, self.heads, self.head_dim).transpose(1, 2).contiguous()

    def project_kv(self, x: torch.Tensor) -> KV:
        return self._split(self.k_proj(x)), self._split(self.v_proj(x))

    def forward(self, x: torch.Tensor, kv: KV, causal: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask`` (boolean, broadcast over the scores) marks the keys
        attended to."""
        b, t, _ = x.shape
        q = self._split(self.q_proj(x) * self.scaling)
        out = F.scaled_dot_product_attention(q, kv[0], kv[1], attn_mask=mask, scale=1.0,
                                             is_causal=causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, -1))


def _ffn(layer, x: torch.Tensor) -> torch.Tensor:
    return x + layer.fc2(F.gelu(layer.fc1(layer.final_layer_norm(x))))


class EncoderLayer(nn.Module):
    """A pre-LN block of bidirectional self-attention and a GELU
    feed-forward layer: Whisper's encoder block, and with ``key_bias``
    wav2vec 2.0's "stable layer norm" block (:mod:`..wav2vec2.model`)."""

    def __init__(self, d_model: int, heads: int, ffn_dim: int, key_bias: bool = False):
        super().__init__()
        self.self_attn = Attention(d_model, heads, key_bias)
        self.self_attn_layer_norm = nn.LayerNorm(d_model)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)
        self.final_layer_norm = nn.LayerNorm(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.self_attn_layer_norm(x)
        x = x + self.self_attn(h, self.self_attn.project_kv(h))
        return _ffn(self, x)


class DecoderLayer(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims.d_model
        self.self_attn = Attention(d, dims.decoder_attention_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d)
        self.encoder_attn = Attention(d, dims.decoder_attention_heads)
        self.encoder_attn_layer_norm = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, dims.decoder_ffn_dim)
        self.fc2 = nn.Linear(dims.decoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d)

    def forward(self, x: torch.Tensor, past: Optional[KV], cross: KV
                ) -> Tuple[torch.Tensor, KV]:
        h = self.self_attn_layer_norm(x)
        k, v = self.self_attn.project_kv(h)
        if past is not None:
            k, v = torch.cat([past[0], k], dim=-2), torch.cat([past[1], v], dim=-2)
        x = x + self.self_attn(h, (k, v), causal=past is None and x.shape[1] > 1)
        return self._rest(x, cross), (k, v)

    def step(self, x: torch.Tensor, pos: torch.Tensor, cache: KV, length: int,
             mask: torch.Tensor, cross: KV) -> torch.Tensor:
        """One token at device position ``pos``: its key and value written
        into the layer's static ``cache`` there, attention over the first
        ``length`` positions under ``mask``."""
        h = self.self_attn_layer_norm(x)
        k, v = self.self_attn.project_kv(h)
        cache[0].index_copy_(2, pos, k)
        cache[1].index_copy_(2, pos, v)
        x = x + self.self_attn(h, (cache[0][:, :, :length], cache[1][:, :, :length]),
                               mask=mask)
        return self._rest(x, cross)

    def _rest(self, x: torch.Tensor, cross: KV) -> torch.Tensor:
        """Cross-attention and the feed-forward layer."""
        x = x + self.encoder_attn(self.encoder_attn_layer_norm(x), cross)
        return _ffn(self, x)


class Encoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims.d_model
        self.conv1 = nn.Conv1d(dims.num_mel_bins, d, kernel_size=3, padding=1)
        self.conv2 = nn.Conv1d(d, d, kernel_size=3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(dims.max_source_positions, d)
        self.layers = nn.ModuleList(
            EncoderLayer(d, dims.encoder_attention_heads, dims.encoder_ffn_dim)
            for _ in range(dims.encoder_layers))
        self.layer_norm = nn.LayerNorm(d)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """(B, num_mel_bins, 2 * max_source_positions) log-mel ->
        (B, max_source_positions, d_model)."""
        expected = 2 * self.embed_positions.num_embeddings
        if features.shape[-1] != expected:
            raise ValueError(f"Whisper expects {expected} mel frames, got "
                             f"{features.shape[-1]}")
        x = F.gelu(self.conv1(features))
        x = F.gelu(self.conv2(x)).permute(0, 2, 1)
        x = x + self.embed_positions.weight
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x)


class Decoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims.d_model
        self.embed_tokens = nn.Embedding(dims.vocab_size, d, dims.pad_token_id)
        self.embed_positions = nn.Embedding(dims.max_target_positions, d)
        self.layers = nn.ModuleList(DecoderLayer(dims) for _ in range(dims.decoder_layers))
        self.layer_norm = nn.LayerNorm(d)

    def cross_kv(self, encoded: torch.Tensor) -> List[KV]:
        """Each layer's cross-attention keys and values of one encoding."""
        return [layer.encoder_attn.project_kv(encoded) for layer in self.layers]

    def forward(self, ids: torch.Tensor, cross: List[KV],
                past: Optional[List[KV]] = None) -> Tuple[torch.Tensor, List[KV]]:
        """(B, T) token ids after the ``past`` ones -> (B, T, d_model) final
        states and the extended cache."""
        start = 0 if past is None else past[0][0].shape[-2]
        end = start + ids.shape[1]
        if end > self.embed_positions.num_embeddings:
            raise ValueError(f"decoder position {end - 1} is past the model's "
                             f"{self.embed_positions.num_embeddings} positions")
        x = self.embed_tokens(ids) + self.embed_positions.weight[start:end]
        cache = []
        for i, layer in enumerate(self.layers):
            x, kv = layer(x, None if past is None else past[i], cross[i])
            cache.append(kv)
        return self.layer_norm(x), cache

    def step(self, cache: "StaticCache", length: int) -> torch.Tensor:
        """The token ``cache.ids`` at position ``cache.pos`` (both on the
        device) -> (1, 1, d_model) final state, its keys and values written
        into ``cache``; self-attention reads the first ``length`` positions,
        those after ``pos`` masked out. Nothing here waits on the card or
        reads a device value on the host."""
        pos = cache.pos
        x = self.embed_tokens(cache.ids) + self.embed_positions.weight.index_select(0, pos)
        mask = (cache.positions[:length] <= pos).view(1, 1, 1, length)
        for layer, kv, cross in zip(self.layers, cache.self_kv, cache.cross):
            x = layer.step(x, pos, kv, length, mask, cross)
        return self.layer_norm(x)

    def logits(self, states: torch.Tensor) -> torch.Tensor:
        """The output projection, tied to the token embedding."""
        return F.linear(states, self.embed_tokens.weight)


class StaticCache:
    """One row's decoder state at fixed addresses: each layer's
    self-attention keys and values at full size, (1, heads,
    ``max_target_positions``, head_dim), the window's cross-attention keys
    and values, the token id and its position. Float32 zeros at first, so
    a masked position holds a finite value (a masked key's weight is
    exactly 0, and 0 times a finite value is 0)."""

    def __init__(self, dims: WhisperDims, device):
        heads = dims.decoder_attention_heads
        head_dim = dims.d_model // heads

        def pairs(length):
            shape = (1, heads, length, head_dim)
            return [(torch.zeros(shape, device=device), torch.zeros(shape, device=device))
                    for _ in range(dims.decoder_layers)]

        self.self_kv = pairs(dims.max_target_positions)
        self.cross = pairs(dims.max_source_positions)
        self.positions = torch.arange(dims.max_target_positions, device=device)
        self.ids = torch.zeros((1, 1), dtype=torch.long, device=device)
        self.pos = torch.zeros(1, dtype=torch.long, device=device)

    def load(self, cross: List[KV], prompt: List[KV]) -> None:
        """A window's cross keys and values, and its prompt's
        self-attention keys and values at positions 0 to p - 1."""
        for (k, v), (ck, cv) in zip(cross, self.cross):
            ck.copy_(k)
            cv.copy_(v)
        for (k, v), (sk, sv) in zip(prompt, self.self_kv):
            n = k.shape[-2]
            sk[:, :, :n].copy_(k)
            sv[:, :, :n].copy_(v)


class WhisperCore(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        self.encoder = Encoder(dims)
        self.decoder = Decoder(dims)


class Whisper(nn.Module):
    """Encoder, decoder and the tied output projection; ``state_dict``
    keys are the checkpoint's (``model.encoder...``, ``model.decoder...``)."""

    def __init__(self, dims: WhisperDims):
        super().__init__()
        if dims.activation_function != "gelu":
            raise NotImplementedError(
                f"activation {dims.activation_function!r}: only Whisper's "
                "'gelu' is supported")
        self.dims = dims
        self.model = WhisperCore(dims)

    def encode(self, features: torch.Tensor) -> torch.Tensor:
        return self.model.encoder(features)

    def logits(self, states: torch.Tensor) -> torch.Tensor:
        return self.model.decoder.logits(states)

    @classmethod
    def from_weights(cls, dims: WhisperDims, state_dict) -> "Whisper":
        """The model holding a checkpoint's float32 tensors themselves (built
        on the meta device, so nothing is initialised first); a stored
        ``proj_out.weight`` is the tied embedding and is not loaded."""
        with torch.device("meta"):
            model = cls(dims)
        weights = {k: v for k, v in state_dict.items() if k != "proj_out.weight"}
        model.load_state_dict(weights, strict=True, assign=True)
        return model.eval()
