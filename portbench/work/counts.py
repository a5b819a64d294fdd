"""Operations and bytes that the inputs need, from their shapes: each
input byte read once, each output byte written once, no padding and no
implementation's repeats."""

from __future__ import annotations

from dataclasses import dataclass

F32 = 4
F16 = 2


@dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes}


def mfcc_frames(samples: int, shift: int = 160) -> int:
    """Kaldi's frame count with ``--snip-edges=false``."""
    return (samples + shift // 2) // shift


def k3(frames: int, pdfs: int, gauss: int, dim: int) -> Work:
    """K3 (emissions of a row's graph states): for each real frame and each
    distinct pdf of the row's graph, G x (4D + 2) operations (the
    quadratic form's 2D multiply-adds, two operations each as the peak
    counts them, the constant and the log-sum-exp's step); the frames'
    features and the used pdfs' rows (G x (2D + 1) floats) read once, one
    float32 emission a (frame, pdf) written."""
    flops = frames * pdfs * gauss * (4 * dim + 2)
    nbytes = (frames * dim + pdfs * gauss * (2 * dim + 1) + frames * pdfs) * F32
    return Work(float(flops), float(nbytes))


def k1(frames: int, states: int, arcs: int) -> Work:
    """K1 (the Viterbi forward pass of a row): 2 operations (add, max) per
    real arc and step; the real frames' emissions of the real states read,
    one backpointer byte per real state and step written."""
    steps = max(frames - 1, 0)
    return Work(2.0 * arcs * steps, float(frames * states * F32 + states * steps))


def whisper_encoder(d: int, layers: int, ffn: int, mels: int, positions: int) -> Work:
    """One encoder call: 2 x its multiply-adds over ``positions`` (the two
    convolutions over 2 x positions mel frames, each layer's four
    projections, attention scores and mix, and feed-forward); the weights
    read once at their stored float16 size, the log-mel read and the
    encoding written in float32."""
    frames = 2 * positions
    macs = frames * d * mels * 3 + positions * d * d * 3
    per_layer = 4 * positions * d * d + 2 * positions * positions * d + 2 * positions * d * ffn
    macs += layers * per_layer
    weights = d * mels * 3 + d * d * 3 + layers * (4 * d * d + 2 * d * ffn)
    nbytes = weights * F16 + (mels * frames + positions * d) * F32
    return Work(2.0 * macs, float(nbytes))


def whisper_cross_kv(d: int, layers: int, positions: int) -> Work:
    """The decoder's cross-attention keys and values of one encoding."""
    macs = layers * 2 * positions * d * d
    nbytes = layers * (2 * d * d * F16 + 2 * positions * d * F32) + positions * d * F32
    return Work(2.0 * macs, float(nbytes))


def whisper_decoder_step(d: int, layers: int, ffn: int, vocab: int, positions: int,
                         past: int, tokens: int = 1) -> Work:
    """One decoder call on ``tokens`` new tokens after ``past`` cached ones:
    2 x multiply-adds (self-attention projections and attention over the
    cache, cross-attention over the encoder's ``positions``, feed-forward,
    the tied output projection of the last token); the weights read once
    at their stored float16 size, the self-attention cache and the
    cross-attention keys and values read once in float32."""
    ctx = past + tokens
    per_layer = (4 * tokens * d * d + 2 * tokens * ctx * d + 2 * tokens * d * d
                 + 2 * tokens * positions * d + 2 * tokens * d * ffn)
    macs = layers * per_layer + d * vocab
    weights = layers * (4 * d * d + 2 * d * d + 2 * d * ffn) + vocab * d
    cache = layers * (2 * ctx * d + 2 * positions * d) * F32
    return Work(2.0 * macs, float(weights * F16 + cache))
