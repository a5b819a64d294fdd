"""Operations and bytes that one wav2vec 2.0 CTC utterance needs, from its
sample count and the configuration: 2 x the multiply-adds of the real
frames only (each convolution at its own output length, the projections,
the positional convolution, attention at the utterance's own length, the
feed-forward layers and the head), the weights read once an utterance
and the part's input read and output written once, all in float32.
LayerNorms, GELUs and the softmax are not counted."""

from __future__ import annotations

from portbench.work.counts import F32, Work

__all__ = ["Work", "conv_lengths", "ctc_head", "encoder", "feature_encoder", "frames"]


def conv_lengths(cfg: dict, samples: int) -> list:
    """Each feature-encoder convolution's output length, unpadded."""
    out = []
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        samples = (samples - k) // s + 1
        out.append(samples)
    return out


def frames(cfg: dict, samples: int) -> int:
    return conv_lengths(cfg, samples)[-1]


def feature_encoder(cfg: dict, samples: int) -> Work:
    """The convolutions (each with its bias and LayerNorm) and the
    feature projection (LayerNorm and linear): the samples read, the
    projected features written."""
    c_in, macs, weights = 1, 0, 0
    for c, k, n in zip(cfg["conv_dim"], cfg["conv_kernel"], conv_lengths(cfg, samples)):
        macs += n * c * c_in * k
        weights += c * c_in * k + (c if cfg["conv_bias"] else 0) + 2 * c
        c_in = c
    d, t = cfg["hidden_size"], frames(cfg, samples)
    macs += t * c_in * d
    weights += 2 * c_in + c_in * d + d
    return Work(2.0 * macs, float((weights + samples + t * d) * F32))


def encoder(cfg: dict, t: int) -> Work:
    """The positional convolution over the ``t`` real frames, each block
    (four projections, scores and mix over ``t`` keys, feed-forward) and the
    final LayerNorm: the projected features read, the states written."""
    d, ffn, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    taps, groups = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    macs = t * d * (d // groups) * taps
    macs += layers * (4 * t * d * d + 2 * t * t * d + 2 * t * d * ffn)
    weights = d * (d // groups) * taps + d
    weights += layers * (4 * (d * d + d) + 2 * d * ffn + ffn + d + 4 * d) + 2 * d
    return Work(2.0 * macs, float((weights + 2 * t * d) * F32))


def ctc_head(cfg: dict, t: int) -> Work:
    """The linear head over the characters: the states read, the
    log-probabilities written."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    return Work(2.0 * t * d * v, float((d * v + v + t * d + t * v) * F32))
