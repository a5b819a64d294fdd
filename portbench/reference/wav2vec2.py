"""Plain reference of wav2vec 2.0 with a CTC head (Baevski et al. 2020;
``Wav2Vec2ForCTC`` in its large "stable layer norm" layout), in float32
PyTorch with TF32 off, written from the published description over a
checkpoint's own tensor names. It reads the checkpoint's files itself and
imports nothing of the program, of JAX or of ``transformers``.

The waveform (int16-scaled samples) is scaled to [-1, 1) and, with
``do_normalize``, shifted to zero mean and scaled to unit variance
(population variance plus 1e-7, in float64); each convolution of the
feature encoder is followed by a LayerNorm over its channels and GELU;
the last one's output is LayerNormed and projected to the model width
(the "frontend"); a grouped convolution over the frames, whose weight is
``g * v / ||v||`` with the norm over every dimension but the last, gives
the positions (padding of half its taps each side, the trailing frame
dropped, GELU), added to the frontend; each block is x + attention(LN(x))
then x + FFN(LN(x)); a final LayerNorm; a linear head; log-softmax. Greedy
CTC text: each frame's best character, runs read once, the blank
``<pad>`` dropped, ``|`` a space, stripped.

``forward(..., tf32=True)`` is the control: the same reference with TF32
tensor-core products and convolutions, the step below the float32 the
configuration states."""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

NORMS = (("weight_g", "weight_v"),
         ("parametrizations.weight.original0", "parametrizations.weight.original1"))


def positional_weight(w: Dict[str, torch.Tensor], p: str) -> torch.Tensor:
    for gain, direction in NORMS:
        if p + gain in w:
            g, v = w[p + gain], w[p + direction]
            return g * v / torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))
    return w[p + "weight"]


def forward(w: Dict[str, torch.Tensor], cfg: dict, samples: np.ndarray,
            do_normalize: bool = True, tf32: bool = False) -> Dict[str, torch.Tensor]:
    """``{"frontend": (T, hidden), "log_probs": (T, vocab)}`` of one
    utterance. ``w`` holds the checkpoint's float32 tensors under their
    stored names, on the device to run on."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _forward(w, cfg, samples, do_normalize)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _ln(x, w, p, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], w[p + ".weight"], w[p + ".bias"], eps)


def _lin(x, w, p):
    return x @ w[p + ".weight"].T + w[p + ".bias"]


def _forward(w, cfg, samples, do_normalize):
    dev = next(iter(w.values())).device
    x = np.asarray(samples, np.float64) / 32768.0
    if do_normalize:
        x = (x - x.mean()) / np.sqrt(x.var() + 1e-7)
    x = torch.tensor(x, dtype=torch.float32, device=dev)[None, None]
    eps = cfg.get("layer_norm_eps", 1e-5)
    for i, stride in enumerate(cfg["conv_stride"]):
        p = f"wav2vec2.feature_extractor.conv_layers.{i}"
        x = F.conv1d(x, w[p + ".conv.weight"], w.get(p + ".conv.bias"), stride=stride)
        x = F.gelu(_ln(x[0].T, w, p + ".layer_norm").T[None])
    h = _lin(_ln(x[0].T, w, "wav2vec2.feature_projection.layer_norm", eps), w,
             "wav2vec2.feature_projection.projection")
    frontend = h
    taps, groups = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    p = "wav2vec2.encoder.pos_conv_embed.conv."
    pos = F.conv1d(h.T[None], positional_weight(w, p), w[p + "bias"], padding=taps // 2,
                   groups=groups)[0]
    if taps % 2 == 0:
        pos = pos[:, :-1]
    h = h + F.gelu(pos.T)
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = d // heads
    T = h.shape[0]
    for i in range(cfg["num_hidden_layers"]):
        p = f"wav2vec2.encoder.layers.{i}"
        a = _ln(h, w, p + ".layer_norm", eps)
        q = _lin(a, w, p + ".attention.q_proj").view(T, heads, hd).transpose(0, 1)
        k = _lin(a, w, p + ".attention.k_proj").view(T, heads, hd).transpose(0, 1)
        v = _lin(a, w, p + ".attention.v_proj").view(T, heads, hd).transpose(0, 1)
        s = (q @ k.transpose(1, 2)) / math.sqrt(hd)
        o = (s.softmax(-1) @ v).transpose(0, 1).reshape(T, d)
        h = h + _lin(o, w, p + ".attention.out_proj")
        f = _ln(h, w, p + ".final_layer_norm", eps)
        f = _lin(F.gelu(_lin(f, w, p + ".feed_forward.intermediate_dense")), w,
                 p + ".feed_forward.output_dense")
        h = h + f
    h = _ln(h, w, "wav2vec2.encoder.layer_norm", eps)
    return {"frontend": frontend, "log_probs": F.log_softmax(_lin(h, w, "lm_head"), -1)}


def read_weights(directory: Path, device) -> Dict[str, torch.Tensor]:
    """The float32 safetensors file's tensors on ``device``."""
    path = Path(directory) / "model.safetensors"
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        a, b = info["data_offsets"]
        arr = np.frombuffer(data[a:b], dtype=np.float32).reshape(info["shape"])
        out[name] = torch.from_numpy(arr.copy()).to(device)
    return out


class Model:
    """A checkpoint directory's weights, settings and vocabulary."""

    def __init__(self, directory: Path, device):
        directory = Path(directory)
        self.w = read_weights(directory, device)
        self.cfg = json.loads((directory / "config.json").read_text())
        pre = json.loads((directory / "preprocessor_config.json").read_text())
        self.do_normalize = bool(pre.get("do_normalize", True))
        vocab = json.loads((directory / "vocab.json").read_text())
        self.chars = {i: c for c, i in vocab.items()}

    def __call__(self, samples: np.ndarray, tf32: bool = False) -> Dict[str, torch.Tensor]:
        return forward(self.w, self.cfg, samples, self.do_normalize, tf32)

    def text(self, ids: List[int]) -> str:
        """The greedy CTC text of frame ids, lowercased."""
        out, last = [], None
        for i in ids:
            if i != last:
                c = self.chars.get(i, "<unk>")
                if c != "<pad>":
                    out.append(" " if c == "|" else c)
            last = i
        return "".join(out).strip().lower()
