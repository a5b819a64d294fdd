"""Plain reference of Whisper's transcription path, in float32 PyTorch with
TF32 off, from the published model (Radford et al. 2022; the Hugging Face
checkpoint layout): the log-mel front end, the encoder, the decoder run
once over a whole token sequence (no cache), the tied output projection,
and the generation config's suppressions. It reads the checkpoint's files
itself and imports nothing of the program.

``gaps(..., control=True)`` reads the control: the same reference with
TF32 tensor-core products, the step below the float32 the configuration
states."""

from __future__ import annotations

import json
import math
import struct
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def read_weights(directory: Path, device) -> Dict[str, torch.Tensor]:
    """The float16 safetensors file's tensors as float32 on ``device``."""
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
        arr = np.frombuffer(data[a:b], dtype=np.float16).reshape(info["shape"])
        out[name] = torch.from_numpy(arr.copy()).to(device, torch.float32)
    return out


@contextmanager
def precision(kind: str):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = kind == "tf32"
    torch.backends.cudnn.allow_tf32 = kind == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    mel = 3.0 * f / 200.0
    log_part = f >= 1000.0
    return np.where(log_part, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) * 27.0 / np.log(6.4), mel)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f = 200.0 * m / 3.0
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), f)


def mel_filters(n_mels: int, n_fft: int = 400, sr: int = 16000) -> np.ndarray:
    """(1 + n_fft // 2, n_mels) Slaney-scale triangles with Slaney's area
    normalisation, 0 to sr / 2."""
    freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2), n_mels + 2))
    out = np.zeros((len(freqs), n_mels))
    for i in range(n_mels):
        lo, c, hi = pts[i], pts[i + 1], pts[i + 2]
        up = (freqs - lo) / (c - lo)
        down = (hi - freqs) / (hi - c)
        out[:, i] = np.maximum(0.0, np.minimum(up, down)) * 2.0 / (hi - lo)
    return out


def log_mel(samples: np.ndarray, n_mels: int, device, n_samples: int = 480000) -> torch.Tensor:
    """(n_mels, 3000) log-mel of int16-scaled samples: cut or padded with
    zeros to 30 s, a centred 400-point Hann STFT every 160 samples (the
    last frame dropped), power, Slaney mel, log10 floored at 1e-10 and at
    8 below the maximum, then (x + 4) / 4."""
    x = np.zeros(n_samples, np.float32)
    s = np.asarray(samples, np.float32)[:n_samples] / 32768.0
    x[: len(s)] = s
    wave = torch.from_numpy(x).to(device)
    spec = torch.stft(wave, 400, 160, window=torch.hann_window(400, device=device),
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec[:, :-1].abs() ** 2
    fb = torch.from_numpy(mel_filters(n_mels)).to(device, torch.float32)
    logs = torch.clamp(fb.T @ power, min=1e-10).log10()
    logs = torch.maximum(logs, logs.max() - 8.0)
    return (logs + 4.0) / 4.0


class Model:
    def __init__(self, cfg: dict, directory: Path, device):
        self.cfg = cfg
        self.w = read_weights(directory, device)
        self.gen = json.loads((Path(directory) / "generation_config.json").read_text())

    def _ln(self, x, p):
        return F.layer_norm(x, x.shape[-1:], self.w[p + ".weight"], self.w[p + ".bias"])

    def _lin(self, x, p, bias=True):
        return F.linear(x, self.w[p + ".weight"], self.w.get(p + ".bias") if bias else None)

    def _attn(self, x, kv, p, heads, causal):
        d = x.shape[-1]
        hd = d // heads

        def split(t):
            return t.view(t.shape[0], heads, hd).transpose(0, 1)

        q = split(self._lin(x, p + ".q_proj")) * hd ** -0.5
        k = split(self._lin(kv, p + ".k_proj", bias=False))
        v = split(self._lin(kv, p + ".v_proj"))
        s = q @ k.transpose(1, 2)
        if causal:
            n = s.shape[-1]
            s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=s.device).triu(1),
                              -math.inf)
        o = (s.softmax(-1) @ v).transpose(0, 1).reshape(x.shape[0], d)
        return self._lin(o, p + ".out_proj")

    def _ffn(self, x, p):
        return self._lin(F.gelu(self._lin(self._ln(x, p + ".final_layer_norm"), p + ".fc1")),
                         p + ".fc2")

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(n_mels, 3000) -> (1500, d_model)."""
        w, cfg = self.w, self.cfg
        x = F.gelu(F.conv1d(mel[None], w["model.encoder.conv1.weight"],
                            w["model.encoder.conv1.bias"], padding=1))
        x = F.gelu(F.conv1d(x, w["model.encoder.conv2.weight"], w["model.encoder.conv2.bias"],
                            stride=2, padding=1))[0].T
        x = x + w["model.encoder.embed_positions.weight"]
        for i in range(cfg["encoder_layers"]):
            p = f"model.encoder.layers.{i}"
            h = self._ln(x, p + ".self_attn_layer_norm")
            x = x + self._attn(h, h, p + ".self_attn", cfg["encoder_attention_heads"], False)
            x = x + self._ffn(x, p)
        return self._ln(x, "model.encoder.layer_norm")

    def logits(self, enc: torch.Tensor, ids: List[int]) -> torch.Tensor:
        """(len(ids), vocab) logits after each token of ``ids``."""
        w, cfg = self.w, self.cfg
        t = torch.tensor(ids, device=enc.device)
        x = w["model.decoder.embed_tokens.weight"][t] + w["model.decoder.embed_positions.weight"][: len(ids)]
        heads = cfg["decoder_attention_heads"]
        for i in range(cfg["decoder_layers"]):
            p = f"model.decoder.layers.{i}"
            h = self._ln(x, p + ".self_attn_layer_norm")
            x = x + self._attn(h, h, p + ".self_attn", heads, True)
            x = x + self._attn(self._ln(x, p + ".encoder_attn_layer_norm"), enc,
                               p + ".encoder_attn", heads, False)
            x = x + self._ffn(x, p)
        x = self._ln(x, "model.decoder.layer_norm")
        return x @ w["model.decoder.embed_tokens.weight"].T

    def allowed(self, vocab: int, first: bool, device) -> torch.Tensor:
        """The tokens the generation config leaves at a step (its
        suppressed tokens; at a window's first step also the begin-
        suppressed ones)."""
        ok = torch.ones(vocab, dtype=torch.bool, device=device)
        ok[self.gen.get("suppress_tokens") or []] = False
        if first:
            ok[self.gen.get("begin_suppress_tokens") or []] = False
        return ok


def strip(tokens: List[int], gen: dict) -> List[int]:
    """A window's tokens without trailing padding and the final end of
    text (``generate_with_fallback``)."""
    pad, eos = gen.get("pad_token_id"), gen.get("eos_token_id")
    if tokens and tokens[-1] == pad:
        n = tokens.count(pad) - (1 if pad == eos else 0)
        if n:
            tokens = tokens[:-n]
    if tokens and tokens[-1] == eos:
        tokens = tokens[:-1]
    return tokens


def seek_after(tokens: List[int], gen: dict, frames: int = 3000) -> int:
    """Mel frames to move on after a window (``_retrieve_segment``): the
    whole window, unless a pair of timestamps ends a segment inside it and
    no single timestamp ends the window, in which case up to the last
    pair's first timestamp (two frames a timestamp step)."""
    tb = gen["no_timestamps_token_id"] + 1
    toks = strip(list(tokens), gen)
    is_ts = [t >= tb for t in toks]
    cuts = [i for i in range(len(toks) - 1) if is_ts[i] and is_ts[i + 1]]
    if not cuts or is_ts[-2:] == [False, True]:
        return frames
    return (toks[cuts[-1]] - tb) * 2


def gaps(model: Model, samples: np.ndarray, prompt: List[int], windows: List[List[int]],
         control: bool = False) -> dict:
    """The reference's readings of one decoded utterance, whose windows
    served ``windows`` (each window's tokens, end of text included) after
    ``prompt``: its log-mel, each window's encoding, and, over the served
    language token (among the languages) and every served token (among
    those the generation config allows), the widest gap by which the
    reference's logit of the served token lies below its best. With
    ``control`` the served token is the one the reference computed in
    TF32 puts first at each position of the same sequences."""
    cfg, gen = model.cfg, model.gen
    dev = next(iter(model.w.values())).device
    lang_ids = torch.tensor(sorted(gen["lang_to_id"].values()), device=dev)
    first = len(prompt) - 1

    def run(kind):
        with precision(kind):
            mel = log_mel(samples, cfg["num_mel_bins"], dev)
            encs, logits, seek = [], [], 0
            for tokens in windows:
                seg = mel[:, seek:seek + 3000]
                seg = F.pad(seg, (0, 3000 - seg.shape[1]))
                encs.append(model.encode(seg))
                logits.append(model.logits(encs[-1], list(prompt) + list(tokens)[:-1]))
                seek += seek_after(tokens, gen)
            return mel, encs, logits

    mel, encs, logits = run("float32")
    if control:
        c_mel, c_encs, c_logits = run("tf32")
    lang_row = logits[0][0, lang_ids]
    lang = prompt[1]
    if control:
        lang = int(lang_ids[c_logits[0][0, lang_ids].argmax()])
    where = (lang_ids == lang).nonzero()
    out = {"mel": mel, "encoders": encs,
           "control_mel": c_mel if control else None,
           "control_encoders": c_encs if control else None,
           "token_gap": float(lang_row.max() - lang_row[where[0, 0]]) if len(where) else math.inf}
    vocab = logits[0].shape[1]
    for k, tokens in enumerate(windows):
        ok = model.allowed(vocab, False, dev)[None].repeat(len(tokens), 1)
        ok[0] &= model.allowed(vocab, True, dev)
        rows = logits[k][first:first + len(tokens)].masked_fill(~ok, -math.inf)
        served = torch.tensor(tokens, device=dev)
        if control:
            served = c_logits[k][first:first + len(tokens)].masked_fill(~ok, -math.inf).argmax(1)
        gap = (rows.max(1).values - rows.gather(1, served[:, None])[:, 0]).max()
        out["token_gap"] = max(out["token_gap"], float(gap))
    return out
