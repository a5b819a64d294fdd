"""The ``wav2vec2`` configuration kind: a Hugging Face ``Wav2Vec2ForCTC``
checkpoint directory at the configuration's published sizes, with random
weights drawn on the device from the configuration's seed (as its
``assumed`` says) and stored as float32 safetensors under the published
names (the positional convolution's weight norm as ``weight_g`` /
``weight_v``), the published vocabulary and preprocessor settings.
Written once into the cache; the program loads it with its own loader, as
users load a downloaded checkpoint."""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import struct
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

CONFIG_KEYS = (
    "architectures", "model_type", "activation_dropout", "apply_spec_augment",
    "attention_dropout", "bos_token_id", "conv_bias", "conv_dim", "conv_kernel", "conv_stride",
    "ctc_loss_reduction", "ctc_zero_infinity", "do_stable_layer_norm", "eos_token_id",
    "feat_extract_activation", "feat_extract_dropout", "feat_extract_norm",
    "feat_proj_dropout", "final_dropout", "hidden_act", "hidden_dropout",
    "hidden_dropout_prob", "hidden_size", "initializer_range", "intermediate_size",
    "layer_norm_eps", "layerdrop", "mask_feature_length", "mask_feature_prob",
    "mask_time_length", "mask_time_prob", "num_attention_heads",
    "num_conv_pos_embedding_groups", "num_conv_pos_embeddings", "num_feat_extract_layers",
    "num_hidden_layers", "pad_token_id", "vocab_size")


def parameters(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """Every stored tensor as (name, shape, how it is drawn, scale), in the
    published checkpoint's names."""
    d, ffn, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    std = cfg["initializer_range"]
    out = []

    def norm(p, n):
        out.extend([(p + ".weight", (n,), "ones", 0.0), (p + ".bias", (n,), "zeros", 0.0)])

    def linear(p, n_out, n_in):
        out.extend([(p + ".weight", (n_out, n_in), "normal", std),
                    (p + ".bias", (n_out,), "normal", std)])

    c_in = 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        p = f"wav2vec2.feature_extractor.conv_layers.{i}"
        out.append((p + ".conv.weight", (c, c_in, k), "normal", math.sqrt(2.0 / (c_in * k))))
        if cfg["conv_bias"]:
            out.append((p + ".conv.bias", (c,), "uniform", math.sqrt(1.0 / (c_in * k))))
        norm(p + ".layer_norm", c)
        c_in = c
    norm("wav2vec2.feature_projection.layer_norm", c_in)
    bound = math.sqrt(1.0 / c_in)
    out += [("wav2vec2.feature_projection.projection.weight", (d, c_in), "uniform", bound),
            ("wav2vec2.feature_projection.projection.bias", (d,), "uniform", bound)]
    taps, groups = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    p = "wav2vec2.encoder.pos_conv_embed.conv."
    out += [(p + "bias", (d,), "normal", std),
            (p + "weight_g", (1, 1, taps), "gain", 0.0),
            (p + "weight_v", (d, d // groups, taps), "normal", 2.0 * math.sqrt(1.0 / (taps * d)))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"wav2vec2.encoder.layers.{i}"
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            linear(f"{p}.attention.{proj}", d, d)
        norm(p + ".layer_norm", d)
        linear(p + ".feed_forward.intermediate_dense", ffn, d)
        linear(p + ".feed_forward.output_dense", d, ffn)
        norm(p + ".final_layer_norm", d)
    norm("wav2vec2.encoder.layer_norm", d)
    out.append(("wav2vec2.masked_spec_embed", (d,), "uniform01", 0.0))
    linear("lm_head", V, d)
    return out


def draw_weights(cfg: dict, device) -> Tuple[List[Tuple[str, tuple, int]], torch.Tensor]:
    """([(name, shape, offset)], the flat float32 buffer), drawn on
    ``device`` from one generator seeded by ``model_seed``, tensor by
    tensor in :func:`parameters`' order. The positional convolution's
    gain is its direction's norm over dims 0 and 1 times U(0.5, 1.5)."""
    params = parameters(cfg)
    sizes = [int(np.prod(s)) for _, s, _, _ in params]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    flat = torch.empty(int(offsets[-1]), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(cfg["model_seed"])
    views = {}
    for i, (name, shape, kind, scale) in enumerate(params):
        view = flat[int(offsets[i]):int(offsets[i + 1])].view(shape)
        views[name] = view
        if kind == "normal":
            view.normal_(0.0, scale, generator=gen)
        elif kind == "uniform":
            view.uniform_(-scale, scale, generator=gen)
        elif kind == "uniform01":
            view.uniform_(0.0, 1.0, generator=gen)
        elif kind in ("ones", "zeros"):
            view.fill_(1.0 if kind == "ones" else 0.0)
    for name, shape, kind, _ in params:
        if kind == "gain":
            v = views[name[:-len("weight_g")] + "weight_v"]
            factor = torch.empty(shape, device=device).uniform_(0.5, 1.5, generator=gen)
            views[name].copy_(v.norm(dim=(0, 1), keepdim=True) * factor)
    return [(n, s, int(offsets[i])) for i, (n, s, _, _) in enumerate(params)], flat


def _files(cfg: dict) -> dict:
    config = {k: cfg[k] for k in CONFIG_KEYS}
    config["torch_dtype"] = "float32"
    vocab = {c: i for i, c in enumerate(cfg["vocab"])}
    tokenizer = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
                 "pad_token": "<pad>", "do_lower_case": False, "word_delimiter_token": "|",
                 "tokenizer_class": "Wav2Vec2CTCTokenizer"}
    return {"config.json": config, "vocab.json": vocab,
            "preprocessor_config.json": cfg["preprocessor"],
            "tokenizer_config.json": tokenizer,
            "special_tokens_map.json": {k: tokenizer[k] for k in
                                        ("bos_token", "eos_token", "unk_token", "pad_token")}}


def _key(cfg) -> str:
    return hashlib.sha256(json.dumps(cfg, sort_keys=True).encode()).hexdigest()[:16]


def build(cfg: dict, cache_dir: Path, device) -> Path:
    """The checkpoint directory, written once into ``cache_dir`` under a
    name made from the configuration's contents."""
    out = Path(cache_dir) / f"wav2vec2-{cfg['name']}-{_key(cfg)}"
    if (out / "model.safetensors").exists():
        return out
    tmp = out.with_name(out.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    for name, data in _files(cfg).items():
        (tmp / name).write_text(json.dumps(data, indent=1))
    layout, flat = draw_weights(cfg, device)
    header = {n: {"dtype": "F32", "shape": list(s),
                  "data_offsets": [4 * o, 4 * (o + int(np.prod(s)))]} for n, s, o in layout}
    header["__metadata__"] = {"format": "pt"}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(tmp / "model.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        f.write(flat.cpu().numpy().tobytes())
    del flat
    shutil.rmtree(out, ignore_errors=True)
    os.replace(tmp, out)
    return out
