"""The ``whisper`` configuration kind: a Hugging Face Whisper checkpoint
directory at the configuration's published sizes, with random weights
drawn on the device from the configuration's seed and stored as float16
safetensors, a vocabulary in the published layout and the published
generation keys. Written once into the cache; the program loads it with
its own loader, as users load a downloaded checkpoint."""

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

# the first 100 of Whisper's language codes, in its order
LANGUAGE_CODES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs ro da hu "
    "ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn et mk br eu is hy ne mn "
    "bs kk sq sw gl mr pa si km sn yo so af oc ka be tg sd gu am yi lo uz fo ht ps tk nn "
    "mt sa lb my bo tl mg as tt haw ln ha ba jw su yue").split()


def bytes_to_unicode() -> dict:
    """GPT-2's map from each byte to a printable character."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def text_layout(n_base: int, n_languages: int, n_timestamps: int, seed: int):
    """A vocabulary in the published layout: the 256 byte characters and
    seeded letter strings (with and without GPT-2's word-initial ``Ġ``) as
    the byte-level tokens, then the special tokens and the timestamps at
    the published ids. (vocab, added [(id, text, special)], named ids,
    lang_to_id)."""
    rng = np.random.RandomState(seed)
    chars = bytes_to_unicode()
    vocab = {chars[b]: b for b in range(256)}
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(vocab) < n_base:
        word = "".join(rng.choice(letters, rng.randint(2, 9)))
        token = ("Ġ" + word) if rng.rand() < 0.6 else word
        vocab.setdefault(token, len(vocab))
    codes = LANGUAGE_CODES[:n_languages]
    names = (["<|endoftext|>", "<|startoftranscript|>"] + [f"<|{c}|>" for c in codes]
             + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
                "<|nospeech|>", "<|notimestamps|>"])
    added = [(n_base + i, t, True) for i, t in enumerate(names)]
    first_ts = n_base + len(names)
    added += [(first_ts + i, f"<|{i * 0.02:.2f}|>", False) for i in range(n_timestamps)]
    ids = {t.strip("<|>"): i for i, t, _ in added[:len(names)]}
    lang_to_id = {f"<|{c}|>": ids[c] for c in codes}
    return vocab, added, ids, lang_to_id


def parameters(cfg: dict) -> List[Tuple[str, tuple]]:
    """Every stored tensor's name and shape, as the published checkpoint
    names them (the output projection is tied to the token embedding)."""
    d, ffn_e, ffn_d = cfg["d_model"], cfg["encoder_ffn_dim"], cfg["decoder_ffn_dim"]
    out = [("model.encoder.conv1.weight", (d, cfg["num_mel_bins"], 3)),
           ("model.encoder.conv1.bias", (d,)),
           ("model.encoder.conv2.weight", (d, d, 3)), ("model.encoder.conv2.bias", (d,)),
           ("model.encoder.embed_positions.weight", (cfg["max_source_positions"], d))]

    def attn(p):
        return [(f"{p}.k_proj.weight", (d, d)), (f"{p}.v_proj.weight", (d, d)),
                (f"{p}.v_proj.bias", (d,)), (f"{p}.q_proj.weight", (d, d)),
                (f"{p}.q_proj.bias", (d,)), (f"{p}.out_proj.weight", (d, d)),
                (f"{p}.out_proj.bias", (d,))]

    def norm(p):
        return [(f"{p}.weight", (d,)), (f"{p}.bias", (d,))]

    def ffn(p, f):
        return [(f"{p}.fc1.weight", (f, d)), (f"{p}.fc1.bias", (f,)),
                (f"{p}.fc2.weight", (d, f)), (f"{p}.fc2.bias", (d,))]

    for i in range(cfg["encoder_layers"]):
        p = f"model.encoder.layers.{i}"
        out += attn(f"{p}.self_attn") + norm(f"{p}.self_attn_layer_norm")
        out += ffn(p, ffn_e) + norm(f"{p}.final_layer_norm")
    out += norm("model.encoder.layer_norm")
    out += [("model.decoder.embed_tokens.weight", (cfg["vocab_size"], d)),
            ("model.decoder.embed_positions.weight", (cfg["max_target_positions"], d))]
    for i in range(cfg["decoder_layers"]):
        p = f"model.decoder.layers.{i}"
        out += attn(f"{p}.self_attn") + norm(f"{p}.self_attn_layer_norm")
        out += attn(f"{p}.encoder_attn") + norm(f"{p}.encoder_attn_layer_norm")
        out += ffn(p, ffn_d) + norm(f"{p}.final_layer_norm")
    out += norm("model.decoder.layer_norm")
    return out


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's encoder positions (sin half, cos half)."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float32))
    t = torch.arange(length, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cat([t.sin(), t.cos()], dim=1)


def _kind(name: str) -> str:
    if name == "model.encoder.embed_positions.weight":
        return "sinusoids"
    if "layer_norm" in name:
        return "ones" if name.endswith("weight") else "zeros"
    if name.endswith("bias"):
        return "zeros"
    return "normal"


def draw_weights(cfg: dict, device) -> Tuple[List[Tuple[str, tuple, int]], torch.Tensor]:
    """([(name, shape, offset)], the flat float16 buffer): weight matrices
    N(0, init_std^2) from one generator call on ``device``, LayerNorms 1
    and 0, biases 0, the encoder positions sinusoidal."""
    params = parameters(cfg)
    sizes = [int(np.prod(s)) for _, s in params]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    flat = torch.empty(int(offsets[-1]), dtype=torch.float16, device=device)
    normal = [i for i, (n, _) in enumerate(params) if _kind(n) == "normal"]
    gen = torch.Generator(device=device).manual_seed(cfg["model_seed"])
    draws = torch.randn(sum(sizes[i] for i in normal), generator=gen, device=device)
    draws = (draws * cfg["init_std"]).to(torch.float16)
    pos = 0
    for i, (name, shape) in enumerate(params):
        a, b = int(offsets[i]), int(offsets[i + 1])
        kind = _kind(name)
        if kind == "normal":
            flat[a:b] = draws[pos:pos + b - a]
            pos += b - a
        elif kind == "sinusoids":
            flat[a:b] = sinusoids(*shape).to(device, torch.float16).reshape(-1)
        else:
            flat[a:b] = 1.0 if kind == "ones" else 0.0
    return [(n, s, int(offsets[i])) for i, (n, s) in enumerate(params)], flat


def _files(cfg: dict) -> dict:
    """The checkpoint's JSON files and vocabulary."""
    t = cfg["text"]
    vocab, added, ids, lang_to_id = text_layout(t["n_base"], t["n_languages"],
                                                t["n_timestamps"], cfg["model_seed"])
    eot, sot = ids["endoftext"], ids["startoftranscript"]
    rng = np.random.RandomState(cfg["model_seed"] + 1)
    n_suppress = min(82, t["n_base"] // 8)
    suppress = sorted(int(i) for i in rng.choice(np.arange(256, t["n_base"]), n_suppress,
                                                 replace=False))
    suppress += [sot, ids["translate"], ids["transcribe"], ids["startoflm"],
                 ids["startofprev"], ids["nospeech"]]
    begin_suppress = [vocab["Ġ"], eot]
    dims = {k: cfg[k] for k in ("vocab_size", "num_mel_bins", "d_model", "encoder_layers",
                                "encoder_attention_heads", "encoder_ffn_dim",
                                "decoder_layers", "decoder_attention_heads",
                                "decoder_ffn_dim", "max_source_positions",
                                "max_target_positions")}
    config = {
        "architectures": ["WhisperForConditionalGeneration"], "model_type": "whisper",
        **dims, "activation_function": "gelu", "bos_token_id": eot, "eos_token_id": eot,
        "pad_token_id": eot, "decoder_start_token_id": sot,
        "begin_suppress_tokens": begin_suppress, "scale_embedding": False,
        "is_encoder_decoder": True, "use_cache": True, "torch_dtype": "float16",
        "init_std": cfg["init_std"],
    }
    generation = {
        "begin_suppress_tokens": begin_suppress, "bos_token_id": eot,
        "decoder_start_token_id": sot, "eos_token_id": eot, "pad_token_id": eot,
        "forced_decoder_ids": [[1, None], [2, ids["transcribe"]]],
        "is_multilingual": True, "lang_to_id": lang_to_id,
        "max_initial_timestamp_index": 50, "max_length": cfg["max_target_positions"],
        "no_timestamps_token_id": ids["notimestamps"],
        "prev_sot_token_id": ids["startofprev"], "return_timestamps": False,
        "suppress_tokens": suppress,
        "task_to_id": {"transcribe": ids["transcribe"], "translate": ids["translate"]},
    }
    preprocessor = {
        "chunk_length": 30, "feature_extractor_type": "WhisperFeatureExtractor",
        "feature_size": cfg["num_mel_bins"], "hop_length": 160, "n_fft": 400,
        "n_samples": 480000, "nb_max_frames": 3000, "padding_side": "right",
        "padding_value": 0.0, "processor_class": "WhisperProcessor",
        "return_attention_mask": False, "sampling_rate": 16000,
    }
    specials = [x for _, x, s in added if s]
    tokenizer = {
        "add_prefix_space": False, "additional_special_tokens": specials,
        "added_tokens_decoder": {
            str(i): {"content": x, "lstrip": False, "normalized": False, "rstrip": False,
                     "single_word": False, "special": s} for i, x, s in added},
        "bos_token": "<|endoftext|>", "clean_up_tokenization_spaces": True,
        "eos_token": "<|endoftext|>", "errors": "replace",
        "model_max_length": 1000000000000000019884624838656,
        "pad_token": "<|endoftext|>", "processor_class": "WhisperProcessor",
        "tokenizer_class": "WhisperTokenizer", "unk_token": "<|endoftext|>",
    }
    special_map = {"additional_special_tokens": specials, "bos_token": "<|endoftext|>",
                   "eos_token": "<|endoftext|>", "pad_token": "<|endoftext|>",
                   "unk_token": "<|endoftext|>"}
    return {"config.json": config, "generation_config.json": generation,
            "preprocessor_config.json": preprocessor, "tokenizer_config.json": tokenizer,
            "special_tokens_map.json": special_map, "vocab.json": vocab}


def _key(cfg) -> str:
    return hashlib.sha256(json.dumps(cfg, sort_keys=True).encode()).hexdigest()[:16]


def build(cfg: dict, cache_dir: Path, device) -> Path:
    """The checkpoint directory, written once into ``cache_dir`` under a
    name made from the configuration's contents."""
    out = Path(cache_dir) / f"whisper-{cfg['name']}-{_key(cfg)}"
    if (out / "model.safetensors").exists():
        return out
    tmp = out.with_name(out.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    for name, data in _files(cfg).items():
        (tmp / name).write_text(json.dumps(data, indent=1))
    (tmp / "merges.txt").write_text("#version: 0.2\n")
    layout, flat = draw_weights(cfg, device)
    header = {n: {"dtype": "F16", "shape": list(s),
                  "data_offsets": [2 * o, 2 * (o + int(np.prod(s)))]} for n, s, o in layout}
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
