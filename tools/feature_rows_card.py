#!/usr/bin/env python3
"""Whether each row's features and all-pdf emissions are its own on a card.

    python3 tools/feature_rows_card.py

On the first CUDA card, at the SAT-scale model's widths (13 cepstra,
splice +-3 into a 40 x 91 LDA, 40 x 41 fMLLR transforms over 8 speakers,
all-pdf emissions at P*G = 8,000 and 161,440):

- ``rows``: 64 seeded utterances of 2-30 s (noise plus a tone) in corpus
  order, batched 1, 8 and 32 at a time, through ``compute_mfcc_batch``,
  ``apply_transform``, ``apply_per_speaker_transform`` and
  ``gmm_loglikes``: each row's largest difference from batch 1 (0.0 is
  bit-identical);
- ``positions``: each product of those functions alone at its tile's
  shape, the tile's rows rolled by 1, 16 and 1,000 positions: the largest
  difference of a row from itself elsewhere in the tile, for the
  functions' own formulation and for two others (each 16-frame block a
  product of its own through ``bmm``; multiply and sum over K);
- ``times``: each function at sat-2pass's largest batch (32 rows of up to
  3,000 frames), tiled as the port runs it against the same work in one
  call of the batch's shape (the tile lifted past the batch), CUDA events,
  median of 5 after a warm-up.

Prints the card as ``nvidia-smi`` gives it and one JSON line. Exits 1 if
a row differs (``rows``).
"""

import argparse
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from montreal_forced_aligner_tpu_torch.ops import feats as PF  # noqa: E402
from montreal_forced_aligner_tpu_torch.ops import mfcc as PM  # noqa: E402
from montreal_forced_aligner_tpu_torch.ops import tiles  # noqa: E402

PG = importlib.import_module("montreal_forced_aligner_tpu_torch.ops.gmm_loglikes")

BATCH_SIZES = (1, 8, 32)


def waves(n=64, seed=0, lo=2.0, hi=30.0):
    rng = np.random.RandomState(seed)
    out = []
    for s in rng.uniform(lo, hi, n):
        t = np.arange(int(s * 16000)) / 16000.0
        w = rng.randn(t.size) * 800 + 3000 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
        out.append(np.round(w).astype(np.int16))
    return out


def gmm(P, G, D, dev, seed=1):
    rng = np.random.RandomState(seed)
    miv = torch.from_numpy(rng.randn(P * G, D).astype(np.float32))
    iv = torch.from_numpy(rng.uniform(0.2, 2.0, (P * G, D)).astype(np.float32))
    W = torch.cat([miv, -0.5 * iv], 1).T.contiguous().to(dev)
    gc = torch.from_numpy(rng.uniform(-80, -40, (P, G)).astype(np.float32)).to(dev)
    return W, gc


def rows_check(dev):
    cfg = PM.MfccConfig()
    ws = waves()
    rng = np.random.RandomState(2)
    lda = torch.from_numpy((rng.randn(40, 91) / 9).astype(np.float32)).to(dev)
    ident = np.hstack([np.eye(40), np.zeros((40, 1))])
    trans = torch.from_numpy(
        (ident + rng.randn(8, 40, 41) * 0.05).astype(np.float32)).to(dev)
    spk = np.arange(len(ws)) % 8
    models = {f"gmm_loglikes (P*G = {P * G})": gmm(P, G, 40, dev)
              for P, G in ((500, 16), (5045, 32))}
    out = {}
    for bs in BATCH_SIZES:
        got = {k: [] for k in ["mfcc", "lda", "fmllr", *models]}
        for lo in range(0, len(ws), bs):
            part = ws[lo : lo + bs]
            L = -(-max(len(w) for w in part) // 16000) * 16000
            feats, flens = PM.compute_mfcc_batch(part, cfg, padded_len=L, device=dev)
            got["mfcc"] += [feats[b, :n] for b, n in enumerate(flens)]
            x = PF.splice_frames(feats, torch.from_numpy(flens).to(dev), 3, 3)
            ff = PF.apply_transform(x, lda)
            got["lda"] += [ff[b, :n] for b, n in enumerate(flens)]
            fm = PF.apply_per_speaker_transform(
                ff, torch.from_numpy(spk[lo : lo + bs]).to(dev), trans)
            got["fmllr"] += [fm[b, :n] for b, n in enumerate(flens)]
            for name, (W, gc) in models.items():
                # the long rows' all-pdf block at P*G = 161,440 is 2 GB a row
                ll = PG.gmm_loglikes(fm[:, :400], W, gc)
                got[name] += [ll[b, : min(n, 400)] for b, n in enumerate(flens)]
        out[bs] = got
    base = out[BATCH_SIZES[0]]
    return {name: {str(bs): max(float((a - b).abs().max())
                                for a, b in zip(out[bs][name], base[name]))
                   for bs in BATCH_SIZES[1:]}
            for name in base}


def positions(dev):
    """Each product at its tile's shape, rows rolled: the largest change of a
    row's result, per formulation."""
    g = torch.Generator(device="cpu").manual_seed(3)
    blk = tiles.BLOCK

    def roll_diff(f, x, shifts=(1, blk, 1000)):
        y = f(x)
        return max(float((torch.roll(y, s, 0) - f(torch.roll(x, s, 0))).abs().max())
                   for s in shifts)

    def mm_forms(W):
        K, N = W.shape
        return {
            "matmul": lambda x: torch.matmul(x, W),
            "bmm_blocks": lambda x: torch.bmm(
                x.view(-1, blk, K), W.expand(x.shape[0] // blk, K, N)).reshape(-1, N),
            "mul_sum": lambda x: (x[:, :, None] * W[None]).sum(1),
        }

    out = {}
    C = PM.TILE_FRAMES
    cases = {
        "mfcc mel (C, 256) x (256, 23)": (C, torch.rand(256, 23, generator=g)),
        "mfcc dct (C, 23) x (23, 13)": (C, torch.randn(23, 13, generator=g)),
        "lda (C, 91) x (91, 40)": (PF.TRANSFORM_TILE_FRAMES,
                                   torch.randn(91, 40, generator=g)),
        "gmm (C, 80) x (80, 8000)": (min(PG.MAX_TILE_FRAMES,
                                         PG.TILE_BYTES // (8000 * 4)) // blk * blk,
                                     torch.randn(80, 8000, generator=g)),
    }
    for name, (rows, W) in cases.items():
        x = torch.randn(rows, W.shape[0], generator=g).to(dev)
        forms = mm_forms(W.to(dev))
        if rows * W.numel() * 4 > 1 << 30:
            del forms["mul_sum"]
        out[name] = {k: roll_diff(f, x) for k, f in forms.items()}
    x = torch.randn(C, 400, generator=g).to(dev)
    out["mfcc rfft (C, 400), n = 512"] = {"rfft": roll_diff(
        lambda v: torch.view_as_real(torch.fft.rfft(v, n=512, dim=-1)), x)}
    out["mfcc mean (C, 400)"] = {"mean": roll_diff(lambda v: v.mean(-1), x)}
    nb = PF.TRANSFORM_TILE_FRAMES // blk
    A = torch.randn(8, 40, 40, generator=g).to(dev)
    which = torch.arange(nb, device=dev) % 8
    x = torch.randn(nb * blk, 40, generator=g).to(dev)

    def fmllr(v, w):
        return torch.bmm(v.view(nb, blk, 40), A[w].transpose(1, 2)).reshape(-1, 40)

    y = fmllr(x, which)
    out["fmllr bmm (NB, 16, 40) x (NB, 40, 40)"] = {"bmm": max(
        float((torch.roll(y, s * blk, 0)
               - fmllr(torch.roll(x, s * blk, 0), torch.roll(which, s))).abs().max())
        for s in (1, 10, 100))}
    q = torch.randn(256, 8000, generator=g).to(dev).reshape(256, 500, 16)
    out["gmm logsumexp (C, 500, 16)"] = {"logsumexp": roll_diff(
        lambda v: torch.logsumexp(v, -1), q)}
    return out


def times(dev, reps=5):
    cfg = PM.MfccConfig()
    ws = sorted(waves(), key=len)[-32:]
    lens = [min(len(w), 3000 * 160) for w in ws]
    ws = [w[:n] for w, n in zip(ws, lens)]
    padded, _ = PM.pad_waves_for_mfcc(ws, cfg, 30 * 16000)
    padded = torch.from_numpy(padded).to(dev)
    T = cfg.num_frames(30 * 16000)
    feats = PM._mfcc_device(padded, cfg, T)
    spliced = PF.splice_frames(feats, torch.full((32,), T, device=dev), 3, 3)
    lda = torch.randn(40, 91, device=dev) / 9
    ff = PF.apply_transform(spliced, lda)
    trans = torch.eye(40, 41, device=dev).expand(8, 40, 41).contiguous()
    spk = torch.arange(32, device=dev) % 8
    W, gc = gmm(500, 16, 40, dev)
    fns = {
        "mfcc": (PM, "TILE_FRAMES", lambda: PM._mfcc_device(padded, cfg, T)),
        "lda": (PF, "TRANSFORM_TILE_FRAMES", lambda: PF.apply_transform(spliced, lda)),
        "fmllr": (PF, "TRANSFORM_TILE_FRAMES",
                  lambda: PF.apply_per_speaker_transform(ff, spk, trans)),
        "gmm_loglikes (P*G = 8000)": (PG, "MAX_TILE_FRAMES",
                                      lambda: PG.gmm_loglikes(ff, W, gc)),
    }

    def timed(f):
        f()
        ms = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            f()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        return statistics.median(ms)

    out = {"batch": [32, T]}
    for name, (mod, const, f) in fns.items():
        tiled = timed(f)
        kept, kept_bytes = getattr(mod, const), PG.TILE_BYTES
        setattr(mod, const, 32 * (T + tiles.BLOCK))
        PG.TILE_BYTES = 1 << 40
        try:
            whole = timed(f)
        finally:
            setattr(mod, const, kept)
            PG.TILE_BYTES = kept_bytes
        out[name] = {"tiled_ms": tiled, "one_call_ms": whole}
    return out


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rows = rows_check(dev)
    out = {"device": torch.cuda.get_device_name(0), "rows": rows,
           "positions": positions(dev), "times": times(dev)}
    print(json.dumps(out))
    return 0 if all(v == 0.0 for r in rows.values() for v in r.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
