"""The ``gmm_sat`` configuration kind: a SAT triphone GMM-HMM with random
parameters drawn from the configuration's own seed, its archive in the
program's format, and a seeded pronunciation dictionary.

The tree gives each non-silence phone's pdf class one pdf per left context
(the previous phone, silence or none) and silence one pdf per class, so a
configuration of ``num_phones`` phones has 5 + num_phones x 3 x
(num_phones + 2) pdfs. :func:`draw_parameters` and :func:`draw_lexicon`
are plain numpy: the reference reads the same arrays, and only
:func:`build` touches the program (to write its archive)."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np

SILENCE = "sil"


def phone_names(cfg) -> list:
    """Phone names by id: 0 is epsilon, 1 silence, then p00, p01, ..."""
    return ["<eps>", SILENCE] + [f"p{i:02d}" for i in range(cfg["num_phones"])]


def num_left_contexts(cfg) -> int:
    return cfg["num_phones"] + 2


def pdf_id(cfg, phone: int, cls: int, left: int) -> int:
    """The tree's pdf of ``phone`` (id >= 2), pdf class ``cls``, after the
    phone ``left`` (0 for none, 1 for silence)."""
    n_sil = cfg["topology"]["silence_states"]
    per_phone = cfg["topology"]["phone_states"] * num_left_contexts(cfg)
    return n_sil + (phone - 2) * per_phone + cls * num_left_contexts(cfg) + left


def num_pdfs(cfg) -> int:
    return pdf_id(cfg, cfg["num_phones"] + 2, 0, 0)


def draw_parameters(cfg) -> dict:
    """The final (SAT) and speaker-independent GMMs and the LDA, from the
    configuration's seed: means N(0, 2^2), inverse variances 1 / max(Gamma(4,
    0.25), 0.1), equal weights; float32 (P, G, D) arrays. The LDA's rows
    are N(0, 1/spliced) over ``feature_rms`` (the spliced features' RMS),
    so the LDA features have about unit variance, as a trained LDA's do."""
    rng = np.random.default_rng(cfg["model_seed"])
    P, G, D = num_pdfs(cfg), cfg["gauss_per_pdf"], cfg["dim"]

    def gmm():
        means = (rng.standard_normal((P, G, D), dtype=np.float32) * 2.0)
        inv_vars = (1.0 / np.maximum(rng.gamma(4.0, 0.25, (P, G, D)), 0.1)
                    ).astype(np.float32)
        return means, inv_vars

    final = gmm()
    si = gmm()
    spliced = cfg["num_ceps"] * (cfg["splice_left"] + 1 + cfg["splice_right"])
    lda = (rng.standard_normal((D, spliced)) / (np.sqrt(spliced) * cfg["feature_rms"])
           ).astype(np.float32)
    return {"means": final[0], "inv_vars": final[1], "si_means": si[0],
            "si_inv_vars": si[1], "lda": lda}


def draw_lexicon(cfg) -> list:
    """[(word, phone names)]: ``dictionary_words`` words of
    ``word_phones`` phones (inclusive range), each phone uniform over the
    non-silence phones; the words' ranks are their order."""
    rng = np.random.default_rng(cfg["model_seed"] + 1)
    lo, hi = cfg["word_phones"]
    names = phone_names(cfg)[2:]
    n = cfg["dictionary_words"]
    lengths = rng.integers(lo, hi + 1, n)
    phones = rng.integers(0, len(names), int(lengths.sum()))
    out, pos = [], 0
    for w in range(n):
        k = int(lengths[w])
        out.append((f"w{w:05d}", [names[i] for i in phones[pos:pos + k]]))
        pos += k
    return out


def _key(cfg) -> str:
    return hashlib.sha256(json.dumps(cfg, sort_keys=True).encode()).hexdigest()[:16]


def build(cfg, cache_dir: Path):
    """(archive path, dictionary path), written once into ``cache_dir``
    under a name made from the configuration's contents."""
    out = Path(cache_dir) / f"gmm_sat-{cfg['name']}-{_key(cfg)}"
    model_path, dict_path = out / "model.zip", out / "dictionary.dict"
    if model_path.exists() and dict_path.exists():
        return model_path, dict_path
    tmp = out.with_name(out.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    _write_archive(cfg, draw_parameters(cfg), tmp / "model.zip")
    with open(tmp / "dictionary.dict", "w") as f:
        for word, phones in draw_lexicon(cfg):
            f.write(f"{word}\t{' '.join(phones)}\n")
    shutil.rmtree(out, ignore_errors=True)
    os.replace(tmp, out)
    return model_path, dict_path


def _write_archive(cfg, params: dict, path: Path) -> None:
    """The program's acoustic-model archive of ``params``."""
    from montreal_forced_aligner_tpu_torch.models.acoustic_model import AcousticModel
    from montreal_forced_aligner_tpu_torch.models.gmm import DiagGmmSet
    from montreal_forced_aligner_tpu_torch.models.transition_model import (
        HmmTopology,
        TransitionModel,
    )
    from montreal_forced_aligner_tpu_torch.models.tree import (
        KPDF_CLASS,
        ConstantEventMap,
        ContextDependency,
        TableEventMap,
    )

    topo_cfg = cfg["topology"]
    n = cfg["num_phones"]
    phones = [1] + [2 + i for i in range(n)]
    topo = HmmTopology.standard(
        phones, silence_phones=[1],
        num_non_silence_states=topo_cfg["phone_states"],
        num_silence_states=topo_cfg["silence_states"])
    center = [None] * (n + 2)
    center[1] = TableEventMap(KPDF_CLASS, [ConstantEventMap(c)
                                           for c in range(topo_cfg["silence_states"])])
    for p in range(2, n + 2):
        center[p] = TableEventMap(KPDF_CLASS, [
            TableEventMap(0, [ConstantEventMap(pdf_id(cfg, p, c, left))
                              for left in range(num_left_contexts(cfg))])
            for c in range(topo_cfg["phone_states"])])
    tree = ContextDependency(N=3, P=1, to_pdf=TableEventMap(1, center))
    if tree.num_pdfs != num_pdfs(cfg):
        raise RuntimeError(f"tree has {tree.num_pdfs} pdfs, not {num_pdfs(cfg)}")
    tm = TransitionModel.from_topology_and_tree(topo, tree)
    G = cfg["gauss_per_pdf"]

    def gmm(means, inv_vars):
        miv = means * inv_vars
        return DiagGmmSet.from_lists(
            weights_list=[np.full(G, 1.0 / G, np.float32)] * len(means),
            miv_list=list(miv), iv_list=list(inv_vars))

    names = phone_names(cfg)
    model = AcousticModel(
        transition_model=tm,
        gmm=gmm(params["means"], params["inv_vars"]),
        tree=tree,
        meta={
            "version": "0.1.0", "architecture": "gmm-hmm",
            "phones": sorted(names[2:]),
            "features": {
                "type": "mfcc", "deltas": False, "lda": True, "fmllr": True,
                "frame_shift": 10, "splice_left_context": cfg["splice_left"],
                "splice_right_context": cfg["splice_right"],
            },
        },
        phone_table={name: i for i, name in enumerate(names)},
        lda_mat=params["lda"],
        alignment_model=(tm, gmm(params["si_means"], params["si_inv_vars"])),
    )
    model.save(path)
