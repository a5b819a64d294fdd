"""Corpus-level Kaldi-parity harness.

Counterpart of ``montreal_forced_aligner_tpu/parity/harness.py`` for the
port: the production path is the port's ``PretrainedAligner`` on its device
(the card's kernels K1-K3 on CUDA), the reference the same independent numpy
decoder. Runs the production alignment path and the independent reference decoder
(:mod:`reference_decoder`) on the same corpus/model/dictionary and reports
frame- and boundary-level agreement. This is the in-repo stand-in for the
BASELINE.md target ("≥98 % phone-boundary agreement @ ±10 ms vs MFA
``english_us_arpa`` on LibriSpeech dev-clean", metric per reference
``helper.py:671``): point it at any corpus + MFA model the moment network /
hardware allow — e.g.

    python -m montreal_forced_aligner_tpu_torch.parity.harness \
        CORPUS_DIR DICT MODEL_ZIP [--device cpu] [--sat]

Both paths share audio, features and the GMM; the graph
expansion and Viterbi DP are fully independent, so any drift in graph
weights, topology handling, optional-silence semantics, scales, or DP
tie-handling shows up as disagreement here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class UtteranceParity:
    utterance_id: int
    num_frames: int
    frame_mismatches: int  # frames whose phone differs
    boundary_total: int
    boundary_exact: int  # boundaries agreeing to the frame
    boundary_within_1: int  # boundaries within ±1 frame (±10 ms)
    score_production: float
    score_reference: float

    @property
    def frame_agreement(self) -> float:
        return 1.0 - self.frame_mismatches / max(self.num_frames, 1)


def production_frame_phones(aln, num_frames: int, frame_shift: float, begin: float):
    """Reconstruct per-frame phone labels from production CTM intervals."""
    labels = [None] * num_frames
    for p in aln.phones:
        f0 = int(round((p.begin - begin) / frame_shift))
        f1 = int(round((p.end - begin) / frame_shift))
        for f in range(f0, min(f1, num_frames)):
            labels[f] = p.label
    return labels


def _strip_pos(name: str) -> str:
    for pos in ("_B", "_E", "_I", "_S"):
        if name.endswith(pos):
            return name[: -len(pos)]
    return name


def _production_final_feats(aligner, corpus) -> List[np.ndarray]:
    """Each utterance's final features (T, D) as the aligner computes them
    (MFCC -> per-speaker CMVN -> deltas or splice+LDA), one utterance at a
    time on the aligner's device, as float32 host arrays."""
    import torch

    from montreal_forced_aligner_tpu_torch.align.aligner import (
        _final_feats,
        _mfcc_and_sums,
    )
    from montreal_forced_aligner_tpu_torch.ops.mfcc import pad_waves_for_mfcc

    dev = aligner.device
    speaker_index = corpus.speaker_index
    cfg = aligner.mfcc_config
    waves = corpus.load_audio_parallel(cfg.sample_rate)
    spk_sum: Dict[int, np.ndarray] = {}
    spk_n: Dict[int, float] = {}
    raw = []
    for utt, w in zip(corpus.utterances, waves):
        L = ((len(w) + 15999) // 16000) * 16000
        padded, lens = pad_waves_for_mfcc([w], cfg, L)
        flens = np.array([cfg.num_frames(int(lens[0]))], np.int32)
        feats, sums = _mfcc_and_sums(
            torch.from_numpy(padded).to(dev), torch.from_numpy(flens).to(dev),
            cfg, cfg.num_frames(L),
        )
        s = speaker_index[utt.speaker]
        spk_sum[s] = spk_sum.get(s, 0) + sums.cpu().numpy()[0]
        spk_n[s] = spk_n.get(s, 0.0) + float(flens[0])
        raw.append(feats[0, : flens[0]])
    model = aligner.model
    lda = (
        torch.from_numpy(np.asarray(model.lda_mat, np.float32)).to(dev)
        if model.uses_lda and model.lda_mat is not None
        else None
    )
    out = []
    for utt, feats in zip(corpus.utterances, raw):
        s = speaker_index[utt.speaker]
        mean = (spk_sum[s] / max(spk_n[s], 1.0)).astype(np.float32)
        T = feats.shape[0]
        ff = _final_feats(
            feats[None],
            torch.tensor([T], dtype=torch.int32, device=dev),
            torch.from_numpy(mean[None]).to(dev),
            lda,
            None,
        )
        out.append(ff[0, :T].cpu().numpy())
    return out


def _solve_fmllr(K, G, beta, min_count: float) -> Optional[np.ndarray]:
    """One speaker's (D, D+1) transform by the plain numpy row sweep, or
    None under ``min_count`` (the features stay as they are)."""
    from montreal_forced_aligner_tpu_torch.ops.transforms import (
        _solve_fmllr_batched_numpy,
    )

    if beta < min_count:
        return None
    return _solve_fmllr_batched_numpy(
        np.asarray(K)[None], np.asarray(G)[None], np.array([beta], np.float64)
    )[0]


def compare_corpus(
    aligner,
    corpus,
    beam: float = float("inf"),
    max_utterances: Optional[int] = None,
) -> List[UtteranceParity]:
    """Aligns ``corpus`` with the production ``PretrainedAligner`` and with
    the independent reference decoder, returning per-utterance parity."""
    from montreal_forced_aligner_tpu_torch.parity.reference_decoder import (
        ReferenceAligner,
    )

    results = aligner.align_corpus(corpus)
    ref = ReferenceAligner(
        aligner.model.transition_model,
        aligner.model.tree,
        aligner.lexicon,
        transition_scale=aligner.config.transition_scale,
        self_loop_scale=aligner.config.self_loop_scale,
        acoustic_scale=aligner.config.acoustic_scale,
    )
    phone_names = aligner.model.phone_names

    # recompute the production features per utterance (identical code path
    # to the aligner: MFCC -> per-speaker CMVN -> deltas/LDA)
    speaker_index = corpus.speaker_index
    out = []
    utts = corpus.utterances[:max_utterances] if max_utterances else corpus.utterances
    for utt, ff in zip(utts, _production_final_feats(aligner, corpus)):
        T = ff.shape[0]
        tokens = utt.normalized_tokens or aligner.tokenizer.tokenize(utt.text)
        gmm = aligner.model.gmm
        if aligner.config.boost_silence != 1.0:
            import copy as _copy
            import math as _math

            gmm = _copy.deepcopy(gmm)
            gmm.gconsts = gmm.gconsts.copy()
            gmm.gconsts[aligner._silence_pdfs()] += _math.log(
                aligner.config.boost_silence
            )
        ll = ref.loglikes_for(ff, gmm)
        tids, phones, score = ref.align(ll, tokens, beam=beam)
        aln = results[utt.id]
        prod_labels = production_frame_phones(
            aln, T, aligner.frame_shift, utt.begin
        )
        ref_labels = [
            _strip_pos(phone_names.get(int(p), str(p))) for p in phones
        ]
        mismatches = sum(
            1 for a, b in zip(prod_labels, ref_labels) if a != b
        )

        def boundaries(labels):
            return {
                f
                for f in range(1, len(labels))
                if labels[f] != labels[f - 1]
            }

        b_prod = boundaries(prod_labels)
        b_ref = boundaries(ref_labels)
        exact = len(b_prod & b_ref)
        within1 = sum(
            1
            for b in b_ref
            if b in b_prod or (b - 1) in b_prod or (b + 1) in b_prod
        )
        out.append(
            UtteranceParity(
                utterance_id=utt.id,
                num_frames=T,
                frame_mismatches=mismatches,
                boundary_total=len(b_ref),
                boundary_exact=exact,
                boundary_within_1=within1,
                score_production=aln.log_likelihood,
                score_reference=score,
            )
        )
    return out


def compare_corpus_sat(
    aligner,
    corpus,
    max_utterances: Optional[int] = None,
) -> List[UtteranceParity]:
    """Two-pass (SAT/fMLLR) parity: the production path (SI-model pass 1 ->
    per-speaker fMLLR -> adapted pass 2, ``align/aligner.py``
    ``_fmllr_second_pass_feats``) vs an independent numpy two-pass built on
    the reference token-passing decoder — pass-1 alignments from the
    reference decoder, fMLLR sufficient statistics accumulated in float64
    numpy straight from the Kaldi formulas (``gmm-est-fmllr``; weights 0 on
    silence frames, matching the production silence weighting), the scalar
    row-sweep solve, and a reference pass-2 decode on the adapted features.
    """
    from montreal_forced_aligner_tpu_torch.parity.reference_decoder import (
        ReferenceAligner,
    )

    model = aligner.model
    if not (model.uses_fmllr and model.alignment_model is not None):
        raise ValueError("compare_corpus_sat needs a SAT model (.alimdl)")
    _ali_tm, ali_gmm = model.alignment_model
    results = aligner.align_corpus(corpus)
    ref = ReferenceAligner(
        model.transition_model,
        model.tree,
        aligner.lexicon,
        transition_scale=aligner.config.transition_scale,
        self_loop_scale=aligner.config.self_loop_scale,
        acoustic_scale=aligner.config.acoustic_scale,
    )
    phone_names = model.phone_names
    sil_pdfs = set(int(p) for p in aligner._silence_pdfs())

    # production features (MFCC -> speaker CMVN -> splice+LDA), identical
    # code path to the aligner
    speaker_index = corpus.speaker_index
    final_feats = [ff.astype(np.float64)
                   for ff in _production_final_feats(aligner, corpus)]

    # pass 1: reference decode with the speaker-independent model
    gmm = model.gmm
    means = np.asarray(gmm.get_means(), np.float64)  # (P, G, D)
    iv = np.asarray(gmm.inv_vars, np.float64)
    miv = np.asarray(gmm.means_invvars, np.float64)
    gconst = np.asarray(gmm.gconsts, np.float64)
    D = means.shape[-1]
    E = D + 1
    K_s: Dict[int, np.ndarray] = {}
    G_s: Dict[int, np.ndarray] = {}
    beta_s: Dict[int, float] = {}
    for utt, ff in zip(corpus.utterances, final_feats):
        tokens = utt.normalized_tokens or aligner.tokenizer.tokenize(utt.text)
        ll1 = ref.loglikes_for(ff.astype(np.float32), ali_gmm)
        tids, _phones, _score = ref.align(ll1, tokens)
        frame_pdf = np.asarray(model.transition_model.id2pdf, np.int64)[
            np.asarray(tids, np.int64)
        ]
        s = speaker_index[utt.speaker]
        if s not in K_s:
            K_s[s] = np.zeros((D, E))
            G_s[s] = np.zeros((D, E, E))
            beta_s[s] = 0.0
        for t in range(ff.shape[0]):
            p = int(frame_pdf[t])
            if p in sil_pdfs:
                continue  # silence weight 0 (production semantics)
            x = ff[t]
            quad = miv[p] @ x - 0.5 * (iv[p] @ (x * x)) + gconst[p]
            quad = quad - quad.max()
            gamma = np.exp(quad)
            gamma /= gamma.sum()
            xp = np.concatenate([x, [1.0]])
            K_s[s] += (gamma[:, None] * (iv[p] * means[p])).sum(0)[
                :, None
            ] * xp[None, :]
            w_iv = (gamma[:, None] * iv[p]).sum(0)  # (D,)
            G_s[s] += w_iv[:, None, None] * np.outer(xp, xp)[None]
            beta_s[s] += float(gamma.sum())

    transforms: Dict[int, Optional[np.ndarray]] = {}
    for s in K_s:
        transforms[s] = _solve_fmllr(
            K_s[s], G_s[s], beta_s[s],
            min_count=aligner.config.fmllr_min_count,
        )

    # pass 2: reference decode on adapted features with the final model
    # (production pass 2 boosts silence via _prepare_gmm; pass 1 does not)
    gmm2 = gmm
    if aligner.config.boost_silence != 1.0:
        import copy as _copy
        import math as _math

        gmm2 = _copy.deepcopy(gmm)
        gmm2.gconsts = gmm2.gconsts.copy()
        gmm2.gconsts[sorted(sil_pdfs)] += _math.log(
            aligner.config.boost_silence
        )
    out = []
    utts = (
        corpus.utterances[:max_utterances]
        if max_utterances
        else corpus.utterances
    )
    for utt, ff in zip(utts, final_feats):
        s = speaker_index[utt.speaker]
        W = transforms.get(s)
        if W is not None:
            xp = np.concatenate(
                [ff, np.ones((ff.shape[0], 1))], axis=1
            )
            ff = xp @ np.asarray(W, np.float64).T
        tokens = utt.normalized_tokens or aligner.tokenizer.tokenize(utt.text)
        ll2 = ref.loglikes_for(ff.astype(np.float32), gmm2)
        _tids, phones, score = ref.align(ll2, tokens)
        aln = results[utt.id]
        T = ff.shape[0]
        prod_labels = production_frame_phones(
            aln, T, aligner.frame_shift, utt.begin
        )
        ref_labels = [
            _strip_pos(phone_names.get(int(p), str(p))) for p in phones
        ]
        mismatches = sum(1 for a, b in zip(prod_labels, ref_labels) if a != b)

        def boundaries(labels):
            return {
                f for f in range(1, len(labels)) if labels[f] != labels[f - 1]
            }

        b_prod = boundaries(prod_labels)
        b_ref = boundaries(ref_labels)
        out.append(
            UtteranceParity(
                utterance_id=utt.id,
                num_frames=T,
                frame_mismatches=mismatches,
                boundary_total=len(b_ref),
                boundary_exact=len(b_prod & b_ref),
                boundary_within_1=sum(
                    1
                    for b in b_ref
                    if b in b_prod or (b - 1) in b_prod or (b + 1) in b_prod
                ),
                score_production=aln.log_likelihood,
                score_reference=score,
            )
        )
    return out


def main(argv=None):
    import argparse

    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("corpus_directory")
    ap.add_argument("dictionary_path")
    ap.add_argument("acoustic_model_path")
    ap.add_argument("--beam", type=float, default=float("inf"))
    ap.add_argument("--max_utterances", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the production path (cuda, or cpu)")
    ap.add_argument("--sat", action="store_true",
                    help="the two-pass (fMLLR) comparison of a SAT model")
    args = ap.parse_args(argv)
    aligner = PretrainedAligner(
        args.acoustic_model_path, args.dictionary_path, AlignerConfig(),
        device=args.device,
    )
    corpus = Corpus.load(args.corpus_directory)
    if args.sat:
        report = compare_corpus_sat(
            aligner, corpus, max_utterances=args.max_utterances
        )
    else:
        report = compare_corpus(
            aligner, corpus, beam=args.beam, max_utterances=args.max_utterances
        )
    frames = sum(r.num_frames for r in report)
    mism = sum(r.frame_mismatches for r in report)
    b_tot = sum(r.boundary_total for r in report)
    b_exact = sum(r.boundary_exact for r in report)
    b_w1 = sum(r.boundary_within_1 for r in report)
    print(
        f"utterances={len(report)} frames={frames} "
        f"frame_agreement={1 - mism / max(frames,1):.4%} "
        f"boundary_exact={b_exact}/{b_tot} "
        f"boundary_within_10ms={b_w1 / max(b_tot,1):.4%}"
    )
    for r in report:
        print(
            f"  utt {r.utterance_id}: frames={r.num_frames} "
            f"mismatch={r.frame_mismatches} "
            f"score prod={r.score_production:.2f} ref={r.score_reference:.2f}"
        )


if __name__ == "__main__":
    main()
