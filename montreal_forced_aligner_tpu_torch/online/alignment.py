"""Single-utterance ("online") alignment.

Counterpart of ``montreal_forced_aligner_tpu/online/alignment.py``
(behavioural spec: reference ``online/alignment.py:29-123``,
``align_utterance_online``: tokenize, graph compile, MFCC + utterance CMVN,
align, CTM), the path behind ``align_one`` and the corpus path's long
utterances. Unlike the corpus pipeline, CMVN is estimated from the one
utterance itself, and a SAT model's fMLLR transform from its own frames.
Utterances over :data:`LONG_UTTERANCE_FRAMES` decode through the chunked
exact Viterbi (``ops/long_viterbi.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.corpus.corpus import Utterance
from montreal_forced_aligner_tpu_torch.data import UtteranceAlignment
from montreal_forced_aligner_tpu_torch.graph.compiler import (
    batch_graphs,
    ship_graph_to_device,
)
from montreal_forced_aligner_tpu_torch.ops.feats import (
    apply_per_speaker_transform,
    cmvn_means,
    nonsilence_weight,
)
from montreal_forced_aligner_tpu_torch.ops.long_viterbi import viterbi_align_long
from montreal_forced_aligner_tpu_torch.ops.mfcc import pad_waves_for_mfcc
from montreal_forced_aligner_tpu_torch.ops.transforms import (
    FmllrEstimate,
    accumulate_fmllr_stats,
    estimate_speaker_fmllr,
    stats_to_host,
)
from montreal_forced_aligner_tpu_torch.ops.viterbi import (
    band_limits_from_arcs,
    extract_frame_labels_host,
)

# frames above which an utterance decodes through the checkpointed chunked
# Viterbi (10 ms frames: 60000 = 10 minutes); the corpus path sends such
# utterances here
LONG_UTTERANCE_FRAMES = 60000


def align_utterance_online(
    aligner,
    samples: np.ndarray,
    text: str,
    utterance_id: int = 0,
) -> UtteranceAlignment:
    """Align one waveform (int16-scaled float samples at the model's sample
    rate) against its transcript with a loaded
    :class:`~montreal_forced_aligner_tpu_torch.align.aligner.PretrainedAligner`,
    on the aligner's device."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        _emit_and_align,
        _final_feats,
        _mfcc_and_sums,
        _round_up,
        frames_to_alignment,
    )

    dev = aligner.device
    cfg = aligner.config
    tokens = aligner.tokenizer.tokenize(text)
    if aligner.g2p is not None:
        aligner._add_g2p_pronunciations(tokens, aligner.lexicon)
    graph = aligner.compiler.compile(tokens)

    L = _round_up(len(samples), 16000)
    padded, lens = pad_waves_for_mfcc([samples], aligner.mfcc_config, L)
    flens = np.array(
        [aligner.mfcc_config.num_frames(int(n)) for n in lens], np.int32
    )
    flens_dev = torch.from_numpy(flens).to(dev)
    feats, sums = _mfcc_and_sums(
        torch.from_numpy(padded).to(dev),
        flens_dev,
        aligner.mfcc_config,
        aligner.mfcc_config.num_frames(L),
    )
    # single-utterance CMVN (reference ``online/alignment.py:86-88``): the
    # corpus path's float64 sum and division for a speaker of one
    # utterance; a pitch model's pitch is pasted after it, as phase A
    # pastes it
    mean = cmvn_means(sums, torch.from_numpy(flens).to(dev))
    pitch = None
    if aligner.use_pitch:
        from montreal_forced_aligner_tpu_torch.ops.pitch import (
            pitch_for_mfcc_frames,
        )

        pitch = torch.from_numpy(pitch_for_mfcc_frames(
            np.asarray(samples, np.float32)[None],
            np.array([len(samples)], np.int32), flens, int(feats.shape[1]),
            device=dev,
        )).to(dev)
    ff = _final_feats(feats, flens_dev, mean, aligner.gmm.lda, pitch)
    garrs = batch_graphs([graph])
    Lf0 = int(flens[0])
    is_long = Lf0 > LONG_UTTERANCE_FRAMES
    bgraph = ship_graph_to_device(garrs, dev)
    band_limits = None if is_long else band_limits_from_arcs(garrs)

    def decode(ff_in, gmm, use_emission_kernel):
        """One decode pass: (state path (1, T') on the device, score (1,)),
        T' = Lf0 on the chunked path (its O(T*S) backpointers and
        emissions would not fit the card batched), else the padded T."""
        if is_long:
            path, score = viterbi_align_long(
                ff_in[0, :Lf0], garrs, gmm,
                acoustic_scale=cfg.acoustic_scale,
                use_emission_kernel=use_emission_kernel,
            )
            return torch.from_numpy(path)[None].to(dev), torch.tensor([score])
        return _emit_and_align(
            ff_in, flens_dev, bgraph, gmm, cfg.acoustic_scale,
            band_limits=band_limits, use_emission_kernel=use_emission_kernel,
        )

    # SAT models run the reference's two-pass online semantics (SI first
    # pass, one utterance's fMLLR, adapted second pass); --single_speaker
    # aligns with final.alimdl only (aligner.gmm), as the corpus path does
    if aligner.two_pass:
        fm = aligner.fmllr
        sp1, _sc1 = decode(ff, aligner.si_gmm, aligner.si_use_emission_kernel)
        frame_pdf = bgraph.state_pdf.gather(1, sp1.long())
        K, G, beta = stats_to_host(*accumulate_fmllr_stats(
            ff[:, : frame_pdf.shape[1]],
            [Lf0],
            frame_pdf,
            [0],
            nonsilence_weight(frame_pdf, fm.sil_mask),
            fm.means, fm.inv_vars, fm.gconsts, fm.miv, 1,
        ))
        transforms = estimate_speaker_fmllr(K, G, beta,
                                            min_count=cfg.fmllr_min_count)
        aligner.last_fmllr = FmllrEstimate(K, G, beta, transforms)
        ff = apply_per_speaker_transform(
            ff, torch.zeros(1, dtype=torch.int64, device=dev),
            torch.from_numpy(transforms).to(dev),
        )

    sp, scores = decode(ff, aligner.gmm, aligner.use_emission_kernel)
    sp = sp.cpu().numpy().astype(np.int64)
    phone_f, word_f, inst_f, _ts = extract_frame_labels_host(garrs, sp)
    utt = Utterance(
        id=utterance_id,
        speaker="speaker",
        file_path=None,
        file_name="utterance",
        begin=0.0,
        end=len(samples) / aligner.mfcc_config.sample_rate,
        channel=0,
        text=text,
        normalized_tokens=tokens,
    )
    return frames_to_alignment(
        utt,
        graph.words,
        phone_f[0, :Lf0],
        word_f[0, :Lf0],
        inst_f[0, :Lf0],
        float(scores.cpu()[0]),
        aligner.model.phone_names,
        aligner.frame_shift,
    )
