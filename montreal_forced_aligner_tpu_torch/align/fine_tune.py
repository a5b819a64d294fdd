"""Fine-tuning of phone boundaries at 1 ms resolution.

Behavioral spec: reference ``FineTuneFunction``
(``alignment/multiprocessing.py:1127-1345``): for each phone boundary, take
a ±1.5-frame (15 ms) window around it, recompute features at 1 ms frame
shift over a 3x-padded span, align a two-phone graph, and move the boundary
to where the Viterbi path switches phones; then cascade-fix overlaps.

Counterpart of ``montreal_forced_aligner_tpu/align/fine_tune.py``: every
boundary in the corpus becomes one row of a padded (N, T_w, D) batch of
micro-windows with a tiny two-phone graph, all aligned in one batched
dense-Viterbi call on the aligner's device, instead of the reference's
per-boundary C++ aligner invocations. The windows' graphs never fit a band,
so this is the dense recursion at acoustic scale 1.0, in plain PyTorch. The
emissions follow the aligner's rule for the final model: all pdfs and a
gather (as the reference package computes them) below the state-emission
kernel's threshold, the kernel K3 above it, where the all-pdf product of a
2048-window batch would need tens of GB.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
from montreal_forced_aligner_tpu_torch.data import UtteranceAlignment
from montreal_forced_aligner_tpu_torch.graph.compiler import (
    _GraphBuilder,
    batch_graphs,
    ship_graph_to_device,
)
from montreal_forced_aligner_tpu_torch.ops.feats import compute_deltas, splice_frames, apply_transform
from montreal_forced_aligner_tpu_torch.ops.mfcc import MfccConfig, compute_mfcc_batch
from montreal_forced_aligner_tpu_torch.ops.pitch import PitchConfig, pitch_for_mfcc_frames


@dataclass
class _BoundaryJob:
    utt_id: int
    phone_index: int  # index into alignment.phones of the *current* phone
    feat_begin: float  # feature window start (utterance-relative seconds)
    seg_start_frame: int  # 1ms frames into the feature window
    seg_end_frame: int
    graph_index: int


def _two_phone_graph(compiler, prev_window, cur_window, prev_phone, cur_phone):
    """Tiny linear graph: phone A then phone B (no optional silence; the
    boundary is between known phones)."""
    g = _GraphBuilder()
    plan_a = compiler._phone_plan(prev_window)
    plan_b = compiler._phone_plan(cur_window)
    entry_a, exits_a = compiler._expand_plan(g, plan_a, prev_phone, 0)
    entry_b, exits_b = compiler._expand_plan(g, plan_b, cur_phone, 1)
    for s, w, tid in exits_a:
        g.add_arc(s, entry_b, w, tid)
    g.add_start(entry_a, 0.0)
    for s, w, tid in exits_b:
        g.add_final(s, w, tid)
    return g.finish(["a", "b"])


def fine_tune_alignments(
    aligner,
    corpus: Corpus,
    results: Dict[int, UtteranceAlignment],
    batch_size: int = 2048,
    padding_frames: float = 1.5,
    feature_padding_factor: int = 3,
) -> Dict[int, UtteranceAlignment]:
    """Refine all phone boundaries to 1 ms; returns updated results. On an
    aligner's mesh of several ranks the boundary windows shard as align
    batches do: each rank refines its own speakers' utterances and every
    rank returns all of them."""
    mesh = getattr(aligner, "mesh", None)
    if mesh is None or mesh.world_size == 1:
        return _fine_tune_local(aligner, corpus, results, batch_size,
                                padding_frames, feature_padding_factor)
    from montreal_forced_aligner_tpu_torch.parallel.multihost import (
        host_allgather_object,
        shard_corpus,
    )

    sub, ids = shard_corpus(corpus)
    mine = {}
    if ids:
        local = {new: results[old] for new, old in enumerate(ids)
                 if old in results}
        tuned = _fine_tune_local(aligner, sub, local, batch_size,
                                 padding_frames, feature_padding_factor)
        mine = {ids[new]: aln for new, aln in tuned.items()}
    for part in host_allgather_object(mine):
        results.update(part)
    results.update(mine)
    return results


def _fine_tune_local(
    aligner,
    corpus: Corpus,
    results: Dict[int, UtteranceAlignment],
    batch_size: int,
    padding_frames: float,
    feature_padding_factor: int,
) -> Dict[int, UtteranceAlignment]:
    """``fine_tune_alignments`` on this process's device."""
    base_cfg = aligner.mfcc_config
    fine_cfg = MfccConfig(
        sample_rate=base_cfg.sample_rate,
        frame_shift_ms=1.0,
        frame_length_ms=base_cfg.frame_length_ms,
        num_coefficients=base_cfg.num_coefficients,
        num_mel_bins=base_cfg.num_mel_bins,
        low_frequency=base_cfg.low_frequency,
        high_frequency=base_cfg.high_frequency,
    )
    fs = aligner.frame_shift  # original (seconds)
    pad = round(fs * padding_frames, 3)
    feat_pad = pad * feature_padding_factor
    sil_phone = aligner.lexicon.silence_phone_id

    # collect boundary jobs + their graphs and window waves
    jobs: List[_BoundaryJob] = []
    graphs = []
    waves = []
    spk_means = []
    utt_cache: Dict[int, np.ndarray] = {}

    # speaker CMVN means recomputed from the aligned corpus features cache is
    # unavailable here; recompute quickly per speaker from raw MFCCs
    spk_mean = _speaker_means(aligner, corpus)

    N3 = aligner.model.tree.N == 3
    for utt in corpus.utterances:
        if utt.id not in results:
            continue
        aln = results[utt.id]
        phones = aln.phones
        if len(phones) < 2:
            continue
        if utt.id not in utt_cache:
            utt_cache[utt.id] = corpus.load_audio(utt).samples
        wave = utt_cache[utt.id]
        utt_dur = len(wave) / fine_cfg.sample_rate
        for i in range(1, len(phones)):
            prev = phones[i - 1]
            cur = phones[i]
            if prev.phone_id is None or cur.phone_id is None:
                continue
            boundary = cur.begin - utt.begin  # utterance-relative
            seg_begin = max(round(boundary - pad, 4), 0.0)
            seg_end = round(min(boundary + pad, cur.end - utt.begin), 4)
            feat_begin = max(round(boundary - feat_pad, 4), 0.0)
            feat_end = min(round(boundary + feat_pad, 4), utt_dur)
            if seg_end - seg_begin < 0.004:
                continue
            s0 = int(round((seg_begin - feat_begin) * 1000))
            s1 = int(round((seg_end - feat_begin) * 1000))
            lctx = phones[i - 2].phone_id if i >= 2 else 0
            rctx = phones[i + 1].phone_id if i + 1 < len(phones) else 0
            if N3:
                prev_window = (lctx, prev.phone_id, cur.phone_id)
                cur_window = (prev.phone_id, cur.phone_id, rctx)
            else:
                prev_window = (prev.phone_id,)
                cur_window = (cur.phone_id,)
            g = _two_phone_graph(
                aligner.compiler, prev_window, cur_window, prev.phone_id, cur.phone_id
            )
            a = int(round(feat_begin * fine_cfg.sample_rate))
            b = int(round(feat_end * fine_cfg.sample_rate))
            waves.append(wave[a:b])
            graphs.append(g)
            spk_means.append(spk_mean[corpus.speaker_index[utt.speaker]])
            jobs.append(
                _BoundaryJob(utt.id, i, feat_begin, s0, s1, len(graphs) - 1)
            )

    if not jobs:
        return results

    from montreal_forced_aligner_tpu_torch.align.aligner import (
        _emission_kernel_eligible,
        _emit_and_align,
    )

    dev = aligner.device
    # a pitch model's pitch at the fine-tune's 1 ms grid, each window's
    # computed on its own samples as the reference computes each segment's
    # features (a row's pitch does not depend on the rows batched with it)
    window_pitch: Dict[int, np.ndarray] = {}
    if aligner.use_pitch:
        pitch_cfg = PitchConfig(frame_shift_ms=1.0)
        for lo in range(0, len(jobs), batch_size):
            part = [j.graph_index for j in jobs[lo : lo + batch_size]]
            lens = np.array([len(waves[g]) for g in part], np.int32)
            buf = np.zeros((len(part), int(lens.max())), np.float32)
            for r, g in enumerate(part):
                buf[r, : lens[r]] = waves[g]
            counts = np.array([fine_cfg.num_frames(int(n)) for n in lens], np.int32)
            out = pitch_for_mfcc_frames(buf, lens, counts, int(counts.max()),
                                        pitch_cfg, device=dev)
            window_pitch.update((g, out[r, : counts[r]]) for r, g in enumerate(part))
    # the final model with the aligner's silence boost, whichever model
    # aligned the corpus (the reference package's fine-tune reads it too)
    gmm = aligner._prepare_gmm()
    use_kernel = _emission_kernel_eligible(gmm.num_pdfs, gmm.num_gauss)
    lda = gmm.lda
    new_begins: Dict[Tuple[int, int], float] = {}

    for lo in range(0, len(jobs), batch_size):
        chunk = jobs[lo : lo + batch_size]
        wave_chunk = [waves[j.graph_index] for j in chunk]
        L = max(len(w) for w in wave_chunk)
        feats, flens = compute_mfcc_batch(
            wave_chunk, cfg=fine_cfg, padded_len=((L + 159) // 160) * 160,
            device=dev,
        )
        mean_stack = np.stack([spk_means[j.graph_index] for j in chunk])
        mean_rows = torch.from_numpy(mean_stack).to(dev)
        x = feats - mean_rows[:, None, :]
        if window_pitch:
            # pasted after CMVN and before deltas or splice+LDA, as phase A
            # pastes it at 10 ms
            T = int(x.shape[1])
            pitch = np.zeros((len(chunk), T, pitch_cfg.num_feature_dims), np.float32)
            for r, j in enumerate(chunk):
                rows = window_pitch[j.graph_index][:T]
                pitch[r, : len(rows)] = rows
            x = torch.cat([x, torch.from_numpy(pitch).to(dev)], dim=-1)
        flens_j = torch.from_numpy(flens).to(dev)
        if lda is None:
            ff = compute_deltas(x, flens_j)
        else:
            ff = apply_transform(splice_frames(x, flens_j, 3, 3), lda)
        # slice each row to its [s0, s1) window (lengths vary; use a padded
        # aligned slice with per-row start offsets via host roll)
        ff_host = ff.cpu().numpy()
        Tw = max(j.seg_end_frame - j.seg_start_frame for j in chunk)
        D = ff_host.shape[2]
        win = np.zeros((len(chunk), Tw, D), np.float32)
        wlens = np.zeros(len(chunk), np.int32)
        for r, j in enumerate(chunk):
            n = min(j.seg_end_frame, int(flens[r])) - j.seg_start_frame
            n = max(n, 1)
            win[r, :n] = ff_host[r, j.seg_start_frame : j.seg_start_frame + n]
            wlens[r] = n
        garrs = batch_graphs([graphs[j.graph_index] for j in chunk])
        graph = ship_graph_to_device(garrs, dev)
        state_path, _scores = _emit_and_align(
            torch.from_numpy(win).to(dev), torch.from_numpy(wlens).to(dev),
            graph, gmm, 1.0, use_emission_kernel=use_kernel,
        )
        sp = state_path.cpu().numpy().astype(np.int64)
        b_idx = np.arange(sp.shape[0])[:, None]
        word_f = garrs["state_word"][b_idx, sp]  # 0 = phone A, 1 = phone B
        for r, j in enumerate(chunk):
            n = int(wlens[r])
            switch = np.argmax(word_f[r, :n] == 1)
            if word_f[r, switch] != 1:  # never switched; keep original
                continue
            new_begin = j.feat_begin + (j.seg_start_frame + switch) * 0.001
            new_begins[(j.utt_id, j.phone_index)] = new_begin

    # apply + cascade overlap fixes (reference interval_mapping loop)
    for utt in corpus.utterances:
        if utt.id not in results:
            continue
        aln = results[utt.id]
        for i, p in enumerate(aln.phones):
            nb = new_begins.get((utt.id, i))
            if nb is None:
                continue
            p.begin = round(nb + utt.begin, 4)
        # make intervals contiguous and drop empties
        phones = aln.phones
        for i in range(len(phones) - 1):
            phones[i].end = phones[i + 1].begin
        aln.phones = [p for p in phones if p.end - p.begin > 1e-6]
        # refresh word boundaries from their phones
        for w in aln.words:
            if w.phones:
                w.phones = [p for p in w.phones if p.end - p.begin > 1e-6]
                if w.phones:
                    w.begin = w.phones[0].begin
                    w.end = w.phones[-1].end
    return results


def _speaker_means(aligner, corpus: Corpus) -> np.ndarray:
    """Per-speaker CMVN means over the corpus (mirrors the align pipeline)."""
    from montreal_forced_aligner_tpu_torch.align.aligner import _mfcc_and_sums, _round_up
    from montreal_forced_aligner_tpu_torch.ops.mfcc import pad_waves_for_mfcc

    dev = aligner.device

    D = aligner.mfcc_config.num_coefficients
    S = len(corpus.speakers)
    sums = np.zeros((S, D))
    counts = np.zeros(S)
    speaker_index = corpus.speaker_index
    waves = [corpus.load_audio(u).samples for u in corpus.utterances]
    bs = aligner.config.batch_size
    for lo in range(0, len(waves), bs):
        chunk = waves[lo : lo + bs]
        L = _round_up(max(len(w) for w in chunk), 16000)
        padded, lens = pad_waves_for_mfcc(chunk, aligner.mfcc_config, L)
        flens = np.array(
            [aligner.mfcc_config.num_frames(int(n)) for n in lens], np.int32
        )
        _feats, ssum = _mfcc_and_sums(
            torch.from_numpy(padded).to(dev),
            torch.from_numpy(flens).to(dev),
            aligner.mfcc_config,
            aligner.mfcc_config.num_frames(L),
        )
        ssum = ssum.cpu().numpy()
        for r, u in enumerate(corpus.utterances[lo : lo + bs]):
            s = speaker_index[u.speaker]
            sums[s] += ssum[r]
            counts[s] += flens[r]
    return (sums / np.maximum(counts, 1.0)[:, None]).astype(np.float32)
