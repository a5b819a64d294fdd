"""Phone-level transcription of an aligned corpus.

Counterpart of ``montreal_forced_aligner_tpu/transcription/phone_transcriber.py``
(reference ``WorkflowType.phone_transcription``): after alignment, a phone
LM is trained from the aligned phone sequences (reference
``train_phone_lm``) and every utterance is decoded against a graph whose
vocabulary is the phone set (reference ``DecodePhoneFunction``). ``align
--use_phone_model`` drives it and scores the free phone decode against the
forced alignment.

The phone decode is the exact dense decode of ``transcriber.py`` (kernel K3
for large models); the phone LM is the package's modified-Kneser-Ney
n-gram. Optional-silence arcs of the decoding graph stand in for silence
tokens, so silence labels are stripped from the LM training texts.
"""

from __future__ import annotations

import csv
import logging
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from montreal_forced_aligner_tpu_torch.data import CtmInterval

logger = logging.getLogger("mfa_tpu")


def transcribe_phones(
    acoustic_model_path,
    corpus,
    results,
    *,
    order: int = 2,
    batch_size: int = 16,
    acoustic_scale: float = 1.0 / 12,
    phone_lm=None,
    device="cuda",
) -> Dict[int, List[CtmInterval]]:
    """Free phone decode of ``corpus``, informed by its own alignments
    (``results``, the ``align_corpus`` output). Returns utterance id ->
    phone intervals. ``order`` 2 is the reference's align-path phone LM;
    ``phone_lm``, the archive's bundled phone LM, replaces the one trained
    here."""
    from montreal_forced_aligner_tpu_torch.transcription.transcriber import (
        Transcriber,
        train_phone_lm,
    )

    silence_labels = {"sil", "<eps>"}
    texts_results = {
        uid: [p.label for p in aln.phones if p.label not in silence_labels]
        for uid, aln in results.items()
    }
    if phone_lm is not None:
        logger.info("using the archive's bundled phone LM (phone_lm.arpa)")
        lm = phone_lm
    else:
        lm = train_phone_lm(
            {
                uid: _PhoneSeq(labels)
                for uid, labels in texts_results.items()
                if labels
            },
            order=order,
        )

    phone_vocab = sorted(
        {lab for labels in texts_results.values() for lab in labels}
    )
    if not phone_vocab:
        return {}

    with tempfile.TemporaryDirectory(prefix="mfa_tpu_phone_dict_") as tmp:
        dict_path = Path(tmp) / "phones.dict"
        with open(dict_path, "w") as f:
            for ph in phone_vocab:
                f.write(f"{ph}\t{ph}\n")
        tr = Transcriber(
            acoustic_model_path,
            dict_path,
            lm=lm,
            batch_size=batch_size,
            acoustic_scale=acoustic_scale,
            device=device,
        )
        decoded = tr.transcribe_corpus(corpus)

    return {
        uid: [CtmInterval(begin=w.begin, end=w.end, label=w.label)
              for w in res.words]
        for uid, res in decoded.items()
    }


class _PhoneSeq:
    """Gives ``train_phone_lm`` the ``.phones`` shape it expects."""

    __slots__ = ("phones",)

    def __init__(self, labels):
        self.phones = [CtmInterval(begin=0.0, end=0.0, label=l) for l in labels]


def evaluate_against_alignments(
    results,
    phone_transcripts: Dict[int, List[CtmInterval]],
    corpus,
    output_path: Optional[Path] = None,
    silence_phone: str = "sil",
) -> Tuple[Optional[float], float]:
    """Score the free phone decode against the forced alignment (reference
    ``evaluate_alignments(comparison_source=phone_transcription)``): per
    utterance the mean boundary-overlap error and the phone error rate,
    written as a CSV. Returns (mean overlap error, mean phone error rate)."""
    from montreal_forced_aligner_tpu_torch.evaluation import align_phones

    utt_by_id = {u.id: u for u in corpus.utterances}
    rows = []
    overlap_sum, overlap_n = 0.0, 0
    per_sum, per_n = 0.0, 0
    for uid, aln in results.items():
        hyp = phone_transcripts.get(uid)
        if hyp is None:
            continue
        ref = [p for p in aln.phones if p.label != silence_phone]
        score, per, _errors = align_phones(
            ref, [h for h in hyp if h.label != silence_phone],
            silence_phone=silence_phone,
        )
        utt = utt_by_id.get(uid)
        end = getattr(utt, "end", None)
        if end is None:  # whole-file utterance: report its duration
            end = getattr(utt, "begin", 0.0) + getattr(utt, "duration", 0.0)
        rows.append(
            {
                "file": getattr(utt, "file_name", str(uid)),
                "begin": getattr(utt, "begin", 0.0),
                "end": end,
                "speaker": getattr(utt, "speaker", ""),
                "overlap_score": "" if score is None else f"{score:.4f}",
                "phone_error_rate": f"{per:.4f}",
            }
        )
        if score is not None:
            overlap_sum += score
            overlap_n += 1
        per_sum += per
        per_n += 1
    if output_path is not None:
        output_path = Path(output_path)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        with open(output_path, "w", newline="") as f:
            writer = csv.DictWriter(
                f,
                fieldnames=["file", "begin", "end", "speaker", "overlap_score",
                            "phone_error_rate"],
            )
            writer.writeheader()
            writer.writerows(rows)
    mean_overlap = overlap_sum / overlap_n if overlap_n else None
    mean_per = per_sum / per_n if per_n else 1.0
    logger.info(
        "phone-transcription evaluation: overlap error %s, PER %.4f over %d "
        "utterances",
        "n/a" if mean_overlap is None else f"{mean_overlap:.4f}",
        mean_per,
        per_n,
    )
    return mean_overlap, mean_per
