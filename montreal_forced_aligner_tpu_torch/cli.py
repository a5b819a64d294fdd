"""Command-line interface of the PyTorch port.

    python -m montreal_forced_aligner_tpu_torch.cli align CORPUS DICT MODEL OUT_DIR \\
        [--device cuda] [--single_speaker] ...
    python -m montreal_forced_aligner_tpu_torch.cli align_one SOUND TEXT DICT MODEL OUT \\
        [--device cuda]

Serves the options of the reference package's ``align`` and ``align_one``
commands that this port implements, plus ``--device``; options not ported
yet raise, naming their ROADMAP item. Built on ``argparse`` so it needs
nothing beyond the standard library, numpy and torch.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

_OUTPUT_FORMATS = ["long_textgrid", "short_textgrid", "json", "csv"]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mfa-tpu-torch")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="INFO-level progress logs")
    sub = p.add_subparsers(dest="command", required=True)
    a = sub.add_parser("align", help="Align a corpus to word/phone TextGrids")
    a.add_argument("corpus_directory")
    a.add_argument("dictionary_path")
    a.add_argument("acoustic_model_path")
    a.add_argument("output_directory")
    a.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a card) "
                        "or cpu")
    a.add_argument("--beam", type=int, default=10,
                   help="kept for MFA CLI parity; the DP is exact")
    a.add_argument("--retry_beam", type=int, default=40)
    a.add_argument("--boost_silence", type=float, default=1.0)
    a.add_argument("--batch_size", type=int, default=16)
    a.add_argument("--single_speaker", action="store_true",
                   help="Disable speaker adaptation (SAT models align "
                        "single-pass with the speaker-independent model "
                        "instead of the fMLLR two-pass)")
    a.add_argument("--include_silence", dest="include_silence",
                   action="store_true", default=False)
    a.add_argument("--no_include_silence", dest="include_silence",
                   action="store_false")
    a.add_argument("--textgrid_cleanup", dest="textgrid_cleanup",
                   action="store_true", default=None,
                   help="Strip silence intervals from exports "
                        "(= --no_include_silence)")
    a.add_argument("--no_textgrid_cleanup", dest="textgrid_cleanup",
                   action="store_false")
    a.add_argument("--output_format", default="long_textgrid",
                   choices=_OUTPUT_FORMATS)
    a.add_argument("--include_original_text", action="store_true")
    a.add_argument("-s", "--speaker_characters", default="0",
                   help="Speaker from the first N filename characters (or "
                        "'prosodylab'); default uses directory names")
    a.add_argument("-a", "--audio_directory", default=None,
                   help="Additional root searched for sound files")
    a.add_argument("--language", default=None,
                   help="Language-specific tokenizer: not ported yet, raises")
    a.add_argument("--fine_tune", action="store_true",
                   help="1 ms boundary refinement: not ported yet, raises")
    a.add_argument("--use_phone_model", action="store_true",
                   help="Phone-transcript evaluation: not ported yet, raises")
    o = sub.add_parser("align_one", help="Align a single utterance")
    o.add_argument("sound_file")
    o.add_argument("text_file")
    o.add_argument("dictionary_path")
    o.add_argument("acoustic_model_path")
    o.add_argument("output_path")
    o.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a card) "
                        "or cpu")
    o.add_argument("--output_format", default="long_textgrid",
                   choices=_OUTPUT_FORMATS)
    return p


def _align(args) -> int:
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    for flag in ("fine_tune", "use_phone_model"):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag}: ROADMAP.md Queue 1 item 11 (alignment extras)")
    include_silence = args.include_silence
    if args.textgrid_cleanup is not None:
        include_silence = not args.textgrid_cleanup
    t0 = time.time()
    config = AlignerConfig(
        beam=args.beam,
        retry_beam=args.retry_beam,
        boost_silence=args.boost_silence,
        batch_size=args.batch_size,
        uses_speaker_adaptation=not args.single_speaker,
        language=args.language,
    )
    aligner = PretrainedAligner(
        args.acoustic_model_path, args.dictionary_path, config,
        device=args.device,
    )
    corpus = Corpus.load(
        args.corpus_directory,
        speaker_characters=args.speaker_characters,
        audio_directory=args.audio_directory,
    )
    print(
        f"Loaded corpus: {corpus.num_utterances} utterances, "
        f"{len(corpus.speakers)} speakers"
    )
    results = aligner.align_corpus(corpus)
    outs = aligner.export_textgrids(
        corpus,
        results,
        args.output_directory,
        include_silence=include_silence,
        output_format=args.output_format,
        include_original_text=args.include_original_text,
    )
    # alignment quality analysis: the reference always runs it after align
    # (``command_line/align.py:124``)
    from montreal_forced_aligner_tpu_torch.align.analysis import (
        analyze_alignments,
        csv_report,
    )

    analyses, flagged = analyze_alignments(results)
    csv_report(analyses, corpus,
               Path(args.output_directory) / "alignment_analysis.csv")
    if flagged:
        print(f"Flagged {len(flagged)} utterances with anomalous phone "
              "durations (see alignment_analysis.csv)")
    print(
        f"Aligned {len(results)} utterances -> {len(outs)} files in "
        f"{time.time() - t0:.1f}s on {aligner.device}"
    )
    return 0


def _align_one(args) -> int:
    """One utterance through ``align_corpus`` (reference
    ``command_line/align_one.py:85``): a corpus of one file."""
    from montreal_forced_aligner_tpu_torch.align.aligner import PretrainedAligner
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    aligner = PretrainedAligner(
        args.acoustic_model_path, args.dictionary_path, device=args.device
    )
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp) / "corpus"
        d.mkdir()
        shutil.copy(args.sound_file, d / ("utt" + Path(args.sound_file).suffix))
        shutil.copy(args.text_file, d / "utt.lab")
        corpus = Corpus.load(d)
        results = aligner.align_corpus(corpus)
        out = Path(args.output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        paths = aligner.export_textgrids(
            corpus, results, Path(tmp) / "out", output_format=args.output_format
        )
        shutil.move(str(paths[0]), out)
    print(f"Wrote {args.output_path}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    import logging

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(message)s",
    )
    from montreal_forced_aligner_tpu_torch.exceptions import MFAError

    try:
        return _align(args) if args.command == "align" else _align_one(args)
    except MFAError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
