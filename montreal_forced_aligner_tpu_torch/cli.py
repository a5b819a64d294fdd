"""Command-line interface of the PyTorch port.

    python -m montreal_forced_aligner_tpu_torch.cli align CORPUS DICT MODEL OUT_DIR \\
        [--device cuda] [--single_speaker] ...

Serves the options of the reference package's ``align`` command that this
port implements, plus ``--device``. Built on ``argparse`` so it needs
nothing beyond the standard library, numpy and torch.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


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
                        "single-pass with the speaker-independent model)")
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
                   choices=["long_textgrid", "short_textgrid", "json", "csv"])
    a.add_argument("--include_original_text", action="store_true")
    a.add_argument("-s", "--speaker_characters", default="0",
                   help="Speaker from the first N filename characters (or "
                        "'prosodylab'); default uses directory names")
    a.add_argument("-a", "--audio_directory", default=None,
                   help="Additional root searched for sound files")
    a.add_argument("--language", default=None,
                   help="Language-specific tokenizer: not ported yet, raises")
    return p


def _align(args) -> int:
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

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
    print(
        f"Aligned {len(results)} utterances -> {len(outs)} files in "
        f"{time.time() - t0:.1f}s on {aligner.device}"
    )
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
        return _align(args)
    except MFAError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
