"""Command-line interface of the PyTorch port.

    python -m montreal_forced_aligner_tpu_torch.cli align CORPUS DICT MODEL OUT_DIR \\
        [--device cuda] [--single_speaker] ...
    python -m montreal_forced_aligner_tpu_torch.cli align_one SOUND TEXT DICT MODEL OUT \\
        [--device cuda]
    python -m montreal_forced_aligner_tpu_torch.cli train CORPUS DICT OUTPUT_MODEL \\
        [--device cuda] [--config_path recipe.yaml] ...

Serves the options of the reference package's ``align``, ``align_one`` and
``train`` commands that this port implements, plus ``--device``; options
not ported yet raise, naming their ROADMAP item. Built on ``argparse`` so it needs
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
    _train_parser(sub)
    return p


def _train_parser(sub) -> None:
    t = sub.add_parser("train", help="Train an acoustic model mono -> tri -> "
                       "LDA+MLLT -> SAT")
    t.add_argument("corpus_directory")
    t.add_argument("dictionary_path")
    t.add_argument("output_model_path")
    t.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a card) "
                        "or cpu")
    t.add_argument("--output_directory", default=None,
                   help="Also align the corpus with the final model and "
                        "export TextGrids here")
    # None = not given: a --config_path value applies, else the default
    t.add_argument("--batch_size", type=int, default=None, help="default 16")
    t.add_argument("--graph_workers", type=int, default=None,
                   help="graph-compile processes: not ported yet, raises "
                        "above 0")
    t.add_argument("--num_iterations_scale", type=float, default=1.0,
                   help="Scale factor on per-stage iteration counts")
    t.add_argument("--working_directory", default=None,
                   help="Stage and iteration checkpoints for resume")
    t.add_argument("--seed", type=int, default=0,
                   help="RNG seed for Gaussian splits and subset sampling")
    t.add_argument("--checkpoint_interval", type=float, default=60.0,
                   help="Minimum seconds between per-iteration checkpoints "
                        "(0 = every iteration)")
    t.add_argument("--clean", action="store_true",
                   help="Wipe --working_directory and start fresh")
    t.add_argument("--position_dependent_phones", dest="position_dependent_phones",
                   action="store_true", default=None)
    t.add_argument("--no_position_dependent_phones",
                   dest="position_dependent_phones", action="store_false")
    t.add_argument("--features_on_host", action="store_true",
                   help="Keep feature batches in pinned host memory")
    t.add_argument("--phone_set_type", "--phone_set", default=None,
                   choices=["UNKNOWN", "AUTO", "ARPA", "IPA", "PINYIN"],
                   type=str.upper, help="default UNKNOWN")
    t.add_argument("-s", "--speaker_characters", default="0")
    t.add_argument("-a", "--audio_directory", default=None)
    t.add_argument("--output_format", default="long_textgrid",
                   choices=_OUTPUT_FORMATS)
    t.add_argument("--include_original_text", action="store_true")
    t.add_argument("--language", default=None,
                   help="Language-specific tokenizer: not ported yet, raises")
    t.add_argument("--config_path", default=None,
                   help="Yaml training recipe + parameters (the reference "
                        "schema)")
    t.add_argument("--rules_path", default=None,
                   help="Phonological rules: not ported yet, raises")
    t.add_argument("--topology_path", default=None)
    t.add_argument("--phone_groups_path", default=None)
    t.add_argument("--variable_length_topology", dest="variable_length_topology",
                   action="store_true", default=True)
    t.add_argument("--chain_topology", dest="variable_length_topology",
                   action="store_false")
    t.add_argument("--distributed", action="store_true",
                   help="Multi-GPU training: not ported yet, raises")
    t.add_argument("--profile_dir", default=None,
                   help="Write a torch.profiler trace of the run here")
    t.add_argument("--train_g2p", action="store_true",
                   help="G2P-trained pronunciation stages: not ported yet, "
                        "raises")


_TRAIN_STAGE_KINDS = {
    "monophone": "mono",
    "triphone": "tri",
    "lda": "lda",
    "sat": "sat",
    "pronunciation_probabilities": "pron_prob",
}
_STAGE_DEFAULT_ITERS = {"mono": 40, "tri": 35, "lda": 35, "sat": 35, "pron_prob": 0}


def _recipe_from_config(data):
    """Reference training-recipe yaml (``training:`` list of
    ``{stage_type: params}`` blocks) -> list of StageConfig. Unknown
    per-stage keys are reported and skipped."""
    from montreal_forced_aligner_tpu_torch.training.trainer import StageConfig

    known = {
        "num_iterations", "max_gaussians", "num_leaves", "subset", "quick",
        "train_g2p",
        # accepted for reference-config compatibility; not tunable here
        "cluster_threshold", "power", "boost_silence", "silence_weight",
        "fmllr_update_type", "features", "optional",
    }
    stages = []
    counts = {}
    for item in data.get("training", []):
        ((name, params),) = item.items()
        params = params or {}
        if name not in _TRAIN_STAGE_KINDS:
            raise ValueError(f"unknown training stage type: {name}")
        unknown = set(params) - known
        if unknown:
            print(f"config: ignoring unknown keys for stage {name}: "
                  f"{sorted(unknown)}")
        kind = _TRAIN_STAGE_KINDS[name]
        counts[name] = counts.get(name, 0) + 1
        stage_name = name if counts[name] == 1 else f"{name}_{counts[name]}"
        stages.append(
            StageConfig(
                stage_name,
                kind,
                num_iterations=int(
                    params.get("num_iterations", _STAGE_DEFAULT_ITERS[kind])
                ),
                max_gaussians=int(params.get("max_gaussians", 1000)),
                num_leaves=int(params.get("num_leaves", 0)),
                subset=int(params.get("subset", 0)),
                quick=bool(params.get("quick", params.get("optional", False))),
                train_g2p=bool(params.get("train_g2p", False)),
            )
        )
    return stages


def _train(args) -> int:
    """Train through the staged recipe (reference ``mfa train``,
    ``command_line/train_acoustic_model.py``)."""
    import contextlib
    from dataclasses import replace

    from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        DEFAULT_RECIPE,
        TrainableAligner,
    )

    t0 = time.time()
    data = {}
    if args.config_path:
        import yaml

        with open(args.config_path, encoding="utf8") as f:
            data = yaml.safe_load(f) or {}
    # precedence: defaults < config file < command line
    def setting(name, default):
        value = getattr(args, name)
        if value is not None:
            return value
        return data.get(name, default)

    batch_size = int(setting("batch_size", 16))
    graph_workers = int(setting("graph_workers", 0))
    position_dependent = bool(setting("position_dependent_phones", True))
    phone_set_type = str(setting("phone_set_type", "UNKNOWN")).upper()
    feats = data.get("features") or {}
    use_pitch = bool(feats.get("use_pitch", False))
    mfcc_config = None
    if "frame_shift" in feats or "use_energy" in feats:
        from montreal_forced_aligner_tpu_torch.ops.mfcc import MfccConfig

        mfcc_config = MfccConfig(
            frame_shift_ms=float(feats.get("frame_shift", 10)),
            use_energy=bool(feats.get("use_energy", False)),
        )
    recipe = _recipe_from_config(data) if data.get("training") else DEFAULT_RECIPE
    recipe = [
        replace(
            st,
            num_iterations=max(2, int(st.num_iterations * args.num_iterations_scale))
            if st.num_iterations
            else 0,
            train_g2p=st.train_g2p or (args.train_g2p and st.kind == "pron_prob"),
        )
        for st in recipe
    ]
    if args.clean and args.working_directory is not None:
        wd = Path(args.working_directory)
        if wd.exists():
            shutil.rmtree(wd)
            print(f"Cleaned working directory {wd}")
    ta = TrainableAligner(
        args.corpus_directory, args.dictionary_path, recipe=recipe,
        base_config=TrainerConfig(
            checkpoint_interval_s=float(args.checkpoint_interval),
            seed=int(args.seed),
        ),
        batch_size=batch_size, working_directory=args.working_directory,
        speaker_characters=args.speaker_characters,
        audio_directory=args.audio_directory,
        position_dependent_phones=position_dependent,
        features_on_host=args.features_on_host,
        phone_set_type=phone_set_type,
        num_graph_workers=graph_workers,
        use_pitch=use_pitch,
        mfcc_config=mfcc_config,
        rules_path=args.rules_path,
        topology_path=args.topology_path,
        phone_groups_path=args.phone_groups_path,
        variable_length_topology=args.variable_length_topology,
        distributed=args.distributed,
        language=args.language,
        device=args.device,
    )
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if ta.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        trace_cm = profile(activities=activities)
    else:
        trace_cm = contextlib.nullcontext()
    with trace_cm as prof:
        ta.train()
    if args.profile_dir:
        out = Path(args.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "train_trace.json"))
    ta.export_model(args.output_model_path)
    print(f"Saved model to {args.output_model_path}")
    if args.output_directory is not None:
        from montreal_forced_aligner_tpu_torch.align.aligner import (
            AlignerConfig,
            PretrainedAligner,
        )
        from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

        aligner = PretrainedAligner(
            args.output_model_path, args.dictionary_path,
            AlignerConfig(batch_size=batch_size), device=args.device,
        )
        corpus = Corpus.load(
            args.corpus_directory,
            speaker_characters=args.speaker_characters,
            audio_directory=args.audio_directory,
        )
        results = aligner.align_corpus(corpus)
        outs = aligner.export_textgrids(
            corpus, results, args.output_directory,
            output_format=args.output_format,
            include_original_text=args.include_original_text,
        )
        print(f"Exported {len(outs)} TextGrids to {args.output_directory}")
    print(f"Done! Everything took {time.time() - t0:.1f} seconds on {ta.device}")
    return 0


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
        run = {"align": _align, "align_one": _align_one, "train": _train}
        return run[args.command](args)
    except MFAError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
