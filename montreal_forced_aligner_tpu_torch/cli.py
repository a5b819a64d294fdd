"""Command-line interface of the PyTorch port.

    python -m montreal_forced_aligner_tpu_torch.cli align CORPUS DICT MODEL OUT_DIR \\
        [--device cuda] [--single_speaker] [--fine_tune] ...
    python -m montreal_forced_aligner_tpu_torch.cli align_one SOUND TEXT DICT MODEL OUT
    python -m montreal_forced_aligner_tpu_torch.cli train CORPUS DICT OUTPUT_MODEL \\
        [--device cuda] [--config_path recipe.yaml] ...
    python -m montreal_forced_aligner_tpu_torch.cli adapt CORPUS DICT MODEL OUTPUT_MODEL
    python -m montreal_forced_aligner_tpu_torch.cli transcribe CORPUS DICT MODEL OUT_DIR \\
        [--language_model_path lm.arpa] [--nbest 8] [--evaluate] ...
    python -m montreal_forced_aligner_tpu_torch.cli train_ivector CORPUS OUTPUT_MODEL
    python -m montreal_forced_aligner_tpu_torch.cli diarize_speakers CORPUS IVECTOR_MODEL OUT_DIR
    python -m montreal_forced_aligner_tpu_torch.cli create_segments_vad CORPUS OUT_DIR
    python -m montreal_forced_aligner_tpu_torch.cli create_segments CORPUS DICT MODEL OUT_DIR
    python -m montreal_forced_aligner_tpu_torch.cli validate CORPUS DICT
    python -m montreal_forced_aligner_tpu_torch.cli evaluate_alignments REF_DIR TEST_DIR
    python -m montreal_forced_aligner_tpu_torch.cli train_lm SOURCE OUTPUT
    python -m montreal_forced_aligner_tpu_torch.cli train_dictionary CORPUS DICT MODEL OUT
    python -m montreal_forced_aligner_tpu_torch.cli train_g2p DICT OUTPUT_MODEL
    python -m montreal_forced_aligner_tpu_torch.cli g2p {WORD_LIST,CORPUS} G2P_MODEL OUT
    python -m montreal_forced_aligner_tpu_torch.cli validate_dictionary DICT
    python -m montreal_forced_aligner_tpu_torch.cli train_tokenizer PAIRS OUTPUT_MODEL
    python -m montreal_forced_aligner_tpu_torch.cli tokenize TEXT TOKENIZER_MODEL OUT
    python -m montreal_forced_aligner_tpu_torch.cli model {inspect,add,save,add_words,list,download}
    python -m montreal_forced_aligner_tpu_torch.cli {version,configure,history}

Serves the reference package's commands that this port implements, with
their options, plus ``--device`` on the commands that run on a device.

Several cards: ``python -m torch.distributed.run --nproc_per_node N -m
montreal_forced_aligner_tpu_torch.cli {align,train,validate,transcribe} ...
--distributed`` (one rank a card on NCCL; ``MFA_TPU_TORCH_DIST_BACKEND=gloo``
lets ranks share cards, and ``--device cpu`` runs the ranks on the CPU over
gloo). Each rank works on its own speakers; ``align`` and ``transcribe``
ranks export their own files, ``train`` reduces the statistics over the
ranks and rank 0 writes the model.
Options whose work is not ported yet parse and then raise
``NotImplementedError`` naming their ROADMAP item. Built on ``argparse`` so
it needs nothing beyond the standard library, numpy, torch and yaml.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

_OUTPUT_FORMATS = ["long_textgrid", "short_textgrid", "json", "csv"]

_logger = logging.getLogger("mfa_tpu")


def _flag(p, name: str, default, help: str = None, negative: str = None) -> None:
    """``--name`` / ``--no_name`` (or ``negative``) setting one destination."""
    p.add_argument(f"--{name}", dest=name, action="store_true", default=default,
                   help=help)
    p.add_argument(f"--{negative or 'no_' + name}", dest=name,
                   action="store_false")


def _num_jobs(p) -> None:
    """The reference's ``-j/--num_jobs``: accepted and logged. Parallelism
    here is batch- and device-driven, not worker processes."""
    p.add_argument("-j", "--num_jobs", type=int, default=None,
                   help="Accepted for reference-CLI compatibility; "
                        "parallelism is batch/device-driven here")


def _device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a card) "
                        "or cpu")


def _align_parser(sub) -> None:
    a = sub.add_parser("align", help="Align a corpus to word/phone TextGrids")
    _num_jobs(a)
    a.add_argument("corpus_directory")
    a.add_argument("dictionary_path")
    a.add_argument("acoustic_model_path")
    a.add_argument("output_directory")
    _device(a)
    # None = not given: a --config_path value applies, else the default
    a.add_argument("--beam", type=int, default=None,
                   help="kept for MFA CLI parity; the DP is exact (default 10)")
    a.add_argument("--retry_beam", type=int, default=None, help="default 40")
    a.add_argument("--boost_silence", type=float, default=None, help="default 1.0")
    a.add_argument("--batch_size", type=int, default=None, help="default 16")
    a.add_argument("--graph_workers", type=int, default=None,
                   help="Processes for host graph compilation of "
                        "context-dependent trees (0 = in-process; default 0)")
    _flag(a, "distributed", None,
          "Multi-GPU alignment: under torch.distributed.run each rank aligns "
          "its own speakers and exports their files; in one process, batches "
          "round-robin over the local cards (default: on under several ranks)")
    _flag(a, "include_silence", None)
    a.add_argument("--textgrid_cleanup", dest="textgrid_cleanup",
                   action="store_true", default=None,
                   help="Strip silence intervals from exports "
                        "(= --no_include_silence)")
    a.add_argument("--no_textgrid_cleanup", dest="textgrid_cleanup",
                   action="store_false")
    _flag(a, "use_phone_model", None,
          "After alignment, decode a free phone transcription with a phone "
          "LM trained from the alignments and evaluate it against the "
          "forced alignment (supersedes --fine_tune)")
    _flag(a, "fine_tune", None, "Refine boundaries at 1 ms resolution")
    a.add_argument("--transfer_mode", default="auto",
                   choices=["auto", "waves", "features"],
                   help="Host->device payload of phase A: waves, or float16 "
                        "MFCC features computed on the host; auto probes the "
                        "link and ships features below "
                        "MFA_TPU_TRANSFER_THRESHOLD_MBPS (default 25), waves "
                        "on the CPU (MFA_TPU_TRANSFER_MODE overrides)")
    a.add_argument("--single_speaker", action="store_true",
                   help="Disable speaker adaptation (SAT models align "
                        "single-pass with the speaker-independent model "
                        "instead of the fMLLR two-pass)")
    a.add_argument("--g2p_model_path", default=None,
                   help="G2P model: OOV words get generated pronunciations")
    a.add_argument("--rules_path", default=None,
                   help="Phonological rules yaml for pronunciation variants")
    a.add_argument("--profile_dir", default=None,
                   help="Write a torch.profiler trace of the alignment here")
    a.add_argument("--config_path", default=None,
                   help="Yaml parameter file (reference --config_path "
                        "semantics: command line > config file > defaults)")
    a.add_argument("--output_format", default=None, choices=_OUTPUT_FORMATS,
                   help="default long_textgrid")
    a.add_argument("--include_original_text", action="store_true")
    a.add_argument("-s", "--speaker_characters", default="0",
                   help="Speaker from the first N filename characters (or "
                        "'prosodylab'); default uses directory names")
    a.add_argument("-a", "--audio_directory", default=None,
                   help="Additional root searched for sound files")
    a.add_argument("--reference_directory", default=None,
                   help="Gold-standard alignments to evaluate against")
    a.add_argument("--custom_mapping_path", default=None,
                   help="Yaml mapping phones across phone sets for evaluation")
    a.add_argument("--language", default=None,
                   help="Language-specific tokenizer (english, japanese, "
                        "chinese, korean, thai)")


def _train_parser(sub) -> None:
    t = sub.add_parser("train", help="Train an acoustic model mono -> tri -> "
                       "LDA+MLLT -> SAT")
    _num_jobs(t)
    t.add_argument("corpus_directory")
    t.add_argument("dictionary_path")
    t.add_argument("output_model_path")
    _device(t)
    t.add_argument("--output_directory", default=None,
                   help="Also align the corpus with the final model and "
                        "export TextGrids here")
    # None = not given: a --config_path value applies, else the default
    t.add_argument("--batch_size", type=int, default=None, help="default 16")
    t.add_argument("--graph_workers", type=int, default=None,
                   help="Processes for host graph compilation of "
                        "context-dependent trees (0 = in-process; default 0)")
    t.add_argument("--num_iterations_scale", type=float, default=1.0,
                   help="Scale factor on per-stage iteration counts")
    t.add_argument("--working_directory", default=None,
                   help="Stage and iteration checkpoints for resume")
    t.add_argument("--seed", type=int, default=0,
                   help="RNG seed for Gaussian splits and subset sampling")
    t.add_argument("--checkpoint_interval", type=float, default=60.0,
                   help="Minimum seconds between per-iteration checkpoints "
                        "(0 = every iteration)")
    _flag(t, "clean", False, "Wipe --working_directory and start fresh")
    _flag(t, "position_dependent_phones", None)
    _flag(t, "features_on_host", False,
          "Keep feature batches in pinned host memory",
          negative="features_on_device")
    t.add_argument("--phone_set_type", "--phone_set", default=None,
                   choices=["UNKNOWN", "AUTO", "ARPA", "IPA", "PINYIN"],
                   type=str.upper, help="default UNKNOWN")
    t.add_argument("-s", "--speaker_characters", default="0")
    t.add_argument("-a", "--audio_directory", default=None)
    t.add_argument("--output_format", default="long_textgrid",
                   choices=_OUTPUT_FORMATS)
    t.add_argument("--include_original_text", action="store_true")
    t.add_argument("--language", default=None,
                   help="Language-specific tokenizer (english, japanese, "
                        "chinese, korean, thai)")
    t.add_argument("--config_path", default=None,
                   help="Yaml training recipe + parameters (the reference "
                        "schema)")
    t.add_argument("--rules_path", default=None,
                   help="Phonological rules yaml applied to the dictionary")
    t.add_argument("--topology_path", default=None)
    t.add_argument("--phone_groups_path", default=None)
    t.add_argument("--variable_length_topology", dest="variable_length_topology",
                   action="store_true", default=True)
    t.add_argument("--chain_topology", dest="variable_length_topology",
                   action="store_false")
    _flag(t, "distributed", None,
          "Multi-GPU training: under torch.distributed.run each rank trains on "
          "its own speakers and the statistics are reduced over the ranks "
          "(default: on under several ranks)")
    t.add_argument("--profile_dir", default=None,
                   help="Write a torch.profiler trace of the run here")
    t.add_argument("--train_g2p", action="store_true",
                   help="Pronunciation-probability stages train a G2P model "
                        "on the aligned pronunciations and regenerate the "
                        "lexicon from it")


def _host_parsers(sub) -> None:
    """The commands over host modules and the aligner: adapt, validate,
    evaluate_alignments, train_lm, train_dictionary, model, version,
    configure and history."""
    d = sub.add_parser("adapt", help="MAP-adapt an acoustic model to a corpus")
    _num_jobs(d)
    d.add_argument("corpus_directory")
    d.add_argument("dictionary_path")
    d.add_argument("acoustic_model_path")
    d.add_argument("output_model_path")
    _device(d)
    d.add_argument("--mapping_tau", type=float, default=20.0)
    d.add_argument("--output_directory", default=None,
                   help="Also align the corpus with the adapted model and "
                        "export TextGrids here")
    d.add_argument("--output_format", default="long_textgrid",
                   choices=_OUTPUT_FORMATS)
    d.add_argument("--include_original_text", action="store_true")
    d.add_argument("-s", "--speaker_characters", default="0")
    d.add_argument("-a", "--audio_directory", default=None)

    v = sub.add_parser("validate", help="Validate a corpus + dictionary")
    _num_jobs(v)
    v.add_argument("corpus_directory")
    v.add_argument("dictionary_path")
    v.add_argument("--acoustic_model_path", default=None)
    _flag(v, "test_transcriptions", None,
          "Decode utterances against per-speaker LMs and report WER "
          "(flags likely transcript errors; needs --acoustic_model_path)")
    _device(v)
    _flag(v, "distributed", None,
          "Under torch.distributed.run each rank decodes its own speakers for "
          "--test_transcriptions and the WER is reduced over the ranks "
          "(default: on under several ranks)")
    v.add_argument("--ignore_acoustics", "--skip_acoustics",
                   dest="ignore_acoustics", action="store_true", default=None)
    v.add_argument("--no_ignore_acoustics", "--no_skip_acoustics",
                   dest="ignore_acoustics", action="store_false")
    v.add_argument("-s", "--speaker_characters", default=None,
                   help="default 0")
    v.add_argument("-a", "--audio_directory", default=None)
    v.add_argument("--output_directory", "--output_path", default=None,
                   help="Write oovs_found.txt / utterance_oovs.txt here")
    v.add_argument("--rules_path", default=None,
                   help="Phonological rules yaml applied to the dictionary "
                        "before validation")
    v.add_argument("--config_path", default=None)

    e = sub.add_parser("evaluate_alignments",
                       help="Compare two directories of TextGrids")
    e.add_argument("reference_directory")
    e.add_argument("test_directory")
    e.add_argument("--silence_phone", default="sil")
    e.add_argument("--custom_mapping_path", default=None)

    lm = sub.add_parser("train_lm", help="Train an n-gram language model")
    _num_jobs(lm)
    lm.add_argument("source_path")
    lm.add_argument("output_model_path")
    lm.add_argument("--order", type=int, default=3)
    lm.add_argument("--dictionary_path", default=None)
    lm.add_argument("--prune_thresh_small", type=float, default=0.0000003)
    lm.add_argument("--prune_thresh_medium", type=float, default=0.0000001)

    td = sub.add_parser("train_dictionary",
                        help="Estimate pronunciation and silence probabilities")
    _num_jobs(td)
    td.add_argument("corpus_directory")
    td.add_argument("dictionary_path")
    td.add_argument("acoustic_model_path")
    td.add_argument("output_dictionary_path")
    _device(td)
    td.add_argument("--batch_size", type=int, default=16)
    _flag(td, "silence_probabilities", True)
    td.add_argument("-s", "--speaker_characters", default="0")
    td.add_argument("-a", "--audio_directory", default=None)

    m = sub.add_parser("model", aliases=["models"], help="Model utilities")
    msub = m.add_subparsers(dest="model_command", required=True)
    mi = msub.add_parser("inspect")
    mi.add_argument("model_path")
    ma = msub.add_parser("add")
    ma.add_argument("model_type")
    ma.add_argument("path")
    ma.add_argument("--name", default=None)
    ms = msub.add_parser("save")
    ms.add_argument("model_type")
    ms.add_argument("path")
    ms.add_argument("--name", default=None)
    _flag(ms, "overwrite", False)
    mw = msub.add_parser("add_words")
    mw.add_argument("dictionary_path")
    mw.add_argument("new_pronunciations_path")
    ml = msub.add_parser("list")
    ml.add_argument("model_type", nargs="?", default=None)
    md = msub.add_parser("download")
    md.add_argument("model_type")
    md.add_argument("name")

    sub.add_parser("version", help="Print the package version")
    c = sub.add_parser("configure", help="Persist default options")
    c.add_argument("--profile", default=None)
    c.add_argument("--batch_size", type=int, default=None)
    c.add_argument("--seed", type=int, default=None)
    _flag(c, "clean", None)
    _flag(c, "debug", None)
    c.add_argument("--temporary_directory", default=None)
    h = sub.add_parser("history", help="Show recent command history")
    h.add_argument("--depth", type=int, default=10)


def _transcribe_parser(sub) -> None:
    t = sub.add_parser("transcribe", help="Transcribe a corpus against an LM")
    _num_jobs(t)
    t.add_argument("corpus_directory")
    t.add_argument("dictionary_path")
    t.add_argument("acoustic_model_path")
    t.add_argument("output_directory")
    _device(t)
    t.add_argument("--language_model_path", default=None,
                   help="ARPA LM or LanguageModel zip; trained from the "
                        "corpus transcripts if omitted")
    _flag(t, "distributed", None,
          "Under torch.distributed.run each rank decodes its own speakers and "
          "exports their transcripts (default: on under several ranks)")
    _flag(t, "evaluate", None, "Print WER and CER against the transcripts")
    t.add_argument("--batch_size", type=int, default=None, help="default 16")
    t.add_argument("--nbest", type=int, default=None,
                   help="Decode N-best hypotheses (determinized K-best "
                        "Viterbi; default 1)")
    t.add_argument("--rescore_lm_path", default=None,
                   help="Larger ARPA LM for N-best rescoring")
    t.add_argument("--rescore_weight", type=float, default=None,
                   help="LM weight during N-best rescoring (default "
                        "--language_model_weight)")
    t.add_argument("--language_model_weight", type=float, default=None,
                   help="LM scale during decoding (default 1.0)")
    t.add_argument("--word_insertion_penalty", type=float, default=None,
                   help="Per-word entry cost (default 0.0)")
    t.add_argument("--config_path", default=None,
                   help="Yaml parameter file (reference --config_path "
                        "semantics)")
    t.add_argument("--profile_dir", default=None,
                   help="Write a torch.profiler trace of the decode here")
    t.add_argument("--output_type", default="transcription",
                   choices=["transcription", "alignment"],
                   help="transcription: utterance-text tiers; alignment: "
                        "word/phone tiers of the decoded best path")
    t.add_argument("--output_format", default="long_textgrid",
                   choices=_OUTPUT_FORMATS)
    t.add_argument("--include_original_text", action="store_true")
    t.add_argument("-s", "--speaker_characters", default="0")
    t.add_argument("-a", "--audio_directory", default=None)


def _neural_parsers(sub) -> None:
    """The neural transcription backends: transcribe_whisper and
    transcribe_speechbrain."""
    for name, what in (("transcribe_whisper", "a local Whisper checkpoint "
                        "(Hugging Face directory)"),
                       ("transcribe_speechbrain", "a local SpeechBrain ASR "
                        "checkpoint (needs the speechbrain package)")):
        t = sub.add_parser(name, help=f"Transcribe a corpus with {what}")
        t.add_argument("corpus_directory")
        t.add_argument("model_path")
        t.add_argument("output_directory")
        _device(t)
        t.add_argument("--language", default=None, help="decoding language hint")
        t.add_argument("--profile_dir", default=None,
                       help="Write a torch.profiler trace of the transcription here")


def _segmentation_parsers(sub) -> None:
    """i-vectors, diarization and segmentation: train_ivector,
    diarize_speakers, create_segments_vad and create_segments."""
    t = sub.add_parser("train_ivector",
                       help="Train a UBM + i-vector extractor (+ PLDA)")
    _num_jobs(t)
    t.add_argument("corpus_directory")
    t.add_argument("output_model_path")
    _device(t)
    t.add_argument("--num_gauss", type=int, default=256)
    t.add_argument("--ivector_dim", type=int, default=192)
    t.add_argument("--num_iterations", type=int, default=10)
    t.add_argument("--batch_size", type=int, default=16)
    t.add_argument("--plda", dest="train_plda", action="store_true",
                   default=True,
                   help="Also train PLDA on the corpus's speaker-labelled "
                        "i-vectors and bundle it (default)")
    t.add_argument("--no_plda", dest="train_plda", action="store_false")

    d = sub.add_parser("diarize_speakers",
                       help="Cluster or classify utterances into speakers")
    _num_jobs(d)
    d.add_argument("corpus_directory")
    d.add_argument("ivector_extractor_path",
                   help="i-vector extractor (npz or reference archive), or "
                        "the literal 'speechbrain' for SpeechBrain x-vectors "
                        "(with --xvector_model_path)")
    d.add_argument("output_directory")
    _device(d)
    d.add_argument("--xvector_model_path", default=None,
                   help="Local SpeechBrain EncoderClassifier checkpoint for "
                        "'speechbrain' (needs the speechbrain package)")
    # None = not given: a --config_path value applies, else the default
    d.add_argument("--expected_num_speakers", type=int, default=None,
                   help="0 = threshold-based (default 0)")
    d.add_argument("--distance_threshold", type=float, default=None,
                   help="default 0.5")
    d.add_argument("--cluster_type", default=None,
                   choices=["agglomerative", "kmeans", "spectral", "dbscan",
                            "hdbscan", "optics", "affinity", "meanshift"],
                   help="Clustering algorithm (default agglomerative)")
    d.add_argument("--min_cluster_size", type=int, default=None,
                   help="Density methods: smallest cluster (default 15)")
    d.add_argument("--batch_size", type=int, default=None, help="default 16")
    d.add_argument("--evaluate", "--validate", dest="evaluate",
                   action="store_true", default=False,
                   help="Score the clustering against the corpus's speakers")
    d.add_argument("--no_evaluate", dest="evaluate", action="store_false")
    d.add_argument("--classify", dest="classify", action="store_true",
                   default=False,
                   help="Reassign each utterance to the best-scoring known "
                        "speaker (PLDA if bundled, else cosine)")
    d.add_argument("--cluster", dest="classify", action="store_false")
    d.add_argument("--metric", default=None, choices=["cosine", "plda"],
                   help="default cosine; plda needs a PLDA-bundled extractor")
    _flag(d, "visualize", False,
          "Write cluster_plot.png (needs sklearn and matplotlib)")
    d.add_argument("--manifold_algorithm", default=None,
                   choices=["tsne", "mds", "spectral", "isomap"],
                   help="default tsne")
    d.add_argument("--output_format", default=None, choices=_OUTPUT_FORMATS,
                   help="default long_textgrid")
    d.add_argument("--config_path", default=None)

    v = sub.add_parser("create_segments_vad",
                       help="Segment audio files by energy VAD")
    _num_jobs(v)
    v.add_argument("corpus_directory")
    v.add_argument("output_directory")
    _device(v)
    v.add_argument("--max_segment_length", type=float, default=30.0)
    v.add_argument("--min_segment_length", type=float, default=0.333)
    v.add_argument("--min_pause_duration", type=float, default=0.333)
    v.add_argument("--energy_threshold", type=float, default=5.5)
    v.add_argument("--speechbrain_model_path", default=None,
                   help="Local SpeechBrain VAD checkpoint: neural VAD in "
                        "place of the energy VAD (needs the speechbrain "
                        "package)")
    v.add_argument("--output_format", default="long_textgrid",
                   choices=_OUTPUT_FORMATS)

    c = sub.add_parser("create_segments",
                       help="Segment long transcribed files by alignment")
    _num_jobs(c)
    c.add_argument("corpus_directory")
    c.add_argument("dictionary_path")
    c.add_argument("acoustic_model_path")
    c.add_argument("output_directory")
    _device(c)
    c.add_argument("--max_segment_length", type=float, default=30.0)
    c.add_argument("--min_pause_duration", type=float, default=0.15,
                   help="Aligned silence gap that splits segments")


def _g2p_parsers(sub) -> None:
    """The host commands over G2P and tokenizer models: train_g2p, g2p,
    validate_dictionary, train_tokenizer and tokenize."""
    t = sub.add_parser("train_g2p",
                       help="Train a G2P model from a pronunciation dictionary")
    _num_jobs(t)
    t.add_argument("dictionary_path")
    t.add_argument("output_model_path")
    t.add_argument("--order", type=int, default=8, help="default 8")
    t.add_argument("--num_alignment_iterations", type=int, default=10,
                   help="default 10")
    t.add_argument("--evaluate", "--validate", dest="evaluation_mode",
                   action="store_true",
                   help="Hold out a random tenth of the dictionary, report "
                        "word accuracy and phone error rate on it")
    t.add_argument("--phonetisaurus", action="store_true",
                   help="Use the Phonetisaurus-style engine (many-to-many "
                        "chunked EM alignment + graphone n-gram); default is "
                        "the pair-ngram engine with random-start EM")
    t.add_argument("--random_starts", type=int, default=10,
                   help="Random EM starts for the pair-ngram engine "
                        "(default 10)")
    t.add_argument("--reference_format", action="store_true",
                   help="Write a reference-format G2P archive (binary "
                        "OpenFst model.fst + symbol tables) instead of the "
                        "graphone-LM zip")

    g = sub.add_parser("g2p", help="Generate pronunciations for a word list "
                       "or a corpus directory's vocabulary")
    _num_jobs(g)
    g.add_argument("input_path")
    g.add_argument("g2p_model_path")
    g.add_argument("output_path")
    # None = not given: a --config_path value applies, else the default
    g.add_argument("--num_pronunciations", type=int, default=None,
                   help="default 1")
    g.add_argument("--dictionary_path", default=None,
                   help="Existing dictionary: only OOV words get "
                        "pronunciations")
    g.add_argument("--include_bracketed", action="store_true", default=None,
                   help="Also generate for [bracketed]/(...)/<...> words")
    g.add_argument("--export_scores", action="store_true", default=None,
                   help="Add a column with each pronunciation's score")
    g.add_argument("--sorted", dest="sorted_output", action="store_true",
                   help="Sort the output alphabetically")
    g.add_argument("--config_path", default=None,
                   help="Yaml parameter file (reference --config_path "
                        "semantics)")

    v = sub.add_parser("validate_dictionary",
                       help="G2P-based dictionary QA")
    v.add_argument("dictionary_path")
    v.add_argument("--order", type=int, default=6, help="default 6")

    tt = sub.add_parser("train_tokenizer", help="Train a tokenizer from "
                        "tab-separated (raw, tokenized) lines")
    _num_jobs(tt)
    tt.add_argument("training_file")
    tt.add_argument("output_model_path")
    tt.add_argument("--order", type=int, default=6, help="default 6")
    tt.add_argument("--evaluate", "--validate", dest="evaluation_mode",
                    action="store_true",
                    help="Hold out a random tenth of the pairs and report "
                         "utterance accuracy and character error rate on it")
    tt.add_argument("--phonetisaurus", action="store_true",
                    help="Accepted for reference-CLI parity: the trainable "
                         "tokenizer is always the pair-ngram EM aligner")

    k = sub.add_parser("tokenize", help="Tokenize text with a trained "
                       "tokenizer")
    _num_jobs(k)
    k.add_argument("input_path")
    k.add_argument("tokenizer_model_path")
    k.add_argument("output_path")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mfa-tpu-torch")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="INFO-level progress logs")
    p.add_argument("-q", "--quiet", action="store_true", help="Errors only")
    p.add_argument("--debug", action="store_true",
                   help="DEBUG-level logs incl. per-phase timings")
    sub = p.add_subparsers(dest="command", required=True)
    _align_parser(sub)
    o = sub.add_parser("align_one", help="Align a single utterance")
    _num_jobs(o)
    o.add_argument("sound_file")
    o.add_argument("text_file")
    o.add_argument("dictionary_path")
    o.add_argument("acoustic_model_path")
    o.add_argument("output_path")
    _device(o)
    o.add_argument("--output_format", default="long_textgrid",
                   choices=_OUTPUT_FORMATS)
    _train_parser(sub)
    _transcribe_parser(sub)
    _neural_parsers(sub)
    _segmentation_parsers(sub)
    _host_parsers(sub)
    _g2p_parsers(sub)
    return p


def _load_command_config(config_path) -> dict:
    """Per-command yaml parameter file (reference ``--config_path``)."""
    import yaml

    with open(config_path, encoding="utf8") as f:
        return yaml.safe_load(f) or {}


def _settings(args, data: dict):
    """``setting(name, default)``: the command line's value when given,
    else the config file's, else ``default`` (the reference's precedence)."""

    def setting(name, default):
        value = getattr(args, name)
        if value is not None:
            return value
        return data.get(name, default)

    return setting


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


def _profiled(profile_dir, device, name: str):
    """A context that traces its body with ``torch.profiler`` and writes
    ``<profile_dir>/<name>`` as a Chrome trace, the port's spans drawn over
    their kernels; a no-op without a dir."""
    if not profile_dir:
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def trace():
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        from montreal_forced_aligner_tpu_torch import tracing

        with profile(activities=activities) as prof, tracing.on_card_timeline():
            yield
        out = Path(profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / name))

    return trace()


def _sharded(args) -> bool:
    """Whether this command splits its corpus over the ranks: ``--distributed``
    (None: on when several ranks run). The command decides: the aligner and
    the decoders work on the corpus they are given unless told otherwise."""
    from montreal_forced_aligner_tpu_torch.parallel import multihost

    flag = getattr(args, "distributed", None)
    return multihost.process_count() > 1 and flag is not False


def _aligner_distributed(args) -> bool:
    """``AlignerConfig.distributed`` of a command: sharded over the ranks
    (:func:`_sharded`), or round-robin over the local cards of one process
    with ``--distributed``."""
    return _sharded(args) or bool(getattr(args, "distributed", None))


def _rank_corpus(corpus, ids):
    """The utterances ``ids`` of ``corpus`` with their ids kept (what one rank
    exports)."""
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    utts = [corpus.utterances[i] for i in ids]
    return Corpus(utterances=utts, speakers=sorted({u.speaker for u in utts}),
                  files=dict(corpus.files))


def _rank_summary(command: str, device, utterances: int, t0: float) -> None:
    """One line per rank of a multi-process run: its utterances, wall,
    kernel launches and peak card memory."""
    import torch

    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.parallel import multihost

    if not multihost.is_initialized():
        return
    peak = (torch.cuda.max_memory_allocated(device)
            if device is not None and device.type == "cuda" else None)
    print("rank_summary " + json.dumps({
        "command": command, "rank": multihost.process_index(),
        "world_size": multihost.process_count(), "device": str(device),
        "utterances": utterances, "wall_s": time.time() - t0,
        "launches": dict(cuda_build.LAUNCHES), "peak_memory_bytes": peak,
    }), flush=True)


def _train(args) -> int:
    """Train through the staged recipe (reference ``mfa train``,
    ``command_line/train_acoustic_model.py``)."""
    from dataclasses import replace

    from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        DEFAULT_RECIPE,
        TrainableAligner,
    )

    t0 = time.time()
    data = _load_command_config(args.config_path) if args.config_path else {}
    setting = _settings(args, data)
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
    from montreal_forced_aligner_tpu_torch.parallel import multihost

    if args.clean and args.working_directory is not None:
        wd = Path(args.working_directory)
        # ranks share the working directory: rank 0 wipes it, and no rank
        # goes on before it has
        if multihost.process_index() == 0 and wd.exists():
            shutil.rmtree(wd)
            print(f"Cleaned working directory {wd}")
        multihost.host_barrier("train_clean")
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
    with _profiled(args.profile_dir, ta.device, "train_trace.json"):
        ta.train()
    # every rank holds the same model: rank 0 writes it
    if multihost.process_index() == 0:
        ta.export_model(args.output_model_path)
        print(f"Saved model to {args.output_model_path}")
    multihost.host_barrier("train_saved")
    _rank_summary("train", ta.device, ta.corpus.num_utterances, t0)
    if args.output_directory is not None:
        _align_and_export(args, args.output_model_path, batch_size)
    print(f"Done! Everything took {time.time() - t0:.1f} seconds on {ta.device}")
    return 0


def _align_and_export(args, model_path, batch_size: int = 16) -> None:
    """Align ``args.corpus_directory`` with ``model_path`` and export to
    ``args.output_directory`` (``train`` and ``adapt`` with
    ``--output_directory``)."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    aligner = PretrainedAligner(
        model_path, args.dictionary_path,
        AlignerConfig(batch_size=batch_size,
                      distributed=_aligner_distributed(args)),
        device=args.device,
    )
    corpus = Corpus.load(
        args.corpus_directory,
        speaker_characters=args.speaker_characters,
        audio_directory=args.audio_directory,
    )
    results = aligner.align_corpus(corpus)
    if aligner.mesh is not None and aligner.mesh.world_size > 1:
        corpus = _rank_corpus(corpus, aligner.last_shard)
    outs = aligner.export_textgrids(
        corpus, results, args.output_directory,
        output_format=args.output_format,
        include_original_text=args.include_original_text,
    )
    print(f"Exported {len(outs)} TextGrids to {args.output_directory}")


def _align(args) -> int:
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    data = _load_command_config(args.config_path) if args.config_path else {}
    setting = _settings(args, data)
    output_format = setting("output_format", "long_textgrid")
    if output_format not in _OUTPUT_FORMATS:
        raise ValueError(
            f"config output_format must be one of {_OUTPUT_FORMATS}, got "
            f"{output_format!r}"
        )
    fine_tune = bool(setting("fine_tune", False))
    use_phone_model = bool(setting("use_phone_model", False))
    include_silence = bool(setting("include_silence", False))
    # after the config: an explicit flag always wins
    if args.textgrid_cleanup is not None:
        include_silence = not args.textgrid_cleanup
    t0 = time.time()
    config = AlignerConfig(
        beam=int(setting("beam", 10)),
        retry_beam=int(setting("retry_beam", 40)),
        boost_silence=float(setting("boost_silence", 1.0)),
        batch_size=int(setting("batch_size", 16)),
        num_graph_workers=int(setting("graph_workers", 0)),
        uses_speaker_adaptation=not args.single_speaker,
        language=args.language,
        transfer_mode=args.transfer_mode,
        distributed=_aligner_distributed(args),
    )
    aligner = PretrainedAligner(
        args.acoustic_model_path, args.dictionary_path, config,
        g2p_model_path=args.g2p_model_path, rules_path=args.rules_path,
        device=args.device,
    )
    # the trace covers the corpus load and the export as well as the
    # alignment, so their spans show in it
    with _profiled(args.profile_dir, aligner.device, "align_trace.json"):
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
        # several ranks: every rank holds every result; each exports the files
        # of its own speakers, rank 0 the corpus-wide reports
        multi = aligner.mesh is not None and aligner.mesh.world_size > 1
        lead = not multi or aligner.mesh.rank == 0
        full_corpus = corpus
        # the phone decode runs on this rank's utterances, numbered from 0
        phone_corpus, phone_results, phone_csv = (
            corpus, results, "phone_transcript_evaluation.csv")
        if multi:
            corpus = _rank_corpus(corpus, aligner.last_shard)
            print(f"rank {aligner.mesh.rank}/{aligner.mesh.world_size}: aligned "
                  f"{corpus.num_utterances} utterances")
            phone_corpus = full_corpus.subset(aligner.last_shard)
            phone_results = {n: results[o]
                             for n, o in enumerate(aligner.last_shard)
                             if o in results}
            phone_csv = f"phone_transcript_evaluation.rank{aligner.mesh.rank}.csv"
        phone_transcripts = None
        if use_phone_model:
            # the reference's precedence (``alignment/base.py:543``): the phone
            # transcription replaces fine-tuning
            from montreal_forced_aligner_tpu_torch.transcription.phone_transcriber import (
                transcribe_phones,
            )

            if fine_tune:
                print("--use_phone_model supersedes --fine_tune (reference "
                      "behavior); skipping fine-tuning")
                fine_tune = False
            phone_transcripts = transcribe_phones(
                args.acoustic_model_path, phone_corpus, phone_results,
                batch_size=config.batch_size, phone_lm=aligner.model.phone_lm,
                device=aligner.device,
            )
            print(f"Phone-transcribed {len(phone_transcripts)} utterances")
        if fine_tune:
            from montreal_forced_aligner_tpu_torch.align.fine_tune import (
                fine_tune_alignments,
            )

            results = fine_tune_alignments(aligner, full_corpus, results)
            print("Fine-tuned boundaries at 1 ms resolution")
        outs = aligner.export_textgrids(
            corpus,
            results,
            args.output_directory,
            include_silence=include_silence,
            output_format=output_format,
            include_original_text=args.include_original_text,
        )
    # alignment quality analysis: the reference always runs it after align
    # (``command_line/align.py:124``)
    from montreal_forced_aligner_tpu_torch.align.analysis import (
        analyze_alignments,
        csv_report,
    )

    analyses, flagged = analyze_alignments(results)
    if lead:
        csv_report(analyses, full_corpus,
                   Path(args.output_directory) / "alignment_analysis.csv")
    if flagged and lead:
        print(f"Flagged {len(flagged)} utterances with anomalous phone "
              "durations (see alignment_analysis.csv)")
    print(
        f"Aligned {len(results)} utterances -> {len(outs)} files in "
        f"{time.time() - t0:.1f}s on {aligner.device}"
    )
    _rank_summary("align", aligner.device, corpus.num_utterances, t0)
    if phone_transcripts is not None:
        from montreal_forced_aligner_tpu_torch.transcription.phone_transcriber import (
            evaluate_against_alignments,
        )

        overlap, per = evaluate_against_alignments(
            phone_results, phone_transcripts, phone_corpus,
            output_path=Path(args.output_directory) / phone_csv,
            silence_phone=aligner.lexicon.silence_phone,
        )
        print("Phone-transcript evaluation: overlap error "
              f"{'n/a' if overlap is None else f'{overlap:.4f}'}, "
              f"PER {per:.4f} ({phone_csv})")
    if multi and args.reference_directory:
        from montreal_forced_aligner_tpu_torch.parallel.multihost import (
            host_barrier,
        )

        # rank 0 reads every rank's exports
        host_barrier("align_exported")
        corpus = full_corpus
    if args.reference_directory and lead:
        eval_dir = args.output_directory
        if output_format in ("json", "csv"):
            # the evaluator reads TextGrids; export a temporary copy
            eval_dir = tempfile.mkdtemp(prefix="mfa_tpu_eval_")
            aligner.export_textgrids(
                corpus, results, eval_dir, include_silence=include_silence
            )
        _evaluate_alignment_dirs(
            args.reference_directory, eval_dir, "sil",
            custom_mapping=_load_custom_mapping(args.custom_mapping_path),
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


def _adapt(args) -> int:
    """MAP-adapt an acoustic model to a corpus (reference ``mfa adapt``,
    ``alignment/adapting.py``)."""
    from montreal_forced_aligner_tpu_torch.training.adapt import MapAdapter

    adapter = MapAdapter(args.acoustic_model_path, args.dictionary_path,
                         args.mapping_tau, device=args.device)
    adapted = adapter.adapt(
        args.corpus_directory,
        speaker_characters=args.speaker_characters,
        audio_directory=args.audio_directory,
    )
    adapted.save(args.output_model_path)
    print(f"Saved adapted model to {args.output_model_path}")
    if args.output_directory is not None:
        _align_and_export(args, args.output_model_path)
    return 0


def _validate(args) -> int:
    """Validate a corpus + dictionary (reference ``mfa validate``,
    ``validation/corpus_validator.py:77``): counts, OOVs, audio issues."""
    from collections import Counter, defaultdict

    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon
    from montreal_forced_aligner_tpu_torch.dictionary.tokenizer import (
        SimpleTokenizer,
    )

    data = _load_command_config(args.config_path) if args.config_path else {}
    setting = _settings(args, data)
    test_transcriptions = bool(setting("test_transcriptions", False))
    if test_transcriptions and args.acoustic_model_path is None:
        print("Error: --test_transcriptions requires --acoustic_model_path",
              file=sys.stderr)
        return 1
    ignore_acoustics = bool(setting("ignore_acoustics", False))
    speaker_characters = setting("speaker_characters", "0")
    lex = Lexicon.load(args.dictionary_path)
    if args.rules_path is not None:
        from montreal_forced_aligner_tpu_torch.dictionary.rules import (
            PhonologicalRule,
            apply_rules_to_lexicon,
        )

        apply_rules_to_lexicon(lex, PhonologicalRule.load_rules(args.rules_path))
    corpus = Corpus.load(
        args.corpus_directory,
        speaker_characters=speaker_characters,
        audio_directory=args.audio_directory,
    )
    tokenizer = SimpleTokenizer(word_set=set(lex.words))
    oovs = Counter()
    utterance_oovs = defaultdict(list)
    total_words = 0
    bad_audio = []
    total_duration = 0.0
    for utt in corpus.utterances:
        _norm, utt_oovs = tokenizer(utt.text)
        oovs.update(utt_oovs)
        if utt_oovs:
            utterance_oovs[f"{utt.file_name}-{utt.speaker}"].extend(utt_oovs)
        total_words += len(utt.normalized_tokens or _norm.split())
        if ignore_acoustics:
            continue
        try:
            wav = corpus.load_audio(utt)
            total_duration += len(wav.samples) / wav.sample_rate
        except Exception as e:  # reported per file, as the reference does
            bad_audio.append((utt.file_name, str(e)))
    print(f"Speakers: {len(corpus.speakers)}")
    print(f"Utterances: {corpus.num_utterances}")
    print(f"Total duration: {total_duration:.1f}s")
    print(f"Total words: {total_words}")
    print(f"OOV types: {len(oovs)}  tokens: {sum(oovs.values())}")
    for w, c in oovs.most_common(20):
        print(f"  {w}\t{c}")
    if bad_audio:
        print(f"Sound file errors: {len(bad_audio)}")
        for f, e in bad_audio[:10]:
            print(f"  {f}: {e}")
    # container-level triage: truncated/unreadable files, per-speaker
    # sample-rate mixtures, segments past end-of-file (reference
    # analyze_setup wav issues, validation/corpus_validator.py:77)
    file_issues = corpus.audit_files()
    if file_issues:
        print(f"Sound file issues: {len(file_issues)}")
        for issue in file_issues[:20]:
            print(f"  [{issue['issue']}] {issue['file']}: {issue['detail']}")
    if args.output_directory is not None:
        out = Path(args.output_directory)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "oovs_found.txt", "w", encoding="utf-8") as f:
            for w, c in oovs.most_common():
                f.write(f"{w}\t{c}\n")
        with open(out / "utterance_oovs.txt", "w", encoding="utf-8") as f:
            for key, words in sorted(utterance_oovs.items()):
                f.write(f"{key}\t{', '.join(words)}\n")
        if file_issues:
            with open(out / "sound_file_issues.txt", "w", encoding="utf-8") as f:
                for issue in file_issues:
                    f.write(
                        f"{issue['issue']}\t{issue['file']}\t"
                        f"{issue['detail']}\n"
                    )
        print(f"Wrote OOV reports to {out}")
    if test_transcriptions:
        _test_transcriptions(args, corpus)
    print("Validation complete")
    return 0


def _test_transcriptions(args, corpus) -> None:
    """``validate --test_transcriptions``: decode every speaker's
    utterances against an LM of that speaker's own transcripts (reference
    ``PerSpeakerDecodeFunction``), print the WER and the utterances whose
    WER exceeds 0.45."""
    from montreal_forced_aligner_tpu_torch.evaluation import score_wer
    from montreal_forced_aligner_tpu_torch.transcription.transcriber import (
        Transcriber,
    )

    from montreal_forced_aligner_tpu_torch.parallel import multihost

    t0 = time.time()
    tr = Transcriber(args.acoustic_model_path, args.dictionary_path,
                     device=args.device)
    sharded = _sharded(args)
    if sharded:
        # per-speaker LM decode is speaker-independent: each rank decodes
        # its own speakers (the reference's speaker-sharded
        # PerSpeakerDecodeFunction jobs)
        corpus = multihost.shard_corpus(corpus)[0]
        print(f"rank {multihost.process_index()}/{multihost.process_count()}: "
              f"decoding {corpus.num_utterances} utterances with per-speaker LMs")
    results = (tr.transcribe_corpus_per_speaker(corpus)
               if corpus.num_utterances else {})
    metrics = tr.evaluate(corpus, results)
    print(f"Transcription check: WER {metrics['wer']:.4f} over "
          f"{metrics['num_utterances']} utterances")
    if sharded:
        # the corpus-wide numbers a single run gives: utterance-weighted
        # WER/CER sums over the ranks
        n = metrics["num_utterances"]
        tot = multihost.host_allreduce_sum(np.array(
            [metrics["wer"] * n, metrics["cer"] * n, n], np.float64))
        if tot[2] > 0:
            print(f"Transcription check (all ranks): WER {tot[0] / tot[2]:.4f} "
                  f"CER {tot[1] / tot[2]:.4f} over {int(tot[2])} utterances")
        _rank_summary("validate", tr.device, corpus.num_utterances, t0)
    flagged = []
    for utt in corpus.utterances:
        if utt.id not in results:
            continue
        ref = tr.aligner.tokenizer.tokenize(utt.text)
        wer = score_wer(ref, results[utt.id].text.split())
        if wer > 0.45:
            flagged.append((utt.file_name, wer))
    if flagged:
        print(f"Utterances with suspicious transcripts: {len(flagged)}")
        for f, w in flagged[:20]:
            print(f"  {f}: WER {w:.2f}")


def _transcribe(args) -> int:
    """Transcribe a corpus (reference ``mfa transcribe``): one ``.lab`` per
    file under ``<speaker>/``, and utterance-text tiers (or, with
    ``--output_type alignment``, the word and phone tiers of the decoded
    best path, force-aligned)."""
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.language_modeling.ngram import ArpaModel
    from montreal_forced_aligner_tpu_torch.transcription.transcriber import (
        Transcriber,
    )

    data = _load_command_config(args.config_path) if args.config_path else {}
    setting = _settings(args, data)
    batch_size = int(setting("batch_size", 16))
    nbest = int(setting("nbest", 1))
    rescore_weight = setting("rescore_weight", None)
    evaluate = bool(setting("evaluate", False))
    lm_weight = float(setting("language_model_weight", 1.0))
    wip = float(setting("word_insertion_penalty", 0.0))
    lm = None
    archive_rescore = None
    if args.language_model_path:
        if str(args.language_model_path).lower().endswith(".zip"):
            # a LanguageModel archive decodes with its small model and
            # rescores N-best with its large one (reference decode_arpa_path
            # / carpa_path)
            from montreal_forced_aligner_tpu_torch.language_modeling.archive import (
                LanguageModelArchive,
            )

            la = LanguageModelArchive.load(args.language_model_path)
            lm = la.decode_model
            if la.rescore_model is not la.decode_model:
                archive_rescore = la.rescore_model
        else:
            lm = ArpaModel.read(args.language_model_path)
    tr = Transcriber(args.acoustic_model_path, args.dictionary_path, lm=lm,
                     batch_size=batch_size, lm_scale=lm_weight,
                     word_insertion_penalty=wip, device=args.device)
    corpus = Corpus.load(args.corpus_directory,
                         speaker_characters=args.speaker_characters,
                         audio_directory=args.audio_directory,
                         require_transcripts=False)
    from montreal_forced_aligner_tpu_torch.parallel import multihost

    t0 = time.time()
    sharded = _sharded(args)
    if sharded:
        # decoding is per utterance: each rank takes its speakers and exports
        # their transcripts (as align does)
        corpus, shard_ids = multihost.shard_corpus(corpus)
        print(f"rank {multihost.process_index()}/{multihost.process_count()}: "
              f"transcribing {corpus.num_utterances} utterances")
    rescore_lm = ArpaModel.read(args.rescore_lm_path) if args.rescore_lm_path else None
    if rescore_lm is None and archive_rescore is not None:
        # rescoring needs alternatives to re-rank: N-best even when 1-best
        # was asked for
        rescore_lm = archive_rescore
        if nbest <= 1:
            nbest = 10
        print("Rescoring N-best with the archive's large LM")
    if rescore_weight is None:
        rescore_weight = lm_weight
    with _profiled(args.profile_dir, tr.device, "transcribe_trace.json"):
        results = tr.transcribe_corpus(
            corpus, nbest=nbest, rescore_lm=rescore_lm,
            rescore_weight=float(rescore_weight),
        ) if corpus.num_utterances else {}
    _export_transcripts(corpus, {i: r.text for i, r in results.items()},
                        args.output_directory)
    if args.output_type == "alignment":
        # word/phone tiers of the decoded best path: align the hypotheses
        decoded = Corpus.load(args.corpus_directory,
                              speaker_characters=args.speaker_characters,
                              audio_directory=args.audio_directory,
                              require_transcripts=False)
        if sharded:
            decoded = decoded.subset(shard_ids)
        for utt in decoded.utterances:
            if utt.id in results:
                utt.text = results[utt.id].text
        aligned = tr.aligner.align_corpus(decoded)
        tr.aligner.export_textgrids(
            decoded, aligned, args.output_directory,
            output_format=args.output_format,
            include_original_text=args.include_original_text,
        )
    else:
        _export_transcription_textgrids(
            corpus, results, args.output_directory, args.output_format,
            include_original_text=args.include_original_text,
        )
    print(f"Transcribed {len(results)} utterances to {args.output_directory}")
    if evaluate:
        metrics = tr.evaluate(corpus, results)
        print(f"WER: {metrics['wer']:.4f}  CER: {metrics['cer']:.4f} "
              f"({metrics['num_utterances']} utterances)")
        if sharded:
            n = metrics["num_utterances"]
            tot = multihost.host_allreduce_sum(np.array(
                [metrics["wer"] * n, metrics["cer"] * n, n], np.float64))
            if tot[2] > 0:
                print(f"WER (all ranks): {tot[0] / tot[2]:.4f}  CER: "
                      f"{tot[1] / tot[2]:.4f} ({int(tot[2])} utterances)")
    if sharded:
        _rank_summary("transcribe", tr.device, corpus.num_utterances, t0)
    return 0


def _export_transcription_textgrids(corpus, results, output_directory,
                                    output_format, include_original_text=False):
    """Per file a TextGrid (or json/csv) with one utterance-text tier per
    speaker (reference ``mfa transcribe --output_type transcription``)."""
    from montreal_forced_aligner_tpu_torch.io.textgrid import Interval, TextGrid
    from montreal_forced_aligner_tpu_torch.io.wav import read_wave

    extensions = {"long_textgrid": ".TextGrid", "short_textgrid": ".TextGrid",
                  "json": ".json", "csv": ".csv"}
    output_directory = Path(output_directory)
    output_directory.mkdir(parents=True, exist_ok=True)
    by_file = {}
    for utt in corpus.utterances:
        by_file.setdefault(utt.file_name, []).append(utt)
    out_paths = []
    for file_name, utts in by_file.items():
        tg = TextGrid()
        tg.xmax = read_wave(corpus.files[file_name]).duration
        speakers = sorted({u.speaker for u in utts})
        for spk in speakers:
            tier = []
            texts = []
            for utt in utts:
                if utt.speaker != spk or utt.id not in results:
                    continue
                tier.append(Interval(utt.begin, utt.end or tg.xmax,
                                     results[utt.id].text))
                if include_original_text:
                    texts.append(Interval(utt.begin, utt.end or tg.xmax, utt.text))
            name = spk if len(speakers) > 1 else "utterances"
            tg.tiers[name] = tier
            if include_original_text:
                tg.tiers[f"{name} - original"] = texts
        out = output_directory / f"{file_name}{extensions[output_format]}"
        if output_format == "json":
            tg.write_json(out)
        elif output_format == "csv":
            tg.write_csv(out, default_speaker=speakers[0] if speakers else "speaker")
        else:
            tg.write(out, output_format=output_format)
        out_paths.append(out)
    return out_paths


def _export_transcripts(corpus, texts, output_directory) -> None:
    """One ``<speaker>/<file>.lab`` per corpus file; the utterances of a
    multi-utterance file are written in order, one a line."""
    from collections import OrderedDict

    out = Path(output_directory)
    by_file = OrderedDict()
    for utt in corpus.utterances:
        if utt.id not in texts:
            continue
        by_file.setdefault((utt.speaker, utt.file_name), []).append(texts[utt.id])
    for (speaker, file_name), lines in by_file.items():
        d = out / speaker
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{file_name}.lab").write_text("\n".join(lines) + "\n")


def _load_custom_mapping(custom_mapping_path):
    """Phone-mapping yaml for cross-phone-set evaluation (reference
    ``--custom_mapping_path``; many-to-one entries allowed)."""
    if not custom_mapping_path:
        return None
    raw = _load_command_config(custom_mapping_path)
    mapping = {}
    for k, v in raw.items():
        if isinstance(v, list):
            # many-to-one entries stay lists (compare_labels membership test)
            mapping[str(k)] = [str(item) for item in v]
        else:
            mapping[str(k)] = str(v)
    return mapping


def _evaluate_alignment_dirs(
    reference_directory, test_directory, silence_phone, custom_mapping=None
) -> None:
    """Compare two directories of TextGrids (reference
    ``alignment/base.py:2536``); prints overlap error, phone error rate and
    +-10 ms boundary agreement."""
    import numpy as np

    from montreal_forced_aligner_tpu_torch.data import CtmInterval
    from montreal_forced_aligner_tpu_torch.evaluation import (
        align_phones,
        boundary_agreement,
    )
    from montreal_forced_aligner_tpu_torch.io.textgrid import TextGrid

    def phones_of(path):
        tg = TextGrid.read(path)
        out = []
        for name, ivs in tg.tiers.items():
            if "phone" in name.lower():
                out.extend(
                    CtmInterval(iv.begin, iv.end, iv.label.strip())
                    for iv in ivs
                    if iv.label.strip()
                )
        return out

    scores, pers, agrees, totals = [], [], [], []
    for ref_tg in sorted(Path(reference_directory).rglob("*.TextGrid")):
        test_tg = Path(test_directory) / ref_tg.name
        if not test_tg.exists():
            continue
        ref = phones_of(ref_tg)
        test = phones_of(test_tg)
        if not ref or not test:
            continue
        sc, per, _err = align_phones(
            ref, test, silence_phone, custom_mapping=custom_mapping
        )
        ag, nb = boundary_agreement(ref, test, silence_phone)
        if sc is not None:
            scores.append(sc)
        pers.append(per)
        agrees.append(ag * nb)
        totals.append(nb)
    if not totals:
        print("No overlapping TextGrids found")
        return
    print(f"Files evaluated: {len(pers)}")
    print(f"Mean overlap error: {np.mean(scores):.4f}s")
    print(f"Mean phone error rate: {np.mean(pers):.4f}")
    print(
        f"Boundary agreement (+-10ms): {sum(agrees) / max(sum(totals), 1):.4f}"
    )


def _evaluate_alignments(args) -> int:
    """Compare two directories of TextGrids (reference
    ``alignment/base.py:2536`` evaluate_alignments)."""
    _evaluate_alignment_dirs(
        args.reference_directory, args.test_directory, args.silence_phone,
        custom_mapping=_load_custom_mapping(args.custom_mapping_path),
    )
    return 0


def _train_lm(args) -> int:
    """Train an n-gram LM from a text file (one sentence per line) or a
    corpus directory (reference ``mfa train_lm``,
    ``language_modeling/trainer.py``). A ``.zip`` output writes the
    reference's archive (large + entropy-pruned medium/small); other
    extensions write a single ARPA file."""
    from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
        train_lm_from_texts,
    )

    src = Path(args.source_path)
    if src.is_dir():
        texts = []
        for lab in sorted(src.rglob("*.lab")) + sorted(src.rglob("*.txt")):
            t = lab.read_text(encoding="utf-8").strip().lower()
            if t:
                texts.append(t)
    else:
        texts = [
            ln.strip().lower()
            for ln in src.read_text(encoding="utf-8").splitlines()
            if ln.strip()
        ]
    if args.dictionary_path is not None:
        from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon

        vocab = set(Lexicon.load(args.dictionary_path).words)
        texts = [
            " ".join(t if t in vocab else "<unk>" for t in s.split())
            for s in texts
        ]
    order = args.order
    if str(args.output_model_path).lower().endswith(".zip"):
        from montreal_forced_aligner_tpu_torch.language_modeling.archive import (
            LanguageModelArchive,
        )

        archive = LanguageModelArchive.train(
            texts, order=order,
            prune_thresh_small=args.prune_thresh_small,
            prune_thresh_medium=args.prune_thresh_medium,
        )
        archive.save(args.output_model_path)
        sizes = {
            k: sum(len(m.ngrams[n]) for n in range(1, m.order + 1))
            for k, m in (
                ("large", archive.large),
                ("medium", archive.medium),
                ("small", archive.small),
            )
        }
        print(
            f"Trained order-{order} LM archive on {len(texts)} sentences "
            f"(ngrams: large {sizes['large']}, medium {sizes['medium']}, "
            f"small {sizes['small']}) -> {args.output_model_path}"
        )
    else:
        model, _counter = train_lm_from_texts(texts, order=order)
        model.write(args.output_model_path)
        print(
            f"Trained order-{order} LM on {len(texts)} sentences "
            f"({len(model.ngrams[1])} unigrams) -> {args.output_model_path}"
        )
    return 0


def _train_dictionary(args) -> int:
    """Align a corpus and export a dictionary with estimated pronunciation
    and silence probabilities (reference ``mfa train_dictionary``,
    ``pretrained.py:561`` DictionaryTrainer)."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.training.pronunciation import (
        PronunciationCounter,
        apply_probabilities_to_lexicon,
        compute_pronunciation_probabilities,
    )

    aligner = PretrainedAligner(
        args.acoustic_model_path, args.dictionary_path,
        AlignerConfig(batch_size=args.batch_size), device=args.device,
    )
    corpus = Corpus.load(
        args.corpus_directory,
        speaker_characters=args.speaker_characters,
        audio_directory=args.audio_directory,
    )
    results = aligner.align_corpus(corpus)
    counter = PronunciationCounter()
    for aln in results.values():
        counter.add_utterance(aln, aligner.lexicon.silence_phone)
    probs = compute_pronunciation_probabilities(counter)
    apply_probabilities_to_lexicon(aligner.lexicon, probs)
    if not args.silence_probabilities:
        # probability-only export (reference DictionaryTrainer
        # silence_probabilities=False, pretrained.py:561)
        for prons in aligner.lexicon.words.values():
            for p in prons:
                p.silence_after_probability = None
                p.silence_before_correction = None
                p.non_silence_before_correction = None
    aligner.lexicon.write(args.output_dictionary_path)
    print(
        f"Exported dictionary with pronunciation probabilities to "
        f"{args.output_dictionary_path}"
    )
    return 0


def _model(args) -> int:
    """Model utilities (reference ``command_line/model.py``)."""
    from montreal_forced_aligner_tpu_torch.model_manager import ModelManager

    cmd = args.model_command
    if cmd == "inspect":
        from montreal_forced_aligner_tpu_torch.models.acoustic_model import (
            AcousticModel,
        )

        am = AcousticModel.load(args.model_path)
        tm = am.transition_model
        info = {
            "meta": am.meta,
            "num_phones": int(len(tm.topo.phones)),
            "num_pdfs": am.gmm.num_pdfs,
            "num_gaussians": am.gmm.total_gauss,
            "feature_dim": am.gmm.dim,
            "num_transition_states": tm.num_transition_states,
            "num_transition_ids": tm.num_transition_ids,
            "tree_context_width": am.tree.N,
            "lda": am.lda_mat is not None,
            "has_alignment_model": am.alignment_model is not None,
        }
        print(json.dumps(info, indent=2, default=str))
    elif cmd == "add":
        print(f"Registered {ModelManager().add(args.model_type, args.path, args.name)}")
    elif cmd == "save":
        mm = ModelManager()
        resolved = args.name or Path(args.path).stem
        try:
            existing = mm.resolve(args.model_type, resolved)
        except FileNotFoundError:
            existing = None
        if existing is not None and not args.overwrite:
            print(
                f"Error: {args.model_type} model {resolved!r} already saved at "
                f"{existing}; pass --overwrite to replace it",
                file=sys.stderr,
            )
            return 1
        print(f"Saved {mm.add(args.model_type, args.path, resolved)}")
    elif cmd == "add_words":
        return _model_add_words(args)
    elif cmd == "list":
        for mt, names in ModelManager().list_models(args.model_type).items():
            print(f"{mt}:")
            for n in names:
                print(f"  {n}")
    elif cmd == "download":
        try:
            dst = ModelManager().download(args.model_type, args.name)
        except RuntimeError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        print(f"Downloaded to {dst}")
    return 0


def _model_add_words(args) -> int:
    """Merge pronunciations from one dictionary into another, so long as
    the new entries introduce no new phones (reference
    ``mfa model add_words``, ``command_line/model.py:156-193``)."""
    from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon

    base = Lexicon.load(args.dictionary_path)
    new = Lexicon.load(args.new_pronunciations_path)

    def phone_set(lex):
        return {
            p
            for prons in lex.words.values()
            for pron in prons
            for p in pron.phones
        }

    new_phones = phone_set(new) - phone_set(base)
    if new_phones:
        print(
            "Error: new pronunciations contain phones missing from the base "
            f"dictionary: {sorted(new_phones)}",
            file=sys.stderr,
        )
        return 1
    added = 0
    for word, prons in new.words.items():
        for pron in prons:
            before = len(base.words.get(word, ()))
            base.add_pronunciation(word, pron)
            added += len(base.words[word]) > before
    base.write(args.dictionary_path)
    print(
        f"Added {added} pronunciations from {args.new_pronunciations_path} "
        f"to {args.dictionary_path}"
    )
    return 0


def _version(args) -> int:
    from montreal_forced_aligner_tpu_torch import __version__

    print(__version__)
    return 0


def _configure(args) -> int:
    """Persist default options to the global profile store (reference
    ``mfa configure``, ``config.py:167-280``)."""
    from montreal_forced_aligner_tpu_torch.config import get_config

    cfg = get_config()
    if args.profile:
        cfg.current_profile_name = args.profile
    options = {k: getattr(args, k) for k in (
        "batch_size", "seed", "clean", "debug", "temporary_directory")}
    cfg.current_profile.update({k: v for k, v in options.items() if v is not None})
    cfg.save()
    print(f"Saved profile {cfg.current_profile_name!r}")
    return 0


def _history(args) -> int:
    """Show recent command history (reference ``mfa history``)."""
    from montreal_forced_aligner_tpu_torch.config import load_history

    for entry in load_history()[-args.depth:]:
        print(
            f"{entry['time']}  (exit {entry['exit_code']})  "
            + " ".join(entry["command"])
        )
    return 0


def _train_ivector(args) -> int:
    """Train a UBM + i-vector extractor (reference ``mfa train_ivector``,
    ``ivector/trainer.py``)."""
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ivector.pipeline import (
        train_ivector_model,
    )

    corpus = Corpus.load(args.corpus_directory, require_transcripts=False)
    extractor = train_ivector_model(
        corpus, num_gauss=args.num_gauss, ivector_dim=args.ivector_dim,
        num_iterations=args.num_iterations, batch_size=args.batch_size,
        train_plda=args.train_plda, device=args.device,
    )
    if extractor.plda is not None:
        print(f"Trained PLDA over {len(corpus.speakers)} speakers "
              f"({corpus.num_utterances} i-vectors)")
    elif args.train_plda:
        print("Skipping PLDA: need at least 2 speakers", file=sys.stderr)
    extractor.save(args.output_model_path)
    print(f"Trained {extractor.ubm.num_gauss}-gauss UBM + {args.ivector_dim}-dim "
          f"extractor -> {args.output_model_path}")
    return 0


def _diarize_speakers(args) -> int:
    """Cluster or classify utterances into speakers (reference ``mfa
    diarize_speakers``, ``diarization/speaker_diarizer.py``). Writes
    utt2spk.tsv, parameters.yaml and the relabelled transcripts."""
    import numpy as np

    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.diarization.speaker_diarizer import (
        DiarizationResult,
        SpeakerDiarizer,
    )
    from montreal_forced_aligner_tpu_torch.ivector.extractor import IvectorExtractor
    from montreal_forced_aligner_tpu_torch.ivector.pipeline import (
        corpus_feature_batches,
    )

    data = _load_command_config(args.config_path) if args.config_path else {}
    setting = _settings(args, data)
    expected_num_speakers = setting("expected_num_speakers", 0)
    distance_threshold = setting("distance_threshold", 0.5)
    cluster_type = setting("cluster_type", "agglomerative")
    min_cluster_size = setting("min_cluster_size", 15)
    batch_size = setting("batch_size", 16)
    metric = setting("metric", "cosine")
    output_format = setting("output_format", "long_textgrid")
    manifold_algorithm = setting("manifold_algorithm", "tsne")
    if args.ivector_extractor_path == "speechbrain":
        return _diarize_xvectors(
            args, expected_num_speakers=expected_num_speakers,
            distance_threshold=distance_threshold, cluster_type=cluster_type,
            min_cluster_size=min_cluster_size, metric=metric,
            output_format=output_format, manifold_algorithm=manifold_algorithm)
    if not Path(args.ivector_extractor_path).exists():
        raise FileNotFoundError(
            f"IVECTOR_EXTRACTOR_PATH {args.ivector_extractor_path!r} does not "
            "exist (pass an i-vector extractor archive)"
        )
    corpus = Corpus.load(args.corpus_directory, require_transcripts=False)
    batches, order = corpus_feature_batches(corpus, batch_size=batch_size,
                                            device=args.device)
    extractor = IvectorExtractor.load(args.ivector_extractor_path)
    if metric == "plda" and extractor.plda is None:
        raise ValueError("--metric plda needs an extractor with bundled PLDA "
                         "(train with train_ivector --plda)")
    diarizer = SpeakerDiarizer(extractor, plda=extractor.plda, metric=metric,
                               device=args.device)
    if args.classify:
        # enroll per-speaker mean i-vectors from the corpus's own labels,
        # then reassign every utterance (reference classify_speakers,
        # speaker_diarizer.py:307)
        iv = diarizer.utterance_ivectors(batches)
        enrolled = {}
        for s in corpus.speakers:
            rows = [pos for pos, ui in enumerate(order)
                    if corpus.utterances[ui].speaker == s]
            enrolled[s] = iv[rows].mean(axis=0)
        names = diarizer.classify_speakers(batches, enrolled, ivectors=iv)
        name_idx = {s: i for i, s in enumerate(corpus.speakers)}
        result = DiarizationResult(
            labels=np.array([name_idx[n] for n in names]), ivectors=iv
        )
        moved = sum(1 for pos, ui in enumerate(order)
                    if names[pos] != corpus.utterances[ui].speaker)
        print(f"Classification reassigned {moved}/{len(order)} utterances")
    else:
        result = diarizer.cluster_utterances(
            batches,
            num_speakers=expected_num_speakers or None,
            threshold=None if expected_num_speakers else distance_threshold,
            method=cluster_type,
            min_cluster_size=min_cluster_size,
        )
    _export_diarization(
        corpus, result, order, args.output_directory, args.classify,
        args.evaluate, args.visualize, manifold_algorithm, output_format,
        metric=metric, extractor_path=str(args.ivector_extractor_path),
        expected_num_speakers=expected_num_speakers, cluster_type=cluster_type,
        distance_threshold=distance_threshold, min_cluster_size=min_cluster_size,
    )
    return 0


def _diarize_xvectors(args, *, expected_num_speakers, distance_threshold,
                      cluster_type, min_cluster_size, metric, output_format,
                      manifold_algorithm) -> int:
    """``diarize_speakers CORPUS speechbrain OUT --xvector_model_path CKPT``:
    SpeechBrain embeddings on the device in place of i-vectors, then the
    same clustering or classification and export."""
    import numpy as np

    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.diarization.embeddings import (
        XVectorDiarizer,
        XVectorEmbedder,
    )
    from montreal_forced_aligner_tpu_torch.diarization.speaker_diarizer import (
        DiarizationResult,
    )
    from montreal_forced_aligner_tpu_torch.ivector.extractor import length_normalize

    if args.xvector_model_path is None:
        raise ValueError(
            "IVECTOR_EXTRACTOR_PATH 'speechbrain' needs --xvector_model_path "
            "pointing at a local EncoderClassifier checkpoint (no network "
            "egress here)")
    corpus = Corpus.load(args.corpus_directory, require_transcripts=False)
    embedder = XVectorEmbedder(args.xvector_model_path, device=args.device)
    if metric == "plda":
        raise ValueError(
            "--metric plda is not available with x-vector embeddings (no "
            "PLDA model in a speechbrain checkpoint); use cosine")
    order = list(range(corpus.num_utterances))
    if args.classify:
        emb = length_normalize(embedder.embed_corpus(corpus))
        enrolled = {
            s: emb[[i for i, u in enumerate(corpus.utterances)
                    if u.speaker == s]].mean(axis=0)
            for s in corpus.speakers
        }
        names = list(enrolled)
        enroll = length_normalize(np.stack([enrolled[n] for n in names]))
        a = enroll / np.linalg.norm(enroll, axis=1, keepdims=True)
        b = emb / np.linalg.norm(emb, axis=1, keepdims=True)
        assigned = [names[i] for i in (a @ b.T).argmax(axis=0)]
        name_idx = {s: i for i, s in enumerate(corpus.speakers)}
        result = DiarizationResult(
            labels=np.array([name_idx[n] for n in assigned]), ivectors=emb)
        moved = sum(1 for i, u in enumerate(corpus.utterances)
                    if assigned[i] != u.speaker)
        print(f"Classification reassigned {moved}/{len(order)} utterances")
    else:
        result = XVectorDiarizer(embedder, metric=metric).cluster_corpus(
            corpus,
            num_speakers=expected_num_speakers or None,
            threshold=None if expected_num_speakers else distance_threshold,
            method=cluster_type,
            min_cluster_size=min_cluster_size,
        )
    _export_diarization(
        corpus, result, order, args.output_directory, args.classify,
        args.evaluate, args.visualize, manifold_algorithm, output_format,
        metric=metric, extractor_path="speechbrain",
        expected_num_speakers=expected_num_speakers, cluster_type=cluster_type,
        distance_threshold=distance_threshold, min_cluster_size=min_cluster_size,
    )
    return 0


def _export_diarization(
    corpus, result, order, output_directory, classify, evaluate,
    visualize, manifold_algorithm, output_format, *,
    metric="cosine", extractor_path="", expected_num_speakers=0,
    cluster_type="agglomerative", distance_threshold=0.5,
    min_cluster_size=15,
):
    """The diarization export (reference ``SpeakerDiarizer.export_files``,
    ``speaker_diarizer.py:1505``): utt2spk.tsv, parameters.yaml, relabelled
    transcripts at their corpus-relative paths (whole-file utterances as
    .lab, segmented files as one tier per new speaker), and optionally the
    cluster plot and the evaluation against the corpus's speakers."""
    import yaml

    from montreal_forced_aligner_tpu_torch.io.textgrid import Interval, TextGrid

    out = Path(output_directory)
    out.mkdir(parents=True, exist_ok=True)
    new_speaker = {}
    for pos, utt_idx in enumerate(order):
        lbl = int(result.labels[pos])
        new_speaker[utt_idx] = corpus.speakers[lbl] if classify else f"speaker{lbl}"
    with open(out / "utt2spk.tsv", "w", encoding="utf-8") as f:
        for utt_idx in order:
            utt = corpus.utterances[utt_idx]
            end = "" if utt.end is None else f"{utt.end}"
            f.write(f"{utt.speaker}/{utt.file_name}\t{utt.begin}\t{end}\t"
                    f"{new_speaker[utt_idx]}\n")
    with open(out / "parameters.yaml", "w", encoding="utf-8") as f:
        yaml.safe_dump(
            {
                "ivector_extractor_path": extractor_path,
                "expected_num_speakers": expected_num_speakers,
                "cluster": not classify,
                "metric": metric,
                "cluster_type": cluster_type,
                "distance_threshold": distance_threshold,
                "min_cluster_size": min_cluster_size,
            },
            f,
        )
    by_file = {}
    for utt in corpus.utterances:
        by_file.setdefault(utt.file_name, []).append(utt)
    fmt = output_format.lower()
    ext = ".TextGrid" if fmt.endswith("textgrid") else f".{fmt}"
    for fname, utts in by_file.items():
        (out / fname).parent.mkdir(parents=True, exist_ok=True)
        if len(utts) == 1 and utts[0].end is None:
            (out / f"{fname}.lab").write_text(utts[0].text, encoding="utf-8")
            continue
        tiers = {}
        xmax = 0.0
        for utt in utts:
            spk = new_speaker.get(utt.id, utt.speaker)
            end = utt.end if utt.end is not None else utt.begin
            tiers.setdefault(spk, []).append(Interval(utt.begin, end, utt.text))
            xmax = max(xmax, end)
        tg = TextGrid(xmin=0.0, xmax=xmax, tiers=tiers)
        if fmt == "json":
            tg.write_json(out / f"{fname}{ext}")
        elif fmt == "csv":
            tg.write_csv(out / f"{fname}{ext}")
        else:
            tg.write(out / f"{fname}{ext}", output_format=fmt)
    n = len(set(result.labels.tolist()))
    print(f"Clustered {corpus.num_utterances} utterances into {n} speakers")
    if visualize:
        from montreal_forced_aligner_tpu_torch.diarization.visualization import (
            manifold_points,
            plot_clusters,
        )

        points = manifold_points(
            result.ivectors,
            algorithm=manifold_algorithm,
            metric="cosine" if metric == "plda" else metric,
            quick=corpus.num_utterances < 200,
        )
        plot_path = plot_clusters(points, result.labels, out / "cluster_plot.png")
        print(f"Wrote cluster plot to {plot_path}")
    if evaluate:
        from montreal_forced_aligner_tpu_torch.diarization.clustering import (
            adjusted_rand_index,
            cluster_purity,
        )

        truth = [corpus.utterances[i].speaker for i in order]
        labels = [int(x) for x in result.labels]
        ari = adjusted_rand_index(truth, labels)
        purity = cluster_purity(truth, labels)
        print(f"Evaluation vs original speakers: purity {purity:.4f}, "
              f"adjusted Rand index {ari:.4f} ({len(set(truth))} true speakers)")


def _create_segments_vad(args) -> int:
    """Segment audio files by energy VAD, or by a SpeechBrain VAD with
    ``--speechbrain_model_path`` (reference ``mfa create_segments_vad``,
    ``vad/segmenter.py:56,328``)."""
    from montreal_forced_aligner_tpu_torch.vad.segmenter import (
        SegmenterConfig,
        SpeechbrainVadSegmenter,
        VadSegmenter,
    )

    cfg = SegmenterConfig(
        max_segment_length=args.max_segment_length,
        min_segment_length=args.min_segment_length,
        min_pause_duration=args.min_pause_duration,
        energy_threshold=args.energy_threshold,
    )
    if args.speechbrain_model_path:
        seg = SpeechbrainVadSegmenter(args.speechbrain_model_path, cfg,
                                      device=args.device)
    else:
        seg = VadSegmenter(cfg, device=args.device)
    outs = seg.segment_corpus(args.corpus_directory, args.output_directory,
                              output_format=args.output_format)
    print(f"Wrote {len(outs)} segment files to {args.output_directory}")
    return 0


def _create_segments(args) -> int:
    """Segment long transcribed files by aligning each transcript and
    cutting at aligned silences (reference ``TranscriptionSegmenter``,
    ``vad/segmenter.py:575``; ``SegmentTranscriptFunction``,
    ``vad/multiprocessing.py:409``). One TextGrid per file, whose
    ``segments`` tier carries each segment's words."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.io.textgrid import Interval, TextGrid
    from montreal_forced_aligner_tpu_torch.vad.transcript_segmenter import (
        segment_transcribed_file,
    )

    aligner = PretrainedAligner(args.acoustic_model_path, args.dictionary_path,
                                AlignerConfig(), device=args.device)
    corpus = Corpus.load(args.corpus_directory)
    out = Path(args.output_directory)
    out.mkdir(parents=True, exist_ok=True)
    n_segments = 0
    for utt in corpus.utterances:
        wav = corpus.load_audio(utt)
        segs = segment_transcribed_file(
            aligner, wav.samples, utt.text,
            min_pause=args.min_pause_duration,
            max_segment_length=args.max_segment_length,
        )
        tg = TextGrid()
        tg.xmax = wav.duration
        tg.tiers["segments"] = [Interval(s.begin, s.end, s.text) for s in segs]
        target = out / f"{utt.file_name}.TextGrid"
        target.parent.mkdir(parents=True, exist_ok=True)
        tg.write(target)
        n_segments += len(segs)
    print(f"Segmented {corpus.num_utterances} files into {n_segments} "
          f"utterances -> {args.output_directory}")
    return 0


def _train_g2p(args) -> int:
    """Train a G2P model from a pronunciation dictionary (reference ``mfa
    train_g2p``: the PyniniTrainer pair-ngram engine by default,
    ``g2p/trainer.py:79-880``; ``--phonetisaurus`` the chunked-graphone
    engine, ``g2p/phonetisaurus_trainer.py``)."""
    from montreal_forced_aligner_tpu_torch.dictionary.lexicon import (
        parse_dictionary_file,
    )
    from montreal_forced_aligner_tpu_torch.g2p.pair_ngram import PairNgramTrainer
    from montreal_forced_aligner_tpu_torch.g2p.trainer import G2PTrainer

    def make_trainer():
        if args.phonetisaurus:
            return G2PTrainer(
                order=args.order,
                num_alignment_iterations=args.num_alignment_iterations,
            )
        return PairNgramTrainer(
            order=args.order,
            num_random_starts=args.random_starts,
            max_em_iterations=args.num_alignment_iterations * 2,
        )

    if args.evaluation_mode:
        # 90/10 split evaluation before the full train (reference
        # ``g2p/trainer.py:736-770``, validation_proportion 0.1)
        import random

        from montreal_forced_aligner_tpu_torch.g2p.generator import (
            G2PGenerator,
            evaluate_g2p,
        )

        pairs = [
            (word, pron.phones)
            for word, pron in parse_dictionary_file(args.dictionary_path)
        ]
        rng = random.Random(1234)
        words = sorted({w for w, _p in pairs})
        held = set(rng.sample(words, max(1, len(words) // 10)))
        train_pairs = [(w, p) for w, p in pairs if w not in held]
        test_pairs = [(w, p) for w, p in pairs if w in held]
        eval_model = make_trainer().train_from_pairs(train_pairs)
        metrics = evaluate_g2p(G2PGenerator(eval_model), test_pairs)
        print(
            f"Evaluation on {len(test_pairs)} held-out pronunciations: "
            f"word accuracy {metrics['word_accuracy']:.4f}, "
            f"phone error rate {metrics['phone_error_rate']:.4f}"
        )
    model = make_trainer().train_from_dictionary(args.dictionary_path)
    if args.reference_format:
        from montreal_forced_aligner_tpu_torch.g2p.export_openfst import (
            export_reference_g2p,
        )

        export_reference_g2p(model, args.output_model_path)
        print(f"Saved reference-format G2P archive to {args.output_model_path}")
    else:
        model.save(args.output_model_path)
        print(f"Saved G2P model to {args.output_model_path}")
    return 0


def _g2p(args) -> int:
    """Generate pronunciations for a word list (one word per line) or a
    corpus directory's vocabulary (reference ``mfa g2p``,
    ``g2p/generator.py:475-1100``)."""
    from montreal_forced_aligner_tpu_torch.g2p.generator import G2PGenerator
    from montreal_forced_aligner_tpu_torch.g2p.trainer import G2PModel

    data = _load_command_config(args.config_path) if args.config_path else {}
    setting = _settings(args, data)
    num_pronunciations = int(setting("num_pronunciations", 1))
    include_bracketed = bool(setting("include_bracketed", False))
    export_scores = bool(setting("export_scores", False))
    gen = G2PGenerator(G2PModel.load(args.g2p_model_path))
    input_path = Path(args.input_path)
    if input_path.is_dir():
        # corpus mode: vocabulary from every transcript (reference
        # PyniniCorpusGenerator / PyniniDictionaryCorpusGenerator), scanned
        # directly so text-only corpora (no audio) work too
        from montreal_forced_aligner_tpu_torch.dictionary.tokenizer import (
            SimpleTokenizer,
        )
        from montreal_forced_aligner_tpu_torch.io.textgrid import TextGrid

        tok = SimpleTokenizer()
        vocab = set()
        for ext in (".lab", ".txt"):
            for f in input_path.rglob(f"*{ext}"):
                vocab.update(tok.tokenize(f.read_text(encoding="utf-8")))
        for ext in (".TextGrid", ".textgrid"):
            for f in input_path.rglob(f"*{ext}"):
                tg = TextGrid.read(f)
                for ivs in tg.tiers.values():
                    for iv in ivs:
                        if iv.label.strip():
                            vocab.update(tok.tokenize(iv.label))
        words = sorted(vocab)
    else:
        words = [
            w.strip().lower()
            for w in input_path.read_text(encoding="utf-8").splitlines()
            if w.strip()
        ]
    if not include_bracketed:
        words = [w for w in words if not (w[:1] in "[(<" and w[-1:] in "])>")]
    if args.dictionary_path:
        from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon

        known = set(Lexicon.load(args.dictionary_path).words)
        words = [w for w in words if w not in known]
    if args.sorted_output:
        words = sorted(words)
    with open(args.output_path, "w", encoding="utf-8") as f:
        n = 0
        for w in words:
            for phones, score in gen.generate(w, num_pronunciations):
                if export_scores:
                    f.write(f"{w}\t{score:.4f}\t{' '.join(phones)}\n")
                else:
                    f.write(f"{w}\t{' '.join(phones)}\n")
                n += 1
    print(f"Wrote {n} pronunciations for {len(words)} words to {args.output_path}")
    return 0


def _validate_dictionary(args) -> int:
    """G2P-based dictionary QA (reference ``mfa validate_dictionary``,
    ``validation/dictionary_validator.py:15``): train a G2P model on the
    dictionary and flag entries whose pronunciations disagree strongly."""
    from montreal_forced_aligner_tpu_torch.dictionary.lexicon import (
        parse_dictionary_file,
    )
    from montreal_forced_aligner_tpu_torch.evaluation import edit_distance
    from montreal_forced_aligner_tpu_torch.g2p.generator import G2PGenerator
    from montreal_forced_aligner_tpu_torch.g2p.trainer import G2PTrainer

    pairs = [
        (w, p.phones) for w, p in parse_dictionary_file(args.dictionary_path)
    ]
    gen = G2PGenerator(G2PTrainer(order=args.order).train_from_pairs(pairs))
    flagged = []
    for w, phones in pairs:
        hyps = gen.generate(w, num_pronunciations=3)
        if not hyps:
            continue
        best = min(edit_distance(list(phones), list(h)) for h, _s in hyps)
        if best > max(2, len(phones) // 2):
            flagged.append((w, " ".join(phones), best))
    print(f"Validated {len(pairs)} entries; {len(flagged)} flagged")
    for w, pron, d in flagged[:50]:
        print(f"  {w}\t{pron}\t(phone distance {d})")
    return 0


def _train_tokenizer(args) -> int:
    """Train a tokenizer from tab-separated (raw, tokenized) lines
    (reference ``mfa train_tokenizer``, ``tokenization/trainer.py``)."""
    from montreal_forced_aligner_tpu_torch.tokenization.trainer import (
        TokenizerTrainer,
    )

    pairs = []
    for line in Path(args.training_file).read_text(encoding="utf-8").splitlines():
        if "\t" in line:
            raw, tok = line.split("\t", 1)
            pairs.append((raw.strip(), tok.strip()))
    if args.evaluation_mode and len(pairs) >= 10:
        import random

        from montreal_forced_aligner_tpu_torch.evaluation import edit_distance

        rng = random.Random(1234)
        idx = set(rng.sample(range(len(pairs)), max(1, len(pairs) // 10)))
        train = [p for i, p in enumerate(pairs) if i not in idx]
        test = [p for i, p in enumerate(pairs) if i in idx]
        tok = TokenizerTrainer(order=args.order).train_from_pairs(train)
        correct = 0
        cers = []
        for raw, ref in test:
            hyp = tok.tokenize(raw)
            correct += hyp == ref
            # spaces count: they are exactly what tokenization predicts
            cers.append(edit_distance(list(ref), list(hyp)) / max(len(ref), 1))
        print(
            f"Evaluation on {len(test)} held-out lines: utterance accuracy "
            f"{correct / len(test):.4f}, CER "
            f"{sum(cers) / len(cers):.4f}"
        )
    tokenizer = TokenizerTrainer(order=args.order).train_from_pairs(pairs)
    tokenizer.model.save(args.output_model_path)
    print(f"Trained tokenizer on {len(pairs)} pairs -> {args.output_model_path}")
    return 0


def _tokenize(args) -> int:
    """Tokenize text with a trained tokenizer (reference ``mfa tokenize``)."""
    from montreal_forced_aligner_tpu_torch.g2p.trainer import G2PModel
    from montreal_forced_aligner_tpu_torch.tokenization.trainer import (
        TrainedTokenizer,
    )

    tok = TrainedTokenizer(model=G2PModel.load(args.tokenizer_model_path))
    lines = Path(args.input_path).read_text(encoding="utf-8").splitlines()
    with open(args.output_path, "w", encoding="utf-8") as f:
        for line in lines:
            f.write(tok.tokenize(line.strip()) + "\n")
    print(f"Tokenized {len(lines)} lines -> {args.output_path}")
    return 0


def _transcribe_neural(args, transcriber_class) -> int:
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    tr = transcriber_class(args.model_path, language=args.language,
                           device=args.device)
    with _profiled(args.profile_dir, tr.device, "transcribe_trace.json"):
        corpus = Corpus.load(args.corpus_directory, require_transcripts=False)
        results = tr.transcribe_corpus(corpus)
    _export_transcripts(corpus, results, args.output_directory)
    print(f"Transcribed {len(results)} utterances to {args.output_directory}")
    return 0


def _transcribe_whisper(args) -> int:
    """Transcribe a corpus with a local Whisper checkpoint (reference ``mfa
    transcribe_whisper``, ``transcription/transcriber.py:1850``): the
    port's own model on the device; one ``spk/<file>.lab`` per file."""
    from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
        WhisperTranscriber,
    )

    return _transcribe_neural(args, WhisperTranscriber)


def _transcribe_speechbrain(args) -> int:
    """Transcribe a corpus with a local SpeechBrain ASR checkpoint
    (reference ``mfa transcribe_speechbrain``,
    ``transcription/transcriber.py:1967``); needs the speechbrain package."""
    from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
        SpeechbrainTranscriber,
    )

    return _transcribe_neural(args, SpeechbrainTranscriber)


_COMMANDS = {
    "align": _align, "align_one": _align_one, "train": _train, "adapt": _adapt,
    "validate": _validate, "transcribe": _transcribe,
    "train_ivector": _train_ivector, "diarize_speakers": _diarize_speakers,
    "create_segments_vad": _create_segments_vad,
    "transcribe_whisper": _transcribe_whisper,
    "transcribe_speechbrain": _transcribe_speechbrain,
    "create_segments": _create_segments,
    "evaluate_alignments": _evaluate_alignments,
    "train_lm": _train_lm, "train_dictionary": _train_dictionary,
    "model": _model, "models": _model, "version": _version,
    "configure": _configure, "history": _history,
    "train_g2p": _train_g2p, "g2p": _g2p,
    "validate_dictionary": _validate_dictionary,
    "train_tokenizer": _train_tokenizer, "tokenize": _tokenize,
}


def main(argv: Optional[List[str]] = None) -> int:
    """Run one command. Called with no ``argv`` (the command line itself),
    the command is also recorded in the history store."""
    args = _parser().parse_args(argv)
    level = logging.WARNING
    if args.debug:
        level = logging.DEBUG
    elif args.verbose:
        level = logging.INFO
    elif args.quiet:
        level = logging.ERROR
    logging.basicConfig(level=level, format="%(levelname)s %(message)s")
    if getattr(args, "num_jobs", None) is not None:
        _logger.info(
            "--num_jobs %s accepted for compatibility; this port parallelizes "
            "via device batches (--batch_size), not worker processes",
            args.num_jobs,
        )
    if argv is None:
        from montreal_forced_aligner_tpu_torch.config import record_history

        record_history(sys.argv[1:])
    from montreal_forced_aligner_tpu_torch.exceptions import MFAError
    from montreal_forced_aligner_tpu_torch.parallel import multihost

    # a multi-process launch (python -m torch.distributed.run): join the
    # process group before any device use (a caller that made the group
    # keeps it)
    joined = "WORLD_SIZE" in os.environ and not multihost.is_initialized()
    if joined:
        multihost.initialize_multihost(device=getattr(args, "device", "cpu"))
    try:
        return _COMMANDS[args.command](args)
    except MFAError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    finally:
        if joined:
            multihost.shutdown_multihost()


if __name__ == "__main__":
    sys.exit(main())
