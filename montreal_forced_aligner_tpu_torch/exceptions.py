"""Exception hierarchy (reference ``exceptions.py:72-961``, rooted at
``MFAError``; the kaldi-log-scraping machinery is unnecessary since there
are no subprocess workers)."""

from __future__ import annotations

from typing import List, Optional


class MFAError(Exception):
    """Root of the framework's exception hierarchy."""


# -- model errors ------------------------------------------------------------
class ModelError(MFAError):
    pass


class ModelLoadError(ModelError):
    pass


class ModelTypeError(ModelError):
    pass


class PhoneMismatchError(ModelError):
    """Dictionary phones missing from the acoustic model inventory
    (reference ``AcousticModel.validate``, ``models.py:790``)."""

    def __init__(self, missing_phones, model_phones=None):
        self.missing_phones = sorted(missing_phones)
        hint = ""
        if model_phones:
            hint = (
                f" The model's phone set is: "
                f"{sorted(model_phones)[:40]}..."
                if len(model_phones) > 40
                else f" The model's phone set is: {sorted(model_phones)}."
            )
        super().__init__(
            "The pronunciation dictionary uses phones the acoustic model "
            f"was not trained on: {self.missing_phones}.{hint} The "
            "dictionary and model must share a phone set (e.g. ARPA "
            "dictionary with an ARPA model); pick the matching dictionary "
            "or retrain with this one."
        )


# -- dictionary errors -------------------------------------------------------
class DictionaryError(MFAError):
    pass


class DictionaryPathError(DictionaryError):
    pass


class DictionaryFileError(DictionaryError):
    pass


class DictionaryParseError(DictionaryError, ValueError):
    """A malformed dictionary line, located by file + 1-based line number
    (reference ``DictionaryError`` family, ``exceptions.py:72-961``).
    Subclasses ValueError for backwards compatibility."""

    def __init__(self, path, line_number: int, line: str, reason: str):
        self.path = path
        self.line_number = line_number
        self.line = line
        super().__init__(
            f"{path}, line {line_number}: {reason}\n"
            f"    {line.rstrip()!r}\n"
            "Dictionary lines are `word [prob [sil_prob [corrections]]] "
            "phone phone ...` separated by whitespace."
        )


# -- corpus errors -----------------------------------------------------------
class CorpusError(MFAError):
    pass


class CorpusReadError(CorpusError):
    def __init__(self, file_name, message: str = ""):
        self.file_name = file_name
        super().__init__(f"Error reading {file_name}: {message}")


class EmptyCorpusError(CorpusError, FileNotFoundError):
    """No sound files found (reference ``CorpusError`` on empty corpora).
    Subclasses FileNotFoundError for backwards compatibility."""

    def __init__(self, directory):
        self.directory = directory
        super().__init__(
            f"No sound files (.wav/.flac/.mp3/.opus) found under "
            f"{directory}. Expected an MFA-style corpus: per-speaker "
            "directories of audio + .lab/.txt transcripts, or audio + "
            ".TextGrid pairs. Check the corpus path (and --audio_directory "
            "if transcripts and audio live apart)."
        )


class NoTranscriptsError(CorpusError):
    """Sound files exist but none paired with a transcript."""

    def __init__(self, directory, num_wavs: int):
        self.directory = directory
        super().__init__(
            f"Found {num_wavs} sound files under {directory} but no "
            "transcripts paired with any of them. Each audio file needs a "
            ".lab/.txt (same stem) or a .TextGrid with speaker tiers; use "
            "--audio_directory when audio and transcripts live in separate "
            "trees, or `mfa-tpu create_segments_vad` to bootstrap "
            "segments for untranscribed audio."
        )


class AllOovError(CorpusError):
    """Every utterance's words are out-of-vocabulary for the dictionary."""

    def __init__(self, num_utterances: int, examples):
        self.examples = list(examples)[:10]
        super().__init__(
            f"None of the {num_utterances} utterances contain any word "
            f"found in the pronunciation dictionary (sample OOVs: "
            f"{self.examples}). The transcripts and dictionary likely use "
            "different languages, casing conventions, or orthographies; "
            "run `mfa-tpu validate` for an OOV report, or `mfa-tpu g2p` "
            "to generate pronunciations for the missing words."
        )


class SoundFileError(CorpusReadError):
    pass


class TextParseError(CorpusReadError):
    pass


class TextGridParseError(CorpusReadError):
    pass


# -- alignment errors --------------------------------------------------------
class AlignmentError(MFAError):
    pass


class AlignmentExportError(AlignmentError):
    pass


class NoAlignmentsError(AlignmentError):
    def __init__(self, num_utterances: int = 0):
        super().__init__(
            f"No utterances could be aligned (of {num_utterances})"
        )


# -- training / config errors ------------------------------------------------
class TrainerError(MFAError):
    pass


class ConfigError(MFAError):
    pass


class G2PError(MFAError):
    pass


class LanguageModelError(MFAError):
    pass


class KaldiProcessingError(MFAError):
    """Kept for API parity with the reference (``exceptions.py:961``); this
    framework has no Kaldi subprocesses, so it only wraps numerical-pipeline
    failures."""

    def __init__(self, error_logs: Optional[List[str]] = None, message: str = ""):
        self.error_logs = error_logs or []
        super().__init__(message or "Processing error")
