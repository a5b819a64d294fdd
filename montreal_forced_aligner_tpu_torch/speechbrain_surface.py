"""The speechbrain API surface this framework consumes, pinned in ONE place.

Three wrappers integrate speechbrain models (reference:
``transcription/transcriber.py:1967`` EncoderDecoderASR,
``vad/models.py:133`` VAD, ``diarization/multiprocessing.py:610-749``
EncoderClassifier):

- :mod:`..transcription.torch_models` ``SpeechbrainTranscriber``
- :mod:`..vad.segmenter` ``SpeechbrainVadSegmenter``
- :mod:`..diarization.embeddings` ``XVectorEmbedder``

Every (module, class, method) they touch is listed here; the test mock
(``tests/torch_mock_speechbrain.py``) and an interface test assert both the mock
and — when the real package is installed — speechbrain itself provide
exactly this surface, so a wrapper can only consume names the contract
covers and a speechbrain release that breaks the contract fails loudly in
CI instead of silently at a user's machine.
"""

from __future__ import annotations

# module path -> class name -> methods the wrappers call.
# `from_hparams(source=..., savedir=..., run_opts=...)` is the loader
# classmethod on every speechbrain inference class.
SPEECHBRAIN_SURFACE = {
    "speechbrain.inference.ASR": {
        "EncoderDecoderASR": (
            "from_hparams",
            # (wavs (B, T) float tensor, wav_lens (B,) relative lengths)
            # -> (list[str] transcripts, token tensor)
            "transcribe_batch",
        ),
    },
    "speechbrain.inference.VAD": {
        "VAD": (
            "from_hparams",
            # (wav (1, T) float tensor) -> frame posterior tensor
            "get_speech_prob_chunk",
        ),
    },
    "speechbrain.inference.speaker": {
        "EncoderClassifier": (
            "from_hparams",
            # (wav (1, T) float tensor) -> (1, 1, D) embedding tensor
            "encode_batch",
        ),
    },
}


def check_surface(get_module) -> list:
    """Return [(module, class, method)] missing from an implementation.

    ``get_module``: callable mapping a module path to a module object
    (e.g. ``importlib.import_module``). Used by the interface tests to
    hold both the mock and the real package to the same contract."""
    missing = []
    for mod_path, classes in SPEECHBRAIN_SURFACE.items():
        try:
            mod = get_module(mod_path)
        except ImportError:
            missing.append((mod_path, None, None))
            continue
        for cls_name, methods in classes.items():
            cls = getattr(mod, cls_name, None)
            if cls is None:
                missing.append((mod_path, cls_name, None))
                continue
            for meth in methods:
                if not callable(getattr(cls, meth, None)):
                    missing.append((mod_path, cls_name, meth))
    return missing
