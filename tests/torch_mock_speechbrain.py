"""An in-process stand-in for the ``speechbrain`` package, for the port.

The same three models as ``tests/mock_speechbrain.py`` (an energy VAD, a
sinusoid-filterbank x-vector encoder, a pooling ASR whose output length
drives its text), with the same deterministic weights round-tripped
through ``torch.save``/``torch.load`` by ``from_hparams``, and the
surface pinned in ``montreal_forced_aligner_tpu_torch.speechbrain_surface``.
Unlike that mock, ``from_hparams`` honours ``run_opts["device"]`` as the
real package does: the modules move to that device, and each model keeps
the device of the last wave it was given (``input_device``), so a run on
the card can show where its models and inputs were. It imports nothing of
the JAX package.

Install with :func:`install` (uses ``sys.modules``); a real speechbrain,
when importable, always wins.
"""

from __future__ import annotations

import os
import sys
import types

import numpy as np


def _checkpoint_round_trip(module, savedir, name):
    """Save the weights once per checkpoint directory and load them back,
    as the real package materialises checkpoint files."""
    if savedir is None:
        return module
    import torch

    os.makedirs(savedir, exist_ok=True)
    path = os.path.join(savedir, name)
    if not os.path.exists(path):
        torch.save(module.state_dict(), path)
    module.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return module


def _build_classes():
    import torch

    class _Base(torch.nn.Module):
        @classmethod
        def from_hparams(cls, source=None, savedir=None, run_opts=None):
            torch.manual_seed(0)  # deterministic weights
            model = cls()
            model.eval()
            _checkpoint_round_trip(model, savedir, f"{cls.__name__}.ckpt")
            model.device = torch.device((run_opts or {}).get("device", "cpu"))
            model.input_device = None
            return model.to(model.device)

        def _seen(self, wav):
            self.input_device = wav.device
            return wav

    class _MockASR(_Base):
        """EncoderDecoderASR stand-in: a pooling encoder whose output
        length (one 'token' per second of audio) drives the decode."""

        def __init__(self):
            super().__init__()
            self.pool = torch.nn.AvgPool1d(kernel_size=16000, stride=16000)

        def forward(self, wav):
            return self.pool(wav.reshape(1, 1, -1) ** 2)

        def transcribe_batch(self, wav, lens):
            with torch.no_grad():
                frames = self.forward(self._seen(wav))
            n_tokens = max(1, int(frames.shape[-1]))
            return [("MOCK " * n_tokens).strip()], torch.ones(1, device=wav.device)

    class _MockVAD(_Base):
        """speechbrain.inference.VAD stand-in: chunked energy posteriors
        from a conv-pool energy network (10 ms chunks at 16 kHz)."""

        CHUNK = 160

        def __init__(self):
            super().__init__()
            self.pool = torch.nn.AvgPool1d(kernel_size=self.CHUNK, stride=self.CHUNK)

        def forward(self, wav):
            energy = self.pool(wav.reshape(1, 1, -1) ** 2).reshape(-1)
            logp = torch.log(torch.sqrt(energy) + 1e-12)
            return torch.sigmoid(logp - logp.median())

        def get_speech_prob_chunk(self, wav):
            with torch.no_grad():
                return self.forward(self._seen(wav))

    class _MockEncoderClassifier(_Base):
        """EncoderClassifier stand-in: 32 fixed sine filters at distinct
        frequencies; log band energies -> a normalised embedding, so the
        same dominant frequency maps to nearby embeddings."""

        DIM = 32
        KERNEL = 256

        def __init__(self):
            super().__init__()
            self.bank = torch.nn.Conv1d(1, self.DIM, kernel_size=self.KERNEL,
                                        stride=128, bias=False)
            t = np.arange(self.KERNEL)
            filters = np.stack([
                np.sin(2 * np.pi * (k + 1) * t / self.KERNEL) * np.hanning(self.KERNEL)
                for k in range(self.DIM)
            ]).astype(np.float32)
            with torch.no_grad():
                self.bank.weight.copy_(torch.from_numpy(filters).unsqueeze(1))

        def forward(self, wav):
            x = wav.reshape(1, 1, -1)[:, :, : 1 << 14]
            resp = self.bank(x) ** 2  # (1, DIM, T')
            emb = torch.log(resp.mean(dim=2) + 1e-6)
            emb = (emb - emb.mean()) / (emb.std() + 1e-6)
            return emb.reshape(1, 1, -1)

        def encode_batch(self, wav):
            with torch.no_grad():
                return self.forward(self._seen(wav))

    return _MockASR, _MockVAD, _MockEncoderClassifier


def install() -> None:
    """Register the mock as ``speechbrain`` in ``sys.modules`` (no-op if a
    real package is importable)."""
    try:
        import speechbrain  # noqa: F401

        if not getattr(speechbrain, "__mfa_tpu_mock__", False):
            return  # never shadow a real install
    except ImportError:
        pass
    asr_cls, vad_cls, enc_cls = _build_classes()
    root = types.ModuleType("speechbrain")
    root.__mfa_tpu_mock__ = True
    inference = types.ModuleType("speechbrain.inference")
    asr = types.ModuleType("speechbrain.inference.ASR")
    asr.EncoderDecoderASR = asr_cls
    vad = types.ModuleType("speechbrain.inference.VAD")
    vad.VAD = vad_cls
    speaker = types.ModuleType("speechbrain.inference.speaker")
    speaker.EncoderClassifier = enc_cls
    inference.ASR, inference.VAD, inference.speaker = asr, vad, speaker
    root.inference = inference
    sys.modules.update({
        "speechbrain": root,
        "speechbrain.inference": inference,
        "speechbrain.inference.ASR": asr,
        "speechbrain.inference.VAD": vad,
        "speechbrain.inference.speaker": speaker,
    })


def uninstall() -> None:
    root = sys.modules.get("speechbrain")
    if root is None or not getattr(root, "__mfa_tpu_mock__", False):
        return
    for name in list(sys.modules):
        if name == "speechbrain" or name.startswith("speechbrain."):
            sys.modules.pop(name, None)
