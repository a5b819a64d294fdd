"""Model registry: save, list and resolve pretrained models by name.

Counterpart of ``montreal_forced_aligner_tpu/model_manager.py``, on the same
local store. Behavioral spec: reference ``models.py:1619-1937`` (``ModelManager`` /
``ModelRelease``: download from the MFA-models GitHub releases into
``~/Documents/MFA/pretrained_models/<type>/``, resolve CLI model-name
arguments to archives). The registry is local: ``add``/``list``/``resolve``
work on the local store (``MFA_TPU_MODEL_ROOT``); ``download`` reads only
``MFA_TPU_MODEL_MIRROR``, a local directory mirror, and otherwise raises,
since fetching a release needs the network.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Dict, List, Optional

MODEL_TYPES = (
    "acoustic",
    "g2p",
    "language_model",
    "ivector",
    "dictionary",
    "tokenizer",
)

EXTENSIONS = {
    "acoustic": ".zip",
    "g2p": ".zip",
    "language_model": ".zip",
    "ivector": ".npz",
    "dictionary": ".dict",
    "tokenizer": ".zip",
}

# extra accepted suffixes per type (mirror lookups and release assets):
# language models exist both as archives (large+medium+small, reference
# models.py:1258) and bare ARPA files
ALT_EXTENSIONS = {
    "language_model": (".zip", ".arpa", ".lm"),
}


def default_root() -> Path:
    return Path(
        os.environ.get(
            "MFA_TPU_MODEL_ROOT",
            Path.home() / "Documents" / "MFA-TPU" / "pretrained_models",
        )
    )


class ModelManager:
    def __init__(self, root: Optional[Path] = None):
        self.root = Path(root) if root else default_root()

    def _dir(self, model_type: str) -> Path:
        if model_type not in MODEL_TYPES:
            raise ValueError(f"unknown model type {model_type!r}")
        return self.root / model_type

    def add(self, model_type: str, path, name: Optional[str] = None) -> Path:
        """Register a local model archive under a name."""
        src = Path(path)
        name = name or src.stem
        dst = self._dir(model_type) / (name + src.suffix)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
        return dst

    def list_models(self, model_type: Optional[str] = None) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for mt in MODEL_TYPES:
            if model_type and mt != model_type:
                continue
            d = self._dir(mt)
            out[mt] = sorted(p.stem for p in d.glob("*")) if d.exists() else []
        return out

    def resolve(self, model_type: str, name_or_path) -> Path:
        """Resolve a CLI model argument: an existing path wins, otherwise a
        registered name (reference CLI behavior for model-name arguments)."""
        p = Path(name_or_path)
        if p.exists():
            return p
        d = self._dir(model_type)
        candidates = list(d.glob(f"{name_or_path}.*")) if d.exists() else []
        if candidates:
            return candidates[0]
        raise FileNotFoundError(
            f"no {model_type} model {name_or_path!r}: not a path and not in "
            f"{d} (register one with `mfa-tpu model add`)"
        )

    def download(
        self, model_type: str, name: str, version: Optional[str] = None
    ) -> Path:
        """Fetch a pretrained model from a local mirror
        (``MFA_TPU_MODEL_MIRROR``, laid out ``<type>/<name><ext>``). Fetching
        from the MFA-models releases (reference ``models.py:1654``) needs the
        network, which this port never opens: without a mirror holding the
        model it raises with guidance."""
        mirror = os.environ.get("MFA_TPU_MODEL_MIRROR")
        exts = ALT_EXTENSIONS.get(model_type, (EXTENSIONS[model_type],))
        if mirror:
            for ext in exts:
                src = Path(mirror) / model_type / (name + ext)
                if src.exists():
                    return self.add(model_type, src, name)
        raise RuntimeError(
            f"could not download {model_type} model {name!r}"
            f"{'' if version is None else f' v{version}'}: downloading needs "
            "the network, which this package does not use. Set "
            "MFA_TPU_MODEL_MIRROR to a local mirror, or place the archive "
            f"manually and run: mfa-tpu-torch model add {model_type} <path>"
        )
