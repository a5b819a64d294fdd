"""Global configuration and profiles.

Counterpart of ``montreal_forced_aligner_tpu/config.py``, on the same store
(``MFA_TPU_TEMP_DIR``). Behavioral spec: reference ``config.py`` (global flags ``:138-158``, the
``MfaProfile`` yaml profile store selected by ``MFA_PROFILE`` ``:167-280``,
command history ``:94-135``). Postgres/server management does not exist here
(the in-memory pipeline replaced the database), so profiles only carry
runtime options.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml


def temporary_directory() -> Path:
    return Path(
        os.environ.get(
            "MFA_TPU_TEMP_DIR", Path.home() / "Documents" / "MFA-TPU"
        )
    )


def global_config_path() -> Path:
    return temporary_directory() / "global_config.yaml"


@dataclass
class Profile:
    """Runtime options (the subset of the reference's profile flags that are
    meaningful without the Postgres/multiprocessing control plane)."""

    clean: bool = False
    debug: bool = False
    verbose: bool = False
    seed: int = 0
    batch_size: int = 16
    num_jobs: int = 3  # accepted for CLI parity; device count rules instead
    single_speaker: bool = False
    temporary_directory: str = ""

    def update(self, options: Dict[str, Any]) -> None:
        for k, v in options.items():
            if hasattr(self, k) and v is not None:
                setattr(self, k, v)


class Config:
    def __init__(self):
        self.profiles: Dict[str, Profile] = {"global": Profile()}
        self.current_profile_name = os.environ.get("MFA_TPU_PROFILE", "global")
        self.load()

    @property
    def current_profile(self) -> Profile:
        if self.current_profile_name not in self.profiles:
            self.profiles[self.current_profile_name] = Profile()
        return self.profiles[self.current_profile_name]

    def load(self) -> None:
        path = global_config_path()
        if not path.exists():
            return
        with open(path, "r", encoding="utf-8") as f:
            data = yaml.safe_load(f) or {}
        for name, opts in (data.get("profiles") or {}).items():
            prof = Profile()
            prof.update(opts or {})
            self.profiles[name] = prof

    def save(self) -> None:
        path = global_config_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            yaml.safe_dump(
                {
                    "profiles": {
                        name: asdict(p) for name, p in self.profiles.items()
                    }
                },
                f,
            )


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


# -- command history (reference ``config.py:94-135``) ------------------------
def history_path() -> Path:
    return temporary_directory() / "history.yaml"


def record_history(command: List[str], exit_code: int = 0) -> None:
    """Append ``command`` to the history store. Processes that run at once
    (the ranks of one launch) share the store: each writes a file of its
    own and renames it over the store, so a reader never sees a partial
    one; an unreadable store starts anew."""
    path = history_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    entry = {
        "command": command,
        "time": datetime.datetime.now().isoformat(timespec="seconds"),
        "exit_code": exit_code,
    }
    try:
        history = load_history()
    except yaml.YAMLError:
        history = []
    history.append(entry)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        yaml.safe_dump(history[-200:], f)
    os.replace(tmp, path)


def load_history() -> List[dict]:
    path = history_path()
    if not path.exists():
        return []
    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f) or []
