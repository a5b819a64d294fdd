"""Short import alias for :mod:`montreal_forced_aligner_tpu_torch`."""
import sys as _sys

from montreal_forced_aligner_tpu_torch import *  # noqa: F401,F403
from montreal_forced_aligner_tpu_torch import __version__  # noqa: F401

_sys.modules.setdefault("mfa_tpu_torch._base", _sys.modules["montreal_forced_aligner_tpu_torch"])
