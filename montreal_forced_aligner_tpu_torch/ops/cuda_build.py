"""Build and load the hand-written CUDA kernels, and count their launches.

Each source in ``csrc/`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, which is loaded
with ``ctypes``. Libraries go to ``_build/`` inside the package (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused. :func:`build_all` starts
one ``nvcc`` per source at once.

Nothing here runs at import: the CPU tests import every module, where
there may be no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# per-source extra nvcc flags. band_viterbi must not contract a*b + c into
# an FMA: its kernel is held bit for bit against the plain version.
_EXTRA_FLAGS: Dict[str, List[str]] = {
    "band_viterbi": ["--fmad=false"],
    "state_emission": [],
}
_BASE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# kernel name -> launches since the last reset; each wrapper adds one where
# it launches its kernel, and nowhere else
LAUNCHES: Dict[str, int] = {
    "band_forward": 0,
    "band_backtrace": 0,
    "state_emission": 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are built "
        "from csrc/ at first use"
    )


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(_BASE_FLAGS + _EXTRA_FLAGS[name]).encode()
    digest = hashlib.sha1(src + b"\0" + flags).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, target) or
    None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_BASE_FLAGS, *_EXTRA_FLAGS[name], "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def _finish_build(name: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: concurrent builders never see a torn file


def build_all() -> None:
    """Compile every kernel source that is not built yet, all at once."""
    with _lock:
        jobs = {n: _start_build(n) for n in _EXTRA_FLAGS}
        for n, job in jobs.items():
            if job is not None:
                _finish_build(n, job)


def load_library(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    ``declare(lib)`` sets its functions' argument and result types, once,
    when the library is first loaded."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        job = _start_build(name)
        if job is not None:
            _finish_build(name, job)
        lib = ctypes.CDLL(str(_target(name)))
        declare(lib)
        _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_inputs(what: str, device, specs) -> None:
    """Raise ``ValueError`` unless every ``(name, tensor, dtype, shape)`` in
    ``specs`` is a contiguous tensor of that dtype and shape on ``device``:
    a kernel reads raw pointers and checks nothing itself."""
    for name, x, dtype, shape in specs:
        if (x.device != device or x.dtype != dtype
                or tuple(x.shape) != tuple(shape) or not x.is_contiguous()):
            raise ValueError(
                f"{what}: {name} is {x.dtype} {tuple(x.shape)} on {x.device} "
                f"(contiguous: {x.is_contiguous()}); expected a contiguous "
                f"{dtype} {tuple(shape)} on {device}"
            )
