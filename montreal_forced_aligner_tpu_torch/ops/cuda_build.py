"""Build and load the hand-written native code, and count kernel launches.

Each CUDA source in ``csrc/`` is compiled on first use with ``nvcc`` for
``sm_90a``, and the host C++ sources in ``native/`` with ``g++``, into a
shared library with a plain C interface, which is loaded with ``ctypes``.
Libraries go to ``_build/`` inside the package (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused. :func:`build_all` starts one compiler per
source at once. A failed build raises: nothing falls back to another path.

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
from typing import Callable, Dict, List, NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
_GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]


class Source(NamedTuple):
    path: Path
    compiler: str  # "nvcc" or "g++"
    flags: List[str]


# band_viterbi must not contract a*b + c into an FMA: its kernel is held bit
# for bit against the plain version.
SOURCES: Dict[str, Source] = {
    "band_viterbi": Source(CSRC / "band_viterbi.cu", "nvcc",
                           _NVCC_FLAGS + ["--fmad=false"]),
    "state_emission": Source(CSRC / "state_emission.cu", "nvcc", _NVCC_FLAGS),
    "fmllr_solve": Source(_PKG / "native" / "fmllr_solve.cc", "g++", _GXX_FLAGS),
    "graph_assembly": Source(_PKG / "native" / "graph_assembly.cc", "g++",
                             _GXX_FLAGS),
    "flac_decode": Source(_PKG / "native" / "flac_decode.cc", "g++",
                          _GXX_FLAGS),
}

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


def _compiler(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    if name == "nvcc":
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError(
        f"{name} not found (PATH or $CUDA_HOME/bin): the native libraries "
        "are built from the package's sources at first use"
    )


def _target(name: str) -> Path:
    src = SOURCES[name]
    flags = " ".join([src.compiler] + src.flags).encode()
    digest = hashlib.sha1(src.path.read_bytes() + b"\0" + flags).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start the compiler for one source; returns (process, tmp path,
    target) or None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    src = SOURCES[name]
    cmd = [_compiler(src.compiler), *src.flags, "-o", str(tmp), str(src.path)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def _finish_build(name: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"{SOURCES[name].compiler} failed for {SOURCES[name].path.name}:\n{out}"
        )
    os.replace(tmp, target)  # atomic: concurrent builders never see a torn file


def build_all() -> None:
    """Compile every source that is not built yet, all at once."""
    with _lock:
        jobs = {n: _start_build(n) for n in SOURCES}
        for n, job in jobs.items():
            if job is not None:
                _finish_build(n, job)


def load_library(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for source ``name``, built first if needed.
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
