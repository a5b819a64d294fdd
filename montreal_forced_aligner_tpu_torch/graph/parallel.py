"""Multiprocess host graph compilation.

Counterpart of ``montreal_forced_aligner_tpu/graph/parallel.py``. The
host-side lexicon/HMM expansion (``AlignmentGraphCompiler.compile``) grows
linearly with corpus size and runs on no device; for context-dependent
trees, which the native core does not assemble, it fans out over a process
pool (the reference parallelizes the same stage across jobs,
``CompileTrainGraphsFunction``, ``alignment/multiprocessing.py:386``).

The pool uses the ``spawn`` context: a forked child of a process that holds
a CUDA context must never run. Workers are numpy-only: they hide every card
(``CUDA_VISIBLE_DEVICES`` empty) before they unpickle anything, so a worker
never creates a CUDA context, and a ``CompiledGraph`` holds numpy arrays
only, so nothing of torch crosses the pipe.

Workers receive the pickled compiler table once at pool startup; per-task
traffic is ``(dictionary_key, tokens)`` in and a ``CompiledGraph`` of small
numpy arrays out. Results are returned in submission order, and each worker
replays exactly the serial expansion (compilation is a pure function of the
compiler state), so graphs — and therefore boundaries — are identical to
single-process compilation.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Sequence, Tuple

from montreal_forced_aligner_tpu_torch.graph.compiler import (
    AlignmentGraphCompiler,
    CompiledGraph,
)

_COMPILERS: Dict[str, AlignmentGraphCompiler] = {}


def _init_worker(payload: bytes) -> None:
    global _COMPILERS
    # CUDA reads this when it first initialises: a worker that touched the
    # card by mistake would find none instead of opening a context
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _COMPILERS = pickle.loads(payload)


def _compile_one(item: Tuple[str, Tuple[str, ...]]) -> CompiledGraph:
    key, tokens = item
    return _COMPILERS[key].compile(list(tokens))


class ParallelGraphCompiler:
    """A persistent worker pool over a compiler table.

    Reused across ``align_corpus`` calls (pool startup costs ~1-2 s: spawn +
    compiler unpickling); only worth engaging for corpora with at least a few
    utterances per worker — callers gate on corpus size.
    """

    def __init__(
        self,
        compilers: Dict[str, AlignmentGraphCompiler],
        num_workers: int,
    ):
        payload = pickle.dumps(compilers, protocol=pickle.HIGHEST_PROTOCOL)
        self.num_workers = num_workers
        self._pool = ProcessPoolExecutor(
            max_workers=num_workers,
            mp_context=mp.get_context("spawn"),
            initializer=_init_worker,
            initargs=(payload,),
        )

    def compile_all(
        self, items: Sequence[Tuple[str, Sequence[str]]]
    ) -> List[CompiledGraph]:
        """Compile ``[(dictionary_key, tokens)]`` -> graphs, in order."""
        items = [(k, tuple(t)) for k, t in items]
        chunksize = max(1, len(items) // (self.num_workers * 4))
        return list(self._pool.map(_compile_one, items, chunksize=chunksize))

    def close(self, wait: bool = False) -> None:
        """Stop the workers; with ``wait``, return once they have exited."""
        self._pool.shutdown(wait=wait, cancel_futures=True)

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass


# --- shared pool with per-call compiler tables -----------------------------
# Training rebuilds the compiler every stage (new tree/transition model), so
# the fixed-initializer pool above would respawn workers per stage (~1-2 s
# each time). This variant keeps workers alive and ships each stage's pickled
# table through a temp file that every worker loads once per version.

_WORKER_TABLES: Dict[int, Dict[str, AlignmentGraphCompiler]] = {}


def _compile_one_versioned(item):
    path, version, key, tokens = item
    table = _WORKER_TABLES.get(version)
    if table is None:
        with open(path, "rb") as f:
            table = pickle.load(f)
        _WORKER_TABLES.clear()  # stages are sequential; drop stale tables
        _WORKER_TABLES[version] = table
    return table[key].compile(list(tokens))


class SharedGraphCompilerPool:
    """Persistent worker pool reused across compiler-table changes."""

    def __init__(self, num_workers: int):
        import tempfile

        self.num_workers = num_workers
        self._pool = ProcessPoolExecutor(
            max_workers=num_workers,
            mp_context=mp.get_context("spawn"),
            initializer=_init_worker,
            initargs=(pickle.dumps({}),),
        )
        self._version = 0
        self._tmpdir = tempfile.mkdtemp(prefix="mfa_tpu_graph_tables_")

    def compile_all(
        self,
        items: Sequence[Tuple[str, Sequence[str]]],
        compilers: Dict[str, AlignmentGraphCompiler],
    ) -> List[CompiledGraph]:
        import os

        self._version += 1
        path = os.path.join(self._tmpdir, f"table_{self._version}.pkl")
        with open(path, "wb") as f:
            pickle.dump(compilers, f, protocol=pickle.HIGHEST_PROTOCOL)
        args = [(path, self._version, k, tuple(t)) for k, t in items]
        chunksize = max(1, len(args) // (self.num_workers * 4))
        out = list(
            self._pool.map(_compile_one_versioned, args, chunksize=chunksize)
        )
        os.unlink(path)  # map() has completed; no worker will re-read it
        return out

    def close(self, wait: bool = False) -> None:
        """Stop the workers and drop the table files; with ``wait``, return
        once the workers have exited."""
        import shutil

        self._pool.shutdown(wait=wait, cancel_futures=True)
        shutil.rmtree(self._tmpdir, ignore_errors=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
