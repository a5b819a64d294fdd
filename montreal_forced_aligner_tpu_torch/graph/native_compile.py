"""Native (C++) batch graph compilation for monophone alignment graphs.

Counterpart of ``montreal_forced_aligner_tpu/graph/native_compile.py``.
Drives ``native/graph_assembly.cc``: host-side lexicon lookup and template
freezing stay in Python (shared with the pure-Python compiler's caches, so
either path produces identical templates), while per-utterance template
splicing, junction-arc construction and the dense incoming-arc assembly run
in C++ over a thread pool. Output is bit-identical to
``AlignmentGraphCompiler.compile`` (``tests/test_torch_native_graph.py``).
Utterances whose pronunciations start with the silence phone engage the
compiler's context filters, which the C++ core does not replay: those, and
tokens with no pronunciation, are compiled per utterance by the Python
compiler, which is the compiler's own semantics and not a fallback.

The library is built by ``g++`` through ``ops/cuda_build.py`` at first use.
A failed build raises; only a context-dependent tree (``tree.N != 1``)
returns None, so the caller takes the Python compiler or the worker pool.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch.graph.compiler import (
    NEG_INF,
    AlignmentGraphCompiler,
    CompiledGraph,
    _safe_log,
)

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)

def _declare(lib: ctypes.CDLL) -> None:
    lib.gac_compile_mono_batch.restype = ctypes.c_void_p
    lib.gac_compile_mono_batch.argtypes = (
        [ctypes.c_int32] + [_I32P] * 2 + [_I32P] * 7 + [_I32P] * 3
        + [_F32P, _I32P]
        + [_I32P] * 6 + [_F64P, _I32P]
        + [ctypes.c_int32, _I32P, _I32P, _I32P, _F64P, _F64P, _F64P, _I32P]
        + [ctypes.c_int32, ctypes.c_int32]
        + [ctypes.c_double] * 4
        + [ctypes.c_int32]
    )
    lib.gac_get_dims.restype = None
    lib.gac_get_dims.argtypes = [ctypes.c_void_p, ctypes.c_int32, _I32P, _I32P]
    lib.gac_copy_graph.restype = None
    lib.gac_copy_graph.argtypes = (
        [ctypes.c_void_p, ctypes.c_int32, _I32P, _F32P, _I32P, _F32P, _F32P]
        + [_I32P] * 7
    )
    lib.gac_free.restype = None
    lib.gac_free.argtypes = [ctypes.c_void_p]


def _load() -> ctypes.CDLL:
    """The graph-assembly library, built at first use; raises when the
    build fails."""
    from montreal_forced_aligner_tpu_torch.ops import cuda_build

    return cuda_build.load_library("graph_assembly", _declare)


def _variant_template(comp: AlignmentGraphCompiler, pids, left_ctxs, rights):
    """Fetch/freeze the template ``expand_variant_cached`` would use (same
    cache keys, so native and Python paths share identical templates)."""
    if len(pids) >= 2:
        key = ("v", tuple(pids))
        tpl = comp._tpl_cache.get(key)
        if tpl is None:
            tpl = comp._freeze_template(
                lambda sg: comp._expand_variant(sg, pids, 0, [0], [0])
            )
            comp._tpl_cache[key] = tpl
        return key, tpl, True  # single ALL-lset branch
    key = ("v", tuple(pids), tuple(left_ctxs), tuple(rights))
    tpl = comp._tpl_cache.get(key)
    if tpl is None:
        tpl = comp._freeze_template(
            lambda sg: comp._expand_variant(sg, pids, 0, left_ctxs, rights)
        )
        comp._tpl_cache[key] = tpl
    return key, tpl, False


def _silence_template(comp: AlignmentGraphCompiler, sil: int):
    key = ("s", sil, False)
    tpl = comp._tpl_cache.get(key)
    if tpl is None:
        tpl = comp._freeze_template(
            lambda sg: comp._expand_single(sg, sil, -1, 0, [0])
        )
        comp._tpl_cache[key] = tpl
    return key, tpl


class _TemplateTable:
    """Accumulates frozen templates into the flat arrays the C++ core reads.

    Persistent per compiler; ``flatten`` results are cached until a new
    template is added."""

    def __init__(self):
        self.ids: Dict[tuple, int] = {}
        self.n_states: List[int] = []
        self.n_inst: List[int] = []
        self.state_cols: List[Tuple] = []  # per tpl: 6 state arrays
        self.arc_cols: List[Tuple] = []  # per tpl: src, dst, w, tid
        self.branches: List[List[Tuple[int, Optional[List[int]], list]]] = []
        self._flat = None

    def add(self, key, tpl, all_lset: bool, is_silence: bool = False) -> int:
        tid = self.ids.get(key)
        if tid is not None:
            return tid
        self._flat = None
        tid = len(self.n_states)
        self.ids[key] = tid
        self.n_states.append(tpl["n"])
        self.n_inst.append(tpl["n_inst"])
        self.state_cols.append(
            (
                tpl["pdf"], tpl["tstate"], tpl["hmm"], tpl["phone"],
                tpl["word_rel"], tpl["inst_rel"],
            )
        )
        self.arc_cols.append(
            (tpl["arc_src"], tpl["arc_dst"], tpl["arc_w"], tpl["arc_tid"])
        )
        brs = []
        if is_silence:
            for _rs, entry, exits in tpl["meta"]:
                brs.append((entry, None, list(exits)))
        elif all_lset:
            b = tpl["meta"][0]
            brs.append((b["entry"], None, list(b["exits"])))
        else:
            for b in tpl["meta"]:
                brs.append((b["entry"], sorted(b["lset"]), list(b["exits"])))
        self.branches.append(brs)
        return tid

    def flatten(self):
        if self._flat is not None:
            return self._flat
        nt = len(self.n_states)
        state_off = np.zeros(nt + 1, np.int32)
        arc_off = np.zeros(nt + 1, np.int32)
        branch_off = np.zeros(nt + 1, np.int32)
        for i in range(nt):
            state_off[i + 1] = state_off[i] + self.n_states[i]
            arc_off[i + 1] = arc_off[i] + len(self.arc_cols[i][0])
            branch_off[i + 1] = branch_off[i] + len(self.branches[i])

        def cat(idx, dtype):
            parts = [np.asarray(c[idx], dtype) for c in self.state_cols]
            return (
                np.concatenate(parts).astype(dtype)
                if parts
                else np.zeros(0, dtype)
            )

        def cat_arc(idx, dtype):
            parts = [np.asarray(c[idx], dtype) for c in self.arc_cols]
            return (
                np.concatenate(parts).astype(dtype)
                if parts
                else np.zeros(0, dtype)
            )

        br_entry, br_lset_off, br_lset = [], [0], []
        br_exit_off, br_exit_state, br_exit_w, br_exit_tid = [0], [], [], []
        for brs in self.branches:
            for entry, lset, exits in brs:
                br_entry.append(entry)
                if lset:
                    br_lset.extend(lset)
                br_lset_off.append(len(br_lset))
                for s, w, t in exits:
                    br_exit_state.append(s)
                    br_exit_w.append(w)
                    br_exit_tid.append(t)
                br_exit_off.append(len(br_exit_state))
        self._flat = dict(
            nt=nt,
            n_states=np.asarray(self.n_states, np.int32),
            n_inst=np.asarray(self.n_inst, np.int32),
            state_off=state_off,
            pdf=cat(0, np.int32), tstate=cat(1, np.int32),
            hmm=cat(2, np.int32), phone=cat(3, np.int32),
            word_rel=cat(4, np.int32), inst_rel=cat(5, np.int32),
            arc_off=arc_off,
            arc_src=cat_arc(0, np.int32), arc_dst=cat_arc(1, np.int32),
            arc_w=cat_arc(2, np.float32), arc_tid=cat_arc(3, np.int32),
            branch_off=branch_off,
            br_entry=np.asarray(br_entry, np.int32),
            br_lset_off=np.asarray(br_lset_off, np.int32),
            br_lset=np.asarray(br_lset, np.int32),
            br_exit_off=np.asarray(br_exit_off, np.int32),
            br_exit_state=np.asarray(br_exit_state, np.int32),
            br_exit_w=np.asarray(br_exit_w, np.float64),
            br_exit_tid=np.asarray(br_exit_tid, np.int32),
        )
        return self._flat


def _p(a: np.ndarray, ptr_type):
    return a.ctypes.data_as(ptr_type)


def compile_batch_native(
    comp: AlignmentGraphCompiler,
    token_lists: Sequence[Sequence[str]],
    num_threads: Optional[int] = None,
) -> Optional[List[CompiledGraph]]:
    """Compile a batch of tokenized transcripts through the C++ core.

    Returns None for a context-dependent tree (``tree.N != 1``), which the
    C++ core does not assemble, so the caller takes the Python compiler or
    the worker pool. A failed build of the library raises.
    """
    if comp.tree.N != 1:
        return None
    lib = _load()
    lex = comp.lexicon
    sil = lex.phone_id(lex.silence_phone, None)
    skey, stpl = _silence_template(comp, sil)
    # the native caches snapshot lexicon-derived costs (pronunciation and
    # silence probabilities); invalidate them whenever the lexicon mutates
    # (apply_probabilities_to_lexicon / add_pronunciation / rules bump the
    # version) so a reused compiler never ships stale weights
    lex_version = getattr(lex, "version", 0)
    if getattr(comp, "_native_cache_version", None) != lex_version:
        comp._native_table = None
        comp._native_word_cache = None
        comp._native_tok_cache = None
        comp._native_cache_version = lex_version
    table = getattr(comp, "_native_table", None)
    if table is None:
        table = comp._native_table = _TemplateTable()
    sil_tpl_id = table.add(skey, stpl, all_lset=True, is_silence=True)
    word_cache = getattr(comp, "_native_word_cache", None)
    if word_cache is None:
        word_cache = comp._native_word_cache = {}

    p_init = lex.initial_silence_probability
    fsc = lex.final_silence_correction
    fnsc = lex.final_non_silence_correction

    utt_word_off = [0]
    word_var_off = [0]
    var_tpl: List[int] = []
    var_cost: List[float] = []
    var_log_psil: List[float] = []
    var_log_1m_psil: List[float] = []
    var_last: List[int] = []
    utt_words: List[List[str]] = []
    fallback: Dict[int, CompiledGraph] = {}
    native_rows: List[int] = []

    # per-token lookup cache (tokens repeat heavily across a corpus):
    # token -> (out_word, [(pron_cost, log_psil, log_1m_psil, pids)], starts)
    tok_cache = getattr(comp, "_native_tok_cache", None)
    if tok_cache is None:
        tok_cache = comp._native_tok_cache = {}

    def _token_data(tok: str):
        data = tok_cache.get(tok)
        if data is not None:
            return data
        out_word, prons = lex.lookup(tok)
        variants = []
        for pron in prons:
            if lex.position_dependent:
                pids = lex.pronunciation_phone_ids(pron.phones)
            else:
                pids = [lex.phone_id(p, None) for p in pron.phones]
            prob = pron.probability if pron.probability is not None else 1.0
            p_sil = (
                pron.silence_after_probability
                if pron.silence_after_probability is not None
                else lex.silence_probability
            )
            variants.append(
                (
                    -_safe_log(max(min(prob, 1.0), 1e-5)),
                    _safe_log(p_sil),
                    _safe_log(1.0 - p_sil),
                    tuple(pids),
                )
            )
        starts = sorted({v[3][0] for v in variants})
        data = (out_word, variants, starts)
        tok_cache[tok] = data
        return data

    for ui, tokens in enumerate(token_lists):
        per_tok = [_token_data(tok) for tok in tokens]
        words = [d[0] for d in per_tok]
        starts = [d[2] for d in per_tok]
        # a pronunciation starting with the silence phone engages the
        # compiler's allowed-next filters, and a token with zero
        # pronunciation variants changes how the next word's left contexts
        # are derived; replay both exactly via Python
        if any(sil in s for s in starts) or any(
            not d[1] for d in per_tok
        ):
            fallback[ui] = comp.compile(list(tokens))
            continue
        native_rows.append(ui)
        utt_words.append(words)
        W = len(per_tok)
        left_ctxs = tuple(sorted({0, sil}))
        for w_idx, (_ow, variants, _st) in enumerate(per_tok):
            is_last = w_idx == W - 1
            next_starts = (0,) if is_last else tuple(starts[w_idx + 1])
            rights = tuple(sorted({sil, *next_starts}))
            ck = (tokens[w_idx], left_ctxs, rights)
            rows = word_cache.get(ck)
            if rows is None:
                rows = []
                for cost, lp, l1p, pids in variants:
                    key, tpl, all_lset = _variant_template(
                        comp, list(pids), list(left_ctxs), list(rights)
                    )
                    rows.append(
                        (table.add(key, tpl, all_lset), cost, lp, l1p, pids[-1])
                    )
                word_cache[ck] = rows
            for tid, cost, lp, l1p, last in rows:
                var_tpl.append(tid)
                var_cost.append(cost)
                var_log_psil.append(lp)
                var_log_1m_psil.append(l1p)
                var_last.append(last)
            word_var_off.append(len(var_tpl))
            left_ctxs = tuple(
                sorted({v[3][-1] for v in variants} | {sil})
            )
        utt_word_off.append(len(word_var_off) - 1)

    n_utts = len(native_rows)
    results: List[Optional[CompiledGraph]] = [None] * len(token_lists)
    for ui, gr in fallback.items():
        results[ui] = gr
    if n_utts:
        t = table.flatten()
        if num_threads is None:
            # the C++ stage is ~20 us/utt; threads only pay off on large
            # batches where splice+finish work amortizes spawn cost
            num_threads = 1 if n_utts < 512 else min(8, os.cpu_count() or 1)
        arrs = dict(
            utt_word_off=np.asarray(utt_word_off, np.int32),
            word_var_off=np.asarray(word_var_off, np.int32),
            var_tpl=np.asarray(var_tpl, np.int32),
            var_cost=np.asarray(var_cost, np.float64),
            var_log_psil=np.asarray(var_log_psil, np.float64),
            var_log_1m_psil=np.asarray(var_log_1m_psil, np.float64),
            var_last=np.asarray(var_last, np.int32),
        )
        handle = lib.gac_compile_mono_batch(
            t["nt"],
            _p(t["n_states"], _I32P), _p(t["n_inst"], _I32P),
            _p(t["state_off"], _I32P), _p(t["pdf"], _I32P),
            _p(t["tstate"], _I32P), _p(t["hmm"], _I32P),
            _p(t["phone"], _I32P), _p(t["word_rel"], _I32P),
            _p(t["inst_rel"], _I32P), _p(t["arc_off"], _I32P),
            _p(t["arc_src"], _I32P), _p(t["arc_dst"], _I32P),
            _p(t["arc_w"], _F32P), _p(t["arc_tid"], _I32P),
            _p(t["branch_off"], _I32P), _p(t["br_entry"], _I32P),
            _p(t["br_lset_off"], _I32P), _p(t["br_lset"], _I32P),
            _p(t["br_exit_off"], _I32P), _p(t["br_exit_state"], _I32P),
            _p(t["br_exit_w"], _F64P), _p(t["br_exit_tid"], _I32P),
            n_utts,
            _p(arrs["utt_word_off"], _I32P), _p(arrs["word_var_off"], _I32P),
            _p(arrs["var_tpl"], _I32P), _p(arrs["var_cost"], _F64P),
            _p(arrs["var_log_psil"], _F64P),
            _p(arrs["var_log_1m_psil"], _F64P),
            _p(arrs["var_last"], _I32P),
            sil_tpl_id, sil,
            _safe_log(p_init), _safe_log(1.0 - p_init),
            _safe_log(fsc) if fsc else 0.0,
            _safe_log(fnsc) if fnsc else 0.0,
            num_threads,
        )
        try:
            S = ctypes.c_int32()
            K = ctypes.c_int32()
            for j, ui in enumerate(native_rows):
                lib.gac_get_dims(handle, j, ctypes.byref(S), ctypes.byref(K))
                s, k = S.value, K.value
                in_src = np.empty((s, k), np.int32)
                in_weight = np.empty((s, k), np.float32)
                in_tid = np.empty((s, k), np.int32)
                start = np.empty(s, np.float32)
                final = np.empty(s, np.float32)
                final_tid = np.empty(s, np.int32)
                pdf = np.empty(s, np.int32)
                phone = np.empty(s, np.int32)
                word = np.empty(s, np.int32)
                hmm = np.empty(s, np.int32)
                tstate = np.empty(s, np.int32)
                inst = np.empty(s, np.int32)
                lib.gac_copy_graph(
                    handle, j,
                    _p(in_src, _I32P), _p(in_weight, _F32P), _p(in_tid, _I32P),
                    _p(start, _F32P), _p(final, _F32P), _p(final_tid, _I32P),
                    _p(pdf, _I32P), _p(phone, _I32P), _p(word, _I32P),
                    _p(hmm, _I32P), _p(tstate, _I32P), _p(inst, _I32P),
                )
                results[ui] = CompiledGraph(
                    state_pdf=pdf,
                    state_phone=phone,
                    state_word=word,
                    state_hmm_pos=hmm,
                    state_tstate=tstate,
                    state_instance=inst,
                    in_src=in_src,
                    in_weight=in_weight,
                    in_tid=in_tid,
                    start=start,
                    final=final,
                    final_tid=final_tid,
                    words=utt_words[j],
                )
        finally:
            lib.gac_free(handle)
    return results  # type: ignore[return-value]


def compile_items_native(
    compilers: Dict[str, AlignmentGraphCompiler],
    items: Sequence[Tuple[str, Sequence[str]]],
    num_threads: Optional[int] = None,
) -> Optional[List[CompiledGraph]]:
    """Batch-compile ``[(dictionary_key, tokens)]`` via the native core,
    grouping by dictionary. None when any dictionary's tree is context
    dependent."""
    keys = {k for k, _t in items}
    if any(compilers[k].tree.N != 1 for k in keys):
        return None
    out: List[Optional[CompiledGraph]] = [None] * len(items)
    for key in keys:
        rows = [i for i, (k, _t) in enumerate(items) if k == key]
        graphs = compile_batch_native(
            compilers[key], [items[i][1] for i in rows], num_threads
        )
        if graphs is None:
            return None
        for i, gr in zip(rows, graphs):
            out[i] = gr
    return out  # type: ignore[return-value]
