"""Utterance alignment-graph compiler.

Replaces the reference's per-utterance FST composition (``compile-train-graphs``
composing text with L, C and H; call sites ``alignment/multiprocessing.py:537-571``
and ``online/alignment.py:77-96``) with a direct host-side construction of the
emission-state lattice: the transcript is expanded into pronunciation variants
with optional-silence branches (semantics of the lexicon FST built in reference
``dictionary/multispeaker.py:3105-3225``), each phone into its HMM states
(topology + tree + transition model), and the result is flattened into dense
int/float arrays consumed by the batched Viterbi kernel on TPU.

Transition weights follow Kaldi's graph-scaling convention (so boundaries
match the reference's ``gmm-align-compiled`` with the same scales,
``alignment/mixins.py:68-95``):

  self-loop arc:      self_loop_scale * log(p_self)
  other arcs:         transition_scale * log(p / (1 - p_self))
                      + self_loop_scale * log(1 - p_self)

with probabilities taken from the trained transition model.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch import tracing
from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon, Pronunciation
from montreal_forced_aligner_tpu_torch.models.transition_model import KNOPDF, TransitionModel
from montreal_forced_aligner_tpu_torch.models.tree import ContextDependency

NEG_INF = -1.0e30


def _safe_log(p: float) -> float:
    return math.log(p) if p > 0 else NEG_INF


@dataclass
class CompiledGraph:
    """Host (numpy) representation of one utterance's alignment graph."""

    state_pdf: np.ndarray  # (S,)
    state_phone: np.ndarray  # (S,) phone id
    state_word: np.ndarray  # (S,) transcript word index, -1 for silence
    state_hmm_pos: np.ndarray  # (S,) hmm-state index within the phone
    state_tstate: np.ndarray  # (S,) transition-state (1-based)
    state_instance: np.ndarray  # (S,) phone-instance index within the utterance
    # arcs in "incoming list" form
    in_src: np.ndarray  # (S, K)
    in_weight: np.ndarray  # (S, K) NEG_INF padded
    in_tid: np.ndarray  # (S, K) transition-id of each incoming arc (0 = none)
    start: np.ndarray  # (S,)
    final: np.ndarray  # (S,)
    final_tid: np.ndarray  # (S,) exit transition-id used when ending here (0 = none)
    words: List[str] = field(default_factory=list)  # transcript words
    # (S, K) word index emitted by each incoming arc, -1 = none. Decoding
    # graphs mark word-entry arcs explicitly so that a consecutive repeat of
    # the same word with no intervening silence (which re-enters the same
    # instance and is invisible to instance-crossing inference) still
    # produces a word event. None for alignment graphs.
    in_event: Optional[np.ndarray] = None

    @property
    def num_states(self) -> int:
        return len(self.state_pdf)

    @property
    def max_in_arcs(self) -> int:
        return self.in_src.shape[1]


class _GraphBuilder:
    """Accumulates states and arcs during expansion (numpy-block based: a
    whole phone instance's states and internal arcs are appended as arrays;
    only junction arcs are scalar)."""

    def __init__(self):
        self.num_states = 0
        self.num_instances = 0
        # per-instance blocks
        self._pdf_blocks: List[np.ndarray] = []
        self._phone_vals: List[Tuple[int, int, int, int]] = []  # phone, word, inst, n
        self._tstate_blocks: List[np.ndarray] = []
        self._hmm_blocks: List[np.ndarray] = []
        # template blocks: (base, phone_col, word_col, inst_col) overriding
        # the scalar phone/word/instance columns for their state range
        self._col_blocks: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
        # arc blocks (absolute state indices)
        self._arc_src: List[np.ndarray] = []
        self._arc_dst: List[np.ndarray] = []
        self._arc_w: List[np.ndarray] = []
        self._arc_tid: List[np.ndarray] = []
        # scalar junction arcs
        self._jsrc: List[int] = []
        self._jdst: List[int] = []
        self._jw: List[float] = []
        self._jtid: List[int] = []
        self._jevent: List[int] = []  # word emitted by the arc, -1 = none
        self.start: Dict[int, float] = {}
        self.final: Dict[int, float] = {}
        self.final_tid: Dict[int, int] = {}

    def add_instance_block(
        self, plan: dict, phone: int, word: int
    ) -> int:
        """Add all states + internal arcs of one phone instance; returns the
        base state index."""
        base = self.num_states
        n = plan["n_emit"]
        inst = self.num_instances
        self.num_instances += 1
        self._pdf_blocks.append(plan["np_pdfs"])
        self._tstate_blocks.append(plan["np_tstates"])
        self._hmm_blocks.append(plan["np_hmm_pos"])
        self._phone_vals.append((phone, word, inst, n))
        if len(plan["np_arc_src"]):
            self._arc_src.append(plan["np_arc_src"] + base)
            self._arc_dst.append(plan["np_arc_dst"] + base)
            self._arc_w.append(plan["np_arc_w"])
            self._arc_tid.append(plan["np_arc_tid"])
        self.num_states += n
        return base

    def add_template(self, tpl: dict, word: int) -> int:
        """Splice a frozen expansion template (relative state/arc arrays from
        :meth:`AlignmentGraphCompiler._freeze_template`) in one block append;
        returns the base state index. State and instance ordering is exactly
        what replaying the expansion would produce, so downstream
        tie-breaking (and hence boundaries) is unchanged."""
        base = self.num_states
        n = tpl["n"]
        self._pdf_blocks.append(tpl["pdf"])
        self._tstate_blocks.append(tpl["tstate"])
        self._hmm_blocks.append(tpl["hmm"])
        # per-state phone/word/instance columns for this block
        wc = tpl["word_cols"]
        word_col = wc.get(word)
        if word_col is None:
            word_col = np.where(tpl["word_rel"] < 0, -1, word).astype(np.int32)
            wc[word] = word_col
        self._col_blocks.append(
            (base, tpl["phone"], word_col, tpl["inst_rel"] + self.num_instances)
        )
        self.num_instances += tpl["n_inst"]
        if len(tpl["arc_src"]):
            self._arc_src.append(tpl["arc_src"] + base)
            self._arc_dst.append(tpl["arc_dst"] + base)
            self._arc_w.append(tpl["arc_w"])
            self._arc_tid.append(tpl["arc_tid"])
        # keep _phone_vals aligned with the pdf blocks via an array marker
        self._phone_vals.append((None, None, None, n))
        self.num_states += n
        return base

    @property
    def state_pdf(self):  # length check compatibility
        class _Len:
            def __init__(self, n):
                self.n = n

            def __len__(self):
                return self.n

        return _Len(self.num_states)

    def add_arc(
        self, src: int, dst: int, weight: float, tid: int = 0, event: int = -1
    ) -> None:
        self._jsrc.append(src)
        self._jdst.append(dst)
        self._jw.append(weight)
        self._jtid.append(tid)
        self._jevent.append(event)

    def add_start(self, state: int, weight: float) -> None:
        prev = self.start.get(state, NEG_INF)
        self.start[state] = max(prev, weight) if prev > NEG_INF else weight

    def add_final(self, state: int, weight: float, tid: int = 0) -> None:
        prev = self.final.get(state, NEG_INF)
        if prev > NEG_INF and prev >= weight:
            return
        self.final[state] = weight
        self.final_tid[state] = tid

    def finish(self, words: List[str]) -> CompiledGraph:
        S = self.num_states
        state_pdf = (
            np.concatenate(self._pdf_blocks)
            if self._pdf_blocks
            else np.zeros(0, np.int32)
        )
        state_tstate = (
            np.concatenate(self._tstate_blocks)
            if self._tstate_blocks
            else np.zeros(0, np.int32)
        )
        state_hmm = (
            np.concatenate(self._hmm_blocks)
            if self._hmm_blocks
            else np.zeros(0, np.int32)
        )
        counts = np.asarray([v[3] for v in self._phone_vals], np.int32)
        state_phone = np.repeat(
            np.asarray(
                [0 if v[0] is None else v[0] for v in self._phone_vals],
                np.int32,
            ),
            counts,
        )
        state_word = np.repeat(
            np.asarray(
                [0 if v[1] is None else v[1] for v in self._phone_vals],
                np.int32,
            ),
            counts,
        )
        state_instance = np.repeat(
            np.asarray(
                [0 if v[2] is None else v[2] for v in self._phone_vals],
                np.int32,
            ),
            counts,
        )
        for cb_base, cb_phone, cb_word, cb_inst in self._col_blocks:
            end = cb_base + len(cb_phone)
            state_phone[cb_base:end] = cb_phone
            state_word[cb_base:end] = cb_word
            state_instance[cb_base:end] = cb_inst

        src_a = np.concatenate(
            self._arc_src + [np.asarray(self._jsrc, np.int32)]
        ).astype(np.int32)
        dst_a = np.concatenate(
            self._arc_dst + [np.asarray(self._jdst, np.int32)]
        ).astype(np.int32)
        w_a = np.concatenate(
            self._arc_w + [np.asarray(self._jw, np.float32)]
        ).astype(np.float32)
        tid_a = np.concatenate(
            self._arc_tid + [np.asarray(self._jtid, np.int32)]
        ).astype(np.int32)
        n_block = sum(len(a) for a in self._arc_src)
        ev_a = np.concatenate(
            [
                np.full(n_block, -1, np.int32),
                np.asarray(self._jevent, np.int32),
            ]
        )
        has_events = bool((ev_a >= 0).any())

        if len(dst_a):
            order = np.argsort(dst_a, kind="stable")
            dst_s = dst_a[order]
            counts_in = np.bincount(dst_s, minlength=S)
            K = max(1, int(counts_in.max()))
            starts = np.concatenate([[0], np.cumsum(counts_in[:-1])])
            rank = np.arange(len(dst_s)) - starts[dst_s]
            in_src = np.zeros((S, K), dtype=np.int32)
            in_weight = np.full((S, K), NEG_INF, dtype=np.float32)
            in_tid = np.zeros((S, K), dtype=np.int32)
            in_event = np.full((S, K), -1, dtype=np.int32)
            in_src[dst_s, rank] = src_a[order]
            in_weight[dst_s, rank] = w_a[order]
            in_tid[dst_s, rank] = tid_a[order]
            in_event[dst_s, rank] = ev_a[order]
        else:
            K = 1
            in_src = np.zeros((S, K), dtype=np.int32)
            in_weight = np.full((S, K), NEG_INF, dtype=np.float32)
            in_tid = np.zeros((S, K), dtype=np.int32)
            in_event = np.full((S, K), -1, dtype=np.int32)

        start = np.full(S, NEG_INF, dtype=np.float32)
        for st, w in self.start.items():
            start[st] = w
        final = np.full(S, NEG_INF, dtype=np.float32)
        final_tid = np.zeros(S, dtype=np.int32)
        for st, w in self.final.items():
            final[st] = w
            final_tid[st] = self.final_tid.get(st, 0)
        return CompiledGraph(
            state_pdf=state_pdf,
            state_phone=state_phone,
            state_word=state_word,
            state_hmm_pos=state_hmm,
            state_tstate=state_tstate,
            state_instance=state_instance,
            in_src=in_src,
            in_weight=in_weight,
            in_tid=in_tid,
            start=start,
            final=final,
            final_tid=final_tid,
            words=words,
            in_event=in_event if has_events else None,
        )


class AlignmentGraphCompiler:
    """Compiles token sequences into :class:`CompiledGraph`s.

    Handles monophone (N=1) and triphone (N=3) trees. For context-dependent
    trees, cross-word context is resolved during expansion: word-initial and
    word-final phones (and optional-silence instances) are duplicated per
    distinct left/right context whose tree lookups actually differ, so every
    path through the graph carries exactly the pdfs the reference's
    C-transducer composition would produce (``compile-train-graphs``,
    ``alignment/multiprocessing.py:537-571``). Context groups with identical
    pdf tuples share one instance (collapses e.g. context-independent
    silence back to a single copy).
    """

    def __init__(
        self,
        transition_model: TransitionModel,
        tree: ContextDependency,
        lexicon: Lexicon,
        transition_scale: float = 1.0,
        self_loop_scale: float = 0.1,
    ):
        self.tm = transition_model
        self.tree = tree
        self.lexicon = lexicon
        self.transition_scale = transition_scale
        self.self_loop_scale = self_loop_scale
        if tree.N not in (1, 3):
            raise NotImplementedError(f"context width {tree.N} not supported")
        self._phone_cache: Dict[Tuple[int, ...], dict] = {}
        self._tpl_cache: Dict[tuple, dict] = {}  # frozen expansion templates

    def _window(self, left: int, center: int, right: int) -> Tuple[int, ...]:
        if self.tree.N == 1:
            return (center,)
        return (left, center, right)

    # -- phone expansion -----------------------------------------------------
    def _phone_plan(self, window: Tuple[int, ...]) -> dict:
        """Per-(phone-in-context) HMM structure: pdfs, tstates, internal arc
        weights, and exit weights."""
        cached = self._phone_cache.get(window)
        if cached is not None:
            return cached
        tm, tree = self.tm, self.tree
        phone = window[tree.P]
        entry = tm.topo.entry_for_phone(phone)
        n_emit = sum(1 for s in entry if s.forward_pdf_class != KNOPDF)
        final_idx = next(
            (j for j, s in enumerate(entry) if s.forward_pdf_class == KNOPDF), None
        )
        pdfs = []
        tstates = []
        for j in range(n_emit):
            fwd_pdf = tree.compute_pdf(list(window), entry[j].forward_pdf_class)
            slf_pdf = tree.compute_pdf(list(window), entry[j].self_loop_pdf_class)
            pdfs.append(fwd_pdf)
            tstates.append(tm.tuple_to_transition_state(phone, j, fwd_pdf, slf_pdf))
        internal: List[Tuple[int, int, float, int]] = []  # (src, dst, weight, tid)
        exits: List[Tuple[int, float, int]] = []  # (src_hmm, exit_weight, tid)
        ts, sls = self.transition_scale, self.self_loop_scale
        for j in range(n_emit):
            trans = tm.transitions_of_state(tstates[j])
            p_self = 0.0
            for _tid, dst, logp in trans:
                if dst == j:
                    p_self = math.exp(logp)
            log_1m = _safe_log(1.0 - p_self) if p_self < 1.0 else NEG_INF
            for tid, dst, logp in trans:
                if dst == j:
                    internal.append((j, j, sls * logp, tid))
                else:
                    w = ts * (logp - log_1m) + sls * log_1m if p_self > 0 else ts * logp
                    if dst == final_idx:
                        exits.append((j, w, tid))
                    else:
                        internal.append((j, dst, w, tid))
        plan = dict(
            n_emit=n_emit,
            pdfs=pdfs,
            tstates=tstates,
            internal=internal,
            exits=exits,
            key=tuple(zip(pdfs, tstates)),
            # numpy blocks for bulk instantiation
            np_pdfs=np.asarray(pdfs, dtype=np.int32),
            np_tstates=np.asarray(tstates, dtype=np.int32),
            np_hmm_pos=np.arange(n_emit, dtype=np.int32),
            np_arc_src=np.asarray([a[0] for a in internal], dtype=np.int32),
            np_arc_dst=np.asarray([a[1] for a in internal], dtype=np.int32),
            np_arc_w=np.asarray([a[2] for a in internal], dtype=np.float32),
            np_arc_tid=np.asarray([a[3] for a in internal], dtype=np.int32),
        )
        self._phone_cache[window] = plan
        return plan

    def _expand_plan(
        self, g: _GraphBuilder, plan: dict, phone: int, word_idx: int
    ) -> Tuple[int, List[Tuple[int, float, int]]]:
        """Materialize one phone instance from a plan; returns
        (entry_state, [(exit_state, weight, tid)])."""
        base = g.add_instance_block(plan, phone, word_idx)
        exits = [(base + src, w, tid) for src, w, tid in plan["exits"]]
        return base, exits

    def _expand_phone_standalone(self, g: _GraphBuilder, phone: int, word_idx: int = -1):
        """Expand one phone with empty context (monophone decode graphs)."""
        plan = self._phone_plan(self._window(0, phone, 0))
        return self._expand_plan(g, plan, phone, word_idx)

    def _expand_pronunciation(
        self, g: _GraphBuilder, pids: Sequence[int], word_idx: int,
        boundary_ctx: int = 0,
    ):
        """Simple within-variant chain with interior context only (used by
        the LVCSR decoding-graph builder; monophone-exact). ``boundary_ctx``
        is the assumed cross-word context phone for the first/last phone
        (silence is the usual choice — its leaves are well trained and
        word boundaries border silence more often than any other phone)."""
        entry = None
        prev_exits = []
        n = len(pids)
        for k, phone in enumerate(pids):
            l = pids[k - 1] if k > 0 else boundary_ctx
            r = pids[k + 1] if k < n - 1 else boundary_ctx
            plan = self._phone_plan(self._window(l, phone, r))
            p_entry, p_exits = self._expand_plan(g, plan, phone, word_idx)
            if entry is None:
                entry = p_entry
            for s, w, tid in prev_exits:
                g.add_arc(s, p_entry, w, tid)
            prev_exits = p_exits
        return entry, prev_exits

    def _group_rights(
        self, left: int, phone: int, rights: Sequence[int]
    ) -> List[Tuple[frozenset, dict]]:
        """Group right contexts whose plans are identical (fixed left)."""
        groups: Dict[tuple, List[int]] = {}
        plans: Dict[tuple, dict] = {}
        for r in rights:
            plan = self._phone_plan(self._window(left, phone, r))
            groups.setdefault(plan["key"], []).append(r)
            plans[plan["key"]] = plan
        return [(frozenset(rs), plans[k]) for k, rs in groups.items()]

    def _expand_single(
        self, g: _GraphBuilder, phone: int, word_idx: int, left: int,
        rights: Sequence[int],
    ) -> List[Tuple[frozenset, int, List[Tuple[int, float, int]]]]:
        """One phone with fixed left context, instances per right-context
        group: [(right_set, entry, exits)]."""
        out = []
        for rs, plan in self._group_rights(left, phone, rights):
            entry, exits = self._expand_plan(g, plan, phone, word_idx)
            out.append((rs, entry, exits))
        return out

    def _expand_variant(
        self,
        g: _GraphBuilder,
        pids: Sequence[int],
        word_idx: int,
        left_ctxs: Sequence[int],
        rights: Sequence[int],
        group_lefts: bool = False,
    ) -> List[dict]:
        """Expand a pronunciation variant for every needed cross-word
        context. Returns branches: dicts with keys
        ``lset`` (left contexts served), ``entry``, ``rset`` (right contexts
        served), ``exits``.

        ``group_lefts`` merges single-phone instances whose plans agree for
        every right context (fewer states; used by the LVCSR cross-word
        builder). Alignment/training graphs keep per-left instances so the
        state ordering — and hence EM tie-breaking — is unchanged.
        """
        n = len(pids)
        branches: List[dict] = []
        if n == 1:
            lgroups1: Dict[tuple, List[int]] = {}
            for l in left_ctxs:
                key = (
                    tuple(
                        self._phone_plan(self._window(l, pids[0], r))["key"]
                        for r in rights
                    )
                    if group_lefts
                    else l
                )
                lgroups1.setdefault(key, []).append(l)
            for ls in lgroups1.values():
                for rs, entry, exits in self._expand_single(
                    g, pids[0], word_idx, ls[0], rights
                ):
                    branches.append(
                        dict(lset=frozenset(ls), entry=entry, rset=rs, exits=exits)
                    )
            return branches
        # group left contexts by the initial phone's plan
        lgroups: Dict[tuple, List[int]] = {}
        lplans: Dict[tuple, dict] = {}
        for l in left_ctxs:
            plan = self._phone_plan(self._window(l, pids[0], pids[1]))
            lgroups.setdefault(plan["key"], []).append(l)
            lplans[plan["key"]] = plan
        entries = []  # (lset, entry_state, initial_exits)
        for k, ls in lgroups.items():
            entry, exits = self._expand_plan(g, lplans[k], pids[0], word_idx)
            entries.append((frozenset(ls), entry, exits))
        # shared interior chain
        prev_exits_groups = [e[2] for e in entries]

        def connect_all(exit_lists, entry_state):
            for exits in exit_lists:
                for s, w, tid in exits:
                    g.add_arc(s, entry_state, w, tid)

        cur_exit_lists = prev_exits_groups
        for k in range(1, n - 1):
            window = self._window(pids[k - 1], pids[k], pids[k + 1])
            plan = self._phone_plan(window)
            entry, exits = self._expand_plan(g, plan, pids[k], word_idx)
            connect_all(cur_exit_lists, entry)
            cur_exit_lists = [exits]
        # final phone: instances per right-context group
        finals = []
        for rs, plan in self._group_rights(pids[n - 2], pids[n - 1], rights):
            entry, exits = self._expand_plan(g, plan, pids[n - 1], word_idx)
            connect_all(cur_exit_lists, entry)
            finals.append((rs, exits))
        for lset, entry, _ex in entries:
            for rs, exits in finals:
                branches.append(dict(lset=lset, entry=entry, rset=rs, exits=exits))
        return branches

    # -- expansion templates ---------------------------------------------
    # compile() is host-side and linear in corpus size; word pronunciations
    # (and their cross-word context signatures) recur constantly, so each
    # distinct expansion is performed once into a scratch builder, frozen to
    # relocatable arrays, and thereafter spliced in with one block append.
    # The replayed state/instance ordering is identical to direct expansion,
    # so argmax tie-breaking — and hence every boundary — is unchanged.

    def _freeze_template(self, build_fn):
        """Run ``build_fn(scratch_builder) -> meta`` and freeze the scratch
        into a relocatable template dict (state/arc arrays relative to 0)."""
        sg = _GraphBuilder()
        meta = build_fn(sg)
        assert not sg.start and not sg.final and not sg._col_blocks
        pdf = (
            np.concatenate(sg._pdf_blocks)
            if sg._pdf_blocks
            else np.zeros(0, np.int32)
        )
        tstate = (
            np.concatenate(sg._tstate_blocks)
            if sg._tstate_blocks
            else np.zeros(0, np.int32)
        )
        hmm = (
            np.concatenate(sg._hmm_blocks)
            if sg._hmm_blocks
            else np.zeros(0, np.int32)
        )
        counts = np.asarray([v[3] for v in sg._phone_vals], np.int32)
        phone = np.repeat(
            np.asarray([v[0] for v in sg._phone_vals], np.int32), counts
        )
        word_rel = np.repeat(
            np.asarray([v[1] for v in sg._phone_vals], np.int32), counts
        )
        inst_rel = np.repeat(
            np.asarray([v[2] for v in sg._phone_vals], np.int32), counts
        )
        arc_src = np.concatenate(
            sg._arc_src + [np.asarray(sg._jsrc, np.int32)]
        ).astype(np.int32)
        arc_dst = np.concatenate(
            sg._arc_dst + [np.asarray(sg._jdst, np.int32)]
        ).astype(np.int32)
        arc_w = np.concatenate(
            sg._arc_w + [np.asarray(sg._jw, np.float32)]
        ).astype(np.float32)
        arc_tid = np.concatenate(
            sg._arc_tid + [np.asarray(sg._jtid, np.int32)]
        ).astype(np.int32)
        return dict(
            n=sg.num_states,
            n_inst=sg.num_instances,
            pdf=pdf,
            tstate=tstate,
            hmm=hmm,
            phone=phone,
            word_rel=word_rel,
            inst_rel=inst_rel,
            arc_src=arc_src,
            arc_dst=arc_dst,
            arc_w=arc_w,
            arc_tid=arc_tid,
            word_cols={},
            meta=meta,
        )

    def _template(self, key: tuple, build_fn) -> dict:
        """The template cached under ``key``, frozen from ``build_fn`` on a
        miss (counted: ``graph_template_lookups``, ``graph_template_builds``)."""
        tracing.count("graph_template_lookups")
        tpl = self._tpl_cache.get(key)
        if tpl is None:
            tracing.count("graph_template_builds")
            with tracing.span("graph_template_build"):
                tpl = self._tpl_cache[key] = self._freeze_template(build_fn)
        return tpl

    def expand_variant_cached(
        self, g: _GraphBuilder, pids, word_idx, left_ctxs, rights
    ) -> List[dict]:
        """Template-cached :meth:`_expand_variant` (same branches, spliced
        from a frozen template)."""
        if self.tree.N == 1 and len(pids) >= 2:
            # monophone, multi-phone pronunciation: plans ignore context and
            # the expansion emits exactly one branch, so one template per
            # pronunciation serves every (left, right) combination — the
            # context-keyed cache would miss on every novel word pairing.
            # (Single-phone variants keep the per-left instances that the
            # direct expansion creates, preserving tie-breaking order.)
            tpl = self._template(
                ("v", tuple(pids)),
                lambda sg: self._expand_variant(sg, pids, 0, [0], [0]),
            )
            assert len(tpl["meta"]) == 1
            base = g.add_template(tpl, word_idx)
            b = tpl["meta"][0]
            return [
                dict(
                    lset=set(left_ctxs),
                    entry=b["entry"] + base,
                    rset=frozenset(rights),
                    exits=[(s + base, w, t) for s, w, t in b["exits"]],
                )
            ]
        tpl = self._template(
            ("v", tuple(pids), tuple(left_ctxs), tuple(rights)),
            lambda sg: self._expand_variant(sg, pids, 0, left_ctxs, rights),
        )
        base = g.add_template(tpl, word_idx)
        return [
            dict(
                lset=b["lset"],
                entry=b["entry"] + base,
                rset=b["rset"],
                exits=[(s + base, w, t) for s, w, t in b["exits"]],
            )
            for b in tpl["meta"]
        ]

    def expand_single_cached(
        self, g: _GraphBuilder, phone, word_idx, left, rights
    ):
        """Template-cached :meth:`_expand_single`."""
        # the frozen word_rel column encodes only the SIGN of word_idx
        # (word vs silence), so the key must separate the two
        if self.tree.N == 1:
            # monophone: context-independent template (see
            # expand_variant_cached)
            tpl = self._template(
                ("s", phone, word_idx >= 0),
                lambda sg: self._expand_single(
                    sg, phone, 0 if word_idx >= 0 else -1, 0, [0]
                ),
            )
            assert len(tpl["meta"]) == 1
            base = g.add_template(tpl, word_idx)
            _rs, entry, exits = tpl["meta"][0]
            return [
                (
                    frozenset(rights),
                    entry + base,
                    [(s + base, w, t) for s, w, t in exits],
                )
            ]
        tpl = self._template(
            ("s", phone, left, tuple(rights), word_idx >= 0),
            lambda sg: self._expand_single(
                sg, phone, 0 if word_idx >= 0 else -1, left, rights
            ),
        )
        base = g.add_template(tpl, word_idx)
        return [
            (rs, entry + base, [(s + base, w, t) for s, w, t in exits])
            for rs, entry, exits in tpl["meta"]
        ]

    # -- utterance compilation ----------------------------------------------
    def compile(self, tokens: Sequence[str]) -> CompiledGraph:
        """Build the alignment graph for a tokenized transcript.

        Structure (reference lexicon-FST semantics): optional silence before
        the first word, between words and at the end; per-word pronunciation
        alternatives weighted by -log(probability); silence branch costs from
        silence probabilities (defaults 0.5, ``dictionary/mixins.py:91-194``).
        """
        lex = self.lexicon
        g = _GraphBuilder()
        sil = lex.phone_id(lex.silence_phone, None)
        EPS = 0

        words: List[str] = []
        prons_per_word: List[List[Tuple[Pronunciation, List[int]]]] = []
        for tok in tokens:
            out_word, prons = lex.lookup(tok)
            words.append(out_word)
            expanded = []
            for pron in prons:
                if lex.position_dependent:
                    pids = lex.pronunciation_phone_ids(pron.phones)
                else:
                    pids = [lex.phone_id(p, None) for p in pron.phones]
                expanded.append((pron, pids))
            prons_per_word.append(expanded)

        W = len(prons_per_word)
        starts = [
            sorted({pids[0] for _pron, pids in expanded})
            for expanded in prons_per_word
        ]

        p_init = lex.initial_silence_probability
        fsc = lex.final_silence_correction
        fnsc = lex.final_non_silence_correction
        sil_corr = _safe_log(fsc) if fsc else 0.0
        nonsil_corr = _safe_log(fnsc) if fnsc else 0.0

        # frontier entries: (src_state or None, weight, tid, left_ctx,
        #                    allowed_next_first_phones or None)
        frontier: List[Tuple[Optional[int], float, int, int, Optional[frozenset]]] = []

        if W == 0:
            # empty transcript: just one silence
            for rs, entry, exits in self.expand_single_cached(g, sil, -1, EPS, [EPS]):
                g.add_start(entry, 0.0)
                for s, w, tid in exits:
                    g.add_final(s, w, tid)
            return g.finish(words)

        frontier.append((None, _safe_log(1.0 - p_init), 0, EPS, None))
        for rs, entry, exits in self.expand_single_cached(g, sil, -1, EPS, starts[0]):
            g.add_start(entry, _safe_log(p_init))
            for s, w, tid in exits:
                frontier.append((s, w, tid, sil, rs))

        for w_idx, expanded in enumerate(prons_per_word):
            is_last = w_idx == W - 1
            next_starts = [EPS] if is_last else starts[w_idx + 1]
            rights = sorted(set([sil] + next_starts))
            left_ctxs = sorted({f[3] for f in frontier})
            new_frontier: List[
                Tuple[Optional[int], float, int, int, Optional[frozenset]]
            ] = []
            # collected inputs to the optional silence after this word,
            # keyed by the emitting variant's final phone (silence left ctx)
            sil_inputs: Dict[int, List[Tuple[int, float, int]]] = {}

            for pron, pids in expanded:
                prob = pron.probability if pron.probability is not None else 1.0
                pron_cost = -_safe_log(max(min(prob, 1.0), 1e-5))
                p_sil = (
                    pron.silence_after_probability
                    if pron.silence_after_probability is not None
                    else lex.silence_probability
                )
                branches = self.expand_variant_cached(g, pids, w_idx, left_ctxs, rights)
                for br in branches:
                    for src, w, tid, l, allowed in frontier:
                        if l not in br["lset"]:
                            continue
                        if allowed is not None and pids[0] not in allowed:
                            continue
                        if src is None:
                            g.add_start(br["entry"], w - pron_cost)
                        else:
                            g.add_arc(src, br["entry"], w - pron_cost, tid)
                    serves_sil = sil in br["rset"]
                    non_sil = br["rset"] - {sil}
                    for s, w, tid in br["exits"]:
                        if serves_sil:
                            sil_inputs.setdefault(pids[-1], []).append(
                                (s, w + _safe_log(p_sil), tid)
                            )
                        if non_sil:
                            if is_last:
                                g.add_final(
                                    s, w + _safe_log(1.0 - p_sil) + nonsil_corr, tid
                                )
                            else:
                                new_frontier.append(
                                    (
                                        s,
                                        w + _safe_log(1.0 - p_sil),
                                        tid,
                                        pids[-1],
                                        non_sil,
                                    )
                                )

            # optional silence after this word, per distinct left context
            for last_phone, inputs in sil_inputs.items():
                for rs, sentry, sexits in self.expand_single_cached(
                    g, sil, -1, last_phone, next_starts
                ):
                    for s, w, tid in inputs:
                        g.add_arc(s, sentry, w, tid)
                    for ss, sw, stid in sexits:
                        if is_last:
                            g.add_final(ss, sw + sil_corr, stid)
                        else:
                            new_frontier.append((ss, sw, stid, sil, rs))

            frontier = new_frontier

        return g.finish(words)


def batch_graphs(graphs: List[CompiledGraph], state_multiple: int = 64):
    """Pad a list of host graphs into stacked numpy arrays (S_max, K_max).

    Padding states are unreachable self-loops with NEG_INF weights and pdf 0.
    ``S`` is rounded up to ``state_multiple`` so device programs recompile
    per bucket rather than per batch (S is the lane dimension of the
    emission and DP tensors; 64 keeps the padding overhead small while
    collapsing almost all alignment batches onto a handful of shapes).
    Returns a dict of arrays ready to build a
    :class:`~montreal_forced_aligner_tpu_torch.ops.viterbi.BatchedGraph`.
    """
    B = len(graphs)
    S = max(gr.num_states for gr in graphs)
    if state_multiple > 1:
        S = ((S + state_multiple - 1) // state_multiple) * state_multiple
    K = max(gr.max_in_arcs for gr in graphs)
    out = dict(
        in_src=np.zeros((B, S, K), dtype=np.int32),
        in_weight=np.full((B, S, K), NEG_INF, dtype=np.float32),
        in_tid=np.zeros((B, S, K), dtype=np.int32),
        start=np.full((B, S), NEG_INF, dtype=np.float32),
        final=np.full((B, S), NEG_INF, dtype=np.float32),
        final_tid=np.zeros((B, S), dtype=np.int32),
        state_pdf=np.zeros((B, S), dtype=np.int32),
        state_phone=np.zeros((B, S), dtype=np.int32),
        state_word=np.full((B, S), -1, dtype=np.int32),
        state_hmm_pos=np.zeros((B, S), dtype=np.int32),
        state_tstate=np.zeros((B, S), dtype=np.int32),
        state_instance=np.full((B, S), -1, dtype=np.int32),
        num_states=np.array([gr.num_states for gr in graphs], dtype=np.int32),
    )
    if any(gr.in_event is not None for gr in graphs):
        out["in_event"] = np.full((B, S, K), -1, dtype=np.int32)
    for b, gr in enumerate(graphs):
        s, k = gr.num_states, gr.max_in_arcs
        if "in_event" in out and gr.in_event is not None:
            out["in_event"][b, :s, :k] = gr.in_event
        out["in_src"][b, :s, :k] = gr.in_src
        out["in_weight"][b, :s, :k] = gr.in_weight
        out["in_tid"][b, :s, :k] = gr.in_tid
        out["start"][b, :s] = gr.start
        out["final"][b, :s] = gr.final
        out["final_tid"][b, :s] = gr.final_tid
        out["state_pdf"][b, :s] = gr.state_pdf
        out["state_phone"][b, :s] = gr.state_phone
        out["state_word"][b, :s] = gr.state_word
        out["state_hmm_pos"][b, :s] = gr.state_hmm_pos
        out["state_tstate"][b, :s] = gr.state_tstate
        out["state_instance"][b, :s] = gr.state_instance
    return out


# Only these arrays are consumed by device DP/emission programs; the label
# arrays (tids, phone/word/instance/hmm-pos) are used exclusively by the host
# backtrace (``extract_frame_labels_host``/``frame_tids_host``) and stay as
# host numpy inside the returned BatchedGraph — jit drops unused args
# (keep_unused=False default), so they never cross the host->device link.
DEVICE_INT_GRAPH_KEYS = ["in_src", "state_pdf", "num_states"]
DEVICE_FLOAT_GRAPH_KEYS = ["in_weight", "start", "final"]
HOST_GRAPH_KEYS = [
    "in_tid",
    "final_tid",
    "state_phone",
    "state_word",
    "state_hmm_pos",
    "state_tstate",
    "state_instance",
]
# kept for backward compatibility with external callers, in the original
# (order-sensitive: packed-buffer layouts were derived from it) order
INT_GRAPH_KEYS = [
    "in_src",
    "in_tid",
    "final_tid",
    "state_pdf",
    "state_phone",
    "state_word",
    "state_hmm_pos",
    "state_tstate",
    "state_instance",
    "num_states",
]
FLOAT_GRAPH_KEYS = list(DEVICE_FLOAT_GRAPH_KEYS)


def ship_graph_to_device(garrs: dict, device) -> "BatchedGraph":
    """Transfer the device-consumed half of a batched graph with exactly TWO
    host->device copies.

    The int and float arrays are packed into one buffer each; device-side
    unpacking is metadata-only slicing. Index arrays ship as int16 when
    their values fit (state and pdf counts < 2^15, true for every real
    alignment batch) and are widened to int32 on device, halving the wire
    bytes. Host-only label arrays are passed through as numpy and never
    transferred.
    """
    import torch

    from montreal_forced_aligner_tpu_torch.ops.viterbi import BatchedGraph

    int_arrays = [garrs[k] for k in DEVICE_INT_GRAPH_KEYS]
    narrow = all(
        a.size == 0 or (a.min() >= 0 and a.max() < 2**15) for a in int_arrays
    )
    int_dtype = np.int16 if narrow else np.int32
    int_parts = [
        np.ascontiguousarray(a, dtype=int_dtype).reshape(-1) for a in int_arrays
    ]
    float_parts = [
        np.ascontiguousarray(garrs[k], dtype=np.float32).reshape(-1)
        for k in DEVICE_FLOAT_GRAPH_KEYS
    ]
    int_buf = torch.from_numpy(np.concatenate(int_parts)).to(device)
    float_buf = torch.from_numpy(np.concatenate(float_parts)).to(device)
    out = {}
    off = 0
    for k, part in zip(DEVICE_INT_GRAPH_KEYS, int_parts):
        n = part.size
        sliced = int_buf[off : off + n].reshape(garrs[k].shape)
        out[k] = sliced.to(torch.int32) if narrow else sliced
        off += n
    off = 0
    for k, part in zip(DEVICE_FLOAT_GRAPH_KEYS, float_parts):
        n = part.size
        out[k] = float_buf[off : off + n].reshape(garrs[k].shape)
        off += n
    for k in HOST_GRAPH_KEYS:
        out[k] = garrs[k]
    return BatchedGraph(**out)
