"""HMM topology and transition model.

Clean-room reader/representation for Kaldi-format ``final.mdl`` files so that
pretrained reference model archives load directly (behavioral spec: the
reference loads these through kalpy in ``models.py:360-586``; topology
generation semantics in ``dictionary/mixins.py:699-790``).

Unlike the reference's object-oriented C++ structures, everything here is held
as flat numpy arrays so the downstream graph builder can ship integer tensors
straight to TPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch.io.kaldi_io import (
    KaldiBinaryReader,
    KaldiBinaryWriter,
    KaldiReadError,
    open_kaldi_stream,
)

KNOPDF = -1  # pdf-class of a non-emitting (final) topology state

# reference default (``dictionary/mixins.py``): 3 emitting non-silence states
DEFAULT_NUM_NON_SILENCE_STATES = 3


@dataclass
class TopologyState:
    forward_pdf_class: int
    self_loop_pdf_class: int
    # (next_state_index_within_entry, probability)
    transitions: List[Tuple[int, float]] = field(default_factory=list)


@dataclass
class HmmTopology:
    """Per-phone HMM topologies.

    ``entries[i]`` is a list of :class:`TopologyState`; the final state is
    non-emitting (pdf class ``KNOPDF``) with no transitions.
    """

    phones: np.ndarray  # sorted phone ids
    phone2idx: np.ndarray  # phone id -> entry index (-1 if absent)
    entries: List[List[TopologyState]]

    @classmethod
    def read(cls, reader: KaldiBinaryReader) -> "HmmTopology":
        if not getattr(reader, "binary", True):
            return cls._read_text(reader)
        reader.expect_token("<Topology>")
        phones = reader.read_int32_vector()
        phone2idx = reader.read_int32_vector()
        size = reader.read_int32()
        is_hmm = True
        if size == -1:  # sentinel for the two-pdf (chain) topology format
            is_hmm = False
            size = reader.read_int32()
        entries: List[List[TopologyState]] = []
        for _ in range(size):
            n_states = reader.read_int32()
            states: List[TopologyState] = []
            for _ in range(n_states):
                fwd = reader.read_int32()
                slf = fwd if is_hmm else reader.read_int32()
                n_trans = reader.read_int32()
                transitions = []
                for _ in range(n_trans):
                    dst = reader.read_int32()
                    prob = reader.read_float()
                    transitions.append((dst, prob))
                states.append(TopologyState(fwd, slf, transitions))
            entries.append(states)
        reader.expect_token("</Topology>")
        return cls(phones=phones, phone2idx=phone2idx, entries=entries)

    @classmethod
    def _read_text(cls, reader) -> "HmmTopology":
        """Kaldi text-mode topology: the user-editable ``<TopologyEntry>`` /
        ``<ForPhones>`` format (public Kaldi topology file format; the
        reference generates these files in ``dictionary/mixins.py:699``).

        States carry either ``<PdfClass> k`` or ``<ForwardPdfClass> f
        <SelfLoopPdfClass> s``; the final state has neither and no
        transitions.
        """
        reader.expect_token("<Topology>")
        entry_phones: List[List[int]] = []
        entries: List[List[TopologyState]] = []
        while True:
            tok = reader.read_token()
            if tok == "</Topology>":
                break
            if tok != "<TopologyEntry>":
                raise KaldiReadError(f"expected <TopologyEntry>, got {tok!r}")
            reader.expect_token("<ForPhones>")
            phones_here: List[int] = []
            while True:
                tok = reader.read_token()
                if tok == "</ForPhones>":
                    break
                phones_here.append(int(tok))
            states: List[TopologyState] = []
            while True:
                tok = reader.read_token()
                if tok == "</TopologyEntry>":
                    break
                if tok != "<State>":
                    raise KaldiReadError(f"expected <State>, got {tok!r}")
                state_idx = reader.read_int32()
                if state_idx != len(states):
                    raise KaldiReadError(
                        f"non-sequential state index {state_idx}"
                    )
                fwd = slf = KNOPDF
                transitions: List[Tuple[int, float]] = []
                while True:
                    tok = reader.read_token()
                    if tok == "</State>":
                        break
                    if tok == "<PdfClass>":
                        fwd = slf = reader.read_int32()
                    elif tok == "<ForwardPdfClass>":
                        fwd = reader.read_int32()
                    elif tok == "<SelfLoopPdfClass>":
                        slf = reader.read_int32()
                    elif tok == "<Transition>":
                        dst = reader.read_int32()
                        prob = reader.read_float()
                        transitions.append((dst, prob))
                    else:
                        raise KaldiReadError(
                            f"unexpected token {tok!r} in <State>"
                        )
                states.append(TopologyState(fwd, slf, transitions))
            entry_phones.append(phones_here)
            entries.append(states)
        all_phones = sorted(p for group in entry_phones for p in group)
        if not all_phones:
            raise KaldiReadError("topology has no phones")
        phone2idx = np.full(max(all_phones) + 1, -1, dtype=np.int32)
        for idx, group in enumerate(entry_phones):
            for p in group:
                phone2idx[p] = idx
        return cls(
            phones=np.array(all_phones, dtype=np.int32),
            phone2idx=phone2idx,
            entries=entries,
        )

    def write(self, writer: KaldiBinaryWriter) -> None:
        if not getattr(writer, "binary", True):
            self._write_text(writer)
            return
        writer.write_token("<Topology>")
        writer.write_int32_vector(self.phones)
        writer.write_int32_vector(self.phone2idx)
        is_hmm = all(
            s.forward_pdf_class == s.self_loop_pdf_class
            for e in self.entries
            for s in e
        )
        if not is_hmm:
            writer.write_int32(-1)
        writer.write_int32(len(self.entries))
        for entry in self.entries:
            writer.write_int32(len(entry))
            for s in entry:
                writer.write_int32(s.forward_pdf_class)
                if not is_hmm:
                    writer.write_int32(s.self_loop_pdf_class)
                writer.write_int32(len(s.transitions))
                for dst, prob in s.transitions:
                    writer.write_int32(dst)
                    writer.write_float(prob)
        writer.write_token("</Topology>")

    def _write_text(self, writer) -> None:
        """Text-mode topology in the ``<TopologyEntry>``/``<ForPhones>``
        format (inverse of :meth:`_read_text`); phones sharing an entry are
        grouped into one ``<ForPhones>`` block."""
        writer._w("<Topology>\n")
        for idx, entry in enumerate(self.entries):
            phones = [int(p) for p in self.phones if int(self.phone2idx[p]) == idx]
            if not phones:
                continue
            writer._w("<TopologyEntry>\n<ForPhones>\n")
            writer._w(" ".join(str(p) for p in phones) + "\n")
            writer._w("</ForPhones>\n")
            for j, st in enumerate(entry):
                writer._w(f"<State> {j} ")
                if st.forward_pdf_class != KNOPDF:
                    if st.forward_pdf_class == st.self_loop_pdf_class:
                        writer._w(f"<PdfClass> {st.forward_pdf_class} ")
                    else:
                        writer._w(
                            f"<ForwardPdfClass> {st.forward_pdf_class} "
                            f"<SelfLoopPdfClass> {st.self_loop_pdf_class} "
                        )
                for dst, prob in st.transitions:
                    writer._w(f"<Transition> {dst} {prob:.7g} ")
                writer._w("</State>\n")
            writer._w("</TopologyEntry>\n")
        writer._w("</Topology>\n")

    def entry_for_phone(self, phone: int) -> List[TopologyState]:
        idx = int(self.phone2idx[phone])
        if idx < 0:
            raise KeyError(f"phone {phone} has no topology entry")
        return self.entries[idx]

    def num_pdf_classes(self, phone: int) -> int:
        entry = self.entry_for_phone(phone)
        return max(s.forward_pdf_class for s in entry) + 1

    @classmethod
    def standard(
        cls,
        phones: List[int],
        silence_phones: Optional[List[int]] = None,
        num_non_silence_states: int = DEFAULT_NUM_NON_SILENCE_STATES,
        num_silence_states: int = 5,
        phone_topologies: Optional[Dict[int, Tuple[int, int]]] = None,
        variable_length: bool = True,
    ) -> "HmmTopology":
        """Build the reference's default topology.

        Semantics from reference ``dictionary/mixins.py:699-790``: non-silence
        phones default to (min_states=1, max_states=num_non_silence_states) —
        the initial state fans out to states min..max (phones as short as one
        frame), interior states self-loop 0.5 / forward 0.5, and the last
        emitting state exits with probability 1. ``phone_topologies`` maps a
        phone id to per-phone (min_states, max_states) overrides
        (``--topology_path`` yaml, ``multispeaker.py:252``); min == max gives
        a strict left-to-right chain. ``variable_length=False`` switches the
        non-silence default to classic Bakis chains with a self-loop on every
        state (the pre-2.0 MFA/Kaldi topology, also what the checked-in MFA
        test model uses): stronger duration priors, useful when acoustics
        alone underdetermine boundaries. Silence phones have
        ``num_silence_states`` emitting states where the initial state fans
        out to all non-final intermediate states, intermediate states are
        ergodic over {intermediates, final-emitting}, and the last emitting
        state has self-loop 0.75 / exit 0.25.
        """
        silence_phones = sorted(silence_phones or [])
        silence_set = set(silence_phones)
        nonsil = [p for p in phones if p not in silence_set]
        phone_topologies = phone_topologies or {}

        entries: List[List[TopologyState]] = []

        def ns_entry(min_states, max_states: int) -> List[TopologyState]:
            n = max_states
            states = []
            if min_states is None:
                # legacy Bakis chain: every state self-loops 0.5 / forwards 0.5
                for i in range(n):
                    states.append(
                        TopologyState(i, i, [(i, 0.5), (i + 1, 0.5)])
                    )
                states.append(TopologyState(KNOPDF, KNOPDF, []))
                return states
            if min_states == max_states:
                # strict chain (reference min==max branch): initial and
                # interior states self-loop 0.5 / forward 0.5, last emitting
                # state exits with probability 1 (n == 1: the initial state
                # is also last and keeps its 0.5/0.5 split)
                for i in range(n - 1):
                    states.append(
                        TopologyState(i, i, [(i, 0.5), (i + 1, 0.5)])
                    )
                if n == 1:
                    states.append(TopologyState(0, 0, [(0, 0.5), (1, 0.5)]))
                else:
                    states.append(TopologyState(n - 1, n - 1, [(n, 1.0)]))
            else:
                # the initial state (1 frame) fans out to entry points that
                # realize every duration in [min_states, max_states]: landing
                # on state k then chaining forward spends max - k + 1 frames,
                # so the targets are k in [1, max - min + 1] (k == n meaning
                # the final state, i.e. a 1-frame phone, only when
                # min_states == 1 — where this reduces exactly to the
                # reference writer's default (1, N) entry). Unlike the
                # reference's literal off-default branch (unnormalized fan to
                # range(min, max+1), which leaves dead states and violates
                # the floor), probabilities sum to 1 and the duration floor
                # holds.
                n_targets = max_states - min_states + 1
                p = 1.0 / n_targets
                states.append(
                    TopologyState(
                        0, 0, [(t, p) for t in range(1, n_targets + 1)]
                    )
                )
                for i in range(1, n - 1):
                    states.append(
                        TopologyState(i, i, [(i, 0.5), (i + 1, 0.5)])
                    )
                states.append(TopologyState(n - 1, n - 1, [(n, 1.0)]))
            states.append(TopologyState(KNOPDF, KNOPDF, []))
            return states

        def sil_entry() -> List[TopologyState]:
            n = num_silence_states
            if n == 1:
                states = [TopologyState(0, 0, [(0, 0.75), (1, 0.25)])]
                states.append(TopologyState(KNOPDF, KNOPDF, []))
                return states
            states = []
            # initial state: transitions to itself + all intermediate states
            initial_targets = list(range(n - 1))
            p = 1.0 / len(initial_targets)
            states.append(TopologyState(0, 0, [(t, p) for t in initial_targets]))
            # intermediate states: ergodic over intermediates + final emitting
            mid_targets = list(range(1, n))
            pm = 1.0 / len(mid_targets)
            for i in range(1, n - 1):
                states.append(TopologyState(i, i, [(t, pm) for t in mid_targets]))
            # final emitting state
            states.append(TopologyState(n - 1, n - 1, [(n - 1, 0.75), (n, 0.25)]))
            states.append(TopologyState(KNOPDF, KNOPDF, []))
            return states

        phone2idx = np.full(max(phones) + 1, -1, dtype=np.int32)
        all_sorted = sorted(phones)
        entry_index: Dict[tuple, int] = {}
        for p in all_sorted:
            if p in silence_set:
                kind = ("sil",)
            else:
                default = (
                    (1, num_non_silence_states)
                    if variable_length
                    else (None, num_non_silence_states)  # legacy chain
                )
                mn, mx = phone_topologies.get(p, default)
                if mn is not None and (mn < 1 or mn > mx):
                    raise ValueError(
                        f"phone {p}: need 1 <= min_states <= max_states, "
                        f"got ({mn}, {mx})"
                    )
                kind = ("ns", mn, mx)
            if kind not in entry_index:
                entry_index[kind] = len(entries)
                entries.append(
                    sil_entry() if kind[0] == "sil" else ns_entry(*kind[1:])
                )
            phone2idx[p] = entry_index[kind]
        return cls(
            phones=np.array(all_sorted, dtype=np.int32),
            phone2idx=phone2idx,
            entries=entries,
        )


@dataclass
class TransitionModel:
    """Transition model: tuples (phone, hmm-state, forward-pdf, self-loop-pdf)
    plus per-transition-id log probabilities.

    Transition-states are 1-based indices into ``tuples``; transition-ids are
    1-based and laid out contiguously per transition-state in topology
    transition order (matching the reference's numbering so alignments and
    accumulated statistics are interoperable).
    """

    topo: HmmTopology
    # tuple arrays, one row per transition-state (0-based row = tstate-1)
    phone: np.ndarray
    hmm_state: np.ndarray
    forward_pdf: np.ndarray
    self_loop_pdf: np.ndarray
    log_probs: np.ndarray  # indexed by transition-id; entry 0 unused

    # derived
    state2id: np.ndarray = field(default=None)  # tstate -> first transition-id
    id2state: np.ndarray = field(default=None)  # transition-id -> tstate
    id2pdf: np.ndarray = field(default=None)  # transition-id -> pdf emitted
    _tuple_lookup: Dict[Tuple[int, int, int, int], int] = field(default=None)

    def __post_init__(self):
        self._compute_derived()

    def _compute_derived(self) -> None:
        n_tstates = len(self.phone)
        state2id = np.zeros(n_tstates + 2, dtype=np.int32)
        cur = 1
        counts = np.zeros(n_tstates, dtype=np.int32)
        for s in range(n_tstates):
            state2id[s + 1] = cur
            entry = self.topo.entry_for_phone(int(self.phone[s]))
            counts[s] = len(entry[int(self.hmm_state[s])].transitions)
            cur += counts[s]
        state2id[n_tstates + 1] = cur
        self.num_transition_ids = cur - 1
        id2state = np.zeros(cur, dtype=np.int32)
        id2pdf = np.zeros(cur, dtype=np.int32)
        for s in range(n_tstates):
            entry = self.topo.entry_for_phone(int(self.phone[s]))
            trans = entry[int(self.hmm_state[s])].transitions
            for k, (dst, _prob) in enumerate(trans):
                tid = state2id[s + 1] + k
                id2state[tid] = s + 1
                is_self_loop = dst == int(self.hmm_state[s])
                id2pdf[tid] = (
                    self.self_loop_pdf[s] if is_self_loop else self.forward_pdf[s]
                )
        self.state2id = state2id
        self.id2state = id2state
        self.id2pdf = id2pdf
        self._tuple_lookup = {
            (
                int(self.phone[s]),
                int(self.hmm_state[s]),
                int(self.forward_pdf[s]),
                int(self.self_loop_pdf[s]),
            ): s + 1
            for s in range(n_tstates)
        }

    # -- queries -------------------------------------------------------------
    @property
    def num_pdfs(self) -> int:
        if len(self.forward_pdf) == 0:
            return 0
        return int(max(self.forward_pdf.max(), self.self_loop_pdf.max())) + 1

    @property
    def num_transition_states(self) -> int:
        return len(self.phone)

    def tuple_to_transition_state(
        self, phone: int, hmm_state: int, forward_pdf: int, self_loop_pdf: int
    ) -> int:
        return self._tuple_lookup[(phone, hmm_state, forward_pdf, self_loop_pdf)]

    def transition_ids_of_state(self, tstate: int) -> np.ndarray:
        return np.arange(self.state2id[tstate], self.state2id[tstate + 1])

    def transitions_of_state(self, tstate: int) -> List[Tuple[int, int, float]]:
        """Returns [(transition_id, dest_hmm_state, log_prob)] for a tstate."""
        s = tstate - 1
        entry = self.topo.entry_for_phone(int(self.phone[s]))
        trans = entry[int(self.hmm_state[s])].transitions
        out = []
        for k, (dst, _prob) in enumerate(trans):
            tid = int(self.state2id[tstate]) + k
            out.append((tid, dst, float(self.log_probs[tid])))
        return out

    def transition_id_to_phone(self, tid: int) -> int:
        return int(self.phone[self.id2state[tid] - 1])

    def is_self_loop(self, tid: int) -> bool:
        s = int(self.id2state[tid]) - 1
        entry = self.topo.entry_for_phone(int(self.phone[s]))
        trans = entry[int(self.hmm_state[s])].transitions
        k = tid - int(self.state2id[s + 1])
        return trans[k][0] == int(self.hmm_state[s])

    # -- serialization -------------------------------------------------------
    @classmethod
    def read(cls, reader: KaldiBinaryReader) -> "TransitionModel":
        reader.expect_token("<TransitionModel>")
        topo = HmmTopology.read(reader)
        token = reader.read_token()
        if token not in ("<Triples>", "<Tuples>"):
            raise KaldiReadError(f"expected <Triples>/<Tuples>, got {token!r}")
        two_pdf = token == "<Tuples>"
        size = reader.read_int32()
        phone = np.zeros(size, dtype=np.int32)
        hmm_state = np.zeros(size, dtype=np.int32)
        fwd = np.zeros(size, dtype=np.int32)
        slf = np.zeros(size, dtype=np.int32)
        for i in range(size):
            phone[i] = reader.read_int32()
            hmm_state[i] = reader.read_int32()
            fwd[i] = reader.read_int32()
            slf[i] = reader.read_int32() if two_pdf else fwd[i]
        reader.expect_token("</Tuples>" if two_pdf else "</Triples>")
        reader.expect_token("<LogProbs>")
        log_probs = reader.read_vector().astype(np.float32)
        reader.expect_token("</LogProbs>")
        reader.expect_token("</TransitionModel>")
        return cls(
            topo=topo,
            phone=phone,
            hmm_state=hmm_state,
            forward_pdf=fwd,
            self_loop_pdf=slf,
            log_probs=log_probs,
        )

    def write(self, writer: KaldiBinaryWriter) -> None:
        writer.write_token("<TransitionModel>")
        self.topo.write(writer)
        two_pdf = not np.array_equal(self.forward_pdf, self.self_loop_pdf)
        writer.write_token("<Tuples>" if two_pdf else "<Triples>")
        writer.write_int32(len(self.phone))
        for i in range(len(self.phone)):
            writer.write_int32(int(self.phone[i]))
            writer.write_int32(int(self.hmm_state[i]))
            writer.write_int32(int(self.forward_pdf[i]))
            if two_pdf:
                writer.write_int32(int(self.self_loop_pdf[i]))
        writer.write_token("</Tuples>" if two_pdf else "</Triples>")
        writer.write_token("<LogProbs>")
        writer.write_vector(self.log_probs)
        writer.write_token("</LogProbs>")
        writer.write_token("</TransitionModel>")

    # -- training-side constructors / updates -------------------------------
    @classmethod
    def from_topology_and_tree(cls, topo: HmmTopology, tree) -> "TransitionModel":
        """Initialize tuples from a tree (all seen (phone, hmm-state, pdf)
        combinations), with uniform-probability transitions.
        """
        rows = []
        for phone in topo.phones.tolist():
            entry = topo.entry_for_phone(phone)
            for j, st in enumerate(entry):
                if st.forward_pdf_class == KNOPDF:
                    continue
                pdfs = tree.pdfs_for_phone_pdf_class(phone, st.forward_pdf_class)
                self_pdfs = tree.pdfs_for_phone_pdf_class(phone, st.self_loop_pdf_class)
                if len(pdfs) == len(self_pdfs):
                    for fp, sp in zip(pdfs, self_pdfs):
                        rows.append((phone, j, fp, sp))
                else:
                    for fp in pdfs:
                        for sp in self_pdfs:
                            rows.append((phone, j, fp, sp))
        rows.sort()
        phone = np.array([r[0] for r in rows], dtype=np.int32)
        hmm_state = np.array([r[1] for r in rows], dtype=np.int32)
        fwd = np.array([r[2] for r in rows], dtype=np.int32)
        slf = np.array([r[3] for r in rows], dtype=np.int32)
        # initialize log-probs from topology prior probabilities
        model = cls(
            topo=topo,
            phone=phone,
            hmm_state=hmm_state,
            forward_pdf=fwd,
            self_loop_pdf=slf,
            log_probs=np.zeros(1, dtype=np.float32),
        )
        log_probs = np.zeros(model.num_transition_ids + 1, dtype=np.float32)
        for s in range(len(phone)):
            entry = topo.entry_for_phone(int(phone[s]))
            trans = entry[int(hmm_state[s])].transitions
            for k, (_dst, prob) in enumerate(trans):
                tid = int(model.state2id[s + 1]) + k
                log_probs[tid] = math.log(max(prob, 1e-20))
        model.log_probs = log_probs
        return model

    def mle_update(
        self, stats: np.ndarray, floor: float = 0.01, min_count: float = 5.0
    ) -> float:
        """Transition probability MLE update from per-transition-id counts.

        Semantics: reference ``acoustic_modeling/base.py:769-801`` calls the
        native transition MLE update; per transition-state, probabilities are
        count-normalized with flooring, states under ``min_count`` keep priors.
        Returns auxiliary-function improvement (log-likelihood gain).
        """
        assert stats.shape[0] == self.num_transition_ids + 1
        objf_impr = 0.0
        count_total = max(stats.sum(), 1e-10)
        new_log_probs = self.log_probs.copy()
        for s in range(1, self.num_transition_states + 1):
            lo = int(self.state2id[s])
            hi = int(self.state2id[s + 1])
            c = stats[lo:hi].astype(np.float64)
            tot = c.sum()
            if tot < min_count or hi - lo <= 1:
                continue
            probs = c / tot
            probs = np.maximum(probs, floor)
            probs = probs / probs.sum()
            old = np.exp(self.log_probs[lo:hi].astype(np.float64))
            objf_impr += float(np.sum(c * (np.log(probs) - np.log(np.maximum(old, 1e-20)))))
            new_log_probs[lo:hi] = np.log(probs).astype(np.float32)
        self.log_probs = new_log_probs
        return objf_impr / count_total
