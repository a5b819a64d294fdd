"""Triphone training: tree stats → question clustering → decision tree →
model init → alignment conversion → Viterbi EM.

Counterpart of ``montreal_forced_aligner_tpu/training/triphone.py``: the
per-event statistics reduce on the device (``base._accumulate_events``); the
frame labels, events, tree and alignment conversion are the reference's host
code.

Behavioral spec: reference ``acoustic_modeling/triphone.py`` (tree stats
``:123-188``, auto questions + ``build_tree`` ``:383-458``, alignment
conversion ``:55-121``; realign every 10th iteration ``:318-325``). The
framewise tree-stat accumulation runs on the device; clustering and tree
building are host-side numpy (see ``training/tree_builder.py``).
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch.models.transition_model import HmmTopology, TransitionModel
from montreal_forced_aligner_tpu_torch.models.tree import KPDF_CLASS
from montreal_forced_aligner_tpu_torch.training.base import (
    TrainerConfig,
    TrainingPipeline,
    _accumulate_events,
)
from montreal_forced_aligner_tpu_torch.training.em import ViterbiEmTrainer
from montreal_forced_aligner_tpu_torch.training.tree_builder import (
    GaussStats,
    Root,
    TreeStats,
    auto_questions,
    build_tree,
    init_gmm_from_tree,
)

logger = logging.getLogger("mfa_tpu")

POSITIONS = ("_B", "_E", "_I", "_S")


class TriphoneTrainer(ViterbiEmTrainer):
    train_type = "tri"

    def __init__(
        self,
        lexicon,
        topo: HmmTopology,
        config: Optional[TrainerConfig] = None,
        num_leaves: int = 1000,
        initial_gaussians: Optional[int] = None,
        cluster_pdf_class: int = 1,
        phone_set_type=None,
        custom_phone_groups=None,
    ):
        super().__init__(lexicon, config)
        self.topo = topo
        self.num_leaves = num_leaves
        self.initial_gaussians = initial_gaussians
        self.cluster_pdf_class = cluster_pdf_class
        from montreal_forced_aligner_tpu_torch.data import PhoneSetType

        if phone_set_type is None:
            phone_set_type = PhoneSetType.UNKNOWN
        elif isinstance(phone_set_type, str):
            phone_set_type = PhoneSetType[phone_set_type.upper()]
        self.phone_set_type = phone_set_type
        # user-supplied tree-root groups of base phones (reference
        # ``--phone_groups_path``, ``dictionary/multispeaker.py:206-240``);
        # list of lists of base-phone names
        self.custom_phone_groups = custom_phone_groups

    def _resolved_phone_set(self):
        """AUTO inspects the dictionary's base phone labels (reference
        ``PhoneSetType.AUTO``, ``data.py:615``)."""
        from montreal_forced_aligner_tpu_torch.data import PhoneSetType

        pst = self.phone_set_type
        if pst is PhoneSetType.AUTO:
            pst = PhoneSetType.detect(self._positional_bases().keys())
        return pst

    def _positional_bases(self) -> Dict[str, List[int]]:
        """{positional-suffix-stripped name: phone ids} over the table."""
        groups: Dict[str, List[int]] = defaultdict(list)
        for name, pid in self.lexicon.phone_table.items():
            if pid <= 0:
                continue
            base = name
            for pos in POSITIONS:
                if name.endswith(pos):
                    base = name[: -len(pos)]
                    break
            groups[base].append(pid)
        return groups

    def phone_groups(self) -> List[List[int]]:
        """MFA root grouping: a base phone's positional variants form one
        group (``dictionary/mixins.py:834-880``); silence phones likewise.
        With a known phone set, stress/tone/suprasegmental variants merge
        into one root too (AH0/AH1/AH2 -> AH; reference
        ``dictionary/mixins.py:224-530`` base-phone grouping)."""
        from montreal_forced_aligner_tpu_torch.data import PhoneSetType

        groups = self._positional_bases()
        if self.custom_phone_groups:
            # explicit groups win (reference load_phone_groups,
            # ``multispeaker.py:206``): listed base phones pool into their
            # group's root; unlisted phones keep per-base roots
            out: List[List[int]] = []
            grouped: set = set()
            for members in self.custom_phone_groups:
                pids: List[int] = []
                for base in members:
                    pids.extend(groups.get(base, ()))
                    grouped.add(base)
                if pids:
                    out.append(sorted(pids))
            for base, pids in sorted(groups.items()):
                if base not in grouped:
                    out.append(sorted(pids))
            return out
        pst = self._resolved_phone_set()
        if pst not in (PhoneSetType.UNKNOWN, PhoneSetType.AUTO):
            merged: Dict[str, List[int]] = defaultdict(list)
            for base, pids in groups.items():
                merged[pst.base_phone(base)].extend(pids)
            groups = merged
        return [sorted(v) for _k, v in sorted(groups.items())]

    def extra_question_sets(self) -> List[set]:
        """Phonological-class questions as phone-id sets (reference
        ``PhoneSetType.extra_questions``, ``data.py:1364``; written to
        extra_questions.int by ``dictionary/mixins.py:834``)."""
        from montreal_forced_aligner_tpu_torch.data import PhoneSetType

        pst = self._resolved_phone_set()
        if pst in (PhoneSetType.UNKNOWN, PhoneSetType.AUTO):
            return []
        bases = self._positional_bases()
        out = []
        for _name, cls_bases in sorted(pst.extra_questions().items()):
            q = set()
            for base, pids in bases.items():
                if pst.base_phone(base) in cls_bases:
                    q.update(pids)
            if len(q) > 1:
                out.append(q)
        for _name, full in sorted(pst.tone_questions(bases.keys()).items()):
            q = set()
            for base in full:
                q.update(bases[base])
            if len(q) > 1:
                out.append(q)
        return out

    # -- alignment label extraction (from the previous stage) ----------------
    def _extract_labels(self, pipeline: TrainingPipeline) -> List[dict]:
        """Per batch: host arrays (phone, hmm_pos, instance) per frame plus
        left/right phone context per frame, from the cached state paths."""
        out = []
        for fb in pipeline.batches:
            assert fb.has_alignment(), "previous-stage alignment required"
            sp = fb.host_state_path()
            b = np.arange(sp.shape[0])[:, None]
            phone = fb.garrs["state_phone"][b, sp]
            hmm_pos = fb.garrs["state_hmm_pos"][b, sp]
            inst = fb.garrs["state_instance"][b, sp]
            B, T = phone.shape
            left = np.zeros_like(phone)
            right = np.zeros_like(phone)
            for row in range(B):
                L = int(fb.frame_lengths[row])
                if L == 0:
                    continue
                ii = inst[row, :L]
                ph = phone[row, :L]
                # run boundaries by instance change
                change = np.flatnonzero(np.diff(ii)) + 1
                seg_start = np.concatenate([[0], change])
                seg_end = np.concatenate([change, [L]])
                seg_phone = ph[seg_start]
                n_seg = len(seg_start)
                seg_left = np.concatenate([[0], seg_phone[:-1]])
                seg_right = np.concatenate([seg_phone[1:], [0]])
                for k in range(n_seg):
                    left[row, seg_start[k] : seg_end[k]] = seg_left[k]
                    right[row, seg_start[k] : seg_end[k]] = seg_right[k]
            out.append(
                dict(
                    phone=phone, hmm_pos=hmm_pos, inst=inst,
                    left=left, right=right, fb=fb,
                )
            )
        return out

    def _pdf_class_of(self, phone: int, hmm_pos: int) -> int:
        return self.topo.entry_for_phone(phone)[hmm_pos].forward_pdf_class

    def _accumulate_tree_stats(
        self, labels: List[dict], dim: int
    ) -> TreeStats:
        """Event = (left, center, right, pdf-class); Gaussian stats per event
        accumulated on the device by fixed-order segmented sums."""
        stats = TreeStats(dim, context_width=3, central_position=1)
        event_ids: Dict[Tuple[int, int, int, int], int] = {}
        batch_events = []
        for lab in labels:
            fb = lab["fb"]
            B, T = lab["phone"].shape
            ev = np.zeros((B, T), np.int32)
            for row in range(B):
                L = int(fb.frame_lengths[row])
                for t in range(L):
                    key = (
                        int(lab["left"][row, t]),
                        int(lab["phone"][row, t]),
                        int(lab["right"][row, t]),
                        self._pdf_class_of(
                            int(lab["phone"][row, t]), int(lab["hmm_pos"][row, t])
                        ),
                    )
                    eid = event_ids.get(key)
                    if eid is None:
                        eid = len(event_ids)
                        event_ids[key] = eid
                    ev[row, t] = eid
            batch_events.append((fb, ev))
        E = len(event_ids)
        counts = np.zeros(E)
        sums = np.zeros((E, dim))
        sumsqs = np.zeros((E, dim))
        pending = []
        for fb, ev in batch_events:
            out = _accumulate_events(
                fb.put_b(fb.feats), fb.put_b(fb.frame_lengths), fb.put_b(ev), E
            )
            pending.append(out)
        from montreal_forced_aligner_tpu_torch.training.base import fetch_all

        for c, s_, ss in fetch_all(pending):
            counts += c
            sums += s_
            sumsqs += ss
        for key, eid in event_ids.items():
            l, c, r, cls = key
            stats.add_event(
                [l, c, r],
                cls,
                GaussStats(float(counts[eid]), sums[eid], sumsqs[eid]),
            )
        return stats

    def _convert_alignments(self, labels: List[dict]) -> None:
        """Map the previous stage's alignments onto the new tree
        (reference ``ConvertAlignmentsFunction``, ``triphone.py:55-121``):
        same phone/state timing, new pdf-ids and transition-ids."""
        tm = self.tm
        for lab in labels:
            fb = lab["fb"]
            B, T = lab["phone"].shape
            frame_pdf = np.zeros((B, T), np.int32)
            frame_tid = np.zeros((B, T), np.int32)
            for row in range(B):
                L = int(fb.frame_lengths[row])
                prev_key = None
                cached = None
                for t in range(L):
                    ph = int(lab["phone"][row, t])
                    hp = int(lab["hmm_pos"][row, t])
                    window = [
                        int(lab["left"][row, t]),
                        ph,
                        int(lab["right"][row, t]),
                    ]
                    key = (window[0], ph, window[2], hp)
                    if key != prev_key:
                        entry = self.topo.entry_for_phone(ph)
                        fwd = self.tree.compute_pdf(window, entry[hp].forward_pdf_class)
                        slf = self.tree.compute_pdf(window, entry[hp].self_loop_pdf_class)
                        tstate = tm.tuple_to_transition_state(ph, hp, fwd, slf)
                        trans = tm.transitions_of_state(tstate)
                        self_tid = next(
                            (tid for tid, dst, _ in trans if dst == hp), 0
                        )
                        by_dst = {dst: tid for tid, dst, _ in trans}
                        fwd_tid = next(
                            (tid for tid, dst, _ in trans if dst != hp), self_tid
                        )
                        final_idx = len(entry) - 1
                        cached = (fwd, self_tid, fwd_tid, by_dst, final_idx)
                        prev_key = key
                    fwd, self_tid, fwd_tid, by_dst, final_idx = cached
                    frame_pdf[row, t] = fwd
                    # frame t consumes the arc leaving its state; with
                    # variable-length topologies a state can have several
                    # forward arcs (skips, direct exit), so the arc is
                    # resolved by the actual destination: self-loop when the
                    # next frame stays in the same (instance, hmm state),
                    # the matching in-phone arc when the instance continues
                    # elsewhere, and the exit arc when the instance ends
                    same_inst = (
                        t + 1 < L
                        and lab["inst"][row, t + 1] == lab["inst"][row, t]
                    )
                    if same_inst and lab["hmm_pos"][row, t + 1] == hp:
                        tid = self_tid
                    elif same_inst:
                        tid = by_dst.get(
                            int(lab["hmm_pos"][row, t + 1]), fwd_tid
                        )
                    else:
                        tid = by_dst.get(final_idx, fwd_tid)
                    frame_tid[row, t] = tid
            fb.frame_pdf = fb.put_b(frame_pdf)
            fb.frame_tid = frame_tid
            # the previous stage's device-resident alignment no longer
            # matches the new tree/transition-ids
            fb.frame_tid_dev = None
            fb.state_path_dev = None
            fb.state_path = None
            fb.align_scores_dev = None
            # a mid-stage checkpoint may have materialized a host copy of
            # the previous stage's scores; clear it too so
            # host_align_scores() cannot serve stale values
            fb.align_scores = None
        self._tcounts = None

    def initialize(self, pipeline: TrainingPipeline) -> None:
        with pipeline.clock("tree"):
            labels = self._extract_labels(pipeline)
            dim = pipeline.feature_dim
            logger.info("accumulating tree stats")
            tree_stats = self._accumulate_tree_stats(labels, dim)
            logger.info("%d tree-stat events", len(tree_stats.stats))
            groups = self.phone_groups()
            questions = auto_questions(tree_stats, groups, self.cluster_pdf_class)
            extra = self.extra_question_sets()
            if extra:
                seen = {tuple(sorted(q)) for q in questions}
                questions.extend(
                    q for q in extra if tuple(sorted(q)) not in seen
                )
                logger.info(
                    "%s phone set: %d extra phonological questions",
                    self.phone_set_type, len(extra),
                )
            roots = [Root(set(g)) for g in groups]
            with pipeline.clock("build_tree"):
                self.tree = build_tree(
                    tree_stats, questions, roots, max_leaves=self.num_leaves
                )
            logger.info("built tree with %d leaves", self.tree.num_pdfs)
            self.tm = TransitionModel.from_topology_and_tree(self.topo, self.tree)
            mean, var = pipeline.global_mean_var()
            self.gmm = init_gmm_from_tree(
                self.tree, fallback_mean=mean, fallback_var=var
            )
            self._convert_alignments(labels)
        acc = self._accumulate(pipeline)
        self._update(acc, mixup_target=self.initial_gaussians)
        # graphs for subsequent realignment iterations
        pipeline.compile_graphs(self.make_compiler())
        self._realign(pipeline)
