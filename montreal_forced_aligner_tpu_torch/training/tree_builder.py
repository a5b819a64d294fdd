"""Phonetic decision-tree building (host side).

Clean-room implementation of the tree-building pipeline the reference drives
through ``_kalpy.tree`` (``automatically_obtain_questions`` + ``build_tree``;
call site ``acoustic_modeling/triphone.py:383-458``), with MFA's root
grouping: every base phone's positional variants form one "shared split"
root (``dictionary/mixins.py:834-880``).

Pieces:
* :class:`TreeStats` — per-event (context window, pdf-class) diagonal
  Gaussian statistics.
* :func:`auto_questions` — bottom-up likelihood clustering of phone groups;
  every merge-tree node's membership becomes a question.
* :func:`build_tree` — greedy likelihood-gain splitting of roots on
  (pdf-class, context-position) questions into a
  :class:`~montreal_forced_aligner_tpu_torch.models.tree.ContextDependency`.

Tree *construction* is sequential and irregular; it runs on the host in
numpy (the framewise statistics run on the device, ``training/base.py``).
Copy of ``montreal_forced_aligner_tpu/training/tree_builder.py`` but for the
search of a leaf's best split, which scores every (key, question) of a leaf
at once instead of one at a time (:func:`_split_scores`), with the same sums
in the same order, so it picks the same split: the reference's loop took
about a minute a tree at 2000 leaves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch.models.tree import (
    KPDF_CLASS,
    ConstantEventMap,
    ContextDependency,
    EventMap,
    SplitEventMap,
    TableEventMap,
)

# event key layout for N=3, P=1: keys 0,1,2 = left/center/right phone,
# KPDF_CLASS = -1 = pdf-class
EventKey = Tuple[Tuple[int, int], ...]  # sorted ((key, value), ...)


@dataclass
class GaussStats:
    count: float = 0.0
    sum: np.ndarray = None
    sumsq: np.ndarray = None

    @classmethod
    def zero(cls, dim: int) -> "GaussStats":
        return cls(0.0, np.zeros(dim), np.zeros(dim))

    def add(self, other: "GaussStats") -> None:
        self.count += other.count
        self.sum = self.sum + other.sum
        self.sumsq = self.sumsq + other.sumsq

    def log_likelihood(self, var_floor: float = 1e-3) -> float:
        """Maximum log-likelihood of the data under the pooled diagonal
        Gaussian (Kaldi GaussClusterable objf)."""
        if self.count <= 0:
            return 0.0
        mean = self.sum / self.count
        var = np.maximum(self.sumsq / self.count - mean**2, var_floor)
        dim = len(mean)
        return float(
            -0.5 * self.count * (dim * (math.log(2 * math.pi) + 1.0) + np.log(var).sum())
        )


class TreeStats:
    """Accumulated stats per event: {((key, value), ...): GaussStats}."""

    def __init__(self, dim: int, context_width: int = 3, central_position: int = 1):
        self.dim = dim
        self.N = context_width
        self.P = central_position
        self.stats: Dict[EventKey, GaussStats] = {}

    def add_event(self, context: Sequence[int], pdf_class: int, stats: GaussStats):
        key = tuple(
            sorted([(KPDF_CLASS, pdf_class)] + list(enumerate(context)))
        )
        if key not in self.stats:
            self.stats[key] = GaussStats.zero(self.dim)
        self.stats[key].add(stats)

    def events_list(self) -> List[Tuple[Dict[int, int], GaussStats]]:
        return [(dict(k), v) for k, v in self.stats.items()]


def cluster_gauss_stats(
    items: List[Tuple[int, GaussStats]],
) -> List[Set[int]]:
    """Bottom-up greedy merging by minimum likelihood loss; returns the
    membership sets of every node of the merge tree (the questions)."""
    clusters: List[Tuple[Set[int], GaussStats]] = [
        ({pid}, GaussStats(g.count, g.sum.copy(), g.sumsq.copy()))
        for pid, g in items
        if g.count > 0
    ]
    # include singletons with no stats so every phone appears in questions
    no_stats = [pid for pid, g in items if g.count <= 0]
    questions: List[Set[int]] = [set(c[0]) for c in clusters]
    questions.extend({pid} for pid in no_stats)

    def merged_loss(a: GaussStats, b: GaussStats) -> float:
        m = GaussStats(a.count, a.sum.copy(), a.sumsq.copy())
        m.add(b)
        return a.log_likelihood() + b.log_likelihood() - m.log_likelihood()

    while len(clusters) > 1:
        best = None
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                loss = merged_loss(clusters[i][1], clusters[j][1])
                if best is None or loss < best[0]:
                    best = (loss, i, j)
        _loss, i, j = best
        si, gi = clusters[i]
        sj, gj = clusters[j]
        merged = si | sj
        g = GaussStats(gi.count, gi.sum.copy(), gi.sumsq.copy())
        g.add(gj)
        clusters = [c for k, c in enumerate(clusters) if k not in (i, j)]
        clusters.append((merged, g))
        questions.append(set(merged))
    # deduplicate
    seen = set()
    out = []
    for q in questions:
        key = tuple(sorted(q))
        if key not in seen:
            seen.add(key)
            out.append(q)
    return out


def auto_questions(
    tree_stats: TreeStats,
    phone_groups: List[List[int]],
    cluster_pdf_class: int = 1,
) -> List[Set[int]]:
    """Cluster phone groups by their central-state stats; questions are the
    merge-tree node memberships expanded back to phone ids (Kaldi
    ``automatically_obtain_questions`` with pdf-class [1])."""
    group_stats: List[Tuple[int, GaussStats]] = []
    for gi, group in enumerate(phone_groups):
        g = GaussStats.zero(tree_stats.dim)
        for event, stats in tree_stats.stats.items():
            ed = dict(event)
            if (
                ed.get(tree_stats.P) in group
                and ed.get(KPDF_CLASS) == cluster_pdf_class
            ):
                g.add(stats)
        group_stats.append((gi, g))
    group_questions = cluster_gauss_stats(group_stats)
    questions = []
    for q in group_questions:
        phones = set()
        for gi in q:
            phones.update(phone_groups[gi])
        questions.append(phones)
    return questions


@dataclass
class Root:
    phones: Set[int]
    shared: bool = True
    split: bool = True


@dataclass
class _Leaf:
    events: List[Tuple[Dict[int, int], GaussStats]]
    stats: GaussStats
    pdf: int = -1


@dataclass
class _Split:
    key: int
    yes_set: Set[int]
    yes: object
    no: object


def _pool(events, dim) -> GaussStats:
    g = GaussStats.zero(dim)
    for _e, s in events:
        g.add(s)
    return g


def _stats_ll(count: np.ndarray, sums: np.ndarray, sumsq: np.ndarray,
              var_floor: float = 1e-3) -> np.ndarray:
    """:meth:`GaussStats.log_likelihood` of many pooled statistics at once,
    with the same operations in the same order (0 where count <= 0)."""
    dim = sums.shape[1]
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = sums / count[:, None]
        var = np.maximum(sumsq / count[:, None] - mean**2, var_floor)
        ll = -0.5 * count * (
            dim * (math.log(2 * math.pi) + 1.0) + np.log(var).sum(axis=1)
        )
    return np.where(count > 0, ll, 0.0)


def _question_table(flat_questions):
    """(keys, key index of each question, (questions, values) membership
    table) for :func:`_split_scores`."""
    keys = sorted({k for k, _q in flat_questions})
    top = max((max(q) for _k, q in flat_questions if q), default=0)
    table = np.zeros((len(flat_questions), top + 2), bool)
    for i, (_k, q) in enumerate(flat_questions):
        table[i, sorted(q)] = True
    key_of_q = np.array([keys.index(k) for k, _q in flat_questions])
    return keys, key_of_q, table


def _split_scores(events, flat_questions, dim: int, min_count: float):
    """Yes + no log-likelihood of every (key, question) split of a leaf's
    events (``flat_questions`` from :func:`_question_table`), -inf where the split is not allowed (one side empty or under
    ``min_count``), and each split's yes mask. The pools are running sums
    over the events in list order, as ``_pool`` adds them one by one, so
    every score equals the reference loop's to the bit."""
    n = len(events)
    stats = np.empty((n, 2 * dim + 1))
    for i, (_e, s) in enumerate(events):
        stats[i, 0] = s.count
        stats[i, 1 : dim + 1] = s.sum
        stats[i, dim + 1 :] = s.sumsq
    keys, key_of_q, table = flat_questions
    values = np.array([[e.get(k, 0) for e, _s in events] for k in keys])
    nq = len(key_of_q)
    # values no question names read the table's last column, all False
    values = np.minimum(values, table.shape[1] - 1)
    masks = table[np.arange(nq)[:, None], values[key_of_q]]  # (nq, n)
    n_yes = masks.sum(axis=1)
    # running sums from 0.0 over the events in list order; an event on the
    # other side adds exactly 0.0 to a running sum (x * 0, x - x * 1), so
    # each last value is the loop's pool to the bit
    F = stats.shape[1]
    yes = np.zeros((nq, F))
    no = np.zeros((nq, F))
    tmp = np.empty((nq, F))
    member = masks.T.astype(np.float64)[:, :, None]  # (n, nq, 1)
    for i in range(n):
        np.multiply(member[i], stats[i], out=tmp)
        yes += tmp
        np.subtract(stats[i], tmp, out=tmp)
        no += tmp
    ok = (n_yes > 0) & (n_yes < n) & (yes[:, 0] >= min_count) & (no[:, 0] >= min_count)
    ll = (_stats_ll(yes[:, 0], yes[:, 1 : dim + 1], yes[:, dim + 1 :])
          + _stats_ll(no[:, 0], no[:, 1 : dim + 1], no[:, dim + 1 :]))
    gains = np.where(ok, ll, -np.inf)
    return gains, masks


def build_tree(
    tree_stats: TreeStats,
    questions: List[Set[int]],
    roots: List[Root],
    max_leaves: int = 1000,
    min_gain: float = 0.0001,
    min_count: float = 4.0,
    pdf_class_questions: Optional[List[Set[int]]] = None,
    cluster_thresh: float = -1.0,
) -> ContextDependency:
    """Greedy global best-first splitting (Kaldi ``build-tree`` semantics).

    Every root starts as one leaf (shared roots pool all pdf-classes and
    phones of the group); at each step the (leaf, key, question) with the
    largest likelihood gain splits, until ``max_leaves``.
    """
    dim = tree_stats.dim
    N, P = tree_stats.N, tree_stats.P
    if pdf_class_questions is None:
        max_cls = max(
            (dict(e).get(KPDF_CLASS, 0) for e in tree_stats.stats), default=0
        )
        pdf_class_questions = [set(range(c + 1)) for c in range(max_cls + 1)]

    events_by_center: Dict[int, List] = {}
    for event, stats in tree_stats.stats.items():
        ed = dict(event)
        events_by_center.setdefault(ed[P], []).append((ed, stats))

    # build initial leaves per root
    trees: List[Tuple[Root, object]] = []
    leaves: List[_Leaf] = []
    for root in roots:
        evs = []
        for phone in root.phones:
            evs.extend(events_by_center.get(phone, []))
        leaf = _Leaf(events=evs, stats=_pool(evs, dim))
        leaves.append(leaf)
        trees.append((root, leaf))

    key_questions = {key: questions for key in range(N) if key != P}
    key_questions[P] = questions
    key_questions[KPDF_CLASS] = pdf_class_questions

    flat_questions = [(key, q) for key, qs in key_questions.items() for q in qs]
    question_table = _question_table(flat_questions)

    def best_split(leaf: _Leaf):
        if len(leaf.events) < 2:
            return None
        base_ll = leaf.stats.log_likelihood()
        scored = _split_scores(leaf.events, question_table, dim, min_count)
        if scored is None:
            return None
        split_ll, yes_masks = scored
        gains = split_ll - base_ll
        i = int(np.argmax(gains))  # the first best, as the loop's strict >
        if not np.isfinite(gains[i]):
            return None
        gain = float(gains[i])
        key, q = flat_questions[i]
        mask = yes_masks[i]
        yes_events = [ev for ev, m in zip(leaf.events, mask) if m]
        no_events = [ev for ev, m in zip(leaf.events, mask) if not m]
        return (gain, key, q, yes_events, no_events)

    # priority loop (recompute best split lazily per leaf)
    splittable = {}
    for i, (root, leaf) in enumerate(trees):
        if root.split:
            splittable[id(leaf)] = (leaf, best_split(leaf))

    containers: Dict[int, Tuple[Optional[_Split], Optional[int]]] = {}
    # parent link map for replacing leaves in the tree structure
    parent: Dict[int, Tuple[Optional[_Split], str, int]] = {}
    for i, (_root, leaf) in enumerate(trees):
        parent[id(leaf)] = (None, "root", i)

    num_leaves = len(leaves)
    while num_leaves < max_leaves:
        best_leaf = None
        best_val = None
        for lid, (leaf, split) in splittable.items():
            if split is None:
                continue
            if best_val is None or split[0] > best_val:
                best_val = split[0]
                best_leaf = lid
        if best_leaf is None or best_val <= min_gain:
            break
        leaf, (gain, key, q, yes_events, no_events) = splittable.pop(best_leaf)
        yes_leaf = _Leaf(events=yes_events, stats=_pool(yes_events, dim))
        no_leaf = _Leaf(events=no_events, stats=_pool(no_events, dim))
        node = _Split(key=key, yes_set=set(q), yes=yes_leaf, no=no_leaf)
        # replace leaf with node in its parent
        pnode, side, ridx = parent[id(leaf)]
        if pnode is None:
            trees[ridx] = (trees[ridx][0], node)
        elif side == "yes":
            pnode.yes = node
        else:
            pnode.no = node
        parent[id(yes_leaf)] = (node, "yes", ridx)
        parent[id(no_leaf)] = (node, "no", ridx)
        splittable[id(yes_leaf)] = (yes_leaf, best_split(yes_leaf))
        splittable[id(no_leaf)] = (no_leaf, best_split(no_leaf))
        num_leaves += 1

    # assign pdf ids in deterministic (tree traversal) order
    pdf_counter = [0]
    all_leaf_stats: List[GaussStats] = []

    def assign(node) -> None:
        if isinstance(node, _Leaf):
            node.pdf = pdf_counter[0]
            all_leaf_stats.append(node.stats)
            pdf_counter[0] += 1
        else:
            assign(node.yes)
            assign(node.no)

    for _root, node in trees:
        assign(node)

    # convert to EventMap: top-level TE on the central phone
    def convert(node) -> EventMap:
        if isinstance(node, _Leaf):
            return ConstantEventMap(node.pdf)
        return SplitEventMap(
            node.key, sorted(node.yes_set), convert(node.yes), convert(node.no)
        )

    max_phone = max(p for root, _n in trees for p in root.phones)
    table: List[Optional[EventMap]] = [None] * (max_phone + 1)
    for root, node in trees:
        em = convert(node)
        for phone in root.phones:
            table[phone] = em
    cd = ContextDependency(N=N, P=P, to_pdf=TableEventMap(P, table))
    cd.leaf_stats = all_leaf_stats  # for GMM init
    return cd


def init_gmm_from_tree(
    tree: ContextDependency,
    var_floor: float = 1e-3,
    fallback_mean: Optional[np.ndarray] = None,
    fallback_var: Optional[np.ndarray] = None,
):
    """One Gaussian per leaf from its pooled stats (``gmm-init-model``)."""
    from montreal_forced_aligner_tpu_torch.models.gmm import DiagGmmSet

    stats: List[GaussStats] = tree.leaf_stats
    dim = len(stats[0].sum) if stats else len(fallback_mean)
    weights, mivs, ivs = [], [], []
    for g in stats:
        if g.count > 0:
            mean = g.sum / g.count
            var = np.maximum(g.sumsq / g.count - mean**2, var_floor)
        else:
            mean = fallback_mean if fallback_mean is not None else np.zeros(dim)
            var = fallback_var if fallback_var is not None else np.ones(dim)
        iv = 1.0 / var
        weights.append(np.ones(1, np.float32))
        mivs.append((mean * iv)[None, :].astype(np.float32))
        ivs.append(iv[None, :].astype(np.float32))
    return DiagGmmSet.from_lists(weights, mivs, ivs)
