"""Plain reference of speaker-adapted (SAT) forced alignment, in float64
PyTorch on whatever device it is given, written from the published
semantics (Kaldi's MFCC, CMVN, splicing and LDA, the HMM topology of MFA 2
and later with Kaldi's graph scaling, diagonal GMMs, exact Viterbi, fMLLR
by Kaldi's row-by-row solve) and not from the program's code.

It reads the configuration (``configs/<name>.json``), the parameters that
``models.gmm_sat`` draws from the configuration's seed, the audio files
and the transcripts; it imports nothing of the program.

``precision="tf32"`` is the control: every float32 product of the
program's path (the LDA, each frame's products in the fMLLR statistics,
the fMLLR apply and the emissions) computed in float32 on TF32 tensor
cores, the step below the float32 the configuration states (the fMLLR
solve stays in float64, as the program runs it)."""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.models import gmm_sat as model

F64 = torch.float64
NEG = -math.inf


# -- features ------------------------------------------------------------------

def mfcc(wave: np.ndarray, device, sr=16000, shift_ms=10.0, length_ms=25.0,
         num_ceps=13, num_mel=23, low=20.0, high=7800.0, preemph=0.97,
         lifter=22.0) -> torch.Tensor:
    """Kaldi ``compute-mfcc-feats`` with ``--snip-edges=false``, no energy
    and no dither: (frames, num_ceps) float64."""
    x = torch.as_tensor(np.asarray(wave, np.float64), device=device)
    n = x.shape[0]
    shift, length = int(sr * shift_ms / 1000), int(sr * length_ms / 1000)
    frames = (n + shift // 2) // shift
    fft = 1 << (length - 1).bit_length()
    start = torch.arange(frames, device=device) * shift + shift // 2 - length // 2
    idx = start[:, None] + torch.arange(length, device=device)[None, :]
    idx = torch.where(idx < 0, -idx - 1, idx)
    idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
    f = x[idx]
    f = f - f.mean(dim=1, keepdim=True)
    f = f - preemph * torch.cat([f[:, :1], f[:, :-1]], dim=1)
    k = torch.arange(length, device=device, dtype=F64)
    f = f * (0.5 - 0.5 * torch.cos(2 * math.pi * k / (length - 1))) ** 0.85
    power = torch.fft.rfft(f, n=fft).abs() ** 2
    power = power[:, : fft // 2]

    def mel(hz):
        return 1127.0 * torch.log1p(torch.as_tensor(hz, dtype=F64, device=device) / 700.0)

    lo, hi = mel(low), mel(high)
    delta = (hi - lo) / (num_mel + 1)
    bins = mel(torch.arange(fft // 2, device=device, dtype=F64) * sr / fft)
    left = lo + delta * torch.arange(num_mel, device=device, dtype=F64)
    up = (bins[:, None] - left[None]) / delta
    down = (left[None] + 2 * delta - bins[:, None]) / delta
    banks = torch.clamp(torch.minimum(up, down), min=0.0)
    logmel = torch.log(torch.clamp(power @ banks, min=float(np.finfo(np.float32).eps)))
    m = torch.arange(num_mel, device=device, dtype=F64)
    c = torch.arange(num_ceps, device=device, dtype=F64)
    dct = math.sqrt(2.0 / num_mel) * torch.cos(math.pi * c[:, None] * (2 * m[None] + 1) / (2 * num_mel))
    dct[0] = math.sqrt(1.0 / num_mel)
    lift = 1.0 + 0.5 * lifter * torch.sin(math.pi * c / lifter)
    return (logmel @ dct.T) * lift


def splice(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Kaldi ``splice-feats``: frames past either end repeat the end."""
    T = x.shape[0]
    t = torch.arange(T, device=x.device)
    parts = [x[torch.clamp(t + j, 0, T - 1)] for j in range(-left, right + 1)]
    return torch.cat(parts, dim=1)


@contextmanager
def _precision(precision: str):
    """float64 for the reference; float32 on TF32 tensor cores for the
    control."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return (a.to(torch.float32) @ b.to(torch.float32)).to(F64)
    return a @ b


# -- the model -----------------------------------------------------------------

@dataclass
class Gmm:
    means: torch.Tensor  # (P, G, D) float64
    inv_vars: torch.Tensor
    gconsts: torch.Tensor  # (P, G)


def _gmm(means: np.ndarray, inv_vars: np.ndarray, device) -> Gmm:
    m = torch.as_tensor(means, dtype=F64, device=device)
    iv = torch.as_tensor(inv_vars, dtype=F64, device=device)
    G, D = m.shape[1], m.shape[2]
    gc = (math.log(1.0 / G) + 0.5 * (torch.log(iv).sum(-1) - D * math.log(2 * math.pi)
                                      - (m * m * iv).sum(-1)))
    return Gmm(m, iv, gc)


def loglikes(x: torch.Tensor, gmm: Gmm, pdfs: torch.Tensor, precision: str) -> torch.Tensor:
    """(T, len(pdfs)) log-likelihoods of the frames ``x`` under the listed
    pdfs: the quadratic form as one product of [x^2, x, 1] with each
    Gaussian's coefficients, then a log-sum-exp over Gaussians."""
    m, iv, gc = gmm.means[pdfs], gmm.inv_vars[pdfs], gmm.gconsts[pdfs]
    J, G, D = m.shape
    coef = torch.cat([-0.5 * iv, m * iv], dim=-1).reshape(J * G, 2 * D).T
    q = _mm(torch.cat([x * x, x], dim=1), coef, precision)
    return torch.logsumexp(q.reshape(-1, J, G) + gc[None], dim=-1)


@dataclass
class Model:
    cfg: dict
    final: Gmm
    si: Gmm
    lda: torch.Tensor  # (D, spliced)
    lexicon: Dict[str, List[int]]  # word -> phone ids


def load_model(cfg: dict, device) -> Model:
    p = model.draw_parameters(cfg)
    pid = {n: i for i, n in enumerate(model.phone_names(cfg))}
    lex = {w: [pid[x] for x in ph] for w, ph in model.draw_lexicon(cfg)}
    return Model(cfg, _gmm(p["means"], p["inv_vars"], device),
                 _gmm(p["si_means"], p["si_inv_vars"], device),
                 torch.as_tensor(p["lda"], dtype=F64, device=device), lex)


# -- the alignment graph ---------------------------------------------------------

def topology(cfg: dict, silence: bool) -> Tuple[List[List[Tuple[int, float]]], int]:
    """Each emitting state's transitions [(dst, probability)], dst == the
    state count meaning the exit: MFA's default topology (phones of 1 to
    ``phone_states`` frames: the first state fans out to the later states
    and the exit, the middle ones loop 0.5, the last exits; silence's first
    state loops and fans out, its middle states are ergodic over
    themselves and the last, which loops 0.75)."""
    t = cfg["topology"]
    if silence:
        n = t["silence_states"]
        states = [[(d, 1.0 / (n - 1)) for d in range(n - 1)]]
        states += [[(d, 1.0 / (n - 1)) for d in range(1, n)] for _ in range(1, n - 1)]
        states.append([(n - 1, 0.75), (n, 0.25)])
        return states, n
    n, lo = t["phone_states"], t["phone_min_states"]
    k = n - lo + 1
    states = [[(d, 1.0 / k) for d in range(1, k + 1)]]
    states += [[(i, 0.5), (i + 1, 0.5)] for i in range(1, n - 1)]
    states.append([(n, 1.0)])
    return states, n


def hmm_arcs(cfg: dict, silence: bool):
    """(internal arcs [(src, dst, weight)], exits [(src, weight)], states)
    with Kaldi's graph scaling: a self-loop weighs self_loop_scale x log
    p_self, any other arc transition_scale x log(p / (1 - p_self)) +
    self_loop_scale x log(1 - p_self)."""
    ts, sls = cfg["transition_scale"], cfg["self_loop_scale"]
    states, n = topology(cfg, silence)
    internal, exits = [], []
    for j, trans in enumerate(states):
        p_self = sum(p for d, p in trans if d == j)
        for d, p in trans:
            if d == j:
                w = sls * math.log(p)
            elif p_self > 0:
                w = ts * (math.log(p) - math.log(1 - p_self)) + sls * math.log(1 - p_self)
            else:
                w = ts * math.log(p)
            if d == n:
                exits.append((j, w))
            else:
                internal.append((j, d, w))
    return internal, exits, n


@dataclass
class Graph:
    pdf: np.ndarray  # (S,)
    key: np.ndarray  # (S,) instance key index into ``keys``
    # (word, phone position); silence (-1, 0) before the first word and
    # (-2 - w, 0) after word w
    keys: List[Tuple[int, int]]
    arcs: List[Tuple[int, int, float]]  # (src, dst, weight)
    start: Dict[int, float]
    final: Dict[int, float]

    @property
    def num_states(self) -> int:
        return len(self.pdf)


class _GraphParts:
    def __init__(self, cfg):
        self.cfg = cfg
        self.pdf, self.key = [], []
        self.keys: List[Tuple[int, int]] = []
        self.key_index: Dict[Tuple[int, int], int] = {}
        self.arcs, self.start, self.final = [], {}, {}
        self.phone_hmm = hmm_arcs(cfg, False)
        self.sil_hmm = hmm_arcs(cfg, True)

    def instance(self, phone: int, left: int, key: Tuple[int, int]):
        """A phone's states after the phone ``left``: (entry state, exits
        [(state, weight)])."""
        sil = phone == 1
        internal, exits, n = self.sil_hmm if sil else self.phone_hmm
        if key not in self.key_index:
            self.key_index[key] = len(self.keys)
            self.keys.append(key)
        base = len(self.pdf)
        for j in range(n):
            self.pdf.append(j if sil else model.pdf_id(self.cfg, phone, j, left))
            self.key.append(self.key_index[key])
        self.arcs += [(base + s, base + d, w) for s, d, w in internal]
        return base, [(base + s, w) for s, w in exits]

    def link(self, exits, entry, extra: float):
        self.arcs += [(s, entry, w + extra) for s, w in exits]

    def graph(self) -> Graph:
        return Graph(np.array(self.pdf), np.array(self.key), self.keys, self.arcs,
                     self.start, self.final)


def build_graph(cfg: dict, lexicon: Dict[str, List[int]], words: Sequence[str]) -> Graph:
    """The transcript's alignment graph: optional silence before the first
    word (probability ``initial_silence_probability``), after every word
    (``silence_probability``), each word's one pronunciation, each phone's
    pdfs after its left neighbour (none, silence or the previous phone)."""
    b = _GraphParts(cfg)
    lp_init, lp_sil = math.log(cfg["initial_silence_probability"]), math.log(cfg["silence_probability"])
    ln_init = math.log(1 - cfg["initial_silence_probability"])
    ln_sil = math.log(1 - cfg["silence_probability"])
    # frontier: [(left phone, [(exit state, weight)] or None for the start)]
    e, x = b.instance(1, 0, (-1, 0))
    b.start[e] = lp_init
    frontier = [(0, None, ln_init), (1, x, 0.0)]
    for wi, word in enumerate(words):
        phones = lexicon[word]
        out = []
        for left, exits, extra in frontier:
            entry, first = b.instance(phones[0], left, (wi, 0))
            if exits is None:
                b.start[entry] = extra
            else:
                b.link(exits, entry, extra)
            out += first
        for k in range(1, len(phones)):
            entry, nxt = b.instance(phones[k], phones[k - 1], (wi, k))
            b.link(out, entry, 0.0)
            out = nxt
        word_exits = out
        s_entry, s_out = b.instance(1, phones[-1], (-2 - wi, 0))
        b.link(word_exits, s_entry, lp_sil)
        if wi == len(words) - 1:
            for s, w in word_exits:
                b.final[s] = max(b.final.get(s, NEG), w + ln_sil)
            for s, w in s_out:
                b.final[s] = max(b.final.get(s, NEG), w)
        frontier = [(phones[-1], word_exits, ln_sil), (1, s_out, 0.0)]
    if not words:
        for s, w in x:
            b.final[s] = w
    return b.graph()


class GraphCounter:
    """(states, arcs, distinct pdfs) of a transcript's graph, for the work
    counts of the traced run."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        pid = {n: i for i, n in enumerate(model.phone_names(cfg))}
        self.lexicon = {w: [pid[x] for x in ph] for w, ph in model.draw_lexicon(cfg)}

    def count(self, words: Sequence[str]):
        g = build_graph(self.cfg, self.lexicon, words)
        return g.num_states, len(g.arcs), len(set(g.pdf.tolist()))


def _incoming(g: Graph):
    S = g.num_states
    src = [[] for _ in range(S)]
    for s, d, w in g.arcs:
        src[d].append((s, w))
    K = max(1, max(len(a) for a in src))
    in_src = np.zeros((S, K), np.int64)
    in_w = np.full((S, K), NEG)
    for d, lst in enumerate(src):
        for k, (s, w) in enumerate(lst):
            in_src[d, k], in_w[d, k] = s, w
    start = np.full(S, NEG)
    final = np.full(S, NEG)
    for s, w in g.start.items():
        start[s] = w
    for s, w in g.final.items():
        final[s] = w
    return in_src, in_w, start, final


def viterbi(emit_fns, lens: List[int], graphs: List[Graph], scale: float,
            device, block: int = 512):
    """Exact Viterbi of each utterance over its graph, all utterances in
    one batch; ``emit_fns[b](t0, t1)`` gives utterance b's (t1 - t0, S_b)
    emissions, asked for in blocks of frames. ([best score], [state path
    (T,) numpy])."""
    dev = device
    B = len(graphs)
    T = max(lens)
    S = max(g.num_states for g in graphs)
    inc = [_incoming(g) for g in graphs]
    K = max(i[0].shape[1] for i in inc)
    in_src = torch.zeros((B, S, K), dtype=torch.int64)
    in_w = torch.full((B, S, K), NEG, dtype=F64)
    start = torch.full((B, S), NEG, dtype=F64)
    final = torch.full((B, S), NEG, dtype=F64)
    for b, (s_, w_, st, fi) in enumerate(inc):
        n, k = s_.shape
        in_src[b, :n, :k] = torch.from_numpy(s_)
        in_w[b, :n, :k] = torch.from_numpy(w_)
        start[b, :n], final[b, :n] = torch.from_numpy(st), torch.from_numpy(fi)
    in_src, in_w = in_src.to(dev).reshape(B, S * K), in_w.to(dev)
    start, final = start.to(dev), final.to(dev)
    lens_t = torch.tensor(lens, device=dev)
    back = torch.zeros((T, B, S), dtype=torch.uint8, device=dev)
    alpha = None
    for t0 in range(0, T, block):
        t1 = min(T, t0 + block)
        em = torch.full((B, t1 - t0, S), NEG, dtype=F64, device=dev)
        for b, fn in enumerate(emit_fns):
            if t0 < lens[b]:
                e = fn(t0, min(t1, lens[b]))
                em[b, : e.shape[0], : e.shape[1]] = scale * e
        for t in range(t0, t1):
            if t == 0:
                alpha = start + em[:, 0]
                continue
            cand = alpha.gather(1, in_src).reshape(B, S, K) + in_w
            best, arg = cand.max(dim=2)
            back[t] = arg.to(torch.uint8)
            alpha = torch.where((t < lens_t)[:, None], best + em[:, t - t0], alpha)
    score, state = (alpha + final).max(dim=1)
    back = back.cpu().numpy()
    src = in_src.reshape(B, S, K).cpu().numpy()
    score, state = score.cpu().numpy(), state.cpu().numpy()
    paths = []
    for b, n in enumerate(lens):
        path = np.empty(n, np.int64)
        s = int(state[b])
        for t in range(n - 1, 0, -1):
            path[t] = s
            s = int(src[b, s, back[t, b, s]])
        path[0] = s
        paths.append(path)
    return [float(x) for x in score], paths


# -- fMLLR -----------------------------------------------------------------------

def _bmm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return torch.bmm(a.to(torch.float32), b.to(torch.float32)).to(F64)
    return torch.bmm(a, b)


def fmllr_stats(x: torch.Tensor, pdf: torch.Tensor, weight: torch.Tensor, gmm: Gmm,
                precision: str = "float64", chunk: int = 4096):
    """Kaldi ``gmm-est-fmllr``'s statistics of frames ``x`` aligned to
    ``pdf`` with frame weights: (K (D, D+1), G (D, D+1, D+1), beta). Each
    frame's products over its pdf's Gaussians (the quadratic form and the
    posterior-weighted sums) in ``precision``; the sums over frames in
    float64."""
    T, D = x.shape
    K = torch.zeros((D, D + 1), dtype=F64, device=x.device)
    G = torch.zeros((D, (D + 1) ** 2), dtype=F64, device=x.device)
    beta = 0.0
    for t0 in range(0, T, chunk):
        xs, p, wt = x[t0:t0 + chunk], pdf[t0:t0 + chunk], weight[t0:t0 + chunk]
        m, iv, gc = gmm.means[p], gmm.inv_vars[p], gmm.gconsts[p]  # (t, G, D)
        miv = m * iv
        q = gc + (_bmm(miv, xs[:, :, None], precision)
                  - 0.5 * _bmm(iv, (xs * xs)[:, :, None], precision))[..., 0]
        post = torch.softmax(q, dim=-1) * wt[:, None]  # (t, G)
        xp = torch.cat([xs, torch.ones_like(xs[:, :1])], dim=1)  # (t, D+1)
        K += _bmm(post[:, None, :], miv, precision)[:, 0].T @ xp
        outer = (xp[:, :, None] * xp[:, None, :]).reshape(len(xs), -1)
        G += _bmm(post[:, None, :], iv, precision)[:, 0].T @ outer
        beta += float(post.sum())
    return K, G.reshape(D, D + 1, D + 1), beta


def fmllr_objective(W: np.ndarray, K: np.ndarray, G: np.ndarray, beta: float) -> float:
    """Kaldi's fMLLR auxiliary function of the transform ``W`` (D, D+1)
    under the statistics (K, G, beta): beta log|det A| + sum_d (w_d . k_d
    - w_d G_d w_d / 2)."""
    W = np.asarray(W, np.float64)
    D = W.shape[0]
    logdet = np.linalg.slogdet(W[:, :D])[1]
    quad = np.einsum("di,dij,dj->", W, G, W)
    return float(beta * logdet + np.sum(W * K) - 0.5 * quad)


def fmllr_solve(K: np.ndarray, G: np.ndarray, beta: float, iters: int) -> np.ndarray:
    """Kaldi's row-by-row fMLLR (``ComputeFmllrMatrixDiagGmmFull``): each
    row in turn set to the optimum along its cofactor direction, from the
    identity, ``iters`` sweeps. (D, D+1) float64."""
    D = K.shape[0]
    W = np.hstack([np.eye(D), np.zeros((D, 1))])
    inv_g = [np.linalg.inv(G[d]) for d in range(D)]
    for _ in range(iters):
        for d in range(D):
            A = W[:, :D]
            c = np.append(np.linalg.inv(A).T[d] * np.linalg.det(A), 0.0)
            cg = c @ inv_g[d]
            a, b = cg @ c, cg @ K[d]
            disc = b * b + 4 * a * beta
            roots = [(-b + s * math.sqrt(disc)) / (2 * a) for s in (1, -1)]

            def objf(alpha):
                w = (K[d] + alpha * c) @ inv_g[d]
                return beta * math.log(abs(w @ c)) - 0.5 * w @ G[d] @ w + w @ K[d]

            alpha = max(roots, key=objf)
            W[d] = (K[d] + alpha * c) @ inv_g[d]
    return W


# -- a speaker, end to end ---------------------------------------------------------

@dataclass
class UttResult:
    score: float
    frames: int
    words: List[str]  # in the path's order
    segments: List[Tuple[Tuple[int, int], int, int]]  # (key, first frame, end frame)


def _intervals(g: Graph, path: np.ndarray, words: Sequence[str]):
    """A state path's words and its segments (a run of one instance key)."""
    keys = g.key[path]
    cut = np.flatnonzero(np.diff(keys)) + 1
    segments = [(g.keys[keys[a]], int(a), int(b))
                for a, b in zip(np.r_[0, cut], np.r_[cut, len(path)])]
    seen = sorted({k[0] for k, _a, _b in segments if k[0] >= 0})
    return [words[i] for i in seen], segments


@dataclass
class SpeakerResult:
    utts: List[UttResult]  # the adapted pass's best paths
    transform: np.ndarray  # (D, D+1): the reference's own estimate
    constrained: Optional[List[float]]  # best scores through the given segmentations
    stats: Tuple[np.ndarray, np.ndarray, float]  # (K, G, beta) of the SI pass


def align_speaker(m: Model, waves: List[np.ndarray], texts: List[List[str]],
                  precision: str = "float64", constrain: Optional[List[np.ndarray]] = None,
                  transform: Optional[np.ndarray] = None) -> SpeakerResult:
    """The two-pass alignment of one speaker's utterances: CMVN over the
    speaker, splice + LDA, the speaker-independent pass, fMLLR statistics
    from it under the final model (silence weighted 0), the solve, the
    adapted pass. With ``transform`` the adapted pass uses that transform
    in place of the reference's own estimate (which is returned all the
    same). With ``constrain`` (each utterance's segmentation as [(key,
    first frame, end frame)], keys as :class:`Graph` names them) the
    adapted pass runs once more restricted to it: the best score of a path
    through exactly that segmentation.""" 
    cfg = m.cfg
    dev = m.lda.device
    with _precision(precision):
        raw = [mfcc(w, dev) for w in waves]
        total = sum(r.sum(0) for r in raw)
        mean = total / sum(r.shape[0] for r in raw)
        feats = [_mm(splice(r - mean, cfg["splice_left"], cfg["splice_right"]), m.lda.T, precision)
                 for r in raw]
        graphs = [build_graph(cfg, m.lexicon, t) for t in texts]
        pdfs = [torch.as_tensor(g.pdf, device=dev) for g in graphs]
        scale = cfg["acoustic_scale"]

        lens = [x.shape[0] for x in feats]

        def emissions(xs, gmm, masks=None):
            fns = []
            for i, (x, p) in enumerate(zip(xs, pdfs)):
                uniq, inv = torch.unique(p, return_inverse=True)

                def fn(t0, t1, x=x, uniq=uniq, inv=inv, i=i):
                    e = loglikes(x[t0:t1], gmm, uniq, precision)[:, inv]
                    if masks is not None:
                        e = e.masked_fill(masks[i][t0:t1], NEG)
                    return e
                fns.append(fn)
            return fns

        _, si_paths = viterbi(emissions(feats, m.si), lens, graphs, scale, dev)
        D = feats[0].shape[1]
        K = torch.zeros((D, D + 1), dtype=F64, device=dev)
        G = torch.zeros((D, D + 1, D + 1), dtype=F64, device=dev)
        beta = 0.0
        n_sil = cfg["topology"]["silence_states"]
        for x, p, path in zip(feats, pdfs, si_paths):
            pdf = p[torch.as_tensor(path, device=dev)]
            k, g, bt = fmllr_stats(x, pdf, (pdf >= n_sil).to(F64), m.final, precision)
            K, G, beta = K + k, G + g, beta + bt
        stats = (K.cpu().numpy(), G.cpu().numpy(), beta)
        if beta >= cfg["fmllr_min_count"]:
            W = fmllr_solve(*stats, cfg["fmllr_iterations"])
        else:
            W = np.hstack([np.eye(D), np.zeros((D, 1))])
        Wt = torch.as_tensor(W if transform is None else transform, dtype=F64, device=dev)
        adapted = [_mm(x, Wt[:, :D].T, precision) + Wt[:, D] for x in feats]
        scores, paths = viterbi(emissions(adapted, m.final), lens, graphs, scale, dev)
        constrained = None
        if constrain is not None:
            masks = [torch.as_tensor(g.key, device=dev)[None, :]
                     != torch.as_tensor(_key_frames(g, c, n), device=dev)[:, None]
                     for g, c, n in zip(graphs, constrain, lens)]
            constrained, _ = viterbi(emissions(adapted, m.final, masks), lens, graphs,
                                     scale, dev)
    results = []
    for g, path, sc, t in zip(graphs, paths, scores, texts):
        words, segments = _intervals(g, path, t)
        results.append(UttResult(sc, len(path), words, segments))
    return SpeakerResult(results, W, constrained, stats)


def _key_frames(g: Graph, segments, frames: int) -> np.ndarray:
    """Each frame's instance-key index in ``g`` from [(key, first frame,
    end frame)]; -1 where no segment or an unknown key covers a frame."""
    index = {k: i for i, k in enumerate(g.keys)}
    out = np.full(frames, -1, np.int64)
    for key, a, b in segments:
        out[max(a, 0):min(b, frames)] = index.get(tuple(key), -1)
    return out
