"""Inputs for the port's kernel tests, made with numpy from a seed (no JAX,
so the card's tests can import them where JAX is not installed)."""

import numpy as np

NEG_INF = -1.0e30


def band_inputs(seed, B, T, S, lb, ub, ties=True):
    """Graph-like band inputs: self-loops everywhere, sparse forward and
    backward arcs. With ``ties``, integer emissions and band weights make
    many candidates exactly equal; without, emissions are random floats."""
    rng = np.random.RandomState(seed)
    D = lb + ub + 1
    band = np.full((B, S, D), NEG_INF, np.float32)
    band[:, :, lb] = -1.0  # self-loop
    band[:, 1:, lb + 1] = -1.0  # next state
    sparse = rng.rand(B, S, D) < 0.15
    band[sparse] = -rng.randint(1, 4, size=int(sparse.sum())).astype(np.float32)
    start = np.full((B, S), NEG_INF, np.float32)
    start[:, : min(3, S)] = 0.0
    final = np.full((B, S), NEG_INF, np.float32)
    final[:, S - 5 :] = -rng.randint(0, 3, size=(B, 5)).astype(np.float32)
    if ties:
        emit = rng.randint(-20, 1, size=(B, T, S)).astype(np.float32)
    else:
        emit = (rng.randn(B, T, S) * 5).astype(np.float32)
    flens = np.array([T, T - 3, 2, 1][:B], np.int32)
    return emit, band, start, final, flens


def backtrace_inputs(seed, T, B, S, lb, ub):
    """Random backpointers (T, B, S) uint8 in [0, lb + ub], frame lengths
    starting T, 1, 2 (then T + 5, past T, and random ones) and start states
    near 0 but the last, S - 1. Random slots walk states down by about
    (ub - lb) / 2 a frame, out of [0, S), and +lb a frame back in. Rows
    t = 0 and t >= flens, which K1 never writes, hold 255 junk."""
    rng = np.random.RandomState(seed)
    bp = rng.randint(0, lb + ub + 1, size=(T, B, S)).astype(np.uint8)
    flens = rng.randint(1, T + 1, size=B).astype(np.int32)
    flens[:4] = [T, 1, 2, T + 5][:B]
    bp[0] = 255
    for b in range(B):
        bp[flens[b]:, b] = 255
    best = rng.randint(0, min(S, 40), size=B).astype(np.int32)
    best[-1] = S - 1
    return bp, flens, best


def leaves_range_across_chunks(states, flens, S, frames):
    """Whether some row's walk is outside [0, S) at a frame of one chunk of
    ``frames`` frames (counted back from the row's last frame) and first
    comes back into range in a later chunk."""
    B, T = states.shape
    for b in range(B):
        L = max(min(int(flens[b]), T), 1)
        left = None  # chunk where the current out-of-range run began
        for t in range(L - 1, -1, -1):
            chunk = (L - 1 - t) // frames
            inside = 0 <= states[b, t] < S
            if not inside and left is None:
                left = chunk
            elif inside and left is not None:
                if chunk > left:
                    return True
                left = None
    return False


def fmllr_inputs(seed, B=5, T=60, D=13, P=20, G=4, num_speakers=4):
    """Arguments of ``accumulate_fmllr_stats`` for B utterances over the
    first min(3, S) speakers (speaker 3 has none; 0 has two), with padded
    frames, a pdf with padded Gaussians, and frame weights of 0 and 1."""
    rng = np.random.RandomState(seed)
    miv, inv_vars, gconsts = gmm_arrays(seed, P, G, D, padded_pdfs=(2,))
    means = (miv / inv_vars).astype(np.float32)
    flens = rng.randint(T // 2, T + 1, size=B).astype(np.int32)
    flens[0] = T
    feats = (rng.randn(B, T, D) * 2).astype(np.float32)
    frame_pdf = rng.randint(0, P, (B, T)).astype(np.int32)
    weight = (rng.rand(B, T) > 0.25).astype(np.float32)
    spk = (np.arange(B) % min(3, num_speakers)).astype(np.int64)
    return dict(feats=feats, flens=flens, frame_pdf=frame_pdf, spk=spk,
                weight=weight, means=means, inv_vars=inv_vars, gconsts=gconsts,
                miv=miv, num_speakers=num_speakers)


def fmllr_system(seed, S, D, NG=4):
    """(K, G, beta) float64 of S speakers from multi-Gaussian posteriors
    (Kaldi ``gmm-est-fmllr`` semantics; rank > 1 keeps each row sweep away
    from the tie where both quadratic roots score equally)."""
    rng = np.random.RandomState(seed)
    E = D + 1
    K = np.zeros((S, D, E))
    G = np.zeros((S, D, E, E))
    beta = np.zeros(S)
    for s in range(S):
        n = 600 + 50 * s
        x = rng.randn(n, D) * (1.0 + 0.2 * s) + 0.4 * (s + 1)
        mus = rng.randn(NG, D) * 2.0
        ivs = 1.0 / (0.5 + rng.rand(NG, D))
        xp = np.hstack([x, np.ones((n, 1))])
        post = rng.rand(n, NG)
        post /= post.sum(axis=1, keepdims=True)
        K[s] = np.einsum("ng,gd,ne->de", post, ivs * mus, xp)
        wsum = np.einsum("ng,ne,nf->gef", post, xp, xp)
        G[s] = np.einsum("gd,gef->def", ivs, wsum)
        beta[s] = post.sum()
    return K, G, beta


def gmm_arrays(seed, P, G, D, padded_pdfs=()):
    rng = np.random.RandomState(seed)
    means = (rng.randn(P, G, D) * 2).astype(np.float32)
    inv_vars = (1.0 / np.maximum(rng.gamma(4.0, 0.25, (P, G, D)), 0.1)).astype(
        np.float32
    )
    gconsts = (
        np.log(1.0 / G)
        - 0.5 * (D * np.log(2 * np.pi) - np.log(inv_vars).sum(-1)
                 + (means * means * inv_vars).sum(-1))
    ).astype(np.float32)
    for p in padded_pdfs:  # a pdf keeps at least one real Gaussian
        gconsts[p, max(1, G // 2) :] = -np.inf
    return (means * inv_vars).astype(np.float32), inv_vars, gconsts


def train_batch_inputs(seed, B=5, T=50, D=6, P=9, G=4):
    """One training batch: features, frame lengths (row 1 zero-length, the
    others random), per-frame pdfs (pdf P - 1 never aligned) and a model
    whose pdf 2 has padded Gaussians; W (2D, P*G) in the likelihood layout
    and the (P, G, D) tensors it is made of."""
    rng = np.random.RandomState(seed)
    miv, inv_vars, gconsts = gmm_arrays(seed, P, G, D, padded_pdfs=(2,))
    W = np.concatenate(
        [miv.reshape(P * G, D), -0.5 * inv_vars.reshape(P * G, D)], axis=1
    ).T.astype(np.float32)
    flens = rng.randint(T // 3, T + 1, size=B).astype(np.int32)
    flens[0] = T
    flens[1] = 0
    feats = (rng.randn(B, T, D) * 2 + 0.5).astype(np.float32)
    frame_pdf = rng.randint(0, P - 1, (B, T)).astype(np.int32)
    return dict(feats=feats, flens=flens, frame_pdf=frame_pdf, W=W, miv=miv,
                inv_vars=inv_vars, gconsts=gconsts, P=P, G=G, D=D)


def segment_inputs(seed, n=3000, num_segments=7, F=5):
    """Rows with segment ids: one segment holding most rows (over a hundred
    tiles), one empty, some ids out of range (dropped)."""
    rng = np.random.RandomState(seed)
    seg = rng.randint(0, num_segments, size=n)
    seg[rng.rand(n) < 0.6] = 0
    seg[seg == 3] = 4
    seg[rng.rand(n) < 0.05] = num_segments  # dropped
    vals = (rng.randn(n, F) * 3).astype(np.float32)
    return seg.astype(np.int64), vals


def split_schedule_inputs(seed, P=6, G=4, D=5):
    """A post-MLE model state for mixing-up: weights, counts (pdf 1 with one
    Gaussian, pdf 4 full) and an occupancy that makes several pdfs split."""
    rng = np.random.RandomState(seed)
    num_gauss = np.array([2, 1, 3, 2, 4, 2][:P], np.int32)
    w = rng.rand(P, G)
    w[np.arange(G)[None, :] >= num_gauss[:, None]] = 0.0
    w /= w.sum(axis=1, keepdims=True)
    occ = rng.rand(P, G) * 200 * (np.arange(G)[None, :] < num_gauss[:, None])
    return w, num_gauss, occ


def tree_event_inputs(seed, num_phones=9, n_utts=40, dim=4):
    """Triphone events (left, center, right, pdf-class) from random phone
    strings, each with Gaussian statistics: (events {key: (count, sum,
    sumsq)}, phone groups)."""
    rng = np.random.RandomState(seed)
    events = {}
    for _ in range(n_utts):
        seq = [1] + list(rng.randint(2, num_phones + 1, rng.randint(3, 9))) + [1]
        for i, c in enumerate(seq):
            left = seq[i - 1] if i else 0
            right = seq[i + 1] if i + 1 < len(seq) else 0
            for cls in range(3):
                key = (int(left), int(c), int(right), cls)
                n = float(rng.randint(2, 20))
                m = rng.randn(dim) + 0.3 * c + cls
                s, ss = m * n, (m * m + rng.rand(dim) + 0.5) * n
                if key in events:
                    a = events[key]
                    events[key] = (a[0] + n, a[1] + s, a[2] + ss)
                else:
                    events[key] = (n, s, ss)
    groups = [[p] for p in range(1, num_phones + 1)]
    return events, groups
