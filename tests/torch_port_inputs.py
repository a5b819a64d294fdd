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
