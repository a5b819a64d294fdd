"""Clustering for speaker diarization (numpy implementations).

Behavioral spec: reference ``diarization/multiprocessing.py:245-465``
(``cluster_matrix``: affinity/agglomerative/spectral/dbscan/hdbscan/optics/
kmeans/meanshift over cosine/euclidean/PLDA distances, with an automatic
distance threshold from the knee of the k-NN distance curve,
``calculate_distance_threshold`` ``:174``). sklearn/hdbscan/kneed are not
baked into this image; every algorithm is implemented directly in numpy —
all are small host-side computations next to i-vector extraction (the
pairwise-distance matmuls are the only O(N²·d) part and vectorize fine).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple, Union

import numpy as np

from montreal_forced_aligner_tpu_torch.data import ClusterType, DistanceMetric

logger = logging.getLogger("mfa_tpu")


def cosine_distance_matrix(x: np.ndarray) -> np.ndarray:
    n = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-10)
    return 1.0 - n @ n.T


def agglomerative_cluster(
    distances: np.ndarray,
    num_clusters: Optional[int] = None,
    threshold: Optional[float] = None,
) -> np.ndarray:
    """Average-linkage agglomerative clustering on a distance matrix.

    Stops at ``num_clusters`` clusters, or when the closest pair exceeds
    ``threshold`` (one of the two must be given).
    """
    if num_clusters is None and threshold is None:
        raise ValueError("need num_clusters or threshold")
    N = distances.shape[0]
    D = distances.astype(np.float64).copy()
    np.fill_diagonal(D, np.inf)
    active = list(range(N))
    members = {i: [i] for i in range(N)}
    while len(active) > (num_clusters or 1):
        sub = D[np.ix_(active, active)]
        flat = np.argmin(sub)
        i_loc, j_loc = divmod(flat, len(active))
        if i_loc == j_loc:
            break
        d_min = sub[i_loc, j_loc]
        if threshold is not None and d_min > threshold:
            break
        a, b = active[i_loc], active[j_loc]
        # average-link update into a
        na, nb = len(members[a]), len(members[b])
        for k in active:
            if k in (a, b):
                continue
            D[a, k] = D[k, a] = (na * D[a, k] + nb * D[b, k]) / (na + nb)
        members[a].extend(members[b])
        del members[b]
        active.remove(b)
        D[b, :] = np.inf
        D[:, b] = np.inf
    labels = np.zeros(N, dtype=np.int32)
    for ci, (root, mem) in enumerate(sorted(members.items())):
        for m in mem:
            labels[m] = ci
    return labels


def kmeans_cluster(
    x: np.ndarray, k: int, num_iters: int = 50, seed: int = 0
) -> np.ndarray:
    rng = np.random.RandomState(seed)
    N = len(x)
    # k-means++ init
    centers = [x[rng.randint(N)]]
    for _ in range(1, k):
        d2 = np.min(
            [np.sum((x - c) ** 2, axis=1) for c in centers], axis=0
        )
        probs = d2 / max(d2.sum(), 1e-10)
        centers.append(x[rng.choice(N, p=probs)])
    C = np.stack(centers)
    labels = np.zeros(N, np.int32)
    for _ in range(num_iters):
        d = ((x[:, None, :] - C[None, :, :]) ** 2).sum(axis=2)
        new_labels = d.argmin(axis=1).astype(np.int32)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for c in range(k):
            sel = labels == c
            if sel.any():
                C[c] = x[sel].mean(axis=0)
    return labels


# ---------------------------------------------------------------------------
# Distance utilities
# ---------------------------------------------------------------------------


def euclidean_distance_matrix(x: np.ndarray) -> np.ndarray:
    sq = np.sum(x * x, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    np.maximum(d2, 0.0, out=d2)
    return np.sqrt(d2)


def _distance_matrix(
    x: np.ndarray,
    metric: Union[str, DistanceMetric] = "euclidean",
    plda=None,
) -> np.ndarray:
    """Pairwise distance matrix under the named metric.

    ``cosine`` follows the reference's convention of L2-normalizing and
    using euclidean distance (``multiprocessing.py:296-299``); ``plda``
    converts symmetric log-likelihood-ratio scores to distances.
    """
    metric = DistanceMetric(metric) if not isinstance(metric, DistanceMetric) else metric
    if metric is DistanceMetric.cosine:
        n = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-10)
        return euclidean_distance_matrix(n)
    if metric is DistanceMetric.plda:
        if plda is None:
            raise ValueError("plda metric requires a trained Plda model")
        scores = plda.log_likelihood_ratio(x, x)
        d = -(scores + scores.T) / 2.0
        d -= d.min()
        np.fill_diagonal(d, 0.0)
        return d
    return euclidean_distance_matrix(x)


def calculate_distance_threshold(
    distances: np.ndarray, min_samples: int = 5
) -> float:
    """Automatic distance threshold: knee of the sorted k-NN distance curve.

    Reference ``diarization/multiprocessing.py:174-244`` fits a
    ``NearestNeighbors`` model, takes each point's distance to its
    ``min_samples``-th neighbor, sorts them, and finds the knee with
    ``kneed.KneeLocator(curve="concave")``. The kneedle criterion for a
    concave increasing curve is the maximum of the difference between the
    normalized curve and the identity.
    """
    N = distances.shape[0]
    k = min(min_samples, N - 1)
    if k < 1:
        return float(distances.max() if distances.size else 0.0)
    part = np.partition(distances, k, axis=1)[:, k]  # k-th NN (excl. self)
    knn = np.sort(part)
    if knn[-1] <= knn[0]:
        return float(knn[-1])
    xn = np.arange(N) / max(N - 1, 1)
    yn = (knn - knn[0]) / (knn[-1] - knn[0])
    # kneedle: knee of a concave curve is max(y - x); elbow of a convex
    # curve (the usual DBSCAN k-distance shape: slow rise then a jump) is
    # max(x - y). The reference calls KneeLocator(curve="concave"); taking
    # whichever deviation dominates handles both shapes robustly.
    diff = yn - xn
    idx = int(np.argmax(diff)) if diff.max() >= -diff.min() else int(np.argmin(diff))
    threshold = float(knn[idx])
    logger.debug(
        "Distance threshold set to %.4f (k-NN range %.4f - %.4f)",
        threshold, knn[0], knn[-1],
    )
    return threshold


def silhouette_score(distances: np.ndarray, labels: np.ndarray) -> float:
    """Mean silhouette coefficient over all points from a distance matrix
    (the reference logs this after clustering,
    ``multiprocessing.py:443-452``)."""
    labels = np.asarray(labels)
    uniq = np.unique(labels[labels >= 0])
    if uniq.shape[0] < 2:
        raise ValueError("silhouette requires >= 2 clusters")
    N = distances.shape[0]
    sil = []
    masks = {c: labels == c for c in uniq}
    for i in range(N):
        c = labels[i]
        if c < 0:
            continue
        own = masks[c].copy()
        own[i] = False
        n_own = own.sum()
        a = distances[i, own].mean() if n_own else 0.0
        b = np.inf
        for c2 in uniq:
            if c2 == c:
                continue
            b = min(b, distances[i, masks[c2]].mean())
        denom = max(a, b)
        sil.append(0.0 if denom == 0 else (b - a) / denom)
    return float(np.mean(sil)) if sil else 0.0


# ---------------------------------------------------------------------------
# Density-based clustering (DBSCAN / OPTICS / HDBSCAN)
# ---------------------------------------------------------------------------


def dbscan_cluster(
    distances: np.ndarray, eps: float, min_samples: int = 5
) -> np.ndarray:
    """DBSCAN over a precomputed distance matrix; noise points get -1
    (reference uses ``sklearn.cluster.DBSCAN``,
    ``multiprocessing.py:360-378``)."""
    N = distances.shape[0]
    neighbor = distances <= eps  # includes self
    n_neighbors = neighbor.sum(axis=1)
    core = n_neighbors >= min_samples
    labels = np.full(N, -1, dtype=np.int32)
    cluster_id = 0
    for seed in range(N):
        if labels[seed] != -1 or not core[seed]:
            continue
        # BFS over density-reachable points
        labels[seed] = cluster_id
        frontier = [seed]
        while frontier:
            p = frontier.pop()
            if not core[p]:
                continue
            for q in np.nonzero(neighbor[p])[0]:
                if labels[q] == -1:
                    labels[q] = cluster_id
                    if core[q]:
                        frontier.append(q)
        cluster_id += 1
    return labels


def optics_cluster(
    distances: np.ndarray, max_eps: float, min_samples: int = 5
) -> np.ndarray:
    """OPTICS ordering + reachability, extracted with a DBSCAN-style cut at
    ``max_eps`` (reference runs ``sklearn.cluster.OPTICS(max_eps=eps)``,
    ``multiprocessing.py:417-439``; the eps-cut extraction is equivalent to
    DBSCAN at that radius up to border-point assignment)."""
    N = distances.shape[0]
    k = min(min_samples, N)
    core_dist = np.sort(distances, axis=1)[:, k - 1]  # self included as in sklearn
    core_dist = np.where(core_dist <= max_eps, core_dist, np.inf)
    processed = np.zeros(N, dtype=bool)
    order = []
    reach = np.full(N, np.inf)
    for start in range(N):
        if processed[start]:
            continue
        processed[start] = True
        order.append(start)
        seeds: dict = {}
        if np.isfinite(core_dist[start]):
            newr = np.maximum(core_dist[start], distances[start])
            for q in range(N):
                if not processed[q] and distances[start, q] <= max_eps:
                    if newr[q] < seeds.get(q, np.inf):
                        seeds[q] = newr[q]
        while seeds:
            p = min(seeds, key=seeds.get)
            reach[p] = seeds.pop(p)
            processed[p] = True
            order.append(p)
            if np.isfinite(core_dist[p]):
                newr = np.maximum(core_dist[p], distances[p])
                for q in range(N):
                    if not processed[q] and distances[p, q] <= max_eps:
                        if newr[q] < seeds.get(q, np.inf):
                            seeds[q] = newr[q]
    # eps-cut extraction along the ordering
    labels = np.full(N, -1, dtype=np.int32)
    cluster_id = -1
    for p in order:
        if reach[p] > max_eps:
            if core_dist[p] <= max_eps:
                cluster_id += 1
                labels[p] = cluster_id
        else:
            labels[p] = cluster_id
    return labels


def hdbscan_cluster(
    distances: np.ndarray,
    min_cluster_size: int = 15,
    min_samples: Optional[int] = None,
    cluster_selection_epsilon: float = 0.0,
) -> np.ndarray:
    """HDBSCAN-style density clustering over a distance matrix.

    Follows the published algorithm (Campello et al.): mutual-reachability
    distances from ``min_samples`` core distances, a single-linkage MST
    hierarchy, and leaf extraction keeping components of at least
    ``min_cluster_size`` that persist below ``cluster_selection_epsilon``
    (reference call: ``hdbscan.HDBSCAN(min_samples, min_cluster_size,
    cluster_selection_epsilon)``, ``multiprocessing.py:384-416``). This
    implementation cuts the MST at the epsilon level and keeps
    sufficiently large components — HDBSCAN's behavior when a selection
    epsilon dominates stability selection.
    """
    N = distances.shape[0]
    if min_samples is None:
        min_samples = max(5, int(min_cluster_size / 4))
    k = min(min_samples, N)
    core = np.sort(distances, axis=1)[:, k - 1]
    mreach = np.maximum(np.maximum(core[:, None], core[None, :]), distances)
    # Prim's MST over mutual reachability
    in_tree = np.zeros(N, dtype=bool)
    in_tree[0] = True
    best = mreach[0].copy()
    best_from = np.zeros(N, dtype=np.int64)
    edges = []  # (weight, u, v)
    for _ in range(N - 1):
        cand = np.where(in_tree, np.inf, best)
        v = int(np.argmin(cand))
        edges.append((best[v], int(best_from[v]), v))
        in_tree[v] = True
        upd = mreach[v] < best
        best = np.where(upd, mreach[v], best)
        best_from = np.where(upd, v, best_from)
    if cluster_selection_epsilon <= 0.0:
        # choose the cut that maximizes the number of >= min_cluster_size
        # components (coarse stand-in for stability selection)
        weights = sorted({w for w, _, _ in edges})
        best_labels, best_count = None, 0
        for w in weights:
            lab = _components_below(edges, N, w, min_cluster_size)
            cnt = lab.max() + 1
            if cnt > best_count:
                best_count, best_labels = cnt, lab
        return best_labels if best_labels is not None else np.full(N, -1, np.int32)
    return _components_below(edges, N, cluster_selection_epsilon, min_cluster_size)


def _components_below(edges, N, eps, min_cluster_size) -> np.ndarray:
    """Union-find components using MST edges with weight <= eps; components
    smaller than min_cluster_size become noise (-1)."""
    parent = np.arange(N)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for w, u, v in edges:
        if w <= eps:
            ru, rv = find(u), find(v)
            if ru != rv:
                parent[ru] = rv
    roots = np.array([find(i) for i in range(N)])
    labels = np.full(N, -1, dtype=np.int32)
    cid = 0
    for r in np.unique(roots):
        members = roots == r
        if members.sum() >= min_cluster_size:
            labels[members] = cid
            cid += 1
    return labels


# ---------------------------------------------------------------------------
# Spectral / affinity propagation / mean shift
# ---------------------------------------------------------------------------


def spectral_cluster(
    x: np.ndarray,
    num_clusters: int,
    n_neighbors: int = 10,
    metric: Union[str, DistanceMetric] = "euclidean",
    plda=None,
    seed: int = 0,
) -> np.ndarray:
    """Normalized spectral clustering (Ng-Jordan-Weiss) on a k-NN affinity
    graph (reference: ``sklearn.cluster.SpectralClustering(
    affinity="nearest_neighbors")``, ``multiprocessing.py:340-359``)."""
    D = _distance_matrix(x, metric, plda)
    N = D.shape[0]
    k = min(n_neighbors, N - 1)
    # symmetric k-NN connectivity affinity (sklearn convention: 0.5*(A+A^T)
    # of the binary kNN graph)
    A = np.zeros((N, N))
    nn = np.argsort(D, axis=1)[:, 1 : k + 1]
    rows = np.repeat(np.arange(N), k)
    A[rows, nn.ravel()] = 1.0
    A = 0.5 * (A + A.T)
    deg = A.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-10))
    L = np.eye(N) - (d_inv_sqrt[:, None] * A * d_inv_sqrt[None, :])
    vals, vecs = np.linalg.eigh(L)
    emb = vecs[:, :num_clusters]
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    emb = emb / np.maximum(norms, 1e-10)
    return kmeans_cluster(emb, num_clusters, seed=seed)


def affinity_propagation_cluster(
    similarities: np.ndarray,
    damping: float = 0.5,
    max_iter: int = 200,
    convergence_iter: int = 15,
    preference: Optional[float] = None,
) -> np.ndarray:
    """Affinity propagation (Frey & Dueck) over a similarity matrix
    (reference: ``sklearn.cluster.AffinityPropagation``,
    ``multiprocessing.py:300-320``; similarity = negative squared distance,
    preference = median similarity)."""
    S = similarities.astype(np.float64).copy()
    N = S.shape[0]
    if preference is None:
        preference = np.median(S[~np.eye(N, dtype=bool)])
    np.fill_diagonal(S, preference)
    # tiny symmetric noise as in sklearn to break degeneracies
    rng = np.random.RandomState(0)
    S += 1e-12 * rng.randn(N, N) * (S.max() - S.min() + 1e-12)
    R = np.zeros((N, N))
    A = np.zeros((N, N))
    idx = np.arange(N)
    stable = 0
    last_exemplars: Optional[np.ndarray] = None
    for _ in range(max_iter):
        AS = A + S
        first = AS.max(axis=1)
        first_arg = AS.argmax(axis=1)
        AS[idx, first_arg] = -np.inf
        second = AS.max(axis=1)
        Rnew = S - first[:, None]
        Rnew[idx, first_arg] = S[idx, first_arg] - second
        R = damping * R + (1 - damping) * Rnew
        Rp = np.maximum(R, 0)
        np.fill_diagonal(Rp, np.diag(R))
        Anew = Rp.sum(axis=0)[None, :] - Rp
        dA = np.diag(Anew).copy()
        Anew = np.minimum(Anew, 0)
        Anew[idx, idx] = dA
        A = damping * A + (1 - damping) * Anew
        exemplars = np.nonzero(np.diag(A + R) > 0)[0]
        if last_exemplars is not None and np.array_equal(exemplars, last_exemplars):
            stable += 1
            if stable >= convergence_iter:
                break
        else:
            stable = 0
        last_exemplars = exemplars
    exemplars = np.nonzero(np.diag(A + R) > 0)[0]
    if exemplars.size == 0:
        exemplars = np.array([int(np.argmax(np.diag(A + R)))])
    labels_ex = S[:, exemplars].argmax(axis=1)
    labels_ex[exemplars] = np.arange(exemplars.size)  # exemplars label themselves
    return labels_ex.astype(np.int32)


def meanshift_cluster(
    x: np.ndarray, bandwidth: Optional[float] = None, max_iter: int = 300
) -> np.ndarray:
    """Flat-kernel mean shift (reference: ``sklearn.cluster.MeanShift``,
    ``multiprocessing.py:379-383``); bandwidth defaults to the mean pairwise
    k-NN distance at k = N//10 (sklearn's ``estimate_bandwidth`` quantile
    0.3 analogue uses mean max-distance within a quantile neighborhood)."""
    N = x.shape[0]
    D = euclidean_distance_matrix(x)
    if bandwidth is None:
        k = max(1, int(N * 0.3))
        bandwidth = float(np.mean(np.sort(D, axis=1)[:, k]))
        if bandwidth <= 0:
            bandwidth = 1.0
    centers = x.astype(np.float64).copy()
    for _ in range(max_iter):
        Dc = (
            np.sum(centers * centers, axis=1)[:, None]
            + np.sum(x * x, axis=1)[None, :]
            - 2.0 * centers @ x.T
        )
        within = Dc <= bandwidth * bandwidth
        counts = within.sum(axis=1)
        new_centers = (within @ x) / np.maximum(counts[:, None], 1)
        if np.allclose(new_centers, centers, atol=1e-5 * bandwidth):
            centers = new_centers
            break
        centers = new_centers
    # merge centers within bandwidth, preferring denser ones
    order = np.argsort(-counts)
    uniq: list = []
    labels_of_center = np.zeros(N, dtype=np.int32)
    for ci in order:
        c = centers[ci]
        for ui, u in enumerate(uniq):
            if np.linalg.norm(c - u) < bandwidth:
                labels_of_center[ci] = ui
                break
        else:
            labels_of_center[ci] = len(uniq)
            uniq.append(c)
    U = np.stack(uniq)
    d = (
        np.sum(x * x, axis=1)[:, None]
        + np.sum(U * U, axis=1)[None, :]
        - 2.0 * x @ U.T
    )
    return d.argmin(axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# Dispatcher (reference ``cluster_matrix``, ``multiprocessing.py:245-465``)
# ---------------------------------------------------------------------------


def cluster_matrix(
    ivectors: np.ndarray,
    cluster_type: Union[str, ClusterType],
    metric: Union[str, DistanceMetric] = DistanceMetric.cosine,
    num_clusters: Optional[int] = None,
    distance_threshold: Optional[float] = None,
    min_cluster_size: int = 15,
    plda=None,
    strict: bool = False,
    seed: int = 0,
) -> np.ndarray:
    """Cluster i-vectors with the named algorithm; mirrors the reference's
    ``cluster_matrix`` dispatch, including the automatic distance threshold
    for the density methods and the post-hoc silhouette log."""
    cluster_type = (
        ClusterType(cluster_type)
        if not isinstance(cluster_type, ClusterType)
        else cluster_type
    )
    metric = DistanceMetric(metric) if not isinstance(metric, DistanceMetric) else metric
    x = np.asarray(ivectors, dtype=np.float64)
    if metric is DistanceMetric.cosine and cluster_type in (
        ClusterType.kmeans,
        ClusterType.meanshift,
        ClusterType.spectral,
        ClusterType.hdbscan,
    ):
        # reference convention: L2-normalize then use euclidean
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-10)
        metric = DistanceMetric.euclidean

    needs_matrix = cluster_type in (
        ClusterType.agglomerative,
        ClusterType.dbscan,
        ClusterType.hdbscan,
        ClusterType.optics,
        ClusterType.affinity,
    )
    D = _distance_matrix(x, metric, plda) if needs_matrix else None

    if cluster_type is ClusterType.kmeans:
        if num_clusters is None:
            raise ValueError("kmeans requires num_clusters")
        labels = kmeans_cluster(x, num_clusters, seed=seed)
    elif cluster_type is ClusterType.spectral:
        if num_clusters is None:
            raise ValueError("spectral requires num_clusters")
        labels = spectral_cluster(x, num_clusters, metric=metric, plda=plda, seed=seed)
    elif cluster_type is ClusterType.meanshift:
        labels = meanshift_cluster(x)
    elif cluster_type is ClusterType.agglomerative:
        if num_clusters is None and distance_threshold is None:
            distance_threshold = calculate_distance_threshold(D, min_cluster_size)
        labels = agglomerative_cluster(
            D, num_clusters=num_clusters, threshold=distance_threshold
        )
    elif cluster_type is ClusterType.dbscan:
        eps = distance_threshold or calculate_distance_threshold(D, min_cluster_size)
        labels = dbscan_cluster(D, eps=eps, min_samples=min_cluster_size)
    elif cluster_type is ClusterType.optics:
        eps = distance_threshold or calculate_distance_threshold(D, min_cluster_size)
        labels = optics_cluster(D, max_eps=eps, min_samples=min_cluster_size)
    elif cluster_type is ClusterType.hdbscan:
        labels = hdbscan_cluster(
            D,
            min_cluster_size=min_cluster_size,
            cluster_selection_epsilon=distance_threshold or 0.0,
        )
    elif cluster_type is ClusterType.affinity:
        labels = affinity_propagation_cluster(-(D**2))
    else:  # pragma: no cover
        raise NotImplementedError(cluster_type)

    num_found = np.unique(labels[labels >= 0]).shape[0]
    logger.debug("Found %d clusters", num_found)
    try:
        Ds = D if D is not None else _distance_matrix(x, metric, plda)
        logger.debug(
            "Silhouette score (-1-1): %.4f", silhouette_score(Ds, labels)
        )
    except ValueError:
        if num_found <= 1:
            logger.warning(
                "Only found one cluster; adjust cluster parameters to "
                "generate more clusters."
            )
            if strict:
                raise
    return labels


def cluster_purity(truth, labels) -> float:
    """Fraction of items whose cluster's majority true label matches theirs
    (diarization evaluation vs known speakers; reference
    ``diarization/speaker_diarizer.py`` evaluate_clustering)."""
    from collections import Counter, defaultdict

    by_cluster = defaultdict(list)
    for t, c in zip(truth, labels):
        by_cluster[c].append(t)
    correct = sum(
        Counter(members).most_common(1)[0][1]
        for members in by_cluster.values()
    )
    return correct / max(len(truth), 1)


def adjusted_rand_index(truth, labels) -> float:
    """Adjusted Rand index between two labelings (chance-corrected pair
    agreement; the reference scores clusterings with sklearn's
    implementation)."""
    from collections import Counter

    n = len(truth)
    if n < 2:
        return 1.0
    contingency = Counter(zip(truth, labels))
    a = Counter(truth)
    b = Counter(labels)

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_ij = sum(comb2(c) for c in contingency.values())
    sum_a = sum(comb2(c) for c in a.values())
    sum_b = sum(comb2(c) for c in b.values())
    total = comb2(n)
    expected = sum_a * sum_b / total
    max_index = (sum_a + sum_b) / 2.0
    if max_index == expected:
        return 1.0
    return (sum_ij - expected) / (max_index - expected)
