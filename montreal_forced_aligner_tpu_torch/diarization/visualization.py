"""Cluster visualization: 2-D manifold projection + scatter plot.

Behavioral spec: reference ``diarization/multiprocessing.py:113``
(``visualize_clusters`` — sklearn.manifold tsne/mds/spectral/isomap over
cosine or PLDA distance) and ``diarization/speaker_diarizer.py:560``
(``SpeakerDiarizer.visualize_clusters`` — tab20-colored scatter with a
"Noise" class for label -1, saved as ``cluster_plot.png``).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np

from montreal_forced_aligner_tpu_torch.data import ManifoldAlgorithm

_logger = logging.getLogger("mfa_tpu")


def manifold_points(
    ivectors: np.ndarray,
    algorithm: ManifoldAlgorithm = ManifoldAlgorithm.tsne,
    metric: str = "cosine",
    n_neighbors: int = 10,
    plda=None,
    quick: bool = False,
) -> np.ndarray:
    """2-D embedding of i-vectors for plotting (reference
    ``visualize_clusters``, ``diarization/multiprocessing.py:113``).

    ``metric='plda'`` scores pairs with the PLDA log-likelihood distance;
    MDS over cosine follows the reference's trick of L2-normalizing and
    using euclidean distance instead.
    """
    from sklearn import manifold, preprocessing

    if isinstance(algorithm, str):
        algorithm = ManifoldAlgorithm[algorithm]
    begin = time.time()
    to_fit = np.asarray(ivectors, np.float64)
    # sklearn requires n_neighbors (tsne perplexity) strictly below the
    # sample count in every manifold; clamp once for all algorithms so
    # small corpora don't crash the plot
    n_neighbors = max(1, min(n_neighbors, to_fit.shape[0] - 1))
    fit_metric = metric
    tsne_iterations = 500 if quick else 1000
    mds_iterations = 150 if quick else 300
    if metric == "plda":
        if plda is None:
            raise ValueError("metric='plda' requires a PLDA model")

        def fit_metric(u, v):  # noqa: F811 - callable metric
            return float(plda.log_likelihood_distance(u, v))

    if algorithm is ManifoldAlgorithm.mds:
        if metric == "cosine":
            to_fit = preprocessing.normalize(to_fit, norm="l2")
            fit_metric = "euclidean"
        points = manifold.MDS(
            dissimilarity="euclidean" if fit_metric == "euclidean" else "precomputed",
            random_state=0,
            max_iter=mds_iterations,
            metric=False,
            normalized_stress=True,
        ).fit_transform(
            to_fit
            if fit_metric == "euclidean"
            else _distance_matrix(to_fit, fit_metric)
        )
    elif algorithm is ManifoldAlgorithm.tsne:
        points = manifold.TSNE(
            metric=fit_metric,
            random_state=0,
            perplexity=max(n_neighbors, 1),
            init="pca" if not callable(fit_metric) else "random",
            max_iter=tsne_iterations,
        ).fit_transform(to_fit)
    elif algorithm is ManifoldAlgorithm.spectral:
        points = manifold.SpectralEmbedding(
            affinity="nearest_neighbors",
            random_state=0,
            n_neighbors=n_neighbors,
        ).fit_transform(to_fit)
    elif algorithm is ManifoldAlgorithm.isomap:
        points = manifold.Isomap(
            metric=fit_metric, n_neighbors=n_neighbors
        ).fit_transform(to_fit)
    else:  # pragma: no cover - enum is exhaustive
        raise NotImplementedError(algorithm)
    _logger.debug(
        "2D representation (%s) took %.3fs", algorithm.name, time.time() - begin
    )
    return np.asarray(points)


def _distance_matrix(x: np.ndarray, metric) -> np.ndarray:
    n = x.shape[0]
    out = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            out[i, j] = out[j, i] = metric(x[i], x[j])
    return out


def plot_clusters(
    points: np.ndarray,
    labels: Optional[np.ndarray],
    path,
) -> Path:
    """tab20-colored cluster scatter saved to ``path`` (reference
    ``SpeakerDiarizer.visualize_clusters``, ``speaker_diarizer.py:560``;
    label -1 plots black as "Noise")."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    try:  # the reference styles with seaborn when present
        import seaborn as sns

        sns.set()
        palette = lambda n: sns.color_palette("tab20", n)  # noqa: E731
    except ImportError:  # pragma: no cover - seaborn is usually present
        cmap = matplotlib.colormaps["tab20"]
        palette = lambda n: [cmap(i % 20) for i in range(n)]  # noqa: E731

    fig = plt.figure(1)
    ax = fig.add_subplot(111)
    if labels is not None:
        labels = np.asarray(labels)
        unique_labels = np.unique(labels)
        num_colored = len(unique_labels) - (1 if -1 in unique_labels else 0)
        cm = palette(max(num_colored, 1))
        color_i = 0
        for cluster in unique_labels:
            idx = np.where(labels == cluster)
            if cluster == -1:
                ax.scatter(
                    points[idx, 0], points[idx, 1],
                    color="k", label="Noise", alpha=0.75,
                )
                continue
            name = cluster if isinstance(cluster, str) else f"Cluster {cluster}"
            ax.scatter(
                points[idx, 0], points[idx, 1],
                color=cm[color_i], label=name, alpha=1.0,
            )
            color_i += 1
    else:
        ax.scatter(points[:, 0], points[:, 1])
    handles, lgd_labels = ax.get_legend_handles_labels()
    fig.subplots_adjust(bottom=0.3, wspace=0.33)
    plt.axis("off")
    lgd = ax.legend(
        handles, lgd_labels, loc="upper center",
        bbox_to_anchor=(0.5, -0.1), fancybox=True, shadow=True, ncol=5,
    )
    path = Path(path)
    plt.savefig(
        path, bbox_extra_artists=(lgd,), bbox_inches="tight", transparent=True
    )
    plt.close(fig)
    return path
