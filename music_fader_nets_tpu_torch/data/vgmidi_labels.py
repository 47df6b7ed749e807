"""VGMIDI annotation filtering (Ferreira et al.); the port's copy of
`music_fader_nets_tpu/data/vgmidi_labels.py` (numpy only).

The reference's `get_average_av_values` (reference ptb_v2.py:159-214)
clusters the 30 annotators' arousal time series with DTW k-means (k=3),
drops the highest-variance cluster, keeps the larger remaining cluster and
averages it — but ships BROKEN: its `TimeSeriesKMeans` import is commented
out (ptb_v2.py:8), so the function crashes if called. This module provides a
working, dependency-free implementation: classic O(T^2) DTW distance and a
k-means with DTW assignments (Euclidean barycenters — tslearn's DBA
refinement is approximated by the arithmetic mean, adequate for
equal-length annotation curves), followed by the reference's exact
cluster-variance filtering rules.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def dtw_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Dynamic-time-warping distance between two 1-D series."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n, m = len(a), len(b)
    dp = np.full((n + 1, m + 1), np.inf)
    dp[0, 0] = 0.0
    cost = (a[:, None] - b[None, :]) ** 2
    for i in range(1, n + 1):
        row = dp[i]
        prev = dp[i - 1]
        for j in range(1, m + 1):
            row[j] = cost[i - 1, j - 1] + min(prev[j], row[j - 1],
                                              prev[j - 1])
    return float(np.sqrt(dp[n, m]))


def dtw_kmeans(series: np.ndarray, k: int = 3, n_iter: int = 10,
               seed: int = 0) -> np.ndarray:
    """Cluster equal-length series (N, T) -> labels (N,). DTW assignment,
    mean barycenters."""
    series = np.asarray(series, dtype=np.float64)
    n = len(series)
    rng = np.random.RandomState(seed)
    k = min(k, n)
    centers = series[rng.choice(n, size=k, replace=False)].copy()
    labels = np.zeros(n, dtype=int)
    for _ in range(n_iter):
        d = np.array([[dtw_distance(s, c) for c in centers] for s in series])
        new_labels = d.argmin(axis=1)
        if (new_labels == labels).all() and _ > 0:
            break
        labels = new_labels
        for ki in range(k):
            members = series[labels == ki]
            if len(members):
                centers[ki] = members.mean(axis=0)
    return labels


def filter_annotations(arousal_values: np.ndarray,
                       valence_values: np.ndarray,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's filtering algorithm (ptb_v2.py:177-214): k=3 DTW
    clusters of the arousal curves; among the three, identify the highest-
    variance cluster and keep the LARGER of the other two; average the kept
    arousal curves and all valence curves."""
    arousal_values = np.asarray(arousal_values, dtype=np.float64)
    valence_values = np.asarray(valence_values, dtype=np.float64)
    if len(arousal_values) < 3:
        return arousal_values.mean(axis=0), valence_values.mean(axis=0)

    clusters = dtw_kmeans(arousal_values, k=3, seed=seed)
    groups = [arousal_values[clusters == i] for i in range(3)]
    variances = [np.mean(np.var(g, axis=0)) if len(g) else np.inf
                 for g in groups]

    # drop the max-variance cluster; keep the larger remaining one
    order = int(np.argmax(variances))
    rest = [i for i in range(3) if i != order]
    keep = rest[0] if len(groups[rest[0]]) > len(groups[rest[1]]) else rest[1]
    kept = groups[keep] if len(groups[keep]) else arousal_values
    return kept.mean(axis=0), valence_values.mean(axis=0)


def get_average_av_values(av_dict: Dict, key: str,
                          min_musicianship: int = 3,
                          seed: int = 0) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Drop-in equivalent of the reference function: collects the 30
    annotators' series for `key` (entries `{key}_{i}` with musicianship >=
    3, ptb_v2.py:163-171), then applies `filter_annotations`."""
    arousal, valence = [], []
    for i in range(1, 31):
        entry = av_dict.get(f"{key}_{i}")
        if entry and entry.get("musicianship", 0) >= min_musicianship:
            arousal.append(entry["arousal"])
            valence.append(entry["valence"])
    if not arousal:
        return None
    return filter_annotations(np.asarray(arousal), np.asarray(valence),
                              seed=seed)
