"""K-means clustering for HInit-style initialisation.

Mirrors `HTKLib/HTrain.c` clustering (FlatCluster/KMeans): deterministic
farthest-point seeding then Lloyd iterations. Host numpy — this runs once
at initialisation on tiny data; the hot path is elsewhere.

Copied from `htk_tpu/algo/kmeans.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def kmeans(x: np.ndarray, k: int, iters: int = 10, seed: int = 0):
    """Cluster rows of x into k groups; returns (assign, means)."""
    n, d = x.shape
    if k >= n:
        # degenerate: each point its own cluster, repeat last
        assign = np.minimum(np.arange(n), k - 1)
        means = np.stack([x[assign == j].mean(axis=0) if np.any(assign == j)
                          else x[min(j, n - 1)] for j in range(k)])
        return assign, means
    # deterministic seeding: first centre = global mean's nearest point,
    # then farthest-point (matches HTK's deterministic flavour)
    centres = [x[np.argmin(((x - x.mean(0)) ** 2).sum(1))]]
    for _ in range(1, k):
        d2 = np.min(
            np.stack([((x - c) ** 2).sum(1) for c in centres]), axis=0
        )
        centres.append(x[int(np.argmax(d2))])
    means = np.stack(centres)
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d2 = ((x[:, None, :] - means[None, :, :]) ** 2).sum(-1)
        new_assign = d2.argmin(axis=1)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for j in range(k):
            sel = assign == j
            if np.any(sel):
                means[j] = x[sel].mean(axis=0)
    return assign, means


def segment_kmeans_gmm(
    frames: np.ndarray, nmix: int, min_var: float = 1e-4
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Frames -> (weights, means, vars) of an nmix diagonal GMM (HInit)."""
    n, d = frames.shape
    if n == 0:
        raise ValueError("segment_kmeans_gmm: empty frame set")
    if nmix == 1:
        mean = frames.mean(axis=0)
        var = np.maximum(frames.var(axis=0), min_var)
        return np.ones(1), mean[None], var[None]
    assign, means = kmeans(frames, nmix)
    weights = np.zeros(nmix)
    variances = np.ones((nmix, d))
    gmean = frames.mean(axis=0)
    gvar = np.maximum(frames.var(axis=0), min_var)
    for j in range(nmix):
        sel = assign == j
        c = int(sel.sum())
        weights[j] = max(c, 1) / n
        if c >= 2:
            means[j] = frames[sel].mean(axis=0)
            variances[j] = np.maximum(frames[sel].var(axis=0), min_var)
        else:
            means[j] = gmean
            variances[j] = gvar
    weights /= weights.sum()
    return weights, means, variances
