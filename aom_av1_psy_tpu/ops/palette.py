"""Palette / k-means kernels (``av1/encoder/k_means_template.h``:
av1_calc_indices_dim1/dim2 + av1_k_means iterations), batched.

The nearest-centroid assignment is a (N, K) distance matrix argmin —
exactly the batched-array formulation; the Lloyd iteration on top is a
segment mean.
"""
from __future__ import annotations

import numpy as np


def _xp(x):
    if isinstance(x, np.ndarray):
        return np
    import jax.numpy as jnp
    return jnp


def calc_indices(data, centroids, dim: int):
    """av1_calc_indices_dim{1,2}_c. data: (N*dim,) or (N, dim);
    centroids: (K*dim,) or (K, dim). Returns (indices uint8 (N,),
    total_dist int). dim==1 uses |d| for the argmin (squared for the
    total), dim==2 squared L2 throughout — matching the reference."""
    xp = _xp(data)
    d = xp.asarray(data).reshape(-1, dim).astype(xp.int64)
    c = xp.asarray(centroids).reshape(-1, dim).astype(xp.int64)
    diff = d[:, None, :] - c[None, :, :]
    if dim == 1:
        dist = xp.abs(diff[..., 0])
        idx = xp.argmin(dist, axis=1)
        best = xp.min(dist, axis=1)
        total = int((best.astype(xp.int64) ** 2).sum())
    else:
        dist = (diff * diff).sum(-1)
        idx = xp.argmin(dist, axis=1)
        total = int(xp.min(dist, axis=1).sum())
    return idx.astype(xp.uint8), total


def k_means(data, k: int, dim: int, max_itr: int = 50):
    """Lloyd iterations (av1_k_means_template): centroids seeded evenly
    over the value range, nearest-assign + segment-mean update."""
    d = np.asarray(data).reshape(-1, dim).astype(np.int64)
    lo, hi = d.min(0), d.max(0)
    cents = np.stack([lo + (hi - lo) * (2 * i + 1) // (2 * k)
                      for i in range(k)]).astype(np.int64)
    prev = None
    for _ in range(max_itr):
        idx, total = calc_indices(d, cents, dim)
        if prev is not None and total >= prev:
            break
        prev = total
        for j in range(k):
            sel = d[idx == j]
            if len(sel):
                cents[j] = (sel.sum(0) + len(sel) // 2) // len(sel)
    idx, total = calc_indices(d, cents, dim)
    return cents, idx, total
