"""KMeans clustering.

Port of deeplearning4j_tpu/clustering/kmeans.py, the equivalent of
reference deeplearning4j-core clustering/kmeans/ (KMeansClustering +
cluster/ strategy classes): kmeans++ seeding on the host with the
reference's numpy generator (so both packages start from the same
centers), then Lloyd iterations on the device in f32. A step is two
products: `x @ centers.T` for the [N, K] distances and `one_hot.T @ x` for
the per-cluster sums, with TF32 off (`card_numerics`). The sums are a
product, not an `index_add_`: the card's atomics would add them in an order
that varies from run to run. `torch.argmin` keeps the first of equal
minima, as `jnp.argmin` does.

Runs on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import numpy as np
import torch

from ..common.device import card_numerics, resolve_device


def _lloyd_step(x, centers, K):
    """One assignment+update step. x [N,D], centers [K,D] (f32 tensors on
    one device) -> (new centers, assignment [N], cost 0-d)."""
    with card_numerics(x.device, x.dtype):
        d2 = ((x * x).sum(1)[:, None]
              - 2.0 * (x @ centers.T)
              + (centers * centers).sum(1)[None, :])
        assign = torch.argmin(d2, dim=1)                          # [N]
        one_hot = torch.nn.functional.one_hot(assign, K).to(x.dtype)
        counts = one_hot.sum(0)                                   # [K]
        sums = one_hot.T @ x                                      # [K,D]
        new_centers = torch.where(counts[:, None] > 0,
                                  sums / counts.clamp_min(1.0)[:, None],
                                  centers)
        cost = d2.min(1).values.sum()
    return new_centers, assign, cost


class KMeansClustering:
    """reference: clustering/kmeans/KMeansClustering.java"""

    def __init__(self, k, max_iterations=100, tol=1e-6, seed=12345,
                 device=None):
        self.k = int(k)
        self.max_iterations = int(max_iterations)
        self.tol = float(tol)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.centers = None
        self.cost = None

    @staticmethod
    def setup(k, max_iterations=100, seed=12345, device=None):
        return KMeansClustering(k, max_iterations, seed=seed, device=device)

    def _init_pp(self, x, rng):
        """kmeans++ seeding."""
        n = x.shape[0]
        centers = [x[rng.integers(0, n)]]
        for _ in range(1, self.k):
            d2 = np.min(
                [np.sum((x - c) ** 2, axis=1) for c in centers], axis=0)
            p = d2 / max(d2.sum(), 1e-12)
            centers.append(x[rng.choice(n, p=p)])
        return np.stack(centers)

    def fit(self, points):
        x = np.asarray(points, np.float32)
        rng = np.random.default_rng(self.seed)
        centers = torch.from_numpy(self._init_pp(x, rng)).to(self.device)
        xd = torch.from_numpy(x).to(self.device)
        prev_cost = None
        assign = None
        for _ in range(self.max_iterations):
            centers, assign, cost = _lloyd_step(xd, centers, self.k)
            cost = float(cost)
            if prev_cost is not None and abs(prev_cost - cost) < self.tol:
                break
            prev_cost = cost
        self.centers = centers.cpu().numpy()
        self.cost = prev_cost
        self.labels = assign.cpu().numpy()
        return self

    applyTo = fit

    def predict(self, points):
        x = np.asarray(points, np.float32)
        d2 = ((x[:, None, :] - self.centers[None, :, :]) ** 2).sum(-1)
        return np.argmin(d2, axis=1)
