"""Spatial trees for nearest-neighbor search: VPTree, KDTree.

The port's copy (numpy) of deeplearning4j_tpu/clustering/trees.py, the
equivalent of reference deeplearning4j-core clustering/vptree/
(VPTree.java — vantage-point tree used by wordsNearest and Barnes-Hut
t-SNE neighbor search) and clustering/kdtree/KDTree.java.
"""
from __future__ import annotations

import heapq

import numpy as np


class VPTree:
    """Vantage-point tree over euclidean distance.
    reference: clustering/vptree/VPTree.java."""

    class _Node:
        __slots__ = ("index", "threshold", "inside", "outside")

        def __init__(self, index):
            self.index = index
            self.threshold = 0.0
            self.inside = None
            self.outside = None

    def __init__(self, points, seed=123):
        self.points = np.asarray(points, np.float64)
        self._rng = np.random.default_rng(seed)
        idx = list(range(len(self.points)))
        self.root = self._build(idx)

    def _dist(self, i, j):
        return float(np.linalg.norm(self.points[i] - self.points[j]))

    def _build(self, idx):
        if not idx:
            return None
        vp = idx[self._rng.integers(0, len(idx))]
        rest = [i for i in idx if i != vp]
        node = VPTree._Node(vp)
        if not rest:
            return node
        dists = np.linalg.norm(self.points[rest] - self.points[vp], axis=1)
        median = float(np.median(dists))
        node.threshold = median
        inside = [i for i, d in zip(rest, dists) if d <= median]
        outside = [i for i, d in zip(rest, dists) if d > median]
        node.inside = self._build(inside)
        node.outside = self._build(outside)
        return node

    def knn(self, query, k):
        """k nearest neighbors -> list[(distance, index)] sorted ascending."""
        query = np.asarray(query, np.float64)
        heap = []   # max-heap via negative distances

        def search(node):
            if node is None:
                return
            d = float(np.linalg.norm(self.points[node.index] - query))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            tau = -heap[0][0] if len(heap) == k else np.inf
            if node.inside is None and node.outside is None:
                return
            if d <= node.threshold:
                search(node.inside)
                if d + tau > node.threshold:
                    search(node.outside)
            else:
                search(node.outside)
                if d - tau <= node.threshold:
                    search(node.inside)

        search(self.root)
        return sorted((-nd, i) for nd, i in heap)


class KDTree:
    """Axis-aligned k-d tree. reference: clustering/kdtree/KDTree.java."""

    class _Node:
        __slots__ = ("index", "axis", "left", "right")

        def __init__(self, index, axis):
            self.index = index
            self.axis = axis
            self.left = None
            self.right = None

    def __init__(self, points):
        self.points = np.asarray(points, np.float64)
        self.dims = self.points.shape[1]
        self.root = self._build(list(range(len(self.points))), 0)

    def _build(self, idx, depth):
        if not idx:
            return None
        axis = depth % self.dims
        idx.sort(key=lambda i: self.points[i][axis])
        mid = len(idx) // 2
        node = KDTree._Node(idx[mid], axis)
        node.left = self._build(idx[:mid], depth + 1)
        node.right = self._build(idx[mid + 1:], depth + 1)
        return node

    def nn(self, query):
        """Nearest neighbor -> (distance, index)."""
        query = np.asarray(query, np.float64)
        best = [np.inf, -1]

        def search(node):
            if node is None:
                return
            d = float(np.linalg.norm(self.points[node.index] - query))
            if d < best[0]:
                best[0], best[1] = d, node.index
            diff = query[node.axis] - self.points[node.index][node.axis]
            near, far = (node.left, node.right) if diff <= 0 else \
                        (node.right, node.left)
            search(near)
            if abs(diff) < best[0]:
                search(far)

        search(self.root)
        return best[0], best[1]
