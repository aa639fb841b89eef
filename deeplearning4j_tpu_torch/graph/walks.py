"""Random walk iterators.

The port's copy of deeplearning4j_tpu/graph/walks.py, held against it by
tests/test_torch_graph.py; the text below is the reference's.

TPU-native equivalent of reference deeplearning4j-graph iterator/:
RandomWalkIterator, WeightedRandomWalkIterator, NoEdgeHandling modes.
"""
from __future__ import annotations

import numpy as np

SELF_LOOP_ON_DISCONNECTED = "self_loop_on_disconnected"
EXCEPTION_ON_DISCONNECTED = "exception_on_disconnected"


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex.
    reference: iterator/RandomWalkIterator.java."""

    def __init__(self, graph, walk_length, seed=12345,
                 no_edge_handling=SELF_LOOP_ON_DISCONNECTED):
        self.graph = graph
        self.walk_length = int(walk_length)
        self.seed = int(seed)
        self.no_edge_handling = no_edge_handling
        self.reset()

    def reset(self):
        self._pos = 0
        self._rng = np.random.default_rng(self.seed)

    def has_next(self):
        return self._pos < self.graph.num_vertices()

    hasNext = has_next

    def next(self):
        start = self._pos
        self._pos += 1
        walk = [start]
        cur = start
        for _ in range(self.walk_length - 1):
            nbrs = self.graph.get_connected_vertex_indices(cur)
            if not nbrs:
                if self.no_edge_handling == EXCEPTION_ON_DISCONNECTED:
                    raise RuntimeError(
                        f"Vertex {cur} has no outgoing edges")
                walk.append(cur)   # self loop
                continue
            cur = int(nbrs[self._rng.integers(0, len(nbrs))])
            walk.append(cur)
        return walk

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional walks.
    reference: iterator/WeightedRandomWalkIterator.java."""

    def next(self):
        start = self._pos
        self._pos += 1
        walk = [start]
        cur = start
        for _ in range(self.walk_length - 1):
            edges = self.graph.get_edges_out(cur)
            if not edges:
                if self.no_edge_handling == EXCEPTION_ON_DISCONNECTED:
                    raise RuntimeError(
                        f"Vertex {cur} has no outgoing edges")
                walk.append(cur)
                continue
            w = np.array([e.weight for e in edges], np.float64)
            p = w / w.sum()
            cur = int(edges[self._rng.choice(len(edges), p=p)].to_idx)
            walk.append(cur)
        return walk
