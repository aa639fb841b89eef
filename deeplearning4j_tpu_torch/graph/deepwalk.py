"""DeepWalk — graph vertex embeddings via skip-gram over random walks.

The port of deeplearning4j_tpu/graph/deepwalk.py, with one more builder
method, `device` (None: the CUDA card; "cpu" runs on the CPU), which `fit`
hands to the port's `SequenceVectors`: the walks are drawn on the host, and
the hierarchical-softmax skip-gram flush (`models/embeddings/learning.py`)
runs on that device. The queries read the host tables, and `save` / `load`
write and read the reference's JSON. The text below is the reference's.

TPU-native equivalent of reference models/deepwalk/DeepWalk.java (skip-gram
with hierarchical softmax over walk sequences, GraphHuffman tree) and the
GraphVectors query API (models/GraphVectors.java) + serializer
(models/loader/GraphVectorSerializer.java). The skip-gram hot loop reuses the
batched XLA kernel from models/embeddings/learning.py.
"""
from __future__ import annotations

import json

import numpy as np

from ..models.sequencevectors.sequence_vectors import SequenceVectors
from .walks import RandomWalkIterator


class DeepWalk:
    class Builder:
        def __init__(self):
            self._vector_size = 100
            self._window = 5
            self._lr = 0.025
            self._seed = 12345
            self._epochs = 1
            self._device = None

        def vector_size(self, v):
            self._vector_size = int(v); return self

        vectorSize = vector_size

        def window_size(self, v):
            self._window = int(v); return self

        windowSize = window_size

        def learning_rate(self, v):
            self._lr = float(v); return self

        learningRate = learning_rate

        def seed(self, v):
            self._seed = int(v); return self

        def epochs(self, v):
            self._epochs = int(v); return self

        def device(self, d):
            """Where the tables train: None (the CUDA card) or a torch
            device such as "cpu"."""
            self._device = d; return self

        def build(self):
            dw = DeepWalk(device=self._device)
            dw.vector_size = self._vector_size
            dw.window = self._window
            dw.learning_rate = self._lr
            dw.seed = self._seed
            dw.epochs = self._epochs
            return dw

    def __init__(self, device=None):
        self.vector_size = 100
        self.window = 5
        self.learning_rate = 0.025
        self.seed = 12345
        self.epochs = 1
        self.device = device
        self._sv = None
        self.num_vertices = 0

    # ------------------------------------------------------------------
    def fit(self, graph_or_walks, walk_length=None):
        """fit(graph, walk_length) generates uniform random walks from every
        vertex; fit(walk_iterator) consumes a prepared iterator.
        reference: DeepWalk.fit(IGraph,int) / fit(GraphWalkIterator)."""
        if walk_length is not None:
            it = RandomWalkIterator(graph_or_walks, walk_length,
                                    seed=self.seed)
            self.num_vertices = graph_or_walks.num_vertices()
        else:
            it = graph_or_walks
            self.num_vertices = it.graph.num_vertices()

        def sequences():
            it.reset()
            while it.has_next():
                yield [str(v) for v in it.next()]

        self._sv = SequenceVectors(
            vector_length=self.vector_size, window=self.window,
            learning_rate=self.learning_rate, seed=self.seed,
            epochs=self.epochs, min_word_frequency=1,
            use_hierarchic_softmax=True, device=self.device)
        self._sv.fit(sequences)
        return self

    # ------------------------------------------------------------------
    # GraphVectors query API
    # ------------------------------------------------------------------
    def get_vertex_vector(self, idx):
        return self._sv.get_word_vector(str(idx))

    getVertexVector = get_vertex_vector

    def similarity(self, a, b):
        return self._sv.similarity(str(a), str(b))

    def verticesNearest(self, idx, top_n=5):
        return [int(w) for w in self._sv.words_nearest(str(idx), top_n)]

    vertices_nearest = verticesNearest

    # ------------------------------------------------------------------
    # serializer — reference: models/loader/GraphVectorSerializer.java
    # ------------------------------------------------------------------
    def save(self, path):
        data = {
            "vectorSize": self.vector_size,
            "numVertices": self.num_vertices,
            "vectors": {w: self._sv.get_word_vector(w).tolist()
                        for w in self._sv.vocab.words()},
        }
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(data, fh)

    writeGraphVectors = save

    @staticmethod
    def load(path):
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
        dw = DeepWalk()
        dw.vector_size = data["vectorSize"]
        dw.num_vertices = data["numVertices"]
        from ..models.embeddings.lookup_table import InMemoryLookupTable
        from ..models.word2vec.vocab import VocabCache
        vocab = VocabCache()
        n = len(data["vectors"])
        for i, w in enumerate(data["vectors"]):
            vocab.add_token(w, n - i)
        vocab.finish()
        lookup = InMemoryLookupTable(vocab, dw.vector_size)
        lookup.syn0 = np.zeros((len(vocab), dw.vector_size), np.float32)
        for w, vec in data["vectors"].items():
            lookup.syn0[vocab.index_of(w)] = vec
        dw._sv = SequenceVectors(vector_length=dw.vector_size)
        dw._sv.vocab = vocab
        dw._sv.lookup = lookup
        return dw

    loadTxtVectors = load
