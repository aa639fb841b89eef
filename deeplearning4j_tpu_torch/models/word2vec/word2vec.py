"""Word2Vec — builder facade over SequenceVectors.

The port of deeplearning4j_tpu/models/word2vec/word2vec.py, with one more
builder method, `device` (None: the CUDA card). The text below is the
reference's.

TPU-native equivalent of reference models/word2vec/Word2Vec.java (builder
mirroring: minWordFrequency, layerSize, windowSize, seed, iterate (sentence
iterator), tokenizerFactory, negativeSample, useHierarchicSoftmax,
learningRate, minLearningRate, sampling, iterations, epochs, elementsLearning
skipgram|cbow).
"""
from __future__ import annotations

from ...text.tokenization import DefaultTokenizerFactory
from ..sequencevectors.sequence_vectors import SequenceVectors


class Word2Vec(SequenceVectors):
    class Builder:
        def __init__(self):
            self._kw = {}
            self._iterator = None
            self._tokenizer = None

        def min_word_frequency(self, v):
            self._kw["min_word_frequency"] = int(v); return self

        minWordFrequency = min_word_frequency

        def layer_size(self, v):
            self._kw["vector_length"] = int(v); return self

        layerSize = layer_size

        def window_size(self, v):
            self._kw["window"] = int(v); return self

        windowSize = window_size

        def seed(self, v):
            self._kw["seed"] = int(v); return self

        def iterations(self, v):
            self._kw["iterations"] = int(v); return self

        def epochs(self, v):
            self._kw["epochs"] = int(v); return self

        def learning_rate(self, v):
            self._kw["learning_rate"] = float(v); return self

        learningRate = learning_rate

        def min_learning_rate(self, v):
            self._kw["min_learning_rate"] = float(v); return self

        minLearningRate = min_learning_rate

        def negative_sample(self, v):
            self._kw["negative"] = int(v)
            if int(v) > 0:
                self._kw.setdefault("use_hierarchic_softmax", False)
            return self

        negativeSample = negative_sample

        def use_hierarchic_softmax(self, v):
            self._kw["use_hierarchic_softmax"] = bool(v); return self

        useHierarchicSoftmax = use_hierarchic_softmax

        def sampling(self, v):
            self._kw["sampling"] = float(v); return self

        def elements_learning_algorithm(self, v):
            self._kw["elements_algo"] = str(v).lower(); return self

        elementsLearningAlgorithm = elements_learning_algorithm

        def batch_pairs(self, v):
            self._kw["batch_pairs"] = int(v); return self

        def mesh(self, m):
            """Distributed training over a `parallel.sharding.Mesh`: the
            tables column-shard over its "model" ranks, every rank fitting
            the same corpus (`embeddings.learning`)."""
            self._kw["mesh"] = m; return self

        def device(self, d):
            """Where the tables train: None (the CUDA card) or a torch
            device such as "cpu"."""
            self._kw["device"] = d; return self

        def iterate(self, sentence_iterator):
            self._iterator = sentence_iterator; return self

        def tokenizer_factory(self, tf):
            self._tokenizer = tf; return self

        tokenizerFactory = tokenizer_factory

        def build(self):
            w2v = Word2Vec(**self._kw)
            w2v._sentence_iterator = self._iterator
            w2v._tokenizer_factory = (self._tokenizer
                                      or DefaultTokenizerFactory())
            return w2v

    def __init__(self, **kw):
        super().__init__(**kw)
        self._sentence_iterator = None
        self._tokenizer_factory = DefaultTokenizerFactory()

    def _sequences(self):
        self._sentence_iterator.reset()
        while self._sentence_iterator.has_next():
            s = self._sentence_iterator.next_sentence()
            if s is None:
                continue
            toks = self._tokenizer_factory.create(s).get_tokens()
            if toks:
                yield toks

    def fit(self, sequence_source=None):
        if sequence_source is not None:
            return super().fit(sequence_source)
        if self._sentence_iterator is None:
            raise ValueError("No sentence iterator configured (.iterate())")
        return super().fit(lambda: self._sequences())
