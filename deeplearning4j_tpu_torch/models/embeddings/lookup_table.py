"""InMemoryLookupTable — the embedding weight store (syn0/syn1/syn1neg).

The port's copy of deeplearning4j_tpu/models/embeddings/lookup_table.py:
the tables are numpy on the host, drawn with numpy, so both packages' tables
start bit-equal from a seed. The learners put them on the device for a fit
(`learning.BaseElementsLearning.configure`) and write them back at `finish`.
`from_reference` carries the JAX package's table (or a GloVe state) over as
it is. The text below is the reference's.

TPU-native equivalent of reference
models/embeddings/inmemory/InMemoryLookupTable.java: syn0 (input vectors),
syn1 (hierarchical-softmax inner-node vectors), syn1neg (negative-sampling
output vectors), exp table replaced by exact jnp.sigmoid, negative-sampling
unigram^0.75 table kept device-resident (reference keeps it DeviceLocal —
SkipGram.java:90).
"""
from __future__ import annotations

import numpy as np

from ..word2vec.vocab import VocabCache


class InMemoryLookupTable:
    def __init__(self, vocab, vector_length=100, seed=12345,
                 negative=0, use_hs=True, table_size=1 << 20):
        self.vocab = vocab
        self.vector_length = int(vector_length)
        self.seed = int(seed)
        self.negative = int(negative)
        self.use_hs = bool(use_hs)
        self.table_size = int(table_size)
        self.syn0 = None
        self.syn1 = None        # HS inner nodes
        self.syn1neg = None     # negative sampling
        self.neg_table = None

    def reset_weights(self):
        """reference: InMemoryLookupTable.resetWeights — syn0 uniform
        [-0.5/dim, 0.5/dim), syn1/syn1neg zeros."""
        V, D = len(self.vocab), self.vector_length
        rng = np.random.default_rng(self.seed)
        self.syn0 = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
        if self.use_hs:
            self.syn1 = np.zeros((max(V - 1, 1), D), np.float32)
        if self.negative > 0:
            self.syn1neg = np.zeros((V, D), np.float32)
            self._build_neg_table()
        return self

    resetWeights = reset_weights

    def _build_neg_table(self):
        """Unigram^0.75 sampling table (word2vec classic)."""
        counts = np.array([w.count for w in self.vocab.vocab_words()],
                         np.float64)
        probs = counts ** 0.75
        probs /= probs.sum()
        cum = np.cumsum(probs)
        self.neg_table = np.searchsorted(
            cum, (np.arange(self.table_size) + 0.5) / self.table_size
        ).astype(np.int32)

    # -- vector access ---------------------------------------------------
    def vector(self, word):
        i = self.vocab.index_of(word)
        if i < 0:
            return None
        return np.asarray(self.syn0[i])

    def set_vector(self, word, vec):
        i = self.vocab.index_of(word)
        if i >= 0:
            self.syn0[i] = np.asarray(vec, np.float32)

    def get_weights(self):
        return np.asarray(self.syn0)

    getWeights = get_weights


def from_reference(table_or_state):
    """The port's copy of a reference object, arrays copied as they are
    (never re-drawn): an `InMemoryLookupTable` of the JAX package (duck
    typed: its vocab, hyperparameters, syn0/syn1/syn1neg and neg_table)
    becomes the port's, with a `VocabCache` of the same words, counts,
    indices, Huffman codes and points; a GloVe state (the dict of arrays
    `Glove.fit` trains: W, Wc, b, bc and their AdaGrad accumulators)
    becomes a dict of f32 numpy arrays."""
    copy = lambda a: None if a is None else np.array(a)  # noqa: E731
    if isinstance(table_or_state, dict):
        return {k: np.array(v, np.float32)
                for k, v in table_or_state.items()}
    ref = table_or_state
    vocab = VocabCache()
    for w in ref.vocab.vocab_words():
        vocab.add_token(w.word, w.count)
    vocab.finish()
    for mine, theirs in zip(vocab.vocab_words(), ref.vocab.vocab_words()):
        if mine.word != theirs.word or mine.index != theirs.index:
            raise ValueError("vocab order differs from the reference's")
        mine.codes, mine.points = list(theirs.codes), list(theirs.points)
    table = InMemoryLookupTable(vocab, ref.vector_length, seed=ref.seed,
                                negative=ref.negative, use_hs=ref.use_hs,
                                table_size=ref.table_size)
    table.syn0, table.syn1 = copy(ref.syn0), copy(ref.syn1)
    table.syn1neg, table.neg_table = copy(ref.syn1neg), copy(ref.neg_table)
    return table
