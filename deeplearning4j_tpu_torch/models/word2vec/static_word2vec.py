"""StaticWord2Vec — read-only, memory-mapped word vectors.

The port's copy of deeplearning4j_tpu/models/word2vec/static_word2vec.py
(numpy): the store's files and queries are held equal to the reference's
by tests/test_torch_embeddings.py; the text below is the reference's.

Parity with the reference's StaticWord2Vec
(deeplearning4j-nlp models/word2vec/StaticWord2Vec.java): a query-only
model for serving/inference that does NOT load the table into heap — here
the vector matrix is an `np.memmap` over an on-disk .npy, so a multi-GB
table costs pages-on-demand, and per-word lookups touch one row. Nearest-
neighbor queries stream the matrix through the OS page cache (one pass).
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..embeddings import model_utils
from .vocab import VocabCache


def write_static_model(model, dir_path):
    """Persist a trained embedding model (SequenceVectors/Word2Vec facade)
    as a static store: vectors.npy (float32 [V, D]) + vocab.json."""
    os.makedirs(dir_path, exist_ok=True)
    W = np.asarray(model.lookup.get_weights(), np.float32)
    np.save(os.path.join(dir_path, "vectors.npy"), W)
    # row norms precomputed so mmap'd nearest queries never materialize W
    np.save(os.path.join(dir_path, "norms.npy"),
            np.linalg.norm(W, axis=1).astype(np.float32))
    words = [model.vocab.word_at_index(i) for i in range(len(model.vocab))]
    counts = [model.vocab.word_frequency(w) for w in words]
    with open(os.path.join(dir_path, "vocab.json"), "w",
              encoding="utf-8") as fh:
        json.dump({"words": words, "counts": counts}, fh)
    return dir_path


class _MmapLookup:
    """Duck-typed read-only lookup over the memmap (the subset of
    InMemoryLookupTable the query utils use)."""

    def __init__(self, W, vocab, norms=None):
        self._W = W
        self._vocab = vocab
        self._norms = norms
        self.vector_length = int(W.shape[1])

    def get_weights(self):
        return self._W

    def row_norms(self):
        if self._norms is None:
            self._norms = np.linalg.norm(np.asarray(self._W), axis=1)
        return self._norms

    def vector(self, word):
        i = self._vocab.index_of(word)
        if i < 0:
            return None
        return np.asarray(self._W[i])


class StaticWord2Vec:
    """Query-only word2vec: `word_vector`, `similarity`, `words_nearest`,
    analogy via `words_nearest_sum` — no training methods, no syn1 tables,
    no gradient state."""

    def __init__(self, dir_path, mmap=True):
        W = np.load(os.path.join(dir_path, "vectors.npy"),
                    mmap_mode="r" if mmap else None)
        with open(os.path.join(dir_path, "vocab.json"),
                  encoding="utf-8") as fh:
            meta = json.load(fh)
        norms_path = os.path.join(dir_path, "norms.npy")
        norms = np.load(norms_path) if os.path.exists(norms_path) else None
        vocab = VocabCache()
        for w, c in zip(meta["words"], meta["counts"]):
            vocab.add_token(w, count=int(c))
        vocab.finish()
        # preserve on-disk row order (finish() may sort by frequency)
        order = [vocab.index_of(w) for w in meta["words"]]
        if order != list(range(len(meta["words"]))):
            inv = np.empty(len(order), np.int64)
            for disk_row, vocab_idx in enumerate(order):
                inv[vocab_idx] = disk_row
            W = W[inv] if not mmap else _ReorderedView(W, inv)
            norms = norms[inv] if norms is not None else None
        self.vocab = vocab
        self.lookup = _MmapLookup(W, vocab, norms)

    # -- queries ----------------------------------------------------------
    def has_word(self, word):
        return word in self.vocab

    hasWord = has_word

    def word_vector(self, word):
        return self.lookup.vector(word)

    getWordVector = word_vector

    def similarity(self, a, b):
        va, vb = self.lookup.vector(a), self.lookup.vector(b)
        if va is None or vb is None:
            return float("nan")
        return model_utils.cosine_sim(va, vb)

    def words_nearest(self, word_or_vec, top_n=10):
        return model_utils.words_nearest(self.vocab, self.lookup,
                                         word_or_vec, top_n=top_n)

    wordsNearest = words_nearest

    def words_nearest_sum(self, positive, negative=(), top_n=10):
        return model_utils.words_nearest_sum(self.vocab, self.lookup,
                                             positive, negative, top_n)


class _ReorderedView:
    """Lazy row-permuted view over a memmap (keeps pages-on-demand
    semantics when vocab order differs from disk order)."""

    def __init__(self, W, index):
        self._W = W
        self._index = np.asarray(index)
        self.shape = (len(index), W.shape[1])
        self.dtype = W.dtype

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return self._W[int(self._index[i])]
        # memmap fancy indexing reads only the addressed rows
        return self._W[self._index[i]]

    def __matmul__(self, v):
        # (view @ v)[i] == W[index[i]] . v — compute in disk order (one
        # streaming pass over the memmap), then permute
        return (self._W @ v)[self._index]

    def __array__(self, dtype=None):
        a = np.asarray(self._W)[self._index]
        return a.astype(dtype) if dtype is not None else a
