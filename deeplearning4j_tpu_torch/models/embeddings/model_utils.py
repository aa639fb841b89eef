"""Model query utils: cosine similarity, wordsNearest, analogy accuracy.

The port's copy of deeplearning4j_tpu/models/embeddings/model_utils.py
(numpy); the text below is the reference's.

TPU-native equivalent of reference
models/embeddings/reader/impl/BasicModelUtils.java (wordsNearest via gemm,
similarity, accuracy). The nearest-neighbor search is one [V,D]x[D] matmul.
"""
from __future__ import annotations

import numpy as np


def cosine_sim(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(a @ b / (na * nb))


def words_nearest(vocab, lookup, word_or_vec, top_n=10, exclude=()):
    """Top-N nearest words by cosine similarity (one gemm over syn0)."""
    if isinstance(word_or_vec, str):
        vec = lookup.vector(word_or_vec)
        if vec is None:
            return []
        exclude = tuple(exclude) + (word_or_vec,)
    else:
        vec = np.asarray(word_or_vec, np.float32)
    W = lookup.get_weights()
    if hasattr(lookup, "row_norms"):
        # memory-mapped lookups precompute norms at write time so nearest
        # queries stream W @ v without materializing the matrix
        norms = np.array(lookup.row_norms(), np.float32)
    else:
        norms = np.linalg.norm(W, axis=1)
    norms[norms == 0] = 1.0
    v = vec / max(np.linalg.norm(vec), 1e-12)
    sims = (W @ v) / norms
    excl_idx = {vocab.index_of(w) for w in exclude if vocab.index_of(w) >= 0}
    order = np.argsort(-sims)
    out = []
    for i in order:
        if int(i) in excl_idx:
            continue
        out.append(vocab.word_at_index(int(i)))
        if len(out) >= top_n:
            break
    return out


def words_nearest_sum(vocab, lookup, positive, negative=(), top_n=10):
    """Analogy query: argmax cos(v, sum(positive) - sum(negative)).
    reference: BasicModelUtils.wordsNearest(Collection, Collection, int)."""
    vec = np.zeros((lookup.vector_length,), np.float32)
    for w in positive:
        v = lookup.vector(w)
        if v is not None:
            vec += v
    for w in negative:
        v = lookup.vector(w)
        if v is not None:
            vec -= v
    return words_nearest(vocab, lookup, vec, top_n,
                         exclude=tuple(positive) + tuple(negative))
