"""Bag-of-words & TF-IDF document vectorizers.

The port's copy of deeplearning4j_tpu/text/vectorizers.py, held against it
by tests/test_torch_text_nlp.py. The vectors stay host numpy arrays, and
`vectorize` returns the port's `datasets.dataset.DataSet`, which a container
moves to its device batch by batch. The text below is the reference's.

TPU-native equivalent of reference
bagofwords/vectorizer/{BagOfWordsVectorizer,TfidfVectorizer}.java: fit a
vocabulary over documents, then transform documents to count / tf-idf
vectors (optionally with labels -> DataSet).
"""
from __future__ import annotations

import math

import numpy as np

from ..models.word2vec.vocab import VocabCache
from .tokenization import DefaultTokenizerFactory


class BagOfWordsVectorizer:
    def __init__(self, tokenizer_factory=None, min_word_frequency=1):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = int(min_word_frequency)
        self.vocab = None
        self._doc_freq = None
        self.num_docs = 0

    def fit(self, documents):
        """documents: iterable of strings."""
        self.vocab = VocabCache()
        doc_freq = {}
        self.num_docs = 0
        for doc in documents:
            self.num_docs += 1
            toks = self.tokenizer_factory.create(doc).get_tokens()
            for t in toks:
                self.vocab.add_token(t)
            for t in set(toks):
                doc_freq[t] = doc_freq.get(t, 0) + 1
        self.vocab.finish(self.min_word_frequency)
        self._doc_freq = doc_freq
        return self

    def transform(self, document):
        """-> count vector [V]."""
        v = np.zeros((len(self.vocab),), np.float32)
        for t in self.tokenizer_factory.create(document).get_tokens():
            i = self.vocab.index_of(t)
            if i >= 0:
                v[i] += 1.0
        return v

    def transform_all(self, documents):
        return np.stack([self.transform(d) for d in documents])

    def fit_transform(self, documents):
        docs = list(documents)
        self.fit(docs)
        return self.transform_all(docs)

    fitTransform = fit_transform

    def vectorize(self, documents, labels=None, num_classes=None):
        """-> DataSet of (vectors, one-hot labels) like the reference's
        vectorize() returning DataSet."""
        from ..datasets.dataset import DataSet
        X = self.transform_all(documents)
        if labels is None:
            return DataSet(X, None)
        uniq = sorted(set(labels))
        lut = {l: i for i, l in enumerate(uniq)}
        n = num_classes or len(uniq)
        Y = np.eye(n, dtype=np.float32)[[lut[l] for l in labels]]
        return DataSet(X, Y)


class TfidfVectorizer(BagOfWordsVectorizer):
    """tf-idf weighting: tf * log(numDocs / docFreq)
    (reference: bagofwords/vectorizer/TfidfVectorizer.java)."""

    def idf(self, word):
        df = self._doc_freq.get(word, 0)
        if df == 0:
            return 0.0
        return math.log(self.num_docs / df)

    def transform(self, document):
        counts = super().transform(document)
        total = max(counts.sum(), 1.0)
        v = np.zeros_like(counts)
        for word, vw in zip(self.vocab.words(), self.vocab.vocab_words()):
            c = counts[vw.index]
            if c > 0:
                v[vw.index] = (c / total) * self.idf(word)
        return v
