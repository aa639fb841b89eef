"""ParagraphVectors (doc2vec): DBOW + DM sequence learning.

The port of deeplearning4j_tpu/models/paragraphvectors/paragraph_vectors.py:
DBOW and DM go through the device steps of `SkipGram.enqueue_pairs` and
`CBOW.enqueue_windows`; `infer_vector` stays host numpy, as in the
reference. The builder has one more method, `device` (None: the CUDA
card). The text below is the reference's.

TPU-native equivalent of reference
models/paragraphvectors/ParagraphVectors.java (1,137 LoC) with the sequence
learning algorithms of models/embeddings/learning/impl/sequence/{DBOW,DM}.java:

- DBOW: the document vector predicts each word of the document (skip-gram
  with the label as the center) — impl/sequence/DBOW.java.
- DM: mean of (document vector + context words) predicts the center word
  (CBOW with the label folded into the context) — impl/sequence/DM.java.

Labels live in the same vocab/syn0 as words (as in the reference's
label-aware vocab), so inference and wordsNearest work across both spaces.
"""
from __future__ import annotations

import numpy as np

from ...text.sentence_iterator import LabelsSource
from ...text.tokenization import DefaultTokenizerFactory
from ..embeddings.learning import CBOW, SkipGram
from ..sequencevectors.sequence_vectors import SequenceVectors
from ..word2vec.vocab import build_huffman


class ParagraphVectors(SequenceVectors):
    class Builder:
        def __init__(self):
            self._kw = {}
            self._iterator = None
            self._tokenizer = None
            self._labels_source = None
            self._sequence_algo = "dbow"

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

        def epochs(self, v):
            self._kw["epochs"] = int(v); return self

        def iterations(self, v):
            self._kw["iterations"] = int(v); return self

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

        def sequence_learning_algorithm(self, v):
            v = str(v).lower()
            self._sequence_algo = "dm" if "dm" in v else "dbow"
            return self

        sequenceLearningAlgorithm = sequence_learning_algorithm

        def device(self, d):
            """Where the tables train: None (the CUDA card) or a torch
            device such as "cpu"."""
            self._kw["device"] = d; return self

        def labels_source(self, ls):
            self._labels_source = ls; return self

        labelsSource = labels_source

        def iterate(self, it):
            self._iterator = it; return self

        def tokenizer_factory(self, tf):
            self._tokenizer = tf; return self

        tokenizerFactory = tokenizer_factory

        def build(self):
            pv = ParagraphVectors(**self._kw)
            pv.sequence_algo = self._sequence_algo
            pv._iterator = self._iterator
            pv._tokenizer = self._tokenizer or DefaultTokenizerFactory()
            pv.labels_source = self._labels_source or LabelsSource()
            return pv

    def __init__(self, **kw):
        super().__init__(**kw)
        self.sequence_algo = "dbow"
        self.labels_source = LabelsSource()
        self._iterator = None
        self._tokenizer = DefaultTokenizerFactory()
        self._docs = None   # list of (label, tokens)

    # ------------------------------------------------------------------
    def fit(self, documents=None):
        """documents: list of (label, tokens) pairs, or None to consume the
        configured (label-aware) sentence iterator."""
        if documents is None:
            documents = self._docs_from_iterator()
        self._docs = list(documents)
        # record THIS fit's label space (dedup'd via the public API) so
        # it serializes — refits replace, never leave a stale list
        # (reference: labelsSource is always populated)
        self.labels_source._labels = []
        for label, _ in self._docs:
            self.labels_source.store_label(label)

        # vocab over words AND labels (labels are count-1 pseudo-words)
        seqs = [toks for _, toks in self._docs]
        self.build_vocab(seqs)
        for label, _ in self._docs:
            self.vocab.add_token(label)
        self.vocab.finish(1)
        if self.use_hs:
            build_huffman(self.vocab)

        from ..embeddings.lookup_table import InMemoryLookupTable
        self.lookup = InMemoryLookupTable(
            self.vocab, self.vector_length, seed=self.seed,
            negative=self.negative, use_hs=self.use_hs).reset_weights()

        if self.sequence_algo == "dm":
            algo = CBOW(batch_pairs=self.batch_pairs)
        else:
            algo = SkipGram(batch_pairs=self.batch_pairs)
        algo.configure(self.vocab, self.lookup, window=self.window,
                       negative=self.negative, use_hs=self.use_hs,
                       seed=self.seed, device=self.device)

        total = max(sum(len(t) for _, t in self._docs)
                    * self.epochs * self.iterations, 1)
        seen = 0
        for _epoch in range(self.epochs):
            for label, toks in self._docs:
                lab_id = self.vocab.index_of(label)
                ids = self._sequence_ids(toks)
                if lab_id < 0 or not ids:
                    continue
                for _ in range(self.iterations):
                    frac = min(seen / total, 1.0)
                    lr = max(self.min_learning_rate,
                             self.learning_rate * (1.0 - frac))
                    if self.sequence_algo == "dm":
                        self._learn_dm(algo, lab_id, ids, lr)
                    else:
                        self._learn_dbow(algo, lab_id, ids, lr)
                    seen += len(ids)
        algo.finish()
        return self

    def _docs_from_iterator(self):
        if self._iterator is None:
            raise ValueError("No documents given and no iterator configured")
        docs = []
        self._iterator.reset()
        while self._iterator.has_next():
            s = self._iterator.next_sentence()
            label = (self._iterator.current_label()
                     if hasattr(self._iterator, "current_label")
                     else self.labels_source.next_label())
            docs.append((label, self._tokenizer.create(s).get_tokens()))
        return docs

    def _learn_dbow(self, algo, lab_id, ids, lr):
        """Label predicts every word (skip-gram pairs label->word)."""
        import numpy as np
        algo.enqueue_pairs(np.full((len(ids),), lab_id, np.int32), ids, lr)

    def _learn_dm(self, algo, lab_id, ids, lr):
        """Mean(label + context) predicts center (CBOW with label)."""
        import numpy as np

        from ..embeddings.learning import window_contexts
        n = len(ids)
        if n == 0:
            return
        ids_arr = np.asarray(ids, np.int32)
        context, _ = window_contexts(ids_arr, self.window, self._rng)
        # the label vector joins every window (the DM doc-vector column)
        context = np.concatenate(
            [context, np.full((n, 1), lab_id, np.int32)], axis=1)
        algo.enqueue_windows(context, ids_arr, lr)

    # ------------------------------------------------------------------
    def infer_vector(self, text_or_tokens, steps=10, lr=0.025):
        """Infer a vector for an unseen document: freeze word weights, run
        gradient steps on a fresh doc vector (reference:
        ParagraphVectors.inferVector)."""
        toks = (text_or_tokens if isinstance(text_or_tokens, (list, tuple))
                else self._tokenizer.create(text_or_tokens).get_tokens())
        ids = self._sequence_ids(toks)
        if not ids:
            return np.zeros((self.vector_length,), np.float32)
        rng = np.random.default_rng(self.seed)
        v = ((rng.random(self.vector_length) - 0.5)
             / self.vector_length).astype(np.float32)
        syn1 = self.lookup.syn1 if self.use_hs else self.lookup.syn1neg
        for _ in range(steps):
            for wid in ids:
                if self.use_hs:
                    vw = self.vocab.vocab_words()[wid]
                    pts = np.asarray(vw.points, np.int32)
                    lbl = 1.0 - np.asarray(vw.codes, np.float32)
                else:
                    negs = self.lookup.neg_table[
                        rng.integers(0, self.lookup.table_size, self.negative)]
                    pts = np.concatenate([[wid], negs]).astype(np.int32)
                    lbl = np.zeros(len(pts), np.float32)
                    lbl[0] = 1.0
                u = syn1[pts]
                logits = np.clip(u @ v, -6, 6)
                g = (lbl - 1.0 / (1.0 + np.exp(-logits))) * lr
                v = v + g @ u
        return v

    inferVector = infer_vector

    def get_label_vector(self, label):
        return self.lookup.vector(label)
