"""SequenceVectors — the generic embedding training engine.

The port of deeplearning4j_tpu/models/sequencevectors/sequence_vectors.py:
the same vocab, route choice (the native corpus-chunk route when
`iterations == 1`, 256 sequences a call with lr decayed per chunk;
otherwise `learn_sequence` per sequence), lr schedule and subsampling, on
the same numpy streams. `device` (None: the CUDA card; `device="cpu"` runs
on the CPU) is where the learner keeps the tables during `fit`; it is
resolved at `fit`, so a model read from a file needs no card. The text
below is the reference's.

TPU-native equivalent of reference
models/sequencevectors/SequenceVectors.java:50 (fit():164): build vocab ->
reset weights -> feed sequences to a pluggable learning algorithm. The
reference's AsyncSequencer producer + VectorCalculationsThread workers
(:954,:1041-1069) running hogwild native kernels become a single host loop
that batches training pairs into deterministic jitted scatter updates
(models/embeddings/learning.py) — the TPU replacement for AggregateSkipGram.

Linear learning-rate decay from `learning_rate` to `min_learning_rate` over
total expected words, and frequent-word subsampling (`sampling` threshold),
match word2vec/reference semantics.
"""
from __future__ import annotations

import logging

import numpy as np

from ..embeddings.learning import ELEMENTS_LEARNING
from ..embeddings.lookup_table import InMemoryLookupTable
from ..word2vec.vocab import VocabCache, build_huffman

log = logging.getLogger(__name__)


class SequenceVectors:
    def __init__(self, *, vector_length=100, window=5, min_word_frequency=1,
                 iterations=1, epochs=1, learning_rate=0.025,
                 min_learning_rate=1e-4, negative=0, use_hierarchic_softmax=True,
                 sampling=0.0, seed=12345, elements_algo="skipgram",
                 batch_pairs=4096, mesh=None, device=None):
        self.vector_length = int(vector_length)
        self.window = int(window)
        self.min_word_frequency = int(min_word_frequency)
        self.iterations = int(iterations)
        self.epochs = int(epochs)
        self.learning_rate = float(learning_rate)
        self.min_learning_rate = float(min_learning_rate)
        self.negative = int(negative)
        self.use_hs = bool(use_hierarchic_softmax)
        self.sampling = float(sampling)
        self.seed = int(seed)
        self.elements_algo = str(elements_algo).lower()
        self.batch_pairs = int(batch_pairs)
        # distributed mode: the tables column-shard over the mesh's
        # "model" ranks (embeddings.learning.configure)
        self.mesh = mesh
        self.device = device
        self.vocab = None
        self.lookup = None
        self._rng = np.random.default_rng(self.seed)

    # ------------------------------------------------------------------
    def build_vocab(self, sequences):
        """sequences: iterable of token lists."""
        vocab = VocabCache()
        n_seq = 0
        for seq in sequences:
            n_seq += 1
            for tok in seq:
                vocab.add_token(tok)
        vocab.finish(self.min_word_frequency)
        if self.use_hs:
            build_huffman(vocab)
        self.vocab = vocab
        self._n_sequences = n_seq
        return vocab

    buildVocab = build_vocab

    # ------------------------------------------------------------------
    def fit(self, sequence_source):
        """sequence_source: callable returning an iterable of token lists
        (called once per epoch), or a list of token lists."""
        if callable(sequence_source):
            get_sequences = sequence_source
        else:
            seqs = list(sequence_source)
            get_sequences = lambda: seqs  # noqa: E731

        if self.vocab is None:
            self.build_vocab(get_sequences())
        if len(self.vocab) == 0:
            raise ValueError("Empty vocabulary — nothing to fit")

        self.lookup = InMemoryLookupTable(
            self.vocab, self.vector_length, seed=self.seed,
            negative=self.negative, use_hs=self.use_hs).reset_weights()

        algo_cls = ELEMENTS_LEARNING.get(self.elements_algo)
        if algo_cls is None:
            raise ValueError(f"Unknown elements learning algorithm "
                             f"'{self.elements_algo}'")
        algo = algo_cls(batch_pairs=self.batch_pairs)
        algo.configure(self.vocab, self.lookup, window=self.window,
                       negative=self.negative, use_hs=self.use_hs,
                       seed=self.seed, mesh=self.mesh, device=self.device)

        total_words = max(self.vocab.total_word_count * self.epochs
                          * self.iterations, 1)
        words_seen = 0
        # corpus-chunk fast path: hand CHUNK sequences to the native pair
        # generator per call (lr decays per chunk instead of per sequence —
        # the reference's per-batch alpha behaves the same way)
        use_batch = (self.iterations == 1
                     and hasattr(algo, "learn_sequences_batch"))
        CHUNK = 256
        for _epoch in range(self.epochs):
            pending, pending_words = [], 0
            for seq in get_sequences():
                ids = self._sequence_ids(seq)
                if not ids:
                    continue
                if use_batch:
                    pending.append(ids)
                    pending_words += len(ids)
                    if len(pending) >= CHUNK:
                        frac = min(words_seen / total_words, 1.0)
                        lr = max(self.min_learning_rate,
                                 self.learning_rate * (1.0 - frac))
                        algo.learn_sequences_batch(pending, lr)
                        words_seen += pending_words
                        pending, pending_words = [], 0
                    continue
                for _ in range(self.iterations):
                    frac = min(words_seen / total_words, 1.0)
                    lr = max(self.min_learning_rate,
                             self.learning_rate * (1.0 - frac))
                    algo.learn_sequence(ids, lr)
                    words_seen += len(ids)
            if pending:
                frac = min(words_seen / total_words, 1.0)
                lr = max(self.min_learning_rate,
                         self.learning_rate * (1.0 - frac))
                algo.learn_sequences_batch(pending, lr)
                words_seen += pending_words
        algo.finish()
        return self

    def _sequence_ids(self, seq):
        """Tokens -> vocab ids with frequent-word subsampling (word2vec
        `sample` formula, as the reference's subsampling in SkipGram)."""
        ids = []
        total = max(self.vocab.total_word_count, 1)
        for tok in seq:
            vw = self.vocab.word_for(tok)
            if vw is None:
                continue
            if self.sampling > 0:
                f = vw.count / total
                keep = (np.sqrt(f / self.sampling) + 1) * self.sampling / f
                if self._rng.random() > keep:
                    continue
            ids.append(vw.index)
        return ids

    # ------------------------------------------------------------------
    # Query API (reference: wordVectors / BasicModelUtils)
    # ------------------------------------------------------------------
    def get_word_vector(self, word):
        return self.lookup.vector(word)

    getWordVector = get_word_vector

    def get_word_vector_matrix(self):
        return self.lookup.get_weights()

    def has_word(self, word):
        return self.vocab is not None and word in self.vocab

    hasWord = has_word

    def similarity(self, a, b):
        from ..embeddings.model_utils import cosine_sim
        va, vb = self.lookup.vector(a), self.lookup.vector(b)
        if va is None or vb is None:
            return float("nan")
        return cosine_sim(va, vb)

    def words_nearest(self, word_or_vec, top_n=10):
        from ..embeddings.model_utils import words_nearest
        return words_nearest(self.vocab, self.lookup, word_or_vec, top_n)

    wordsNearest = words_nearest
