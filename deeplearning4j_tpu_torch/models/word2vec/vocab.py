"""Vocabulary: VocabWord, VocabCache, Huffman coding.

The port's copy of deeplearning4j_tpu/models/word2vec/vocab.py (stdlib
only): vocab order, Huffman codes and points are held equal to the
reference's by tests/test_torch_embeddings.py; the text below is the
reference's.

TPU-native equivalent of reference models/word2vec/wordstore/ (VocabCache /
AbstractCache, 1,460 LoC) and models/word2vec/Huffman.java (hierarchical
softmax tree construction).
"""
from __future__ import annotations

import heapq
from collections import OrderedDict


class VocabWord:
    """reference: models/word2vec/VocabWord.java"""

    __slots__ = ("word", "count", "index", "codes", "points")

    def __init__(self, word, count=1, index=-1):
        self.word = word
        self.count = int(count)
        self.index = int(index)
        self.codes = []      # Huffman code bits (0/1), root->leaf
        self.points = []     # inner-node indices along the path

    def __repr__(self):
        return f"VocabWord({self.word!r}, count={self.count}, idx={self.index})"


class VocabCache:
    """In-memory vocabulary with frequency-ordered indexing.
    reference: models/word2vec/wordstore/inmemory/AbstractCache.java."""

    def __init__(self):
        self._words = OrderedDict()   # word -> VocabWord
        self._by_index = []
        self.total_word_count = 0

    # -- construction ---------------------------------------------------
    def add_token(self, word, count=1):
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word, 0)
            self._words[word] = vw
        vw.count += count
        self.total_word_count += count
        return vw

    def finish(self, min_word_frequency=1):
        """Drop rare words, sort by frequency desc, assign indices."""
        kept = [vw for vw in self._words.values()
                if vw.count >= min_word_frequency]
        kept.sort(key=lambda w: (-w.count, w.word))
        self._words = OrderedDict((w.word, w) for w in kept)
        self._by_index = kept
        for i, vw in enumerate(kept):
            vw.index = i
        self.total_word_count = sum(w.count for w in kept)
        return self

    # -- lookup ---------------------------------------------------------
    def __contains__(self, word):
        return word in self._words

    def __len__(self):
        return len(self._by_index)

    def num_words(self):
        return len(self._by_index)

    numWords = num_words

    def word_for(self, word):
        return self._words.get(word)

    def has_token(self, word):
        return word in self._words

    hasToken = has_token

    def index_of(self, word):
        vw = self._words.get(word)
        return vw.index if vw is not None else -1

    indexOf = index_of

    def word_at_index(self, idx):
        return self._by_index[idx].word

    wordAtIndex = word_at_index

    def word_frequency(self, word):
        vw = self._words.get(word)
        return vw.count if vw is not None else 0

    wordFrequency = word_frequency

    def words(self):
        return list(self._words.keys())

    def vocab_words(self):
        return list(self._by_index)

    vocabWords = vocab_words


def build_huffman(vocab: VocabCache):
    """Assign Huffman codes/points to every vocab word (hierarchical softmax).
    reference: models/word2vec/Huffman.java — two-queue O(V log V) build;
    inner node k gets index k (0 .. V-2), the root is the last created node.
    """
    n = len(vocab)
    if n == 0:
        return vocab
    heap = []
    serial = 0
    for vw in vocab.vocab_words():
        heapq.heappush(heap, (vw.count, serial, ("leaf", vw)))
        serial += 1
    inner_idx = 0
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        node = ("inner", inner_idx, n1, n2)
        inner_idx += 1
        heapq.heappush(heap, (c1 + c2, serial, node))
        serial += 1

    root = heap[0][2]

    # iterative DFS assigning codes (left=0, right=1) and point paths
    stack = [(root, [], [])]
    while stack:
        node, codes, points = stack.pop()
        if node[0] == "leaf":
            vw = node[1]
            vw.codes = codes
            vw.points = points
        else:
            _, idx, left, right = node
            stack.append((left, codes + [0], points + [idx]))
            stack.append((right, codes + [1], points + [idx]))
    return vocab
