"""In-memory inverted index over tokenized documents.

The port's copy of deeplearning4j_tpu/text/inverted_index.py, held against
it by tests/test_torch_text_nlp.py; the text below is the reference's.

TPU-native equivalent of reference
text/invertedindex/InvertedIndex.java (+ the in-memory implementation the
reference builds on it): documents are stored as lists of vocab words with
optional labels; the index maps each word to the documents (and positions)
containing it. Used for context-window sampling and mini-batch iteration in
embedding training.
"""
from __future__ import annotations

import threading


class InMemoryInvertedIndex:
    """reference: text/invertedindex/InvertedIndex.java SPI. Documents are
    integer-indexed; words are any hashables (typically VocabWord tokens or
    strings)."""

    def __init__(self, vocab=None):
        self.vocab = vocab
        self._docs = []            # doc index -> [word, ...]
        self._labels = []          # doc index -> label | None
        self._index = {}           # word -> {doc index -> [positions]}
        self._lock = threading.Lock()
        self._finished = False

    # -- building -------------------------------------------------------
    def add_word_to_doc(self, doc, word):
        """reference: addWordToDoc(int, T)."""
        with self._lock:
            while len(self._docs) <= doc:
                self._docs.append([])
                self._labels.append(None)
            pos = len(self._docs[doc])
            self._docs[doc].append(word)
            self._index.setdefault(word, {}).setdefault(doc, []).append(pos)

    addWordToDoc = add_word_to_doc

    def add_words_to_doc(self, doc, words, label=None):
        """reference: addWordsToDoc(int, List<T>) (+ label overloads)."""
        with self._lock:   # grow slots even for an empty document
            while len(self._docs) <= doc:
                self._docs.append([])
                self._labels.append(None)
        for w in words:
            self.add_word_to_doc(doc, w)
        if label is not None:
            with self._lock:
                self._labels[doc] = label
        return doc

    addWordsToDoc = add_words_to_doc

    def append(self, words, label=None):
        """Convenience: add a new document, returning its index."""
        with self._lock:
            doc = len(self._docs)
            self._docs.append([])
            self._labels.append(None)
        return self.add_words_to_doc(doc, words, label)

    def finish(self):
        """reference: finish() — freeze the index for iteration."""
        self._finished = True

    # -- queries --------------------------------------------------------
    def document(self, index):
        """reference: document(int)."""
        return list(self._docs[index])

    def document_with_label(self, index):
        """reference: documentWithLabel(int) -> Pair<List<T>, String>."""
        return list(self._docs[index]), self._labels[index]

    documentWithLabel = document_with_label

    def documents(self, word):
        """reference: documents(T) — doc indices containing `word`."""
        return sorted(self._index.get(word, {}))

    def word_frequency(self, word):
        """Total occurrences across all documents."""
        return sum(len(p) for p in self._index.get(word, {}).values())

    wordFrequency = word_frequency

    def positions(self, word, doc):
        return list(self._index.get(word, {}).get(doc, []))

    def num_documents(self):
        return len(self._docs)

    numDocuments = num_documents

    def total_words(self):
        return sum(len(d) for d in self._docs)

    totalWords = total_words

    def docs(self):
        """reference: docs() — iterator over token lists."""
        return iter(list(d) for d in self._docs)

    def mini_batches(self, batch_size=32):
        """reference: batchIter/miniBatches — yield lists of documents."""
        batch = []
        for d in self._docs:
            batch.append(list(d))
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    miniBatches = mini_batches

    def eachDoc(self, fn):
        """reference: eachDoc(Function, ExecutorService) — apply fn to every
        document (synchronously; the XLA-side work is already batched)."""
        for d in self._docs:
            fn(list(d))
