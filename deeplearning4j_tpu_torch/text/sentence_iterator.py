"""Sentence / document iterators + label sources.

The port's copy of deeplearning4j_tpu/text/sentence_iterator.py (stdlib
only), held against it by tests/test_torch_embeddings.py; the text below is
the reference's.

TPU-native equivalent of reference text/sentenceiterator/ (Basic/Line/File/
Collection sentence iterators, label-aware variants) and
text/documentiterator/LabelsSource.
"""
from __future__ import annotations

import os


class SentenceIterator:
    def next_sentence(self):
        raise NotImplementedError

    nextSentence = next_sentence

    def has_next(self):
        raise NotImplementedError

    hasNext = has_next

    def reset(self):
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_sentence()


class CollectionSentenceIterator(SentenceIterator):
    """reference: text/sentenceiterator/CollectionSentenceIterator.java"""

    def __init__(self, sentences):
        self._sentences = list(sentences)
        self._pos = 0

    def next_sentence(self):
        s = self._sentences[self._pos]
        self._pos += 1
        return s

    def has_next(self):
        return self._pos < len(self._sentences)

    def reset(self):
        self._pos = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file path or file-like.
    reference: text/sentenceiterator/BasicLineIterator.java"""

    def __init__(self, path):
        self.path = str(path)
        self._fh = None
        self._next = None
        self.reset()

    def _advance(self):
        line = self._fh.readline()
        self._next = line.rstrip("\n") if line else None

    def next_sentence(self):
        s = self._next
        self._advance()
        return s

    def has_next(self):
        return self._next is not None

    def reset(self):
        if self._fh:
            self._fh.close()
        self._fh = open(self.path, "r", encoding="utf-8", errors="replace")
        self._advance()


class FileSentenceIterator(SentenceIterator):
    """All lines of all files under a directory (or a single file).
    reference: text/sentenceiterator/FileSentenceIterator.java"""

    def __init__(self, path):
        self.path = str(path)
        self.reset()

    def _files(self):
        if os.path.isdir(self.path):
            out = []
            for root, _, files in os.walk(self.path):
                out.extend(os.path.join(root, f) for f in sorted(files))
            return sorted(out)
        return [self.path]

    def reset(self):
        self._lines = iter(self._gen())
        self._next = next(self._lines, None)

    def _gen(self):
        for f in self._files():
            with open(f, "r", encoding="utf-8", errors="replace") as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        yield line

    def next_sentence(self):
        s = self._next
        self._next = next(self._lines, None)
        return s

    def has_next(self):
        return self._next is not None


class LabelAwareIterator(SentenceIterator):
    """Sentence iterator that also reports the current document label.
    reference: text/sentenceiterator/labelaware/LabelAwareSentenceIterator.java"""

    def current_label(self):
        raise NotImplementedError

    currentLabel = current_label


class LabelAwareListSentenceIterator(LabelAwareIterator):
    def __init__(self, sentences, labels):
        if len(sentences) != len(labels):
            raise ValueError("sentences and labels must align")
        self._sentences = list(sentences)
        self._labels = list(labels)
        self._pos = 0

    def next_sentence(self):
        s = self._sentences[self._pos]
        self._pos += 1
        return s

    def has_next(self):
        return self._pos < len(self._sentences)

    def reset(self):
        self._pos = 0

    def current_label(self):
        return self._labels[max(0, self._pos - 1)]


class LabelsSource:
    """Generates/holds document labels.
    reference: text/documentiterator/LabelsSource.java"""

    def __init__(self, template="DOC_", labels=None):
        self.template = template
        self._labels = list(labels) if labels else []
        self._counter = 0
        self._fixed = labels is not None

    def next_label(self):
        if self._fixed:
            label = self._labels[self._counter]
        else:
            label = f"{self.template}{self._counter}"
            self._labels.append(label)
        self._counter += 1
        return label

    nextLabel = next_label

    def get_labels(self):
        return list(self._labels)

    getLabels = get_labels

    def store_label(self, label):
        """Record an externally-supplied label (reference storeLabel)."""
        if label not in self._labels:
            self._labels.append(label)
        return label

    storeLabel = store_label

    def reset(self):
        self._counter = 0
