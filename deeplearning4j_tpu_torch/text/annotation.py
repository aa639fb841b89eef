"""Annotation pipeline — UIMA-style analysis over documents.

The port's copy of deeplearning4j_tpu/text/annotation.py, held against it by
tests/test_torch_text_nlp.py; the text below is the reference's.

TPU-native equivalent of reference deeplearning4j-nlp-uima: that module
wraps UIMA AnalysisEngines (SentenceAnnotator, TokenizerAnnotator,
PoStagger, StemmerAnnotator aggregated into pipelines) so tokenization
carries sentence/POS/stem annotations. UIMA itself is a JVM framework; the
capability is reproduced with a small native SPI:

- Annotation(begin, end, type, features) spans over the document text,
- Annotator.process(doc) adds annotations,
- AnnotationPipeline chains annotators (the aggregate AnalysisEngine role).

Annotators provided: SentenceAnnotator (rule-based splitter),
TokenAnnotator (any TokenizerFactory), StemAnnotator (Porter),
PosAnnotator (suffix-heuristic tagger, explicitly approximate — the
reference's PoStagger loads trained OpenNLP models unavailable offline).
"""
from __future__ import annotations

import re


class Annotation:
    def __init__(self, begin, end, type_, features=None):
        self.begin = int(begin)
        self.end = int(end)
        self.type = str(type_)
        self.features = dict(features or {})

    def covered_text(self, text):
        return text[self.begin:self.end]

    def __repr__(self):
        return (f"Annotation({self.type}, {self.begin}:{self.end}, "
                f"{self.features})")


class AnnotatedDocument:
    """The CAS role: text + typed annotation index."""

    def __init__(self, text):
        self.text = str(text)
        self._annotations = []

    def add(self, ann):
        self._annotations.append(ann)
        return ann

    def select(self, type_):
        return [a for a in self._annotations if a.type == type_]

    def covered(self, ann, type_):
        """Annotations of `type_` inside `ann`'s span."""
        return [a for a in self.select(type_)
                if a.begin >= ann.begin and a.end <= ann.end]


class Annotator:
    def process(self, doc: AnnotatedDocument):
        raise NotImplementedError


class SentenceAnnotator(Annotator):
    """reference: uima SentenceAnnotator (OpenNLP there; rule-based here:
    split on ., !, ? followed by whitespace + uppercase/digit/CJK)."""

    _BOUNDARY = re.compile(r"(?<=[.!?])\s+(?=[A-Z0-9぀-鿿])")

    def process(self, doc):
        text = doc.text
        start = 0
        for m in self._BOUNDARY.finditer(text):
            end = m.start() + 1
            if text[start:end].strip():
                doc.add(Annotation(start, end, "sentence"))
            start = m.end()
        if text[start:].strip():
            doc.add(Annotation(start, len(text), "sentence"))


class TokenAnnotator(Annotator):
    """reference: uima TokenizerAnnotator — tokenizes each sentence (or the
    whole text when no sentence annotations exist)."""

    def __init__(self, tokenizer_factory=None):
        if tokenizer_factory is None:
            from .tokenization import DefaultTokenizerFactory
            tokenizer_factory = DefaultTokenizerFactory()
        self.factory = tokenizer_factory

    def process(self, doc):
        spans = doc.select("sentence") or [
            Annotation(0, len(doc.text), "sentence")]
        for s in spans:
            seg = s.covered_text(doc.text)
            seg_low = seg.lower()
            pos = 0
            for tok in self.factory.create(seg).get_tokens():
                found = seg.find(tok, pos)
                if found < 0:   # preprocessor changed the surface form:
                    # case-insensitive re-anchor, and always ADVANCE pos so
                    # later tokens don't stack on one stale offset
                    found = seg_low.find(tok.lower(), pos)
                    if found < 0:
                        found = pos
                pos = min(found + max(len(tok), 1), len(seg))
                doc.add(Annotation(s.begin + found,
                                   s.begin + found + len(tok), "token",
                                   {"text": tok}))


class StemAnnotator(Annotator):
    """reference: uima StemmerAnnotator (snowball there, Porter here) —
    adds a 'stem' feature to every token annotation."""

    def process(self, doc):
        from .stemming import porter_stem
        for t in doc.select("token"):
            t.features["stem"] = porter_stem(
                t.features.get("text", t.covered_text(doc.text)).lower())


class PosAnnotator(Annotator):
    """Suffix-heuristic POS tagger (the reference PoStagger loads trained
    OpenNLP models; offline we tag by morphology — approximate by design,
    feature name matches so downstream code is portable)."""

    _RULES = (("ing", "VBG"), ("ed", "VBD"), ("ly", "RB"), ("tion", "NN"),
              ("ness", "NN"), ("ment", "NN"), ("ous", "JJ"), ("ful", "JJ"),
              ("able", "JJ"), ("ible", "JJ"), ("al", "JJ"), ("s", "NNS"))
    _CLOSED = {"the": "DT", "a": "DT", "an": "DT", "is": "VBZ",
               "are": "VBP", "was": "VBD", "were": "VBD", "be": "VB",
               "been": "VBN", "and": "CC", "or": "CC", "but": "CC",
               "of": "IN", "in": "IN", "on": "IN", "at": "IN",
               "with": "IN", "from": "IN", "by": "IN", "for": "IN",
               "to": "TO", "it": "PRP", "he": "PRP", "she": "PRP",
               "they": "PRP", "we": "PRP", "i": "PRP", "you": "PRP",
               "his": "PRP$", "her": "PRP$", "its": "PRP$",
               "their": "PRP$", "my": "PRP$", "have": "VBP",
               "has": "VBZ", "had": "VBD", "do": "VBP", "does": "VBZ",
               "did": "VBD", "can": "MD", "could": "MD", "will": "MD",
               "would": "MD", "may": "MD", "should": "MD", "must": "MD",
               "not": "RB", "very": "RB", "sat": "VBD", "ran": "VBD",
               "saw": "VBD", "went": "VBD", "made": "VBD", "said": "VBD",
               "chased": "VBD", "ate": "VBD", "big": "JJ", "small": "JJ",
               "quick": "JJ", "old": "JJ", "new": "JJ", "good": "JJ",
               "happy": "JJ", "that": "IN", "this": "DT", "these": "DT",
               "those": "DT"}

    def process(self, doc):
        for t in doc.select("token"):
            w = t.features.get("text", t.covered_text(doc.text)).lower()
            if w in self._CLOSED:
                tag = self._CLOSED[w]
            elif w and w[0].isdigit():
                tag = "CD"
            else:
                tag = next((p for suf, p in self._RULES
                            if w.endswith(suf) and len(w) > len(suf) + 1),
                           "NN")
            t.features["pos"] = tag


class AnnotationPipeline:
    """Aggregate AnalysisEngine role: run annotators in order."""

    def __init__(self, *annotators):
        self.annotators = list(annotators)

    def process(self, text):
        doc = AnnotatedDocument(text)
        for a in self.annotators:
            a.process(doc)
        return doc


def standard_pipeline(tokenizer_factory=None, pos_model=None):
    """sentence -> token -> stem -> pos, the reference's default UIMA
    aggregate. `pos_model` (a `pos_model.PerceptronPosTagger` or a path to
    a serialized model) swaps the suffix-heuristic tagger for the trained
    one — the reference's PoStagger-loads-OpenNLP-model mechanism."""
    if pos_model is not None:
        from .pos_model import TrainedPosAnnotator
        tagger = TrainedPosAnnotator(pos_model)
    else:
        tagger = PosAnnotator()
    return AnnotationPipeline(SentenceAnnotator(),
                              TokenAnnotator(tokenizer_factory),
                              StemAnnotator(), tagger)
