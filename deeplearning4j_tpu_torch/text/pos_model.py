"""Trained statistical POS tagging + chunking with a serialized model
format.

The port's copy of deeplearning4j_tpu/text/pos_model.py, held against it by
tests/test_torch_text_nlp.py; the text below is the reference's.

The reference's UIMA annotators wrap TRAINED OpenNLP maxent models
(deeplearning4j-nlp-uima PoStagger / text/corpora/treeparser/TreeParser.java
loads en-pos-maxent.bin, en-chunker.bin etc.); `annotation.PosAnnotator`
and the rule chunker in `treeparser._chunk` are the offline stand-ins.
This module closes the mechanism gap: greedy averaged-perceptron sequence
taggers (the shape of OpenNLP's beam=1 maxent decoders — per-position
feature templates over the input and the previous predicted tags) with
train / save / load, so annotators and the tree parser are driven by
serialized trained models exactly like the reference, retrainable on any
tagged corpus. Tiny trained fixtures are committed at
tests/fixtures/pos_model.json.gz and tests/fixtures/chunk_model.json.gz
(trained by tools/train_pos_fixture.py / tools/train_chunker_fixture.py)
the same way the CIFAR/LFW format fixtures drive the data parsers.

Model format: gzip JSON — {"format": <per-model name>, "version",
"tags": [...], "weights": {feature: {tag: float}}}. Weights are the
AVERAGED perceptron weights.
"""
from __future__ import annotations

import gzip
import json
import os

FORMAT_NAME = "dl4j-tpu-pos-perceptron"          # kept for back-compat
FORMAT_VERSION = 1

START = ("-START-", "-START2-")


class _AveragedPerceptron:
    """Greedy left-to-right averaged-perceptron sequence tagger core.
    Subclasses define the input item type via `_context` (one per
    sequence) and `_features_at` (one per position, may read the two
    previous predicted tags — teacher-forced during training)."""

    FORMAT = None

    def __init__(self, weights=None, tags=None):
        self.weights = weights or {}       # feature -> {tag: weight}
        self.tags = list(tags or [])

    # -- hooks -------------------------------------------------------------
    def _context(self, seq):
        raise NotImplementedError

    def _features_at(self, i, ctx, prev, prev2):
        raise NotImplementedError

    # -- inference ---------------------------------------------------------
    def _predict(self, feats):
        scores = dict.fromkeys(self.tags, 0.0)
        for f in feats:
            wf = self.weights.get(f)
            if wf is None:
                continue
            for tag, w in wf.items():
                scores[tag] += w
        # deterministic argmax (score, then tag name)
        return max(self.tags, key=lambda t: (scores[t], t))

    def tag(self, seq):
        """[(item, tag)] for one input sequence."""
        seq = list(seq)
        ctx = self._context(seq)
        prev, prev2 = START
        out = []
        for i, item in enumerate(seq):
            t = self._predict(self._features_at(i, ctx, prev, prev2))
            out.append((item, t))
            prev2, prev = prev, t
        return out

    # -- training ----------------------------------------------------------
    @classmethod
    def train(cls, sentences, epochs=8, seed=0):
        """sentences: iterable of [(item, gold)] pairs. Averaged
        perceptron: on a wrong greedy prediction, +1 the gold tag's
        feature weights and -1 the predicted tag's; final weights are the
        average over every update step (stabilizes the tiny-corpus
        case). Gold tags feed the history (teacher forcing, the OpenNLP
        training regime)."""
        import random

        sents = [list(s) for s in sentences]
        tags = sorted({t for s in sents for _, t in s})
        self = cls(weights={}, tags=tags)
        totals = {}                        # (feat, tag) -> accumulated
        stamps = {}                        # (feat, tag) -> step of last chg
        step = 0
        rng = random.Random(seed)

        def upd(feat, tag, delta):
            key = (feat, tag)
            cur = self.weights.setdefault(feat, {}).get(tag, 0.0)
            totals[key] = (totals.get(key, 0.0)
                           + (step - stamps.get(key, 0)) * cur)
            stamps[key] = step
            self.weights[feat][tag] = cur + delta

        for _ in range(epochs):
            rng.shuffle(sents)
            for sent in sents:
                ctx = self._context([item for item, _ in sent])
                prev, prev2 = START
                for i, (_item, gold) in enumerate(sent):
                    feats = self._features_at(i, ctx, prev, prev2)
                    guess = self._predict(feats)
                    if guess != gold:
                        for f in feats:
                            upd(f, gold, +1.0)
                            upd(f, guess, -1.0)
                    prev2, prev = prev, gold
                    step += 1
        # finalize averages
        for (feat, tag), total in totals.items():
            cur = self.weights[feat][tag]
            avg = (total + (step - stamps[(feat, tag)]) * cur) / max(step, 1)
            if abs(avg) > 1e-9:
                self.weights[feat][tag] = round(avg, 6)
            else:
                del self.weights[feat][tag]
        self.weights = {f: wf for f, wf in self.weights.items() if wf}
        return self

    # -- serialization -----------------------------------------------------
    def save(self, path):
        doc = {"format": type(self).FORMAT, "version": FORMAT_VERSION,
               "tags": self.tags, "weights": self.weights}
        with gzip.open(path, "wt", encoding="utf-8") as f:
            json.dump(doc, f)

    @classmethod
    def load(cls, path):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            doc = json.load(f)
        if doc.get("format") != cls.FORMAT:
            raise ValueError(f"not a {cls.FORMAT} model: {path!r} "
                             f"(format {doc.get('format')!r})")
        if doc.get("version", 0) > FORMAT_VERSION:
            raise ValueError(f"model version {doc['version']} newer than "
                             f"supported {FORMAT_VERSION}")
        return cls(weights=doc["weights"], tags=doc["tags"])

    @classmethod
    def coerce(cls, model):
        """Accept a model instance or a path to a serialized model — the
        ONE place the path-or-instance idiom lives for every consumer
        (annotators, TreeParser)."""
        if isinstance(model, (str, os.PathLike)):
            return cls.load(os.fspath(model))
        return model


class PerceptronPosTagger(_AveragedPerceptron):
    """POS tagger over raw words (OpenNLP en-pos-maxent role)."""

    FORMAT = FORMAT_NAME

    def _context(self, words):
        return (["-BOS-"] + [w.lower() for w in words] + ["-EOS-"], words)

    def _features_at(self, i, ctx, prev, prev2):
        """OpenNLP-style templates: word form, affixes, shape, neighbors
        and the two previous predicted tags."""
        context, words = ctx
        word = words[i]
        w = word.lower()
        feats = {
            "bias",
            f"w={w}",
            f"suf3={w[-3:]}",
            f"suf2={w[-2:]}",
            f"suf1={w[-1:]}",
            f"pre1={w[:1]}",
            f"t-1={prev}",
            f"t-2={prev2}",
            f"t-1&w={prev}&{w}",
            f"w-1={context[i]}",           # context is BOS-padded by one
            f"w+1={context[i + 2]}",
        }
        if word[:1].isupper():
            feats.add("cap")
        if any(c.isdigit() for c in word):
            feats.add("digit")
        if "-" in word:
            feats.add("hyphen")
        return feats


class PerceptronChunker(_AveragedPerceptron):
    """BIO shallow chunker over (word, pos) pairs (OpenNLP en-chunker
    role): tags B-NP/I-NP/B-VP/I-VP/B-PP/I-PP/O, consumed by
    `treeparser.TreeParser(chunk_model=...)`."""

    FORMAT = "dl4j-tpu-chunk-perceptron"

    def _context(self, pairs):
        words = ["-BOS-"] + [w.lower() for w, _ in pairs] + ["-EOS-"]
        pos = ["-BOS-"] + [p for _, p in pairs] + ["-EOS-"]
        return (words, pos)

    def _features_at(self, i, ctx, prev, prev2):
        words, pos = ctx
        j = i + 1                           # padded index
        return {
            "bias",
            f"w={words[j]}",
            f"p={pos[j]}",
            f"p-1={pos[j - 1]}",
            f"p+1={pos[j + 1]}",
            f"p-1&p={pos[j - 1]}&{pos[j]}",
            f"p&p+1={pos[j]}&{pos[j + 1]}",
            f"w-1={words[j - 1]}",
            f"w+1={words[j + 1]}",
            f"t-1={prev}",
            f"t-2={prev2}",
            f"t-1&p={prev}&{pos[j]}",
        }


class TrainedPosAnnotator:
    """Annotator driven by a serialized trained model — the reference
    PoStagger mechanism (load model, annotate `pos` features), replacing
    the suffix-heuristic `PosAnnotator` when a model is available."""

    def __init__(self, model):
        self.model = PerceptronPosTagger.coerce(model)

    def process(self, doc):
        for sent in doc.select("sentence"):
            toks = doc.covered(sent, "token")
            words = [t.features.get("text", t.covered_text(doc.text))
                     for t in toks]
            if not words:
                continue
            for t, (_, tag) in zip(toks, self.model.tag(words)):
                t.features["pos"] = tag
