"""Sentence -> parse-tree pipeline (constituency trees over the annotation
SPI).

The port's copy of deeplearning4j_tpu/text/treeparser.py, held against it by
tests/test_torch_text_nlp.py; the text below is the reference's.

TPU-native equivalent of reference deeplearning4j-nlp-uima
text/corpora/treeparser/ (TreeParser.java, TreeFactory.java,
BinarizeTreeTransformer.java, CollapseUnaries.java, HeadWordFinder.java,
TreeVectorizer.java, TreeIterator.java — 1,352 LoC). The reference drives
trained OpenNLP models through UIMA; here the parse is a shallow chunk
layer with BOTH the reference's mechanism and an offline default:
`TreeParser(pos_model=..., chunk_model=...)` loads serialized trained
perceptron models (`pos_model.PerceptronPosTagger` / `PerceptronChunker`
— committed fixtures under tests/fixtures/), while the no-model default
is an Abney-style rule chunker over the heuristic POS annotations.
Either way the artifact family matches: labeled `Tree`s with spans, the
binarize/collapse transformers the reference applies before RNTN-style
training, head-word finding, and batch vectorization/iteration.
"""
from __future__ import annotations

from .annotation import standard_pipeline


class Tree:
    """Labeled constituency node (reference: the nn.layers.feature
    Tree consumed by treeparser/TreeFactory.java): internal nodes carry a
    phrase label; leaves carry the token and its POS in `tags`."""

    def __init__(self, label, children=None, value=None, begin=-1, end=-1,
                 tags=None):
        self.label = label
        self.children = list(children or [])
        self.value = value               # token text (leaves)
        self.begin = int(begin)
        self.end = int(end)
        self.tags = list(tags or [])     # context labels (TreeVectorizer)
        self.gold_label = None

    goldLabel = property(lambda self: self.gold_label)

    def is_leaf(self):
        return not self.children

    isLeaf = is_leaf

    def leaves(self):
        if self.is_leaf():
            return [self]
        out = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    def yield_words(self):
        return [l.value for l in self.leaves()]

    def depth(self):
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def clone(self):
        t = Tree(self.label, [c.clone() for c in self.children],
                 self.value, self.begin, self.end, list(self.tags))
        t.gold_label = self.gold_label
        return t

    def __iter__(self):
        yield self
        for c in self.children:
            yield from c

    def to_string(self):
        """PTB-style bracketing: (S (NP (DT the) (NN cat)) (VP ...))."""
        if self.is_leaf():
            return f"({self.label} {self.value})"
        return (f"({self.label} "
                + " ".join(c.to_string() for c in self.children) + ")")

    __repr__ = to_string


# ---------------------------------------------------------------------------
# Shallow chunker: POS-tagged tokens -> NP/VP/PP chunks -> S tree
# ---------------------------------------------------------------------------

def _chunk(tokens):
    """tokens: list of (word, pos, begin, end). Greedy longest-match
    chunking (Abney-style): NP = DT? (JJ|CD)* NN+ | PRP; VP = MD? VB+ RB*;
    PP = (IN|TO) NP. Unchunked tokens become single-tag nodes."""
    i, n = 0, len(tokens)
    out = []

    def leaf(j):
        w, p, b, e = tokens[j]
        return Tree(p, value=w, begin=b, end=e)

    def phrase(label, lo, hi):
        return Tree(label, [leaf(j) for j in range(lo, hi)],
                    begin=tokens[lo][2], end=tokens[hi - 1][3])

    def match_np(j):
        k = j
        if k < n and tokens[k][1] in ("DT", "PRP$"):
            k += 1
        while k < n and tokens[k][1] in ("JJ", "CD", "VBG"):
            k += 1
        m = k
        while m < n and tokens[m][1] in ("NN", "NNS", "NNP"):
            m += 1
        if m > k and m > j:
            return m
        if j < n and tokens[j][1] == "PRP":
            return j + 1
        return j

    while i < n:
        pos = tokens[i][1]
        if pos in ("IN", "TO"):
            m = match_np(i + 1)
            if m > i + 1:
                pp = Tree("PP", [leaf(i), phrase("NP", i + 1, m)],
                          begin=tokens[i][2], end=tokens[m - 1][3])
                out.append(pp)
                i = m
                continue
        m = match_np(i)
        if m > i:
            out.append(phrase("NP", i, m))
            i = m
            continue
        if pos.startswith("VB") or pos == "MD":
            k = i
            if tokens[k][1] == "MD":
                k += 1
            while k < n and tokens[k][1].startswith("VB"):
                k += 1
            while k < n and tokens[k][1] == "RB":
                k += 1
            if k > i:
                out.append(phrase("VP", i, k))
                i = k
                continue
        out.append(leaf(i))
        i += 1
    return out


def _chunks_from_bio(toks, tagged):
    """Group (word, pos, begin, end) tokens into phrase Trees from BIO
    chunk tags (the trained-chunker path): B-X opens a phrase, I-X
    continues it (an orphan I-X opens one — standard BIO repair), O is a
    bare POS leaf."""
    out = []
    cur_label, cur = None, []

    def leaf(tok):
        w, p, b, e = tok
        return Tree(p, value=w, begin=b, end=e)

    def flush():
        nonlocal cur_label, cur
        if cur:
            out.append(Tree(cur_label, cur, begin=cur[0].begin,
                            end=cur[-1].end))
        cur_label, cur = None, []

    for tok, (_, tag) in zip(toks, tagged):
        if tag == "O":
            flush()
            out.append(leaf(tok))
        elif tag.startswith("B-") or (tag.startswith("I-")
                                      and cur_label != tag[2:]):
            flush()
            cur_label = tag[2:]
            cur = [leaf(tok)]
        else:                                  # I-X continuing X
            cur.append(leaf(tok))
    flush()
    return out


class TreeParser:
    """reference: treeparser/TreeParser.java (getTrees / getTreesWithLabels
    over UIMA sentence+token annotations). `pos_model` / `chunk_model`
    (serialized `pos_model.PerceptronPosTagger` / `PerceptronChunker`
    instances or paths) swap the heuristic tagger and the rule chunker for
    trained models — the reference's OpenNLP en-pos-maxent.bin +
    en-chunker.bin mechanism."""

    def __init__(self, tokenizer_factory=None, pos_model=None,
                 chunk_model=None):
        self.pipeline = standard_pipeline(tokenizer_factory,
                                          pos_model=pos_model)
        if chunk_model is not None:
            from .pos_model import PerceptronChunker
            chunk_model = PerceptronChunker.coerce(chunk_model)
        self.chunk_model = chunk_model

    def get_trees(self, text, pre_processor=None):
        """One S tree per sentence."""
        if pre_processor is not None:
            text = pre_processor.pre_process(text)
        doc = self.pipeline.process(text)
        trees = []
        for sent in doc.select("sentence"):
            toks = [(t.features.get("text", t.covered_text(doc.text)),
                     t.features.get("pos", "NN"), t.begin, t.end)
                    for t in doc.covered(sent, "token")]
            if not toks:
                continue
            if self.chunk_model is not None:
                tagged = self.chunk_model.tag([(w, p)
                                               for w, p, _, _ in toks])
                chunks = _chunks_from_bio(toks, tagged)
            else:
                chunks = _chunk(toks)
            trees.append(Tree("S", chunks, begin=sent.begin,
                              end=sent.end))
        return trees

    getTrees = get_trees

    def get_trees_with_labels(self, text, labels, pre_processor=None):
        """Trees whose leaves carry `tags` = the allowed label set
        (upper-cased, reference getTreesWithLabels contract)."""
        labels = [str(l).upper() for l in labels]
        trees = self.get_trees(text, pre_processor)
        for t in trees:
            for node in t:
                node.tags = list(labels)   # per-node copy: no aliasing
        return trees

    getTreesWithLabels = get_trees_with_labels


# ---------------------------------------------------------------------------
# Transformers — reference treeparser/transformer/ + BinarizeTreeTransformer
# ---------------------------------------------------------------------------

class TreeTransformer:
    def transform(self, tree):
        raise NotImplementedError

    transformTree = transform


class BinarizeTreeTransformer(TreeTransformer):
    """Left-binarize n-ary nodes with @label intermediates (the reference's
    pre-RNTN normalization: every internal node ends up with <= 2
    children)."""

    def transform(self, tree):
        t = tree.clone()
        self._bin(t)
        return t

    def _bin(self, node):
        for c in node.children:
            self._bin(c)
        while len(node.children) > 2:
            # fold the leftmost pair; each intermediate has exactly 2 kids
            pair = node.children[:2]
            inter = Tree(f"@{node.label}", pair,
                         begin=pair[0].begin, end=pair[-1].end)
            node.children = [inter] + node.children[2:]


class CollapseUnaries(TreeTransformer):
    """Collapse unary chains X -> Y -> ... (reference CollapseUnaries:
    keeps the top label, drops single-child intermediates)."""

    def transform(self, tree):
        t = tree.clone()
        return self._collapse(t)

    def _collapse(self, node):
        while len(node.children) == 1 and not node.children[0].is_leaf():
            node.children = node.children[0].children
        node.children = [self._collapse(c) if not c.is_leaf() else c
                         for c in node.children]
        return node


class HeadWordFinder:
    """Per-label head rules (reference HeadWordFinder.java's Collins-style
    table, reduced): NP -> last noun; VP -> first verb; PP -> first
    preposition (or NP head with include_pp_head); S -> VP's head."""

    def __init__(self, include_pp_head=False):
        self.include_pp_head = bool(include_pp_head)

    def find_head(self, tree):
        if tree.is_leaf():
            return tree
        label = tree.label.lstrip("@")
        kids = tree.children
        if label == "NP":
            for c in reversed(kids):
                if c.label.startswith("NN") or c.label in ("NP", "PRP"):
                    return self.find_head(c)
        elif label == "VP":
            for c in kids:
                if c.label.startswith("VB") or c.label == "VP":
                    return self.find_head(c)
        elif label == "PP":
            if self.include_pp_head:
                for c in kids:
                    if c.label == "NP":
                        return self.find_head(c)
            for c in kids:
                if c.label in ("IN", "TO"):
                    return c
        elif label == "S":
            for c in kids:
                if c.label == "VP":
                    return self.find_head(c)
        return self.find_head(kids[0])

    findHead = find_head


class TreeVectorizer:
    """reference TreeVectorizer.java: sentences -> transformed trees ready
    for recursive models (binarized, unaries collapsed, context labels
    attached)."""

    def __init__(self, parser=None):
        self.parser = parser or TreeParser()
        self._binarize = BinarizeTreeTransformer()
        self._collapse = CollapseUnaries()

    def get_trees_with_labels(self, text, label=None, labels=None):
        labels = list(labels or [])
        if label is not None and label not in labels:
            labels.append(label)
        trees = self.parser.get_trees_with_labels(text, labels)
        out = []
        for t in trees:
            t = self._collapse.transform(self._binarize.transform(t))
            if label is not None:
                t.gold_label = label
            out.append(t)
        return out

    getTreesWithLabels = get_trees_with_labels


class TreeIterator:
    """reference TreeIterator.java: batch tree production over a sentence
    iterator (LabelAwareSentenceIterator role: labelled batches)."""

    def __init__(self, sentence_iterator, labels=None, vectorizer=None,
                 batch_size=3):
        self.it = sentence_iterator
        self.labels = list(labels or [])
        self.vectorizer = vectorizer or TreeVectorizer()
        self.batch_size = int(batch_size)

    def has_next(self):
        return self.it.has_next()

    hasNext = has_next

    def next(self, num=None):
        num = num or self.batch_size
        out = []
        while self.it.has_next() and len(out) < num:
            sentence = self.it.next_sentence()
            label = None
            if hasattr(self.it, "current_label"):
                label = self.it.current_label()
            out.extend(self.vectorizer.get_trees_with_labels(
                sentence, label=label, labels=self.labels))
        return out

    def reset(self):
        self.it.reset()
