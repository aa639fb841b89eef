"""The port's `text/` NLP modules against the JAX package's: annotation,
stemming, the trained POS tagger and chunker, the tree parser, the inverted
index, the document iterators and the bag-of-words / TF-IDF vectorizers.

Every module here is stdlib and numpy, so the port's are copies, and the
same inputs (the reference's own test sentences and fixtures) must give
equal outputs in both packages:
  - annotations (type, span, features), tags, chunks, trees (bracketing,
    spans, context tags, gold labels), stems: equal;
  - index hits, positions, batches and every iterator's order: equal;
  - bag-of-words and TF-IDF matrices: within 1e-12 (also under
    hypothesis), and the `DataSet` of `vectorize` is the port's;
  - POS and chunk model files: the committed fixtures load in both, a model
    trained in both from the same corpus has equal weights, and each
    package loads the other's saved file (the decompressed JSON is equal).
"""
import gzip
import os
import types

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.text import annotation as TA
from deeplearning4j_tpu_torch.text import document_iterator as TD
from deeplearning4j_tpu_torch.text import inverted_index as TI
from deeplearning4j_tpu_torch.text import pos_model as TP
from deeplearning4j_tpu_torch.text import sentence_iterator as TSI
from deeplearning4j_tpu_torch.text import stemming as TS
from deeplearning4j_tpu_torch.text import treeparser as TT
from deeplearning4j_tpu_torch.text import vectorizers as TV

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
POS = os.path.join(FIX, "pos_model.json.gz")
CHUNK = os.path.join(FIX, "chunk_model.json.gz")

SENTENCES = [
    "The runners were running quickly. It was a beautiful day.",
    "The hungry dog chased the ball",
    "green leaves covered the wet ground .",
    "The quick dog chased a small cat.",
    "Two large ships arrived at the port",
    "The quick cat sat on the mat. He was happy.",
    "The big dog chased a small cat in the garden",
    "He sat on the mat",
    "she visited Kyoto yesterday. 3 boys ran home!",
]
STEM_WORDS = [
    "caresses", "ponies", "caress", "cats", "feed", "agreed", "plastered",
    "motoring", "sing", "conflated", "troubling", "sized", "hopping",
    "falling", "happy", "relational", "conditional", "rational", "digitizer",
    "operator", "feudalism", "adjustable", "effective", "probate", "rate",
    "controll", "generalizations", "oscillators", "hopefulness", "a", "by",
    "sky", "electricity", "formalize", "Motoring,", "'Conditional'",
]


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    import importlib
    return types.SimpleNamespace(**{
        n: importlib.import_module(f"deeplearning4j_tpu.text.{n}")
        for n in ("annotation", "cjk_tokenization", "document_iterator",
                  "inverted_index", "pos_model", "sentence_iterator",
                  "stemming", "treeparser", "vectorizers")})


def _annotations(doc):
    return [(a.type, a.begin, a.end, sorted(a.features.items()))
            for a in doc._annotations]


def _tree(t):
    """A tree as nested tuples of everything it carries."""
    return (t.label, t.value, t.begin, t.end, tuple(t.tags), t.gold_label,
            tuple(_tree(c) for c in t.children))


# ---------------------------------------------------------------------------
# stemming, annotation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("word", STEM_WORDS)
def test_porter_stem_and_preprocessor_equal(R, word):
    assert TS.porter_stem(word) == R.stemming.porter_stem(word)
    assert (TS.StemmingPreprocessor().pre_process(word)
            == R.stemming.StemmingPreprocessor().pre_process(word))


@pytest.mark.parametrize("model", [None, "pos"])
@pytest.mark.parametrize("text", SENTENCES)
def test_standard_pipeline_annotations_equal(R, text, model):
    path = POS if model else None
    ours = TA.standard_pipeline(pos_model=path).process(text)
    ref = R.annotation.standard_pipeline(pos_model=path).process(text)
    assert _annotations(ours) == _annotations(ref)
    for s, rs in zip(ours.select("sentence"), ref.select("sentence")):
        assert ([a.begin for a in ours.covered(s, "token")]
                == [a.begin for a in ref.covered(rs, "token")])


def test_custom_annotators_equal(R):
    from deeplearning4j_tpu_torch.text import JapaneseTokenizerFactory
    text = "私は東京に住む。It runs."
    ours = TA.AnnotationPipeline(
        TA.SentenceAnnotator(), TA.TokenAnnotator(JapaneseTokenizerFactory()),
        TA.StemAnnotator(), TA.PosAnnotator()).process(text)
    a = R.annotation
    ref = a.AnnotationPipeline(
        a.SentenceAnnotator(),
        a.TokenAnnotator(R.cjk_tokenization.JapaneseTokenizerFactory()),
        a.StemAnnotator(), a.PosAnnotator()).process(text)
    assert _annotations(ours) == _annotations(ref)
    assert all(ours.text[t.begin:t.end] for t in ours.select("token"))


# ---------------------------------------------------------------------------
# the trained tagger and chunker, and their files
# ---------------------------------------------------------------------------

def test_model_formats_are_the_reference_s(R):
    assert TP.FORMAT_NAME == R.pos_model.FORMAT_NAME
    assert TP.FORMAT_VERSION == R.pos_model.FORMAT_VERSION
    for kind in ("PerceptronPosTagger", "PerceptronChunker"):
        assert (getattr(TP, kind).FORMAT
                == getattr(R.pos_model, kind).FORMAT)


@pytest.mark.parametrize("text", SENTENCES)
def test_fixture_tagger_and_chunker_equal(R, text):
    words = text.split()
    ours = TP.PerceptronPosTagger.load(POS).tag(words)
    ref = R.pos_model.PerceptronPosTagger.load(POS).tag(words)
    assert ours == ref
    assert (TP.PerceptronChunker.load(CHUNK).tag(ours)
            == R.pos_model.PerceptronChunker.load(CHUNK).tag(ref))


def _corpus():
    tagged = TP.PerceptronPosTagger.load(POS)
    return [tagged.tag(s.split()) for s in SENTENCES]


@pytest.mark.parametrize("kind", ["PerceptronPosTagger", "PerceptronChunker"])
def test_training_and_files_cross_read(R, tmp_path, kind):
    corpus = _corpus()
    if kind == "PerceptronChunker":   # (word, pos) items, BIO-ish labels
        corpus = [[(p, "B-" + p[1][:2]) for p in s] for s in corpus]
    ours = getattr(TP, kind).train(corpus, epochs=4, seed=3)
    ref = getattr(R.pos_model, kind).train(corpus, epochs=4, seed=3)
    assert ours.weights == ref.weights and ours.tags == ref.tags
    a, b = str(tmp_path / "ours.json.gz"), str(tmp_path / "ref.json.gz")
    ours.save(a)
    ref.save(b)
    with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
        assert fa.read() == fb.read()
    seq = ([p for p, _ in corpus[0]] if kind == "PerceptronChunker"
           else SENTENCES[3].split())
    assert (getattr(R.pos_model, kind).load(a).tag(seq)
            == getattr(TP, kind).load(b).tag(seq) == ours.tag(seq))


def test_format_guards_equal(R, tmp_path):
    import json
    bad = tmp_path / "fut.json.gz"
    with gzip.open(bad, "wt") as f:
        json.dump({"format": TP.FORMAT_NAME, "version": 99, "tags": [],
                   "weights": {}}, f)
    for mod in (TP, R.pos_model):
        with pytest.raises(ValueError):
            mod.PerceptronPosTagger.load(str(bad))
        with pytest.raises(ValueError):
            mod.PerceptronChunker.load(POS)
    assert isinstance(TP.TrainedPosAnnotator(POS).model,
                      TP.PerceptronPosTagger)


# ---------------------------------------------------------------------------
# the tree parser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("models", ["rules", "pos", "pos+chunk"])
@pytest.mark.parametrize("text", SENTENCES)
def test_trees_equal(R, text, models):
    kw = {"rules": {}, "pos": {"pos_model": POS},
          "pos+chunk": {"pos_model": POS, "chunk_model": CHUNK}}[models]
    ours = TT.TreeParser(**kw).get_trees(text)
    ref = R.treeparser.TreeParser(**kw).get_trees(text)
    assert [_tree(t) for t in ours] == [_tree(t) for t in ref]
    assert [t.to_string() for t in ours] == [t.to_string() for t in ref]
    labelled = TT.TreeParser(**kw).get_trees_with_labels(text, ["pos", "neg"])
    want = R.treeparser.TreeParser(**kw).get_trees_with_labels(
        text, ["pos", "neg"])
    assert [_tree(t) for t in labelled] == [_tree(t) for t in want]


@pytest.mark.parametrize("text", SENTENCES[1:5])
def test_transformers_and_head_finder_equal(R, text):
    (ours,), (ref,) = (TT.TreeParser().get_trees(text),
                       R.treeparser.TreeParser().get_trees(text))
    assert (_tree(TT.BinarizeTreeTransformer().transform(ours))
            == _tree(R.treeparser.BinarizeTreeTransformer().transform(ref)))
    assert (_tree(TT.CollapseUnaries().transform(ours))
            == _tree(R.treeparser.CollapseUnaries().transform(ref)))
    for pp in (False, True):
        for a, b in zip(ours, ref):
            ha = TT.HeadWordFinder(include_pp_head=pp).find_head(a)
            hb = R.treeparser.HeadWordFinder(include_pp_head=pp).find_head(b)
            assert (ha.value, ha.begin) == (hb.value, hb.begin)


def test_bio_repair_equal(R):
    toks = [("ships", "NNS", 0, 5), ("sail", "VBP", 6, 10),
            ("home", "NN", 11, 15)]
    tagged = [(("ships", "NNS"), "I-NP"), (("sail", "VBP"), "B-VP"),
              (("home", "NN"), "I-NP")]
    assert ([_tree(t) for t in TT._chunks_from_bio(toks, tagged)]
            == [_tree(t) for t in R.treeparser._chunks_from_bio(toks, tagged)])


def test_tree_vectorizer_and_iterator_equal(R):
    text = "The big dog chased a small cat in the garden"
    assert ([_tree(t) for t in TT.TreeVectorizer().get_trees_with_labels(
        text, label="pos")] == [_tree(t) for t in R.treeparser.TreeVectorizer(
            ).get_trees_with_labels(text, label="pos")])
    docs, labels = ["The cat sat", "The dog ran", "He was happy"], list("abc")

    def batches(tp, si):
        it = tp.TreeIterator(si.LabelAwareListSentenceIterator(docs, labels),
                             labels=labels, batch_size=2)
        out = []
        for _ in range(2):              # twice, through reset
            while it.has_next():
                out.append([_tree(t) for t in it.next()])
            it.reset()
        return out
    assert batches(TT, TSI) == batches(R.treeparser, R.sentence_iterator)


# ---------------------------------------------------------------------------
# the inverted index and the document iterators
# ---------------------------------------------------------------------------

def _index_ops(mod):
    idx = mod.InMemoryInvertedIndex()
    ids = [idx.append(["the", "quick", "fox"], label="animals"),
           idx.append(["the", "lazy", "dog"], label="animals"),
           idx.append(["quick", "quick", "sort"], label="code")]
    idx.add_word_to_doc(5, "fox")           # sparse ids auto-extend
    idx.add_words_to_doc(6, [], label="spam")
    idx.finish()
    seen = []
    idx.eachDoc(lambda d: seen.append(list(d)))
    words = ["the", "quick", "fox", "sort", "missing"]
    return (ids, idx.num_documents(), idx.total_words(),
            [idx.documents(w) for w in words],
            [idx.word_frequency(w) for w in words],
            [idx.positions("quick", d) for d in range(4)],
            [idx.document(d) for d in range(7)],
            [idx.document_with_label(d) for d in (0, 2, 6)],
            [list(map(list, b)) for b in idx.mini_batches(batch_size=2)],
            [list(d) for d in idx.docs()], seen)


def test_inverted_index_equal(R):
    assert _index_ops(TI) == _index_ops(R.inverted_index)


def _doc_tree(root):
    (root / "b.txt").write_text("second doc")
    (root / "a.txt").write_text("first doc")
    for label, texts in [("pos", ["good", "great"]), ("neg", ["bad"])]:
        d = root / label
        d.mkdir()
        for i, t in enumerate(texts):
            (d / f"{i}.txt").write_text(t)


def _iterators(di, si, root):
    out = {"files": list(di.FileDocumentIterator(root))}
    for name, it in (("by_dir", di.FileLabelAwareIterator(root / "pos")),
                     ("labels", di.FileLabelAwareIterator(root)),
                     ("names", di.FilenamesLabelAwareIterator(root)),
                     ("basic", di.BasicLabelAwareIterator(
                         si.CollectionSentenceIterator(["s one", "s two"]))),
                     ("simple", di.SimpleLabelAwareIterator(
                         [(f"c{i}", f"L{i % 3}") for i in range(7)]))):
        docs = [(d.content, d.labels) for d in it]
        out[name] = (docs, sorted(it.get_labels_source().get_labels()))
    return out


def test_document_iterators_equal(R, tmp_path):
    _doc_tree(tmp_path)
    assert (_iterators(TD, TSI, tmp_path)
            == _iterators(R.document_iterator, R.sentence_iterator, tmp_path))


@pytest.mark.parametrize("buffer_size", [1, 4, 64])
def test_async_iterator_keeps_the_order(R, buffer_size):
    docs = [(f"content {i}", f"L{i}") for i in range(40)]

    def run(di):
        it = di.AsyncLabelAwareIterator(di.SimpleLabelAwareIterator(docs),
                                        buffer_size=buffer_size)
        first = [(d.content, d.label) for d in it]
        it.reset()
        head = it.next_labelled().content
        it.reset()
        return first, head, [(d.content, d.label) for d in it]
    ours = run(TD)
    assert ours == run(R.document_iterator)
    assert ours[0] == docs and ours[1] == "content 0"


# ---------------------------------------------------------------------------
# the vectorizers
# ---------------------------------------------------------------------------

DOCS = ["the cat sat on the mat", "the dog sat", "cats and dogs and mats",
        "a mat for the cat", "dogs dogs dogs"]


@pytest.mark.parametrize("kind", ["BagOfWordsVectorizer", "TfidfVectorizer"])
@pytest.mark.parametrize("min_freq", [1, 2])
def test_vectorizer_matrices_equal(R, kind, min_freq):
    ours = getattr(TV, kind)(min_word_frequency=min_freq)
    ref = getattr(R.vectorizers, kind)(min_word_frequency=min_freq)
    a, b = ours.fit_transform(DOCS), ref.fit_transform(DOCS)
    assert ours.vocab.words() == ref.vocab.words()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.transform("the cat and a new word"),
                               ref.transform("the cat and a new word"),
                               rtol=0, atol=1e-12)
    labels = ["pets", "pets", "pets", "home", "pets"]
    ds, rds = ours.vectorize(DOCS, labels), ref.vectorize(DOCS, labels)
    assert type(ds) is DataSet
    np.testing.assert_allclose(ds.features, np.asarray(rds.features),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ds.labels, np.asarray(rds.labels))
    assert ours.vectorize(DOCS).labels is None


_DOC = st.lists(st.sampled_from("cat dog fish bird tree sun moon".split()),
                min_size=1, max_size=12).map(" ".join)


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(docs=st.lists(_DOC, min_size=1, max_size=8))
def test_vectorizers_equal_under_hypothesis(R, docs):
    for kind in ("BagOfWordsVectorizer", "TfidfVectorizer"):
        a = getattr(TV, kind)().fit_transform(docs)
        b = getattr(R.vectorizers, kind)().fit_transform(docs)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    bow = TV.BagOfWordsVectorizer().fit(docs)
    for doc in docs:
        assert bow.transform(doc).sum() == len(doc.split())
