"""The port's embeddings path against the JAX package's: SkipGram and CBOW
(`models/embeddings/learning.py`), `SequenceVectors`, `Word2Vec`,
`ParagraphVectors`, `Glove`, the lookup table, the serializer, the static
mmap store, the vocab and Huffman codes, and the two `text/` modules.

The same numpy inputs go to both packages: tables drawn with numpy from a
seed (bit-equal in both; the reference's are carried over with
`lookup_table.from_reference`), and the same pair and negative streams from
the learners' numpy generators and the native pair generator. Held, on the
CPU:
  - one device step of each kind (skip-gram with negative sampling and with
    hierarchical softmax, CBOW with both, GloVe's AdaGrad batch) from the
    same tables and index arrays, ids repeated within a chunk: 1e-5;
  - the deterministic scatter-add (`learning._Fold`): within 1e-6 of a
    sequential `index_add_`, and bit-equal run to run; every position but
    an id's last adds exactly -0.0;
  - a forced partial flush (padding, valid mask, mean lr): 1e-5;
  - whole fits on a cut-down toy corpus with the same seed (Word2Vec
    skip-gram HS and negative, CBOW; ParagraphVectors DBOW and DM;
    GloVe): vocab, Huffman codes and points equal, the route (native pairs)
    the same in both, tables within 1e-5 (abs + rel); `infer_vector`
    equal; two CPU fits bit-equal;
  - the reference's quality pins (tests/test_word2vec.py) rebuilt on the
    port;
  - the serializer's files byte for byte (gzip: the decompressed bytes;
    zips: member names and bytes, the weights' arrays), each package
    reading the other's; the static store's files and queries;
  - what raises: `mesh=`, `lower_step` (item 20), and `device=None` without
    a card.
Whole-fit parity is held on a cut-down corpus: the two packages' f32 dot
products round differently (~1e-7 a step), and over a long fit at lr 0.05
the differences grow to ~2e-5 on entries of size ~1.9 (8 epochs of the
full toy corpus).

Tests marked `gpu` run on the card and skip without one:
    python -m pytest --noconftest tests/test_torch_embeddings.py -m gpu
"""
import gzip
import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.common import native_ops as TN
from deeplearning4j_tpu_torch.models import (Glove, ParagraphVectors,
                                             SequenceVectors, Word2Vec)
from deeplearning4j_tpu_torch.models.embeddings import learning as TL
from deeplearning4j_tpu_torch.models.embeddings import serializer as TS
from deeplearning4j_tpu_torch.models.embeddings.lookup_table import (
    InMemoryLookupTable, from_reference)
from deeplearning4j_tpu_torch.models.embeddings.model_utils import cosine_sim
from deeplearning4j_tpu_torch.models.glove.glove import glove_step
from deeplearning4j_tpu_torch.models.word2vec.static_word2vec import (
    StaticWord2Vec, write_static_model)
from deeplearning4j_tpu_torch.models.word2vec.vocab import (VocabCache,
                                                            build_huffman)
from deeplearning4j_tpu_torch.text import (CollectionSentenceIterator,
                                           CommonPreprocessor,
                                           DefaultTokenizerFactory,
                                           NGramTokenizerFactory)

ANIMALS = ["cat", "dog", "pet", "fur", "tail", "paw", "claw", "kitten",
           "puppy", "whisker", "leash", "collar"]
VEHICLES = ["car", "truck", "road", "wheel", "engine", "tire", "brake",
            "gear", "fuel", "axle", "lane", "horn"]
CPU = "cpu"


def _toy_corpus(n_repeat=150, seed=0):
    """tests/test_word2vec.py's two topic clusters (one vehicle word named
    differently): words co-occur within a cluster, never across."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_repeat):
        seqs.append(list(rng.choice(ANIMALS, 6, replace=False)))
        seqs.append(list(rng.choice(VEHICLES, 6, replace=False)))
    return seqs


def _check_clusters(model):
    intra = model.similarity("cat", "dog")
    inter = model.similarity("cat", "car")
    assert intra > inter + 0.2, (intra, inter)
    nearest = model.words_nearest("cat", top_n=4)
    assert set(nearest) <= set(ANIMALS), nearest


def _close(ours, ref, tol=1e-5):
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import types

    import jax.numpy as jnp

    from deeplearning4j_tpu.common import native_ops
    from deeplearning4j_tpu.models import (Glove, ParagraphVectors,
                                           SequenceVectors, Word2Vec)
    from deeplearning4j_tpu.models.embeddings import learning, lookup_table
    from deeplearning4j_tpu.models.embeddings import serializer
    from deeplearning4j_tpu.models.glove import glove
    from deeplearning4j_tpu.models.word2vec import static_word2vec, vocab
    from deeplearning4j_tpu.text import sentence_iterator, tokenization
    return types.SimpleNamespace(
        jnp=jnp, N=native_ops, L=learning, T=lookup_table, S=serializer,
        G=glove, V=vocab, SW=static_word2vec, SI=sentence_iterator,
        TK=tokenization, Glove=Glove, ParagraphVectors=ParagraphVectors,
        SequenceVectors=SequenceVectors, Word2Vec=Word2Vec)


# ---------------------------------------------------------------------------
# vocab, Huffman, text
# ---------------------------------------------------------------------------

def _vocab_pair(J, n=60, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.zipf(1.5, n).clip(1, 10_000)
    vs = []
    for V in (J.V, None):
        v = J.V.VocabCache() if V else VocabCache()
        for i, c in enumerate(counts):
            v.add_token(f"w{i}", int(c))
        v.finish()
        (J.V.build_huffman if V else build_huffman)(v)
        vs.append(v)
    return vs


def _assert_vocab_equal(ours, ref):
    assert len(ours) == len(ref)
    assert ours.total_word_count == ref.total_word_count
    for a, b in zip(ours.vocab_words(), ref.vocab_words()):
        assert (a.word, a.count, a.index) == (b.word, b.count, b.index)
        assert list(a.codes) == list(b.codes)
        assert list(a.points) == list(b.points)


def test_vocab_and_huffman_equal(J):
    ref, ours = _vocab_pair(J)
    _assert_vocab_equal(ours, ref)
    assert max(len(w.codes) for w in ours.vocab_words()) > 5


def test_text_modules_equal(J):
    tf, rtf = DefaultTokenizerFactory(), J.TK.DefaultTokenizerFactory()
    tf.set_token_pre_processor(CommonPreprocessor())
    rtf.set_token_pre_processor(J.TK.CommonPreprocessor())
    text = "Hello, World! 123 foo. The cat's tail"
    assert tf.create(text).get_tokens() == rtf.create(text).get_tokens() \
        == ["hello", "world", "foo", "the", "cats", "tail"]
    ngrams = [F(min_n=1, max_n=2).create("a b c").get_tokens()
              for F in (NGramTokenizerFactory, J.TK.NGramTokenizerFactory)]
    assert ngrams[0] == ngrams[1] == ["a", "b", "c", "a b", "b c"]
    sents = ["one two", "three", "four five six"]
    it, rit = (CollectionSentenceIterator(sents),
               J.SI.CollectionSentenceIterator(sents))
    out = []
    for i in (it, rit):
        i.reset()
        out.append([i.next_sentence() for _ in range(3)] + [i.has_next()])
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the device steps
# ---------------------------------------------------------------------------

V_STEP, D_STEP, B_STEP = 40, 16, 256


def _tables(seed, rows=(V_STEP, V_STEP)):
    rng = np.random.default_rng(seed)
    return [((rng.random((r, D_STEP)) - 0.5) / 4).astype(np.float32)
            for r in rows]


def _zipf_ids(rng, shape, n):
    return (rng.zipf(1.3, shape).clip(1, n) - 1).astype(np.int32)


def _ns_batch(seed, B=B_STEP, K=5):
    rng = np.random.default_rng(seed)
    targets = _zipf_ids(rng, (B, K + 1), V_STEP)
    labels = np.zeros((B, K + 1), np.float32)
    labels[:, 0] = 1.0
    mask = (rng.random((B, K + 1)) > 0.1).astype(np.float32)
    return targets, labels, mask


def _hs_batch(J, seed, B=B_STEP):
    """Hierarchical softmax rows as the learner builds them: each pair's
    Huffman path (every path shares the root) and 1 - code."""
    _, vocab = _vocab_pair(J, V_STEP, seed)
    L = max(len(w.codes) for w in vocab.vocab_words())
    out = np.random.default_rng(seed).integers(0, V_STEP, B)
    targets = np.zeros((B, L), np.int32)
    labels = np.zeros((B, L), np.float32)
    mask = np.zeros((B, L), np.float32)
    for r, o in enumerate(out):
        w = vocab.vocab_words()[o]
        targets[r, :len(w.codes)] = w.points
        labels[r, :len(w.codes)] = 1.0 - np.asarray(w.codes)
        mask[r, :len(w.codes)] = 1.0
    return targets, labels, mask


def _port_step(step, tables, *arrays, device=CPU):
    ts = [torch.tensor(t, device=device) for t in tables]
    args = [torch.as_tensor(np.asarray(a)).to(
        device, torch.int64 if np.asarray(a).dtype.kind == "i"
        else torch.float32) for a in arrays]
    step(*ts, *args)
    return [t.cpu().numpy() for t in ts]


def _repeats(idx):
    """Whether some 64-row chunk of idx holds an id twice."""
    idx = np.asarray(idx).reshape(-1, 64, *np.shape(idx)[1:])
    return any(len(np.unique(c)) < c.size for c in idx)


@pytest.mark.parametrize("hs", [False, True], ids=["neg", "hs"])
def test_sg_step_matches_reference(J, hs):
    syn0, syn1 = _tables(1)
    rng = np.random.default_rng(2)
    centers = _zipf_ids(rng, (B_STEP,), V_STEP)
    targets, labels, mask = (_hs_batch(J, 3) if hs else _ns_batch(3))
    assert _repeats(centers) and _repeats(targets)
    lr = np.float32(0.05)
    ref = J.L._sg_step(J.jnp.array(syn0), J.jnp.array(syn1), centers,
                       targets, labels, mask, lr)
    ours = _port_step(TL.sg_step, (syn0, syn1), centers, targets, labels,
                      mask, lr)
    for a, b, start in zip(ours, ref, (syn0, syn1)):
        assert np.abs(np.asarray(b) - start).max() > 1e-3   # it moved
        _close(a, b)


@pytest.mark.parametrize("hs", [False, True], ids=["neg", "hs"])
def test_cbow_step_matches_reference(J, hs):
    syn0, syn1 = _tables(4)
    rng = np.random.default_rng(5)
    context = _zipf_ids(rng, (B_STEP, 7), V_STEP)
    context[rng.random(context.shape) < 0.3] = -1      # padding
    context[0] = -1                                    # a row of padding
    cmask = (context >= 0).astype(np.float32)
    targets, labels, tmask = (_hs_batch(J, 6) if hs else _ns_batch(6))
    lr = np.float32(0.05)
    ref = J.L._cbow_step(J.jnp.array(syn0), J.jnp.array(syn1), context,
                         cmask, targets, labels, tmask, lr)
    ours = _port_step(TL.cbow_step, (syn0, syn1), context, cmask, targets,
                      labels, tmask, lr)
    for a, b in zip(ours, ref):
        _close(a, b)


def test_glove_step_matches_reference(J):
    V, D, B = 30, 12, 512
    rng = np.random.default_rng(7)
    init = lambda s: ((rng.random(s) - 0.5) / D).astype(np.float32)  # noqa
    state = {"W": init((V, D)), "Wc": init((V, D)), "b": init((V,)),
             "bc": init((V,)),
             "hW": rng.random((V, D)).astype(np.float32) * 1e-2,
             "hWc": rng.random((V, D)).astype(np.float32) * 1e-2,
             "hb": rng.random((V,)).astype(np.float32) * 1e-2,
             "hbc": np.zeros((V,), np.float32)}
    wi, wj = _zipf_ids(rng, (B,), V), _zipf_ids(rng, (B,), V)
    x = rng.random(B).astype(np.float64) * 5 + 0.2
    fx = (np.minimum(x / 3.0, 1.0) ** 0.75).astype(np.float32)
    fx[-40:] = 0.0                                     # padding
    logx = np.log(x).astype(np.float32)
    lr = np.float32(0.1)
    ref = J.G._glove_step({k: J.jnp.array(v) for k, v in state.items()},
                          wi, wj, logx, fx, lr)
    ours = {k: torch.tensor(v) for k, v in from_reference(state).items()}
    glove_step(ours, torch.tensor(wi).long(), torch.tensor(wj).long(),
               torch.tensor(logx), torch.tensor(fx), torch.tensor(lr))
    for k in state:
        _close(ours[k].numpy(), ref[k])


# ---------------------------------------------------------------------------
# the deterministic scatter-add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,width", [(384, 24), (1, 5), (700, 1)])
def test_fold_equals_sequential_index_add(n, width):
    rng = np.random.default_rng(n)
    idx = torch.tensor(_zipf_ids(rng, (n,), 20)).long()
    # update-sized rows (lr-scaled gradients) on table-sized entries
    rows = torch.tensor(rng.standard_normal((n, width)).astype(np.float32)
                        * 0.05)
    table = torch.tensor(rng.standard_normal((20, width)).astype(np.float32))
    want = table.clone().index_add_(0, idx, rows)
    got = table.clone()
    TL.scatter_add_(got, idx, rows)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    again = table.clone()
    TL.scatter_add_(again, idx, rows)
    assert torch.equal(got, again)
    # 1-D tables (GloVe's biases) take the same route
    flat = table[:, 0].clone()
    TL.scatter_add_(flat, idx, rows[:, 0])
    torch.testing.assert_close(flat, want[:, 0], rtol=1e-6, atol=1e-6)


def test_fold_adds_minus_zero_off_each_ids_last_position():
    idx = torch.tensor([3, 1, 3, 3, 0, 1])
    rows = torch.arange(1.0, 7.0)[:, None]
    fold = TL._Fold(idx)
    assert fold.ids.tolist() == [0, 1, 1, 3, 3, 3]
    assert fold.last.tolist() == [True, False, True, False, False, True]
    seen = []
    table = torch.zeros(4, 1)
    table.index_add_ = lambda dim, ids, r: seen.append(r) or table
    fold.add_(table, rows)
    r = seen[0][:, 0]
    assert r.tolist() == [5.0, 0.0, 8.0, 0.0, 0.0, 8.0]
    # the non-last positions are -0.0: x + -0.0 == x for every float x
    assert torch.signbit(r[[1, 3, 4]]).all()
    x = torch.tensor([0.0, -0.0, 1e-45, -3.5, float("inf")])
    assert torch.equal((x + -0.0).view(torch.int32), x.view(torch.int32))


# ---------------------------------------------------------------------------
# learners: flush, fits, routes
# ---------------------------------------------------------------------------

def _learners(J, algo, *, hs, batch_pairs, seed=3):
    """The reference's learner and the port's on the same table (the
    reference's, carried over)."""
    vocab = J.V.VocabCache()
    rng = np.random.default_rng(seed)
    for i in range(V_STEP):
        vocab.add_token(f"w{i}", int(rng.zipf(1.5)))
    vocab.finish()
    if hs:
        J.V.build_huffman(vocab)
    ref_table = J.T.InMemoryLookupTable(
        vocab, D_STEP, seed=seed, negative=0 if hs else 5,
        use_hs=hs).reset_weights()
    our_table = from_reference(ref_table)
    kw = dict(window=3, negative=0 if hs else 5, use_hs=hs, seed=seed)
    ref = J.L.ELEMENTS_LEARNING[algo](batch_pairs=batch_pairs)
    ref.configure(vocab, ref_table, **kw)
    ours = TL.ELEMENTS_LEARNING[algo](batch_pairs=batch_pairs)
    ours.configure(our_table.vocab, our_table, device=CPU, **kw)
    return (ref, ref_table), (ours, our_table)


@pytest.mark.parametrize("algo,hs", [("skipgram", False), ("skipgram", True),
                                     ("cbow", False)])
def test_forced_partial_flush_matches_reference(J, algo, hs):
    """Two sequences at two lrs, then a forced flush: full batches and a
    padded tail (valid mask, the tail's mean lr)."""
    bp = 128 if algo == "skipgram" else 64
    (ref, rt), (ours, ot) = _learners(J, algo, hs=hs, batch_pairs=bp)
    rng = np.random.default_rng(9)
    seqs = [rng.integers(0, V_STEP, 40).tolist() for _ in range(2)]
    for a in (ref, ours):
        a.learn_sequence(seqs[0], 0.05)
        a.learn_sequence(seqs[1], 0.02)
        assert 0 < a._pending_count < bp
        a.finish()
    assert ours._flushed_pairs == ref._flushed_pairs
    assert ours.flushes == -(-ref._flushed_pairs // bp) >= 2
    assert ref._flushed_pairs % bp
    _close(ot.syn0, rt.syn0)
    name = "syn1" if hs else "syn1neg"
    _close(getattr(ot, name), getattr(rt, name))


def _w2v(M, algo, neg, **kw):
    b = (M.Builder().layer_size(16).window_size(3).seed(7)
         .min_word_frequency(1).learning_rate(0.05).epochs(3)
         .elements_learning_algorithm(algo))
    b = b.negative_sample(neg) if neg else b.use_hierarchic_softmax(True)
    if kw:
        b = b.device(kw["device"])
    return b.build()


@pytest.fixture
def native_route(J):
    """Both packages generate pairs natively (assert the route)."""
    assert TN.available() and J.N.available()


@pytest.mark.parametrize("algo,neg", [("skipgram", 0), ("skipgram", 5),
                                      ("cbow", 5)])
def test_word2vec_fit_matches_reference(J, native_route, algo, neg):
    corpus = _toy_corpus(40)
    ref = _w2v(J.Word2Vec, algo, neg).fit(corpus)
    ours = _w2v(Word2Vec, algo, neg, device=CPU).fit(corpus)
    _assert_vocab_equal(ours.vocab, ref.vocab)
    _close(ours.lookup.syn0, ref.lookup.syn0)
    name = "syn1neg" if neg else "syn1"
    _close(getattr(ours.lookup, name), getattr(ref.lookup, name))
    again = _w2v(Word2Vec, algo, neg, device=CPU).fit(corpus)
    np.testing.assert_array_equal(again.lookup.syn0, ours.lookup.syn0)


def _pv(M, algo, **kw):
    b = (M.Builder().layer_size(16).seed(7).learning_rate(0.05).epochs(3)
         .negative_sample(5).sequence_learning_algorithm(algo))
    if kw:
        b = b.device(kw["device"])
    return b.build()


@pytest.mark.parametrize("algo", ["dbow", "dm"])
def test_paragraph_vectors_fit_matches_reference(J, algo):
    docs = [(f"DOC_{i}", t) for i, t in enumerate(_toy_corpus(20))]
    ref = _pv(J.ParagraphVectors, algo).fit(docs)
    ours = _pv(ParagraphVectors, algo, device=CPU).fit(docs)
    _assert_vocab_equal(ours.vocab, ref.vocab)
    assert ours.labels_source.get_labels() == ref.labels_source.get_labels()
    _close(ours.lookup.syn0, ref.lookup.syn0)
    _close(ours.lookup.syn1neg, ref.lookup.syn1neg)
    # infer_vector is host numpy in both, on the same tables: equal
    ref.lookup = from_reference(ref.lookup)
    ref.lookup.syn0, ref.lookup.syn1neg = ours.lookup.syn0, \
        ours.lookup.syn1neg
    np.testing.assert_array_equal(ours.infer_vector(["cat", "dog", "pet"]),
                                  J.ParagraphVectors.infer_vector(
                                      ref, ["cat", "dog", "pet"]))


def test_glove_fit_matches_reference(J, native_route):
    def build(M, **kw):
        b = (M.Builder().layer_size(12).window_size(3).seed(7)
             .learning_rate(0.1).epochs(5))
        return (b.device(kw["device"]) if kw else b).build()
    corpus = _toy_corpus(30)
    ref = build(J.Glove).fit(corpus)
    ours = build(Glove, device=CPU).fit(corpus)
    _assert_vocab_equal(ours.vocab, ref.vocab)
    _close(ours.lookup.syn0, ref.lookup.syn0)
    again = build(Glove, device=CPU).fit(corpus)
    np.testing.assert_array_equal(again.lookup.syn0, ours.lookup.syn0)


def test_from_reference_carries_tables_as_they_are(J):
    (ref, rt), (ours, ot) = _learners(J, "skipgram", hs=True,
                                      batch_pairs=64)
    for name in ("syn0", "syn1"):
        np.testing.assert_array_equal(getattr(ot, name), getattr(rt, name))
    _assert_vocab_equal(ot.vocab, rt.vocab)
    # the port draws the same tables from the same seed
    mine = InMemoryLookupTable(ot.vocab, D_STEP, seed=3, negative=5,
                               use_hs=True).reset_weights()
    np.testing.assert_array_equal(mine.syn0, rt.syn0)
    ref_neg = J.T.InMemoryLookupTable(rt.vocab, D_STEP, seed=3, negative=5,
                                      use_hs=False).reset_weights()
    np.testing.assert_array_equal(mine.neg_table, ref_neg.neg_table)


# ---------------------------------------------------------------------------
# the reference's quality pins (tests/test_word2vec.py), on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo,neg,epochs", [
    ("skipgram", 0, 8), ("skipgram", 5, 8), ("cbow", 5, 10)])
def test_word2vec_clusters(algo, neg, epochs):
    b = (Word2Vec.Builder().layer_size(24).window_size(3).seed(7)
         .min_word_frequency(1).learning_rate(0.05).epochs(epochs)
         .elements_learning_algorithm(algo).device(CPU))
    b = b.negative_sample(neg) if neg else b.use_hierarchic_softmax(True)
    _check_clusters(b.build().fit(_toy_corpus()))


def test_sentence_iterator_path():
    sentences = [" ".join(s) for s in _toy_corpus(60)]
    w2v = (Word2Vec.Builder().layer_size(16).window_size(3).seed(3)
           .epochs(8).learning_rate(0.05).device(CPU)
           .iterate(CollectionSentenceIterator(sentences))
           .tokenizer_factory(DefaultTokenizerFactory()).build())
    w2v.fit()
    assert w2v.has_word("cat")
    assert w2v.get_word_vector("cat").shape == (16,)


def test_dbow_document_clusters():
    docs = [(f"DOC_{i}", t) for i, t in enumerate(_toy_corpus(60))]
    pv = (ParagraphVectors.Builder().layer_size(24).seed(7)
          .learning_rate(0.05).epochs(25).negative_sample(5)
          .sequence_learning_algorithm("dbow").device(CPU).build())
    pv.fit(docs)
    va0, va2, vv1 = (pv.get_label_vector(f"DOC_{i}") for i in (0, 2, 1))
    assert cosine_sim(va0, va2) > cosine_sim(va0, vv1) + 0.15


def test_dm_and_infer():
    docs = [(f"DOC_{i}", t) for i, t in enumerate(_toy_corpus(60))]
    pv = (ParagraphVectors.Builder().layer_size(24).seed(7)
          .learning_rate(0.05).epochs(6).negative_sample(5)
          .sequence_learning_algorithm("dm").device(CPU).build())
    pv.fit(docs)
    inferred = pv.infer_vector(["cat", "dog", "pet"])
    assert inferred.shape == (24,)
    assert cosine_sim(inferred, pv.get_word_vector("fur")) > \
        cosine_sim(inferred, pv.get_word_vector("wheel"))


def test_paragraph_vectors_label_space():
    """tests/test_word2vec.py:231-262 on the port: duplicate labels are
    stored once, and a refit replaces the label space."""
    pv = (ParagraphVectors.Builder().layer_size(8).window_size(2).seed(1)
          .epochs(2).negative_sample(5).device(CPU).build())
    pv.fit([("D_A", ["cat", "dog"] * 4), ("D_B", ["car", "road"] * 4),
            ("D_A", ["pet", "fur"] * 4)])
    assert pv.labels_source.get_labels() == ["D_A", "D_B"]
    pv.fit([("Y", ["e", "f", "g", "h"] * 4)])
    assert pv.labels_source.get_labels() == ["Y"]


def test_glove_clusters():
    g = (Glove.Builder().layer_size(24).window_size(3).seed(7)
         .learning_rate(0.1).epochs(25).device(CPU).build())
    _check_clusters(g.fit(_toy_corpus()))


# ---------------------------------------------------------------------------
# serializer and the static store
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(J):
    """A Word2Vec (HS), a negative-sampling ParagraphVectors and a GloVe,
    trained by the port; the reference's twins hold the same tables."""
    w2v = (Word2Vec.Builder().layer_size(12).window_size(3).seed(7)
           .epochs(2).learning_rate(0.05).device(CPU).build()
           .fit(_toy_corpus(20)))
    pv = (ParagraphVectors.Builder().layer_size(12).window_size(3).seed(4)
          .epochs(2).negative_sample(5).device(CPU).build())
    pv.fit([("D_A", ["cat", "dog", "fur", "pet"] * 5),
            ("D_B", ["car", "wheel", "road", "drive"] * 5)])
    g = (Glove.Builder().layer_size(12).window_size(3).seed(7)
         .learning_rate(0.1).epochs(2).device(CPU).build()
         .fit(_toy_corpus(10)))
    return {"w2v": w2v, "pv": pv, "glove": g}


def _twin(J, model):
    """The reference's model object over the port's vocab and tables."""
    import types
    lookup = J.T.InMemoryLookupTable(model.vocab, model.lookup.vector_length,
                                     negative=model.lookup.negative,
                                     use_hs=model.lookup.use_hs)
    for name in ("syn0", "syn1", "syn1neg", "neg_table"):
        setattr(lookup, name, getattr(model.lookup, name))
    labels = getattr(model, "labels_source", None)
    return types.SimpleNamespace(
        vocab=model.vocab, lookup=lookup,
        labels_source=labels and J.SI.LabelsSource(
            labels=labels.get_labels()))


def _zip_members(path):
    with zipfile.ZipFile(path) as zf:
        out = {}
        for n in zf.namelist():
            data = zf.read(n)
            if n.endswith(".npz"):
                arrays = np.load(io.BytesIO(data))
                data = {k: arrays[k].tobytes() for k in arrays.files}
            out[n] = data
    return out


FORMATS = {
    "text": ("vec.txt", "write_word2vec_text", "read_word2vec_text", "w2v"),
    "gzip": ("vec.txt.gz", "write_word2vec_text", "read_word2vec_text",
             "w2v"),
    "binary": ("vec.bin", "write_word2vec_binary", "read_word2vec_binary",
               "w2v"),
    "full": ("m.zip", "write_full_model", "read_full_model", "w2v"),
    "paragraph": ("pv.zip", "write_paragraph_vectors",
                  "read_paragraph_vectors", "pv"),
    "glove": ("glove.txt", "write_glove_text", "read_word2vec_text",
              "glove"),
}


@pytest.mark.parametrize("fmt", FORMATS)
def test_serializer_files_equal_and_cross_read(J, models, tmp_path, fmt):
    name, write, read, which = FORMATS[fmt]
    model = models[which]
    ours, ref = tmp_path / f"port-{name}", tmp_path / f"ref-{name}"
    getattr(TS, write)(model, str(ours))
    getattr(J.S, write)(_twin(J, model), str(ref))
    if name.endswith(".zip"):
        assert _zip_members(ours) == _zip_members(ref)
    elif name.endswith(".gz"):
        assert ours.read_bytes()[:2] == b"\x1f\x8b"
        assert gzip.decompress(ours.read_bytes()) == \
            gzip.decompress(ref.read_bytes())
    else:
        assert ours.read_bytes() == ref.read_bytes()
    # each package reads the other's file
    for reader, path in ((getattr(TS, read), ref), (getattr(J.S, read), ours)):
        back = reader(str(path))
        assert back.vocab.words() == model.vocab.words()
        tol = 1e-6 if fmt in ("text", "gzip", "glove") else 0.0
        np.testing.assert_allclose(back.lookup.syn0, model.lookup.syn0,
                                   rtol=0, atol=tol)
    if fmt == "paragraph":
        pv = TS.read_paragraph_vectors(str(ref))
        assert pv.labels_source.get_labels() == ["D_A", "D_B"]
        assert pv.use_hs is False and pv.negative == 5
        assert isinstance(pv, ParagraphVectors)
        assert np.isfinite(pv.infer_vector(["cat", "dog"])).all()


def test_static_store_equals_reference_and_trained_model(J, models,
                                                         tmp_path):
    m = models["w2v"]
    write_static_model(m, str(tmp_path / "ours"))
    J.SW.write_static_model(_twin(J, m), str(tmp_path / "ref"))
    for f in ("vectors.npy", "norms.npy", "vocab.json"):
        assert (tmp_path / "ours" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes()
    sm = StaticWord2Vec(str(tmp_path / "ref"), mmap=True)
    rm = J.SW.StaticWord2Vec(str(tmp_path / "ours"), mmap=True)
    np.testing.assert_allclose(sm.word_vector("cat"), m.lookup.vector("cat"),
                               rtol=1e-6)
    assert abs(sm.similarity("cat", "dog") - m.similarity("cat", "dog")) \
        < 1e-5
    assert sm.words_nearest("cat", top_n=4) == m.words_nearest("cat", 4) \
        == rm.words_nearest("cat", top_n=4)
    assert sm.words_nearest_sum(["cat", "dog"], ["car"], 3) == \
        rm.words_nearest_sum(["cat", "dog"], ["car"], 3)
    assert sm.has_word("cat") and not sm.has_word("zeppelin")
    assert not hasattr(sm, "fit") and not hasattr(sm, "train")
    with open(tmp_path / "ours" / "vocab.json") as fh:
        assert json.load(fh)["words"] == m.vocab.words()


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------

def test_unported_and_cardless_calls_raise(monkeypatch):
    vocab = VocabCache()
    for w in ("a", "b", "c"):
        vocab.add_token(w)
    vocab.finish()
    table = InMemoryLookupTable(vocab, 4, negative=2,
                                use_hs=False).reset_weights()
    # item 20's mesh paths work: a one-rank mesh is the unsharded run; the
    # vector length must divide over the model ranks; lower_step records
    # no collective on one rank and puts the tables back
    from deeplearning4j_tpu_torch.parallel.sharding import Mesh, make_mesh
    with pytest.raises(ValueError, match="does not divide over the 3"):
        TL.SkipGram().configure(vocab, table, negative=2, use_hs=False,
                                mesh=Mesh(None, ("data", "model"), (1, 3),
                                          0, CPU), device=CPU)
    sg = TL.SkipGram().configure(vocab, table, negative=2, use_hs=False,
                                 device=CPU, mesh=make_mesh(device=CPU))
    before = sg._syn0.clone(), sg._syn1.clone()
    assert sg.lower_step().footprint == {}
    assert torch.equal(sg._syn0, before[0]) and \
        torch.equal(sg._syn1, before[1])
    corpus = _toy_corpus(2)
    a = (Word2Vec.Builder().mesh(make_mesh(device=CPU)).device(CPU).seed(3)
         .build().fit(corpus))
    b = Word2Vec.Builder().device(CPU).seed(3).build().fit(corpus)
    np.testing.assert_array_equal(a.lookup.syn0, b.lookup.syn0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in (Word2Vec.Builder().build(), Glove.Builder().build(),
                  ParagraphVectors.Builder().build()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            if isinstance(model, ParagraphVectors):
                model.fit([("D", ["a", "b", "c"])])
            else:
                model.fit(_toy_corpus(2))
    # reading a model needs no card
    assert SequenceVectors(vector_length=4).device is None


# ---------------------------------------------------------------------------
# Card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_runs(sg_or_cbow, cuda, hs, graph):
    """One flush of 4 chunks from the same table, on the card (eager or
    graph) and on the CPU; returns the tables."""
    import types
    J = types.SimpleNamespace(V=types.SimpleNamespace(
        VocabCache=VocabCache, build_huffman=build_huffman))
    out = []
    for dev in (cuda, CPU):
        vocab, _ = _vocab_pair(J, V_STEP, 1)
        table = InMemoryLookupTable(vocab, D_STEP, seed=1,
                                    negative=0 if hs else 5,
                                    use_hs=hs).reset_weights()
        a = TL.ELEMENTS_LEARNING[sg_or_cbow](batch_pairs=B_STEP,
                                             cuda_graph=graph)
        a.configure(vocab, table, window=3, negative=0 if hs else 5,
                    use_hs=hs, seed=2, device=dev)
        rng = np.random.default_rng(4)
        for _ in range(3):
            a.learn_sequence(rng.integers(0, V_STEP, 60).tolist(), 0.05)
        a.finish()
        out.append((table.syn0, table.syn1 if hs else table.syn1neg))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("algo,hs", [("skipgram", False), ("skipgram", True),
                                     ("cbow", False)])
def test_flush_on_card_matches_cpu_and_is_deterministic(cuda, algo, hs):
    (g0, g1), (c0, c1) = _card_runs(algo, cuda, hs, graph=True)
    _close(g0, c0)
    _close(g1, c1)
    (e0, e1), _ = _card_runs(algo, cuda, hs, graph=False)
    np.testing.assert_array_equal(e0, g0)      # graph == eager, bit for bit
    np.testing.assert_array_equal(e1, g1)
    (r0, r1), _ = _card_runs(algo, cuda, hs, graph=True)
    np.testing.assert_array_equal(r0, g0)      # two card runs
    np.testing.assert_array_equal(r1, g1)


@pytest.mark.gpu
def test_glove_fit_on_card_matches_cpu(cuda):
    def fit(dev):
        return (Glove.Builder().layer_size(12).window_size(3).seed(7)
                .learning_rate(0.1).epochs(5).device(dev).build()
                .fit(_toy_corpus(30)))
    card, cpu = fit(cuda), fit(CPU)
    _close(card.lookup.syn0, cpu.lookup.syn0)
    np.testing.assert_array_equal(fit(cuda).lookup.syn0, card.lookup.syn0)
