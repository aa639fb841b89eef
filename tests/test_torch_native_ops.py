"""The port's own loader for the native C++ library
(`deeplearning4j_tpu_torch/common/native_ops.py`) against the JAX package's
(`deeplearning4j_tpu/common/native_ops.py`). Both load a library built from
the same `native/dl4j_tpu_native.cpp`: the port's into `build/native/`, the
reference's into `native/`. Held, on the CPU:
  - both report the same `available()`, and the port's library lies under
    `build/native/` with a name that hashes the source;
  - `skipgram_pairs`, `cbow_contexts`, `glove_cooc` and `pack_corpus` return
    equal arrays from both loaders for the same ids, offsets, window and
    seed;
  - the IDX and numeric CSV parsers: the native route and the Python
    fallback give the same values, both ways, in the port, and the port's
    readers equal the reference's;
  - with the library forced off in both packages (both `get_lib` return
    None), the numpy fallbacks of the skip-gram and CBOW corpus routes and
    GloVe's dict counting give equal results in both packages.
"""
import os
import struct

import numpy as np
import pytest

from deeplearning4j_tpu_torch.common import native_ops as TN
from deeplearning4j_tpu_torch.datasets import mnist as TM
from deeplearning4j_tpu_torch.datasets import records as TR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def JN():
    pytest.importorskip("jax")
    from deeplearning4j_tpu.common import native_ops
    return native_ops


def _corpus(seed, n_seq=40, vocab=50):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, vocab, int(rng.integers(1, 30))).tolist()
            for _ in range(n_seq)]
    return seqs


def test_available_matches_reference(JN):
    assert TN.available() == JN.available()
    assert TN.available(), "g++ builds the library on this machine"
    path = TN.library_path()
    assert path.parent == TN.BUILD_DIR
    assert str(TN.BUILD_DIR).startswith(os.path.join(REPO, "build"))
    assert path.exists()
    assert TN.get_lib().dl4j_abi_version() == TN._ABI_VERSION == \
        JN._ABI_VERSION


@pytest.mark.parametrize("window,seed", [(1, 0), (3, 7), (5, 2**63 - 1)])
def test_skipgram_pairs_equal(JN, window, seed):
    ids, offsets = TN.pack_corpus(_corpus(window))
    ours = TN.skipgram_pairs(ids, offsets, window, seed)
    ref = JN.skipgram_pairs(ids, offsets, window, seed)
    assert len(ours[0]) > 0
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("window,seed", [(1, 3), (5, 11)])
def test_cbow_contexts_equal(JN, window, seed):
    ids, offsets = TN.pack_corpus(_corpus(window + 10))
    ours = TN.cbow_contexts(ids, offsets, window, seed)
    ref = JN.cbow_contexts(ids, offsets, window, seed)
    assert ours[0].shape[1] == 2 * window and (ours[0] == -1).any()
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("symmetric", [True, False])
def test_glove_cooc_equal(JN, symmetric):
    ids, offsets = TN.pack_corpus(_corpus(4))
    ours = TN.glove_cooc(ids, offsets, 4, symmetric)
    ref = JN.glove_cooc(ids, offsets, 4, symmetric)
    assert len(ours[0]) > 0
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_pack_corpus_equal(JN):
    seqs = _corpus(9)
    for a, b in zip(TN.pack_corpus(seqs), JN.pack_corpus(seqs)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def _write_u8_idx(path, data):
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, data.ndim))
        f.write(struct.pack(">" + "I" * data.ndim, *data.shape))
        f.write(data.tobytes())


def test_read_idx_routes_equal_both_ways(JN, tmp_path, monkeypatch):
    """The native route returns the raw bytes as f32, the Python route as
    u8: the same values, in either direction, and the port's reader equals
    the reference's."""
    from deeplearning4j_tpu.datasets import mnist as JM
    data = np.random.default_rng(0).integers(0, 256, (6, 5, 4),
                                             dtype=np.uint8)
    p = str(tmp_path / "x-idx3-ubyte")
    _write_u8_idx(p, data)
    native = TM.read_idx(p)
    assert native.dtype == np.float32
    np.testing.assert_array_equal(native, np.asarray(JM.read_idx(p)))
    np.testing.assert_array_equal(TN.read_idx_u8(p, 0.5),
                                  JN.read_idx_u8(p, 0.5))
    with monkeypatch.context() as m:
        m.setattr(TN, "get_lib", lambda: None)
        python = TM.read_idx(p)
    assert python.dtype == np.uint8
    np.testing.assert_array_equal(native, python.astype(np.float32))
    np.testing.assert_array_equal(native.astype(np.uint8), python)


def test_csv_routes_equal_both_ways(JN, tmp_path, monkeypatch):
    """A numeric CSV: native records are floats, Python's are strings that
    the iterators convert with float(); the values are equal both ways and
    equal the reference's records. Non-numeric content takes the Python
    route in both packages."""
    from deeplearning4j_tpu.datasets import records as JR
    p = tmp_path / "m.csv"
    p.write_text("h1;h2;h3\n1.5;2;3\n-4;5e-2;6\n7;8;9.25\n")
    native = TR.CSVRecordReader(str(p), skip_lines=1, delimiter=";")
    assert all(isinstance(v, float) for r in native._records for v in r)
    ref = JR.CSVRecordReader(str(p), skip_lines=1, delimiter=";")
    assert native._records == ref._records
    with monkeypatch.context() as m:
        m.setattr(TN, "get_lib", lambda: None)
        python = TR.CSVRecordReader(str(p), skip_lines=1, delimiter=";")
    assert all(isinstance(v, str) for r in python._records for v in r)
    as_float = [[float(np.float32(v)) for v in r] for r in python._records]
    assert as_float == native._records
    assert [[str(np.float32(v)) for v in r] for r in native._records] == \
        [[str(np.float32(v)) for v in r] for r in python._records]
    s = tmp_path / "s.csv"
    s.write_text("a,b\nc,d\n")
    assert TN.parse_csv(str(s)) is None
    assert TR.CSVRecordReader(str(s))._records == \
        JR.CSVRecordReader(str(s))._records == [["a", "b"], ["c", "d"]]


@pytest.fixture
def no_library(JN, monkeypatch):
    """Both packages' loaders forced off: every caller takes its fallback."""
    monkeypatch.setattr(TN, "get_lib", lambda: None)
    monkeypatch.setattr(JN, "get_lib", lambda: None)
    assert not TN.available() and not JN.available()


@pytest.mark.parametrize("algo", ["skipgram", "cbow"])
def test_corpus_route_fallback_equal(no_library, algo):
    """`learn_sequences_batch` without the library runs the per-sequence
    numpy path in both packages: equal tables after a forced flush."""
    from deeplearning4j_tpu.models.embeddings import learning as JL
    from deeplearning4j_tpu.models.embeddings import lookup_table as JT
    from deeplearning4j_tpu.models.word2vec.vocab import VocabCache
    from deeplearning4j_tpu_torch.models.embeddings import learning as TLn
    from deeplearning4j_tpu_torch.models.embeddings import lookup_table as TT
    vocab = VocabCache()
    rng = np.random.default_rng(3)
    for i in range(30):
        vocab.add_token(f"w{i}", int(rng.integers(1, 20)))
    vocab.finish()
    ref_table = JT.InMemoryLookupTable(vocab, 8, seed=1, negative=3,
                                       use_hs=False).reset_weights()
    our_table = TT.from_reference(ref_table)
    seqs = [rng.integers(0, 30, 12).tolist() for _ in range(20)]
    learners = []
    for L, table, kw in ((JL, ref_table, {}), (TLn, our_table,
                                               {"device": "cpu"})):
        a = L.ELEMENTS_LEARNING[algo](batch_pairs=128)
        a.configure(table.vocab, table, window=3, negative=3, use_hs=False,
                    seed=5, **kw)
        a.learn_sequences_batch(seqs, 0.025)
        a.finish()
        learners.append(a)
    assert learners[0]._flushed_pairs == learners[1]._flushed_pairs > 0
    np.testing.assert_allclose(our_table.syn0, ref_table.syn0, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(our_table.syn1neg, ref_table.syn1neg,
                               rtol=1e-5, atol=1e-5)


def test_glove_cooc_fallback_equal(no_library):
    """GloVe's Python dict counting (no library) in both packages: the same
    COO arrays."""
    from deeplearning4j_tpu.models.glove.glove import Glove as JG
    from deeplearning4j_tpu_torch.models.glove.glove import Glove as TG
    seqs = [[f"w{i}" for i in s] for s in _corpus(6, n_seq=12, vocab=15)]
    out = []
    for G in (JG, TG):
        g = G.Builder().window_size(3).build()
        g.build_vocab(seqs)
        out.append(g._cooc_arrays(seqs))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
