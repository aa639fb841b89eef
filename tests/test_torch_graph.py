"""The port's `graph/` against the JAX package's: the adjacency graph and
its loaders, the random walks, and DeepWalk.

The graph and the walks are copies: the same graph gives the same
adjacency, and the same seed the same walks, vertex for vertex (each step
draws once from `np.random.default_rng(seed)`, `integers` for a uniform
walk and `choice` for a weighted one), also under hypothesis. DeepWalk's
walks are drawn on the host and its skip-gram (hierarchical softmax) trains
through the port's `SequenceVectors` on the device `fit` is given. On the
CPU, against the reference on the reference's two-clique graph
(`tests/test_graph.py`), the vocab is equal and `syn0` and `syn1` agree
within 1e-5 (abs and rel); the queries agree; the JSON each package saves
has the same keys, and each package loads the other's file with the same
vectors. `DeepWalk()` with no device needs a card.

Tests marked `gpu` run on the card and skip without one:
    python -m pytest --noconftest tests/test_torch_graph.py -m gpu
"""
import json
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from deeplearning4j_tpu_torch.graph import (DeepWalk, Graph, GraphLoader,
                                            RandomWalkIterator,
                                            WeightedRandomWalkIterator)
import deeplearning4j_tpu_torch.graph as TG
from deeplearning4j_tpu_torch.graph import walks as TW

TOL = 1e-5
CPU = "cpu"


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    import importlib
    g = importlib.import_module("deeplearning4j_tpu.graph")
    return types.SimpleNamespace(
        g=g, walks=importlib.import_module("deeplearning4j_tpu.graph.walks"))


def _two_cliques(G, k=6):
    """tests/test_graph.py's graph: two k-cliques joined by one edge."""
    g = G(2 * k)
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                g.add_edge(base + i, base + j)
    g.add_edge(0, k)
    return g


def _weighted(G, n=9, seed=4):
    rng = np.random.default_rng(seed)
    g = G(n)
    for i in range(n):
        for j in rng.choice(n, 3, replace=False):
            g.add_edge(i, int(j), weight=float(rng.uniform(0.01, 5.0)),
                       directed=bool(rng.integers(0, 2)))
    return g


def _adjacency(g):
    return [[(e.from_idx, e.to_idx, e.weight, e.directed)
             for e in g.get_edges_out(i)] for i in range(g.num_vertices())]


def _walks(it, rounds=2):
    out = []
    for _ in range(rounds):            # reset draws the same walks again
        out.append(list(it))
    assert out[0] == out[-1]
    return out[0]


# ---------------------------------------------------------------------------
# the graph and its loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cliques", "weighted", "no_multi",
                                  "edge_list", "adjacency_list"])
def test_graphs_equal(R, tmp_path, kind):
    if kind == "cliques":
        ours, ref = _two_cliques(Graph), _two_cliques(R.g.Graph)
    elif kind == "weighted":
        ours, ref = _weighted(Graph), _weighted(R.g.Graph)
    elif kind == "no_multi":
        def build(G):
            g = G(3, allow_multiple_edges=False)
            for a, b, w in ((0, 1, 100.0), (0, 1, 2.0), (0, 2, 0.01),
                            (2, 2, 1.0)):
                g.add_edge(a, b, weight=w, directed=True)
            return g
        ours, ref = build(Graph), build(R.g.Graph)
    elif kind == "edge_list":
        p = tmp_path / "edges.csv"
        p.write_text("0,1\n1,2,2.5\n# comment\n\n2,3\n3,3\n")
        ours = GraphLoader.load_undirected_graph_edge_list_file(str(p), 5)
        ref = R.g.GraphLoader.load_undirected_graph_edge_list_file(str(p), 5)
    else:
        p = tmp_path / "adj.txt"
        p.write_text("0,1,2\n1,0\n2\n# comment\n4,0\n")
        ours = GraphLoader.load_adjacency_list_file(str(p))
        ref = R.g.GraphLoader.load_adjacency_list_file(str(p))
    assert _adjacency(ours) == _adjacency(ref)
    assert ([ours.degree(i) for i in range(ours.num_vertices())]
            == [ref.degree(i) for i in range(ref.num_vertices())])
    assert ([ours.get_connected_vertex_indices(i)
             for i in range(ours.num_vertices())]
            == [ref.get_connected_vertex_indices(i)
                for i in range(ref.num_vertices())])


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 3, 12345])
@pytest.mark.parametrize("length", [1, 2, 8, 40])
def test_uniform_walks_equal(R, seed, length):
    ours = _walks(RandomWalkIterator(_two_cliques(Graph), length, seed=seed))
    ref = _walks(R.g.RandomWalkIterator(_two_cliques(R.g.Graph), length,
                                        seed=seed))
    assert ours == ref
    assert [w[0] for w in ours] == list(range(12))
    assert all(len(w) == length for w in ours)


@pytest.mark.parametrize("seed", [3, 7])
@pytest.mark.parametrize("length", [2, 10])
def test_weighted_walks_equal(R, seed, length):
    ours = _walks(WeightedRandomWalkIterator(_weighted(Graph), length,
                                             seed=seed))
    ref = _walks(R.g.WeightedRandomWalkIterator(_weighted(R.g.Graph), length,
                                                seed=seed))
    assert ours == ref


def test_disconnected_vertices_equal(R):
    for G, mod in ((Graph, TW), (R.g.Graph, R.walks)):
        g = G(3)
        g.add_edge(0, 1, directed=True)
        assert list(mod.RandomWalkIterator(g, 4)) == [
            [0, 1, 1, 1], [1, 1, 1, 1], [2, 2, 2, 2]]
        assert list(mod.WeightedRandomWalkIterator(g, 3))[2] == [2, 2, 2]
        for cls in (mod.RandomWalkIterator, mod.WeightedRandomWalkIterator):
            it = cls(g, 2, no_edge_handling=mod.EXCEPTION_ON_DISCONNECTED)
            assert it.next() == [0, 1]
            with pytest.raises(RuntimeError, match="no outgoing edges"):
                it.next()
    assert (TW.SELF_LOOP_ON_DISCONNECTED, TW.EXCEPTION_ON_DISCONNECTED) == (
        R.walks.SELF_LOOP_ON_DISCONNECTED, R.walks.EXCEPTION_ON_DISCONNECTED)


def _random_graph(G, n, extra, seed, weighted):
    """test_properties.py's ring plus random chords; weighted: random
    weights and directions."""
    rng = np.random.default_rng(seed)
    g = G(n)
    for i in range(n):
        g.add_edge(i, (i + 1) % n)
    for _ in range(extra):
        a, b = rng.integers(0, n, 2)
        w = float(rng.uniform(0.1, 3.0)) if weighted else 1.0
        g.add_edge(int(a), int(b), weight=w,
                   directed=weighted and bool(rng.integers(0, 2)))
    return g


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(n=st.integers(2, 15), extra=st.integers(0, 20), wl=st.integers(1, 8),
       seed=st.integers(0, 2**31 - 1), weighted=st.booleans())
def test_walks_equal_under_hypothesis(R, n, extra, wl, seed, weighted):
    cls = "WeightedRandomWalkIterator" if weighted else "RandomWalkIterator"
    ours = list(getattr(TW, cls)(
        _random_graph(Graph, n, extra, seed, weighted), wl, seed=seed))
    ref = list(getattr(R.walks, cls)(
        _random_graph(R.g.Graph, n, extra, seed, weighted), wl, seed=seed))
    assert ours == ref
    assert sorted(w[0] for w in ours) == list(range(n))


# ---------------------------------------------------------------------------
# DeepWalk
# ---------------------------------------------------------------------------

# tests/test_graph.py's two fits: (vector, window, lr, seed, epochs, walk)
FITS = {"clique_structure": (16, 3, 0.05, 7, 10, 10),
        "save_load": (8, 5, 0.025, 7, 3, 6)}


def _fit(pkg, cfg, device=None, weighted=False):
    """A DeepWalk of `pkg` (either package's `graph`) fit on the two-clique
    graph: `fit(graph, walk_length)`, or over a weighted walk iterator."""
    vec, win, lr, seed, epochs, length = cfg
    b = (pkg.DeepWalk.Builder().vector_size(vec).window_size(win)
         .learning_rate(lr).seed(seed).epochs(epochs))
    if device is not None:
        b = b.device(device)
    dw, g = b.build(), _two_cliques(pkg.Graph)
    if weighted:
        return dw.fit(pkg.WeightedRandomWalkIterator(g, length, seed=seed))
    return dw.fit(g, walk_length=length)


def _close(a, b):
    np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("cfg", sorted(FITS))
def test_deepwalk_fit_on_cpu_matches_reference(R, cfg, weighted):
    ours = _fit(TG, FITS[cfg], CPU, weighted)
    ref = _fit(R.g, FITS[cfg], weighted=weighted)
    assert ours.num_vertices == ref.num_vertices == 12
    assert ours._sv.vocab.words() == ref._sv.vocab.words()
    _close(ours._sv.lookup.syn0, ref._sv.lookup.syn0)
    _close(ours._sv.lookup.syn1, ref._sv.lookup.syn1)
    _close(ours.get_vertex_vector(3), ref.get_vertex_vector(3))
    for a, b in ((1, 2), (1, 8), (0, 6)):
        assert abs(ours.similarity(a, b) - ref.similarity(a, b)) <= TOL
    if cfg == "clique_structure":     # the reference's quality pin
        assert ours.similarity(1, 2) > ours.similarity(1, 8)
        assert set(ours.verticesNearest(1, 4)) <= set(range(6))


def test_deepwalk_files_cross_read(R, tmp_path):
    ours = _fit(TG, FITS["save_load"], CPU)
    ref = _fit(R.g, FITS["save_load"])
    a, b = str(tmp_path / "ours.json"), str(tmp_path / "ref.json")
    ours.save(a)
    ref.writeGraphVectors(b)
    with open(a) as fa, open(b) as fb:
        da, db = json.load(fa), json.load(fb)
    assert list(da) == list(db) and list(da["vectors"]) == list(db["vectors"])
    theirs, mine = R.g.DeepWalk.load(a), DeepWalk.loadTxtVectors(b)
    for v in range(12):
        np.testing.assert_array_equal(np.asarray(theirs.get_vertex_vector(v)),
                                      ours.get_vertex_vector(v))
        np.testing.assert_array_equal(mine.get_vertex_vector(v),
                                      np.asarray(ref.get_vertex_vector(v)))
    assert (mine.num_vertices, mine.vector_size) == (12, 8)
    assert mine.verticesNearest(3, 4) == ref.verticesNearest(3, 4)
    assert abs(mine.similarity(1, 2) - ref.similarity(1, 2)) <= 1e-6


def test_deepwalk_device_defaults_to_the_card():
    dw = DeepWalk.Builder().vector_size(4).epochs(1).build()
    assert dw.device is None and DeepWalk().device is None
    assert DeepWalk.Builder().device(CPU).build().device == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dw.fit(_two_cliques(Graph), walk_length=4)


# ---------------------------------------------------------------------------
# Card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_deepwalk_on_card_matches_cpu_and_repeats(cuda, tmp_path):
    cfg = FITS["clique_structure"]
    card, cpu = _fit(TG, cfg, cuda), _fit(TG, cfg, CPU)
    _close(card._sv.lookup.syn0, cpu._sv.lookup.syn0)
    _close(card._sv.lookup.syn1, cpu._sv.lookup.syn1)
    again = _fit(TG, cfg, cuda)
    np.testing.assert_array_equal(again._sv.lookup.syn0, card._sv.lookup.syn0)
    np.testing.assert_array_equal(again._sv.lookup.syn1, card._sv.lookup.syn1)
    p = str(tmp_path / "gv.json")
    card.save(p)
    back = DeepWalk.load(p)
    for v in range(12):
        np.testing.assert_array_equal(back.get_vertex_vector(v),
                                      card.get_vertex_vector(v))
