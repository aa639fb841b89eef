"""The port's k-means, spatial trees and t-SNE against the JAX package's.

k-means: centers, labels and cost against the reference from the same
seed (the kmeans++ draw is the reference's numpy generator), 1e-5. The VP
and KD trees are numpy copies: the same answers. t-SNE: `_cond_probs`,
`_knn_chunk` (exact duplicates make ties; the lower index first, as
`lax.top_k`), `_beta_search_rows` and `_sparse_sym_p` (more than k
duplicates) against the reference at 1e-6.

The gradient loops are held where their arithmetic allows. The dense loop
at the reference's settings (lr 200, early exaggeration 12, a 1e-2 start)
multiplies a rounding difference by about 10 every iteration: the
reference's own f32 run and an f64 run of the same loop differ by 14% of
the embedding after 20 iterations. So `_tsne_loop` is held at 1e-4
relative over the first three (exaggerated) iterations from such a start,
and over 100 iterations from a converged embedding, where the descent
contracts (read: 1.4e-7). The Barnes-Hut loop (host numpy and the native
forces, the reference's code) is held bit for bit on the reference's P over
50 iterations, with the library and with both `get_lib`s forced to None;
the whole fit, P from the port's device search, 1e-4 relative over 10
iterations (a 1e-7 change of P moves the reference's own 50-iteration fit
by a third). Then the reference's quality pins on the port.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.clustering import (KDTree, KMeansClustering,
                                                 VPTree)
from deeplearning4j_tpu_torch.common import native_ops
from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne
from deeplearning4j_tpu_torch.plot import tsne as T

TOL = 1e-6


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    from deeplearning4j_tpu import clustering
    from deeplearning4j_tpu.common import native_ops as rnative
    from deeplearning4j_tpu.plot import tsne
    return type("R", (), {"clustering": clustering, "tsne": tsne,
                          "native": rnative})


def _blobs(n_per=40, centers=((0, 0, 0), (10, 10, 10), (-10, 5, -5)),
           seed=0):
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for ci, c in enumerate(centers):
        xs.append(rng.normal(c, 1.0, (n_per, len(c))))
        ys.extend([ci] * n_per)
    return np.concatenate(xs).astype(np.float32), np.asarray(ys)


def _spread(emb, y, n):
    """Mean inter-cluster over mean intra-cluster distance on the
    reference's sample of pairs."""
    intra, inter = [], []
    for i in range(0, n, 7):
        for j in range(i + 1, n, 11):
            d = np.linalg.norm(emb[i] - emb[j])
            (intra if y[i] == y[j] else inter).append(d)
    return np.mean(inter) / np.mean(intra)


def _separated(emb, y, n):
    return _spread(emb, y, n) > 2


# -- k-means -----------------------------------------------------------------

@pytest.mark.parametrize("n,d,k,seed", [(300, 8, 5, 3), (500, 16, 12, 7),
                                        (120, 3, 3, 12345)])
def test_kmeans_matches_the_reference(R, n, d, k, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    ref = R.clustering.KMeansClustering(k, seed=seed).fit(x)
    km = KMeansClustering(k, seed=seed, device="cpu").fit(x)
    np.testing.assert_allclose(km.centers, ref.centers, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(km.labels, ref.labels)
    assert abs(km.cost - ref.cost) <= 1e-5 * abs(ref.cost)
    np.testing.assert_array_equal(km.predict(x), ref.predict(x))


def test_lloyd_step_matches_the_reference(R):
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, 6)).astype(np.float32)
    c = x[rng.choice(200, 7, replace=False)]
    c[6] = 1e3          # a center no point chooses keeps its place
    rc, ra, rcost = R.clustering.kmeans._lloyd_step(jnp.asarray(x),
                                                    jnp.asarray(c), 7)
    from deeplearning4j_tpu_torch.clustering.kmeans import _lloyd_step
    pc, pa, pcost = _lloyd_step(torch.from_numpy(x), torch.from_numpy(c), 7)
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), atol=1e-5)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    assert abs(float(pcost) - float(rcost)) <= 1e-5 * abs(float(rcost))
    np.testing.assert_array_equal(pc.numpy()[6], c[6])


def test_kmeans_recovers_blobs():
    x, y = _blobs()
    km = KMeansClustering.setup(3, max_iterations=50, device="cpu").fit(x)
    for c in range(3):
        counts = np.bincount(km.labels[y == c], minlength=3)
        assert counts.max() / counts.sum() > 0.95
    assert np.array_equal(km.predict(x), km.labels)
    c1 = KMeansClustering.setup(1, device="cpu").fit(x).cost
    c3 = KMeansClustering.setup(3, device="cpu").fit(x).cost
    assert c3 < c1


def test_kmeans_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KMeansClustering(3)


# -- trees ---------------------------------------------------------------------

def test_trees_answer_as_the_reference_s(R):
    rng = np.random.default_rng(1)
    pts = rng.random((200, 5))
    vp, rvp = VPTree(pts), R.clustering.VPTree(pts)
    for _ in range(5):
        q = rng.random(5)
        got = vp.knn(q, 7)
        assert got == rvp.knn(q, 7)
        want = np.argsort(np.linalg.norm(pts - q, axis=1))[:7]
        assert {i for _, i in got} == set(want.tolist())
    pts3 = rng.random((150, 3))
    kd, rkd = KDTree(pts3), R.clustering.KDTree(pts3)
    for _ in range(10):
        q = rng.random(3)
        assert kd.nn(q) == rkd.nn(q)
        assert kd.nn(q)[1] == int(np.argmin(np.linalg.norm(pts3 - q, axis=1)))


# -- t-SNE pieces --------------------------------------------------------------

def test_cond_probs_is_the_reference_s(R):
    x = np.random.default_rng(4).standard_normal((40, 5))
    np.testing.assert_array_equal(T._cond_probs(x, 8.0),
                                  R.tsne._cond_probs(x, 8.0))


def _dups(n=40, d=4, seed=7):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    x[5:15] = x[5]      # ten exact copies: tied distances
    return x


def test_knn_chunk_matches_the_reference_ties_included(R):
    import jax.numpy as jnp
    x = _dups()
    for k in (3, 6, 12):
        rd, ri = R.tsne._knn_chunk(jnp.asarray(x[:20]), jnp.asarray(x), k)
        pd, pi = T._knn_chunk(torch.from_numpy(x[:20]), torch.from_numpy(x),
                              k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=0,
                                   atol=TOL * max(1, np.abs(rd).max()))


def test_beta_search_rows_matches_the_reference(R):
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    d2 = np.sort(rng.random((50, 9)).astype(np.float32) * 4, axis=1)
    for perp in (2.0, 5.0):
        want = np.asarray(R.tsne._beta_search_rows(jnp.asarray(d2),
                                                   float(np.log(perp))))
        got = T._beta_search_rows(torch.from_numpy(d2),
                                  float(np.log(perp))).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("case", ["plain", "duplicates"])
def test_sparse_sym_p_matches_the_reference(R, case):
    if case == "plain":
        x, perp = np.random.default_rng(2).normal(size=(150, 7)), 10.0
    else:
        x, perp = _dups(), 2.0      # k = 6 < ten copies
    rp, rc, rv = R.tsne._sparse_sym_p(x, perp)
    pp, pc, pv = T._sparse_sym_p(x, perp, device="cpu")
    np.testing.assert_array_equal(pp, rp)
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_allclose(pv, rv, rtol=0, atol=TOL)
    for i in range(x.shape[0]):
        assert i not in pc[pp[i]:pp[i + 1]]


def _loop_pair(R, P, y0, n_iter, **kw):
    import jax
    import jax.numpy as jnp
    want = np.asarray(R.tsne._tsne_loop(
        jnp.asarray(P, jnp.float32), jnp.asarray(y0), jax.random.PRNGKey(0),
        n_iter, **kw))
    got = T._tsne_loop(torch.from_numpy(P.astype(np.float32)),
                       torch.from_numpy(y0), n_iter, **kw).numpy()
    return got, want


def test_tsne_loop_matches_the_reference(R):
    rng = np.random.default_rng(0)
    n = 60
    P = R.tsne._cond_probs(rng.normal(size=(n, 5)), 10.0)
    y0 = (1e-2 * rng.normal(size=(n, 2))).astype(np.float32)
    for it in (1, 2, 3):        # early exaggeration from the usual start
        got, want = _loop_pair(R, P, y0, it)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), it
    # from a converged embedding the descent contracts: 100 iterations
    start, _ = _loop_pair(R, P, y0, 500)
    got, want = _loop_pair(R, P, start, 100, exaggeration_iters=0)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("native", [True, False])
def test_fit_barnes_hut_is_the_reference_s_on_its_p(R, monkeypatch, native):
    x = np.random.default_rng(0).normal(size=(200, 6))
    if not native:
        monkeypatch.setattr(native_ops, "get_lib", lambda: None)
        monkeypatch.setattr(R.native, "get_lib", lambda: None)
    elif not (native_ops.available() and R.native.available()):
        pytest.skip("native library unavailable")
    want = R.tsne.Tsne(max_iter=50, method="barnes_hut", perplexity=10,
                       seed=4).fit(x)
    monkeypatch.setattr(T, "_sparse_sym_p",
                        lambda x, p, device=None: R.tsne._sparse_sym_p(x, p))
    got = Tsne(max_iter=50, method="barnes_hut", perplexity=10, seed=4,
               device="cpu").fit(x)
    np.testing.assert_array_equal(got, want)


def test_fit_barnes_hut_whole_matches_the_reference(R):
    x = np.random.default_rng(0).normal(size=(200, 6))
    want = R.tsne.Tsne(max_iter=10, method="barnes_hut", perplexity=10,
                       seed=4).fit(x)
    got = Tsne(max_iter=10, method="barnes_hut", perplexity=10, seed=4,
               device="cpu").fit(x)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# -- the reference's quality pins, on the port -------------------------------

def test_clusters_stay_separated():
    """The reference's pin (inter > 2 x intra at seed 3) depends on the
    start's draw: over seeds 0-11 the reference's own ratio reads 1.94 to
    3.84 and misses 2 at two seeds. The port draws another start, so the
    pin is held over the twelve seeds: the mean ratio above 2, and no
    seed's below 1.25 (the clusters never merge)."""
    x, y = _blobs(n_per=30)
    spreads = []
    for seed in range(12):
        emb = (Tsne.Builder().set_max_iter(300).perplexity(10)
               .num_dimension(2).seed(seed).device("cpu").build().fit(x))
        assert emb.shape == (90, 2)
        spreads.append(_spread(emb, y, 90))
    assert np.mean(spreads) > 2 and min(spreads) > 1.25, spreads


def test_barnes_hut_clusters_stay_separated():
    x, y = _blobs(n_per=40)
    emb = BarnesHutTsne(perplexity=12, max_iter=250, seed=2,
                        device="cpu").fit(x)
    assert emb.shape == (120, 2)
    assert _separated(emb, y, 120)


def test_sparse_p_matches_dense_p():
    x = np.random.default_rng(4).standard_normal((60, 5))
    dense = T._cond_probs(x, 10.0)
    row_ptr, cols, vals = T._sparse_sym_p(x, 10.0, device="cpu")
    sparse = np.zeros((60, 60))
    for i in range(60):
        sparse[i, cols[row_ptr[i]:row_ptr[i + 1]]] = \
            vals[row_ptr[i]:row_ptr[i + 1]]
    np.testing.assert_allclose(sparse, dense, atol=3e-4)


def test_sparse_sym_p_with_more_than_k_duplicates():
    x = _dups()
    row_ptr, cols, vals = T._sparse_sym_p(x, perplexity=2.0, device="cpu")
    assert row_ptr[-1] == len(cols) == len(vals)
    c5 = set(cols[row_ptr[6]:row_ptr[7]])
    assert len(c5 & set(range(5, 15))) >= 5
    assert np.all(vals > 0)


def test_auto_method_selection_and_builder_theta(tmp_path):
    t = (Tsne.Builder().theta(0.3).use_barnes_hut(True)
         .perplexity(5).set_max_iter(30).device("cpu").build())
    assert t.theta == 0.3 and t.method == "barnes_hut"
    assert t.device == torch.device("cpu")
    assert Tsne(device="cpu").method == "auto" and T._DENSE_MAX == 4096
    with pytest.raises(ValueError):
        Tsne(n_components=3, method="barnes_hut", device="cpu").fit(
            np.zeros((10, 4)))
    x, y = _blobs(n_per=10)
    p = tmp_path / "coords.tsv"
    Tsne(max_iter=50, perplexity=5, device="cpu").plot(x, labels=y,
                                                       path=str(p))
    lines = p.read_text().strip().split("\n")
    assert len(lines) == 30 and len(lines[0].split("\t")) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Tsne()
