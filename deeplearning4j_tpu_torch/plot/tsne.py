"""t-SNE embedding for visualization.

Port of deeplearning4j_tpu/plot/tsne.py, the equivalent of reference
deeplearning4j-core plot/BarnesHutTsne.java + plot/Tsne.java +
clustering/sptree. Two paths:

* dense (small/medium N): the [N,N] similarity and gradient products on
  the device, the whole gradient loop an eager loop of PyTorch ops in f32
  (the reference's one `lax.fori_loop` program) — exact t-SNE, no tree.
* barnes_hut (N up to 50k+): the reference's O(N log N) design, kept where
  the reference keeps it — on the host. The kNN candidate search (one
  product a chunk of queries) and the per-point perplexity bisection run
  on the device; the quadtree build + theta-criterion repulsion and CSR
  sparse attraction run in the native C++ runtime
  (`native/dl4j_tpu_native.cpp dl4j_bh_repulsion/dl4j_bh_attraction`,
  threaded), with the reference's exact numpy routes when the library is
  missing.

`method="auto"` picks dense up to _DENSE_MAX points, barnes_hut above.
Standard recipe either way: perplexity search for conditional P,
symmetrize, early exaggeration, momentum + adaptive gains descent.

The dense path's start `y0` is drawn from a `torch.Generator` seeded with
`seed` (on the CPU, so every device starts alike); the reference draws
from its own PRNG, so the two packages' dense fits differ from the start
and are each held by the quality pins. The kNN neighbours are a stable
sort of the distances (the lower index first on ties, as `lax.top_k`).
The host parts (`_cond_probs`, the symmetrisation, the Barnes-Hut loop
with numpy `default_rng(seed)`) are the reference's.

Runs on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import numpy as np
import torch

from ..common.device import card_numerics, resolve_device


def _cond_probs(x, perplexity, tol=1e-5, max_tries=50):
    """Binary-search per-point Gaussian bandwidths to hit the target
    perplexity (host-side, as in the reference's computeGaussianPerplexity)."""
    n = x.shape[0]
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    P = np.zeros((n, n))
    log_u = np.log(perplexity)
    for i in range(n):
        beta, beta_min, beta_max = 1.0, -np.inf, np.inf
        di = np.delete(d2[i], i)
        for _ in range(max_tries):
            p = np.exp(-di * beta)
            s = max(p.sum(), 1e-12)
            h = np.log(s) + beta * (di * p).sum() / s
            if abs(h - log_u) < tol:
                break
            if h > log_u:
                beta_min = beta
                beta = beta * 2 if beta_max == np.inf else (beta + beta_max) / 2
            else:
                beta_max = beta
                beta = beta / 2 if beta_min == -np.inf else (beta + beta_min) / 2
        p = np.exp(-di * beta)
        p /= max(p.sum(), 1e-12)
        P[i, np.arange(n) != i] = p
    P = (P + P.T) / (2 * n)
    return np.maximum(P, 1e-12)


def _tsne_loop(P, y0, n_iter, momentum=0.8, lr=200.0, exaggeration=12.0,
               exaggeration_iters=100):
    """The full gradient-descent loop on P's device: P [N, N], y0 [N, c]
    (f32 tensors on one device)."""
    n = y0.shape[0]
    diag = torch.arange(n, device=y0.device)
    Pe_early = P * exaggeration
    with card_numerics(y0.device, y0.dtype):
        y, v = y0.clone(), torch.zeros_like(y0)
        for i in range(n_iter):
            Pe = Pe_early if i < exaggeration_iters else P
            sq = (y * y).sum(1)
            d2 = sq[:, None] - 2 * (y @ y.T) + sq[None, :]
            num = 1.0 / (1.0 + d2)
            num[diag, diag] = 0.0
            Q = (num / num.sum().clamp_min(1e-12)).clamp_min(1e-12)
            PQ = (Pe - Q) * num
            g = 4.0 * ((torch.diag(PQ.sum(1)) - PQ) @ y)
            v = momentum * v - lr * g
            y = y + v
            y = y - y.mean(0)
    return y


_DENSE_MAX = 4096      # auto: dense device loop up to here, Barnes-Hut above


def _knn_chunk(xq, x, k):
    """Squared distances + indices of the k+1 nearest points (self
    included) for a chunk of queries — one product per chunk; ties keep
    the lower index first (a stable sort), as `lax.top_k` does."""
    with card_numerics(x.device, x.dtype):
        d2 = ((xq * xq).sum(1)[:, None] - 2.0 * (xq @ x.T)
              + (x * x).sum(1)[None, :])
    d2s, idx = torch.sort(d2, dim=1, stable=True)
    return d2s[:, :k + 1], idx[:, :k + 1]


def _beta_search_rows(d2, log_u):
    """Vectorized perplexity bisection: all points' bandwidths at once
    (the reference's computeGaussianPerplexity per-row loop, as 50
    bisection steps over [N] betas). d2: [N, K] neighbor sq-distances."""
    n = d2.shape[0]
    beta = torch.ones(n, dtype=d2.dtype, device=d2.device)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, float("inf"))
    for _ in range(50):
        p = torch.exp(-d2 * beta[:, None])
        s = p.sum(1).clamp_min(1e-12)
        h = torch.log(s) + beta * (d2 * p).sum(1) / s
        too_high = h > log_u            # entropy too high -> raise beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(
            too_high,
            torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (beta + hi)),
            torch.where(lo > 0.0, 0.5 * (beta + lo), beta * 0.5))
    p = torch.exp(-d2 * beta[:, None])
    return p / p.sum(1, keepdim=True).clamp_min(1e-12)


def _sparse_sym_p(x, perplexity, chunk=1024, device=None):
    """kNN conditional P on `device`, symmetrized to CSR (row_ptr, cols,
    vals) on the host."""
    device = resolve_device(device)
    n = x.shape[0]
    k = max(3, min(n - 1, int(3 * perplexity)))
    xt = torch.as_tensor(np.asarray(x, np.float32)).to(device)
    d2s, idxs = [], []
    for s in range(0, n, chunk):
        d2c, idxc = _knn_chunk(xt[s:s + chunk], xt, k)
        d2s.append(d2c)
        idxs.append(idxc)
    d2t = torch.cat(d2s)                              # [n, k+1] ascending
    idx = torch.cat(idxs).cpu().numpy()
    # drop self (first occurrence of the query's own index per row); with
    # >k exact duplicates the self index can be tied out of the top-(k+1),
    # making argmax return 0 — drop the farthest column for those rows
    # instead of silently discarding the true nearest neighbor
    rows_arange = np.arange(n)
    is_self = idx == rows_arange[:, None]
    self_pos = np.where(is_self.any(1), np.argmax(is_self, 1), idx.shape[1] - 1)
    keep = np.ones_like(idx, bool)
    keep[rows_arange, self_pos] = False
    keep_t = torch.from_numpy(keep).to(device)
    d2 = d2t[keep_t].reshape(n, k)
    idx = idx[keep].reshape(n, k)
    p = _beta_search_rows(d2, float(np.log(perplexity))).cpu().numpy()
    # symmetrize: P_sym = (P + P^T) / (2n) over the union pattern
    rows = np.repeat(rows_arange, k).astype(np.int64)
    cols = idx.ravel().astype(np.int64)
    keys = np.concatenate([rows * n + cols, cols * n + rows])
    vals = np.concatenate([p.ravel(), p.ravel()]).astype(np.float64)
    uk, inv = np.unique(keys, return_inverse=True)
    sv = np.zeros(uk.shape[0])
    np.add.at(sv, inv, vals)
    sv /= (2.0 * n)
    r, c = (uk // n).astype(np.int64), (uk % n).astype(np.int32)
    row_ptr = np.searchsorted(r, np.arange(n + 1), side="left").astype(
        np.int64)
    return row_ptr, c, np.maximum(sv, 1e-12).astype(np.float32)


def _np_attraction(y, row_ptr, cols, vals):
    """Exact numpy fallback for dl4j_bh_attraction (COO vectorized)."""
    n = y.shape[0]
    rows = np.repeat(np.arange(n), np.diff(row_ptr))
    d = y[rows] - y[cols]
    q = 1.0 / (1.0 + (d * d).sum(1))
    w = (vals * q)[:, None] * d
    out = np.zeros_like(y)
    np.add.at(out, rows, w)
    return out


def _np_repulsion(y, chunk=2048):
    """Exact (theta=0) chunked fallback for dl4j_bh_repulsion."""
    n = y.shape[0]
    rep = np.zeros_like(y)
    Z = 0.0
    for s in range(0, n, chunk):
        d = y[s:s + chunk, None, :] - y[None, :, :]
        q = 1.0 / (1.0 + (d * d).sum(-1))
        q[np.arange(s, min(s + chunk, n)) - s,
          np.arange(s, min(s + chunk, n))] = 0.0
        Z += q.sum()
        rep[s:s + chunk] = ((q * q)[..., None] * d).sum(1)
    return rep, max(Z, 1e-12)


class Tsne:
    """reference API: plot/Tsne.java + BarnesHutTsne.Builder."""

    class Builder:
        def __init__(self):
            self._kw = {}

        def set_max_iter(self, v):
            self._kw["max_iter"] = int(v); return self

        setMaxIter = set_max_iter

        def perplexity(self, v):
            self._kw["perplexity"] = float(v); return self

        def theta(self, v):
            self._kw["theta"] = float(v); return self

        def learning_rate(self, v):
            self._kw["learning_rate"] = float(v); return self

        learningRate = learning_rate

        def num_dimension(self, v):
            self._kw["n_components"] = int(v); return self

        numDimension = num_dimension

        def seed(self, v):
            self._kw["seed"] = int(v); return self

        def use_barnes_hut(self, v):
            self._kw["method"] = "barnes_hut" if v else "dense"
            return self

        def device(self, v):
            """Where the device parts run (default: the card)."""
            self._kw["device"] = v; return self

        def build(self):
            return Tsne(**self._kw)

    def __init__(self, n_components=2, perplexity=30.0, max_iter=500,
                 learning_rate=200.0, seed=123, theta=0.5, method="auto",
                 device=None):
        self.n_components = int(n_components)
        self.perplexity = float(perplexity)
        self.max_iter = int(max_iter)
        self.learning_rate = float(learning_rate)
        self.seed = int(seed)
        self.theta = float(theta)
        self.method = method
        self.device = resolve_device(device)
        self.embedding = None

    def fit(self, x):
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        method = self.method
        if method == "auto":
            # the quadtree is 2-D; 3-D embeddings stay on the exact path
            method = ("dense" if n <= _DENSE_MAX or self.n_components != 2
                      else "barnes_hut")
        if method == "barnes_hut":
            return self._fit_barnes_hut(x)
        perp = min(self.perplexity, (n - 1) / 3.0)
        P = torch.from_numpy(_cond_probs(x, perp).astype(np.float32)).to(
            self.device)
        gen = torch.Generator().manual_seed(self.seed)
        y0 = 1e-2 * torch.randn((n, self.n_components), generator=gen,
                                dtype=torch.float32)
        y = _tsne_loop(P, y0.to(self.device), self.max_iter,
                       lr=self.learning_rate)
        self.embedding = y.cpu().numpy()
        return self.embedding

    fit_transform = fit

    def _fit_barnes_hut(self, x):
        """O(N log N) path (reference BarnesHutTsne.gradient + SpTree):
        sparse kNN attraction + quadtree repulsion, momentum + adaptive
        gains (the reference's gains.muli / learning-rate schedule)."""
        if self.n_components != 2:
            raise ValueError("barnes_hut t-SNE is 2-D (quadtree), like "
                             "the reference's BarnesHutTsne")
        from ..common import native_ops
        n = x.shape[0]
        perp = min(self.perplexity, (n - 1) / 3.0)
        row_ptr, cols, vals = _sparse_sym_p(x, perp, device=self.device)
        rng = np.random.default_rng(self.seed)
        y = (1e-2 * rng.standard_normal((n, 2))).astype(np.float32)
        v = np.zeros_like(y)
        gains = np.ones_like(y)
        native = native_ops.available()
        exagg_iters = min(100, self.max_iter // 4)
        vals_ex = vals * 12.0     # early-exaggeration array, built ONCE
        for it in range(self.max_iter):
            v_it = vals_ex if it < exagg_iters else vals
            momentum = 0.5 if it < 250 else 0.8
            attr = (native_ops.bh_attraction(y, row_ptr, cols, v_it)
                    if native else None)
            if attr is None:
                attr = _np_attraction(y, row_ptr, cols, v_it)
            rz = native_ops.bh_repulsion(y, self.theta) if native else None
            if rz is None:
                rz = _np_repulsion(y)
            rep, Z = rz
            g = 4.0 * (attr - rep / Z)
            flips = np.sign(g) != np.sign(v)
            gains = np.clip(np.where(flips, gains + 0.2, gains * 0.8),
                            0.01, None)
            v = momentum * v - self.learning_rate * gains * g
            y = y + v
            y -= y.mean(0)
        self.embedding = np.asarray(y, np.float32)
        return self.embedding

    def plot(self, x, labels=None, path=None):
        """Fit and dump coordinates (+labels) to a TSV like the reference's
        saveCoordsForPlot."""
        coords = self.fit(x)
        if path:
            with open(path, "w", encoding="utf-8") as fh:
                for i, row in enumerate(coords):
                    lab = labels[i] if labels is not None else i
                    fh.write("\t".join(f"{v:.6f}" for v in row)
                             + f"\t{lab}\n")
        return coords


class BarnesHutTsne(Tsne):
    """reference: plot/BarnesHutTsne.java — always the O(N log N)
    theta-approximate path (quadtree repulsion + sparse kNN attraction),
    any N. Plain `Tsne` auto-selects between this and the exact dense
    device loop by size."""

    def __init__(self, **kw):
        kw.setdefault("method", "barnes_hut")
        super().__init__(**kw)
