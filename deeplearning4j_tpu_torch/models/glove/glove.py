"""GloVe — global vectors from co-occurrence statistics.

The port of deeplearning4j_tpu/models/glove/glove.py. Co-occurrence counting
is the reference's (the native `glove_cooc`, or the Python dict loop), the
initial state and the shuffle are drawn with numpy as the reference draws
them, and the AdaGrad step runs on the device (None: the CUDA card), the
state in f32 tensors. The step keeps the reference's order: it gathers W and
Wc from the old tables, adds all four squared-gradient accumulators, and
only then gathers them to scale the four parameter updates. Its scatter-adds
are deterministic on the card (`learning._Fold`). The text below is the
reference's.

TPU-native equivalent of reference models/glove/Glove.java +
models/glove/AbstractCoOccurrences.java (1,413 LoC pkg): symmetric windowed
co-occurrence counting with 1/distance weighting, then weighted-least-squares
factorization  f(X_ij)(w_i . w~_j + b_i + b~_j - log X_ij)^2  trained by
batched AdaGrad — the reference's per-pair AdaGrad loop becomes one donated
jitted scatter-update per shuffled batch of nonzero co-occurrence entries.
"""
from __future__ import annotations

import numpy as np
import torch

from ...common.device import card_numerics, resolve_device
from ..embeddings.learning import _Fold
from ..sequencevectors.sequence_vectors import SequenceVectors
from ..word2vec.vocab import VocabCache


def glove_step(state, wi, wj, logx, fx, lr):
    """One AdaGrad batch, in place. state = dict(W, Wc, b, bc, hW, hWc, hb,
    hbc) of f32 tensors; wi/wj [B] int64 indices; logx/fx [B]; lr 0-d."""
    W, Wc = state["W"], state["Wc"]
    vi = W[wi]                    # [B,D]
    vj = Wc[wj]
    diff = (torch.bmm(vi[:, None, :], vj[:, :, None])[:, 0, 0]
            + state["b"][wi] + state["bc"][wj] - logx)       # [B]
    g = fx * diff                                            # [B]
    gvi = g[:, None] * vj
    gvj = g[:, None] * vi
    gb = g
    fi, fj = _Fold(wi), _Fold(wj)
    # AdaGrad accumulators (scatter-add of squared grads), all four first
    fi.add_(state["hW"], gvi * gvi)
    fj.add_(state["hWc"], gvj * gvj)
    fi.add_(state["hb"], gb * gb)
    fj.add_(state["hbc"], gb * gb)
    eps = 1e-8
    fi.add_(W, -lr * gvi / torch.sqrt(state["hW"][wi] + eps))
    fj.add_(Wc, -lr * gvj / torch.sqrt(state["hWc"][wj] + eps))
    fi.add_(state["b"], -lr * gb / torch.sqrt(state["hb"][wi] + eps))
    fj.add_(state["bc"], -lr * gb / torch.sqrt(state["hbc"][wj] + eps))


class Glove(SequenceVectors):
    class Builder:
        def __init__(self):
            self._kw = {}
            self._xmax = 100.0
            self._alpha = 0.75
            self._sym = True

        def min_word_frequency(self, v):
            self._kw["min_word_frequency"] = int(v); return self

        minWordFrequency = min_word_frequency

        def layer_size(self, v):
            self._kw["vector_length"] = int(v); return self

        layerSize = layer_size

        def window_size(self, v):
            self._kw["window"] = int(v); return self

        windowSize = window_size

        def seed(self, v):
            self._kw["seed"] = int(v); return self

        def epochs(self, v):
            self._kw["epochs"] = int(v); return self

        def learning_rate(self, v):
            self._kw["learning_rate"] = float(v); return self

        learningRate = learning_rate

        def x_max(self, v):
            self._xmax = float(v); return self

        xMax = x_max

        def alpha(self, v):
            self._alpha = float(v); return self

        def symmetric(self, v):
            self._sym = bool(v); return self

        def device(self, d):
            """Where the state trains: None (the CUDA card) or a torch
            device such as "cpu"."""
            self._kw["device"] = d; return self

        def build(self):
            g = Glove(**self._kw)
            g.x_max = self._xmax
            g.alpha = self._alpha
            g.symmetric = self._sym
            return g

    def __init__(self, **kw):
        kw.setdefault("learning_rate", 0.05)
        super().__init__(**kw)
        self.x_max = 100.0
        self.alpha = 0.75
        self.symmetric = True
        self.batch_size = 8192

    # ------------------------------------------------------------------
    def _cooc_arrays(self, sequences):
        """(i, j, x) COO arrays of windowed 1/distance co-occurrence
        counts. Counting runs in C++ when the native library is available
        (`native_ops.glove_cooc`, arrays end-to-end); the python fallback
        streams one sequence at a time through the dict loop."""
        from ...common import native_ops
        if native_ops.available():
            id_lists = [ids for ids in (self._sequence_ids(seq)
                                        for seq in sequences) if ids]
            if not id_lists:
                z = np.zeros(0, np.int32)
                return z, z.copy(), np.zeros(0, np.float32)
            ids, offsets = native_ops.pack_corpus(id_lists)
            res = native_ops.glove_cooc(ids, offsets, self.window,
                                        self.symmetric)
            if res is not None:
                return res
            sequences = id_lists          # fall through, ids precomputed

            def _ids_iter():
                return sequences
        else:
            def _ids_iter():
                return (self._sequence_ids(seq) for seq in sequences)
        cooc = {}
        w = self.window
        for ids in _ids_iter():
            n = len(ids)
            for i in range(n):
                for off in range(1, w + 1):
                    j = i + off
                    if j >= n:
                        break
                    weight = 1.0 / off
                    a, b = ids[i], ids[j]
                    cooc[(a, b)] = cooc.get((a, b), 0.0) + weight
                    if self.symmetric:
                        cooc[(b, a)] = cooc.get((b, a), 0.0) + weight
        ci = np.fromiter((k[0] for k in cooc), np.int32, len(cooc))
        cj = np.fromiter((k[1] for k in cooc), np.int32, len(cooc))
        cx = np.fromiter(cooc.values(), np.float32, len(cooc))
        return ci, cj, cx

    def build_cooccurrences(self, sequences):
        """reference: AbstractCoOccurrences — dict view of the counts
        (kept for API parity; `fit` consumes the arrays directly)."""
        ci, cj, cx = self._cooc_arrays(sequences)
        return {(int(a), int(b)): float(x)
                for a, b, x in zip(ci, cj, cx)}

    # ------------------------------------------------------------------
    def fit(self, sequence_source):
        if callable(sequence_source):
            get_sequences = sequence_source
        else:
            seqs = list(sequence_source)
            get_sequences = lambda: seqs  # noqa: E731
        if self.vocab is None:
            self.build_vocab(get_sequences())
        V, D = len(self.vocab), self.vector_length
        if V == 0:
            raise ValueError("Empty vocabulary")

        ci, cj, cx = self._cooc_arrays(get_sequences())
        entries = np.column_stack([ci.astype(np.float64),
                                   cj.astype(np.float64),
                                   cx.astype(np.float64)])
        if entries.size == 0:
            raise ValueError("No co-occurrences found")
        rng = np.random.default_rng(self.seed)
        init = lambda shape: ((rng.random(shape) - 0.5) / D).astype(np.float32)  # noqa: E731
        state = {
            "W": init((V, D)), "Wc": init((V, D)),
            "b": init((V,)), "bc": init((V,)),
            "hW": np.zeros((V, D), np.float32),
            "hWc": np.zeros((V, D), np.float32),
            "hb": np.zeros((V,), np.float32),
            "hbc": np.zeros((V,), np.float32),
        }
        dev = resolve_device(self.device)
        state = {k: torch.tensor(v, device=dev) for k, v in state.items()}
        put = lambda a, dtype: torch.as_tensor(  # noqa: E731
            np.asarray(a)).to(dev, dtype)

        B = self.batch_size
        n = len(entries)
        for _epoch in range(self.epochs):
            order = rng.permutation(n)
            for s in range(0, n, B):
                idx = order[s:s + B]
                if len(idx) < B:   # pad tail (fx=0 makes pads no-ops)
                    idx = np.concatenate([idx, np.zeros(B - len(idx), int)])
                    pad_valid = np.zeros(B, np.float32)
                    pad_valid[:len(order[s:s + B])] = 1.0
                else:
                    pad_valid = np.ones(B, np.float32)
                batch = entries[idx]
                wi = batch[:, 0].astype(np.int32)
                wj = batch[:, 1].astype(np.int32)
                x = batch[:, 2]
                fx = (np.minimum(x / self.x_max, 1.0) ** self.alpha
                      ).astype(np.float32) * pad_valid
                logx = np.log(np.maximum(x, 1e-12)).astype(np.float32)
                with card_numerics(dev, torch.float32):
                    glove_step(state, put(wi, torch.int64),
                               put(wj, torch.int64), put(logx, torch.float32),
                               put(fx, torch.float32),
                               put(np.float32(self.learning_rate),
                                   torch.float32))

        from ..embeddings.lookup_table import InMemoryLookupTable
        self.lookup = InMemoryLookupTable(self.vocab, D, seed=self.seed)
        # final vectors: W + Wc (GloVe paper / reference convention)
        self.lookup.syn0 = (state["W"] + state["Wc"]).cpu().numpy()
        return self
