"""Element learning algorithms: SkipGram, CBOW — the batched device step.

The port of deeplearning4j_tpu/models/embeddings/learning.py (reference
models/embeddings/learning/impl/elements/{SkipGram,CBOW}.java, whose hot
loop is libnd4j's native AggregateSkipGram). The host half is the
reference's, line for line: windowing, the negative draws (negatives equal
to the positive masked out), and the flush's padding, valid mask and
per-batch mean lr. So both packages draw the same pair and negative streams
from a seed.

The device half keeps the reference's math: a flush of `batch_pairs` pairs
is applied as chunks of 64 pairs, one after another (the reference's
`lax.scan`). Each chunk gathers its rows from the tables as the previous
chunk left them and takes the classic word2vec SGD step:

  negative sampling: for pair (c, o) with negatives n_k,
      g_t = (label_t - sigmoid(clip(u_t . v_c, -6, 6))) * mask_t * lr
      v_c     += sum_t g_t * u_t
      u_t     += g_t * v_c
  hierarchical softmax: the same with targets = Huffman path nodes and
      label = 1 - code.

CBOW predicts from h, the masked mean of the context rows, and adds dh to
every context row; padding (-1) reads row 0 and adds exact zeros.

Deterministic on the card. A chunk's ids repeat (hot words, and every
Huffman path shares the root), and CUDA's `index_add_` adds repeated rows by
atomics in no fixed order. `_Fold` sums each id's rows first, by a stable
sort and a float64 prefix sum, and scatters one sum per id; every other
position adds -0.0, which leaves any float unchanged, so the order of the
atomics cannot show. The dot products are batched matmuls run with TF32 off
(`card_numerics`).

On the card a flush shape runs as one CUDA graph (`_CapturedFlush`, one per
algorithm and shape): ~1,000 chunks of ~40 kernels would otherwise be
launched one by one. The eager loop stays (`cuda_graph=False`); both give
the same bits.

Not ported: the mesh-sharded tables (`configure(mesh=...)`) and the
`lower_step` cost-model hook raise naming ROADMAP.md queue 1 item 20.
"""
from __future__ import annotations

import numpy as np
import torch

from ...common.device import card_numerics, resolve_device

_CHUNK = 64   # pairs applied simultaneously inside the sequential loop


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to deeplearning4j_tpu_torch yet: ROADMAP.md "
        f"queue 1 item 20")


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------

class _Fold:
    """Deterministic scatter-add of rows indexed by `idx` [N] (int64).

    The ids are sorted (stable) once; `add_(table, rows)` sums each id's
    rows in float64 along the sorted order and adds the sum at the id's
    last position. Every other position adds -0.0 (x + -0.0 == x for every
    float x), so the result does not depend on the order of the card's
    atomic adds. Fixed shapes and no host sync: capturable in a CUDA
    graph."""

    def __init__(self, idx):
        self.ids, self.perm = torch.sort(idx, stable=True)
        first = torch.cat([torch.ones_like(self.ids[:1], dtype=torch.bool),
                           self.ids[1:] != self.ids[:-1]])
        self.last = torch.cat([first[1:], first[:1]])
        pos = torch.arange(idx.shape[0], device=idx.device)
        self.start = torch.cummax(torch.where(first, pos, 0), 0).values

    def add_(self, table, rows):
        if table.ndim == 1:
            table, rows = table[:, None], rows[:, None]
        # the prefix sum runs along the contiguous dim ([D, N]): CUDA's scan
        # over an outer dim walks each column on one thread
        cols = rows.index_select(0, self.perm).t().to(
            torch.float64, memory_format=torch.contiguous_format)
        csum = torch.cumsum(cols, 1)
        before = torch.nn.functional.pad(csum, (1, 0))
        total = (csum - before.index_select(1, self.start)).to(table.dtype)
        table.index_add_(0, self.ids, torch.where(self.last, total, -0.0).t())


def scatter_add_(table, idx, rows):
    """table[idx] += rows with repeated ids, deterministically (`_Fold`)."""
    _Fold(idx).add_(table, rows)


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-torch.clamp(x, -6.0, 6.0)))  # MAX_EXP=6


def _sg_chunk(syn0, syn1, c, t, l, m, lr):
    v = syn0[c]                                         # [C,D]
    u = syn1[t]                                         # [C,T,D]
    logits = torch.bmm(u, v[:, :, None])[:, :, 0]       # [C,T]
    g = (l - _sigmoid(logits)) * m * lr
    dv = torch.bmm(g[:, None, :], u)[:, 0]              # [C,D]
    du = g[..., None] * v[:, None, :]
    scatter_add_(syn0, c, dv)
    scatter_add_(syn1, t.reshape(-1), du.reshape(-1, du.shape[-1]))


def _cbow_chunk(syn0, syn1, ctx_ids, cm, t, l, tm, lr):
    ctx = torch.clamp(ctx_ids, min=0)
    vc = syn0[ctx] * cm[..., None]                      # [C,W,D]
    counts = torch.clamp(cm.sum(1, keepdim=True), min=1.0)
    h = vc.sum(1) / counts                              # [C,D]
    u = syn1[t]                                         # [C,T,D]
    logits = torch.bmm(u, h[:, :, None])[:, :, 0]
    g = (l - _sigmoid(logits)) * tm * lr
    dh = torch.bmm(g[:, None, :], u)[:, 0]              # [C,D]
    du = g[..., None] * h[:, None, :]
    # distribute dh to every context word (classic word2vec neu1e path)
    dctx = dh[:, None, :] * cm[..., None]
    scatter_add_(syn0, ctx.reshape(-1), dctx.reshape(-1, dctx.shape[-1]))
    scatter_add_(syn1, t.reshape(-1), du.reshape(-1, du.shape[-1]))


def _chunks(B):
    return [slice(i, i + _CHUNK) for i in range(0, B, _CHUNK)]


def sg_step(syn0, syn1, centers, targets, labels, mask, lr):
    """One batched skip-gram update, in place on syn0 [V,D] and syn1 [M,D]
    (syn1neg or HS syn1): centers [B]; targets [B,T] indices into syn1;
    labels [B,T] in {0,1}; mask [B,T] valid flags; lr a 0-d tensor. The
    64-pair chunks run one after another, as the reference's scan."""
    for s in _chunks(centers.shape[0]):
        _sg_chunk(syn0, syn1, centers[s], targets[s], labels[s], mask[s], lr)


def cbow_step(syn0, syn1, context, cmask, targets, labels, tmask, lr):
    """One batched CBOW update in place: h = mean(context vectors) predicts
    targets. context [B,C] ids (-1 padded), cmask [B,C];
    targets/labels/tmask [B,T]."""
    for s in _chunks(context.shape[0]):
        _cbow_chunk(syn0, syn1, context[s], cmask[s], targets[s], labels[s],
                    tmask[s], lr)


class _CapturedFlush:
    """One flush shape captured as a CUDA graph. The tables are the graph's
    state (updated in place); the batch's arrays go into static buffers.
    The step runs once on a side stream to warm the libraries, then once
    under capture; the tables are restored bit for bit after the warm-up.
    `replay(values)` copies a batch in and replays: one dispatch."""

    def __init__(self, step, tables, static):
        self.static = static
        saved = [t.clone() for t in tables]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(*tables, **static)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            step(*tables, **static)
        for t, s in zip(tables, saved):
            t.copy_(s)

    def replay(self, values):
        for name, v in values.items():
            self.static[name].copy_(v)
        self.graph.replay()


# ---------------------------------------------------------------------------
# Host-side batch builders + algorithm classes
# ---------------------------------------------------------------------------

def window_indices(n, window, rng):
    """Shared word2vec windowing: per-position reduced window b ~ U[1, w]
    (word2vec semantics). Returns (j [n, 2w] neighbor indices, valid
    [n, 2w] bools) — consumed by SkipGram (pair indices), CBOW (context
    rows), and DM (context rows + label column)."""
    b = rng.integers(1, window + 1, n)
    offs = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    j = np.arange(n)[:, None] + offs[None, :]              # [n, 2w]
    valid = ((np.abs(offs)[None, :] <= b[:, None])
             & (j >= 0) & (j < n))
    return j, valid


def window_contexts(ids_arr, window, rng):
    """(context [n, 2w] with -1 padding, ids) — the CBOW/DM row form."""
    n = len(ids_arr)
    j, valid = window_indices(n, window, rng)
    return np.where(valid, ids_arr[np.clip(j, 0, n - 1)],
                    -1).astype(np.int32), valid


class BaseElementsLearning:
    """Shared batching machinery. Subclasses emit (center, context) training
    pairs; this class turns them into padded index arrays and runs the
    device step on the tables."""

    _step = None        # sg_step / cbow_step
    _inputs = ()        # the step's batch arguments, in order

    def _corpus_chunk(self, seqs_ids, native_fn):
        """Shared corpus-chunk scaffolding for the native generators:
        filters len<2 sequences, concatenates ids, builds offsets, draws
        the seed, and calls `native_fn(ids, offsets, window, seed)`.
        Returns (kept_seqs, result); result is None when the native
        library is unavailable (caller runs the per-sequence fallback)."""
        from ...common.native_ops import pack_corpus
        seqs_ids = [s for s in seqs_ids if len(s) >= 2]
        if not seqs_ids:
            return [], None
        ids, offsets = pack_corpus(seqs_ids)
        return seqs_ids, native_fn(ids, offsets, self.window,
                                   seed=int(self._rng.integers(2**63)))

    def __init__(self, batch_pairs=4096, cuda_graph=True):
        self.batch_pairs = int(batch_pairs)
        self.cuda_graph = bool(cuda_graph)
        self.lookup = None
        self.vocab = None
        self.window = 5
        self.negative = 0
        self.use_hs = True
        self._max_code_len = 1
        self._rng = np.random.default_rng(0)
        self.device = None
        self._syn0 = None
        self._syn1 = None   # whichever of syn1 / syn1neg is in use
        self._graphs = {}
        self._pending = []
        self._pending_count = 0
        self._flushed_pairs = 0   # valid (non-pad) pairs applied on device
        self.flushes = 0          # device steps run (eager or replayed)

    def configure(self, vocab, lookup, *, window=5, negative=0, use_hs=True,
                  seed=12345, mesh=None, device=None):
        """Put the lookup table's syn0 and syn1 (or syn1neg) on `device`
        (None: the CUDA card) as f32 tensors, updated in place by every
        flush until `finish` writes them back. `mesh` (the reference's
        column-sharded tables) is not ported."""
        if mesh is not None:
            raise _not_ported("configure(mesh=...): mesh-sharded embedding "
                              "tables")
        self.device = resolve_device(device)
        self.vocab = vocab
        self.lookup = lookup
        self.window = int(window)
        self.negative = int(negative)
        self.use_hs = bool(use_hs) and lookup.syn1 is not None
        self._rng = np.random.default_rng(seed)
        if self.use_hs:
            self._max_code_len = max(
                (len(w.codes) for w in vocab.vocab_words()), default=1)
        put = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                     device=self.device)
        self._syn0 = put(lookup.syn0)
        self._syn1 = put(lookup.syn1 if self.use_hs else lookup.syn1neg)
        self._graphs = {}
        self._codes = None
        self._points = None
        if self.use_hs:
            V = len(vocab)
            L = self._max_code_len
            self._codes = np.zeros((V, L), np.float32)
            self._points = np.zeros((V, L), np.int32)
            self._code_mask = np.zeros((V, L), np.float32)
            for w in vocab.vocab_words():
                l = len(w.codes)
                self._codes[w.index, :l] = w.codes
                self._points[w.index, :l] = w.points
                self._code_mask[w.index, :l] = 1.0
        self._pending = []
        self._pending_count = 0
        self._flushed_pairs = 0
        return self

    def finish(self):
        """Flush pending pairs and write weights back to the lookup table."""
        self._flush(force=True)
        self.lookup.syn0 = self._fetch(self._syn0)
        if self.use_hs:
            self.lookup.syn1 = self._fetch(self._syn1)
        else:
            self.lookup.syn1neg = self._fetch(self._syn1)

    @staticmethod
    def _fetch(t):
        return t.to("cpu", copy=True).numpy()

    def _run(self, *arrays):
        """Apply one padded batch (numpy, in the step's argument order) to
        the tables: eagerly, or by replaying the shape's CUDA graph."""
        dev = self.device
        values = {}
        for name, a in zip(self._inputs, map(np.asarray, arrays)):
            values[name] = torch.from_numpy(a).to(
                torch.int64 if a.dtype.kind == "i" else torch.float32)
        on_device = lambda: {n: v.to(dev) for n, v in values.items()}  # noqa
        tables = (self._syn0, self._syn1)
        with card_numerics(dev, torch.float32):
            if dev.type != "cuda" or not self.cuda_graph:
                self._step(*tables, **on_device())
            else:
                key = tuple(v.shape for v in values.values())
                if key not in self._graphs:
                    self._graphs[key] = _CapturedFlush(self._step, tables,
                                                       on_device())
                self._graphs[key].replay(values)
        self.flushes += 1

    # -- pair -> target/label arrays ------------------------------------
    def _targets_labels(self, out_ids):
        """out_ids [B]: the predicted word per pair. Returns
        (targets [B,T], labels [B,T], mask [B,T])."""
        B = len(out_ids)
        out_ids = np.asarray(out_ids, np.int32)
        if self.use_hs:
            targets = self._points[out_ids]
            labels = 1.0 - self._codes[out_ids]
            mask = self._code_mask[out_ids]
            return targets, labels.astype(np.float32), mask
        K = self.negative
        neg = self.lookup.neg_table[
            self._rng.integers(0, self.lookup.table_size, (B, K))]
        targets = np.concatenate([out_ids[:, None], neg], axis=1)
        labels = np.zeros((B, K + 1), np.float32)
        labels[:, 0] = 1.0
        mask = np.ones((B, K + 1), np.float32)
        # negatives that collide with the positive are masked out
        mask[:, 1:] = (neg != out_ids[:, None]).astype(np.float32)
        return targets.astype(np.int32), labels, mask


class SkipGram(BaseElementsLearning):
    """reference: learning/impl/elements/SkipGram.java

    Pair generation is vectorized on the host (the reference's
    per-position loop runs inside the native AggregateSkipGram kernel)."""

    name = "skipgram"
    _step = staticmethod(sg_step)
    _inputs = ("centers", "targets", "labels", "mask", "lr")

    def lower_step(self):
        raise _not_ported("lower_step (the mesh cost model's XLA lowering)")

    def learn_sequence(self, ids, lr):
        """ids: list of vocab indices for one sequence."""
        n = len(ids)
        if n < 2:
            return
        ids_arr = np.asarray(ids, np.int32)
        j, valid = window_indices(n, self.window, self._rng)
        pos_idx, off_idx = np.nonzero(valid)
        self.enqueue_pairs(ids_arr[pos_idx], ids_arr[j[pos_idx, off_idx]],
                           lr)

    def learn_sequences_batch(self, seqs_ids, lr):
        """Corpus-chunk fast path: generate pairs for MANY sequences in one
        native call (C++ `dl4j_skipgram_pairs`) at a single lr. Falls back
        to the vectorized per-sequence path when the native library is
        unavailable. Same reduced-window b ~ U[1, w] semantics; the native
        path draws b from its own deterministic xorshift stream seeded off
        this instance's rng."""
        from ...common import native_ops
        kept, res = self._corpus_chunk(seqs_ids, native_ops.skipgram_pairs)
        if res is None:
            for s in kept:
                self.learn_sequence(s, lr)
            return
        centers, outs = res
        self.enqueue_pairs(centers, outs, lr)

    def enqueue_pairs(self, centers, outs, lr):
        """Queue (center, predicted) index arrays for the batched step —
        external pair sources (DBOW's label->word pairs) call this."""
        centers = np.asarray(centers, np.int32)
        outs = np.asarray(outs, np.int32)
        if centers.size == 0:
            return
        self._pending.append((centers, outs, np.float32(lr)))
        self._pending_count += len(centers)
        if self._pending_count >= self.batch_pairs:
            self._flush()

    def _flush(self, force=False):
        # run fixed-size batches only (one shape per flush size); pad the
        # forced tail with masked dummy pairs
        B = self.batch_pairs
        if not self._pending:
            return
        centers = np.concatenate([p[0] for p in self._pending])
        outs = np.concatenate([p[1] for p in self._pending])
        lrs = np.concatenate([
            np.broadcast_to(np.asarray(p[2], np.float32),
                            (len(p[0]),)) for p in self._pending])
        self._pending = []
        self._pending_count = 0
        total = len(centers)
        start = 0
        while total - start >= B or (force and start < total):
            take = min(B, total - start)
            c = np.zeros((B,), np.int32)
            o = np.zeros((B,), np.int32)
            c[:take] = centers[start:start + take]
            o[:take] = outs[start:start + take]
            valid = np.zeros((B,), np.float32)
            valid[:take] = 1.0
            lr = float(lrs[start:start + take].mean()) if take else 0.0
            start += take
            targets, labels, mask = self._targets_labels(o)
            mask = mask * valid[:, None]
            self._run(c, targets, labels, mask, np.float32(lr))
            self._flushed_pairs += take
        if start < total:   # stash the sub-batch remainder
            self._pending.append((centers[start:], outs[start:],
                                  lrs[start:]))
            self._pending_count = total - start


class CBOW(BaseElementsLearning):
    """reference: learning/impl/elements/CBOW.java"""

    name = "cbow"
    _step = staticmethod(cbow_step)
    _inputs = ("context", "cmask", "targets", "labels", "tmask", "lr")

    def __init__(self, batch_pairs=2048, cbow_mean=True, cuda_graph=True):
        super().__init__(batch_pairs, cuda_graph)
        self.cbow_mean = cbow_mean

    def learn_sequence(self, ids, lr):
        n = len(ids)
        if n == 0:
            return
        ids_arr = np.asarray(ids, np.int32)
        context, valid = window_contexts(ids_arr, self.window, self._rng)
        keep = valid.any(axis=1)
        self.enqueue_windows(context[keep], ids_arr[keep], lr)

    def learn_sequences_batch(self, seqs_ids, lr):
        """Corpus-chunk fast path (sibling of SkipGram's): C++
        `dl4j_cbow_contexts` emits padded context rows + targets for many
        sequences in one call; falls back to the vectorized per-sequence
        path without the native library."""
        from ...common import native_ops
        kept, res = self._corpus_chunk(seqs_ids, native_ops.cbow_contexts)
        if res is None:
            for s in kept:
                self.learn_sequence(s, lr)
            return
        context, targets = res
        self.enqueue_windows(context, targets, lr)

    def enqueue_windows(self, context, outs, lr):
        """Queue (context-row, predicted) arrays: context [m, <=2w+1] with
        -1 padding, outs [m]. External window sources (DM's label-augmented
        contexts) call this."""
        context = np.asarray(context, np.int32)
        outs = np.asarray(outs, np.int32)
        if context.size == 0:
            return
        self._pending.append((context, outs, np.float32(lr)))
        self._pending_count += len(outs)
        if self._pending_count >= self.batch_pairs:
            self._flush()

    def _flush(self, force=False):
        B = self.batch_pairs
        # fixed width 2w+1 (covers DM's appended label column): one shape
        # for both CBOW and DM batches
        C = 2 * self.window + 1
        if not self._pending:
            return
        ctx = np.concatenate([
            np.pad(p[0][:, :C], ((0, 0), (0, max(0, C - p[0].shape[1]))),
                   constant_values=-1) for p in self._pending])
        outs = np.concatenate([p[1] for p in self._pending])
        lrs = np.concatenate([
            np.broadcast_to(np.asarray(p[2], np.float32),
                            (len(p[1]),)) for p in self._pending])
        self._pending = []
        self._pending_count = 0
        total = len(outs)
        start = 0
        while total - start >= B or (force and start < total):
            take = min(B, total - start)
            context = np.full((B, C), -1, np.int32)
            o = np.zeros((B,), np.int32)
            context[:take] = ctx[start:start + take]
            o[:take] = outs[start:start + take]
            valid = np.zeros((B,), np.float32)
            valid[:take] = 1.0
            lr = float(lrs[start:start + take].mean()) if take else 0.0
            start += take
            cmask = (context >= 0).astype(np.float32) * valid[:, None]
            targets, labels, tmask = self._targets_labels(o)
            tmask = tmask * valid[:, None]
            self._run(context, cmask, targets, labels, tmask,
                      np.float32(lr))
            self._flushed_pairs += take
        if start < total:   # stash the sub-batch remainder
            self._pending.append((ctx[start:], outs[start:], lrs[start:]))
            self._pending_count = total - start


ELEMENTS_LEARNING = {"skipgram": SkipGram, "cbow": CBOW}
