"""Speculative decoding: K tokens per decode dispatch, bit-identical.

The port's copy of deeplearning4j_tpu/serving/speculate.py: `DraftSource`,
`NGramDraft`, `Speculator` and `as_speculator` are the reference's, line for
line; `ModelDraft` drives the draft `TransformerLM` through the port's
single-token KV-cache step (`TransformerLM._decode_step`) on the model's
device, with one host read of the argmax per draft token, as the
reference's `np.asarray`. The text below is the reference's.

The serving decode loop (`serving/decode.py`) pays one device dispatch
per generated token per iteration — the exact cost model the fused-steps
work attacked for training, and on a remote-attached chip every dispatch
is a tunnel round-trip. Speculative decoding (Leviathan et al. 2023,
"Fast Inference from Transformers via Speculative Decoding") amortizes
it: a cheap DRAFT proposes K-1 candidate tokens, ONE K-wide verify
dispatch scores all of them, and the scheduler accepts the longest
prefix whose greedy argmax matches the draft plus one bonus token —
1..K tokens per dispatch. BOTH cache layouts run it: the fixed-slot
verify program (`models.zoo.transformer.make_slot_verify_fn`) and its
block-table twin (`make_paged_verify_fn` — same contract, writes
re-addressed through the block table under the paged chunk program's
[wfrom, wto) index gate), so `ContinuousDecodeServer(paged=True,
speculate=...)` — the production configuration — keeps the
dispatch-amortization win on the paged memory model.

Because the decode path is GREEDY, acceptance-by-exact-match makes the
emitted stream the verify program's OWN argmax chain by construction:
every accepted token IS that program's argmax at its position, so a
draft can only change how many dispatches the stream costs, never which
tokens it contains. Bit-identity with the plain 1-wide decode stream
then follows from argmax parity across dispatch widths — the same
measured cross-shape property the serving prefill/decode pin already
rests on (per-row gemm bits stable across M; a near-tie logit is the
theoretical exposure, same as bucket-padded prefill). That folds
speculation into the repo's determinism-pin culture (join == solo ==
`generate_batch`): a pure throughput lever, like continuous batching's
slot refill — pinned by tests/test_speculative.py across K ∈ {2, 4, 8},
both draft sources, solo/co-batched serving, and a mid-stream hot swap.

Two draft sources, both pluggable (the `DraftSource` protocol below):

  * `NGramDraft` — host-side prompt-lookup / self n-gram drafting: the
    request's OWN token history (prompt + accepted tokens) is the draft
    model; the longest recent n-gram matching the current suffix
    proposes its continuation. Zero extra model, zero extra dispatch —
    pure host work — and strong on repetitive text (code, greedy loops,
    retrieval-grounded prompts).
  * `ModelDraft` — a smaller `TransformerLM` with its own KV cache
    drafting K-1 tokens in K-1 cheap single-token dispatches. The draft
    cache tracks the ACCEPTED stream: rejected speculative rows are
    rolled back by pointer (dead rows, overwritten before attended —
    the same contract as the target's slot cache), so a divergence costs
    re-ingesting only the bonus token. Draft params are deliberately NOT
    version-pinned across target hot swaps: a stale draft lowers the
    acceptance rate, never correctness.

`Speculator` bundles a draft source with the verify width K — the object
`ContinuousDecodeServer(speculate=...)`, `TransformerLM.generate(
draft=...)` and `generate_batch(draft=...)` all accept.
"""
from __future__ import annotations

import logging

from .. import obs

log = logging.getLogger(__name__)


class DraftSource:
    """Protocol for draft-token providers. Keys identify independent
    request streams (the serving scheduler uses slot indices; generate()
    uses per-call sentinels); every method must be cheap host work or a
    small-model dispatch — never a blocking call into the target model.

    Lifecycle per stream: start(key, tokens) with the full context so far
    (prompt + first accepted token) -> repeated propose(key, k) /
    observe(key, accepted) pairs -> stop(key). A proposal may be SHORTER
    than k (including empty) when the source has nothing credible — the
    scheduler pads; padding costs acceptance, never correctness."""

    def start(self, key, tokens):
        raise NotImplementedError

    def observe(self, key, tokens):
        raise NotImplementedError

    def propose(self, key, k):
        raise NotImplementedError

    def stop(self, key):
        raise NotImplementedError


class NGramDraft(DraftSource):
    """Prompt-lookup / self n-gram drafting (host-side, zero dispatches).

    The draft "model" is the request's own token history: to propose,
    find the most recent PREVIOUS occurrence of the current suffix
    n-gram (longest n first, down to `min_match`) and propose the tokens
    that followed it. Greedy decode loves to repeat itself — and prompts
    that quote the text being continued (summarization, code edits,
    retrieval) repeat the prompt — which is exactly when this hits."""

    def __init__(self, n=3, min_match=1):
        if int(n) < int(min_match) or int(min_match) < 1:
            raise ValueError(f"need n >= min_match >= 1, got "
                             f"n={n} min_match={min_match}")
        self.n = int(n)
        self.min_match = int(min_match)
        self._hist = {}

    def start(self, key, tokens):
        self._hist[key] = [int(t) for t in tokens]

    def observe(self, key, tokens):
        self._hist[key].extend(int(t) for t in tokens)

    def propose(self, key, k):
        hist = self._hist[key]
        if k < 1:
            return []
        for g in range(min(self.n, len(hist) - 1), self.min_match - 1, -1):
            suffix = hist[-g:]
            # most recent prior occurrence wins (recency beats frequency
            # for continuation prediction); j is the index AFTER the match
            for j in range(len(hist) - 1, g - 1, -1):
                if hist[j - g:j] == suffix:
                    return hist[j:j + k]
            # fall through to a shorter suffix only when g never matched
        return []

    def stop(self, key):
        self._hist.pop(key, None)


class ModelDraft(DraftSource):
    """Draft tokens from a smaller `TransformerLM` with its own KV cache.

    Per stream, the draft keeps (cache, pos, pending, fed): `pos` is the
    committed cache frontier (rows < pos hold the ACCEPTED stream),
    `pending` are accepted tokens not yet ingested, `fed` are the
    speculative tokens fed past the frontier by the last propose().
    propose() ingests pending (one cheap dispatch each — the last
    ingest's logits seed the first proposal), then greedily decodes the
    remaining proposals. observe() rolls the frontier forward over the
    accepted prefix that matches what was fed (those speculative rows are
    already correct) and queues the rest — typically just the bonus token
    — so a round costs ~K draft dispatches, not a re-prefill.

    The draft model's max_len must cover the target's streams plus the
    speculative overhang (target max_len + k is always safe); proposals
    are truncated at the draft cache edge rather than overrunning it."""

    def __init__(self, lm):
        self.lm = lm
        self._max_len = int(lm.max_len)
        self._state = {}
        self.dispatch_count = 0     # device dispatches paid for drafting
        #                             (the scheduler folds these into
        #                             device_dispatches_per_token)

    def _feed(self, st, token):
        """One single-token draft dispatch at the stream frontier (the
        model's own KV-cache step, as generate(use_cache=True) runs it)."""
        import torch
        with torch.no_grad():
            logit = self.lm._decode_step(
                st["cache"], st["pos"],
                torch.tensor([int(token)], device=self.lm.device))[0]
        st["pos"] += 1
        self.dispatch_count += 1
        return logit

    def start(self, key, tokens):
        from ..models.zoo.transformer import init_kv_cache
        self._state[key] = {
            "cache": init_kv_cache(len(self.lm.blocks), 1, self._max_len,
                                   self.lm.aux.tok.shape[1],
                                   self.lm.n_heads, self.lm.aux.tok.dtype,
                                   self.lm.device),
            "pos": 0,
            "base": 0,
            "pending": [int(t) for t in tokens],
            "fed": [],
        }

    def observe(self, key, tokens):
        st = self._state[key]
        tokens = [int(t) for t in tokens]
        m = 0
        while m < min(len(tokens), len(st["fed"])) and \
                tokens[m] == st["fed"][m]:
            m += 1
        # keep the speculative rows the target accepted; roll back past
        # the divergence (dead rows, overwritten before attended)
        st["pos"] = st["base"] + m
        st["fed"] = []
        st["pending"].extend(tokens[m:])

    def propose(self, key, k):
        # one span per proposal round: a ModelDraft's K-1 dispatches are
        # real device work the timeline must show next to the verify
        # dispatch they amortize (an NGramDraft never appears here)
        with obs.TRACER.span("draft.propose", cat="serve", track="server",
                             k=int(k)):
            st = self._state[key]
            logit = None
            while st["pending"] and st["pos"] < self._max_len:
                logit = self._feed(st, st["pending"].pop(0))
            st["base"] = st["pos"]
            st["fed"] = []
            if logit is None or k < 1:
                # nothing newly ingested to seed from (or cache exhausted)
                return []
            out = []
            for i in range(int(k)):
                nt = int(logit.float().argmax())
                out.append(nt)
                if i < int(k) - 1:
                    if st["pos"] >= self._max_len:
                        break           # draft cache edge: truncate
                    logit = self._feed(st, nt)
                    st["fed"].append(nt)
            return out

    def stop(self, key):
        self._state.pop(key, None)


class Speculator:
    """Draft source + verify width K, the bundle the serving/scheduling
    layers accept. K is the WIDTH of the verify program: K-1 draft
    tokens in, 1..K tokens accepted per dispatch (matched prefix + one
    bonus). k=1 degenerates to plain decode through the verify program."""

    def __init__(self, draft, k=4):
        if not isinstance(draft, DraftSource):
            raise TypeError(f"draft must be a DraftSource, got "
                            f"{type(draft).__name__}")
        if int(k) < 1:
            raise ValueError(f"speculative width k must be >= 1, got {k}")
        self.draft = draft
        self.k = int(k)


def as_speculator(obj, k=4):
    """Normalize `speculate=`/`draft=` arguments: a Speculator passes
    through; a bare DraftSource is wrapped with width `k`."""
    if obj is None:
        return None
    if isinstance(obj, Speculator):
        return obj
    return Speculator(obj, k)
