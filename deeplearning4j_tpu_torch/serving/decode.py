"""Continuous-batching KV-cache decode scheduler (Orca, OSDI'22): port of
deeplearning4j_tpu/serving/decode.py.

Static request batching decodes a gang of requests until the LAST one
finishes: a 5-token reply waits for the 200-token reply beside it.
Iteration-level ("continuous") batching reschedules at token granularity
instead: a fixed-slot decode program (`models.zoo.transformer.
make_slot_decode_fn`) runs one token for every occupied slot per dispatch,
and requests join or leave slots BETWEEN dispatches. A joining request's
prompt runs through a prefill program padded to a prompt-length bucket,
whose cache rows are installed into the free slot.

The programs are plain functions on tensors; the KV cache is updated in
place (the reference donates it). Every serving cache carries one spare
row past its end, where the writes the reference drops land
(`transformer.gated_cache_rows`). The server runs on the model's device:
the card unless the model was built with device="cpu". Its thread runs
under `torch.no_grad()` and `card_numerics`. Each dispatch waits on the
host once, for its next tokens, as the reference's `np.asarray` does.

Determinism pin (tests/test_torch_decode_server.py): a request's token
stream is bit-identical whether it decodes alone or joins a running batch
- every slot's row math touches only its own cache/pos/token rows, and an
inactive slot writes only the spare row. On the card the pin holds within
one server and one shape (cuBLAS picks its kernels by shape); across
shapes and layouts the smoke measures the difference (PERF.md).

Hot swap keeps several parameter versions live while draining: slots keep
the version they started with, each iteration dispatches once per live
version with the active mask restricted to that version's slots, and new
requests route to the newest version. Drained versions are released on
completion and on idle iterations.

Deadlines are enforced mid-decode: a slot whose request outlives its
budget is evicted between iterations (DeadlineExceededError, shed
counted, slot refilled the same iteration).

Paged KV cache (`paged=True`, `kvpool.BlockPool` + the paged programs):
one block arena for every stream, a block table per request, admission
gated by FREE BLOCKS (a request that cannot get its blocks waits in a
memory line, counted `blocked_on_memory`), prompt prefixes shared by
reference with copy-on-write before a divergent append. Paging adds no
decode dispatch per token.

Overload control (`admission.py` + `make_chunked_prefill_fn`):
* chunked prefill (`chunked_prefill=C`): a prompt longer than one chunk
  enters its slot in a PREFILL phase and advances C rows per iteration,
  interleaved with everyone's decode; the stream equals the one-shot
  stream, and in paged mode chunking starts after a resident shared
  prefix;
* deadline-aware admission (`admission=`): a service-rate estimator
  predicts completion at enqueue and sheds what cannot make its deadline
  (`shed_predicted`);
* brownout (`brownout=`): accept/defer/shed per request class
  (`submit(..., klass=)`); deferred requests park in a side line served
  only when the primary queue is empty;
* prefix-hit priority (paged + prefix_cache + chunked_prefill): a
  request whose prompt is resident costs one chunk and overtakes cold
  prompts, with one primary turn after `_PRIO_BURST` overtakes.

Fused decode windows (`fused_serve=K`): K decode iterations in one
dispatch (`make_fused_decode_fn` / its paged twin). On the card a window
is ONE captured CUDA graph per (layout, slots, K, parameter version):
static input buffers for tok, pos, active, steps (and the block tables
and wto), the cache updated in place, the version's own parameter
tensors; one replay counts as one dispatch. A swap's version captures its
own graph, freed with the version; a reset of the device state frees
them all. A capture that fails raises (the occupied requests fail, as on
any terminal dispatch fault). On the CPU the window runs eagerly.

Speculative decoding (`speculate=`, `serving/speculate.py`): each
iteration drafts K-1 tokens per slot (n-gram lookup on the host, or a
draft model) and one K-wide verify dispatch (`make_slot_verify_fn`, or
`make_paged_verify_fn` through the block table) accepts 1..K of them per
slot. The verify's argmax and acceptance counts come to the host in one
copy per dispatch. The emitted stream is the verify program's own argmax
chain; equality with the 1-wide step's stream rests on argmax parity
across widths, which on the card is measured (PERF.md), not pinned.
`fused_serve > 1` with `speculate=` is refused at the constructor.

Durable KV state (`serving/kvstate.py` + `make_block_extract_fn`, paged
only): a decode-phase slot's rows leave the arena as a host-side
`RequestArtifact` and come back bit-identically. Preemption
(`preempt=True` with a brownout policy) spills a lower-class slot when a
higher class is blocked on blocks and parks it on a resume line served
ahead of the queues; `migrate_out` / `migrate_in` move a live request
between servers, tag-checked by the parameters' content fingerprint
(`_param_fingerprint`, equal to the reference's for the same weights);
`prefix_cache_dir=` saves the prefix cache at stop() and restores it at
construction; `prefix_export` / `prefix_adopt` move a prefix chain
between running servers. An extraction is one gather on the serve stream
followed by one synchronous device-to-host copy, so the spilled rows are
on the host before the freed blocks can be written again.

The fleet verbs (`serving/fleet.py`, `serving/wire.py`): `kill()` is an
abrupt death (every held future fails with `ReplicaDeadError`, nothing
drains or persists, the server never starts again); `drain()` hands
every admitted request off in one pass on the serve thread, decode-phase
ones as `RequestArtifact`s (paged only) and the rest as replay specs,
then stops.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import hashlib
import itertools
import logging
import os
import queue
import shutil
import threading
import time

import numpy as np
import torch

from .. import obs
from ..common.device import card_numerics
from ..models.zoo import transformer as _T
from .admission import DEFER, SHED, AdmissionController
from .kvpool import BlockPool
from .kvstate import (KVStateError, KVStateVersionError,
                      PrefixCacheArtifact, RequestArtifact, artifact_kind)
from .metrics import ServingMetrics
from .server import (DeadlineExceededError, ReplicaDeadError,
                     RequestDrainedError, RequestMigratedError,
                     ServerClosedError, ServerOverloadedError,
                     _fail_future, _RequestLoop, _resolve_future)
from .speculate import as_speculator

log = logging.getLogger(__name__)


def _param_leaves(aux, blocks):
    """(name, tensor) of one parameter version, in a fixed order."""
    return (list(aux.named_parameters(prefix="aux"))
            + [(name, t) for i, b in enumerate(blocks)
               for name, t in b.named_parameters(prefix=f"blocks.{i}")])


def _dtype_name(dtype):
    """A torch or numpy dtype's name: "float32", "bfloat16", ..."""
    return str(dtype).rsplit(".", 1)[-1]


def _param_fingerprint(aux, blocks):
    """Content fingerprint of one parameter version: sha256 over each
    leaf's shape string, dtype name and bytes, in the reference's
    `tree_leaves((aux, blocks))` order (every dict level in sorted key
    order) and layouts, so the same weights give the same tag in both
    packages. The durable version tag of `kvstate`; computed once per
    version, never on the decode path (it copies every parameter to the
    host)."""
    h = hashlib.sha256()
    for t in _T.tree_leaves(aux, blocks):
        t = t.detach().cpu().contiguous()
        h.update(str(tuple(t.shape)).encode())
        h.update(_dtype_name(t.dtype).encode())
        words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        h.update(words.numpy().tobytes())
    return h.hexdigest()[:16]


def _host_panels(dev_panels, rows):
    """Device panels [(k, v)] per layer -> host panels of their first
    `rows` rows, in one synchronous device-to-host copy (never into
    pageable memory asynchronously): when it returns, the rows are on the
    host and the arena may be written again. bf16 stays a CPU torch
    tensor (numpy has none; see kvstate), other dtypes become numpy."""
    flat = torch.stack([a[:rows] for kv in dev_panels for a in kv]).cpu()
    out = [a if a.dtype == torch.bfloat16 else a.numpy() for a in flat]
    return [(out[i], out[i + 1]) for i in range(0, len(out), 2)]


def _block_panels(host, i, bs):
    """Block i's rows of host panels [(k, v)] per layer (copies)."""
    cut = lambda a: a[i * bs:(i + 1) * bs].copy() if isinstance(
        a, np.ndarray) else a[i * bs:(i + 1) * bs].clone()
    return [(cut(k), cut(v)) for k, v in host]


def _cat(parts):
    """Concatenate host panel rows (numpy arrays or bf16 tensors)."""
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts)
    return torch.cat(parts)


class _Wake:
    """Sentinel pushed through the primary queue to wake the idle blocking
    get when a priority submit parks in the side line. Its future is born
    resolved, so every consumer discards it."""

    __slots__ = ("future", "deadline", "req_id")

    def __init__(self):
        self.future = cf.Future()
        self.future.set_result(None)
        self.deadline = None
        self.req_id = None


class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "future", "deadline", "t_submit",
                 "generated", "slot", "version", "req_id", "t_last_tok",
                 "t_first_tok", "alloc", "mem_blocked", "pf_next",
                 "pf_wfrom", "work_left", "work_counted", "predicted_done",
                 "klass", "prio_overtook", "pf_quoted", "artifact",
                 "migrated", "progress_base")

    def __init__(self, prompt, max_new, deadline, klass="default"):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.future = cf.Future()
        self.deadline = deadline
        self.t_submit = time.monotonic()
        self.generated = []
        self.slot = None
        self.version = None
        self.req_id = None      # assigned at submit (the trace/request id)
        self.t_last_tok = None  # when this request's last token landed
        self.t_first_tok = None     # when its first token landed (TTFT)
        self.alloc = None       # paged mode: kvpool.PagedAllocation
        self.mem_blocked = False    # counted blocked_on_memory once
        self.pf_next = None     # chunked prefill: next prompt row to run
        self.pf_wfrom = 0       # chunked paged: first row to WRITE
        self.work_left = int(max_new)   # admission backlog accounting
        self.work_counted = False       # work_left added to the backlog?
        self.predicted_done = None      # estimator's completion estimate
        self.klass = klass      # brownout request class
        self.prio_overtook = False  # left the priority line past queued
        #                             work; counted at ADMIT
        self.pf_quoted = 1      # prefill units quoted at submit
        self.artifact = None    # kvstate.RequestArtifact parked for resume
        self.migrated = False   # arrived by migrate_in
        self.progress_base = 0  # len(generated) at the last restore


class _CapturedWindow:
    """One fused window captured as a CUDA graph. `run(static)` launches
    the window on the static input buffers and returns (toks, pos); it
    runs once on a side stream with every slot inactive (so only the
    spare rows are written) to warm the libraries, then once under
    capture. `replay(values)` copies the new inputs into the buffers and
    replays: one dispatch."""

    def __init__(self, run, static):
        self.static = static
        static["active"].zero_()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(static)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.toks, self.pos = run(static)

    def replay(self, values):
        for name, v in values.items():
            self.static[name].copy_(v)
        self.graph.replay()
        return self.toks, self.pos.clone()


class ContinuousDecodeServer(_RequestLoop):
    """Token-granularity serving endpoint over a TransformerLM.

    `submit(prompt, max_new_tokens)` returns a Future resolving to the
    full token list (prompt + generated, greedy decode: the
    `generate_batch` contract). `static_batching=True` degrades scheduling
    to gang admission (a new batch forms only when every slot is free),
    the A/B baseline, through the same machinery.
    """

    _thread_name = "continuous-decode"
    _default_stop_timeout = 60.0
    # a preemption victim must decode this many tokens since its last
    # (re)start before it may be spilled again (no spill/restore loop)
    _PREEMPT_MIN_PROGRESS = 4
    # after this many consecutive priority overtakes, the primary queue's
    # head gets one turn: prefix-hit traffic never starves cold prompts
    _PRIO_BURST = 4
    # the fleet prefix tier's artifact bytes serviced per iteration (at
    # least one command always runs)
    _PREFIX_IO_BUDGET = 4 << 20

    def __init__(self, lm, slots=4, prompt_buckets=(8, 16, 32),
                 max_queue=64, fault_injector=None, retry_policy=None,
                 metrics=None, stats_reporter=None, report_every=64,
                 static_batching=False, speculate=None, tracer=None,
                 flight_recorder=None, paged=False, block_size=16,
                 n_blocks=None, prefix_cache=True,
                 max_blocks_per_slot=None, chunked_prefill=None,
                 admission=None, brownout=None,
                 default_deadline_ms=None, prefix_priority=True,
                 preempt=False, prefix_cache_dir=None, instance=None,
                 fused_serve=None):
        self._tracer = tracer if tracer is not None else obs.TRACER
        self._flight = flight_recorder
        self.lm = lm
        self.device = lm.device
        self.slots = int(slots)
        self.max_len = int(lm.max_len)
        self.prompt_buckets = tuple(sorted(int(b) for b in prompt_buckets))
        if self.prompt_buckets[-1] > self.max_len:
            raise ValueError(f"largest prompt bucket "
                             f"{self.prompt_buckets[-1]} > model max_len "
                             f"{self.max_len}")
        self._injector = fault_injector
        self._retry = retry_policy
        # the instance's name: the ServingMetrics endpoint name and, when
        # set explicitly, the prefix of the request/trace ids ("i0-7")
        self.metrics = metrics or ServingMetrics(name=instance)
        self.instance = (str(instance) if instance is not None
                         else self.metrics.name)
        self._named_instance = instance is not None
        self._reporter = stats_reporter
        self._report_every = max(1, int(report_every))
        self._static = bool(static_batching)

        n_heads = lm.n_heads
        self._n_heads = n_heads
        self._d_model = int(lm.aux.tok.shape[1])
        self._cache_dtype = lm.aux.tok.dtype
        self._n_layers = len(lm.blocks)
        self._versions = [(lm.aux, list(lm.blocks))]  # index = version

        # paged KV cache: arena + block tables replace the fixed per-slot
        # cache; admission gates on free blocks
        self._paged = bool(paged)
        self._block_size = int(block_size)
        if self._paged and self._block_size < 1:
            raise ValueError(f"need block_size >= 1, got {block_size}")
        # default arena == the fixed-slot footprint at the same slot count
        self._n_blocks = (int(n_blocks) if n_blocks is not None else
                          -(-self.slots * self.max_len
                            // self._block_size))
        self._nb_slot = (int(max_blocks_per_slot)
                         if max_blocks_per_slot is not None else
                         -(-self.max_len // self._block_size))
        self._prefix_cache = bool(prefix_cache)
        self._mem_wait = collections.deque()     # blocked on FREE BLOCKS

        # overload control: chunk size, admission predictor, brownout
        # policy, default per-request deadline
        self._chunk = None if chunked_prefill is None \
            else int(chunked_prefill)
        if self._chunk is not None and self._chunk > self.max_len:
            raise ValueError(f"chunked_prefill {self._chunk} > model "
                             f"max_len {self.max_len}")
        self._admission = (AdmissionController() if admission is True
                           else admission)
        if self._admission is not None and \
                self._admission.estimator.slots is None:
            self._admission.estimator.slots = self.slots
        self._brownout = brownout
        self.default_deadline = (None if default_deadline_ms is None
                                 else float(default_deadline_ms) / 1e3)
        self._defer_q = collections.deque()      # brownout-deferred line
        self._prefix_priority = (bool(prefix_priority) and self._paged
                                 and self._prefix_cache
                                 and self._chunk is not None)
        self._prio_q = collections.deque()       # prefix-hit fast line
        self._prio_streak = 0   # consecutive genuine overtakes
        # durable KV state: preemption needs the paged pool (a block set
        # to spill) and a brownout policy (the class ranking)
        self._preempt_on = bool(preempt)
        if self._preempt_on and not self._paged:
            raise ValueError("preempt=True requires paged=True (only a "
                             "block-table KV set can be spilled)")
        if self._preempt_on and brownout is None:
            raise ValueError("preempt=True requires a brownout= policy: "
                             "BrownoutPolicy.may_preempt ranks request "
                             "classes, and without a ranking nothing "
                             "may ever be preempted")
        self._prefix_dir = (None if prefix_cache_dir is None
                            else str(prefix_cache_dir))
        if self._prefix_dir is not None and not (
                self._paged and self._prefix_cache):
            raise ValueError("prefix_cache_dir requires paged=True with "
                             "prefix_cache=True (there is no prefix "
                             "cache to persist otherwise)")
        self._resume_q = collections.deque()     # serve thread only:
        #   spilled requests (artifact set) awaiting blocks and a slot
        self._migrate_in_q = collections.deque()  # client -> serve thread
        self._migrate_cmds = collections.deque()  # (future, reply)
        self._prefix_cmds = collections.deque()   # fleet prefix tier:
        #   ("export", key, max_bytes, reply) | ("adopt", art, None, reply)
        self._prefix_io_budget = self._PREFIX_IO_BUDGET
        self._drain_cmds = collections.deque()    # (migrate, reply): the
        #   fleet's drain verb, serviced on the serve thread
        self._killed = False    # kill() fired: terminal, never serves again
        self._tag_cache = {}    # version index -> parameter fingerprint
        self._prefix_saved = True   # nothing to save before start()
        self._gate_key = None   # the preempting gate's rescan guard
        self._work_lock = threading.Lock()
        self._work_tokens = 0   # work-unit backlog (queued + live)
        # admission hysteresis: an actual eviction/expiry tightens
        # prediction shedding to exactly the budget for this long
        self._thrash_until = 0.0

        self._graphs = {}       # version -> _CapturedWindow (the card)
        self._spec = None
        self._reset_device_state()
        # ONE decode program for the life of the server; parameters are
        # arguments, so a hot swap reuses it
        if self._paged:
            self._step = _T.make_paged_decode_fn(n_heads, self._block_size)
        else:
            self._step = _T.make_slot_decode_fn(n_heads)
        if self._chunk is None:
            self._chunk_step = None
        else:
            self._chunk_step = _T.make_chunked_prefill_fn(
                n_heads, self._chunk,
                self._block_size if self._paged else None)
        # rolling window of recent SLO outcomes (1 met / 0 missed): the
        # brownout policy's attainment signal
        self._slo_recent = collections.deque(maxlen=64)
        # speculation: one K-wide verify program replaces the 1-token step
        # (fixed layout: the model's own, shared with generate(draft=))
        self._spec = as_speculator(speculate)
        if self._spec is None:
            self._verify = None
        elif self._paged:
            self._verify = _T.make_paged_verify_fn(
                n_heads, self._spec.k, self._block_size)
        else:
            self._verify = lm._spec_verify(self._spec.k)
        self._fused = 1 if fused_serve is None else int(fused_serve)
        if self._fused < 1:
            raise ValueError(f"fused_serve must be >= 1, got "
                             f"{fused_serve}")
        if self._fused > 1 and self._spec is not None:
            raise ValueError(
                "fused_serve > 1 does not compose with speculate= "
                "(a fused window cannot take fresh drafts mid-scan); "
                "configure one or the other")
        if self._fused > 1:
            self._window_step = (
                _T.make_paged_fused_decode_fn(n_heads, self._block_size,
                                              self._fused)
                if self._paged else
                _T.make_fused_decode_fn(n_heads, self._fused))
        else:
            self._window_step = None
        # per-iteration wall-time EWMA: the fused deadline clamp's rate
        self._iter_ewma = None
        self._prefills = {}                      # bucket -> program
        if self._paged:
            self._make_prefill = lambda: _T.make_paged_prefill_fn(n_heads)
            self._paged_install = _T.make_paged_install_fn(
                self._block_size)
            self._cow_copy = _T.make_block_copy_fn(self._block_size)
            # durable KV: one pure gather of a table's rows, shared by
            # preemption, migration and the prefix-cache save/export
            self._extract = _T.make_block_extract_fn(self._block_size)
        else:
            self._make_prefill = lambda: _T.make_prefill_fn(
                n_heads, self.max_len)

        self._swap_lock = threading.Lock()
        self._init_loop(max_queue)
        if self._named_instance:
            self._req_ids = (f"{self.instance}-{n}"
                             for n in itertools.count())
        if self._prefix_dir is not None and \
                artifact_kind(self._prefix_dir) == "prefix_cache":
            # warm start; a version mismatch raises KVStateVersionError
            # out of the constructor, an absent snapshot is a cold start
            self.restore_prefix_cache(self._prefix_dir)

    # -- client API ----------------------------------------------------
    def submit(self, prompt, max_new_tokens, deadline_ms=None,
               klass="default"):
        """Enqueue one decode request; the Future resolves to the full
        token list (prompt + `max_new_tokens` greedy continuations).
        `deadline_ms` falls back to the server's `default_deadline_ms`;
        `klass` is the brownout request class (ignored without a
        `brownout=` policy)."""
        if not self._running:
            raise ServerClosedError("server is not running")
        prompt = [int(t) for t in np.asarray(prompt).ravel()]
        if not prompt:
            raise ValueError("prompt must contain at least one token")
        if int(max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) > self.prompt_buckets[-1]:
            raise ValueError(f"prompt length {len(prompt)} exceeds the "
                             f"largest bucket {self.prompt_buckets[-1]}")
        if len(prompt) + int(max_new_tokens) > self.max_len:
            raise ValueError(
                f"prompt+new tokens ({len(prompt)}+{max_new_tokens}) "
                f"exceed max_len {self.max_len}")
        if self._paged:
            # a request whose worst-case block table exceeds the pool or
            # a slot's table would wait forever: shed it at submit
            need = self._pool.blocks_needed(
                len(prompt) + int(max_new_tokens) - 1)
            if need > self._n_blocks:
                self.metrics.count("shed_blocks")
                raise ServerOverloadedError(
                    f"request needs {need} KV blocks but the pool holds "
                    f"{self._n_blocks} (block_size="
                    f"{self._block_size})")
            if need > self._nb_slot:
                self.metrics.count("shed_blocks")
                raise ServerOverloadedError(
                    f"request needs {need} KV blocks but a slot's table "
                    f"holds {self._nb_slot} (max_blocks_per_slot)")
        if self._injector is not None:
            self._injector.fire("serve.request")
        self.metrics.count("received")
        now = time.monotonic()
        if deadline_ms is not None:
            dl = now + deadline_ms / 1e3
        else:
            dl = (now + self.default_deadline
                  if self.default_deadline is not None else None)
        deferred = False
        if self._brownout is not None:
            # maxsize <= 0 is queue.Queue's unbounded convention: depth
            # pressure is undefined there. The priority line counts.
            frac = ((self._q.qsize() + len(self._prio_q))
                    / self._q.maxsize if self._q.maxsize > 0 else 0.0)
            decision = self._brownout.decide(
                klass, frac, self._recent_attainment())
            if decision == SHED:
                self.metrics.count("shed_brownout")
                self.metrics.record_queue_depth(self._pending_depth())
                raise ServerOverloadedError(
                    f"brownout: class {klass!r} shed at queue depth "
                    f"{frac:.0%}")
            deferred = decision == DEFER
        prio = False
        if self._prefix_priority and not deferred \
                and len(prompt) > self._chunk:
            # a FULL-prefix hit leaves at most one chunk of prefill: the
            # fast line. Advisory (the binding match re-runs at
            # admission); a dict resized by the serve thread mid-walk
            # degrades to FIFO
            with self._swap_lock:
                vidx = len(self._versions) - 1
            try:
                rows = self._pool.match_prefix(prompt, tag=vidx)[1]
            except RuntimeError:    # dict resized during the walk
                rows = 0
            start = min(rows, len(prompt) - 1)
            prio = len(prompt) - start <= self._chunk
        if self._admission is not None and dl is not None \
                and not deferred:
            # predicted completion at ENQUEUE: work ahead plus this
            # request's own units over the measured rate
            backlog = self._work_tokens
            own = int(max_new_tokens) + (1 if prio else
                                         self._pf_units(len(prompt)))
            if self._admission.should_shed(
                    backlog, own, dl - now,
                    strict=now < self._thrash_until):
                self.metrics.count("shed_predicted")
                pred = self._admission.predict_seconds(backlog, own)
                raise ServerOverloadedError(
                    f"predicted completion in {pred * 1e3:.0f}ms behind "
                    f"{backlog} backlog work units cannot make the "
                    f"{(dl - now) * 1e3:.0f}ms deadline budget")
        req = _DecodeRequest(prompt, max_new_tokens, dl, klass=klass)
        # work is counted in iteration-equivalent units: generated tokens
        # plus the prefill dispatches (chunks) the prompt will consume
        req.pf_quoted = 1 if prio else self._pf_units(len(prompt))
        req.work_left += req.pf_quoted
        if self._admission is not None and not deferred:
            pred = self._admission.predict_seconds(
                self._work_tokens, req.work_left)
            if pred is not None:
                req.predicted_done = now + pred
        # deferred requests join the backlog when they leave their line
        if not deferred:
            with self._work_lock:
                self._work_tokens += req.work_left
                req.work_counted = True
        req.future.add_done_callback(
            lambda _f, r=req: self._retire_work(r))
        try:
            if deferred:
                return self._enqueue_deferred(req)
            if prio:
                return self._enqueue_priority(req)
            return self._enqueue(req)
        except BaseException:
            self._retire_work(req)
            raise

    def _deadline_miss(self, req, now, thrash=True):
        """The one deadline-expiry bookkeeping path for every shed site."""
        self.metrics.count("shed_deadline")
        self.metrics.record_slo_miss()
        self._slo_recent.append(0)
        self._admission_outcome(req, now, completed=False)
        if thrash:
            self._thrash_until = now + 0.5

    def _admission_outcome(self, req, now, completed):
        """Close one prediction's feedback loop: the signed (predicted -
        actual) error at completion; at an eviction a negative (predicted
        - now) is a certain bound and is recorded too."""
        if req.predicted_done is None:
            return
        err = req.predicted_done - now
        req.predicted_done = None
        if not completed and err >= 0:
            return
        self.metrics.record_admission_error(err * 1e3)
        if self._admission is not None:
            self._admission.observe_error(err)

    def _pf_units(self, plen):
        """Prefill cost of a prompt in work units: its chunk count when it
        takes the chunked path, one one-shot dispatch otherwise."""
        if self._chunk is not None and int(plen) > self._chunk:
            return -(-int(plen) // self._chunk)
        return 1

    def _retire_work(self, req):
        """Remove a request's unproduced work from the backlog (once)."""
        with self._work_lock:
            if req.work_counted:
                self._work_tokens -= req.work_left
            req.work_left = 0

    def _spend_work(self, req, units=1):
        """Retire `units` of a request's backlog as they are served."""
        with self._work_lock:
            n = min(units, req.work_left)
            req.work_left -= n
            self._work_tokens -= n

    def _recent_attainment(self):
        win = list(self._slo_recent)
        return (sum(win) / len(win)) if win else None

    def _enqueue_deferred(self, req):
        """Park a brownout-DEFERRED request in the side line served only
        when the primary queue is empty (bounded like the queue)."""
        if req.req_id is None:
            req.req_id = next(self._req_ids)
        if 0 < self._q.maxsize <= len(self._defer_q):
            self.metrics.count("shed_queue_full")
            self.metrics.record_queue_depth(self._q.maxsize)
            raise ServerOverloadedError(
                f"deferred line full ({self._q.maxsize} parked)")
        self.metrics.count("deferred")
        self._defer_q.append(req)
        tr = self._tracer
        if tr.enabled:
            tr.instant("serve.enqueue", cat="serve",
                       track=f"req-{req.req_id}", trace_id=req.req_id)
        if not self._running:
            _fail_future(req.future, ServerClosedError(
                "server stopped during submit"))
            raise ServerClosedError("server stopped during submit")
        return req.future

    def _pending_depth(self):
        """Enqueue-time depth: the queue and every parked line (priority,
        resume, migrate-in staging)."""
        return (self._q.qsize() + len(self._prio_q)
                + len(self._resume_q) + len(self._migrate_in_q))

    def _shed_if_lines_full(self):
        """The primary queue and every parked line share `max_queue` (the
        check behind submit, the priority line and migrate_in)."""
        if 0 < self._q.maxsize <= self._pending_depth():
            self.metrics.count("shed_queue_full")
            self.metrics.record_queue_depth(self._pending_depth())
            raise ServerOverloadedError(
                f"queue full ({self._q.maxsize} pending incl. parked "
                f"lines)")

    def _enqueue(self, req):
        self._shed_if_lines_full()
        return super()._enqueue(req)

    def _enqueue_priority(self, req):
        """Park a prefix-hit request in the PRIORITY line, served ahead of
        the primary queue; wake an idle-blocked loop."""
        if req.req_id is None:
            req.req_id = next(self._req_ids)
        self._shed_if_lines_full()
        self._prio_q.append(req)
        if not any(r is not None for r in self._slot_req):
            self._wake_loop()
        self.metrics.record_queue_depth(self._pending_depth())
        tr = self._tracer
        if tr.enabled:
            tr.instant("serve.enqueue", cat="serve",
                       track=f"req-{req.req_id}", trace_id=req.req_id)
        if not self._running:
            _fail_future(req.future, ServerClosedError(
                "server stopped during submit"))
            raise ServerClosedError("server stopped during submit")
        return req.future

    def generate(self, prompt, max_new_tokens, deadline_ms=None,
                 timeout=None):
        """Blocking convenience wrapper over submit()."""
        return self.submit(prompt, max_new_tokens,
                           deadline_ms=deadline_ms).result(timeout)

    # -- hot swap ------------------------------------------------------
    def swap(self, new_lm):
        """Route NEW requests to `new_lm`'s parameters while slots already
        decoding drain on the version they started with. The parameter
        names, shapes, dtypes and devices must match the serving model's
        (a mismatch raises)."""
        with self._swap_lock:
            if self._injector is not None:
                self._injector.fire("serve.swap")
            new = (new_lm.aux, list(new_lm.blocks))
            old_l = _param_leaves(*self._versions[-1])
            new_l = _param_leaves(*new)
            if [n for n, _ in old_l] != [n for n, _ in new_l]:
                raise ValueError("swap rejected: parameter names differ "
                                 "from the serving model's")
            for (name, o), (_, n) in zip(old_l, new_l):
                if (o.shape, o.dtype, o.device) != (n.shape, n.dtype,
                                                    n.device):
                    raise ValueError(
                        f"swap rejected: {name} is {tuple(n.shape)}/"
                        f"{n.dtype}/{n.device}, serving "
                        f"{tuple(o.shape)}/{o.dtype}/{o.device}")
            self._versions.append(new)
            self.metrics.count("swaps")

    def current_params(self):
        """(aux, blocks) of the NEWEST parameter version."""
        with self._swap_lock:
            return self._versions[-1]

    @property
    def paged(self):
        """Whether this server runs the block-table KV cache."""
        return self._paged

    @property
    def alive(self):
        """True while the serve loop runs on a live thread: the fleet
        router's liveness probe. A killed or crashed loop reads False
        before anyone calls stop()."""
        t = self._thread
        return bool(self._running and not self._killed
                    and t is not None and t.is_alive())

    # -- fleet verbs (serving/fleet.py) ----------------------------------
    def kill(self):
        """Abrupt replica death, the verb the fleet's `fleet.replica`
        sever lands on. The serve loop exits at the next iteration
        boundary and every in-flight, parked and queued future fails with
        `ReplicaDeadError`; nothing drains and nothing persists. Terminal
        and idempotent (a killed server refuses start()); callable from
        any thread, including a done callback on the serve thread."""
        self._killed = True
        self._running = False
        self._drain_on_stop = False
        self._wake_loop()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(10.0)
        if t is None or not t.is_alive() \
                or t is threading.current_thread():
            # the loop is gone (or is this thread): fail the stragglers
            # here (resolved futures are skipped)
            self._die_now()

    def _die_now(self):
        """Fail every request this server still holds with the crash
        error: on the serve thread when the loop notices `_killed`, or on
        the killer's thread once the loop is gone."""
        exc = ReplicaDeadError(f"replica {self.instance!r} crashed")
        n_failed = 0
        for s, r in enumerate(self._slot_req):
            if r is not None and _fail_future(r.future, exc):
                n_failed += 1
            self._slot_req[s] = None
        if n_failed:
            self.metrics.count("failed", n_failed)
        self._fail_parked(exc)
        super()._fail_queued(exc)

    def drain(self, migrate=None, timeout=60.0):
        """Hand off every admitted request in one verb, then stop.

        Returns ``(migrated, replayed)``: ``migrated`` lists
        ``(local_future, RequestArtifact)`` for decode-phase requests
        (live slots and the parked resume line), each local future failed
        with `RequestMigratedError`; ``replayed`` lists ``(local_future,
        spec)`` for queued, deferred, parked, memory-blocked and
        prefilling requests (a half-written prefill panel is never an
        artifact), each failed with `RequestDrainedError`, ``spec`` being
        ``{"prompt", "max_new", "deadline" (absolute monotonic or None),
        "klass"}``. `migrate` defaults to the layout (paged servers
        migrate); migrate=True on a fixed-slot server raises ValueError.
        The hand-off runs on the serve thread between iterations; on
        return the loop is stopped and the server holds no request."""
        migrate = self._paged if migrate is None else bool(migrate)
        if migrate and not self._paged:
            raise ValueError("drain(migrate=True) requires paged=True "
                             "(only a block-table KV set can leave the "
                             "arena); fixed-slot servers drain with "
                             "migrate=False, and everything replays")
        if not self._running:
            raise ServerClosedError("server is not running")
        reply = cf.Future()
        self._drain_cmds.append((migrate, reply))
        self._wake_loop()
        migrated, replayed = reply.result(timeout)
        self.stop(drain=False, timeout=timeout)
        return migrated, replayed

    def _service_drain(self):
        """Serve-thread half of `drain()`."""
        while self._drain_cmds:
            migrate, reply = self._drain_cmds.popleft()
            try:
                out = self._drain_now(migrate)
            except BaseException as e:  # noqa: BLE001 - the reply carries it
                if not reply.done():
                    reply.set_exception(e)
            else:
                if not reply.done():
                    reply.set_result(out)

    def _drain_now(self, migrate):
        migrated, replayed = [], []

        def spec_of(r):
            return {"prompt": list(r.prompt), "max_new": r.max_new,
                    "deadline": r.deadline, "klass": r.klass}

        def hand_off(r, art):
            """Decode-phase state with rows in hand migrates (when asked);
            everything else replays."""
            if migrate and art is not None:
                if _fail_future(r.future, RequestMigratedError(
                        "request drained to another replica")):
                    migrated.append((r.future, art))
                    self.metrics.count("migrated_out")
                    self._mark_migrate_out(r)
            elif _fail_future(r.future, RequestDrainedError(
                    "request replayed on another replica (queued/"
                    "prefill-phase state is never migrated)")):
                replayed.append((r.future, spec_of(r)))

        # live slots: a decode-phase slot's rows are extractable, a
        # prefilling slot's panel is half-written and never an artifact
        for s, r in enumerate(self._slot_req):
            if r is None:
                continue
            if r.future.done():
                self._free_slot(s)
                continue
            art = None
            if migrate and r.pf_next is None and r.generated:
                art = self._extract_artifact(s)
            hand_off(r, art)
            self._free_slot(s)
        # parked artifacts (resume line, migrate-in staging) are their own
        # baton
        while self._migrate_in_q:
            self._resume_q.append(self._migrate_in_q.popleft())
        while self._resume_q:
            r = self._resume_q.popleft()
            if r.future.done():
                continue
            art, r.artifact = r.artifact, None
            hand_off(r, art)
        # queued lines hold no KV state: replay specs
        for dq in (self._mem_wait, self._prio_q, self._defer_q):
            while dq:
                try:
                    r = dq.popleft()
                except IndexError:
                    break
                if not r.future.done():
                    hand_off(r, None)
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if not r.future.done():     # skips _Wake sentinels too
                hand_off(r, None)
        self._gc_versions()
        return migrated, replayed

    # -- durable KV state ------------------------------------------------
    def start(self):
        if self._killed:
            raise ServerClosedError(
                "replica was killed; build a new server instead of "
                "restarting a crashed one")
        # a (re)started server has live state the next clean stop persists
        self._prefix_saved = self._prefix_dir is None
        return super().start()

    def stop(self, drain=True, timeout=None):
        """Stop the loop, then, with `prefix_cache_dir=` and the loop
        really exited, save the prefix cache on the caller's thread. A
        join timeout skips the save; a retried stop() performs it. A
        failed save is logged, not raised."""
        super().stop(drain=drain, timeout=timeout)
        t = self._thread
        if (self._prefix_dir is not None and not self._prefix_saved
                and not self._running
                and (t is None or not t.is_alive())):
            self._prefix_saved = True
            try:
                self.save_prefix_cache(self._prefix_dir)
            except Exception:   # noqa: BLE001 - teardown must finish
                log.exception("prefix-cache save failed at stop()")

    def _version_tag(self, vidx):
        """The parameter fingerprint of version `vidx`, computed once."""
        tag = self._tag_cache.get(vidx)
        if tag is None:
            with self._swap_lock:
                ver = self._versions[vidx]
            if ver is None:
                raise KVStateError(f"param version {vidx} already "
                                   f"drained; nothing to fingerprint")
            tag = self._tag_cache[vidx] = _param_fingerprint(*ver)
        return tag

    def _gather_blocks(self, ids):
        """Host panels of physical blocks `ids`, in order: one extract and
        one copy per `max_blocks_per_slot` blocks."""
        bs = self._block_size
        out = []
        for at in range(0, len(ids), self._nb_slot):
            group = ids[at:at + self._nb_slot]
            tab = np.zeros((self._nb_slot,), np.int64)
            tab[:len(group)] = group
            host = _host_panels(self._extract(self._cache, self._dev(tab)),
                                len(group) * bs)
            out.extend(_block_panels(host, i, bs)
                       for i in range(len(group)))
        return out

    def _extract_artifact(self, slot):
        """`slot`'s KV state as a host RequestArtifact (serve thread,
        decode phase): one gather of its table's rows, then the rows
        below the frontier to the host in one copy. Rows at or past the
        frontier (rejected speculative suffixes, padding) are never
        serialized."""
        r = self._slot_req[slot]
        pos = len(r.prompt) + len(r.generated) - 1
        tab = np.zeros((self._nb_slot,), np.int64)
        tab[:len(r.alloc.ids)] = r.alloc.ids
        with self._tracer.span("decode.extract", cat="serve",
                               track="server", trace_id=r.req_id,
                               slot=slot, rows=pos):
            panels = _host_panels(
                self._extract(self._cache, self._dev(tab)), pos)
        art = RequestArtifact(r.prompt, r.generated, r.max_new,
                              self._version_tag(r.version),
                              self._block_size, panels, klass=r.klass,
                              trace={"trace_id": r.req_id,
                                     "parent_span": f"req-{r.req_id}",
                                     "origin": self.instance})
        self.metrics.count("spill_bytes", art.nbytes)
        return art

    def _preempt_slot(self, slot):
        """Pause `slot`'s request: spill it to the host, release its
        blocks, park it on the resume line. Its future stays pending, its
        remaining tokens stay in the backlog, plus one re-install unit."""
        r = self._slot_req[slot]
        r.artifact = self._extract_artifact(slot)
        self._free_slot(slot)           # blocks back to the pool
        r.slot = None                   # r.version kept: the resume runs
        #                                 under the rows' own parameters
        with self._work_lock:
            if r.work_counted:
                r.work_left += 1
                self._work_tokens += 1
        self._resume_q.append(r)
        self.metrics.count("preempted")
        tr = self._tracer
        if tr.enabled:
            tr.instant("decode.preempt", cat="serve",
                       track=f"req-{r.req_id}", trace_id=r.req_id)

    def _gate_signature(self):
        """What the preempting gate's outcome depends on: pool occupancy,
        decode progress and pending depth (the same signature, the same
        outcome: the gate skips the rescan)."""
        return (self._pool.blocks_free, self._pool.blocks_in_use,
                self.metrics.count_value("tokens_out"),
                self._pending_depth())

    def _try_preempt_for(self, req):
        """Free blocks for the memory-blocked `req` by preempting one
        decode-phase slot whose class the policy ranks below its
        (`may_preempt`) and which has decoded `_PREEMPT_MIN_PROGRESS`
        tokens since its last (re)start: the most yielding class first,
        then the slot holding most blocks. False when there is none."""
        if not self._preempt_on or self._brownout is None:
            return False
        cands = []
        for s, r in enumerate(self._slot_req):
            if r is None or r.pf_next is not None or r.alloc is None:
                continue
            if len(r.generated) - r.progress_base \
                    < self._PREEMPT_MIN_PROGRESS:
                continue
            if not self._brownout.may_preempt(r.klass, req.klass):
                continue
            rank = self._brownout.classes.get(
                str(r.klass), self._brownout.default)[0]
            cands.append((rank, -len(r.alloc.ids), s))
        if not cands:
            return False
        self._preempt_slot(min(cands)[2])
        return True

    def _check_panel_fit(self, k0, n_layers, what):
        """The structural fit of host panels against this server's cache
        (the version tag is checked separately)."""
        hd = self._d_model // self._n_heads
        if (n_layers != self._n_layers
                or tuple(k0.shape[1:]) != (self._n_heads, hd)
                or _dtype_name(k0.dtype) != _dtype_name(self._cache_dtype)):
            raise KVStateError(
                f"{what} panel [{k0.shape[0]}, {k0.shape[1]}, "
                f"{k0.shape[2]}] x {n_layers} layers "
                f"({_dtype_name(k0.dtype)}) does not fit this server's "
                f"cache ([rows, {self._n_heads}, {hd}] x {self._n_layers}, "
                f"{_dtype_name(self._cache_dtype)})")

    def _check_artifact(self, art):
        """Structural fit of a RequestArtifact against this server."""
        if art.block_size != self._block_size:
            raise KVStateError(
                f"artifact block_size {art.block_size} != server "
                f"block_size {self._block_size}")
        self._check_panel_fit(art.panels[0][0], len(art.panels), "artifact")
        if len(art.prompt) + art.max_new > self.max_len:
            raise KVStateError(
                f"artifact needs {len(art.prompt)} + {art.max_new} "
                f"rows; server max_len is {self.max_len}")

    def _check_artifact_panels(self, art):
        """The prefix-cache twin of `_check_artifact`."""
        if art.block_size != self._block_size:
            raise KVStateError(
                f"prefix-cache snapshot block_size {art.block_size} != "
                f"server block_size {self._block_size}")
        panels = art.entries[0][1]
        self._check_panel_fit(panels[0][0], len(panels), "prefix-cache")

    def _wake_loop(self):
        """Nudge an idle-blocked serve loop."""
        try:
            self._q.put_nowait(_Wake())
        except queue.Full:
            pass

    def migrate_out(self, future, timeout=30.0):
        """Export the live decode-phase request of `future` as a
        RequestArtifact and drop it here: the serve thread extracts it
        between iterations, releases its blocks and fails `future` with
        RequestMigratedError. The importing server's `migrate_in` future
        carries the stream on."""
        if not self._paged:
            raise ValueError("migrate_out requires paged=True")
        if not self._running:
            raise ServerClosedError("server is not running")
        reply = cf.Future()
        self._migrate_cmds.append((future, reply))
        self._wake_loop()
        return reply.result(timeout)

    def _service_migrations(self):
        while self._migrate_cmds:
            fut, reply = self._migrate_cmds.popleft()
            try:
                art = self._migrate_out_now(fut)
            except BaseException as e:  # noqa: BLE001 - reply carries it
                reply.set_exception(e)
            else:
                reply.set_result(art)

    def _service_prefix_ops(self):
        """The serve thread's half of prefix_export / prefix_adopt, at
        most `_PREFIX_IO_BUDGET` artifact bytes an iteration (at least one
        command)."""
        spent = 0
        while self._prefix_cmds and (
                spent == 0 or spent < self._prefix_io_budget):
            verb, arg, max_bytes, reply = self._prefix_cmds.popleft()
            try:
                if verb == "export":
                    out = self._prefix_export_now(arg, max_bytes)
                    spent += out.nbytes if out is not None else 0
                else:
                    spent += arg.nbytes
                    out = self._prefix_adopt_now(arg)
            except BaseException as e:  # noqa: BLE001 - reply carries it
                if not reply.done():
                    reply.set_exception(e)
            else:
                if not reply.done():
                    reply.set_result(out)

    def _mark_migrate_out(self, r):
        tr = self._tracer
        if tr.enabled:
            tr.instant("serve.migrate_out", cat="serve",
                       track=f"req-{r.req_id}", trace_id=r.req_id,
                       origin=self.instance)

    def _migrate_out_now(self, fut):
        for s, r in enumerate(self._slot_req):
            if r is None or r.future is not fut:
                continue
            if r.pf_next is not None:
                raise KVStateError(
                    "request is still in chunked prefill; only "
                    "decode-phase requests are migratable")
            art = self._extract_artifact(s)
            _fail_future(r.future, RequestMigratedError(
                "request exported to another server"))
            self._free_slot(s)
            self._gc_versions()
            self.metrics.count("migrated_out")
            self._mark_migrate_out(r)
            return art
        for r in list(self._resume_q):
            if r.future is fut and r.artifact is not None:
                self._resume_q.remove(r)
                art = r.artifact
                r.artifact = None
                _fail_future(r.future, RequestMigratedError(
                    "request exported to another server"))
                self.metrics.count("migrated_out")
                self._mark_migrate_out(r)
                return art
        raise KVStateError(
            "request not found in a decode slot (completed, failed, "
            "still queued, or never admitted here)")

    def migrate_in(self, artifact, deadline_ms=None):
        """Adopt another server's RequestArtifact; the Future resolves to
        the full token list (prompt and every generated token). The tag
        must be this server's newest version's (KVStateVersionError),
        checked here and again at admission; the request parks on the
        resume line until blocks and a slot free up."""
        if not self._paged:
            raise ValueError("migrate_in requires paged=True")
        if not self._running:
            raise ServerClosedError("server is not running")
        art = artifact
        with self._swap_lock:
            vidx = len(self._versions) - 1
        art.require_tag(self._version_tag(vidx), what="migrated request")
        self._check_artifact(art)
        need = self._pool.blocks_needed(len(art.prompt) + art.max_new - 1)
        if need > self._n_blocks or need > self._nb_slot:
            self.metrics.count("shed_blocks")
            raise ServerOverloadedError(
                f"migrated request needs {need} KV blocks but the "
                f"server holds {min(self._n_blocks, self._nb_slot)} "
                f"(pool / per-slot table)")
        self._shed_if_lines_full()
        self.metrics.count("received")
        now = time.monotonic()
        if deadline_ms is not None:
            dl = now + deadline_ms / 1e3
        else:
            dl = (now + self.default_deadline
                  if self.default_deadline is not None else None)
        req = _DecodeRequest(list(art.prompt), art.max_new, dl,
                             klass=art.klass)
        req.generated = list(art.generated)
        ctx = art.trace or {}
        # a named origin's string id continues its trace lane here; an
        # unnamed origin's integer id could collide with ours
        req.req_id = (ctx["trace_id"] if isinstance(ctx.get("trace_id"),
                                                      str)
                      else next(self._req_ids))
        req.migrated = True
        if art.remaining <= 0:
            req.future.set_result(list(art.prompt) + req.generated)
            return req.future
        req.artifact = art
        req.work_left = art.remaining + 1   # tokens + the re-install unit
        with self._work_lock:
            self._work_tokens += req.work_left
            req.work_counted = True
        req.future.add_done_callback(
            lambda _f, r=req: self._retire_work(r))
        self._migrate_in_q.append(req)
        self._wake_loop()
        tr = self._tracer
        if tr.enabled:
            kw = {"trace_id": req.req_id}
            if ctx.get("origin") is not None:
                kw["migrated_from"] = ctx["origin"]
            tr.instant("serve.migrate_in", cat="serve",
                       track=f"req-{req.req_id}", **kw)
            tr.instant("serve.enqueue", cat="serve",
                       track=f"req-{req.req_id}", trace_id=req.req_id)
        if not self._running:
            _fail_future(req.future, ServerClosedError(
                "server stopped during migrate_in"))
            raise ServerClosedError("server stopped during migrate_in")
        return req.future

    def _install_panel(self, ids, panels, length, shared_len):
        """Install host panel rows [shared_len, length) through block
        table `ids` with the prefill's install program: one host-to-device
        copy of every layer's rows."""
        tab = np.zeros((self._nb_slot,), np.int64)
        tab[:len(ids)] = ids
        flat = [a for kv in panels for a in kv]
        host = (torch.stack(flat) if isinstance(flat[0], torch.Tensor)
                else torch.from_numpy(np.stack(flat)))
        dev = host.to(self.device)[:, None]                 # [2L, 1, R]
        self._paged_install(self._cache,
                            [(dev[i], dev[i + 1])
                             for i in range(0, len(flat), 2)],
                            self._dev(tab), int(length), int(shared_len))

    def _count_restore_hits(self, alloc):
        """Shared prefix blocks of this admission that a restored
        snapshot brought back (`prefix_restore_hits`)."""
        if not self._pool.restored:
            return
        hits = sum(1 for b in alloc.ids[:alloc.n_shared]
                   if b in self._pool.restored)
        if hits:
            self.metrics.count("prefix_restore_hits", hits)

    def _admit_restored(self, req, slot, alloc, vidx):
        """Install a spilled or migrated request into `slot` from its
        artifact: table, position and one install of the rows the prefix
        match did not make resident. A partial shared tail block takes its
        reserved CoW spare first (installing into the shared block would
        overwrite the cached owner's rows); the artifact carries every row
        of that block, so no device copy is needed."""
        art = req.artifact
        pos = art.pos
        if alloc.cow is not None:
            self._pool.cow(alloc)
        resident = alloc.n_shared * self._block_size
        self._btabs[slot, :] = 0
        self._btabs[slot, :len(alloc.ids)] = alloc.ids
        req.alloc = alloc
        with self._tracer.span("decode.restore", cat="serve",
                               track="server", trace_id=req.req_id,
                               slot=slot, rows=pos, shared=resident):
            self._install_panel(alloc.ids, art.panels, pos, resident)
        # the rows are filled only now: only now may they be matched
        self._pool.commit(alloc)
        self._count_restore_hits(alloc)
        self._spend_work(req)           # the install unit
        self._pos[slot] = pos
        self._tok[slot] = req.generated[-1]
        req.pf_next = None
        req.slot = slot
        req.version = vidx
        req.artifact = None
        req.progress_base = len(req.generated)
        req.t_last_tok = time.monotonic()
        self._slot_req[slot] = req
        if self._spec is not None:
            self._spec.draft.start(slot, list(req.prompt) + req.generated)
        self.metrics.count("migrated" if req.migrated else "resumed")

    def _admit_resume(self, slot):
        """Serve the resume line into `slot`, ahead of every queue. A head
        that cannot get its blocks leaves admission open for queue work
        and retries next iteration. True when the slot was filled."""
        while self._resume_q:
            req = self._resume_q[0]
            if req.future.done():
                self._resume_q.popleft()
                continue
            now = time.monotonic()
            if req.deadline is not None and now > req.deadline:
                self._resume_q.popleft()
                if _fail_future(req.future, DeadlineExceededError(
                        "deadline expired on the resume line")):
                    self._deadline_miss(req, now)
                continue
            art = req.artifact
            if req.version is not None:
                vidx = req.version      # preempted here: its own version
            else:
                with self._swap_lock:   # migrated in: the newest
                    vidx = len(self._versions) - 1
                try:
                    art.require_tag(self._version_tag(vidx),
                                    what="migrated request")
                except KVStateVersionError as e:
                    self._resume_q.popleft()
                    if _fail_future(req.future, e):
                        self.metrics.count("failed")
                    continue
            alloc = self._pool.admit(
                req.prompt, len(req.prompt) + req.max_new - 1,
                will_append=True, tag=vidx)
            if alloc is None:
                if not req.mem_blocked:
                    req.mem_blocked = True
                    self.metrics.count("blocked_on_memory")
                return False
            self._resume_q.popleft()
            try:
                self._admit_restored(req, slot, alloc, vidx)
            except BaseException as e:  # noqa: BLE001 - fail THIS request
                self._pool.release(alloc)
                _fail_future(req.future, e)
                self.metrics.count("failed")
                continue
            return True
        return False

    def _prefix_path(self, path):
        """The snapshot path of a save or restore, on a stopped server."""
        if not (self._paged and self._prefix_cache):
            raise ValueError("no paged prefix cache to save or restore")
        if self._running or (self._thread is not None
                             and self._thread.is_alive()):
            raise KVStateError("the prefix cache is saved and restored on "
                               "a stopped server (the serve thread owns "
                               "the arena while running)")
        path = path if path is not None else self._prefix_dir
        if path is None:
            raise ValueError("no path: pass one or construct with "
                             "prefix_cache_dir=")
        return path

    def save_prefix_cache(self, path=None):
        """Save the pool's cached prefix blocks indexed under the newest
        version as a PrefixCacheArtifact (a stopped server; stop() calls
        it with `prefix_cache_dir=`). Returns the path, or None when there
        is nothing to save; then a stale snapshot at the server's own
        directory is removed (an explicitly passed foreign path never
        is)."""
        path = self._prefix_path(path)
        with self._swap_lock:
            vidx = len(self._versions) - 1
        entries = self._pool.cached_entries(tag=vidx)
        if not entries:
            own = (self._prefix_dir is not None
                   and os.path.abspath(path)
                   == os.path.abspath(self._prefix_dir))
            if own and artifact_kind(path) == "prefix_cache":
                shutil.rmtree(path, ignore_errors=True)
            return None
        tag = self._version_tag(vidx)
        panels = self._gather_blocks([bid for bid, _ in entries])
        art = PrefixCacheArtifact(
            tag, self._block_size,
            [(prefix, p) for (_, prefix), p in zip(entries, panels)])
        self.metrics.count("spill_bytes", art.nbytes)
        out = art.save(path)
        log.info("saved %d prefix-cache blocks (%d bytes) under tag %s "
                 "at %s", len(entries), art.nbytes, tag, out)
        return out

    def _adopt_entries(self, art, vidx):
        """Give each entry of a PrefixCacheArtifact a block (parent
        first; a full pool adopts a prefix of the chain) and install the
        rows, `max_blocks_per_slot` blocks an install. Returns the
        adopted (block id, panels)."""
        if art.entries:
            self._check_artifact_panels(art)
        adopted = []
        for prefix, panels in art.entries:
            bid = self._pool.adopt((vidx, prefix))
            if bid is not None:
                adopted.append((bid, panels))
        bs = self._block_size
        for at in range(0, len(adopted), self._nb_slot):
            group = adopted[at:at + self._nb_slot]
            rows = [tuple(_cat([p[li][j] for _, p in group])
                          for j in (0, 1))
                    for li in range(self._n_layers)]
            self._install_panel([bid for bid, _ in group], rows,
                                len(group) * bs, 0)
        return adopted

    def restore_prefix_cache(self, path=None):
        """Adopt a saved PrefixCacheArtifact into the pool of a stopped
        server (the constructor calls it). The tag is checked first
        (KVStateVersionError, nothing adopted). Returns the number of
        blocks restored."""
        path = self._prefix_path(path)
        art = PrefixCacheArtifact.load(path)
        with self._swap_lock:
            vidx = len(self._versions) - 1
        art.require_tag(self._version_tag(vidx),
                        what="prefix-cache snapshot")
        adopted = self._adopt_entries(art, vidx)
        if adopted:
            log.info("restored %d prefix-cache blocks under tag %s",
                     len(adopted), art.tag)
        return len(adopted)

    def prefix_export(self, key, max_bytes=None, timeout=30.0):
        """Export the resident prefix chain covering `key` (leading
        block-aligned prompt tokens) under the newest version's tag, on a
        running server (the serve thread gathers between iterations); the
        blocks stay resident. `max_bytes` truncates the chain parent
        first. None when nothing covers `key`."""
        if not (self._paged and self._prefix_cache):
            raise ValueError("prefix_export requires paged=True with "
                             "prefix_cache=True")
        if not self._running:
            raise ServerClosedError("server is not running")
        reply = cf.Future()
        self._prefix_cmds.append(("export", tuple(key), max_bytes, reply))
        self._wake_loop()
        return reply.result(timeout)

    def prefix_adopt(self, artifact, timeout=30.0):
        """Adopt a peer's exported prefix chain into the running pool;
        the tag is checked first (KVStateVersionError, counted
        `prefix_pull_refused`). Never evicts resident state. Returns the
        number of blocks adopted (`prefix_pull_hits`,
        `prefix_pull_bytes`)."""
        if not (self._paged and self._prefix_cache):
            raise ValueError("prefix_adopt requires paged=True with "
                             "prefix_cache=True")
        if not self._running:
            raise ServerClosedError("server is not running")
        reply = cf.Future()
        self._prefix_cmds.append(("adopt", artifact, None, reply))
        self._wake_loop()
        return reply.result(timeout)

    def _prefix_export_now(self, key, max_bytes):
        with self._swap_lock:
            vidx = len(self._versions) - 1
        chain = self._pool.indexed_chain(key, tag=vidx)
        if max_bytes is not None and chain:
            # a fixed payload per block: truncate before extracting
            per_block = (2 * self._n_layers * self._block_size
                         * self._d_model
                         * torch.finfo(self._cache_dtype).bits // 8)
            chain = chain[:int(max_bytes) // per_block]
        if not chain:
            return None
        panels = self._gather_blocks([bid for bid, _ in chain])
        return PrefixCacheArtifact(
            self._version_tag(vidx), self._block_size,
            [(prefix, p) for (_, prefix), p in zip(chain, panels)])

    def _prefix_adopt_now(self, art):
        with self._swap_lock:
            vidx = len(self._versions) - 1
        try:
            art.require_tag(self._version_tag(vidx),
                            what="pulled prefix blocks")
        except KVStateVersionError:
            self.metrics.count("prefix_pull_refused")
            raise
        adopted = self._adopt_entries(art, vidx)
        if adopted:
            self.metrics.count("prefix_pull_hits", len(adopted))
            self.metrics.count("prefix_pull_bytes",
                               sum(int(a.nbytes) for _, p in adopted
                                   for kv in p for a in kv))
        return len(adopted)

    # -- scheduler internals -------------------------------------------
    def _complete(self, req, t_now):
        """Resolve one finished request: future, latency and SLO metrics,
        the request span, the flight recorder."""
        if not _resolve_future(req.future,
                               list(req.prompt) + req.generated):
            return
        total_ms = (t_now - req.t_submit) * 1e3
        self.metrics.record_request(
            total_ms, tokens=len(req.generated),
            deadline_met=(None if req.deadline is None
                          else t_now <= req.deadline))
        if req.deadline is not None:
            self._slo_recent.append(1 if t_now <= req.deadline else 0)
        self._admission_outcome(req, t_now, completed=True)
        tr = self._tracer
        if tr.enabled:
            t0 = int(req.t_submit * 1e9)
            tr.emit("serve.request", t0, int(total_ms * 1e6), cat="serve",
                    track=f"req-{req.req_id}", trace_id=req.req_id,
                    args={"tokens": len(req.generated)})
        if self._flight is not None:
            self._flight.observe(total_ms)

    def _reset_device_state(self):
        """Fresh slot state: the KV cache, per-slot positions/tokens and
        host-side occupancy (at construction, and after a dispatch fails
        terminally: the cache may hold a half-written step). The captured
        windows point at the old cache and go with it."""
        self._graphs.clear()
        if self._paged:
            self._cache = _T.init_paged_kv_cache(
                self._n_layers, self._n_blocks, self._block_size,
                self._d_model, self._n_heads, self._cache_dtype,
                self.device)
            # the pool dies with the arena
            self._pool = BlockPool(self._n_blocks, self._block_size,
                                   prefix_cache=self._prefix_cache)
            self._btabs = np.zeros((self.slots, self._nb_slot), np.int64)
        else:
            self._cache = _T.init_slot_kv_cache(
                self._n_layers, self.slots, self.max_len, self._d_model,
                self._n_heads, self._cache_dtype, self.device)
            self._btabs = None
        self._pos = torch.zeros(self.slots, dtype=torch.int64,
                                device=self.device)
        # tok is HOST state uploaded per dispatch (like active/btabs)
        self._tok = np.zeros((self.slots,), np.int64)
        self._slot_req = [None] * self.slots     # host-side occupancy
        if self._spec is not None:
            for s in range(self.slots):
                self._spec.draft.stop(s)

    def _dev(self, a):
        """A host array as a tensor on the server's device."""
        return torch.from_numpy(np.asarray(a)).to(self.device)

    @property
    def prefill_programs(self):
        """bucket -> prefill program (the bounded program-set pin)."""
        return dict(self._prefills)

    def _prompt_bucket(self, n):
        for b in self.prompt_buckets:
            if b >= n:
                return b
        return self.prompt_buckets[-1]

    def _admit(self, req, slot, alloc=None, version=None):
        """Prefill `req`'s prompt and install it into `slot` (paged: through
        `alloc`'s block table, the install only after the prefill
        succeeded). `version` is the (vidx, aux, blocks) the paged caller
        bound when it tagged the pool admission."""
        tr = self._tracer
        if tr.enabled:
            t0 = int(req.t_submit * 1e9)
            tr.emit("serve.queue_wait", t0, time.monotonic_ns() - t0,
                    cat="serve", track=f"req-{req.req_id}",
                    trace_id=req.req_id)
        if version is not None:
            vidx, aux, blocks = version
        else:
            with self._swap_lock:
                vidx = len(self._versions) - 1
                aux, blocks = self._versions[vidx]
        if self._chunk is not None and len(req.prompt) > self._chunk:
            # only prompts LONGER than one chunk take the chunked path: a
            # shorter one already is a chunk-sized stall, and the one-shot
            # program runs it at [1, Pb] instead of [slots, C]
            self._admit_chunked(req, slot, alloc, vidx)
            return
        bucket = self._prompt_bucket(len(req.prompt))
        prog = self._prefills.get(bucket)
        if prog is None:
            prog = self._prefills[bucket] = self._make_prefill()
            log.info("prefill program for prompt bucket %d", bucket)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(req.prompt)] = req.prompt

        def dispatch():
            if self._injector is not None:
                self._injector.fire("serve.batch")
            return prog(aux, blocks, self._dev(padded), len(req.prompt))

        with self._tracer.span("decode.prefill", cat="serve",
                               track="server", trace_id=req.req_id,
                               bucket=bucket, slot=slot):
            if self._retry is not None:
                logits, rows = self._retry.call(
                    dispatch,
                    on_retry=lambda a, e, d: self.metrics.count("retries"))
            else:
                logits, rows = dispatch()
        if self._paged:
            # scatter the panels to their block-table rows; only now are
            # the prompt blocks filled, so only now may they be indexed
            tab = np.zeros((self._nb_slot,), np.int64)
            tab[:len(alloc.ids)] = alloc.ids
            self._paged_install(self._cache, rows, self._dev(tab),
                                len(req.prompt), alloc.shared_rows)
            self._pool.commit(alloc)
            self.metrics.count("prefix_rows_total", len(req.prompt))
            if alloc.shared_rows:
                self.metrics.count("prefix_rows_hit", alloc.shared_rows)
        first = int(logits[0].argmax())
        req.generated.append(first)
        # TTFT closes HERE: the prefill's argmax IS the first token
        req.t_first_tok = req.t_last_tok = time.monotonic()
        self.metrics.record_ttft((req.t_last_tok - req.t_submit) * 1e3)
        self._spend_work(req, 2)    # the prefill unit + the first token
        if len(req.generated) >= req.max_new:
            # one-token request: done at prefill, never occupies a slot
            self._complete(req, time.monotonic())
            if self._paged:
                self._pool.release(alloc)
            return
        if self._paged:
            req.alloc = alloc
            self._btabs[slot, :] = 0
            self._btabs[slot, :len(alloc.ids)] = alloc.ids
        else:
            for c, r in zip(self._cache, rows):
                c["k"][slot].copy_(r["k"][0])
                c["v"][slot].copy_(r["v"][0])
        self._pos[slot] = len(req.prompt)
        self._tok[slot] = first
        req.slot = slot
        req.version = vidx
        self._slot_req[slot] = req
        if self._spec is not None:
            # the draft stream is keyed by slot: the context so far
            self._spec.draft.start(slot, list(req.prompt) + req.generated)

    def _admit_chunked(self, req, slot, alloc, vidx):
        """Install `req` into `slot` in the PREFILL phase: table and
        position state only, no dispatch. Paged mode starts the chunk
        cursor past a resident shared prefix, but always re-runs at least
        the final prompt row (whose argmax is the first token), with
        writes gated below `pf_wfrom`."""
        plen = len(req.prompt)
        if self._paged:
            self._btabs[slot, :] = 0
            self._btabs[slot, :len(alloc.ids)] = alloc.ids
            req.alloc = alloc
            start = min(alloc.shared_rows, plen - 1)
            req.pf_wfrom = alloc.shared_rows
        else:
            start = 0
            req.pf_wfrom = 0
        req.pf_next = start
        # prefix hits skip leading chunks: retire their units now, against
        # the units quoted at submit
        chunks_left = -(-(plen - start) // self._chunk)
        self._spend_work(req, max(0, req.pf_quoted - chunks_left))
        self._pos[slot] = start
        self._tok[slot] = 0
        req.slot = slot
        req.version = vidx
        self._slot_req[slot] = req

    def _next_request(self, wait):
        """Head of the admission line: memory-blocked requests first, then
        the prefix-hit priority line, then the submit queue, then the
        brownout-deferred line (only when the queue is empty). The
        blocking `wait` engages only when every line is empty."""
        if self._mem_wait:
            return self._mem_wait.popleft()
        # discard wake sentinels at the queue head (this loop is the
        # queue's only consumer)
        while True:
            try:
                if not isinstance(self._q.queue[0], _Wake):
                    break
                self._q.get_nowait()
            except (IndexError, queue.Empty):
                break
        if not (self._prio_streak >= self._PRIO_BURST
                and not self._q.empty()):
            r = self._pop_prio()
            if r is not None:
                if r.prio_overtook:
                    self._prio_streak += 1
                return r
        try:
            r = self._q.get_nowait()
        except queue.Empty:
            pass
        else:
            self._prio_streak = 0
            return r
        if self._defer_q:
            try:
                r = self._defer_q.popleft()
            except IndexError:          # raced a concurrent stop
                return None
            # leaving the deferred line: its work joins the backlog now
            with self._work_lock:
                if not r.work_counted:
                    self._work_tokens += r.work_left
                    r.work_counted = True
            return r
        if wait:
            try:
                return self._q.get(timeout=wait)
            except queue.Empty:
                return None
        return None

    def _pop_prio(self):
        """Pop the priority line's head, flagging whether it overtook
        queued work (counted only if it admits)."""
        if not self._prio_q:
            return None
        try:
            r = self._prio_q.popleft()
        except IndexError:
            return None
        r.prio_overtook = not self._q.empty()
        return r

    def _admit_pending(self, timeout=0.0):
        """Fill free slots: the resume line first (paged), then the lines.
        `timeout` blocks on the FIRST get only (the idle wait). Paged mode
        adds the MEMORY gate: a request that cannot get its blocks parks
        at the head of the line (`blocked_on_memory` counted once) and
        admission stops until completions free blocks; with
        `preempt=True` it first spills victims its class outranks, and the
        gate scans on past it (a claimant behind a blocked lower-class
        head must reach its preemption), re-parking the blocked requests
        at the front in arrival order."""
        if not self._running and not self._drain_on_stop:
            # fail-fast stop: never admit queued requests into freed
            # slots; parked lines count as _busy() and fail here
            self._fail_parked(ServerClosedError("server stopped"))
            return
        free = [s for s in range(self.slots) if self._slot_req[s] is None]
        if self._static and len(free) < self.slots:
            return      # gang scheduling: wait for the whole batch
        if self._preempt_on and self._gate_key is not None \
                and self._gate_key == self._gate_signature():
            return      # nothing the last fruitless scan read has moved
        wait = float(timeout)
        blocked = []
        admitted = False
        try:
            for s in free:
                if self._paged and self._admit_resume(s):
                    admitted = True
                    continue
                req, alloc, version = None, None, None
                while req is None:
                    req = self._next_request(wait)
                    wait = 0.0
                    if req is None:
                        return
                    if req.future.done():   # failed by raced submit/stop
                        req = None
                    elif req.deadline is not None and \
                            time.monotonic() > req.deadline:
                        if _fail_future(req.future, DeadlineExceededError(
                                "deadline expired before prefill")):
                            self._deadline_miss(req, time.monotonic())
                        req = None
                    elif self._paged:
                        # reserve every row the request will write; the
                        # version is bound BEFORE the prefix match, which
                        # is tagged with it
                        with self._swap_lock:
                            vidx = len(self._versions) - 1
                            aux, blocks = self._versions[vidx]
                        version = (vidx, aux, blocks)
                        need = (req.prompt, len(req.prompt) + req.max_new - 1)
                        alloc = self._pool.admit(
                            *need, will_append=req.max_new > 1, tag=vidx)
                        while alloc is None and self._try_preempt_for(req):
                            alloc = self._pool.admit(
                                *need, will_append=req.max_new > 1,
                                tag=vidx)
                        if alloc is None:
                            if not req.mem_blocked:
                                req.mem_blocked = True
                                self.metrics.count("blocked_on_memory")
                            blocked.append(req)
                            if not self._preempt_on:
                                return      # FIFO gate: stop admission
                            req = None      # preempting gate: scan on
                try:
                    self._admit(req, s, alloc, version=version)
                except BaseException as e:  # noqa: BLE001 - fail THIS
                    if alloc is not None:   # request
                        self._pool.release(alloc)
                    _fail_future(req.future, e)
                    self.metrics.count("failed")
                else:
                    admitted = True
                    if alloc is not None:
                        self._count_restore_hits(alloc)
                    if req.prio_overtook:
                        req.prio_overtook = False
                        self.metrics.count("admitted_prefix_priority")
        finally:
            if blocked:
                self._mem_wait.extendleft(reversed(blocked))
            if self._preempt_on:
                # arm the rescan guard only after a fully blocked scan
                self._gate_key = (self._gate_signature()
                                  if blocked and not admitted else None)

    def _free_slot(self, slot):
        """Release `slot`'s host-side occupancy (paged: its blocks back to
        the pool). Device rows and pos stay stale: the next admission
        resets pos, and a freed slot's writes go to the spare row."""
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        if self._paged and req is not None and req.alloc is not None:
            self._pool.release(req.alloc)
            req.alloc = None
            self._btabs[slot, :] = 0
        if self._spec is not None:
            self._spec.draft.stop(slot)

    def _sweep_line(self, dq, msg, now, thrash=True):
        """The deadline sweep for every parked FIFO line: fail expired
        requests, keep the rest at the front in order."""
        keep = []
        for _ in range(len(dq)):
            try:
                r = dq.popleft()
            except IndexError:
                break
            if r.future.done():
                continue
            if r.deadline is not None and now > r.deadline:
                if _fail_future(r.future, DeadlineExceededError(msg)):
                    self._deadline_miss(r, now, thrash=thrash)
            else:
                keep.append(r)
        dq.extendleft(reversed(keep))

    def _evict_expired(self):
        """Mid-decode deadline enforcement: a slot whose deadline passed is
        evicted BETWEEN iterations and freed this iteration."""
        now = time.monotonic()
        self._sweep_line(self._mem_wait,
                         "deadline expired while blocked on KV blocks",
                         now)
        self._sweep_line(self._prio_q,
                         "deadline expired in the priority line", now)
        self._sweep_line(self._defer_q,
                         "deadline expired while brownout-deferred",
                         now, thrash=False)
        self._sweep_line(self._resume_q,
                         "deadline expired on the resume line", now)
        evicted = False
        for s, r in enumerate(self._slot_req):
            if r is None or r.deadline is None or now <= r.deadline:
                continue
            mid_decode = r.pf_next is None
            phase = (f"mid-decode after {len(r.generated)} tokens"
                     if mid_decode else "during chunked prefill")
            if _fail_future(r.future, DeadlineExceededError(
                    f"deadline expired {phase}")):
                if mid_decode:
                    self.metrics.count("evicted_mid_decode")
                self._deadline_miss(r, now)
            self._free_slot(s)
            evicted = True
        if evicted:
            self._gc_versions()

    def _materialize_cow(self, live):
        """Lazy copy-on-write at the FIRST divergent append: a live slot
        whose next write lands in a block it still shares gets its
        private copy now (the spare block was reserved at admission)."""
        for s, r in live:
            if r.alloc is None or r.alloc.cow is None:
                continue
            src, dst = self._pool.cow(r.alloc)
            self._btabs[s, :len(r.alloc.ids)] = r.alloc.ids
            with self._tracer.span("decode.cow", cat="serve",
                                   track="server", src=src, dst=dst):
                self._cow_copy(self._cache, src, dst)
            self.metrics.count("cow_copies")

    def _fail_parked(self, exc):
        """Fail everything parked outside the submit queue (the memory,
        priority, deferred, resume and migrate-in lines) and every pending
        durable-KV command."""
        for dq in (self._mem_wait, self._prio_q, self._defer_q,
                   self._resume_q, self._migrate_in_q):
            while dq:
                try:
                    r = dq.popleft()
                except IndexError:
                    break
                if _fail_future(r.future, exc):
                    self.metrics.count("failed")
        for dq in (self._migrate_cmds, self._prefix_cmds,
                   self._drain_cmds):
            while dq:
                try:
                    reply = dq.popleft()[-1]
                except IndexError:
                    break
                if not reply.done():
                    reply.set_exception(exc)

    def _fail_queued(self, exc):
        """On a killed server the crash error wins whatever the exiting
        loop passed (it may notice `_running` drop before `_killed`)."""
        if self._killed:
            exc = ReplicaDeadError(f"replica {self.instance!r} crashed")
        self._fail_parked(exc)
        super()._fail_queued(exc)

    def _observe_rate(self, tokens, dt, active=0):
        """Feed one iteration into the admission estimator."""
        if self._admission is None:
            return
        est = self._admission.estimator
        est.observe(tokens, dt, active)
        tps = est.tokens_per_second
        if tps is not None:
            self.metrics.record_service_rate(tps)

    def _note_iter_time(self, dt):
        """Fold one iteration's wall time into the fused clamp's EWMA."""
        a = 0.2
        self._iter_ewma = (dt if self._iter_ewma is None
                           else a * dt + (1 - a) * self._iter_ewma)

    def _call(self, dispatch):
        """One dispatch, through the retry policy when there is one."""
        if self._retry is not None:
            return self._retry.call(
                dispatch,
                on_retry=lambda a, e, d: self.metrics.count("retries"))
        return dispatch()

    def _chunk_iteration(self, pf):
        """Advance every PREFILLING slot one chunk: one chunk dispatch per
        live version. A slot whose FINAL chunk lands moves to the decode
        phase: its last real row's argmax is the first token (TTFT), and
        the paged prompt blocks are indexed only now. Chunk dispatches
        count `chunk_dispatches`, not `dispatches`."""
        C = self._chunk
        tr = self._tracer
        done_any = False
        for v in sorted({r.version for _, r in pf}):
            pf_v = [(s, r) for s, r in pf if r.version == v]
            active = np.zeros((self.slots,), bool)
            toks = np.zeros((self.slots, C), np.int64)
            nrows = np.zeros((self.slots,), np.int64)
            wfrom = np.zeros((self.slots,), np.int64)
            wto = np.zeros((self.slots,), np.int64)
            for s, r in pf_v:
                active[s] = True
                n = min(C, len(r.prompt) - r.pf_next)
                nrows[s] = n
                toks[s, :n] = r.prompt[r.pf_next:r.pf_next + n]
                wfrom[s] = r.pf_wfrom
                wto[s] = len(r.prompt)
            aux, blocks = self._versions[v]

            def dispatch():
                if self._injector is not None:
                    self._injector.fire("serve.batch")
                if self._paged:
                    return self._chunk_step(
                        aux, blocks, self._cache, self._dev(self._btabs),
                        self._pos, self._dev(toks), self._dev(nrows),
                        self._dev(active), self._dev(wfrom),
                        self._dev(wto))
                return self._chunk_step(
                    aux, blocks, self._cache, self._pos, self._dev(toks),
                    self._dev(nrows), self._dev(active))

            t0 = time.monotonic_ns() if tr.enabled else None
            nxt, _, self._pos = self._call(dispatch)
            self.metrics.count("chunk_dispatches")
            for s, r in pf_v:
                self._spend_work(r)     # one chunk = one work unit
            nxt = nxt.cpu().numpy()
            if t0 is not None:
                dur = time.monotonic_ns() - t0
                for s, r in pf_v:
                    tr.emit("decode.prefill", t0, dur, cat="serve",
                            track=f"req-{r.req_id}", trace_id=r.req_id,
                            args={"chunk": int(nrows[s]), "slot": s})
            t_now = time.monotonic()
            for s, r in pf_v:
                r.pf_next += int(nrows[s])
                if r.pf_next < len(r.prompt):
                    continue
                r.pf_next = None        # final chunk: decode phase now
                if self._paged:
                    self._pool.commit(r.alloc)
                    self.metrics.count("prefix_rows_total",
                                       len(r.prompt))
                    if r.alloc.shared_rows:
                        self.metrics.count("prefix_rows_hit",
                                           r.alloc.shared_rows)
                first = int(nxt[s, int(nrows[s]) - 1])
                r.generated.append(first)
                r.t_first_tok = r.t_last_tok = t_now
                self.metrics.record_ttft(
                    (r.t_last_tok - r.t_submit) * 1e3)
                self._spend_work(r)     # the first token
                if len(r.generated) >= r.max_new:
                    self._complete(r, t_now)
                    self._free_slot(s)
                    done_any = True
                    continue
                self._tok[s] = first
                if self._spec is not None:
                    self._spec.draft.start(s, list(r.prompt) + r.generated)
        if done_any:
            self._gc_versions()

    def _fused_window_ok(self, dec):
        """The mid-window deadline clamp: a window may start only when the
        tightest live deadline has K iterations of headroom (no rate
        estimate yet counts as none); otherwise this round takes the
        plain per-iteration path, which sweeps at the K=1 cadence."""
        tightest = None
        now = time.monotonic()
        for _, r in dec:
            if r.deadline is not None:
                rem = r.deadline - now
                tightest = rem if tightest is None else min(tightest,
                                                            rem)
        if tightest is None:
            return True
        if self._iter_ewma is None:
            return False
        return tightest >= self._fused * self._iter_ewma

    def _window_dispatch(self, v, aux, blocks, inputs):
        """One fused window of version `v`: a CUDA graph replay on the
        card (captured at the version's first window), the eager window
        on the CPU. inputs: the window's host arrays by name."""
        names = (("btabs",) if self._paged else ()) + (
            "pos", "tok", "active", "steps") + (
            ("wto",) if self._paged else ())
        if self.device.type != "cuda":
            args = [self._pos if n == "pos" else self._dev(inputs[n])
                    for n in names]
            toks, _, pos = self._window_step(aux, blocks, self._cache,
                                             *args)
            return toks, pos
        values = {n: (self._pos if n == "pos" else self._dev(inputs[n]))
                  for n in names}
        g = self._graphs.get(v)
        if g is None:
            def run(st):
                toks, _, pos = self._window_step(
                    aux, blocks, self._cache, *[st[n] for n in names])
                return toks, pos
            g = _CapturedWindow(run, {n: t.clone()
                                      for n, t in values.items()})
            self._graphs[v] = g
            self.metrics.count("fused_graphs")
        return g.replay(values)

    def _fused_iteration(self, dec, t_iter_start, n_occ):
        """One fused WINDOW: K decode iterations in one dispatch per live
        version, K tokens per slot read back in one transfer, then the
        host replays the window's bookkeeping as K plain iterations
        would. `steps` clamps each slot to its remaining budget (paged:
        also to its reserved rows, passed as the write gate `wto`); CoW
        materializes before the dispatch."""
        K = self._fused
        tr = self._tracer
        t_iter0 = time.monotonic_ns() if tr.enabled else None
        if self._paged:
            self._materialize_cow(dec)
            self.metrics.record_pool(self._pool.blocks_in_use,
                                     self._pool.capacity)
        steps = np.zeros((self.slots,), np.int64)
        wto = np.zeros((self.slots,), np.int64)
        for s, r in dec:
            n = min(K, r.max_new - len(r.generated))
            if self._paged:
                # the frontier row is len(prompt) + len(generated) - 1;
                # never scan past the reservation
                wto[s] = self._pool.writable_rows(r.alloc)
                n = min(n, int(wto[s]) - (len(r.prompt)
                                          + len(r.generated) - 1))
            steps[s] = max(n, 0)
        win_tok = {}
        for v in sorted({r.version for _, r in dec}):
            active = np.zeros((self.slots,), bool)
            for s, r in dec:
                if r.version == v:
                    active[s] = True
            aux, blocks = self._versions[v]
            inputs = {"btabs": self._btabs, "tok": self._tok,
                      "active": active, "steps": steps, "wto": wto}

            def dispatch():
                if self._injector is not None:
                    self._injector.fire("serve.batch")
                return self._window_dispatch(v, aux, blocks, inputs)

            with tr.span("decode.window", cat="serve", track="server",
                         version=v, k=K):
                toks, self._pos = self._call(dispatch)
            self.metrics.count("dispatches")
            self.metrics.count("fused_windows")
            toks = toks.cpu().numpy()             # [K, S]
            for s, r in dec:
                if r.version == v:
                    win_tok[s] = toks[:, s]
        n_iters = int(steps.max())
        total = 0
        done_any = False
        t_now = time.monotonic()
        for s, r in dec:
            n = int(steps[s])
            if n <= 0:
                continue
            got = [int(t) for t in win_tok[s][:n]]
            r.generated.extend(got)
            self._tok[s] = got[-1]
            total += n
            self._spend_work(r, n)
            # n tokens land at once: one per-token inter-token sample
            if r.t_last_tok is not None:
                self.metrics.record_inter_token(
                    (t_now - r.t_last_tok) * 1e3 / n)
            r.t_last_tok = t_now
            if len(r.generated) >= r.max_new:
                r.generated = r.generated[:r.max_new]
                self._complete(r, t_now)
                self._free_slot(s)
                done_any = True
        self.metrics.count("tokens_out", total)
        self.metrics.count("decode_iterations", n_iters)
        if t_iter0 is not None:
            tr.emit("decode.iteration", t_iter0,
                    time.monotonic_ns() - t_iter0, cat="serve",
                    track="server",
                    args={"slot_occupancy": n_occ / self.slots,
                          "accepted": total, "fused_k": K,
                          "iterations": n_iters})
        # K per-iteration estimator samples, not one K-sized sample
        window_dt = time.monotonic() - t_iter_start
        self._note_iter_time(window_dt / K)
        for i in range(K):
            t_i = int(np.sum(steps > i))
            self._observe_rate(t_i, window_dt / K, t_i)
        if done_any:
            self._gc_versions()
        self._after_iteration()
        return True

    def _decode_iteration(self):
        """One scheduling iteration: advance PREFILLING slots one chunk
        each, then one decode dispatch per live version over the DECODING
        slots, the active mask restricted to that version's slots."""
        t_iter_start = time.monotonic()
        live = [(s, r) for s, r in enumerate(self._slot_req)
                if r is not None]
        if not live:
            return False
        pf = [(s, r) for s, r in live if r.pf_next is not None]
        if pf:
            self._chunk_iteration(pf)
        dec = [(s, r) for s, r in enumerate(self._slot_req)
               if r is not None and r.pf_next is None]
        n_occ = sum(1 for r in self._slot_req if r is not None)
        if n_occ:
            self.metrics.record_occupancy(n_occ, self.slots)
            self.metrics.record_live_streams(n_occ)
        if not dec:
            # pure prefill pass: its wall time dilutes the next sample
            self._observe_rate(0, time.monotonic() - t_iter_start, 0)
            self._after_iteration()
            return True
        if self._spec is not None:
            return self._spec_iteration(dec, t_iter_start)
        if self._fused > 1 and self._fused_window_ok(dec):
            return self._fused_iteration(dec, t_iter_start, n_occ)
        tr = self._tracer
        t_iter0 = time.monotonic_ns() if tr.enabled else None
        if self._paged:
            self._materialize_cow(dec)
            self.metrics.record_pool(self._pool.blocks_in_use,
                                     self._pool.capacity)
        new_tok = {}
        for v in sorted({r.version for _, r in dec}):
            active = np.zeros((self.slots,), bool)
            for s, r in dec:
                if r.version == v:
                    active[s] = True
            aux, blocks = self._versions[v]

            def dispatch():
                if self._injector is not None:
                    self._injector.fire("serve.batch")
                if self._paged:
                    return self._step(aux, blocks, self._cache,
                                      self._dev(self._btabs), self._pos,
                                      self._dev(self._tok),
                                      self._dev(active))
                return self._step(aux, blocks, self._cache, self._pos,
                                  self._dev(self._tok), self._dev(active))

            with tr.span("decode.dispatch", cat="serve", track="server",
                         version=v):
                nxt, _, _, self._pos = self._call(dispatch)
            self.metrics.count("dispatches")
            nxt = nxt.cpu().numpy()
            for s, r in dec:
                if r.version == v:
                    new_tok[s] = int(nxt[s])
        self.metrics.count("tokens_out", len(dec))
        self.metrics.count("decode_iterations")
        for s, r in dec:
            self._spend_work(r)
        done_any = False
        t_now = time.monotonic()
        for s, r in dec:
            self._tok[s] = new_tok[s]
            r.generated.append(new_tok[s])
            if r.t_last_tok is not None:
                self.metrics.record_inter_token(
                    (t_now - r.t_last_tok) * 1e3)
            r.t_last_tok = t_now
            if len(r.generated) >= r.max_new:
                # the final token needs no decode step
                r.generated = r.generated[:r.max_new]
                self._complete(r, t_now)
                self._free_slot(s)
                done_any = True
        if t_iter0 is not None:
            tr.emit("decode.iteration", t_iter0,
                    time.monotonic_ns() - t_iter0, cat="serve",
                    track="server",
                    args={"slot_occupancy": n_occ / self.slots,
                          "accepted": len(dec)})
        dt_iter = time.monotonic() - t_iter_start
        self._note_iter_time(dt_iter)
        self._observe_rate(len(dec), dt_iter, len(dec))
        if done_any:
            self._gc_versions()
        self._after_iteration()
        return True

    def _spec_iteration(self, live, t_iter_start):
        """One SPECULATIVE iteration over the decoding slots `live`: per
        live version, each slot's draft (K-1 tokens, zero-padded: padding
        costs acceptance, never correctness), ONE K-wide verify dispatch,
        the argmax and acceptance counts to the host in one copy, and each
        slot advanced by its accepted count plus the bonus token, capped
        at its budget. Paged: the table and each slot's reserved row bound
        `wto` ride in like tok/active, and a pending CoW materializes
        first (the K-wide write starts inside a still-shared block)."""
        tr = self._tracer
        t_iter0 = time.monotonic_ns() if tr.enabled else None
        n_accepted = 0
        K = self._spec.k
        draft = self._spec.draft
        d0 = getattr(draft, "dispatch_count", 0)
        if self._paged:
            self._materialize_cow(live)
            self.metrics.record_pool(self._pool.blocks_in_use,
                                     self._pool.capacity)
        done_any = False
        for v in sorted({r.version for _, r in live}):
            live_v = [(s, r) for s, r in live if r.version == v]
            active = np.zeros((self.slots,), bool)
            toks = np.zeros((self.slots, K), np.int64)
            wto = np.zeros((self.slots,), np.int64)
            n_dr = {}
            for s, r in live_v:
                active[s] = True
                if self._paged:
                    wto[s] = self._pool.writable_rows(r.alloc)
                # never draft past the remaining budget
                n_want = r.max_new - len(r.generated)
                dr = list(draft.propose(
                    s, min(K - 1, n_want - 1)))[:K - 1]
                n_dr[s] = len(dr)
                toks[s, :1 + len(dr)] = [r.generated[-1]] + dr
            aux, blocks = self._versions[v]

            def dispatch():
                if self._injector is not None:
                    self._injector.fire("serve.batch")
                if self._paged:
                    return self._verify(
                        aux, blocks, self._cache, self._dev(self._btabs),
                        self._pos, self._dev(toks), self._dev(active),
                        self._dev(wto))
                return self._verify(aux, blocks, self._cache, self._pos,
                                    self._dev(toks), self._dev(active))

            with tr.span("decode.verify", cat="serve", track="server",
                         version=v, k=K):
                nxt, n_acc, _, _, self._pos = self._call(dispatch)
            self.metrics.count("dispatches")
            host = torch.cat([n_acc[:, None], nxt], 1).cpu().numpy()
            t_now = time.monotonic()
            for s, r in live_v:
                want = r.max_new - len(r.generated)
                take = min(int(host[s, 0]) + 1, want)
                acc = [int(t) for t in host[s, 1:1 + take]]
                r.generated.extend(acc)
                # `take` tokens land at once: the per-token stream rate
                if take and r.t_last_tok is not None:
                    self.metrics.record_inter_token(
                        (t_now - r.t_last_tok) * 1e3 / take)
                r.t_last_tok = t_now
                n_accepted += take
                self.metrics.count("tokens_out", take)
                self._spend_work(r, take)
                # drafted: real draft tokens, not padding; matched capped
                self.metrics.record_speculation(
                    take, n_dr[s], min(int(host[s, 0]), take, n_dr[s]))
                if len(r.generated) >= r.max_new:
                    self._complete(r, t_now)
                    self._free_slot(s)
                    done_any = True
                else:
                    draft.observe(s, acc)
        dd = getattr(draft, "dispatch_count", 0) - d0
        if dd:
            # a ModelDraft's own dispatches (an NGramDraft has none)
            self.metrics.count("draft_dispatches", dd)
        if t_iter0 is not None:
            tr.emit("decode.iteration", t_iter0,
                    time.monotonic_ns() - t_iter0, cat="serve",
                    track="server",
                    args={"slot_occupancy": len(live) / self.slots,
                          "accepted": n_accepted,
                          "draft_dispatches": dd})
        self.metrics.count("decode_iterations")
        self._observe_rate(n_accepted, time.monotonic() - t_iter_start,
                           len(live))
        if done_any:
            self._gc_versions()
        self._after_iteration()
        return True

    def _after_iteration(self):
        self.metrics.count("batches")       # decode iterations
        if self._reporter is not None and \
                self.metrics.count_value("batches") % self._report_every \
                == 0:
            self._reporter.report(self.metrics.snapshot())

    def _gc_versions(self):
        """Drop drained old parameter versions, and their captured windows
        (indices stay stable: only versions below the newest go)."""
        with self._swap_lock:
            in_use = {r.version for r in self._slot_req if r is not None}
            # a preempted request's version stays while it parks (a
            # migrated-in one has none: it binds the newest at admission)
            in_use.update(r.version for r in self._resume_q
                          if r.version is not None)
            newest = len(self._versions) - 1
            for v in range(newest):
                if v not in in_use and self._versions[v] is not None:
                    self._versions[v] = None
                    self._graphs.pop(v, None)

    def _busy(self):
        return any(r is not None for r in self._slot_req) \
            or bool(self._mem_wait) or bool(self._prio_q) \
            or bool(self._defer_q) or bool(self._resume_q) \
            or bool(self._migrate_in_q) or bool(self._migrate_cmds) \
            or bool(self._prefix_cmds) or bool(self._drain_cmds)

    def _loop_once(self):
        if self._killed:
            # kill(): fail everything and let the loop exit
            self._die_now()
            return
        with torch.no_grad(), card_numerics(self.device, self._cache_dtype):
            self._schedule_once()

    def _schedule_once(self):
        self._service_drain()
        if self._paged:
            # migrate-in staging joins the serve thread's resume line;
            # then the export and prefix commands, before the sweep
            while self._migrate_in_q:
                self._resume_q.append(self._migrate_in_q.popleft())
            self._service_migrations()
            self._service_prefix_ops()
        # evict deadline-expired slots FIRST so the admit below can refill
        # them in the same iteration
        self._evict_expired()
        # idle: block on the queue up to 50 ms; busy: drain non-blocking
        self._admit_pending(timeout=0.0 if self._busy() else 0.05)
        try:
            busy = self._decode_iteration()
        except BaseException as e:  # noqa: BLE001 - fail slots, survive
            # a dispatch failed terminally: the cache may hold a half-
            # written step, so every occupied request fails LOUDLY and the
            # slot state resets; the server keeps serving
            n_failed = 0
            for r in self._slot_req:
                if r is not None and _fail_future(r.future, e):
                    n_failed += 1
            if n_failed:
                self.metrics.count("failed", n_failed)
            self._reset_device_state()
            self._gc_versions()
            return
        if not busy:
            self._gc_versions()
