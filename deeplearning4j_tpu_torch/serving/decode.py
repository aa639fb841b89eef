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

Not ported yet, each raising NotImplementedError that names its
ROADMAP.md item: speculative decoding (`speculate=`, item 3); durable KV
state (`preempt=`, `prefix_cache_dir=`, `migrate_out`, `migrate_in`,
`save_prefix_cache`, `restore_prefix_cache`, `prefix_export`,
`prefix_adopt`, item 4); the fleet verbs (`kill`, `drain`, item 6).
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
import logging
import queue
import threading
import time

import numpy as np
import torch

from .. import obs
from ..common.device import card_numerics
from ..models.zoo import transformer as _T
from .admission import DEFER, SHED, AdmissionController
from .kvpool import BlockPool
from .metrics import ServingMetrics
from .server import (DeadlineExceededError, ServerClosedError,
                     ServerOverloadedError, _fail_future, _RequestLoop,
                     _resolve_future)

log = logging.getLogger(__name__)


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet; ROADMAP.md "
                               f"queue 1 item {item}")


def _param_leaves(aux, blocks):
    """(name, tensor) of one parameter version, in a fixed order."""
    return (list(aux.named_parameters(prefix="aux"))
            + [(name, t) for i, b in enumerate(blocks)
               for name, t in b.named_parameters(prefix=f"blocks.{i}")])


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
                 "klass", "prio_overtook", "pf_quoted")

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
    # after this many consecutive priority overtakes, the primary queue's
    # head gets one turn: prefix-hit traffic never starves cold prompts
    _PRIO_BURST = 4

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
        if speculate is not None:
            raise _not_ported("speculative decoding (speculate=)", 3)
        if preempt:
            raise _not_ported("preemption (preempt=True)", 4)
        if prefix_cache_dir is not None:
            raise _not_ported("the persistent prefix cache "
                              "(prefix_cache_dir=)", 4)
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
        self._work_lock = threading.Lock()
        self._work_tokens = 0   # work-unit backlog (queued + live)
        # admission hysteresis: an actual eviction/expiry tightens
        # prediction shedding to exactly the budget for this long
        self._thrash_until = 0.0

        self._graphs = {}       # version -> _CapturedWindow (the card)
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
        self._fused = 1 if fused_serve is None else int(fused_serve)
        if self._fused < 1:
            raise ValueError(f"fused_serve must be >= 1, got "
                             f"{fused_serve}")
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
        else:
            self._make_prefill = lambda: _T.make_prefill_fn(
                n_heads, self.max_len)

        self._swap_lock = threading.Lock()
        self._init_loop(max_queue)
        if self._named_instance:
            self._req_ids = (f"{self.instance}-{n}"
                             for n in itertools.count())

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
        return self._q.qsize() + len(self._prio_q)

    def _shed_if_lines_full(self):
        """The primary queue and the priority line share `max_queue`."""
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
            try:
                self._q.put_nowait(_Wake())
            except queue.Full:
                pass
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
        """True while the serve loop runs on a live thread."""
        t = self._thread
        return bool(self._running and t is not None and t.is_alive())

    # -- not ported yet --------------------------------------------------
    def kill(self):
        raise _not_ported("kill (the fleet's crash verb)", 6)

    def drain(self, migrate=None, timeout=60.0):
        raise _not_ported("drain (the fleet's hand-off verb)", 6)

    def migrate_out(self, future, timeout=30.0):
        raise _not_ported("migrate_out (durable KV state)", 4)

    def migrate_in(self, artifact, deadline_ms=None):
        raise _not_ported("migrate_in (durable KV state)", 4)

    def save_prefix_cache(self, path=None):
        raise _not_ported("save_prefix_cache (durable KV state)", 4)

    def restore_prefix_cache(self, path=None):
        raise _not_ported("restore_prefix_cache (durable KV state)", 4)

    def prefix_export(self, key, max_bytes=None, timeout=30.0):
        raise _not_ported("prefix_export (durable KV state)", 4)

    def prefix_adopt(self, artifact, timeout=30.0):
        raise _not_ported("prefix_adopt (durable KV state)", 4)

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
        """Fill free slots from the lines. `timeout` blocks on the FIRST
        get only (the idle wait). Paged mode adds the MEMORY gate: a
        request that cannot get its blocks parks at the head of the line
        (`blocked_on_memory` counted once) and admission stops until
        completions free blocks."""
        if not self._running and not self._drain_on_stop:
            # fail-fast stop: never admit queued requests into freed
            # slots; parked lines count as _busy() and fail here
            self._fail_parked(ServerClosedError("server stopped"))
            return
        free = [s for s in range(self.slots) if self._slot_req[s] is None]
        if self._static and len(free) < self.slots:
            return      # gang scheduling: wait for the whole batch
        wait = float(timeout)
        blocked = []
        try:
            for s in free:
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
                        alloc = self._pool.admit(
                            req.prompt, len(req.prompt) + req.max_new - 1,
                            will_append=req.max_new > 1, tag=vidx)
                        if alloc is None:
                            if not req.mem_blocked:
                                req.mem_blocked = True
                                self.metrics.count("blocked_on_memory")
                            blocked.append(req)
                            return      # FIFO gate: stop admission
                try:
                    self._admit(req, s, alloc, version=version)
                except BaseException as e:  # noqa: BLE001 - fail THIS
                    if alloc is not None:   # request
                        self._pool.release(alloc)
                    _fail_future(req.future, e)
                    self.metrics.count("failed")
                else:
                    if req.prio_overtook:
                        req.prio_overtook = False
                        self.metrics.count("admitted_prefix_priority")
        finally:
            if blocked:
                self._mem_wait.extendleft(reversed(blocked))

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
        priority and deferred lines)."""
        for dq in (self._mem_wait, self._prio_q, self._defer_q):
            while dq:
                try:
                    r = dq.popleft()
                except IndexError:
                    break
                if _fail_future(r.future, exc):
                    self.metrics.count("failed")

    def _fail_queued(self, exc):
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
            newest = len(self._versions) - 1
            for v in range(newest):
                if v not in in_use and self._versions[v] is not None:
                    self._versions[v] = None
                    self._graphs.pop(v, None)

    def _busy(self):
        return any(r is not None for r in self._slot_req) \
            or bool(self._mem_wait) or bool(self._prio_q) \
            or bool(self._defer_q)

    def _loop_once(self):
        with torch.no_grad(), card_numerics(self.device, self._cache_dtype):
            self._schedule_once()

    def _schedule_once(self):
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
