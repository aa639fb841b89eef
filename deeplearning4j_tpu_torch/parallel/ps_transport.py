"""Cross-process transport for the asynchronous parameter server: port of
deeplearning4j_tpu/parallel/ps_transport.py, with the same wire format byte
for byte, so a reference `PSClient` talks to a port `PSServer` and the other
way round. The socket, framing and resilience code is the reference's
(stdlib); what changed is the leaves: `pack_leaves` takes numpy arrays or
torch tensors (a message's CUDA tensors go to the host in one copy),
`unpack_leaves` returns CPU torch tensors, and a bf16 leaf travels as its
raw 2-byte words under the reference's dtype name "bfloat16" (numpy has no
bf16). Leaves cross in the reference's order and layout: `param_leaves` /
`params_from_leaves` flatten the port's per-layer trees as
`jax.tree_util.tree_leaves` flattens the reference's (layers in order, or
vertex names sorted; parameter names sorted), convolution kernels HWIO.

The reference's PS is inherently cross-process: ParameterServerParallelWrapper
launches an Aeron MediaDriver and workers push gradients / pull parameters
through a ParameterServerClient over UDP (reference
ParameterServerParallelWrapper.java:159-160, ParameterServerTrainer.java).
The in-process accumulator (`parameter_server.GradientsAccumulator`) carries
the staleness semantics; this module puts a REAL process/network boundary
under the same two operations:

  * `PSServer` — owns the master network and a GradientsAccumulator; serves
    PULL (latest version-tagged snapshot) and PUSH (enqueue gradients) over a
    length-prefixed TCP protocol. The ack for PUSH is sent only after the
    gradient is enqueued, so the accumulator's bounded inbox exerts
    backpressure straight through TCP — the role the Aeron client's bounded
    buffer played.
  * `PSClient` — worker-side client, one connection per worker.
  * `ps_worker_fit` — the worker loop: pull snapshot -> grad_fn ->
    push gradients, the exact loop the in-process wrapper's worker threads
    run, against a remote master.

Why TCP and not Aeron/UDP: synchronous training rides collectives
(`parallel_wrapper.py`); the PS transport crosses the host boundary, where
a stream socket's ordering and backpressure match the accumulator's queue
semantics exactly.

Fault tolerance (what Aeron's loss-tolerant transport gave the reference
for free, made explicit here — see `common/resilience.py` and
ARCHITECTURE.md "Resilience layer"):

  * identity: every connection opens with HELLO; the server assigns (or
    re-accepts) a worker id, so a worker keeps its identity across
    reconnects.
  * reconnect: with a `RetryPolicy`, a dropped/severed connection is
    re-dialed with bounded backoff and the in-flight operation re-run.
    PULL is a read (naturally idempotent); PUSH carries a per-worker
    monotonic sequence number and the server applies each (worker, seq) AT
    MOST ONCE — a push whose ack was lost is re-sent, detected as a
    duplicate, and acked without re-applying (`dup_pushes` in stats).
  * liveness: workers heartbeat on a dedicated second socket (the main
    socket legitimately blocks for long stretches under PUSH backpressure,
    so it cannot carry liveness). The server reaps workers silent past
    `heartbeat_timeout` — reaped workers count toward the shutdown barrier
    so `wait()` returns with the survivors instead of deadlocking on a
    crashed worker (graceful degradation; `workers_reaped` in stats).

Wire format (little-endian): each message is `u32 length | u8 op | payload`.
Array payloads pack a leaf list as `u32 n | per leaf: u8 dtype-len,
dtype-str, u8 ndim, u64 dims..., u64 nbytes, raw bytes` — both ends hold the
same model, so pytree structure never crosses the wire, only leaves.
PUSH payload: `u64 worker_id | u64 seq | u64 version | f64 score | leaves |
u8 has-state [| state leaves]`. HELLO: `i64 proposed_id` (-1 = assign) ->
`u64 assigned_id`. HEARTBEAT/DONE: `u64 worker_id`.
"""
from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time

from ..common.resilience import NonRetryableError
from ..datasets.iterators import next_processed

import numpy as np
import torch

log = logging.getLogger(__name__)

OP_PULL = 1
OP_PUSH = 2
OP_STATS = 3
OP_DONE = 4
OP_HELLO = 5
OP_HEARTBEAT = 6

_ACK = b"\x01"
_NACK = b"\x00"


class ProtocolError(ConnectionError):
    """Malformed/unexpected wire message. Raised eagerly — a desynced
    stream must fail loudly, never be parsed as the wrong message type.
    Subclasses ConnectionError so a retry policy treats a desynced stream
    like a broken one: reconnect and re-run the (idempotent) operation."""


class ServerRefusedError(ProtocolError, NonRetryableError):
    """The server processed the request and said no (e.g. a push the
    stopped accumulator discarded). The stream is still consistent and a
    retry would be refused again — never auto-retried."""


# -- leaf (de)serialization -------------------------------------------------

def _torch_name(dtype):
    """A torch dtype's numpy name ("float32", "bfloat16", "int64", ...)."""
    return str(dtype).rsplit(".", 1)[-1]


def _leaf_records(leaves):
    """(dtype name, shape, raw bytes) per leaf, in C order. The CUDA
    tensors among the leaves go to the host in ONE copy."""
    recs = [None] * len(leaves)
    cuda = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.is_cuda:
                cuda.append(i)
                continue
            raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
            recs[i] = (_torch_name(t.dtype), tuple(t.shape), raw.tobytes())
            continue
        # NOT ascontiguousarray: it promotes 0-d scalars to 1-d, and
        # tobytes() below already emits C-order for any layout
        a = np.asarray(leaf)
        # dtype by NAME, not .str (an ml_dtypes bf16 array's .str is '<V2');
        # the name drops byte order, so big-endian sources go native first
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("="))
        recs[i] = (a.dtype.name, a.shape, a.tobytes())
    if cuda:
        parts = [leaves[i].detach().contiguous().reshape(-1).view(torch.uint8)
                 for i in cuda]
        host = torch.cat(parts).cpu().numpy()
        off = 0
        for i, p in zip(cuda, parts):
            t = leaves[i]
            recs[i] = (_torch_name(t.dtype), tuple(t.shape),
                       host[off:off + p.numel()].tobytes())
            off += p.numel()
    return recs


def pack_leaves(leaves):
    out = [struct.pack("<I", len(leaves))]
    for name, shape, raw in _leaf_records(leaves):
        dt = name.encode()
        out.append(struct.pack("<B", len(dt)))
        out.append(dt)
        out.append(struct.pack("<B", len(shape)))
        out.append(struct.pack(f"<{len(shape)}Q", *shape) if shape else b"")
        out.append(struct.pack("<Q", len(raw)))
        out.append(raw)
    return b"".join(out)


def _leaf(buf, dt, shape, off, nbytes):
    """One leaf of the wire as a CPU tensor (a copy)."""
    count = int(np.prod(shape)) if shape else 1   # 0-d scalar = 1 elem
    if dt == "bfloat16":
        if not nbytes:
            return torch.empty(shape, dtype=torch.bfloat16)
        words = np.frombuffer(buf, np.int16, count=count, offset=off)
        return torch.from_numpy(words.reshape(shape).copy()).view(
            torch.bfloat16)
    if not nbytes:
        return torch.from_numpy(np.empty(shape, np.dtype(dt)))
    return torch.from_numpy(np.frombuffer(buf, np.dtype(dt), count=count,
                                          offset=off).reshape(shape).copy())


def unpack_leaves(buf, off=0):
    """Returns (leaves as CPU torch tensors, next_offset)."""
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    leaves = []
    for _ in range(n):
        (dtl,) = struct.unpack_from("<B", buf, off)
        off += 1
        dt = buf[off:off + dtl].decode()
        off += dtl
        (ndim,) = struct.unpack_from("<B", buf, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}Q", buf, off) if ndim else ()
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", buf, off)
        off += 8
        leaves.append(_leaf(buf, dt, tuple(shape), off, nbytes))
        off += nbytes
    return leaves, off


# -- the port's trees in the reference's leaf order and layout -------------

def _layer_order(net):
    """(key, layer) in the order tree_leaves walks the reference's tree:
    MultiLayerNetwork's list by index, ComputationGraph's dict by sorted
    vertex name."""
    return sorted(net._keyed_layers(), key=lambda kl: kl[0])


def param_leaves(net, params):
    """A per-layer tree of the port ({key: {name: tensor}}: parameters or
    their gradients) as the reference's leaves: its order, its layout."""
    return [layer.to_reference(k, params[key][k])
            for key, layer in _layer_order(net) for k in sorted(params[key])]


def state_leaves(net, state):
    """The layer state ({key: {name: tensor}}) as the reference's leaves."""
    return [state[key][n] for key, _ in _layer_order(net)
            for n in sorted(state[key])]


def _from_leaves(net, leaves, like, convert):
    order = [(key, layer, k) for key, layer in _layer_order(net)
             for k in sorted(like[key])]
    if len(leaves) != len(order):
        raise ProtocolError(f"{len(leaves)} leaves on the wire, the network "
                            f"has {len(order)}")
    out = {key: {} for key, _ in _layer_order(net)}
    for (key, layer, k), leaf in zip(order, leaves):
        ref = like[key][k]
        out[key][k] = convert(layer, k, leaf).to(device=ref.device,
                                                 dtype=ref.dtype)
    return out


def params_from_leaves(net, leaves, like=None):
    """The reference's leaves (parameters or gradients) as a port tree
    shaped, placed and typed like `like` (the network's masters)."""
    return _from_leaves(net, leaves, like if like is not None else net._params,
                        lambda layer, k, a: layer.from_reference(k, a))


def state_from_leaves(net, leaves, like=None):
    return _from_leaves(net, leaves,
                        like if like is not None else net._states(),
                        lambda layer, k, a: a)


# -- framed socket I/O ------------------------------------------------------

def _send_msg(sock, op, payload=b""):
    sock.sendall(struct.pack("<IB", 1 + len(payload), op) + payload)


def _recv_exact(sock, n):
    chunks = []
    while n:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("peer closed")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _recv_msg(sock):
    (length,) = struct.unpack("<I", _recv_exact(sock, 4))
    body = _recv_exact(sock, length)
    return body[0], body[1:]


# -- server -----------------------------------------------------------------

class PSServer:
    """Socket front end over a GradientsAccumulator owning `net`.

    `n_workers`: the server stops (drains the accumulator, closes the
    listener) after this many workers finished — DONE handshake (the
    shutdown the reference runs through ParallelWrapper.close()) OR
    heartbeat reap (a crashed worker must not deadlock the survivors).
    `wait()` blocks until then and returns the merged stats.

    `heartbeat_timeout`: seconds of silence (no HELLO/PULL/PUSH/HEARTBEAT
    from a worker) after which it is declared dead and reaped. None
    (default) disables liveness tracking — the pre-resilience behavior.
    A worker expected by `n_workers` that NEVER says HELLO is reaped on
    the same timeout, counted from the last registration (or startup)."""

    def __init__(self, net, host="127.0.0.1", port=0, queue_size=8,
                 max_staleness=None, n_workers=1, heartbeat_timeout=None,
                 heartbeat_check_interval=None):
        from .parameter_server import GradientsAccumulator

        self.net = net
        # the accumulator initializes a fresh net (_ensure_init)
        self._acc = GradientsAccumulator(net, queue_size, max_staleness)
        self._n_workers = int(n_workers)
        self._done_evt = threading.Event()
        self._lock = threading.Lock()
        # worker registry: id -> {"last_seen", "done", "reaped"}
        self._workers = {}
        self._worker_locks = {}
        self._last_seq = {}          # id -> last push seq applied
        self._next_id = 0
        self._anon_done = 0          # DONEs without a worker id (legacy)
        self._dup_pushes = 0
        self._reaped = 0
        self._missing_reaped = 0     # expected workers that never connected
        self._last_registration = time.monotonic()
        self._hb_timeout = (None if heartbeat_timeout is None
                            else float(heartbeat_timeout))
        self._reaper_stop = threading.Event()
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._threads = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        if self._hb_timeout is not None:
            interval = (heartbeat_check_interval
                        if heartbeat_check_interval is not None
                        else max(0.05, self._hb_timeout / 4.0))
            self._reaper_thread = threading.Thread(
                target=self._reap_loop, args=(float(interval),), daemon=True)
            self._reaper_thread.start()
        self.stats = None

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:           # listener closed during shutdown
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    # -- worker registry / liveness ------------------------------------
    def _register(self, proposed):
        with self._lock:
            self._last_registration = time.monotonic()
            if proposed is None or proposed < 0:
                wid = self._next_id
                while wid in self._workers:
                    wid += 1
                self._next_id = wid + 1
            else:
                wid = int(proposed)
            w = self._workers.get(wid)
            if w is None:
                self._workers[wid] = {"last_seen": time.monotonic(),
                                      "done": False, "reaped": False}
                self._worker_locks[wid] = threading.Lock()
            else:
                w["last_seen"] = time.monotonic()
            return wid

    def _touch(self, wid):
        with self._lock:
            w = self._workers.get(wid)
            if w is None:
                # pushes/heartbeats carry the id — a reconnecting worker
                # the registry lost (or that skipped HELLO) re-registers
                self._workers[wid] = {"last_seen": time.monotonic(),
                                      "done": False, "reaped": False}
                self._worker_locks[wid] = threading.Lock()
            else:
                w["last_seen"] = time.monotonic()

    def _worker_lock(self, wid):
        with self._lock:
            lk = self._worker_locks.get(wid)
            if lk is None:
                lk = self._worker_locks[wid] = threading.Lock()
            return lk

    def _mark_done(self, wid):
        with self._lock:
            if wid is None:
                self._anon_done += 1
            else:
                w = self._workers.get(wid)
                if w is None:
                    w = self._workers[wid] = {
                        "last_seen": time.monotonic(),
                        "done": False, "reaped": False}
                    self._worker_locks.setdefault(wid, threading.Lock())
                w["done"] = True
            self._check_barrier_locked()

    def _check_barrier_locked(self):
        finished = (sum(1 for w in self._workers.values()
                        if w["done"] or w["reaped"])
                    + self._anon_done + self._missing_reaped)
        if finished >= self._n_workers:
            self._done_evt.set()

    def _reap_loop(self, interval):
        while not self._reaper_stop.wait(interval):
            now = time.monotonic()
            with self._lock:
                for wid, w in self._workers.items():
                    if (not w["done"] and not w["reaped"]
                            and now - w["last_seen"] > self._hb_timeout):
                        w["reaped"] = True
                        self._reaped += 1
                        log.warning(
                            "ps server: reaping worker %d (no heartbeat "
                            "for > %.1fs); training continues with the "
                            "survivors", wid, self._hb_timeout)
                # workers the barrier expects that never even registered
                # (crashed before HELLO) are reaped on the same timeout
                if (len(self._workers) < self._n_workers
                        and now - self._last_registration
                        > self._hb_timeout):
                    missing = self._n_workers - len(self._workers)
                    if missing != self._missing_reaped:
                        log.warning(
                            "ps server: %d expected worker(s) never "
                            "connected within %.1fs; reaping their slots",
                            missing, self._hb_timeout)
                        self._missing_reaped = missing
                else:
                    self._missing_reaped = min(
                        self._missing_reaped,
                        max(0, self._n_workers - len(self._workers)))
                self._check_barrier_locked()

    # -- connection handler --------------------------------------------
    def _serve_conn(self, conn):
        wid = None                   # this connection's worker identity
        try:
            with conn:
                while True:
                    try:
                        op, payload = _recv_msg(conn)
                    except ConnectionError:
                        return
                    if wid is not None:
                        self._touch(wid)     # any traffic is liveness
                    if op == OP_HELLO:
                        (proposed,) = struct.unpack_from("<q", payload, 0)
                        wid = self._register(proposed)
                        # reply carries the last APPLIED push seq for this
                        # id: a restarted worker process reusing its id
                        # resumes numbering above it, otherwise its fresh
                        # seqs (restarting at 1) would all be "duplicates"
                        # and its gradients silently discarded. Read under
                        # the GLOBAL lock, never the worker lock — that
                        # one is legitimately held for long stretches by a
                        # backpressure-blocked PUSH, and a stalled HELLO
                        # would block the heartbeat socket into a false
                        # reap of a healthy worker
                        with self._lock:
                            last = self._last_seq.get(wid, 0)
                        _send_msg(conn, OP_HELLO,
                                  struct.pack("<QQ", wid, last))
                    elif op == OP_HEARTBEAT:
                        (hb_wid,) = struct.unpack_from("<Q", payload, 0)
                        wid = int(hb_wid)
                        self._touch(wid)
                        from ..obs.registry import default_registry
                        default_registry().counter(
                            "ps.server.heartbeats").inc()
                        _send_msg(conn, OP_HEARTBEAT, _ACK)
                    elif op == OP_PULL:
                        params, mstate, version = self._acc.snapshot_params()
                        # the layer state always travels, as the
                        # reference's (never None) does
                        body = [struct.pack("<Q", version),
                                pack_leaves(param_leaves(self.net, params)),
                                b"\x01",
                                pack_leaves(state_leaves(self.net, mstate))]
                        _send_msg(conn, OP_PULL, b"".join(body))
                    elif op == OP_PUSH:
                        pwid, seq = struct.unpack_from("<QQ", payload, 0)
                        wid = int(pwid)
                        self._touch(wid)
                        (version,) = struct.unpack_from("<Q", payload, 16)
                        (score,) = struct.unpack_from("<d", payload, 24)
                        # per-worker serialization makes the dedup check
                        # sound: a retried push (reconnect after a lost
                        # ack) cannot race the original's enqueue. The
                        # _last_seq MAP itself is guarded by the global
                        # lock (brief accesses only) so readers like the
                        # HELLO handler never wait on this long-held lock
                        with self._worker_lock(wid):
                            with self._lock:
                                last = self._last_seq.get(wid, 0)
                            if seq <= last:
                                with self._lock:
                                    self._dup_pushes += 1
                                log.warning(
                                    "ps server: duplicate push from worker"
                                    " %d (seq %d) — already applied, "
                                    "acking without re-applying", wid, seq)
                                # graftlint: disable=lock-discipline -- the dup-ack stays inside the per-worker lock on purpose: releasing before acking would let a THIRD retry interleave between dedup-check and ack, and per-worker serialization is exactly what makes the seq dedup sound
                                _send_msg(conn, OP_PUSH, _ACK)
                                continue
                            leaves, off = unpack_leaves(payload, 32)
                            grads = params_from_leaves(self.net, leaves)
                            mstate = None
                            if payload[off] == 1:
                                sleaves, _ = unpack_leaves(payload, off + 1)
                                mstate = state_from_leaves(self.net, sleaves)
                            # blocks while the inbox is full -> the TCP ack
                            # below is the backpressure signal; a push the
                            # stopped accumulator discarded is NACKed so
                            # the worker fails instead of training into a
                            # void
                            accepted = self._acc.push_gradients(
                                grads, score, version, mstate)
                            if accepted:
                                with self._lock:
                                    self._last_seq[wid] = seq
                        _send_msg(conn, OP_PUSH,
                                  _ACK if accepted else _NACK)
                    elif op == OP_STATS:
                        _send_msg(conn, OP_STATS,
                                  json.dumps(self.server_stats()).encode())
                    elif op == OP_DONE:
                        if len(payload) >= 8:
                            (dwid,) = struct.unpack_from("<Q", payload, 0)
                            wid = int(dwid)
                        self._mark_done(wid)
                        _send_msg(conn, OP_DONE, _ACK)
                        return
                    else:
                        raise ProtocolError(f"unknown op {op}")
        except Exception:  # noqa: BLE001 — one bad client never kills serve
            log.exception("ps connection handler failed")

    def server_stats(self):
        """Accumulator stats merged with the transport-level resilience
        counters (the graceful-degradation record)."""
        s = dict(self._acc.stats())
        with self._lock:
            s["workers_reaped"] = self._reaped + self._missing_reaped
            s["dup_pushes"] = self._dup_pushes
            s["workers_done"] = (sum(1 for w in self._workers.values()
                                     if w["done"]) + self._anon_done)
        return s

    def wait(self, timeout=None):
        """Block until every worker finished (DONE or reaped), then drain +
        stop. Returns the merged stats dict."""
        if not self._done_evt.wait(timeout):
            with self._lock:
                finished = (sum(1 for w in self._workers.values()
                                if w["done"] or w["reaped"])
                            + self._anon_done + self._missing_reaped)
            raise TimeoutError(
                f"only {finished}/{self._n_workers} workers finished")
        self.stop()
        return self.stats

    def stop(self):
        self._reaper_stop.set()
        try:
            self._acc.shutdown()
        finally:
            self.stats = self.server_stats()
            try:
                self._sock.close()
            except OSError:
                pass


# -- client -----------------------------------------------------------------

class PSClient:
    """Worker-side connection: pull/push move leaf lists (numpy arrays or
    torch tensors out, CPU torch tensors in); the caller owns the tree
    structure (both ends built the same model).

    Resilience (all opt-in, defaults preserve fail-fast semantics):

    * `retry_policy` (`common.resilience.RetryPolicy`): reconnect with
      bounded backoff on ConnectionError/ProtocolError and re-run the
      operation. PULL retries are idempotent reads; PUSH retries carry the
      same (worker_id, seq) and the server applies them at most once.
    * `heartbeat_interval`: run a daemon thread heartbeating on a SECOND
      socket (the main socket can block legitimately under PUSH
      backpressure and must not carry liveness).
    * `worker_id`: stable identity across reconnects; None lets the server
      assign one at HELLO.
    * `fault_injector` (`common.resilience.FaultInjector`): deterministic
      fault sites `client.connect`, `client.pull`, `client.pull.sent`,
      `client.push`, `client.push.sent`, `client.done`,
      `client.heartbeat` — a sever rule closes the real socket so the
      injected fault exercises the REAL reconnect path.
    """

    def __init__(self, host, port, connect_timeout=120.0, retry_policy=None,
                 worker_id=None, heartbeat_interval=None,
                 fault_injector=None):
        self._host = host
        self._port = port
        self._connect_timeout = connect_timeout
        self._retry = retry_policy
        self._injector = fault_injector
        self.worker_id = None if worker_id is None else int(worker_id)
        self.reconnects = 0
        self._push_seq = 0
        self._sock = None
        self._hb_stop = threading.Event()
        self._hb_thread = None
        self._connect()
        if heartbeat_interval:
            self._hb_interval = float(heartbeat_interval)
            self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                               daemon=True)
            self._hb_thread.start()

    # -- connection management -----------------------------------------
    def _fault(self, site):
        if self._injector is not None:
            self._injector.fire(site, on_sever=self._sever)

    def _sever(self):
        """Drop the main connection (fault-injection sever callback and
        internal teardown after a stream error — a desynced stream can
        never be reused)."""
        s, self._sock = self._sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _raw_connect(self):
        self._fault("client.connect")
        sock = socket.create_connection((self._host, self._port),
                                        timeout=self._connect_timeout)
        # operations run UNBOUNDED: a PUSH ack legitimately blocks while
        # the server inbox is full (that block IS the backpressure
        # contract) — an op timeout here would kill healthy workers.
        # SO_KEEPALIVE still detects a silently-dead peer (host power
        # loss / partition produces no FIN, and recv would hang forever)
        sock.settimeout(None)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        try:
            proposed = -1 if self.worker_id is None else int(self.worker_id)
            _send_msg(sock, OP_HELLO, struct.pack("<q", proposed))
            op, payload = _recv_msg(sock)
            self._expect(op, OP_HELLO, "HELLO")
            (wid,) = struct.unpack_from("<Q", payload, 0)
            last_seq = (struct.unpack_from("<Q", payload, 8)[0]
                        if len(payload) >= 16 else 0)
        except BaseException:
            sock.close()
            raise
        self.worker_id = int(wid)     # identity survives reconnects
        # resume seq numbering above what the server already applied for
        # this id (a RESTARTED process reusing its worker_id must not
        # collide with its previous life's seqs — they would dedup as
        # duplicates and silently discard real gradients). max(): a mid-
        # retry reconnect keeps the in-flight seq's dedup semantics.
        self._push_seq = max(self._push_seq, int(last_seq))
        self._sock = sock

    def _connect(self):
        if self._retry is None:
            return self._raw_connect()
        return self._retry.call(self._raw_connect, on_retry=self._log_retry)

    @staticmethod
    def _log_retry(attempt, exc, delay):
        log.warning("ps client: %s — retrying (attempt %d) after %.2fs",
                    exc, attempt + 1, delay)

    def _call(self, fn):
        """Run one framed operation, reconnecting-with-backoff between
        attempts when a retry policy is configured."""
        def attempt():
            if self._sock is None:
                self._raw_connect()
                self.reconnects += 1
            try:
                return fn()
            except NonRetryableError:
                raise               # stream is consistent; keep it
            except (ConnectionError, OSError):
                self._sever()       # broken/desynced stream: force re-dial
                raise
        if self._retry is None:
            return attempt()
        return self._retry.call(attempt, on_retry=self._log_retry)

    @staticmethod
    def _expect(op, want, what):
        # explicit raise, not assert: protocol checks must survive
        # python -O in a deployed worker
        if op != want:
            raise ProtocolError(f"expected {what} reply (op {want}), "
                                f"got op {op}")

    # -- operations ----------------------------------------------------
    def pull(self):
        """-> (param_leaves, state_leaves_or_None, version)"""
        def op():
            self._fault("client.pull")
            _send_msg(self._sock, OP_PULL)
            self._fault("client.pull.sent")
            op_, payload = _recv_msg(self._sock)
            self._expect(op_, OP_PULL, "PULL")
            (version,) = struct.unpack_from("<Q", payload, 0)
            leaves, off = unpack_leaves(payload, 8)
            state = None
            if payload[off] == 1:
                state, _ = unpack_leaves(payload, off + 1)
            return leaves, state, version
        return self._call(op)

    def push(self, grad_leaves, score, version, state_leaves=None):
        self._push_seq += 1
        seq = self._push_seq          # same seq on every retry -> dedup
        body = [struct.pack("<Q", version), struct.pack("<d", float(score)),
                pack_leaves(grad_leaves)]
        if state_leaves is not None:
            body.append(b"\x01")
            body.append(pack_leaves(state_leaves))
        else:
            body.append(b"\x00")
        packed = b"".join(body)

        def op():
            self._fault("client.push")
            _send_msg(self._sock, OP_PUSH,
                      struct.pack("<QQ", self.worker_id, seq) + packed)
            self._fault("client.push.sent")
            op_, ack = _recv_msg(self._sock)
            self._expect(op_, OP_PUSH, "PUSH")
            if ack != _ACK:
                raise ServerRefusedError(
                    "server refused the push (accumulator stopped) — "
                    "gradient was discarded")
        return self._call(op)

    def stats(self):
        def op():
            _send_msg(self._sock, OP_STATS)
            op_, payload = _recv_msg(self._sock)
            self._expect(op_, OP_STATS, "STATS")
            return json.loads(payload.decode())
        return self._call(op)

    def done(self):
        """Graceful shutdown handshake; stops heartbeats first so the
        server never reaps a worker that is mid-DONE."""
        self._stop_heartbeat()

        def op():
            self._fault("client.done")
            _send_msg(self._sock, OP_DONE,
                      struct.pack("<Q", self.worker_id))
            op_, ack = _recv_msg(self._sock)
            self._expect(op_, OP_DONE, "DONE")
            if ack != _ACK:
                raise ProtocolError("DONE not acknowledged")
        self._call(op)
        self._sever()

    def close(self):
        """Abrupt teardown WITHOUT the DONE handshake — exactly what a
        crashed worker looks like to the server (heartbeats stop, the
        connection drops); the server's heartbeat reaper handles the
        rest. Also the fault-injection hook for killing a worker."""
        self._stop_heartbeat()
        self._sever()

    kill = close

    # -- heartbeats ----------------------------------------------------
    def _stop_heartbeat(self):
        self._hb_stop.set()
        t = self._hb_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)
        self._hb_thread = None

    def _heartbeat_loop(self):
        sock = None
        while not self._hb_stop.wait(self._hb_interval):
            try:
                if sock is None:
                    sock = socket.create_connection(
                        (self._host, self._port),
                        timeout=self._connect_timeout)
                    sock.settimeout(None)
                    _send_msg(sock, OP_HELLO,
                              struct.pack("<q", int(self.worker_id)))
                    op_, _payload = _recv_msg(sock)
                    if op_ != OP_HELLO:
                        raise ProtocolError("bad HELLO reply on heartbeat "
                                            "socket")
                self._fault("client.heartbeat")
                _send_msg(sock, OP_HEARTBEAT,
                          struct.pack("<Q", int(self.worker_id)))
                op_, _ack = _recv_msg(sock)
                if op_ != OP_HEARTBEAT:
                    raise ProtocolError("bad HEARTBEAT reply")
                from ..obs.registry import default_registry
                default_registry().counter("ps.client.heartbeats").inc()
            except OSError:
                # heartbeats are best-effort: drop the socket and re-dial
                # on the next tick; the server only reaps after a full
                # heartbeat_timeout of SILENCE
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


# -- worker loop ------------------------------------------------------------

def ps_worker_fit(net, host, port, data, num_epochs=1, seed=0,
                  retry_policy=None, heartbeat_interval=None,
                  worker_id=None, fault_injector=None):
    """The PS worker loop against a REMOTE master: pull snapshot, compute
    gradients with the network's grad fn on its device, push; the same
    math as the in-process `ParameterServerParallelWrapper` worker
    threads. `net` provides the architecture, the device and the layer
    state when the master sends none; its own parameters are never read.
    The resilience kwargs are forwarded to `PSClient`."""
    from .parameter_server import _ps_fns, batch_generator, ps_batch

    net._ensure_init()
    grad_fn = _ps_fns(net)[0]
    client = PSClient(host, port, retry_policy=retry_policy,
                      heartbeat_interval=heartbeat_interval,
                      worker_id=worker_id, fault_injector=fault_injector)
    step = 0
    for _ in range(num_epochs):
        data.reset()
        while data.has_next():
            ds = next_processed(data)
            pleaves, sleaves, version = client.pull()
            params = params_from_leaves(net, pleaves)
            state = (state_from_leaves(net, sleaves)
                     if sleaves is not None else None)
            batch = ps_batch(net, ds, batch_generator(net, seed, step))
            grads, score, new_state, _ = grad_fn(params, state, batch)
            client.push(param_leaves(net, grads), float(score), version,
                        state_leaves(net, new_state))
            step += 1
    stats = client.stats()
    client.done()
    return stats
