"""Serving wire protocol: replicas behind a REAL process/socket
boundary.

The port's copy of deeplearning4j_tpu/serving/wire.py, held against it by
tests/test_torch_wire.py: the frames, the op table, the dedup registry,
the sender thread, the heartbeat socket and the epoch fencing are the
reference's, and a frame from either package's client is served by
either package's server. The two places that touch parameters, the
SWAP client (`RemoteReplica.swap`) and server (`ReplicaServer.
_apply_swap`), list `(aux, blocks)` through the transformer's
`tree_leaves` / `params_from_leaves` in the reference's leaf order and
layout; the receiving side moves each leaf to the serving model's device
before `swap()`. The text below is the reference's, less its history
notes.

The in-process `FleetManager` proved the control loop — autoscale, canary,
crash survival — but every replica was an in-process object, so
"replica death" was a Python exception and "migration" a dict handoff.
This module is the transport half: the SAME router/failover/drain
machinery now runs against replicas that live behind a length-prefixed
TCP protocol, where a severed socket, a hung process, and a reaped
heartbeat are genuinely different failures from a raised exception.

Two halves, mirroring `parallel/ps_transport.py`'s server/client split
(whose framing, HELLO-identity, dedicated-heartbeat-socket, and
at-most-once-dedup discipline this module deliberately reuses — the
parameter-server lineage, Li et al. OSDI'14):

  * `ReplicaServer` — wraps ONE started `ContinuousDecodeServer`
    behind a listener. Every client frame carries a client-unique id;
    SUBMIT/MIGRATE_IN register the id in a request registry, so a
    RETRIED frame (reconnect after a lost ack) re-attaches to the
    original request instead of decoding twice (at-most-once — the PS
    transport's (worker, seq) dedup, generalized to string ids), and a
    finished request's result is RE-DELIVERED to the new connection.
    Results are pushed asynchronously as STREAM frames by a dedicated
    sender thread — a stalled client's TCP backpressure must never
    block the decode serve thread (whose done-callbacks only enqueue).
  * `RemoteReplica` — the client that plugs into `FleetManager`
    wherever an in-process `ContinuousDecodeServer` does: the same
    `submit/drain/migrate_in/kill/stop/alive/metrics` surface, with
    every verb crossing the wire. A broken connection reconnects under
    a `RetryPolicy` and RE-SENDS every unresolved in-flight frame
    (`wire_reconnects` / `wire_retries` counted); retry exhaustion
    marks the replica DEAD and fails every pending future with
    `ReplicaDeadError` — exactly the signal the manager's failover
    path replays prompts on. Liveness rides a DEDICATED heartbeat
    socket (the main socket legitimately stalls under big MIGRATE
    payloads): ack silence past `heartbeat_timeout` flips `alive`
    False and the manager's health probe reaps the replica — a HUNG
    process is reaped the same way a crashed one is.

Op table (each frame is `u32 len | u8 op | u32 hdr_len | hdr_json |
blob`; the blob carries artifact/param bytes, the JSON header
everything else):

    HELLO        identity + capabilities (instance, paged, block_size)
    SUBMIT       enqueue one decode request        -> ack, then STREAM
    STREAM       server-pushed result/error for a registered id
    CANCEL       drop interest in an id (purges the registry entry)
    DRAIN        drain(migrate=) the whole replica -> artifacts + specs
    MIGRATE_OUT  export one live request's KV state as artifact bytes
    MIGRATE_IN   adopt an artifact (tag-checked)   -> ack, then STREAM
    SNAPSHOT     kind_snapshot + alive + instance (metrics federation)
    SWAP         hot-swap params (leaves packed like a PS PUSH)
    HEARTBEAT    liveness ping (dedicated socket)
    STOP / KILL  graceful stop (drain semantics) / abrupt death

Failure classification over the wire (the fleet manager's verdict
table, serialized): an ERROR header names the exception class and the
client re-raises the REAL type — request-level verdicts
(`DeadlineExceededError`, `ServerOverloadedError`,
`UnhealthyOutputError`, `ValueError`) propagate to the caller's future
as-is; handoff markers (`RequestMigratedError`, `RequestDrainedError`)
mean the request's state moved; everything else — including an unknown
remote type (`WireRemoteError`) and every transport death — is
infrastructure, and the manager fails over by prompt replay
(deterministic greedy decode ⇒ the replayed stream is bit-identical
to an uninterrupted run). A destination that REFUSES a migration
(version tag, layout, overload) degrades to replay the same way:
correct bits either way, never a lost request.

Fault-injection sites (client side, `common.resilience.FaultInjector`):

    serve.wire.submit     fires between a SUBMIT's send and its ack —
                          a sever here IS the dropped-ACK scenario:
                          the server decoded, the ack died with the
                          connection, and the retried SUBMIT must
                          dedup (one decoded stream, one wire_retries)
    serve.wire.stream     fires as a STREAM frame arrives — a sever
                          drops the result mid-stream; reconnect +
                          re-SUBMIT re-delivers without re-decoding
    serve.wire.migrate    fires on DRAIN / MIGRATE_IN / MIGRATE_OUT
    serve.wire.heartbeat  fires per heartbeat tick — a repeated sever
                          is heartbeat SILENCE: `alive` decays and the
                          router reaps

Zero-dispatch pin: everything here is host-side socket plumbing — the
no-fault cross-process path adds ZERO device dispatches per token over
the same fleet in-process (tests/test_wire.py, dispatch-counter A/B).
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
import json
import logging
import os
import queue
import socket
import struct
import threading
import time

from ..common.resilience import (FaultInjected, RetryBudgetExhaustedError,
                                 RetryPolicy)
from .kvstate import (KVStateError, KVStateVersionError,
                      PrefixCacheArtifact, RequestArtifact)
from .server import (DeadlineExceededError, ReplicaDeadError,
                     RequestDrainedError, RequestMigratedError,
                     ServerClosedError, ServerOverloadedError,
                     ServingError, UnhealthyOutputError, _fail_future,
                     _ParamsView)

log = logging.getLogger(__name__)

__all__ = ["ReplicaServer", "RemoteReplica", "StaleEpochError",
           "WireProtocolError", "WireRemoteError", "run_replica_server"]

OP_HELLO = 1
OP_SUBMIT = 2
OP_STREAM = 3
OP_CANCEL = 4
OP_DRAIN = 5
OP_MIGRATE_OUT = 6
OP_MIGRATE_IN = 7
OP_SNAPSHOT = 8
OP_SWAP = 9
OP_HEARTBEAT = 10
OP_STOP = 11
OP_KILL = 12
OP_PREFIX_PULL = 13     # fleet prefix tier: export a resident chain
OP_PREFIX_PUSH = 14     # fleet prefix tier: adopt a peer's chain

# control-plane ops a stale-epoch manager is fenced out of (tentpole
# of the durable control plane): everything that mutates the replica's lifecycle
# or params. Data-plane ops (SUBMIT/CANCEL/SNAPSHOT/MIGRATE_IN, the
# PREFIX tier) stay open — a zombie manager's in-flight REQUESTS still
# resolve; only its authority over the replica is revoked. The prefix
# ops are data-plane by the same rule: a pull moves CACHE bytes, never
# lifecycle or params, and a stale artifact is refused by its version
# tag, not by epoch fencing.
_FENCED_OPS = frozenset((OP_DRAIN, OP_MIGRATE_OUT, OP_SWAP,
                         OP_STOP, OP_KILL))


class WireProtocolError(ConnectionError):
    """Malformed/unexpected wire frame. Subclasses ConnectionError so
    a desynced stream is treated like a broken one: reconnect and
    re-run the (deduped) operations — the PS transport rule."""


class WireRemoteError(ServingError):
    """The replica reported an exception type this client does not
    know. Deliberately NOT a request-level verdict: the fleet
    manager's classification table treats it as infrastructure and
    fails over by prompt replay — an unknown failure must never be
    silently delivered as the request's outcome."""


class StaleEpochError(ServingError):
    """A control-plane op (DRAIN/SWAP/MIGRATE_OUT/STOP/KILL) arrived
    from a manager whose HELLO epoch is OLDER than the highest this
    replica has seen: a zombie predecessor trying to drive a fleet its
    successor owns. The replica refuses loudly (and counts
    `fenced_ops`) instead of obeying — the split-brain guard of the
    durable control plane (serving/fleetjournal.py)."""


# the exception types that survive a wire round-trip AS THEMSELVES —
# the fleet manager's verdict table depends on real types, so the
# ERROR header carries the class name and the client re-raises it
_WIRE_EXCEPTIONS = {cls.__name__: cls for cls in (
    ServingError, ServerOverloadedError, DeadlineExceededError,
    UnhealthyOutputError, ServerClosedError, ReplicaDeadError,
    RequestMigratedError, RequestDrainedError,
    KVStateError, KVStateVersionError, StaleEpochError)}
_WIRE_EXCEPTIONS["ValueError"] = ValueError


def _exc_to_hdr(exc):
    return {"error": type(exc).__name__, "message": str(exc)}


def _exc_from_hdr(hdr):
    cls = _WIRE_EXCEPTIONS.get(hdr.get("error"), WireRemoteError)
    msg = hdr.get("message", "")
    if cls is WireRemoteError:
        msg = f"{hdr.get('error')}: {msg}"
    return cls(msg)


# -- framing ----------------------------------------------------------------

def _close_sock(sock):
    """shutdown-then-close: a bare close() does NOT reliably wake a
    recv() blocked in another thread — shutdown(SHUT_RDWR) does, and
    the severed reader is exactly who must notice first."""
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _recv_exact(sock, n):
    chunks = []
    while n:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("peer closed")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _frame(op, hdr, blob=b""):
    h = json.dumps(hdr).encode()
    return struct.pack("<IBI", 5 + len(h) + len(blob), op, len(h)) \
        + h + blob


def _send_frame(sock, op, hdr, blob=b""):
    sock.sendall(_frame(op, hdr, blob))


def _recv_frame(sock):
    (length,) = struct.unpack("<I", _recv_exact(sock, 4))
    if length < 5:
        raise WireProtocolError(f"short frame ({length} bytes)")
    body = _recv_exact(sock, length)
    op = body[0]
    (hlen,) = struct.unpack_from("<I", body, 1)
    if 5 + hlen > length:
        raise WireProtocolError("frame header overruns frame")
    try:
        hdr = json.loads(body[5:5 + hlen].decode())
    except ValueError as e:
        raise WireProtocolError(f"bad frame header: {e}") from e
    return op, hdr, body[5 + hlen:]


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------
class _Conn:
    __slots__ = ("sock", "wlock", "peer", "epoch")

    def __init__(self, sock):
        self.sock = sock
        self.wlock = threading.Lock()
        self.epoch = None    # manager epoch announced by this
        #                      connection's HELLO (None = legacy
        #                      client, unfenced)
        try:
            self.peer = sock.getpeername()
        except OSError:
            self.peer = None

    def send(self, op, hdr, blob=b""):
        with self.wlock:
            # graftlint: disable=lock-discipline -- wlock is this connection's dedicated write mutex (frame interleaving guard); it never nests another lock and a stalled peer blocks only this connection's writers
            _send_frame(self.sock, op, hdr, blob)


class _Entry:
    """One registered request: the decode server's future plus the
    connection its STREAM frame should land on, re-pointed by retried
    frames. `attempt` orders the re-pointing: the client bumps it per
    resend, and only an equal-or-NEWER attempt may move delivery — a
    STALE original frame (still buffered on the severed connection,
    read after the retry landed on the fresh one) must never point the
    result back at the dead socket."""

    __slots__ = ("rid", "future", "conn", "attempt")

    def __init__(self, rid, future, conn, attempt=0):
        self.rid = rid
        self.future = future
        self.conn = conn
        self.attempt = attempt


class ReplicaServer:
    """Socket front end over one `ContinuousDecodeServer` (module
    docstring: op table, dedup registry, async delivery).

    `server` may be started or not (the wrapper starts it). The
    listener binds `host:port` (port 0 = ephemeral; read `.port`).
    In-thread use (tests, same-process fleets over a real loopback
    wire) keeps a handle to both; cross-process use runs
    `run_replica_server` in the child and talks only through
    `RemoteReplica`."""

    # completed registry entries kept for re-delivery; beyond this the
    # oldest DONE entries are pruned (a client that never reconnects
    # must not grow the registry without bound)
    _REGISTRY_CAP = 4096

    def __init__(self, server, host="127.0.0.1", port=0):
        self.server = server
        if not server._running and not getattr(server, "_killed", False):
            server.start()
        self._lock = threading.Lock()
        self._registry = collections.OrderedDict()   # rid -> _Entry
        self._rpc_cache = collections.OrderedDict()  # rid -> reply frame
        self._rpc_cache_bytes = 0
        self._client_ids = itertools.count()
        self._closed = False
        self.killed = False
        self.epoch_seen = 0   # highest manager epoch HELLO'd to this
        #   replica; control frames from an older epoch are fenced
        self._start_time = time.time()   # wire-front-end birth: the
        #   identity re-adoption verifies alongside pid, so a recycled
        #   port owned by a DIFFERENT incarnation is refused
        self.pause_heartbeats = False    # chaos hook: a HUNG process —
        #   the main socket still answers but liveness goes silent, and
        #   the client's heartbeat-timeout reap is the only way out
        self._stop_evt = threading.Event()
        self._sendq = queue.Queue()
        self._sender = threading.Thread(target=self._send_loop,
                                        name="wire-sender", daemon=True)
        self._sender.start()
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self._accept = threading.Thread(target=self._accept_loop,
                                        name="wire-accept", daemon=True)
        self._accept.start()

    # -- lifecycle -----------------------------------------------------
    def serve_forever(self, timeout=None):
        """Block until a STOP/KILL/DRAIN frame shuts the replica down
        (the cross-process child's main loop). Returns True when the
        shutdown was a graceful one (trace-saving is appropriate),
        False after KILL (a crash persists nothing)."""
        self._stop_evt.wait(timeout)
        self.close(stop_server=False)    # STOP/DRAIN already stopped it
        return not self.killed

    def close(self, stop_server=True):
        """Tear the wire front end down (listener + sender); with
        `stop_server`, also stop the decode server underneath."""
        self._closed = True
        self._stop_evt.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._sendq.put(None)            # unblock the sender
        if stop_server and self.server._running:
            try:
                self.server.stop(drain=True)
            except Exception:   # noqa: BLE001 — teardown finishes
                log.exception("decode server stop failed at close()")

    # -- delivery ------------------------------------------------------
    def _send_loop(self):
        """THE delivery thread: future done-callbacks (which run on the
        decode serve thread) only ever enqueue here — a stalled
        client's TCP backpressure can never block an iteration."""
        while True:
            item = self._sendq.get()
            try:
                if item is None:
                    return
                conn, op, hdr, blob = item
                try:
                    conn.send(op, hdr, blob)
                except OSError:
                    # client gone: the result stays in the registry
                    # and is re-delivered when the reconnecting client
                    # re-SUBMITs
                    pass
            finally:
                # every item is accounted (sentinel included) so the
                # STOP handler's join() below can never deadlock
                self._sendq.task_done()

    def _stream_frame(self, entry):
        fut = entry.future
        if fut.cancelled():
            hdr = {"id": entry.rid, "error": "CancelledError",
                   "message": "request cancelled on the replica"}
        else:
            exc = fut.exception()
            if exc is not None:
                hdr = dict(_exc_to_hdr(exc), id=entry.rid)
            else:
                hdr = {"id": entry.rid,
                       "tokens": [int(t) for t in fut.result()]}
        return hdr

    def _queue_delivery(self, entry):
        conn = entry.conn
        if conn is None:
            return
        self._sendq.put((conn, OP_STREAM, self._stream_frame(entry), b""))

    def _register_or_dedup(self, rid, conn, call, attempt=0):
        """ATOMIC dedup-or-create: the registry lookup, the decode
        submit, and the insert happen under ONE lock — a retried frame
        racing the original's handler thread (read the frame, about to
        submit) must block here and then find the entry, never
        double-submit. Returns (entry, created, exc): a synchronous
        verdict from `call` comes back as `exc` with nothing
        registered."""
        with self._lock:
            entry = self._registry.get(rid)
            if entry is not None:
                return entry, False, None
            try:
                future = call()
            except BaseException as e:  # noqa: BLE001 — verdict crosses
                return None, False, e
            entry = _Entry(rid, future, conn, attempt=attempt)
            self._registry[rid] = entry
            # prune: oldest DONE entries beyond the cap (generator, no
            # full-dict copy — this runs under the dispatch lock on
            # every insert once the cap is reached)
            while len(self._registry) > self._REGISTRY_CAP:
                victim = next((k for k, e in self._registry.items()
                               if e.future.done()), None)
                if victim is None:
                    break
                del self._registry[victim]
        future.add_done_callback(lambda _f: self._queue_delivery(entry))
        return entry, True, None

    def _dedup_repoint(self, entry, conn, attempt, op):
        """The dedup branch's delivery half: an equal-or-newer attempt
        re-points delivery at this connection and re-pushes a finished
        result; a STALE frame only gets its (harmless) dup-ack."""
        with self._lock:
            if attempt >= entry.attempt:
                entry.attempt = attempt
                entry.conn = conn
                repoint = True
            else:
                repoint = False
        try:
            conn.send(op, {"id": entry.rid, "ok": True, "dup": True})
        except OSError:
            pass    # a stale frame's conn is usually already dead
        if repoint and entry.future.done():
            self._queue_delivery(entry)

    # -- connection handling -------------------------------------------
    def _accept_loop(self):
        while True:
            try:
                sock, _ = self._sock.accept()
            except OSError:              # listener closed
                return
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            t = threading.Thread(target=self._serve_conn,
                                 args=(_Conn(sock),),
                                 name="wire-conn", daemon=True)
            t.start()

    def _serve_conn(self, conn):
        try:
            with conn.sock:
                while not self._closed:
                    try:
                        op, hdr, blob = _recv_frame(conn.sock)
                    except (ConnectionError, OSError):
                        return
                    if not self._dispatch(conn, op, hdr, blob):
                        return
        except Exception:   # noqa: BLE001 — one bad client never kills serve
            log.exception("wire connection handler failed")

    def _reply_cached(self, conn, rid):
        with self._lock:
            frame = self._rpc_cache.get(rid)
        if frame is None:
            return False
        with conn.wlock:
            # graftlint: disable=lock-discipline -- the _Conn.send write-mutex rule: cached frames bypass the header re-encode but must still serialize with the sender thread's frames on this socket
            conn.sock.sendall(frame)
        return True

    # the rpc reply cache is bounded by BYTES as well as count:
    # MIGRATE_OUT/DRAIN replies embed whole KV-panel blobs (the blob
    # is load-bearing — a retried op after a lost ack can only get the
    # artifact from here, the request already left the slot), so a
    # count-only cap would pin arbitrarily many megabytes on a
    # long-lived replica under migration churn
    _RPC_CACHE_MAX = 256
    _RPC_CACHE_MAX_BYTES = 32 << 20

    def _cache_reply(self, rid, op, hdr, blob=b""):
        frame = _frame(op, hdr, blob)
        with self._lock:
            self._rpc_cache[rid] = frame
            self._rpc_cache_bytes += len(frame)
            while self._rpc_cache and len(self._rpc_cache) > 1 and (
                    len(self._rpc_cache) > self._RPC_CACHE_MAX
                    or self._rpc_cache_bytes
                    > self._RPC_CACHE_MAX_BYTES):
                _, old = self._rpc_cache.popitem(last=False)
                self._rpc_cache_bytes -= len(old)
        return frame

    def _dispatch(self, conn, op, hdr, blob):
        """Handle one frame; returns False to close the connection."""
        srv = self.server
        rid = hdr.get("id")
        if op == OP_HELLO:
            cid = hdr.get("client_id")
            if not cid:
                cid = f"c{next(self._client_ids)}"
            epoch = hdr.get("epoch")
            if epoch is not None:
                conn.epoch = int(epoch)
                with self._lock:
                    delta = max(0, conn.epoch - self.epoch_seen)
                    self.epoch_seen = max(self.epoch_seen, conn.epoch)
                if delta:
                    # the manager_epoch counter IS the highest manager
                    # generation served (bumped by delta: monotone,
                    # fleet-summable, equals epoch_seen)
                    try:
                        srv.metrics.count("manager_epoch", delta)
                    except Exception:  # noqa: BLE001 — counting never
                        pass           # breaks the handshake
            conn.send(OP_HELLO, {
                "client_id": cid,
                "instance": getattr(srv, "instance", None),
                "pid": os.getpid(),
                "start_time": self._start_time,
                "epoch": self.epoch_seen,
                "paged": bool(getattr(srv, "paged", False)),
                "block_size": getattr(srv, "_block_size", None)})
            return True
        if op == OP_HEARTBEAT:
            if not self.pause_heartbeats:
                conn.send(OP_HEARTBEAT, {"id": rid, "ok": True})
            return True
        if op in _FENCED_OPS and conn.epoch is not None \
                and conn.epoch < self.epoch_seen:
            # epoch fence: refuse loudly with the typed error — the
            # stale manager's caller re-raises StaleEpochError and its
            # degrade paths (replay, crash accounting) keep every
            # request; obeying would hand the replica to a zombie
            try:
                srv.metrics.count("fenced_ops")
            except Exception:   # noqa: BLE001 — counting never fences
                pass
            conn.send(op, dict(_exc_to_hdr(StaleEpochError(
                f"op {op} refused: connection epoch {conn.epoch} < "
                f"highest seen {self.epoch_seen}")), id=rid))
            return True
        if op == OP_SUBMIT:
            attempt = int(hdr.get("attempt", 0))
            entry, created, err = self._register_or_dedup(
                rid, conn,
                lambda: srv.submit(hdr["prompt"], hdr["max_new"],
                                   deadline_ms=hdr.get("deadline_ms"),
                                   klass=hdr.get("klass", "default")),
                attempt=attempt)
            if err is not None:
                conn.send(OP_SUBMIT, dict(_exc_to_hdr(err), id=rid))
                return True
            if not created:
                # the at-most-once rule: a retried SUBMIT after a lost
                # ack re-attaches — never decodes twice — and an
                # equal-or-newer attempt re-points delivery + re-pushes
                # a finished result (a STALE original frame read off
                # the severed connection AFTER the retry must not point
                # the result back at the dead socket)
                self._dedup_repoint(entry, conn, attempt, OP_SUBMIT)
                return True
            conn.send(OP_SUBMIT, {"id": rid, "ok": True})
            return True
        if op == OP_STREAM:
            return True                  # clients never push streams
        if op == OP_CANCEL:
            with self._lock:
                entry = self._registry.pop(rid, None)
            if entry is not None:
                entry.conn = None        # drop delivery interest
                entry.future.cancel()    # no-op once running
            conn.send(OP_CANCEL, {"id": rid, "ok": True})
            return True
        if op == OP_MIGRATE_IN:
            def _adopt():
                art = RequestArtifact.from_bytes(blob)
                return srv.migrate_in(art,
                                      deadline_ms=hdr.get("deadline_ms"))
            attempt = int(hdr.get("attempt", 0))
            entry, created, err = self._register_or_dedup(
                rid, conn, _adopt, attempt=attempt)
            if err is not None:
                if self._reply_cached(conn, rid):
                    return True     # cached REFUSAL (retried blob-less
                    #                 frame re-raised locally — the
                    #                 first verdict stands)
                reply = dict(_exc_to_hdr(err), id=rid)
                self._cache_reply(rid, OP_MIGRATE_IN, reply)
                conn.send(OP_MIGRATE_IN, reply)
                return True
            if not created:
                # retried MIGRATE_IN after a lost ack: the SUBMIT dedup
                # rule — attempt-ordered re-point + re-push (a cached
                # reply alone would strand the stream on a dead socket)
                self._dedup_repoint(entry, conn, attempt, OP_MIGRATE_IN)
                return True
            conn.send(OP_MIGRATE_IN, {"id": rid, "ok": True})
            return True
        if op == OP_MIGRATE_OUT:
            if self._reply_cached(conn, rid):
                return True
            with self._lock:
                entry = self._registry.get(hdr.get("rid"))
            try:
                if entry is None:
                    raise KVStateError(
                        f"no request {hdr.get('rid')!r} on this replica")
                art = srv.migrate_out(entry.future,
                                      timeout=hdr.get("timeout", 30.0))
            except BaseException as e:  # noqa: BLE001
                reply = dict(_exc_to_hdr(e), id=rid)
                self._cache_reply(rid, OP_MIGRATE_OUT, reply)
                conn.send(OP_MIGRATE_OUT, reply)
                return True
            data = art.to_bytes()
            self._cache_reply(rid, OP_MIGRATE_OUT,
                              {"id": rid, "ok": True}, data)
            conn.send(OP_MIGRATE_OUT, {"id": rid, "ok": True}, data)
            return True
        if op == OP_PREFIX_PULL:
            # fleet prefix tier, SOURCE side: ship the resident chain
            # covering the requested key. Idempotent and side-effect
            # free on this replica (the blocks stay resident), so no
            # reply cache — a retried pull just re-extracts.
            try:
                art = srv.prefix_export(
                    tuple(hdr.get("key") or ()),
                    max_bytes=hdr.get("max_bytes"),
                    timeout=hdr.get("timeout", 30.0))
            except BaseException as e:  # noqa: BLE001 — verdict crosses
                conn.send(OP_PREFIX_PULL, dict(_exc_to_hdr(e), id=rid))
                return True
            if art is None:
                conn.send(OP_PREFIX_PULL,
                          {"id": rid, "ok": True, "found": False})
                return True
            conn.send(OP_PREFIX_PULL,
                      {"id": rid, "ok": True, "found": True},
                      art.to_bytes())
            return True
        if op == OP_PREFIX_PUSH:
            # fleet prefix tier, SINK side: adopt a peer's exported
            # chain. Idempotent too — an already-indexed key adopts
            # zero blocks — and the refusal verdict (version tag) is
            # recomputed identically on a retry, so no reply cache.
            try:
                art = PrefixCacheArtifact.from_bytes(blob)
                n = srv.prefix_adopt(art,
                                     timeout=hdr.get("timeout", 30.0))
            except BaseException as e:  # noqa: BLE001 — verdict crosses
                conn.send(OP_PREFIX_PUSH, dict(_exc_to_hdr(e), id=rid))
                return True
            conn.send(OP_PREFIX_PUSH,
                      {"id": rid, "ok": True, "adopted": int(n)})
            return True
        if op == OP_SNAPSHOT:
            conn.send(OP_SNAPSHOT, {
                "id": rid,
                "snapshot": srv.metrics.kind_snapshot(),
                "alive": bool(srv.alive),
                "instance": getattr(srv, "instance", None)})
            return True
        if op == OP_SWAP:
            if self._reply_cached(conn, rid):
                return True
            try:
                self._apply_swap(blob)
            except BaseException as e:  # noqa: BLE001 — verdict crosses
                reply = dict(_exc_to_hdr(e), id=rid)
                self._cache_reply(rid, OP_SWAP, reply)
                conn.send(OP_SWAP, reply)
                return True
            reply = {"id": rid, "ok": True}
            self._cache_reply(rid, OP_SWAP, reply)
            conn.send(OP_SWAP, reply)
            return True
        if op == OP_DRAIN:
            if self._reply_cached(conn, rid):
                return True
            reply_hdr, reply_blob = self._do_drain(hdr)
            self._cache_reply(rid, OP_DRAIN, reply_hdr, reply_blob)
            conn.send(OP_DRAIN, reply_hdr, reply_blob)
            if reply_hdr.get("ok"):
                self._stop_evt.set()     # a drained replica is done
            return True
        if op == OP_STOP:
            try:
                srv.stop(drain=bool(hdr.get("drain", True)),
                         timeout=hdr.get("timeout"))
            except Exception:   # noqa: BLE001 — stop must ack anyway
                log.exception("decode server stop failed over the wire")
            # drained results enqueue via done-callbacks during stop();
            # flush them BEFORE the ack — returning False closes this
            # connection, and an unflushed STREAM frame would fail a
            # future the replica already resolved
            self._sendq.join()
            conn.send(OP_STOP, {"id": rid, "ok": True})
            self._stop_evt.set()
            return False
        if op == OP_KILL:
            self.killed = True
            try:
                srv.kill()
            finally:
                self._stop_evt.set()
            try:
                conn.send(OP_KILL, {"id": rid, "ok": True})
            except OSError:
                pass
            return False
        raise WireProtocolError(f"unknown op {op}")

    def _apply_swap(self, blob):
        from ..models.zoo.transformer import params_from_leaves
        from ..parallel.ps_transport import unpack_leaves
        leaves, _ = unpack_leaves(blob)
        aux, blocks = params_from_leaves(leaves,
                                         self.server.current_params())
        self.server.swap(_ParamsView(aux, blocks))

    def _do_drain(self, hdr):
        srv = self.server
        try:
            migrated, replayed = srv.drain(
                migrate=hdr.get("migrate"),
                timeout=hdr.get("timeout", 60.0))
        except BaseException as e:  # noqa: BLE001 — degrade to crash
            return dict(_exc_to_hdr(e), id=hdr.get("id")), b""
        with self._lock:
            by_fut = {e.future: r for r, e in self._registry.items()}
        now = time.monotonic()
        m_out, blobs = [], []
        for fut, art in migrated:
            data = art.to_bytes()
            m_out.append({"rid": by_fut.get(fut), "nbytes": len(data)})
            blobs.append(data)
        r_out = []
        for fut, spec in replayed:
            dl = spec.get("deadline")
            r_out.append({"rid": by_fut.get(fut),
                          "spec": {"prompt": spec["prompt"],
                                   "max_new": spec["max_new"],
                                   "deadline_ms": (None if dl is None
                                                   else max(0.0, (dl - now)
                                                            * 1e3)),
                                   "klass": spec.get("klass", "default")}})
        # flush queued STREAM deliveries BEFORE the reply goes out: a
        # request that finished just ahead of the drain has its result
        # sitting in the send queue, and the reply overtaking it would
        # make the client tear down (and the manager re-decode) a
        # stream the replica already resolved — the OP_STOP rule
        self._sendq.join()
        return ({"id": hdr.get("id"), "ok": True,
                 "migrated": m_out, "replayed": r_out},
                b"".join(blobs))


def run_replica_server(server, host="127.0.0.1", port=0, port_file=None,
                       tracer=None, trace_out=None, identity_file=None):
    """The cross-process child's main: wrap `server` in a
    `ReplicaServer`, publish the bound port (atomically — a parent
    polls for the file), serve until STOP/KILL/DRAIN, and save the
    tracer's Chrome trace on a GRACEFUL exit (a KILLed replica
    persists nothing — a real crash would not). Returns the wrapper.

    `identity_file` additionally publishes the replica's wire identity
    (host/port/pid/instance/start_time/epoch) as atomic JSON and
    REMOVES it on a graceful exit — so a recovering manager can tell a
    cleanly-stopped replica (file gone: nothing to re-adopt) from a
    crashed or orphaned one (file present: dial and verify)."""
    rs = ReplicaServer(server, host=host, port=port)
    if port_file:
        tmp = str(port_file) + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(str(rs.port))
        os.replace(tmp, str(port_file))
    if identity_file:
        tmp = str(identity_file) + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"host": rs.host, "port": rs.port,
                       "pid": os.getpid(),
                       "instance": getattr(server, "instance", None),
                       "start_time": rs._start_time,
                       "epoch": rs.epoch_seen}, fh)
        os.replace(tmp, str(identity_file))
    graceful = rs.serve_forever()
    if graceful and tracer is not None and trace_out:
        try:
            tracer.save(str(trace_out))
        except Exception:   # noqa: BLE001 — trace is best-effort
            log.exception("trace save failed at replica shutdown")
    if graceful and identity_file:
        try:
            os.remove(str(identity_file))
        except OSError:
            pass    # already gone: the distinguishing bit is absence
    return rs


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------
class _PendingOp:
    __slots__ = ("rid", "op", "hdr", "blob", "ack", "stream", "resend",
                 "attempt", "sent")

    def __init__(self, rid, op, hdr, blob=b"", stream=False, resend=True):
        self.rid = rid
        self.op = op
        self.hdr = hdr
        self.blob = blob
        self.ack = cf.Future()           # resolves (hdr, blob) or exc
        self.stream = cf.Future() if stream else None
        self.resend = resend
        self.attempt = 0                 # bumped per re-sent frame: the
        #                                  server's attempt-ordered
        #                                  delivery re-pointing
        self.sent = False                # first send attempted — only
        #                                  then is the op eligible for
        #                                  reconnect resends (a lazy
        #                                  dial inside _send_op must
        #                                  not resend the op that call
        #                                  is about to send)

    @property
    def done(self):
        if self.stream is not None:
            return self.stream.done()
        return self.ack.done()


class _RemoteMetrics:
    """The `ServingMetrics`-shaped facade the fleet plane reads off a
    remote replica: `kind_snapshot()` fetches fresh state over the
    wire (falling back to the last good snapshot when the wire is
    down — exactly what the manager's counters-only TOMBSTONE needs to
    stay monotone after a death), while `count_value()` reads the
    CACHE only, so the per-tick health probe never multiplies wire
    round-trips by counter key."""

    def __init__(self, replica):
        self._replica = replica
        self._cache = {}

    @property
    def instance(self):
        return self._replica.instance

    @property
    def name(self):
        return self._replica.instance

    def kind_snapshot(self):
        try:
            self._cache = self._replica._fetch_snapshot()
        except Exception:   # noqa: BLE001 — stale beats absent
            pass
        return dict(self._cache)

    def count_value(self, key):
        m = self._cache.get(key)
        if isinstance(m, dict) and m.get("kind") == "counter":
            return m.get("value") or 0
        return 0

    def snapshot(self):
        """The familiar flat snapshot() shape, derived from the latest
        kind snapshot (histograms/summaries as _p50/_p99/_mean/_count
        — `FleetView.flat`'s flattening, reused)."""
        from ..obs.fleet import FleetView
        name = self.instance or "remote"
        return FleetView().add(name, self.kind_snapshot()).flat(name)


class RemoteReplica:
    """`FleetManager`-pluggable client for one `ReplicaServer` (module
    docstring: reconnect-with-resend, heartbeat liveness, failure
    classification).

    `process` (optional) is a Popen-like handle this replica OWNS: its
    exit flips `alive`, `kill()` terminates it, and `stop()` waits for
    it. `counters` is any object with `.count(key, n)` — the fleet
    manager binds its own `ServingMetrics` via `configure_wire()` so
    `wire_reconnects`/`wire_retries` land on the fleet's control-plane
    snapshot."""

    def __init__(self, host, port, name=None, retry_policy=None,
                 heartbeat_interval=0.25, heartbeat_timeout=None,
                 fault_injector=None, counters=None, process=None,
                 connect_timeout=30.0, op_timeout=120.0):
        self._host = host
        self._port = int(port)
        self.name = name
        self.instance = name
        self._retry_is_default = retry_policy is None
        self._retry = retry_policy if retry_policy is not None else \
            RetryPolicy(max_retries=3, base_delay=0.05, max_delay=0.5,
                        jitter=0.0)
        self._injector = fault_injector
        self._counters = counters
        self._process = process
        self._connect_timeout = float(connect_timeout)
        self._op_timeout = float(op_timeout)
        self._client_id = None
        self._paged = False
        self._block_size = None
        self._epoch = None    # manager epoch announced in HELLO once
        #                       configure_wire(epoch=) sets it
        self.pid = None       # replica identity off the HELLO reply:
        self.start_time = None   # recovery verifies these against the
        #                       journal before re-adopting a port
        self._ids = itertools.count()
        self._pending = {}               # rid -> _PendingOp
        self._plock = threading.Lock()
        self._wlock = threading.Lock()   # serializes main-socket sends
        self._conn_lock = threading.RLock()
        self._rc_lock = threading.Lock()  # one reconnector at a time
        self._sock = None
        self._gen = 0
        self._ever_connected = False
        self._dead = False
        self._dead_exc = None
        self._closed = False
        self._running = True             # the fleet-manager contract
        self.metrics = _RemoteMetrics(self)
        # heartbeat state: a dedicated socket, like the PS client's —
        # the main socket legitimately stalls under MIGRATE payloads
        self._hb_interval = (None if not heartbeat_interval
                             else float(heartbeat_interval))
        self.heartbeat_timeout = (None if heartbeat_timeout is None
                                  else float(heartbeat_timeout))
        self._hb_last_ok = time.monotonic()
        self._hb_stop = threading.Event()
        self._hb_thread = None
        # first dial is LOUD: an unreachable replica fails the factory
        self._retry.call(self._dial_once)
        if self._hb_interval:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, name="wire-heartbeat",
                daemon=True)
            self._hb_thread.start()

    # -- fleet-manager surface ----------------------------------------
    def start(self):
        return self

    def configure_wire(self, heartbeat_timeout=None, retry_policy=None,
                       counters=None, epoch=None):
        """Fleet-manager hook (`FleetManager._spawn`): fill in
        fleet-level wire config the factory left unset — the manager's
        `heartbeat_timeout`, its failover `RetryPolicy`, its
        `ServingMetrics` as the wire-counter sink, and its `epoch`
        (announced to the replica so stale-manager fencing engages)."""
        if counters is not None:
            self._counters = counters
        if retry_policy is not None and self._retry_is_default:
            # only replace the built-in default, never an explicit one
            self._retry = retry_policy
            self._retry_is_default = False
        if heartbeat_timeout is not None and \
                self.heartbeat_timeout is None:
            self.heartbeat_timeout = float(heartbeat_timeout)
        if epoch is not None and epoch != self._epoch:
            self._epoch = int(epoch)
            self._announce_epoch()
        return self

    def _announce_epoch(self):
        """Best-effort re-HELLO on the LIVE main connection with the
        newly configured epoch (future dials carry it in their opening
        HELLO). The reply matches no pending op and falls through
        `_on_reply` harmlessly — only the server-side `epoch_seen`
        bump matters."""
        try:
            with self._conn_lock:
                sock = self._sock
            if sock is None:
                return    # the next dial's HELLO announces it
            with self._wlock:
                # graftlint: disable=lock-discipline -- _wlock is the main socket's dedicated write mutex (the _send_op rule); it never nests another lock
                _send_frame(sock, OP_HELLO,
                            {"client_id": self._client_id,
                             "epoch": self._epoch})
        except OSError:
            pass    # broken wire: the reconnect dial re-announces

    @property
    def paged(self):
        return self._paged

    @property
    def alive(self):
        """The router's liveness probe: dead wire, exited process, or
        heartbeat-ack silence past `heartbeat_timeout` all read False
        — the healthy→degraded→dead state machine's input."""
        if self._dead or self._closed:
            return False
        if self._process is not None and self._process.poll() is not None:
            return False
        if self.heartbeat_timeout is not None and self._hb_interval:
            return (time.monotonic() - self._hb_last_ok
                    <= self.heartbeat_timeout)
        return True

    def current_params(self):
        raise NotImplementedError(
            "a remote replica's params live in its own process; swap() "
            "ships new ones, but there is no params pull op (canary "
            "rollout is in-process-only until the sharding round)")

    def submit(self, prompt, max_new_tokens, deadline_ms=None,
               klass="default"):
        """Enqueue one decode request over the wire; returns a future
        resolving to the full token list. Synchronous verdicts at the
        replica (sheds, closed) re-raise here with their REAL types —
        the local submit contract, preserved across the wire."""
        self._check_usable()
        rid = self._mint()
        hdr = {"id": rid, "prompt": [int(t) for t in prompt],
               "max_new": int(max_new_tokens),
               "deadline_ms": deadline_ms, "klass": klass}
        p = _PendingOp(rid, OP_SUBMIT, hdr, stream=True)
        try:
            self._send_op(p, site="serve.wire.submit")
            self._await_ack(p)
        except BaseException:
            self._forget(rid)
            raise
        return p.stream

    def generate(self, prompt, max_new_tokens, deadline_ms=None,
                 timeout=None):
        return self.submit(prompt, max_new_tokens,
                           deadline_ms=deadline_ms).result(timeout)

    def migrate_in(self, artifact, deadline_ms=None):
        """Ship an artifact to the replica (`to_bytes` over the wire,
        tag-checked at the far end). Refusals — version tag, layout,
        overload — re-raise synchronously with their real types, so
        the manager's degrade-to-replay path works unchanged."""
        self._check_usable()
        rid = self._mint()
        p = _PendingOp(rid, OP_MIGRATE_IN,
                       {"id": rid, "deadline_ms": deadline_ms},
                       blob=artifact.to_bytes(), stream=True)
        try:
            self._send_op(p, site="serve.wire.migrate")
            self._await_ack(p)
        except BaseException:
            self._forget(rid)
            raise
        return p.stream

    def migrate_out(self, future, timeout=30.0):
        """Export a live request by its submit() future; returns the
        `RequestArtifact` (the local future fails RequestMigratedError
        via the replica's STREAM push, same as in-process)."""
        with self._plock:
            rid = next((r for r, p in self._pending.items()
                        if p.stream is future), None)
        if rid is None:
            raise KVStateError("future was not submitted through this "
                               "replica")
        oid = self._mint()
        p = _PendingOp(oid, OP_MIGRATE_OUT,
                       {"id": oid, "rid": rid, "timeout": timeout})
        try:
            self._send_op(p, site="serve.wire.migrate")
            hdr, blob = self._await_ack(p, timeout + self._op_timeout)
        except BaseException:
            # a failed op must leave the registry: an unresolved
            # pending entry is excluded from the done-op prune AND
            # re-sent on every later reconnect, forever (graftlint
            # future-hygiene triage)
            self._forget(oid)
            raise
        return RequestArtifact.from_bytes(blob)

    def prefix_export(self, key, max_bytes=None, timeout=30.0):
        """Pull the replica's resident prefix chain covering `key` as
        a `PrefixCacheArtifact` (None when nothing is resident) — the
        wire twin of `ContinuousDecodeServer.prefix_export`, so the
        fleet prefix tier drives in-process and remote replicas
        through one seam."""
        self._check_usable()
        rid = self._mint()
        p = _PendingOp(rid, OP_PREFIX_PULL,
                       {"id": rid, "key": [int(t) for t in key],
                        "max_bytes": max_bytes, "timeout": timeout})
        try:
            self._send_op(p, site="serve.wire.migrate")
            hdr, blob = self._await_ack(p, timeout + self._op_timeout)
        except BaseException:
            self._forget(rid)
            raise
        if not hdr.get("found"):
            return None
        return PrefixCacheArtifact.from_bytes(blob)

    def prefix_adopt(self, artifact, timeout=30.0):
        """Ship a peer's exported prefix chain into this replica
        (`to_bytes` over the wire, tag-checked at the far end — a
        `KVStateVersionError` refusal re-raises here with its real
        type so the manager can count it and fall back to cold
        compute). Returns the number of blocks adopted."""
        self._check_usable()
        rid = self._mint()
        p = _PendingOp(rid, OP_PREFIX_PUSH, {"id": rid,
                                             "timeout": timeout},
                       blob=artifact.to_bytes())
        try:
            self._send_op(p, site="serve.wire.migrate")
            hdr, _blob = self._await_ack(p, timeout + self._op_timeout)
        except BaseException:
            self._forget(rid)
            raise
        return int(hdr.get("adopted", 0))

    def drain(self, migrate=None, timeout=60.0):
        """The fleet drain verb over the wire: returns ``(migrated,
        replayed)`` in exactly `ContinuousDecodeServer.drain`'s shape —
        each entry's future is THIS client's future for that request,
        so `FleetManager.scale_down` repoints artifacts and replays
        specs with no remote-special code path. The replica stops
        itself after draining; this side closes too."""
        self._check_usable()
        rid = self._mint()
        p = _PendingOp(rid, OP_DRAIN,
                       {"id": rid, "migrate": migrate, "timeout": timeout})
        try:
            self._send_op(p, site="serve.wire.migrate")
            hdr, blob = self._await_ack(p, timeout + self._op_timeout)
        except BaseException:
            self._forget(rid)   # the migrate_out rule: a failed op
            raise               # must never linger for resend
        migrated, replayed = [], []
        off = 0
        for m in hdr.get("migrated", ()):
            data = blob[off:off + m["nbytes"]]
            off += m["nbytes"]
            art = RequestArtifact.from_bytes(data)
            fut = self._future_for(m.get("rid"), RequestMigratedError(
                "request drained to another replica"))
            migrated.append((fut, art))
        for r in hdr.get("replayed", ()):
            spec = dict(r["spec"])
            # the wire spec carries REMAINING deadline ms; re-anchor it
            # on this side's clock (the local drain contract: absolute
            # monotonic or None)
            dl = spec.pop("deadline_ms", None)
            spec["deadline"] = (None if dl is None
                                else time.monotonic() + dl / 1e3)
            fut = self._future_for(r.get("rid"), RequestDrainedError(
                "request replayed on another replica"))
            replayed.append((fut, spec))
        self._shutdown_local(ServerClosedError("replica drained"),
                             dead=False)
        self._reap_process(timeout)
        return migrated, replayed

    def swap(self, new_lm):
        """Hot-swap the replica's params: (aux, blocks) leaves packed
        like a PS PUSH (both ends hold the same model, so only leaves
        cross the wire). Structure/shape refusals re-raise as
        ValueError — the local swap contract."""
        from ..models.zoo.transformer import tree_leaves
        from ..parallel.ps_transport import pack_leaves
        self._check_usable()
        leaves = tree_leaves(new_lm.aux, new_lm.blocks)
        rid = self._mint()
        p = _PendingOp(rid, OP_SWAP, {"id": rid},
                       blob=pack_leaves(leaves))
        try:
            self._send_op(p)
            self._await_ack(p)
        except BaseException:
            self._forget(rid)   # the migrate_out rule: a failed op
            raise               # must never linger for resend

    def kill(self):
        """Abrupt replica death from this side: best-effort KILL frame
        (a severed wire may never deliver it), then every pending
        future fails loudly with `ReplicaDeadError` and the owned
        process is terminated — the fleet crash verb, cross-process."""
        if self._closed and self._dead:
            return
        self._dead = True
        try:
            with self._conn_lock:
                sock = self._sock
            if sock is not None:
                # BOUND the best-effort frame: a peer with a full TCP
                # buffer would otherwise block this sendall forever —
                # kill() is the fleet's crash verb and must never
                # wedge on the replica it is crashing. Disturbing the
                # reader thread with the timeout is fine: the local
                # teardown below severs this socket anyway.
                sock.settimeout(5.0)
                with self._wlock:
                    # graftlint: disable=lock-discipline -- best-effort frame on the shared write mutex, bounded by the settimeout above; the teardown below severs the socket regardless
                    _send_frame(sock, OP_KILL, {"id": self._mint()})
        except OSError:
            pass
        self._shutdown_local(
            ReplicaDeadError(f"replica {self.instance!r} killed"),
            dead=True)
        if self._process is not None:
            try:
                self._process.terminate()
                self._process.wait(timeout=10)
            except Exception:   # noqa: BLE001 — last resort below
                try:
                    self._process.kill()
                except Exception:   # noqa: BLE001
                    pass

    def stop(self, drain=True, timeout=None):
        """Graceful stop: the replica drains (or fails queued work)
        under its own stop contract, acks, and exits; pending results
        stream back BEFORE the ack. Wire already dead -> local
        teardown only (the replica's own crash handling applies)."""
        if self._closed:
            self._reap_process(timeout or 30.0)
            return
        budget = timeout if timeout is not None else 60.0
        try:
            rid = self._mint()
            p = _PendingOp(rid, OP_STOP,
                           {"id": rid, "drain": bool(drain),
                            "timeout": timeout}, resend=False)
            self._send_op(p)
            self._await_ack(p, budget + 10.0)
            # drained results may still be in flight behind the ack
            # (the replica's sender thread is asynchronous): wait —
            # bounded — for pending streams before closing, or a
            # drain=True stop would fail futures the replica already
            # resolved
            with self._plock:
                streams = [q.stream for q in self._pending.values()
                           if q.stream is not None and not q.done]
            if streams:
                cf.wait(streams, timeout=min(10.0, budget))
        except BaseException:   # noqa: BLE001 — teardown must finish
            log.warning("replica %s stop over the wire failed; closing "
                        "locally", self.instance)
        self._shutdown_local(ServerClosedError("replica stopped"),
                             dead=False)
        self._reap_process(budget)

    def snapshot_metrics(self):
        """Refresh + return the kind snapshot (the SNAPSHOT op)."""
        return self.metrics.kind_snapshot()

    # -- internals -----------------------------------------------------
    def _fetch_snapshot(self):
        """The SNAPSHOT op: one kind snapshot off the replica (the
        `_RemoteMetrics` refresh path). TIGHT timeout: the fleet
        manager's tombstone fetches call this on the crash/drain-
        handling thread — outside the manager lock,
        but failover delivery still waits behind it — so a wedged
        wire must cost seconds, not the op default; the stale-cache
        fallback makes a miss harmless."""
        self._check_usable()
        rid = self._mint()
        p = _PendingOp(rid, OP_SNAPSHOT, {"id": rid})
        try:
            self._send_op(p)
            hdr, _ = self._await_ack(p, 5.0)
        finally:
            self._forget(rid)
        return hdr.get("snapshot") or {}

    def _check_usable(self):
        exc = self._usable_exc()
        if exc is not None:
            raise exc

    def _usable_exc(self):
        """The named error a dead/closed replica owes its callers
        (None while usable) — shared by the submit-time check and the
        raced-teardown delivery paths, so the two can never drift."""
        if self._dead:
            return ReplicaDeadError(
                f"remote replica {self.instance!r} is dead"
                + (f" ({self._dead_exc})" if self._dead_exc else ""))
        if self._closed:
            return ServerClosedError("remote replica is closed")
        return None

    def _fail_op(self, p, exc):
        """Resolve one pending op's futures with `exc` (idempotent,
        cancel-race-safe via the shared `_fail_future`): the loud-
        failure delivery every teardown path funnels through — a
        registered op must NEVER be left for its caller to time out
        on."""
        for fut in (p.ack, p.stream):
            if fut is not None:
                _fail_future(fut, exc)

    def _fail_pending(self, exc):
        with self._plock:
            pend = list(self._pending.values())
        for p in pend:
            self._fail_op(p, exc)

    def _mint(self):
        return f"{self._client_id or 'c?'}:{next(self._ids)}"

    def _forget(self, rid):
        with self._plock:
            self._pending.pop(rid, None)

    def _future_for(self, rid, exc):
        """The client future for a drained request: the one its SUBMIT
        registered, failed with the drain verdict (idempotent — the
        replica's own STREAM push may have failed it already); an
        unknown rid (a request the replica admitted locally) gets a
        fresh pre-failed future so the caller's bookkeeping stays
        uniform."""
        with self._plock:
            p = self._pending.get(rid) if rid is not None else None
        if p is not None and p.stream is not None:
            fut = p.stream
        else:
            fut = cf.Future()
        if not fut.done():
            fut.set_exception(exc)
        return fut

    def _await_ack(self, p, timeout=None):
        try:
            return p.ack.result(timeout if timeout is not None
                                else self._op_timeout)
        except cf.TimeoutError:
            raise ReplicaDeadError(
                f"wire op {p.op} to {self.instance!r} timed out after "
                f"{timeout or self._op_timeout:.0f}s") from None

    # -- connection management -----------------------------------------
    def _dial_once(self):
        """One dial attempt: connect, HELLO, start the reader, resend
        every unresolved in-flight frame (the server dedups). Each
        resent op spends one fleet retry-budget token; denied ops fail
        LOUDLY with `RetryBudgetExhaustedError` instead of riding the
        fresh socket — under a sever storm the budget bounds total
        resends fleet-wide."""
        denied = []
        try:
            self._dial_locked(denied)
        finally:
            # outside _conn_lock: failing a future runs its done
            # callbacks inline, and a fleet-manager callback may
            # re-enter submit -> lazy dial -> _conn_lock (not
            # re-entrant)
            for p in denied:
                self._forget(p.rid)
                self._count("retry_budget_exhausted")
                self._fail_op(p, RetryBudgetExhaustedError(
                    f"fleet retry budget exhausted; not resending wire "
                    f"op {p.op} ({p.rid}) to {self.instance!r}"))

    def _grant_retry(self, n=1):
        """Consult the shared fleet retry budget through the manager's
        RetryPolicy (configure_wire installed it). A policy without the
        hook — or one with no budget — always grants: the budget is an
        opt-in fleet-level brake, never a default behavior change."""
        grant = getattr(self._retry, "grant_retry", None)
        return grant is None or grant(n)

    def _dial_locked(self, denied):
        with self._conn_lock:
            if self._sock is not None:
                return
            if self._closed or self._dead:
                raise ServerClosedError("remote replica is closed")
            # graftlint: disable=lock-discipline -- the dial runs under _conn_lock BY DESIGN: the socket must not publish until HELLO + resends complete, and every contender (reconnector, lazy dials) needs the dialed socket anyway; the connect itself is bounded by connect_timeout
            sock = socket.create_connection(
                (self._host, self._port), timeout=self._connect_timeout)
            sock.settimeout(None)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            try:
                hello = {"client_id": self._client_id}
                if self._epoch is not None:
                    hello["epoch"] = self._epoch
                # graftlint: disable=lock-discipline -- the dial-under-_conn_lock rule above: HELLO must complete before the socket publishes
                _send_frame(sock, OP_HELLO, hello)
                # graftlint: disable=lock-discipline -- the dial-under-_conn_lock rule above: HELLO must complete before the socket publishes
                op, hdr, _ = _recv_frame(sock)
                if op != OP_HELLO:
                    raise WireProtocolError(
                        f"expected HELLO reply, got op {op}")
            except BaseException:
                sock.close()
                raise
            self._client_id = hdr["client_id"]
            if self.instance is None:
                self.instance = hdr.get("instance")
                self.name = self.instance
            self._paged = bool(hdr.get("paged"))
            self._block_size = hdr.get("block_size")
            self.pid = hdr.get("pid")
            self.start_time = hdr.get("start_time")
            # resend in-flight frames BEFORE publishing the socket: a
            # failure here must leave self._sock None so the retry
            # loop re-dials — publishing first would install a broken
            # socket with NO reader to notice it (every later op would
            # stall to its timeout instead of reconnecting)
            with self._plock:
                resend = [p for p in self._pending.values()
                          if p.resend and p.sent and not p.done]
            granted = []
            for p in resend:
                (granted if self._grant_retry() else denied).append(p)
            resend = granted
            try:
                for p in resend:
                    # attempt-stamped: the server re-points delivery
                    # only for the NEWEST attempt, so a stale original
                    # frame read later off the severed connection can
                    # never steal the result back to the dead socket
                    p.attempt += 1
                    p.hdr["attempt"] = p.attempt
                    # graftlint: disable=lock-discipline -- the dial-under-_conn_lock rule above: in-flight frames must resend before the socket publishes, or a racing op could interleave ahead of them
                    _send_frame(sock, p.op, p.hdr, p.blob)
            except BaseException:
                _close_sock(sock)
                raise
            self._sock = sock
            self._gen += 1
            gen = self._gen
            if self._ever_connected:
                self._count("wire_reconnects")
            self._ever_connected = True
            if resend:
                self._count("wire_retries", len(resend))
            self._hb_last_ok = time.monotonic()
            t = threading.Thread(target=self._reader, args=(sock, gen),
                                 name="wire-reader", daemon=True)
            t.start()

    def _count(self, key, n=1):
        c = self._counters
        if c is not None:
            try:
                c.count(key, n)
            except Exception:   # noqa: BLE001 — counting never breaks IO
                pass

    def _sever_main(self):
        """The fault-injection sever callback AND internal teardown of
        a broken/desynced main connection."""
        with self._conn_lock:
            sock, self._sock = self._sock, None
        _close_sock(sock)

    def _conn_broken(self, gen, exc):
        with self._conn_lock:
            if gen != self._gen:
                return               # a newer connection took over
            sock, self._sock = self._sock, None
        _close_sock(sock)
        self._maybe_reconnect(exc)

    def _maybe_reconnect(self, cause):
        """At most one reconnector at a time; a second caller returns
        immediately — its pending op is resent by the owner (or failed
        by `_mark_dead` if the owner gives up)."""
        if not self._rc_lock.acquire(blocking=False):
            return
        try:
            attempt = 0
            while True:
                if self._closed or self._dead:
                    # ops that registered after _shutdown_local's
                    # sweep would otherwise wait out their timeouts —
                    # the teardown owes them the loud failure
                    self._fail_pending(self._usable_exc())
                    return
                with self._plock:
                    waiting = any(not p.done
                                  for p in self._pending.values())
                if not waiting and self._ever_connected:
                    # nothing in flight: dial lazily at the next op
                    return
                try:
                    # graftlint: disable=lock-discipline -- _rc_lock is the single-reconnector latch (acquired non-blocking: a contender returns instantly rather than waiting); serializing the dial IS its job
                    self._dial_once()
                    return
                except (ConnectionError, OSError) as e:
                    cause = e
                    if attempt >= self._retry.max_retries:
                        self._mark_dead(cause)
                        return
                    if not self._grant_retry():
                        # budget exhausted: stop hammering the endpoint
                        # — dead-replica delivery fails the pending ops
                        # loudly and the manager's failover path (its
                        # own budget gate) decides what survives
                        self._count("retry_budget_exhausted")
                        self._mark_dead(RetryBudgetExhaustedError(
                            f"fleet retry budget exhausted reconnecting "
                            f"to {self.instance!r} (last error: {cause})"))
                        return
                    d = self._retry.delay(attempt)
                    attempt += 1
                    log.warning(
                        "wire to %s broken (%s) — reconnect attempt %d "
                        "in %.2fs", self.instance, cause, attempt, d)
                    # graftlint: disable=lock-discipline -- the reconnect backoff sleeps inside the single-reconnector latch on purpose: contenders never block on it (non-blocking acquire), and exactly one thread may pace the retries
                    time.sleep(d)
        finally:
            self._rc_lock.release()

    def _mark_dead(self, exc):
        self._dead = True
        self._dead_exc = exc
        self._shutdown_local(ReplicaDeadError(
            f"wire to replica {self.instance!r} died: {exc}"), dead=True)

    def _shutdown_local(self, exc, dead):
        self._closed = True
        self._running = False
        self._dead = self._dead or dead
        self._hb_stop.set()
        self._sever_main()
        self._fail_pending(exc)

    def _reap_process(self, timeout):
        proc = self._process
        if proc is None:
            return
        try:
            proc.wait(timeout=timeout)
        except Exception:   # noqa: BLE001 — escalate
            try:
                proc.terminate()
                proc.wait(timeout=10)
            except Exception:   # noqa: BLE001
                try:
                    proc.kill()
                except Exception:   # noqa: BLE001
                    pass

    # -- send / receive ------------------------------------------------
    def _send_op(self, p, site=None):
        """Register + send one op. The fault site fires AFTER the send
        — a sever there is the lost-ack scenario (module docstring).
        Any failure here just kicks the reconnector: the op is already
        registered, so the reconnect resends it and the caller's ack
        wait covers the rest."""
        with self._plock:
            self._pending[p.rid] = p
            # prune resolved entries (kept for drain's rid lookup)
            if len(self._pending) > 8192:
                for rid in [r for r, q in self._pending.items()
                            if q.done][:4096]:
                    del self._pending[rid]
        try:
            with self._conn_lock:
                if self._sock is None:
                    # lazy dial: resends skip this op (p.sent False),
                    # so the frame below is its FIRST copy — never a
                    # double-send with a spurious wire_retries
                    # graftlint: disable=lock-discipline -- the dial-under-_conn_lock rule (see _dial_once): every path that needs the socket must wait for the dial regardless
                    self._dial_once()
                sock = self._sock
            with self._wlock:
                # graftlint: disable=lock-discipline -- _wlock is the main socket's dedicated write mutex (the _Conn.send rule, client side); it never nests another lock
                _send_frame(sock, p.op, p.hdr, p.blob)
            p.sent = True
            if site is not None and self._injector is not None:
                self._injector.fire(site, on_sever=self._sever_main)
        except (FaultInjected, ConnectionError, OSError) as e:
            # the frame MAY have gone out before the failure: mark it
            # eligible for resend (dedup absorbs the may-have-arrived
            # half) and let the reconnector take it from here
            p.sent = True
            dead_exc = self._usable_exc()
            if dead_exc is not None:
                # a stop()/kill() raced past the submit-time check:
                # no reconnector is coming (it exits on closed/dead),
                # and _shutdown_local's sweep may have run BEFORE this
                # op registered — fail it loudly HERE instead of
                # stranding the caller until its op timeout
                # (graftlint future-hygiene triage)
                self._fail_op(p, dead_exc)
                return
            t = threading.Thread(target=self._maybe_reconnect, args=(e,),
                                 name="wire-reconnect", daemon=True)
            t.start()

    def _reader(self, sock, gen):
        try:
            while True:
                op, hdr, blob = _recv_frame(sock)
                if op == OP_STREAM:
                    self._on_stream(hdr)
                else:
                    self._on_reply(hdr, blob)
        except _StreamSevered as e:
            self._conn_broken(gen, e)
        except (ConnectionError, OSError) as e:
            if not (self._closed or self._dead):
                self._conn_broken(gen, e)

    def _on_stream(self, hdr):
        if self._injector is not None:
            severed = []
            self._injector.fire(
                "serve.wire.stream",
                on_sever=lambda: (self._sever_main(),
                                  severed.append(1)))
            if severed:
                # the frame died on the severed wire: the pending
                # request stays unresolved, reconnect re-SUBMITs, and
                # the server re-delivers WITHOUT re-decoding (dedup)
                raise _StreamSevered("stream severed by fault injection")
        with self._plock:
            p = self._pending.get(hdr.get("id"))
        if p is None or p.stream is None:
            return
        if not p.ack.done():
            # delivery implies acceptance — an out-of-order STREAM
            # (sender thread vs handler thread) must not strand the
            # submitter on its ack
            try:
                p.ack.set_result(({"id": p.rid, "ok": True}, b""))
            except cf.InvalidStateError:
                pass
        p.blob = b""    # registered server-side: resends dedup blob-less
        if p.stream.done():
            return
        try:
            if "error" in hdr:
                p.stream.set_exception(_exc_from_hdr(hdr))
            else:
                p.stream.set_result([int(t) for t in hdr["tokens"]])
        except cf.InvalidStateError:
            pass

    def _on_reply(self, hdr, blob):
        with self._plock:
            p = self._pending.get(hdr.get("id"))
        if p is None or p.ack.done():
            return
        try:
            if "error" in hdr:
                exc = _exc_from_hdr(hdr)
                if isinstance(exc, StaleEpochError):
                    # the fenced manager's OWN overlay shows the
                    # refusal too (the replica counted it as well —
                    # federation sums the replica side)
                    self._count("fenced_ops")
                p.ack.set_exception(exc)
                if p.stream is not None and not p.stream.done():
                    p.stream.set_exception(exc)
            else:
                p.ack.set_result((hdr, blob))
                # the request payload is no longer needed for resend:
                # the server registered the id, so a blob-less retried
                # frame dedups — dropping it here keeps a long-lived
                # client from pinning every migrated artifact's bytes
                p.blob = b""
        except cf.InvalidStateError:
            pass

    # -- heartbeats ----------------------------------------------------
    def _heartbeat_loop(self):
        """Dedicated-socket liveness (the PS client pattern): one ping
        per interval; each ack refreshes `_hb_last_ok`. Ack silence
        past `heartbeat_timeout` — severed wire, hung process, paused
        server — decays `alive` and the fleet router reaps."""
        sock = None
        while not self._hb_stop.wait(self._hb_interval):
            if self._closed or self._dead:
                break
            try:
                if sock is None:
                    sock = socket.create_connection(
                        (self._host, self._port),
                        timeout=self._connect_timeout)
                    # a bounded recv timeout: a HUNG server must read
                    # as silence, not block this thread forever
                    sock.settimeout(
                        max(self._hb_interval * 2.0,
                            min(self.heartbeat_timeout or 2.0, 2.0)))
                    hello = {"client_id": self._client_id,
                             "heartbeat": True}
                    if self._epoch is not None:
                        hello["epoch"] = self._epoch
                    _send_frame(sock, OP_HELLO, hello)
                    op, _h, _b = _recv_frame(sock)
                    if op != OP_HELLO:
                        raise WireProtocolError(
                            "bad HELLO reply on heartbeat socket")
                severed = []
                if self._injector is not None:
                    def _sever_hb():
                        severed.append(1)
                    self._injector.fire("serve.wire.heartbeat",
                                        on_sever=_sever_hb)
                if severed:
                    raise ConnectionError("heartbeat severed by fault "
                                          "injection")
                _send_frame(sock, OP_HEARTBEAT, {"id": None})
                op, _h, _b = _recv_frame(sock)
                if op != OP_HEARTBEAT:
                    raise WireProtocolError("bad HEARTBEAT reply")
                self._hb_last_ok = time.monotonic()
            except (ConnectionError, OSError):
                # best-effort: drop the socket, re-dial next tick; the
                # reap only fires after heartbeat_timeout of SILENCE
                _close_sock(sock)
                sock = None
        _close_sock(sock)


class _StreamSevered(ConnectionError):
    """Internal: a fault-injected sever consumed a STREAM frame."""
