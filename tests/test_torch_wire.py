"""The port's serving wire protocol (serving/wire.py).

  * Against the JAX package's: every op's frame is byte-equal and each
    package parses the other's; the error headers map to the same types;
    mixed pairs over localhost in one process, a reference
    `RemoteReplica` against a port `ReplicaServer` and the reverse:
    greedy streams equal the port's solo run, and SUBMIT, STREAM,
    SNAPSHOT, SWAP, MIGRATE_IN and DRAIN cross; an artifact written by
    one package and drained over the wire resumes on the other.
  * The reference's own pins, rebuilt on the port: the bodies of
    tests/test_wire.py (transport, zero added dispatches, at-most-once
    dedup, heartbeat reaping, migration over the wire, future hygiene)
    run against the port's classes, every endpoint a real TCP socket on
    127.0.0.1. No test asserts a wall-clock bound; every wait names what
    it waited for.
"""
import socket
import sys
import time
from pathlib import Path

import pytest

from deeplearning4j_tpu_torch.common.resilience import FaultInjector, RetryPolicy
from deeplearning4j_tpu_torch.serving import (ContinuousDecodeServer,
                                              DeadlineExceededError,
                                              FleetManager, RemoteReplica,
                                              ReplicaDeadError,
                                              ReplicaServer,
                                              ServerClosedError,
                                              ServerOverloadedError,
                                              ServingMetrics)
from deeplearning4j_tpu_torch.serving import wire as pw

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fleet_manager import _lm, _wait  # noqa: E402


# ---------------------------------------------------------------------------
# against the JAX package's wire
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rw():
    """The reference's wire module and what a mixed pair needs."""
    pytest.importorskip("jax")
    from deeplearning4j_tpu.models.zoo.transformer import TransformerLM as J
    from deeplearning4j_tpu.serving import ContinuousDecodeServer as JS
    from deeplearning4j_tpu.serving import RequestArtifact as JA
    from deeplearning4j_tpu.serving import ServingMetrics as JM
    from deeplearning4j_tpu.serving import wire as W
    return {"W": W, "S": JS, "A": JA, "M": JM,
            "lm": lambda seed: J(64, d_model=16, n_heads=2, n_layers=1,
                                 max_len=64, seed=seed)}


_OPS = [name for name in dir(pw) if name.startswith("OP_")]
_HDRS = [{}, {"id": "c0:7", "prompt": [1, 2, 3], "max_new": 8,
              "deadline_ms": None, "klass": "default", "attempt": 2},
         {"id": None, "ok": True, "dup": True, "tokens": list(range(40)),
          "x": 1.5e-7, "s": "naïve"}]


def test_op_table_and_frames_byte_equal(rw):
    W = rw["W"]
    assert _OPS == [n for n in dir(W) if n.startswith("OP_")]
    assert pw._FENCED_OPS == W._FENCED_OPS
    for name in _OPS:
        op = getattr(pw, name)
        assert op == getattr(W, name)
        for hdr in _HDRS:
            for blob in (b"", bytes(range(256)) * 3):
                frame = pw._frame(op, hdr, blob)
                assert frame == W._frame(op, hdr, blob)
                # each package parses the other's bytes
                for send, recv in ((pw, W), (W, pw)):
                    a, b = socket.socketpair()
                    try:
                        send._send_frame(a, op, hdr, blob)
                        assert recv._recv_frame(b) == (op, hdr, blob)
                    finally:
                        a.close()
                        b.close()


def test_malformed_frames_refused_alike(rw):
    W = rw["W"]
    import struct
    for raw in (struct.pack("<I", 3) + b"abc",
                struct.pack("<IBI", 5 + 2, 2, 9) + b"{}",
                struct.pack("<IBI", 5 + 3, 2, 3) + b"{x}"):
        for mod in (pw, W):
            a, b = socket.socketpair()
            try:
                a.sendall(raw)
                with pytest.raises(ConnectionError) as ei:
                    mod._recv_frame(b)
                assert type(ei.value).__name__ == "WireProtocolError"
            finally:
                a.close()
                b.close()


def test_error_headers_map_to_the_same_types(rw):
    W = rw["W"]
    assert sorted(pw._WIRE_EXCEPTIONS) == sorted(W._WIRE_EXCEPTIONS)
    for name in list(pw._WIRE_EXCEPTIONS) + ["KeyError"]:
        hdr = {"error": name, "message": "m"}
        p, r = pw._exc_from_hdr(hdr), W._exc_from_hdr(hdr)
        assert (type(p).__name__, str(p)) == (type(r).__name__, str(r))
        assert pw._exc_to_hdr(p) == W._exc_to_hdr(r)


def _decoding(server, timeout=60.0):
    _wait(lambda: any(r is not None and r.pf_next is None and r.generated
                      for r in server._slot_req), timeout=timeout,
          msg="a request decoding on the replica")


@pytest.mark.parametrize("server_side", ["port", "ref"])
def test_mixed_pair_streams_swap_migrate_and_drain(rw, server_side):
    """A `RemoteReplica` of one package against a `ReplicaServer` of the
    other, paged: SUBMIT/STREAM, SNAPSHOT, SWAP, MIGRATE_IN and DRAIN
    cross, and every stream equals the port's solo run."""
    W = rw["W"]
    port_side = {"S": ContinuousDecodeServer, "M": ServingMetrics,
                 "RS": ReplicaServer, "RR": RemoteReplica, "lm": _lm}
    ref_side = {"S": rw["S"], "M": rw["M"], "RS": W.ReplicaServer,
                "RR": W.RemoteReplica, "lm": rw["lm"]}
    srv_pkg, cli_pkg = ((port_side, ref_side) if server_side == "port"
                        else (ref_side, port_side))
    kw = dict(slots=2, prompt_buckets=(8, 16), paged=True, block_size=8)
    solo3 = list(_lm(3).generate([1, 2, 3], 30))
    solo9 = list(_lm(9).generate([1, 2, 3], 30))
    srv = srv_pkg["S"](srv_pkg["lm"](3), metrics=srv_pkg["M"](name="i0"),
                       instance="i0", **kw)
    rs = srv_pkg["RS"](srv)
    rr = cli_pkg["RR"]("127.0.0.1", rs.port, name="i0",
                       heartbeat_interval=0.05)
    local = cli_pkg["S"](cli_pkg["lm"](9), **kw).start()
    try:
        assert rr.paged
        # SUBMIT + STREAM
        assert list(rr.generate([1, 2, 3], 30, timeout=120)) == solo3
        # SNAPSHOT
        snap = rr.snapshot_metrics()
        assert snap["completed"]["value"] == 1
        # SWAP the client package's seed-9 weights
        rr.swap(cli_pkg["lm"](9))
        assert list(rr.generate([1, 2, 3], 30, timeout=120)) == solo9
        # MIGRATE_IN: a live request exported by the client package's
        # own server resumes on the far side
        fut = local.submit([1, 2, 3], 30)
        _decoding(local)
        art = local.migrate_out(fut)
        assert list(rr.migrate_in(art).result(120)) == solo9
        # DRAIN: a live request leaves the far side as artifact bytes
        # and resumes on the client package's server
        live = rr.submit([1, 2, 3], 30)
        _decoding(srv)
        migrated, replayed = rr.drain()
        assert [f for f, _ in migrated] == [live] and replayed == []
        (_, out_art), = migrated
        assert list(local.migrate_in(out_art).result(120)) == solo9
    finally:
        local.stop(timeout=60)
        rr.kill()
        rs.close(stop_server=False)
        if srv._running:
            srv.stop(timeout=60)


class _WireFleet:
    """N in-thread ReplicaServers behind RemoteReplicas — a REAL
    loopback wire under every verb, without subprocess startup cost
    (the 2-process arm is the tier-1 smoke)."""

    def __init__(self, lm, injector=None, paged=False, **mgr_kw):
        self.wrappers = {}
        self._lm = lm
        self._paged = paged
        self._injector = injector
        self.mgr = FleetManager(self._factory, **mgr_kw)

    def _factory(self, name):
        srv = ContinuousDecodeServer(
            self._lm, slots=2, prompt_buckets=(8, 16),
            paged=self._paged, block_size=8,
            metrics=ServingMetrics(name=name), instance=name)
        rs = ReplicaServer(srv)
        self.wrappers[name] = rs
        return RemoteReplica("127.0.0.1", rs.port, name=name,
                             heartbeat_interval=0.05,
                             fault_injector=self._injector)

    def __enter__(self):
        self.mgr.start()
        for n in self.mgr.replicas:     # compile off the clock
            self.mgr.replica(n).generate([1, 2, 3], 2, timeout=120)
        return self.mgr

    def __exit__(self, *exc):
        self.mgr.stop(timeout=60)
        for rs in self.wrappers.values():
            rs.close(stop_server=False)

    def received_total(self):
        """Sum of the replicas' own `received` counters — the decoded-
        stream census the at-most-once pins count."""
        total = 0
        for name in self.mgr.replicas:
            snap = self.mgr.replica(name).metrics.kind_snapshot()
            total += (snap.get("received") or {}).get("value") or 0
        return total


# ---------------------------------------------------------------------------
# (a) transport
# ---------------------------------------------------------------------------
class TestWireTransport:
    def test_submit_over_wire_bit_identical_and_verdicts_propagate(self):
        lm = _lm()
        ref = list(lm.generate([1, 2, 3], 8))
        srv = ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8, 16),
                                     metrics=ServingMetrics(name="i0"),
                                     instance="i0", max_queue=2)
        rs = ReplicaServer(srv)
        rr = RemoteReplica("127.0.0.1", rs.port, name="i0",
                           heartbeat_interval=0.05)
        try:
            assert list(rr.generate([1, 2, 3], 8, timeout=120)) == ref
            # request-level verdicts cross the wire as their REAL types
            # (the fleet manager's classification table depends on it)
            with pytest.raises(ValueError):
                rr.generate(list(range(1, 70)), 8, timeout=60)
            with pytest.raises(DeadlineExceededError):
                rr.generate([1, 2, 3], 8, deadline_ms=0.0, timeout=60)
            futs, shed = [], 0
            for _ in range(64):
                try:
                    futs.append(rr.submit([1, 2, 3], 30))
                except ServerOverloadedError:
                    shed += 1
            assert shed > 0             # backpressure reached the caller
            for f in futs:
                f.result(120)
        finally:
            rr.stop(drain=True)
            rs.close(stop_server=False)
        assert not rr.alive

    def test_wire_fleet_adds_zero_dispatches_vs_inprocess_fleet(self):
        """THE zero-added-dispatch acceptance pin: the same sequential
        round-robin workload through (1) a fleet of wire replicas on a
        real loopback socket and (2) the same fleet in-process —
        per-replica dispatch and token counters IDENTICAL, results
        bit-identical. The wire is host-side plumbing; it must never
        buy a token with an extra device dispatch."""
        lm = _lm()
        prompts = [[1 + i, 2, 3] for i in range(6)]
        counts, outs = {}, {}
        fleet = _WireFleet(lm, n_replicas=2, policy="round_robin")
        with fleet as mgr:
            outs["wire"] = [mgr.generate(p, 5, timeout=120)
                            for p in prompts]
            counts["wire"] = []
            for n in mgr.replicas:
                snap = mgr.replica(n).metrics.kind_snapshot()
                counts["wire"].append(
                    ((snap.get("dispatches") or {}).get("value") or 0,
                     (snap.get("tokens_out") or {}).get("value") or 0))

        def local_factory(name):
            return ContinuousDecodeServer(
                lm, slots=2, prompt_buckets=(8, 16),
                metrics=ServingMetrics(name=name), instance=name)
        with FleetManager(local_factory, n_replicas=2,
                          policy="round_robin") as mgr:
            for n in mgr.replicas:
                mgr.replica(n).generate([1, 2, 3], 2, timeout=120)
            outs["local"] = [mgr.generate(p, 5, timeout=120)
                             for p in prompts]
            counts["local"] = [
                (mgr.replica(n).metrics.count_value("dispatches"),
                 mgr.replica(n).metrics.count_value("tokens_out"))
                for n in mgr.replicas]
        assert counts["wire"] == counts["local"]
        assert [list(r) for r in outs["wire"]] == \
            [list(r) for r in outs["local"]]

    def test_wire_counters_always_present_on_fleet_snapshot(self):
        """The satellite surface pin: wire_reconnects / wire_retries /
        migrate_refused ride EVERY fleet snapshot as zeros on a fleet
        that never lost a connection (the PINNED_KEYS twin lives in
        test_obs)."""
        lm = _lm()
        with _WireFleet(lm, n_replicas=2) as mgr:
            snap = mgr.fleet_snapshot()
            for key in ("fleet_wire_reconnects", "fleet_wire_retries",
                        "fleet_migrate_refused"):
                assert snap[key] == 0
            assert mgr.heartbeat_timeout is None    # exposed config


# ---------------------------------------------------------------------------
# (b) at-most-once
# ---------------------------------------------------------------------------
class TestAtMostOnce:
    def test_drop_after_ack_decodes_once_one_wire_retry(self):
        """THE at-most-once pin: a seeded sever on
        `serve.wire.submit` fires AFTER the frame went out — the
        replica decodes, the ack dies with the connection. The retried
        SUBMIT must dedup: exactly one decoded stream (the replicas'
        summed `received` moves by 1), exactly one `wire_retries`
        increment, and the caller's future resolves bit-identically."""
        lm = _lm()
        ref = list(lm.generate([1, 2, 3], 24))
        inj = FaultInjector()
        fleet = _WireFleet(lm, injector=inj, n_replicas=2)
        with fleet as mgr:
            base_recv = fleet.received_total()
            base = mgr.fleet_snapshot()
            inj.plan("serve.wire.submit",
                     on_call=inj.calls("serve.wire.submit"),
                     sever=True, exc=None)
            fut = mgr.submit([1, 2, 3], 24)
            assert list(fut.result(120)) == ref
            snap = mgr.fleet_snapshot()
            assert snap["fleet_wire_retries"] \
                - base["fleet_wire_retries"] == 1
            assert snap["fleet_wire_reconnects"] \
                - base["fleet_wire_reconnects"] == 1
            assert fleet.received_total() - base_recv == 1

    def test_stream_sever_redelivers_without_redecoding(self):
        """A sever as the result frame arrives (`serve.wire.stream`)
        drops the stream mid-flight: reconnect re-SUBMITs, the dedup
        registry re-attaches, and the finished result is RE-DELIVERED
        — one decode, correct bits."""
        lm = _lm()
        ref = list(lm.generate([4, 5], 24))
        inj = FaultInjector()
        fleet = _WireFleet(lm, injector=inj, n_replicas=2)
        with fleet as mgr:
            base_recv = fleet.received_total()
            inj.plan("serve.wire.stream",
                     on_call=inj.calls("serve.wire.stream"),
                     sever=True, exc=None)
            fut = mgr.submit([4, 5], 24)
            assert list(fut.result(120)) == ref
            assert fleet.received_total() - base_recv == 1


# ---------------------------------------------------------------------------
# (c) liveness
# ---------------------------------------------------------------------------
class TestHeartbeatReap:
    def test_heartbeat_silence_reaps_and_fails_over_zero_lost(self):
        """A HUNG replica — heartbeats go silent while the main socket
        still answers — is reaped on `heartbeat_timeout`: `alive`
        decays, the control tick's probe crashes it, its in-flight
        requests fail over to survivors, every stream bit-identical
        to solo, zero lost."""
        lm = _lm()
        prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
        refs = {tuple(p): list(lm.generate(p, 32)) for p in prompts}
        fleet = _WireFleet(lm, n_replicas=2, heartbeat_timeout=0.4)
        with fleet as mgr:
            victim = mgr.replicas[0]
            futs = [mgr.submit(prompts[i % 3], 32) for i in range(6)]
            fleet.wrappers[victim].pause_heartbeats = True
            deadline = time.monotonic() + 10
            while mgr.replica(victim).alive:
                if time.monotonic() > deadline:
                    raise TimeoutError("alive never decayed")
                time.sleep(0.02)
            tick = mgr.control_tick()
            assert tick["states"][victim] == "dead"
            assert tick["n_replicas"] == 2          # backfilled
            for i, f in enumerate(futs):
                assert list(f.result(120)) == refs[tuple(prompts[i % 3])]
            snap = mgr.fleet_snapshot()
            assert snap["fleet_replica_dead"] == 1

    def test_retry_exhaustion_fails_pending_loudly(self):
        """The wire dies for good (listener closed, replica gone):
        bounded reconnect exhausts and every pending future fails
        LOUDLY with ReplicaDeadError — never a silent hang."""
        lm = _lm()
        srv = ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8, 16),
                                     metrics=ServingMetrics(name="i0"),
                                     instance="i0")
        rs = ReplicaServer(srv)
        rr = RemoteReplica(
            "127.0.0.1", rs.port, name="i0", heartbeat_interval=None,
            retry_policy=RetryPolicy(max_retries=1, base_delay=0.01,
                                     jitter=0.0))
        try:
            rr.generate([1, 2, 3], 2, timeout=120)      # warm + healthy
            fut = rr.submit([1, 2, 3], 56)
            # the wire dies mid-stream AND the listener is gone, so
            # reconnect gets ECONNREFUSED until the budget exhausts
            rs.close(stop_server=False)
            rr._sever_main()
            with pytest.raises(Exception) as ei:
                fut.result(30)
            assert isinstance(ei.value, ReplicaDeadError)
            assert not rr.alive
            with pytest.raises(ReplicaDeadError):
                rr.submit([1, 2, 3], 2)
        finally:
            rr.kill()
            srv.kill()
            rs.close(stop_server=False)


# ---------------------------------------------------------------------------
# (d) migration over the wire
# ---------------------------------------------------------------------------
class TestWireMigration:
    def _inflight_victim(self, mgr, timeout=0.5):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with mgr._lock:
                for r in mgr._replicas.values():
                    if r.inflight:
                        return r.name
            time.sleep(0.002)
        raise TimeoutError("no in-flight replica found")

    def test_scale_down_ships_artifact_bytes_bit_identical(self):
        """The durable-KV bit-identity pin across a REAL socket: scale_down
        drains a wire replica, the decode-phase request leaves as
        `RequestArtifact` BYTES (`to_bytes` over the DRAIN frame),
        lands on the survivor via `migrate_in`, and the caller's one
        future resolves to exactly the uninterrupted stream."""
        lm = _lm()
        refs = {tuple(p): list(lm.generate(p, 56))
                for p in ([1, 2, 3], [4, 5])}
        fleet = _WireFleet(lm, paged=True, n_replicas=2, min_replicas=1)
        with fleet as mgr:
            futs = [mgr.submit([1, 2, 3], 56), mgr.submit([4, 5], 56)]
            victim = self._inflight_victim(mgr)
            mgr.scale_down(victim)
            for f, p in zip(futs, ([1, 2, 3], [4, 5])):
                assert list(f.result(120)) == refs[tuple(p)]
            # at least one request really moved as an artifact (the
            # other may have been queued/prefilling -> replayed)
            migrated = 0
            for n in mgr.replicas:
                snap = mgr.replica(n).metrics.kind_snapshot()
                migrated += (snap.get("migrated") or {}).get("value") or 0
            assert migrated >= 1
            assert mgr.fleet_snapshot()["fleet_replica_drained"] == 1

    def test_refused_migration_degrades_to_replay_never_lost(self):
        """Mid-rollout fleet: the survivor runs NEW params, so the
        drained artifact's version tag is refused at `migrate_in`
        (KVStateVersionError over the wire). The manager counts
        `migrate_refused` and degrades to prompt replay on the
        survivor — the caller's future resolves with the survivor's
        (new-params) solo stream; nothing is lost."""
        lm = _lm()
        lm2 = _lm(seed=11)
        ref_new = list(lm2.generate([1, 2, 3], 56))
        fleet = _WireFleet(lm, paged=True, n_replicas=2, min_replicas=1)
        with fleet as mgr:
            fut = mgr.submit([1, 2, 3], 56)
            victim = self._inflight_victim(mgr)
            survivor = next(n for n in mgr.replicas if n != victim)
            mgr.replica(survivor).swap(lm2)     # SWAP over the wire
            mgr.scale_down(victim)
            assert list(fut.result(120)) == ref_new
            snap = mgr.fleet_snapshot()
            assert snap["fleet_migrate_refused"] >= 1


# ---------------------------------------------------------------------------
# (e) graftlint regressions: future-hygiene at the wire —
#     a registered op must NEVER be left for its caller to time out on
# ---------------------------------------------------------------------------
class TestWireFutureHygiene:
    def test_send_failure_after_close_fails_op_immediately(self):
        """A stop()/kill() racing past the submit-time usable check
        used to spawn a reconnector that exits on closed/dead without
        failing the just-registered op — stranding the caller for the
        full op timeout (120s). The op must fail LOUDLY the moment
        the send fails."""
        from deeplearning4j_tpu_torch.serving.wire import (OP_SUBMIT,
                                                           _PendingOp)
        lm = _lm()
        srv = ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                     metrics=ServingMetrics(name="i0"),
                                     instance="i0")
        rs = ReplicaServer(srv)
        rr = RemoteReplica("127.0.0.1", rs.port, name="i0",
                           heartbeat_interval=None, op_timeout=120.0)
        try:
            # the race, made deterministic: close lands AFTER
            # _check_usable would have passed, BEFORE the send
            rr._closed = True
            rr._sock.close()        # raw close: next sendall raises
            p = _PendingOp("race:0", OP_SUBMIT,
                           {"id": "race:0", "prompt": [1],
                            "max_new": 1}, stream=True)
            rr._send_op(p)
            # failed by the time the send returned, not stranded until
            # its op timeout
            assert p.ack.done() and p.stream.done(), \
                "op stranded instead of failing at the send"
            with pytest.raises(ServerClosedError):
                p.ack.result(0)
            with pytest.raises(ServerClosedError):
                p.stream.result(0)
        finally:
            rr._closed = False
            rr.kill()
            rs.close()

    def test_failed_op_is_forgotten_not_resent_forever(self):
        """An op whose ack never arrives (timeout -> ReplicaDeadError)
        used to stay in `_pending` forever: excluded from the done-op
        prune AND re-sent on every later reconnect. swap/migrate_out/
        drain now forget the op on failure."""
        from deeplearning4j_tpu_torch.serving.wire import OP_SWAP
        lm = _lm()
        srv = ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                     metrics=ServingMetrics(name="i0"),
                                     instance="i0")
        rs = ReplicaServer(srv)
        orig = rs._dispatch

        def blackhole(conn, op, hdr, blob):
            if op == OP_SWAP:
                return True          # swallow: the lost-ack scenario
            return orig(conn, op, hdr, blob)

        rs._dispatch = blackhole
        rr = RemoteReplica("127.0.0.1", rs.port, name="i0",
                           heartbeat_interval=None, op_timeout=1.0)
        try:
            with pytest.raises(ReplicaDeadError):
                rr.swap(_lm(seed=3))
            with rr._plock:
                leftover = [p for p in rr._pending.values()
                            if p.op == OP_SWAP]
            assert not leftover, \
                "failed SWAP lingered in _pending (resent forever)"
        finally:
            rr.kill()
            rs.close()
