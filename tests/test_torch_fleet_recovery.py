"""The durable control plane on the port: FleetManager.recover over the
port's journal and wire, epoch fencing, the reconcile rules, and replica
processes.

  * The reference's own pins, rebuilt on the port: the bodies of
    tests/test_fleet_recovery.py (recovery and re-adoption, epoch
    fencing, the reconcile rules, the zero-added-dispatch A/B) run
    against the port's classes over in-thread `ReplicaServer`s. Its
    chaos sweeps run the reference's tools/load_sweep.py, which is not
    ported, and are left out.
  * Replica processes: one module fixture starts two children, each
    running this file as a script (`run_replica_server` over a port
    server of the reference's toy model, weights moved from the JAX
    package; the children import the port only). Against them: a
    severed STREAM retries and deduplicates (one decode, the same bits),
    a SIGKILLed child is reaped by its heartbeat and its requests fail
    over to the survivor, and a manager dropped without stop() is
    recovered from its journal, re-adopts the live child and fences the
    stale manager out with StaleEpochError.
No test asserts a wall-clock bound; every wait names what it waited for.
"""
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from deeplearning4j_tpu_torch.common.resilience import FaultInjector
from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
from deeplearning4j_tpu_torch.serving import (ContinuousDecodeServer,
                                              FleetJournal, FleetManager,
                                              RemoteReplica, ReplicaServer,
                                              ServerClosedError,
                                              ServingMetrics, StaleEpochError,
                                              replay_journal,
                                              run_replica_server)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fleet_manager import _lm, _wait, jax_weights  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


class _JournaledFleet:
    """N in-thread ReplicaServers behind RemoteReplicas with the
    manager JOURNALING — the test_wire `_WireFleet` idiom plus the
    durable control plane. `abandon()` simulates the manager process
    dying (journal handle vanishes with it; replica servers and the
    zombie's sockets stay up); `recover()` builds the successor from
    the journal through the same factory."""

    def __init__(self, lm, jpath, **mgr_kw):
        self.wrappers = {}
        self.stales = []
        self._lm = lm
        self.jpath = jpath
        self.mgr = FleetManager(self._factory, journal=jpath, **mgr_kw)

    def _factory(self, name):
        srv = ContinuousDecodeServer(
            self._lm, slots=2, prompt_buckets=(8, 16),
            metrics=ServingMetrics(name=name), instance=name)
        rs = ReplicaServer(srv)
        self.wrappers[name] = rs
        return RemoteReplica("127.0.0.1", rs.port, name=name,
                             heartbeat_interval=0.05)

    def start(self):
        self.mgr.start()
        for n in self.mgr.replicas:     # compile off the clock
            self.mgr.replica(n).generate([1, 2, 3], 2, timeout=120)
        return self.mgr

    def abandon(self):
        """The manager 'dies': drop its journal handle the way process
        death would, keep the object as the zombie predecessor."""
        stale = self.mgr
        j, stale._journal = stale._journal, None
        if j is not None:
            j.close()
        self.stales.append(stale)
        return stale

    def recover(self, **kw):
        self.mgr = FleetManager.recover(self._factory, self.jpath, **kw)
        return self.mgr

    def close(self):
        try:
            self.mgr.stop(timeout=60)
        finally:
            for stale in self.stales:
                for n in list(stale.replicas):
                    try:
                        stale.replica(n)._shutdown_local(
                            ServerClosedError("test teardown"),
                            dead=False)
                    except Exception:   # noqa: BLE001
                        pass
                stale._running = False
            for rs in self.wrappers.values():
                rs.close(stop_server=False)


@pytest.fixture
def jpath(tmp_path):
    return str(tmp_path / "fleet.journal")


# ---------------------------------------------------------------------------
# (a) recovery + re-adoption, (b) epoch fencing
# ---------------------------------------------------------------------------
class TestRecovery:
    def test_kill_recover_readopts_and_fences(self, jpath):
        lm = _lm()
        prompts = [[1 + i, 2, 3] for i in range(4)]
        fleet = _JournaledFleet(lm, jpath, n_replicas=2,
                                policy="round_robin")
        try:
            mgr = fleet.start()
            assert mgr.epoch == 1
            refs = [list(mgr.generate(p, 6, timeout=120))
                    for p in prompts]
            fv = mgr.fleet_view()
            pre_done = {n: fv.flat(n).get("completed") or 0
                        for n in fv.instances}
            listed = set(mgr.replicas)
            stale = fleet.abandon()
            # the predecessor still has DATA-PLANE work in flight when
            # the successor takes over — the fence must not touch it
            inflight = [stale.submit(p, 6, deadline_ms=600_000)
                        for p in prompts]
            mgr2 = fleet.recover(n_replicas=2, policy="round_robin")
            assert mgr2.epoch == 2
            assert set(mgr2.replicas) == listed     # re-adopted, not
            assert mgr2.metrics.count_value(        # respawned
                "replicas_adopted") == 2
            assert mgr2.fleet_snapshot()["fleet_replica_spawned"] == 0
            # streams across the restart: bit-identical to pre-kill
            assert [list(mgr2.generate(p, 6, timeout=120))
                    for p in prompts] == refs
            # federated counters monotone across the manager restart
            fv2 = mgr2.fleet_view()
            for n in fv2.instances:
                assert (fv2.flat(n).get("completed") or 0) \
                    >= pre_done.get(n, 0)
            # FENCING: the zombie's next control op gets the typed
            # refusal, counted replica-side AND on the stale client
            victim = next(iter(listed))
            with pytest.raises(StaleEpochError):
                stale.replica(victim).drain(timeout=10.0)
            assert mgr2.fleet_snapshot()["fleet_fenced_ops"] >= 1
            assert stale.metrics.count_value("fenced_ops") >= 1
            # zero requests lost: the zombie's in-flight futures all
            # resolved bit-identically through the fence
            assert [list(f.result(120)) for f in inflight] == refs
        finally:
            fleet.close()

    def test_empty_journal_recovers_empty_then_backfills(self, jpath):
        lm = _lm()
        fleet = _JournaledFleet(lm, jpath, n_replicas=2)
        try:
            # never started: the journal on disk holds only this
            # manager's epoch record — no roster to adopt
            mgr = fleet.recover(n_replicas=2)
            assert mgr.metrics.count_value("replicas_adopted") == 0
            assert mgr.n_alive() == 2           # backfilled, fresh
        finally:
            fleet.close()

    def test_empty_journal_no_backfill_is_empty_fleet(self, tmp_path):
        mgr = FleetManager.recover(
            lambda name: (_ for _ in ()).throw(AssertionError(
                "no spawn may happen with backfill=False")),
            str(tmp_path / "absent.journal"), backfill=False,
            n_replicas=2)
        assert mgr.n_alive() == 0
        assert mgr.metrics.count_value("replicas_adopted") == 0
        mgr._running = False

    def test_recovered_manager_still_gets_control_thread(self, tmp_path):
        # recover() marks the manager running; the public
        # start(control_interval_s=...) must still attach the control
        # thread — and never a second one
        mgr = FleetManager.recover(
            lambda name: (_ for _ in ()).throw(AssertionError(
                "no spawn may happen with backfill=False")),
            str(tmp_path / "absent.journal"), backfill=False,
            n_replicas=2)
        try:
            assert mgr._ctl_thread is None
            mgr.start(control_interval_s=30.0)
            t = mgr._ctl_thread
            assert t is not None and t.is_alive()
            mgr.start(control_interval_s=30.0)
            assert mgr._ctl_thread is t
        finally:
            mgr.stop(timeout=10)

    def test_recover_accepts_control_interval(self, tmp_path):
        mgr = FleetManager.recover(
            lambda name: (_ for _ in ()).throw(AssertionError(
                "no spawn may happen with backfill=False")),
            str(tmp_path / "absent.journal"), backfill=False,
            n_replicas=2, control_interval_s=30.0)
        try:
            assert mgr._ctl_thread is not None
            assert mgr._ctl_thread.is_alive()
        finally:
            mgr.stop(timeout=10)


# ---------------------------------------------------------------------------
# (c) reconcile rules
# ---------------------------------------------------------------------------
class TestReconcile:
    def test_mid_drain_replica_never_readopted(self, jpath):
        lm = _lm()
        fleet = _JournaledFleet(lm, jpath, n_replicas=2)
        try:
            mgr = fleet.start()
            doomed = mgr.replicas[0]
            # the predecessor journaled drain INTENT and died before
            # the completion record — resurrection would route new
            # work at a replica mid-goodbye
            mgr._journal_append("drain_begin", name=doomed)
            fleet.abandon()
            mgr2 = fleet.recover(n_replicas=2)
            assert doomed not in mgr2.replicas
            assert mgr2.n_alive() == 2          # backfilled past it
        finally:
            fleet.close()

    def test_half_finished_canary_rolls_back(self, jpath):
        lm = _lm()
        fleet = _JournaledFleet(lm, jpath, n_replicas=2)
        try:
            mgr = fleet.start()
            canary = mgr.replicas[0]
            mgr._journal_append("canary_begin", name=canary, version=1)
            fleet.abandon()
            mgr2 = fleet.recover(n_replicas=2)
            # the canary alone held unvetted params: deterministic
            # rollback by crash, backfill rebuilt on factory params
            assert mgr2.metrics.count_value("canary_rollbacks") == 1
            assert canary not in mgr2.replicas
            assert mgr2.n_alive() == 2
        finally:
            fleet.close()

    def test_recycled_port_identity_mismatch_refused(self, tmp_path):
        lm = _lm()
        jp = str(tmp_path / "fleet.journal")
        # an UNRELATED server now owns the journaled port: its HELLO
        # claims a different instance (and pid/start-time would also
        # miss) — adoption must refuse without sending it a control
        # frame
        srv = ContinuousDecodeServer(
            lm, slots=2, prompt_buckets=(8, 16),
            metrics=ServingMetrics(name="imposter"),
            instance="imposter")
        rs = ReplicaServer(srv)
        try:
            with FleetJournal(jp) as j:
                j.append("epoch", epoch=1)
                j.append("spawn", name="i0", seq=0, host="127.0.0.1",
                         port=rs.port, pid=999999, start_time=1.0)
            mgr = FleetManager.recover(
                lambda name: (_ for _ in ()).throw(AssertionError(
                    "mismatch must refuse, not respawn here")),
                jp, backfill=False, n_replicas=1)
            assert mgr.metrics.count_value(
                "adopt_identity_mismatch") == 1
            assert mgr.n_alive() == 0
            mgr._running = False
            # local-only teardown: the imposter was NEVER stopped — it
            # still serves its own clients
            rr = RemoteReplica("127.0.0.1", rs.port, name="imposter",
                               heartbeat_interval=0.05)
            try:
                assert list(rr.generate([1, 2, 3], 4, timeout=120)) \
                    == list(lm.generate([1, 2, 3], 4))
            finally:
                rr.stop(drain=True)
        finally:
            rs.close(stop_server=False)

    def test_clean_exit_identity_file_skips_dial(self, tmp_path):
        jp = str(tmp_path / "fleet.journal")
        with FleetJournal(jp) as j:
            j.append("epoch", epoch=1)
            # journaled at a port nobody listens on; identity_dir has
            # no i0.json -> clean exit, skipped WITHOUT a dial (a dial
            # would raise/yield replica_dead, not replica_drained)
            j.append("spawn", name="i0", seq=0, host="127.0.0.1",
                     port=1, pid=1, start_time=1.0)
        mgr = FleetManager.recover(
            lambda name: (_ for _ in ()).throw(AssertionError(
                "backfill off: no spawn")),
            jp, backfill=False, identity_dir=str(tmp_path),
            n_replicas=1)
        assert mgr.n_alive() == 0
        assert mgr.metrics.count_value("replicas_adopted") == 0
        recs = [r for r in replay_journal(jp)
                if r.get("name") == "i0" and r["kind"] != "spawn"]
        assert [r["kind"] for r in recs] == ["replica_drained"]
        mgr._running = False


# ---------------------------------------------------------------------------
# (d) zero-added-dispatch A/B
# ---------------------------------------------------------------------------
class TestDispatchAB:
    def test_journal_and_epoch_add_zero_dispatches(self, jpath):
        """THE no-fault A/B: the SAME sequential workload through the
        journaled+epoch-fenced wire fleet and the journal-less
        wire fleet — per-replica (dispatches, tokens_out) IDENTICAL,
        streams bit-identical. Journal appends and epoch HELLOs are
        host-side; they must never buy a token with a dispatch."""
        lm = _lm()
        prompts = [[1 + i, 2, 3] for i in range(6)]
        counts, outs = {}, {}
        fleet = _JournaledFleet(lm, jpath, n_replicas=2,
                                policy="round_robin")
        try:
            mgr = fleet.start()
            assert mgr.epoch == 1       # epoch plumbing really on
            outs["journaled"] = [mgr.generate(p, 5, timeout=120)
                                 for p in prompts]
            counts["journaled"] = [
                (mgr.replica(n).metrics.count_value("dispatches"),
                 mgr.replica(n).metrics.count_value("tokens_out"))
                for n in mgr.replicas]
        finally:
            fleet.close()

        wrappers = {}

        def plain_factory(name):
            srv = ContinuousDecodeServer(
                lm, slots=2, prompt_buckets=(8, 16),
                metrics=ServingMetrics(name=name), instance=name)
            rs = ReplicaServer(srv)
            wrappers[name] = rs
            return RemoteReplica("127.0.0.1", rs.port, name=name,
                                 heartbeat_interval=0.05)
        try:
            with FleetManager(plain_factory, n_replicas=2,
                              policy="round_robin") as mgr:
                for n in mgr.replicas:
                    mgr.replica(n).generate([1, 2, 3], 2, timeout=120)
                assert mgr.epoch == 0   # no journal -> no epoch
                outs["plain"] = [mgr.generate(p, 5, timeout=120)
                                 for p in prompts]
                counts["plain"] = [
                    (mgr.replica(n).metrics.count_value("dispatches"),
                     mgr.replica(n).metrics.count_value("tokens_out"))
                    for n in mgr.replicas]
        finally:
            for rs in wrappers.values():
                rs.close(stop_server=False)
        assert counts["journaled"] == counts["plain"]
        assert [list(r) for r in outs["journaled"]] == \
            [list(r) for r in outs["plain"]]


# ---------------------------------------------------------------------------
# replica processes
# ---------------------------------------------------------------------------
PROC_NAMES = ("i0", "i1")
PUBLISH_TIMEOUT_S = 120.0


def _replica_main(name, port_file, identity_file, weights):
    """A child: the port's paged server over the toy model behind
    `run_replica_server`, until STOP/KILL/DRAIN or a signal."""
    import torch
    torch.set_num_threads(1)
    with open(weights, "rb") as fh:
        aux, blocks = pickle.load(fh)
    lm = TransformerLM.from_jax_params(aux, blocks, 2, device="cpu")
    srv = ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8, 16),
                                 paged=True, block_size=8,
                                 metrics=ServingMetrics(name=name),
                                 instance=name)
    run_replica_server(srv, port_file=port_file,
                       identity_file=identity_file)


@pytest.fixture(scope="module")
def replica_procs(tmp_path_factory):
    """Two replica processes; yields {name: (port, Popen)}. A child that
    exits before it publishes its port fails the fixture with its log."""
    d = tmp_path_factory.mktemp("replicas")
    weights = d / "weights.pkl"
    with open(weights, "wb") as fh:
        pickle.dump(jax_weights(3), fh)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    procs, logs = {}, {}
    for name in PROC_NAMES:
        logs[name] = open(d / f"{name}.log", "wb")
        procs[name] = subprocess.Popen(
            [sys.executable, __file__, name, str(d / f"{name}.port"),
             str(d / f"{name}.json"), str(weights)],
            env=env, cwd=str(REPO), stdout=logs[name],
            stderr=subprocess.STDOUT)
    try:
        ports = {}
        t0 = time.monotonic()
        while len(ports) < len(PROC_NAMES):
            for name, p in procs.items():
                pf = d / f"{name}.port"
                if name not in ports and pf.exists():
                    ports[name] = int(pf.read_text())
                elif name not in ports and p.poll() is not None:
                    pytest.fail(f"replica process {name} exited "
                                f"({p.returncode}) before publishing its "
                                f"port:\n{(d / f'{name}.log').read_text()}")
            if time.monotonic() - t0 > PUBLISH_TIMEOUT_S:
                pytest.fail("replica processes never published their "
                            "ports")
            time.sleep(0.05)
        yield {name: (ports[name], procs[name]) for name in PROC_NAMES}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait(30)
        for fh in logs.values():
            fh.close()


def _proc_factory(replica_procs, injector=None):
    def make(name):
        port, _ = replica_procs[name]
        return RemoteReplica("127.0.0.1", port, name=name,
                             heartbeat_interval=0.05,
                             fault_injector=injector)
    return make


def _detach(mgr):
    """Drop a manager's wire clients locally, leaving the processes
    serving (a STOP frame would end them)."""
    for n in list(mgr.states()):
        try:
            mgr.replica(n)._shutdown_local(
                ServerClosedError("test teardown"), dead=False)
        except Exception:   # noqa: BLE001 - tombstones have no client
            pass
    mgr._running = False
    j, mgr._journal = mgr._journal, None
    if j is not None:
        j.close()


def _counter(mgr, name, key):
    snap = mgr.replica(name).metrics.kind_snapshot()
    return (snap.get(key) or {}).get("value") or 0


def test_processes_dedup_then_sigkill_reaped_and_failed_over(
        replica_procs):
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
    lm = _lm()
    refs = {tuple(p): list(lm.generate(p, 32)) for p in prompts}
    inj = FaultInjector()
    mgr = FleetManager(_proc_factory(replica_procs, inj), n_replicas=2,
                       min_replicas=1, policy="round_robin",
                       heartbeat_timeout=2.0).start()
    try:
        assert mgr.replicas == list(PROC_NAMES)
        for n in mgr.replicas:
            mgr.replica(n).generate([1, 2, 3], 2, timeout=120)
        # a STREAM severed on arrival: reconnect, re-SUBMIT, the
        # registry re-delivers; one decode, the same bits
        before = {n: (_counter(mgr, n, "received"),
                      _counter(mgr, n, "dispatches")) for n in PROC_NAMES}
        inj.plan("serve.wire.stream",
                 on_call=inj.calls("serve.wire.stream"), sever=True,
                 exc=None)
        assert list(mgr.generate([4, 5], 24, timeout=120)) == \
            list(lm.generate([4, 5], 24))
        after = {n: (_counter(mgr, n, "received"),
                     _counter(mgr, n, "dispatches")) for n in PROC_NAMES}
        moved = {n for n in PROC_NAMES if after[n] != before[n]}
        (served,) = moved
        assert after[served][0] - before[served][0] == 1
        assert mgr.fleet_snapshot()["fleet_wire_retries"] == 1
        # SIGKILL one process with requests aboard: its heartbeat goes
        # silent, the tick reaps it, its requests replay on the survivor
        futs = [mgr.submit(prompts[i % 3], 32) for i in range(6)]
        victim_pid = replica_procs["i1"][1].pid
        os.kill(victim_pid, signal.SIGKILL)
        _wait(lambda: not mgr.replica("i1").alive, timeout=60.0,
              msg="heartbeat reap of the killed process")
        tick = mgr.control_tick()
        assert tick["states"]["i1"] == "dead"
        for i, f in enumerate(futs):
            assert list(f.result(120)) == refs[tuple(prompts[i % 3])]
        snap = mgr.fleet_snapshot()
        assert snap["fleet_replica_dead"] == 1
        assert snap["fleet_failover_resubmitted"] >= 1
    finally:
        _detach(mgr)


def test_process_manager_drop_recover_readopts_and_fences(
        replica_procs, tmp_path):
    jpath = str(tmp_path / "fleet.journal")
    factory = _proc_factory(replica_procs)
    lm = _lm()
    mgr = FleetManager(factory, n_replicas=1, journal=jpath).start()
    stale = None
    mgr2 = None
    try:
        assert mgr.replicas == ["i0"] and mgr.epoch == 1
        ref = list(mgr.generate([2, 3, 4], 12, timeout=120))
        assert ref == list(lm.generate([2, 3, 4], 12))
        pre = mgr.fleet_view().flat("i0").get("completed") or 0
        # the manager process "dies": no stop(), its journal handle
        # goes with it
        stale = mgr
        j, stale._journal = stale._journal, None
        j.close()
        mgr2 = FleetManager.recover(factory, jpath, n_replicas=1)
        assert mgr2.epoch == 2 and mgr2.replicas == ["i0"]
        assert mgr2.metrics.count_value("replicas_adopted") == 1
        assert mgr2.fleet_snapshot()["fleet_replica_spawned"] == 0
        assert list(mgr2.generate([2, 3, 4], 12, timeout=120)) == ref
        assert (mgr2.fleet_view().flat("i0").get("completed") or 0) > pre
        with pytest.raises(StaleEpochError):
            stale.replica("i0").drain(timeout=10.0)
        assert stale.metrics.count_value("fenced_ops") >= 1
        assert mgr2.fleet_snapshot()["fleet_fenced_ops"] >= 1
        kinds = [r["kind"] for r in replay_journal(jpath)]
        assert kinds.count("epoch") == 2 and "adopt" in kinds
    finally:
        for m in (stale, mgr2):
            if m is not None:
                _detach(m)


if __name__ == "__main__":
    _replica_main(*sys.argv[1:])
