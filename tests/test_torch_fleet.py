"""The port's fleet plane (obs/fleet.py) and fleet journal
(serving/fleetjournal.py) against the JAX package's copies.

Both are stdlib-only copies of the reference's modules, so the pins are
parity on the same inputs:
  * the journal: the port writes and the reference replays, and the
    reverse; the files are byte-equal for the same records (appends and
    compaction); torn and corrupt files give the same records, or the
    same error type with the same message (which names the record and
    its byte offset), in both; `fold_records` agrees on every kind;
  * obs/fleet: the same Prometheus text parses to the same kind
    snapshots; `FleetView` over the same instances gives the same
    counters, gauges, histograms, quantiles, flat views and snapshot;
    `merge_traces` stitches the port's `Tracer` files into the same
    merged trace; `AutoscaleSignal` takes the same decisions on the same
    observation sequences.
Plus the journal's own write-failure pins (tests/test_fleetjournal.py's
bodies) run on the port's copy.
"""
import json
import random
import struct
import zlib

import pytest

from deeplearning4j_tpu_torch.obs import Tracer
from deeplearning4j_tpu_torch.obs import fleet as pfleet
from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry
from deeplearning4j_tpu_torch.serving import ServingMetrics
from deeplearning4j_tpu_torch.serving import fleetjournal as pj
from deeplearning4j_tpu_torch.serving.kvstate import KVStateError

rj = pytest.importorskip("deeplearning4j_tpu.serving.fleetjournal")
rfleet = pytest.importorskip("deeplearning4j_tpu.obs.fleet")


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------
_RECORD_SETS = {
    "roster": [
        ("epoch", {"epoch": 1}),
        ("spawn", {"name": "i0", "seq": 0, "host": "127.0.0.1",
                   "port": 4242, "pid": 77, "start_time": 1723.456789}),
        ("spawn", {"name": "i1", "seq": 1, "host": "127.0.0.1",
                   "port": 4243, "pid": 78, "start_time": 1723.5}),
        ("drain_begin", {"name": "i0"}),
        ("replica_drained", {"name": "i0", "reason": "scale_down"}),
        ("adopt", {"name": "i7", "seq": 2, "host": "::1", "port": 1,
                   "pid": None, "start_time": None}),
    ],
    "canary_and_containment": [
        ("epoch", {"epoch": 3}),
        ("canary_begin", {"name": "i2", "version": 4}),
        ("params", {"version": 4}),
        ("canary_rolled_forward", {"name": "i2", "version": 4}),
        ("canary_begin", {"name": "i3", "version": 5}),
        ("quarantine", {"fingerprint": "ab" * 32}),
        ("quarantine", {"fingerprint": "ab" * 32}),
        ("breaker", {"state": "open", "strikes": 3, "backoff_s": 0.5}),
        ("replica_dead", {"name": "i3", "reason": "crash"}),
    ],
    "odd_values": [
        ("epoch", {"epoch": 2}),
        ("note", {"text": "naïve ✓  ", "nested": {"b": [1, 2.5],
                                                    "a": None},
                  "big": 2 ** 53 + 1, "neg": -0.0, "tiny": 1e-300}),
        ("spawn", {"name": "x9", "seq": 0}),
        ("manager_stop", {}),
    ],
}


def _write(mod, path, recs):
    with mod.FleetJournal(path) as j:
        for kind, fields in recs:
            j.append(kind, **fields)
    return open(path, "rb").read()


@pytest.mark.parametrize("name", sorted(_RECORD_SETS))
def test_journal_bytes_equal_and_replay_both_ways(tmp_path, name):
    recs = _RECORD_SETS[name]
    port_file, ref_file = tmp_path / "port.journal", tmp_path / "ref.journal"
    a = _write(pj, port_file, recs)
    b = _write(rj, ref_file, recs)
    assert a == b
    got_ref = rj.replay_journal(str(port_file))
    got_port = pj.replay_journal(str(ref_file))
    assert got_ref == got_port == [{"kind": k, **f} for k, f in recs]
    for prefix in ("i", "x"):
        assert pj.fold_records(got_port, name_prefix=prefix) == \
            rj.fold_records(got_ref, name_prefix=prefix)


@pytest.mark.parametrize("name", sorted(_RECORD_SETS))
def test_journal_compaction_bytes_equal(tmp_path, name):
    recs = _RECORD_SETS[name]
    files = {}
    for tag, mod in (("port", pj), ("ref", rj)):
        path = str(tmp_path / f"{tag}.journal")
        with mod.FleetJournal(path) as j:
            for kind, fields in recs:
                j.append(kind, **fields)
            snap = j.compact()
            j.append("spawn", name="i9", seq=9)
        files[tag] = (open(path, "rb").read(), snap)
    assert files["port"] == files["ref"]
    path = str(tmp_path / "port.journal")
    assert pj.fold_records(pj.replay_journal(path)) == \
        rj.fold_records(rj.replay_journal(path))


def _damaged(tmp_path):
    """Damaged copies of one 3-record journal: (label, bytes)."""
    data = _write(pj, str(tmp_path / "src.journal"),
                  _RECORD_SETS["roster"][:3])
    hdr = struct.Struct("<II")
    first_end = hdr.size + hdr.unpack_from(data, 0)[0]
    out = [("cut_payload_1", data[:-1]), ("cut_payload_7", data[:-7]),
           ("cut_header", data[:first_end + 4]),
           ("cut_at_boundary", data[:first_end]), ("empty", b"")]
    for off in (2, 10, first_end + 3, len(data) - 2):
        flip = bytearray(data)
        flip[off] ^= 0xFF
        out.append((f"flip_{off}", bytes(flip)))
    bad_json = b"{not json"
    frame = hdr.pack(len(bad_json), zlib.crc32(bad_json)) + bad_json
    out.append(("undecodable_mid", data[:first_end] + frame
                + data[first_end:]))
    out.append(("undecodable_tail", data + frame))
    out.append(("oversized_tail", data + hdr.pack(1 << 20, 0)))
    return out


def _outcome(fn, path):
    try:
        return ("ok", fn(path))
    except Exception as e:   # noqa: BLE001 - each package's own family
        return (type(e).__name__, str(e))


def test_journal_damage_same_records_or_same_error(tmp_path):
    """Every damaged file: the same records from both replays, or the
    same error class and message (record index and byte offset)."""
    seen = set()
    for label, data in _damaged(tmp_path):
        path = str(tmp_path / f"{label}.journal")
        with open(path, "wb") as fh:
            fh.write(data)
        port, ref = _outcome(pj.replay_journal, path), \
            _outcome(rj.replay_journal, path)
        assert port == ref, label
        seen.add(port[0])
    # both kinds of outcome were exercised
    assert seen == {"ok", "JournalCorruptError"}


def test_journal_errors_are_the_ports_kvstate_family(tmp_path):
    data = bytearray(_write(pj, str(tmp_path / "j"),
                            _RECORD_SETS["roster"][:2]))
    data[10] ^= 0xFF
    path = str(tmp_path / "bad.journal")
    with open(path, "wb") as fh:
        fh.write(bytes(data))
    with pytest.raises(KVStateError):
        pj.replay_journal(path)
    with pj.FleetJournal(str(tmp_path / "j2")) as j:
        j._broken = True
        with pytest.raises(KVStateError):
            j.append("epoch", epoch=1)


def test_journal_failed_append_truncates_to_good_boundary(tmp_path,
                                                          monkeypatch):
    """tests/test_fleetjournal.py's pin on the port's copy."""
    jpath = str(tmp_path / "fleet.journal")

    def boom(fd):
        raise OSError("disk full")
    with pj.FleetJournal(jpath) as j:
        j.append("epoch", epoch=1)
        good = j._good
        monkeypatch.setattr(pj.os, "fsync", boom)
        with pytest.raises(OSError):
            j.append("spawn", name="i0", seq=0)
        monkeypatch.undo()
        assert j._good == good
        j.append("spawn", name="i1", seq=1)
    recs = pj.replay_journal(jpath)
    assert [r["kind"] for r in recs] == ["epoch", "spawn"]
    assert recs[1]["name"] == "i1"


def test_journal_broken_refuses_further_appends(tmp_path, monkeypatch):
    """tests/test_fleetjournal.py's pin on the port's copy."""
    jpath = str(tmp_path / "fleet.journal")
    j = pj.FleetJournal(jpath)
    j.append("epoch", epoch=1)
    real_fh = j._fh

    class TornFile:         # dies 5 bytes into the record
        def write(self, mv):
            real_fh.write(bytes(mv[:5]))
            raise OSError("disk full mid-record")

        def fileno(self):
            return real_fh.fileno()

        def close(self):
            real_fh.close()

    def boom(*a):
        raise OSError("disk gone")
    monkeypatch.setattr(pj.os, "ftruncate", boom)
    j._fh = TornFile()
    with pytest.raises(OSError):
        j.append("spawn", name="i0", seq=0)
    monkeypatch.undo()
    j._fh = real_fh
    with pytest.raises(pj.JournalBrokenError):
        j.append("spawn", name="i1", seq=1)
    j.close()
    assert [r["kind"] for r in pj.replay_journal(jpath)] == ["epoch"]


def test_journal_counts_into_sink(tmp_path):
    m = ServingMetrics(name="fleet")
    with pj.FleetJournal(str(tmp_path / "j"), counters=m) as j:
        j.append("epoch", epoch=1)
        j.append("spawn", name="i0", seq=0)
        j.compact()
    assert m.count_value("journal_records") == 3


# ---------------------------------------------------------------------------
# obs/fleet
# ---------------------------------------------------------------------------
def _instances(seeds=(0, 1, 2), registry=None):
    out = []
    for i, seed in enumerate(seeds):
        m = ServingMetrics(name=f"i{i}", slo_target_ms=50,
                           registry=registry)
        rng = random.Random(seed)
        for _ in range(20 + 10 * i):
            m.record_ttft(rng.uniform(0.1, 400.0))
            m.record_inter_token(rng.uniform(0.1, 40.0))
            m.record_request(rng.uniform(1.0, 100.0), tokens=3)
        m.count("shed_predicted", i)
        m.count("failover_resubmitted", 2 * i)
        m.record_service_rate(100.0 + 17.5 * i)
        m.record_queue_depth(3 * i)
        m.record_occupancy(i, 4)
        m.record_breaker_state(0.5 * (i % 3))
        out.append(m)
    return out


def _views(sources, strip_prefix=""):
    pv, rv = pfleet.FleetView(), rfleet.FleetView()
    for name, src in sources:
        pv.add(name, src, strip_prefix=strip_prefix)
        rv.add(name, src, strip_prefix=strip_prefix)
    return pv, rv


def _readouts(fv):
    out = {"instances": fv.instances, "counters": fv.counters(),
           "snapshot": fv.snapshot(), "shed_share": fv.shed_share()}
    for name in fv.instances:
        out[f"flat:{name}"] = fv.flat(name)
    for g in ("service_rate_tokens_per_sec", "breaker_state",
              "pool_blocks"):
        out[f"gauge:{g}"] = fv.gauge_view(g)
        out[f"gauge_sum:{g}"] = fv.gauge_sum(g)
    for h in ("ttft_ms", "inter_token_ms"):
        out[f"hist:{h}"] = fv.histogram(h)
        for q in (10, 50, 90, 99):
            out[f"q{q}:{h}"] = fv.quantile(h, q)
    return out


@pytest.mark.parametrize("seeds", [(0,), (0, 1, 2), (5, 9, 11, 3)])
def test_fleet_view_equal_on_kind_snapshots(seeds):
    snaps = [(m.name, m.kind_snapshot()) for m in _instances(seeds)]
    pv, rv = _views(snaps)
    assert _readouts(pv) == _readouts(rv)


def test_prometheus_text_parses_and_federates_equally():
    reg = MetricsRegistry()
    ms = _instances((4, 7), registry=reg)
    for inst in (None, "i0", "i1"):
        text = reg.prometheus_text(namespace="dl4j_tpu", instance=inst)
        assert pfleet.parse_prometheus_text(text) == \
            rfleet.parse_prometheus_text(text)
        for m in ms:
            prefix = f"dl4j_tpu_serving_{m.name}_"
            assert pfleet.parse_prometheus_text(
                text, strip_prefix=prefix, instance=inst) == \
                rfleet.parse_prometheus_text(
                    text, strip_prefix=prefix, instance=inst)
    text = reg.prometheus_text(namespace="dl4j_tpu", instance="i0")
    pv, rv = _views([("i0", text)], strip_prefix="dl4j_tpu_serving_i0_")
    assert _readouts(pv) == _readouts(rv)


def test_fleet_view_refusals_match():
    a, b = ServingMetrics(name="a"), ServingMetrics(name="b")
    a.count("completed", 2)
    sa, sb = a.kind_snapshot(), b.kind_snapshot()
    sb["completed"] = {"kind": "gauge", "value": 1.0}
    for mod in (pfleet, rfleet):
        with pytest.raises(ValueError):
            mod.FleetView().add("a", sa).add("b", sb).counters()


def _saved_trace(tmp_path, name, n_spans, seed):
    tr = Tracer(enabled=True)
    rng = random.Random(seed)
    for i in range(n_spans):
        with tr.span(f"op{i % 3}", cat="serve", track=f"req-{i}",
                     trace_id=f"{name}-{i}", n=i):
            sum(range(rng.randint(10, 200)))
        tr.instant("mark", cat="serve", track="server", i=i)
    path = tmp_path / f"{name}.json"
    tr.save(str(path), process_name=name)
    return json.loads(path.read_text())


def test_merge_traces_equal(tmp_path):
    traces = [_saved_trace(tmp_path, f"r{i}", 4 + i, i) for i in range(3)]
    anchorless = {"traceEvents": [e for e in traces[0]["traceEvents"]
                                  if e.get("name") != "clock_sync"]}
    for ts, names in ((traces, None), (traces, ["a", "b", "c"]),
                      (traces[:1], None), ([anchorless] + traces[1:], None)):
        assert pfleet.merge_traces(ts, names=names) == \
            rfleet.merge_traces(ts, names=names)


def _regime_observations(seed):
    rng = random.Random(seed)
    regimes = [dict(n=8, shed_rate=0, service=1000.0, occ=0.7),
               dict(n=10, shed_rate=12, service=1000.0, occ=0.95),
               dict(n=6, shed_rate=12, service=1600.0, occ=0.95),
               dict(n=10, shed_rate=0, service=300.0, occ=0.1),
               dict(n=4, shed_rate=40, service=900.0, occ=None)]
    cum, out = 0.0, []
    for r in regimes:
        for _ in range(r["n"]):
            cum += r["shed_rate"] * rng.uniform(0.8, 1.2) \
                if r["shed_rate"] else 0.0
            if rng.random() < 0.05:
                cum = 0.0           # a counter reset reads as quiet
            out.append((cum, r["service"] * (1 + rng.uniform(-.05, .05)),
                        r["occ"]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window, hysteresis", [(4, 1), (6, 2), (8, 3)])
def test_autoscale_signal_same_decisions(seed, window, hysteresis):
    sigs = [mod.AutoscaleSignal(window=window, hysteresis=hysteresis)
            for mod in (pfleet, rfleet)]
    decisions = [[], []]
    for i, (sheds, svc, occ) in enumerate(_regime_observations(seed)):
        for s, d in zip(sigs, decisions):
            if i % 2:
                d.append(s.observe(sheds=sheds, service_rate=svc,
                                   occupancy=occ))
            else:
                d.append(s.observe({"fleet_shed_predicted": sheds,
                                    "fleet_service_rate_tokens_per_sec":
                                        svc,
                                    "fleet_occupancy_mean": occ}))
            if i == 25:
                s.reset()
    assert decisions[0] == decisions[1]
    assert sigs[0].transitions == sigs[1].transitions
    assert len(set(decisions[0])) >= 2      # the sequence moves


def test_autoscale_signal_validation_matches():
    for kw in ({"window": 3}, {"hysteresis": 0}):
        for mod in (pfleet, rfleet):
            with pytest.raises(ValueError):
                mod.AutoscaleSignal(**kw)


def test_shed_keys_and_exports_match():
    assert pfleet.SHED_KEYS == rfleet.SHED_KEYS
    import deeplearning4j_tpu_torch.obs as pobs
    for name in ("FleetView", "AutoscaleSignal", "merge_traces",
                 "parse_prometheus_text"):
        assert getattr(pobs, name) is getattr(pfleet, name)
