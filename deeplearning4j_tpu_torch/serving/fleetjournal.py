"""Durable fleet-control journal: the manager's write-ahead intent log.

The port's copy of deeplearning4j_tpu/serving/fleetjournal.py (stdlib
only), held against it by tests/test_torch_fleet.py; the text below is the
reference's.

`FleetManager` (serving/fleet.py) keeps the whole control plane — the
replica roster, canary state machine, autoscale history, drains in
flight — in process memory. This module makes that state durable with
the smallest possible machinery: an append-only, fsync'd,
length-prefixed + checksummed record log of fleet *intent*, one JSON
record per state transition.

Record framing (little-endian, `_HDR`)::

    u32 payload-len | u32 crc32(payload) | payload (UTF-8 JSON)

Every record is a flat JSON object with at least a ``"kind"`` field;
the rest of the fields are kind-specific (see ARCHITECTURE.md's
"Durable control plane" table). `append()` flushes and fsyncs before
returning, so a record the manager acted on is on disk before the
action's effects can be observed.

Replay follows the kvstate crash-safety discipline
(serving/kvstate.py): the *final* record may be torn — the process
died mid-write — and is dropped silently; any malformed record with
bytes after it means the file was corrupted at rest, and replay
refuses loudly with `JournalCorruptError` (a `KVStateError`) rather
than hand the manager a roster with a hole in the middle.

`fold_records()` reduces a replayed record list to the recovery
intent `FleetManager.recover()` reconciles against: current epoch,
live roster (with wire identity: host/port/pid/start_time), the
highest minted replica ordinal (so minted names stay unique across
manager generations), the shipped parameter version, and any canary
rollout that was in flight when the journal stopped.

Stdlib-only on purpose: the journal must be writable and replayable
from a process that never imports jax (tools/analyze/layers.toml pins
this module into the stdlib-only layer).
"""
from __future__ import annotations

import json
import os
import struct
import threading
import zlib

from .kvstate import KVStateError

__all__ = ["FleetJournal", "JournalBrokenError", "JournalCorruptError",
           "replay_journal", "fold_records"]

# u32 payload length | u32 crc32 of the payload bytes
_HDR = struct.Struct("<II")


class JournalCorruptError(KVStateError):
    """A journal record *before* the final one failed its length or
    checksum: the file was damaged at rest, not torn by a crash.
    Recovery must not guess at the missing history."""


class JournalBrokenError(KVStateError):
    """A previous `append()` failed mid-record AND the truncate back to
    the last good record boundary also failed: the tail of the file may
    hold torn bytes. Writing more records after them would convert a
    recoverable torn tail into mid-file corruption, so the writer
    refuses every further append."""


class FleetJournal:
    """Append-only writer. Opens in append mode so a recovered manager
    continues the same file its predecessor wrote; every `append()` is
    fsync'd before it returns. Appends are serialized under an internal
    lock and each record is written as ONE contiguous unbuffered write
    — crash/drain paths journal from done-callback and heartbeat-reap
    threads while the control thread journals spawns, and interleaving
    two records' bytes would corrupt the file mid-stream. If a write
    fails partway (e.g. ENOSPC), the file is truncated back to the last
    known-good record boundary so the tear stays at EOF where replay
    tolerates it; if even the truncate fails, the journal marks itself
    broken and refuses further appends (`JournalBrokenError`). Counts
    each durable record into the optional counters sink
    (``journal_records``) so the journal's activity shows up in the
    fleet federation."""

    def __init__(self, path, counters=None):
        self.path = str(path)
        self._counters = counters
        self._lock = threading.Lock()
        self._broken = False
        # a stale .compacting sibling is a compaction that crashed
        # BEFORE its rename commit point: the original file is intact
        # and authoritative, the half-written snapshot is garbage
        try:
            os.unlink(self.path + ".compacting")
        except OSError:
            pass
        # unbuffered: a record's single write() goes straight to the
        # fd, so there is never a buffer holding half a record that a
        # later truncate/flush could tear differently
        self._fh = open(self.path, "ab", buffering=0)
        self._fh.seek(0, os.SEEK_END)
        self._good = self._fh.tell()    # last known-good record boundary

    def size(self):
        """Bytes of known-good records on disk (the compaction
        trigger's cheap read — no stat round-trip)."""
        with self._lock:
            return self._good

    def append(self, kind, **fields):
        rec = {"kind": str(kind), **fields}
        payload = json.dumps(rec, sort_keys=True).encode("utf-8")
        frame = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            if self._fh is None:
                raise JournalBrokenError(
                    f"fleet journal {self.path}: append after close()")
            if self._broken:
                raise JournalBrokenError(
                    f"fleet journal {self.path}: refusing append after "
                    f"an unrecovered write failure at byte {self._good}")
            try:
                mv = memoryview(frame)
                while mv:
                    mv = mv[self._fh.write(mv):]
                os.fsync(self._fh.fileno())
            except Exception:
                try:
                    os.ftruncate(self._fh.fileno(), self._good)
                except Exception:   # pragma: no cover - disk truly gone
                    self._broken = True
                raise
            self._good += len(frame)
        if self._counters is not None:
            try:
                self._counters.count("journal_records")
            except Exception:       # pragma: no cover - sink is best-effort
                pass
        return rec

    def compact(self, name_prefix="i"):
        """Fold the whole journal into ONE ``snapshot`` record and
        rotate the file atomically. The snapshot carries the complete
        fold state (epoch, roster, max_id, params_version, canary,
        quarantine, breaker), so `fold_records(replay_journal(path))`
        is IDENTICAL before and after compaction — compaction changes
        the file's size, never its meaning.

        Crash-safety is the kvstate rename-last discipline: the
        snapshot is written + fsync'd into a ``.compacting`` sibling
        first, and `os.replace` over the live path is the single
        atomic commit point. A crash before it leaves the old journal
        authoritative (the stale sibling is removed at next open); a
        crash after it leaves the compacted journal, which replays to
        the same fold. Returns the snapshot record."""
        with self._lock:
            if self._fh is None:
                raise JournalBrokenError(
                    f"fleet journal {self.path}: compact after close()")
            if self._broken:
                raise JournalBrokenError(
                    f"fleet journal {self.path}: refusing compact "
                    f"after an unrecovered write failure")
            state = fold_records(replay_journal(self.path),
                                 name_prefix=name_prefix)
            rec = {"kind": "snapshot", **state}
            payload = json.dumps(rec, sort_keys=True).encode("utf-8")
            frame = _HDR.pack(len(payload),
                              zlib.crc32(payload)) + payload
            tmp = self.path + ".compacting"
            with open(tmp, "wb") as fh:
                fh.write(frame)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)      # THE commit point
            # the old append handle points at the unlinked inode:
            # reopen on the compacted file before any further append
            self._fh.close()
            self._fh = open(self.path, "ab", buffering=0)
            self._fh.seek(0, os.SEEK_END)
            self._good = self._fh.tell()
        if self._counters is not None:
            try:
                self._counters.count("journal_records")
            except Exception:   # pragma: no cover - sink is best-effort
                pass
        return rec

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def replay_journal(path):
    """Read every intact record from `path`, in order. A missing file
    replays as an empty journal (a manager that never journaled). A
    torn final record — short header, short payload, or a checksum /
    JSON failure that extends exactly to end-of-file — is dropped
    silently: the writer died mid-append and the record never took
    effect. The same failure with bytes *after* it raises
    `JournalCorruptError`."""
    try:
        with open(str(path), "rb") as fh:
            data = fh.read()
    except FileNotFoundError:
        return []
    records = []
    n = len(data)
    off = 0
    while off < n:
        if off + _HDR.size > n:
            break               # torn header at EOF: mid-append crash
        length, crc = _HDR.unpack_from(data, off)
        start = off + _HDR.size
        end = start + length
        if end > n:
            break               # torn payload at EOF: mid-append crash
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            if end == n:
                break           # final record torn mid-write
            raise JournalCorruptError(
                f"fleet journal {path}: checksum mismatch in record "
                f"{len(records)} at byte {off} with "
                f"{n - end} bytes after it")
        try:
            rec = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            if end == n:
                break           # final record torn mid-write
            raise JournalCorruptError(
                f"fleet journal {path}: undecodable record "
                f"{len(records)} at byte {off} with "
                f"{n - end} bytes after it")
        records.append(rec)
        off = end
    return records


def _ordinal(name, prefix):
    """Numeric suffix of a minted replica name (``i7`` -> 7), or None
    for names outside the mint pattern."""
    if not isinstance(name, str) or not name.startswith(prefix):
        return None
    tail = name[len(prefix):]
    return int(tail) if tail.isdigit() else None


def fold_records(records, name_prefix="i"):
    """Reduce a replayed record list to the recovery intent:

    ``epoch``
        highest manager epoch journaled (0 if never).
    ``roster``
        name -> identity dict (``host``/``port``/``pid``/
        ``start_time``/``seq``) for every replica the journal says
        should still be alive. ``spawn`` and ``adopt`` add;
        ``replica_dead`` and ``replica_drained`` remove;
        ``drain_begin`` marks the entry non-re-adoptable (a successor
        must not route to a replica its predecessor was emptying).
    ``max_id``
        highest numeric suffix ever minted under `name_prefix`, so a
        recovered manager resumes its name counter past it.
    ``params_version``
        version tag of the last parameter set rolled forward fleet
        wide (None if never swapped).
    ``canary``
        the in-flight rollout record if a ``canary_begin`` has no
        matching ``canary_rolled_forward``/``canary_rolled_back``,
        else None.
    ``quarantine``
        ordered poison-pill fingerprints (``quarantine`` records): a
        recovered manager must keep shedding a quarantined prompt, not
        resurrect it onto the fresh fleet.
    ``breaker``
        the last journaled spawn-breaker state
        (``{"state", "strikes", "backoff_s"}``) or None: a manager
        that died with the breaker OPEN must not resume the spawn
        crash-loop its predecessor escaped.

    A ``snapshot`` record (written by `FleetJournal.compact()`) seeds
    ALL of the above at once; records after it fold on top.
    """
    epoch = 0
    roster = {}
    max_id = -1
    params_version = None
    canary = None
    quarantine = []
    breaker = None
    for rec in records:
        kind = rec.get("kind")
        name = rec.get("name")
        ordinal = _ordinal(name, name_prefix)
        if ordinal is not None and ordinal > max_id:
            max_id = ordinal
        if kind == "snapshot":
            epoch = max(epoch, int(rec.get("epoch") or 0))
            roster = {k: dict(v)
                      for k, v in (rec.get("roster") or {}).items()}
            max_id = max(max_id, int(rec.get("max_id", -1)))
            params_version = rec.get("params_version")
            canary = rec.get("canary")
            quarantine = list(rec.get("quarantine") or ())
            breaker = rec.get("breaker")
        elif kind == "epoch":
            epoch = max(epoch, int(rec.get("epoch") or 0))
        elif kind in ("spawn", "adopt"):
            roster[name] = {
                "host": rec.get("host"), "port": rec.get("port"),
                "pid": rec.get("pid"),
                "start_time": rec.get("start_time"),
                "seq": rec.get("seq"), "draining": False}
        elif kind == "drain_begin":
            if name in roster:
                roster[name]["draining"] = True
        elif kind in ("replica_dead", "replica_drained"):
            roster.pop(name, None)
        elif kind == "params":
            params_version = rec.get("version")
        elif kind == "canary_begin":
            canary = dict(rec)
        elif kind in ("canary_rolled_forward", "canary_rolled_back"):
            canary = None
        elif kind == "quarantine":
            fp = rec.get("fingerprint")
            if fp and fp not in quarantine:
                quarantine.append(fp)
        elif kind == "breaker":
            breaker = {"state": rec.get("state"),
                       "strikes": rec.get("strikes"),
                       "backoff_s": rec.get("backoff_s")}
    return {"epoch": epoch, "roster": roster, "max_id": max_id,
            "params_version": params_version, "canary": canary,
            "quarantine": quarantine, "breaker": breaker}
