"""StatsStorage backends + routing.

The port's copy of deeplearning4j_tpu/ui/storage.py (stdlib only), the
equivalent of reference ui-model storage/: the StatsStorage API
(sessions, static infos, updates, listeners for live UI push),
InMemoryStatsStorage, FileStatsStorage (JSON-lines replacing MapDB/SQLite),
and RemoteUIStatsStorageRouter (HTTP POST of reports to a remote UI server —
deeplearning4j-core api/storage/impl/RemoteUIStatsStorageRouter.java).
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
import urllib.request


class StatsStorageRouter:
    """Write-side interface (reference: api/storage/StatsStorageRouter.java)."""

    def put_static_info(self, info):
        raise NotImplementedError

    def put_update(self, update):
        raise NotImplementedError

    putStaticInfo = put_static_info
    putUpdate = put_update


class BaseStatsStorage(StatsStorageRouter):
    """Read side (what the UI consumes) + listener push.
    reference: api/storage/StatsStorage.java."""

    def __init__(self):
        self._static = {}        # session -> info
        self._updates = {}       # session -> list[update]
        self._listeners = []
        self._lock = threading.Lock()

    # -- write ----------------------------------------------------------
    def put_static_info(self, info):
        with self._lock:
            self._static[info["sessionId"]] = info
        self._notify("static", info)

    def put_update(self, update):
        with self._lock:
            self._updates.setdefault(update["sessionId"], []).append(update)
        self._notify("update", update)

    # -- read -----------------------------------------------------------
    def list_session_ids(self):
        with self._lock:
            return sorted(set(self._static) | set(self._updates))

    listSessionIDs = list_session_ids

    def get_static_info(self, session_id):
        return self._static.get(session_id)

    getStaticInfo = get_static_info

    def get_all_updates(self, session_id):
        with self._lock:
            return list(self._updates.get(session_id, []))

    getAllUpdates = get_all_updates

    def get_latest_update(self, session_id):
        ups = self._updates.get(session_id)
        return ups[-1] if ups else None

    getLatestUpdate = get_latest_update

    # -- listeners ------------------------------------------------------
    def register_stats_storage_listener(self, fn):
        self._listeners.append(fn)

    registerStatsStorageListener = register_stats_storage_listener

    def _notify(self, kind, payload):
        for fn in self._listeners:
            try:
                fn(kind, payload)
            except Exception:
                pass


class InMemoryStatsStorage(BaseStatsStorage):
    """reference: ui-model storage/InMemoryStatsStorage.java"""


class FileStatsStorage(BaseStatsStorage):
    """JSON-lines persistence (one record per line, replayed on open) —
    stands in for the reference's FileStatsStorage/MapDB/SQLite backends."""

    def __init__(self, path):
        super().__init__()
        self.path = str(path)
        if os.path.exists(self.path):
            self._replay()

    def _replay(self):
        with open(self.path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec["kind"] == "static":
                    super().put_static_info(rec["data"])
                else:
                    super().put_update(rec["data"])

    def _append(self, kind, data):
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps({"kind": kind, "data": data}) + "\n")

    def put_static_info(self, info):
        self._append("static", info)
        super().put_static_info(info)

    def put_update(self, update):
        self._append("update", update)
        super().put_update(update)


class SqliteStatsStorage(BaseStatsStorage):
    """SQLite-backed persistence — parity with the reference's
    J7FileStatsStorage (ui-model storage/sqlite/J7FileStatsStorage.java):
    a single-file relational store that supports concurrent readers and
    incremental queries, where the JSON-lines FileStatsStorage must replay
    the whole log. Uses stdlib sqlite3 (the reference bundles its own JDBC
    library); updates are indexed by (session, insertion order) so
    `get_updates_since` is a range scan, not a replay."""

    def __init__(self, path):
        super().__init__()
        self.path = str(path)
        self._db = sqlite3.connect(self.path, check_same_thread=False)
        self._db_lock = threading.Lock()   # separate from the (non-reentrant)
        #                                    base listener/index lock
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS static_info ("
            " session_id TEXT PRIMARY KEY, data TEXT NOT NULL)")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS updates ("
            " id INTEGER PRIMARY KEY AUTOINCREMENT,"
            " session_id TEXT NOT NULL, data TEXT NOT NULL)")
        self._db.execute(
            "CREATE INDEX IF NOT EXISTS idx_updates_session"
            " ON updates(session_id, id)")
        self._db.commit()
        self._load()

    def _load(self):
        for (data,) in self._db.execute("SELECT data FROM static_info"):
            BaseStatsStorage.put_static_info(self, json.loads(data))
        for (data,) in self._db.execute(
                "SELECT data FROM updates ORDER BY id"):
            BaseStatsStorage.put_update(self, json.loads(data))

    def put_static_info(self, info):
        with self._db_lock:
            self._db.execute(
                "INSERT OR REPLACE INTO static_info VALUES (?, ?)",
                (info["sessionId"], json.dumps(info)))
            self._db.commit()
            super().put_static_info(info)

    def put_update(self, update):
        # both appends under ONE lock so DB rowid order == in-memory list
        # order (get_updates_since's index contract) under concurrent
        # writers; the base _lock nests inside and never takes _db_lock
        with self._db_lock:
            self._db.execute(
                "INSERT INTO updates (session_id, data) VALUES (?, ?)",
                (update["sessionId"], json.dumps(update)))
            self._db.commit()
            super().put_update(update)

    def get_updates_since(self, session_id, after_index):
        """Incremental poll: updates with insertion index > after_index
        (0-based position in get_all_updates order) — the query pattern the
        live UI uses instead of refetching everything."""
        with self._db_lock:
            rows = self._db.execute(
                "SELECT data FROM updates WHERE session_id = ?"
                " ORDER BY id LIMIT -1 OFFSET ?",
                (session_id, int(after_index) + 1)).fetchall()
        return [json.loads(d) for (d,) in rows]

    def close(self):
        self._db.close()


class RemoteUIStatsStorageRouter(StatsStorageRouter):
    """POST reports to a remote UI server (reference:
    deeplearning4j-core RemoteUIStatsStorageRouter — used by cluster workers
    to route stats to the UI beside the coordinating process)."""

    def __init__(self, url, timeout=5.0):
        self.url = url.rstrip("/")
        self.timeout = float(timeout)

    def _post(self, endpoint, payload):
        data = json.dumps(payload).encode("utf-8")
        req = urllib.request.Request(
            f"{self.url}{endpoint}", data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.status

    def put_static_info(self, info):
        self._post("/remoteReceive/static", info)

    def put_update(self, update):
        self._post("/remoteReceive/update", update)
