"""Durable, migratable KV state: one serialization primitive for a
request's KV block set, three production scenarios.

The port's copy of deeplearning4j_tpu/serving/kvstate.py (stdlib and numpy), held
against it by tests/test_torch_serving_stdlib.py; the text below is the
reference's. One difference: numpy has no bfloat16 of its own (the
reference's comes from `ml_dtypes`, which the port never imports), so a
bf16 panel is a CPU `torch.bfloat16` tensor here. It is written as its
raw 2-byte words under the dtype name "bfloat16", byte for byte what the
reference writes, and read back as int16 words viewed as bfloat16. Every
other dtype stays a numpy array.

A slot's KV state — its blocks in the arena, its position, its block
table — has always been trapped in the server process: blocks die with
the arena, a preempted request loses every row it paid for, and a
request can never move between server instances. This module makes that
state a first-class HOST-SIDE ARTIFACT:

  * `RequestArtifact` — one live request's KV panel (all real rows
    `[0, pos)`, gathered out of the arena by the zoo's
    `make_block_extract_fn`), its token history (prompt + generated),
    its position, and the PARAM VERSION TAG the rows were computed
    under. Restoring it into any paged decode server running the same
    params resumes the stream bit-identically: the panel rows are the
    same bits prefill/decode would recompute (per-row bits are
    independent of batch shape — the measured property every serving
    pin rests on), so installing them is indistinguishable from having
    computed them.
  * `PrefixCacheArtifact` — the LRU prefix cache's resident blocks
    (token-prefix keys + row panels) under one version tag, saved at
    `stop()` and re-offered by a restarted server: warm system prompts
    survive a crash or a deploy.

Three consumers in `ContinuousDecodeServer` (decode.py):
PREEMPTION (spill a batch-class slot to host, give its blocks to an
interactive request, resume later bit-identically), the persistent
prefix cache above, and MIGRATION (export a live request from one
server, import into another — the seam prefill/decode disaggregation
and replica fleets consume).

Like `kvpool` and `admission`, this module is jax-free (numpy only, for
the host panels the decode server already holds): serialization can
never add a device dispatch, and everything unit-tests without a
device. The on-disk format follows the `ShardedCheckpointManager`
protocol conventions (util/sharded_checkpoint.py) without its orbax
dependency — KV panels are plain host arrays, not sharded jax trees:
one directory per artifact, a raw little-endian `panels.bin` plus a
`manifest.json` describing every array (dtype/shape/offset), committed
CRASH-SAFELY in the manager's ordering (the new artifact is fully
staged — payload first, manifest `os.replace`d last — before the old
one is swapped out, and a loader treats a manifest-less directory as
absent: a crash mid-save leaves the predecessor readable or a clean
cold start, never a destroyed-old-with-no-new and never a
half-readable mix).

VERSION SAFETY is the load-bearing rule: an artifact's rows are only
valid under the exact params that computed them. Every artifact carries
`tag` — the decode server stamps a content fingerprint of its param
version — and every restore path calls `require_tag()` first, which
raises `KVStateVersionError` on mismatch: a prefix cache saved under
params v1 restored into a server running v2 refuses the blocks loudly
(zero silent reuse — the in-process hot-swap invalidation rule,
extended across restarts), and a migration between servers running
different params refuses the request the same way.
"""
from __future__ import annotations

import json
import os
import shutil
import struct

import numpy as np

__all__ = ["RequestArtifact", "PrefixCacheArtifact", "KVStateError",
           "KVStateVersionError", "FORMAT_VERSION", "artifact_kind",
           "artifact_from_bytes"]

# bumped on any incompatible layout change; loaders refuse unknown
# versions loudly instead of misreading bytes
FORMAT_VERSION = 1

_MANIFEST = "manifest.json"
_PANELS = "panels.bin"


class KVStateError(RuntimeError):
    """Base class for durable-KV-state failures (corrupt/missing
    artifact, shape mismatch against the target server)."""


class KVStateVersionError(KVStateError):
    """The artifact's param version tag does not match the target
    server's — its rows were computed under different weights and MUST
    NOT be reused (the cross-restart twin of the in-process hot-swap
    invalidation rule)."""


def artifact_kind(path):
    """'request' / 'prefix_cache' for a committed artifact directory,
    None for anything else (absent, mid-crash payload without its
    manifest, unreadable) — the warm-start probe the decode server runs
    at construction, which must treat every non-artifact as a cold
    start, never an error."""
    mpath = os.path.join(os.path.abspath(path), _MANIFEST)
    try:
        with open(mpath) as fh:
            return json.load(fh).get("kind")
    except (OSError, ValueError):
        return None


def _panels_nbytes(panels):
    return sum(int(a.nbytes) for kv in panels for a in kv)


def _host_array(a):
    """One panel array in the port's host form: a numpy array, or a CPU
    torch.bfloat16 tensor for bf16 (from a torch tensor, or from a numpy
    array whose dtype is named "bfloat16", as `ml_dtypes` makes them)."""
    import torch
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.contiguous()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        words = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    return a


def _dtype_name(a):
    """The dtype name the manifest records ("float32", "bfloat16", ...)."""
    return str(a.dtype).rsplit(".", 1)[-1]


def _raw_bytes(a):
    """The array's bytes in C order (a bf16 tensor's 2-byte words)."""
    if isinstance(a, np.ndarray):
        return a.tobytes()
    import torch
    return a.view(torch.int16).numpy().tobytes()


def _check_panels(panels):
    """Normalize one panel set: per layer a (k, v) pair of equal-shape
    [rows, H, hd] float arrays, UNIFORM across layers — a later layer
    with fewer rows (corrupt payload, skewed foreign producer) must
    refuse loudly here, not zero-fill silently at install time."""
    out = []
    for kv in panels:
        k, v = kv
        k = _host_array(k)
        v = _host_array(v)
        if k.shape != v.shape or k.dtype != v.dtype or k.ndim != 3:
            raise KVStateError(
                f"malformed KV panel: k {k.shape}/{k.dtype} vs "
                f"v {v.shape}/{v.dtype} (need matching [rows, H, hd])")
        if out and (k.shape != out[0][0].shape
                    or k.dtype != out[0][0].dtype):
            raise KVStateError(
                f"malformed KV panel: layer {len(out)} is "
                f"{k.shape}/{k.dtype} but layer 0 is "
                f"{out[0][0].shape}/{out[0][0].dtype} (layers must be "
                f"uniform)")
        out.append((k, v))
    if not out:
        raise KVStateError("artifact needs at least one layer panel")
    return out


def _serialize_arrays(arrays):
    """ONE layout for every serialization target: flatten `arrays`
    into (descriptors, chunk generator) — descriptors carry dtype/
    shape/offset/nbytes into the concatenation of the yielded chunks.
    `to_bytes()` joins the chunks into one wire buffer; the disk path
    writes them SEQUENTIALLY, holding one array's bytes at a time (a
    multi-GB prefix-cache save must never transiently double its
    footprint) — same bytes either way, so the wire and disk
    serializers structurally cannot drift."""
    norm = [a if not isinstance(a, np.ndarray)
            else np.ascontiguousarray(a) for a in arrays]
    descs, off = [], 0
    for a in norm:
        descs.append({"dtype": _dtype_name(a),
                      "shape": list(a.shape),
                      "offset": off,
                      "nbytes": int(a.nbytes)})
        off += int(a.nbytes)
    return descs, (_raw_bytes(a) for a in norm)


def _deserialize_arrays(manifest, raw):
    """The shared inverse: descriptors + payload bytes -> read-only
    array views over `raw` (the buffer stays alive through each
    array's base). A payload shorter than its descriptors promise —
    a truncated wire buffer or half-written panels.bin — refuses as
    KVStateError like every other corruption mode, never a bare
    numpy ValueError (which a wire consumer would misclassify as a
    request-level verdict)."""
    arrays = []
    try:
        for d in manifest["arrays"]:
            bf16 = d["dtype"] == "bfloat16"
            a = np.frombuffer(raw, dtype=(np.int16 if bf16
                                          else np.dtype(d["dtype"])),
                              count=int(np.prod(d["shape"],
                                                dtype=np.int64))
                              if d["shape"] else 1,
                              offset=d["offset"]).reshape(d["shape"])
            if bf16:
                import torch
                a = torch.from_numpy(a.copy()).view(torch.bfloat16)
            arrays.append(a)
    except (ValueError, TypeError) as e:
        raise KVStateError(f"corrupt artifact payload: {e}") from e
    return arrays


def _check_manifest(manifest, kind, where):
    fv = manifest.get("format_version")
    if fv != FORMAT_VERSION:
        raise KVStateError(
            f"{kind} artifact {where} has format_version {fv!r}; "
            f"this build reads {FORMAT_VERSION}")
    if kind is not None and manifest.get("kind") != kind:
        raise KVStateError(
            f"artifact {where} is a {manifest.get('kind')!r}, "
            f"expected {kind!r}")


def _write_payload(path, manifest, arrays):
    """Commit `arrays` + `manifest` under directory `path` with the
    checkpoint-manager crash ordering: the NEW artifact is fully
    written into a sibling staging directory (payload bytes first, the
    manifest last via atomic os.replace) BEFORE the previous committed
    artifact is touched, then the directories swap. A crash at any
    point leaves either the old artifact readable or (in the rename
    window) no artifact at `path` — a cold start — never a destroyed
    predecessor with no successor and never a half-readable mix (a
    manifest-less directory reads as absent; fsync is not issued, so
    power loss can still cost the newest save). An existing artifact
    at `path` is replaced (the fixed-path periodic-save pattern)."""
    path = os.path.abspath(path)
    stage = path + ".staging"
    trash = path + ".stale"
    for d in (stage, trash):        # leftovers from a crashed save
        if os.path.isdir(d):
            shutil.rmtree(d)
    os.makedirs(stage)
    descs, chunks = _serialize_arrays(arrays)
    with open(os.path.join(stage, _PANELS), "wb") as fh:
        for chunk in chunks:        # one array's bytes at a time
            fh.write(chunk)
    manifest = dict(manifest)
    manifest["format_version"] = FORMAT_VERSION
    manifest["arrays"] = descs
    tmp = os.path.join(stage, _MANIFEST + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(manifest, fh)
    os.replace(tmp, os.path.join(stage, _MANIFEST))  # atomic on POSIX
    if os.path.isdir(path):
        os.rename(path, trash)      # old artifact parked, not deleted
    os.rename(stage, path)          # the commit point
    shutil.rmtree(trash, ignore_errors=True)
    return path


def _read_payload(path, kind):
    path = os.path.abspath(path)
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.exists(mpath):
        raise FileNotFoundError(
            f"no {kind} artifact at {path!r} (missing {_MANIFEST})")
    with open(mpath) as fh:
        manifest = json.load(fh)
    _check_manifest(manifest, kind, f"at {path!r}")
    with open(os.path.join(path, _PANELS), "rb") as fh:
        raw = fh.read()
    return manifest, _deserialize_arrays(manifest, raw)


def _pack_bytes(manifest, arrays):
    """The wire layout: `u32 manifest_len | manifest_json | payload` —
    the manifest+panels directory layout as ONE buffer (no temp dir).
    Shares `_serialize_arrays` with the disk path byte-for-byte."""
    descs, chunks = _serialize_arrays(arrays)
    manifest = dict(manifest)
    manifest["format_version"] = FORMAT_VERSION
    manifest["arrays"] = descs
    hdr = json.dumps(manifest).encode()
    return b"".join([struct.pack("<I", len(hdr)), hdr, *chunks])


def _parse_buffer(buf):
    """Guarded header parse of a `to_bytes()` buffer: every corruption
    mode (truncation, overrun, bad JSON) surfaces as the KVStateError
    family — the ONE parse behind `_unpack_bytes` and
    `artifact_from_bytes`, so their error classification cannot
    drift."""
    buf = bytes(buf) if not isinstance(buf, (bytes, bytearray)) else buf
    if len(buf) < 4:
        raise KVStateError("truncated artifact buffer (no header)")
    (hlen,) = struct.unpack_from("<I", buf, 0)
    if 4 + hlen > len(buf):
        raise KVStateError("truncated artifact buffer (header cut off)")
    try:
        manifest = json.loads(buf[4:4 + hlen].decode())
    except ValueError as e:
        raise KVStateError(f"corrupt artifact manifest: {e}") from e
    return manifest, memoryview(buf)[4 + hlen:]


def _unpack_bytes(buf, kind):
    manifest, payload = _parse_buffer(buf)
    _check_manifest(manifest, kind, "in wire buffer")
    return manifest, _deserialize_arrays(manifest, payload)


def artifact_from_bytes(buf):
    """Deserialize either artifact kind from a `to_bytes()` buffer —
    the wire consumer's one-call probe (the serving wire's MIGRATE
    payloads carry request artifacts; a foreign producer may ship a
    prefix cache through the same frames). ONE manifest parse through
    the same guarded pipeline `from_bytes` uses."""
    manifest, flat = _unpack_bytes(buf, None)   # kind checked below
    kind = manifest.get("kind")
    cls = {"request": RequestArtifact,
           "prefix_cache": PrefixCacheArtifact}.get(kind)
    if cls is None:
        raise KVStateError(f"unknown artifact kind {kind!r} in buffer")
    return cls._from_manifest(manifest, flat)


def _pair_up(flat):
    """Reassemble the flat array list back into per-layer (k, v)."""
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


class _TaggedArtifact:
    """Shared version-tag contract for both artifact kinds."""

    tag = None

    def require_tag(self, expected, what="artifact"):
        """Fail LOUDLY unless this artifact was produced under param
        version `expected` — the one rule that makes durable KV state
        safe at all (module docstring)."""
        if self.tag != expected:
            raise KVStateVersionError(
                f"{what} was saved under param version tag "
                f"{self.tag!r} but the server is running "
                f"{expected!r}: its KV rows were computed under "
                f"different weights and cannot be reused (re-run the "
                f"request / warm the cache cold instead)")


class RequestArtifact(_TaggedArtifact):
    """One request's complete resumable KV state.

    panels:    per layer (k, v), each [pos, H, hd] — every REAL row the
               request has written (prompt + generated-but-last;
               extraction slices the table gather at the frontier).
    prompt:    the prompt tokens (restore re-runs the prefix match on
               them — shared leading blocks are RE-ACQUIRED through the
               prefix index, never duplicated).
    generated: tokens emitted so far (the last one is the next decode
               input; the resumed stream appends after it).
    max_new:   the request's original token budget.
    tag:       param-version fingerprint the rows were computed under.
    block_size: the source pool's block size (restore validates it —
               panel rows are layout-independent, but the logical
               position math the artifact froze is not).
    klass:     brownout request class, carried so a migrated/resumed
               request keeps its policy treatment.
    trace:     optional TRACE CONTEXT dict ({"trace_id", "parent_span",
               "origin"} — obs.trace.TraceContext.to_manifest()): the
               Dapper baton. A destination server continues the
               request's `req-<id>` lane under the SAME trace id, so
               the two instances' saved traces stitch into one
               timeline (obs.fleet.merge_traces). Pure metadata: never
               consulted by any restore-correctness path, absent in
               pre-trace artifacts, and a foreign producer may omit it.
    """

    __slots__ = ("prompt", "generated", "max_new", "tag", "block_size",
                 "klass", "panels", "trace")

    def __init__(self, prompt, generated, max_new, tag, block_size,
                 panels, klass="default", trace=None):
        self.prompt = tuple(int(t) for t in prompt)
        self.generated = tuple(int(t) for t in generated)
        if not self.prompt or not self.generated:
            raise KVStateError("a request artifact needs a prompt and "
                               "at least one generated token (requests "
                               "are only extractable in decode phase)")
        self.max_new = int(max_new)
        self.tag = str(tag)
        self.block_size = int(block_size)
        self.klass = str(klass)
        # accept a mapping or anything with to_manifest() (TraceContext)
        if trace is not None and hasattr(trace, "to_manifest"):
            trace = trace.to_manifest()
        self.trace = dict(trace) if trace else None
        self.panels = _check_panels(panels)
        if self.panels[0][0].shape[0] != self.pos:
            raise KVStateError(
                f"panel rows {self.panels[0][0].shape[0]} != frontier "
                f"position {self.pos} (prompt + generated - 1)")

    @property
    def pos(self):
        """The frontier: rows written so far. The final generated token
        has not been written back (the decode loop's contract: the last
        emitted token needs no cache row until the next step writes
        it)."""
        return len(self.prompt) + len(self.generated) - 1

    @property
    def remaining(self):
        return self.max_new - len(self.generated)

    @property
    def nbytes(self):
        """Host bytes this artifact's KV panel occupies — the
        `spill_bytes` accounting unit."""
        return _panels_nbytes(self.panels)

    def _manifest_and_flat(self):
        """ONE manifest builder behind save() and to_bytes() — the two
        serializers share every field and the panel flattening, so the
        wire and disk layouts cannot drift."""
        flat = [a for kv in self.panels for a in kv]
        manifest = {
            "kind": "request",
            "tag": self.tag,
            "prompt": list(self.prompt),
            "generated": list(self.generated),
            "max_new": self.max_new,
            "block_size": self.block_size,
            "klass": self.klass,
            "n_layers": len(self.panels),
        }
        if self.trace is not None:
            manifest["trace"] = self.trace
        return manifest, flat

    @classmethod
    def _from_manifest(cls, m, flat):
        return cls(m["prompt"], m["generated"], m["max_new"], m["tag"],
                   m["block_size"], _pair_up(flat), klass=m["klass"],
                   trace=m.get("trace"))

    def save(self, path):
        return _write_payload(path, *self._manifest_and_flat())

    @classmethod
    def load(cls, path):
        return cls._from_manifest(*_read_payload(path, "request"))

    def to_bytes(self):
        """The whole artifact as ONE buffer (`u32 manifest_len |
        manifest_json | panel payload`) — the serving wire's MIGRATE
        payload. Byte-identical panel layout to `save()`'s panels.bin
        (shared `_serialize_arrays`), no temp dir."""
        return _pack_bytes(*self._manifest_and_flat())

    @classmethod
    def from_bytes(cls, buf):
        return cls._from_manifest(*_unpack_bytes(buf, "request"))


class PrefixCacheArtifact(_TaggedArtifact):
    """The prefix cache's resident blocks under ONE version tag.

    entries: list of (prefix_tokens tuple, per-layer (k, v) panels each
    [block_size, H, hd]) — exactly the `BlockPool` index's (key ->
    block) mapping with the physical rows pulled to host. Entries are
    kept PARENT-FIRST (sorted by prefix length) so a restore adopts a
    chain in matchable order; a child whose parent was LRU-evicted
    before the save simply restores unmatchable, which is harmless
    (match_prefix walks full prefixes from the front)."""

    __slots__ = ("tag", "block_size", "entries")

    def __init__(self, tag, block_size, entries):
        self.tag = str(tag)
        self.block_size = int(block_size)
        norm = []
        for prefix, panels in entries:
            prefix = tuple(int(t) for t in prefix)
            panels = _check_panels(panels)
            if panels[0][0].shape[0] != self.block_size:
                raise KVStateError(
                    f"prefix-cache panel carries "
                    f"{panels[0][0].shape[0]} rows; every entry is "
                    f"exactly one {self.block_size}-row block")
            if len(prefix) % self.block_size:
                raise KVStateError(
                    f"prefix key length {len(prefix)} is not a "
                    f"multiple of block_size {self.block_size}")
            norm.append((prefix, panels))
        self.entries = sorted(norm, key=lambda e: len(e[0]))

    @property
    def nbytes(self):
        return sum(_panels_nbytes(p) for _, p in self.entries)

    def _manifest_and_flat(self):
        flat = [a for _, panels in self.entries
                for kv in panels for a in kv]
        return {
            "kind": "prefix_cache",
            "tag": self.tag,
            "block_size": self.block_size,
            "prefixes": [list(p) for p, _ in self.entries],
            "n_layers": (len(self.entries[0][1])
                         if self.entries else 0),
        }, flat

    @classmethod
    def _from_manifest(cls, m, flat):
        n_layers = int(m["n_layers"])
        per_entry = 2 * n_layers
        entries = []
        for i, prefix in enumerate(m["prefixes"]):
            chunk = flat[i * per_entry:(i + 1) * per_entry]
            entries.append((prefix, _pair_up(chunk)))
        return cls(m["tag"], m["block_size"], entries)

    def save(self, path):
        return _write_payload(path, *self._manifest_and_flat())

    @classmethod
    def load(cls, path):
        return cls._from_manifest(*_read_payload(path, "prefix_cache"))

    def to_bytes(self):
        """One-buffer serialization (see RequestArtifact.to_bytes) —
        a restarted remote replica could warm its prefix cache straight
        off a peer instead of disk."""
        return _pack_bytes(*self._manifest_and_flat())

    @classmethod
    def from_bytes(cls, buf):
        return cls._from_manifest(*_unpack_bytes(buf, "prefix_cache"))
