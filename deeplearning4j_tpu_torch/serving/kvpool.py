"""Paged KV-cache memory management: BlockPool + per-request block
tables + prefix reuse (vLLM PagedAttention, Kwon et al. SOSP'23).

The port's copy of deeplearning4j_tpu/serving/kvpool.py (stdlib only), held
against it by tests/test_torch_serving_stdlib.py; the text below is the
reference's.

The fixed-slot decode cache reserves `max_len` rows per slot, so
concurrent-stream count is bounded by WORST-CASE length, not actual
usage — four 160-row slots serve four streams even when each stream
touches 30 rows. Paging splits the cache into fixed-size BLOCKS in one
preallocated arena (`models.zoo.transformer.init_paged_kv_cache`) and
gives every request a block TABLE (logical block -> physical block);
the decode program gathers attention rows through the table
(`make_paged_decode_fn`), so a stream holds exactly the blocks its rows
occupy and admission is gated by FREE BLOCKS, not free slots. Slot
count becomes a pure scheduling width.

This module is the HOST half: pure-Python block accounting, zero jax
imports — allocation decisions can never add a device dispatch, and the
pool unit-tests without a device. The device half (arena layout, the
gather/scatter programs, the CoW block copy) lives in the zoo.

Three mechanisms:

* **Free-list allocation, refcounted blocks.** Blocks are free, CACHED
  (refcount 0 but contents still indexed for prefix reuse — evicted LRU
  on demand), or in use (refcount >= 1; > 1 means shared). A request's
  blocks — prompt AND decode rows — are reserved at `admit()` so a
  mid-decode append can never deadlock the pool: either a request
  admits with everything it will ever write, or it waits.
* **Prefix reuse.** Full prompt blocks are indexed by the TOKEN PREFIX
  they complete (exact tuple keys — a dict lookup, no hash-collision
  exposure) under a caller-supplied `tag`. A new request walks the
  index block by block and maps matched leading blocks to the one
  physical copy (refcount++): system prompts and few-shot templates —
  the dominant shape of real traffic — are stored once no matter how
  many streams carry them. Correctness rests on determinism the repo
  already pins: same tokens + SAME PARAMS => bit-identical k/v rows
  regardless of which request computed them (per-row bits independent
  of batch shape), so reading a neighbour's block IS reading your own.
  The "same params" half is why the tag exists: the decode server tags
  every admission with its param VERSION, so a request admitted after a
  hot swap can never match blocks whose k/v were computed under the old
  weights — cross-version reuse is structurally impossible, and stale
  versions' cached blocks simply age out of the LRU.
* **Copy-on-write.** A shorter prompt can also ride the FIRST PART of a
  longer prompt's final indexed block (the partial tail match). Such a
  sharer must not append into the shared block — its first generated
  row would clobber the owner's — so `admit()` reserves a spare and the
  scheduler calls `cow()` right before the first divergent append: the
  spare replaces the shared block in the sharer's table and the device
  copies the rows across (`make_block_copy_fn`). Prefill-only requests
  (max_new_tokens == 1) never append and share the partial block free
  of any copy.

`ContinuousDecodeServer(paged=True)` wires this to the device programs;
tests/test_paged.py pins the invariants (no leak after churn, refcount
consistency, CoW correctness, join == solo bit-identity).
"""
from __future__ import annotations

import collections

__all__ = ["BlockPool", "PagedAllocation"]


class PagedAllocation:
    """One request's block-table allocation.

    ids:         physical block ids in table order (logical block i of
                 the request lives at physical block ids[i]).
    shared_rows: leading prompt rows resident BEFORE this request's
                 prefill (the prefix-cache hit) — the prefill program
                 skips installing them.
    n_shared:    leading ids held by refcount only (never written by
                 this request while shared).
    cow:         None, or (logical_block_idx, spare_block_id): a lazy
                 copy-on-write the scheduler must materialize via
                 `BlockPool.cow()` before this request's first appended
                 row lands in that block.
    pending_index: (position, prefix-key) pairs to register in the
                 prefix index via `BlockPool.commit()` — called by the
                 scheduler ONLY after the prefill dispatch succeeded.
                 Registering at admit() would let a failed prefill
                 leave never-written blocks indexed, and a later
                 same-prompt request would "share" garbage rows.
    """

    __slots__ = ("ids", "shared_rows", "n_shared", "cow",
                 "pending_index")

    def __init__(self, ids, shared_rows, n_shared, cow, pending_index):
        self.ids = ids
        self.shared_rows = int(shared_rows)
        self.n_shared = int(n_shared)
        self.cow = cow
        self.pending_index = pending_index


class BlockPool:
    """Host-side block accounting for one paged KV arena."""

    def __init__(self, n_blocks, block_size, prefix_cache=True):
        self.capacity = int(n_blocks)
        self.block_size = int(block_size)
        if self.capacity < 1:
            raise ValueError(f"need n_blocks >= 1, got {n_blocks}")
        if self.block_size < 1:
            raise ValueError(f"need block_size >= 1, got {block_size}")
        self.prefix_cache = bool(prefix_cache)
        # low ids allocate first (pop from the end of a descending list):
        # deterministic placement for a deterministic test surface
        self._free = list(range(self.capacity - 1, -1, -1))
        self._ref = {}          # id -> refcount (>= 1: in use)
        # ref==0 blocks whose contents stay indexed: the prefix cache
        # proper, evicted LRU when the free list runs dry
        self._cached = collections.OrderedDict()    # id -> index key
        self._index = {}        # (tag, prefix token tuple) -> block id
        self._key_of = {}       # block id -> its index key
        self._children = {}     # parent prefix key -> {id: ext tuple}
        # blocks ADOPTED from a persistent prefix-cache artifact
        # (serving/kvstate.py) and still indexed: the decode server
        # counts a prefix match landing on one as `prefix_restore_hits`
        # — the restart-warm-start proof. Membership ends at _unindex
        # (an evicted-then-reallocated block is a fresh block).
        self.restored = set()

    # -- read-outs -----------------------------------------------------
    @property
    def blocks_in_use(self):
        """Blocks held by live requests (refcount >= 1)."""
        return self.capacity - len(self._free) - len(self._cached)

    @property
    def blocks_free(self):
        """Allocatable RIGHT NOW: the free list plus evictable cached."""
        return len(self._free) + len(self._cached)

    def blocks_needed(self, total_rows):
        """Table length for a request that will ever write `total_rows`
        KV rows (prompt + generated-but-one; the final emitted token is
        never written back)."""
        return max(1, -(-int(total_rows) // self.block_size))

    def writable_rows(self, alloc):
        """Row capacity of one allocation's reserved table — the
        EXCLUSIVE write bound (`wto`) the K-wide paged programs gate
        on. Rows between the request's last real row and this bound are
        the tail of its final reserved block: dead-writable overhang a
        speculative round or chunk padding may scribble on (the pointer
        never passes them, and the block is privately owned). Rows at
        or past this bound are OUTSIDE the reservation — an ungated
        write there would resolve through a zeroed block-table entry
        into block 0, i.e. someone else's memory — so the verify/chunk
        programs index-drop them."""
        return len(alloc.ids) * self.block_size

    # -- prefix matching ----------------------------------------------
    def match_prefix(self, prompt, tag=None):
        """(full_ids, rows_matched, partial_id): the longest run of
        indexed blocks whose contents equal `prompt`'s leading full
        blocks UNDER `tag`, plus at most one PARTIAL match — an indexed
        block whose first rows equal ALL remaining prompt tokens (a
        shorter prompt riding a longer one's final block). Blocks
        indexed under a different tag never match: the decode server
        tags by param version, so k/v computed under swapped-out
        weights are unreachable. Pure lookup: takes no references,
        mutates no state."""
        if not self.prefix_cache:
            return [], 0, None
        prompt = tuple(int(t) for t in prompt)
        bs = self.block_size
        ids, rows = [], 0
        while rows + bs <= len(prompt):
            bid = self._index.get((tag, prompt[:rows + bs]))
            if bid is None:
                break
            ids.append(bid)
            rows += bs
        partial = None
        rem = prompt[rows:]
        if rem and len(rem) < bs:
            for bid, ext in (self._children.get((tag, prompt[:rows]))
                             or {}).items():
                if ext[:len(rem)] == rem:
                    partial = bid
                    rows += len(rem)
                    break
        return ids, rows, partial

    # -- allocation ----------------------------------------------------
    def admit(self, prompt, total_rows, will_append=True, tag=None):
        """Build a block table for one request, or return None when the
        pool cannot currently supply the blocks (the admission gate:
        BLOCKED ON MEMORY, not on slots — the caller holds the request
        and retries as completions free blocks).

        `total_rows` is every KV row the request will EVER write
        (reserved up front — see module docstring); `will_append` False
        (a prefill-only request) skips the copy-on-write spare, letting
        it share a partial block with zero copies. `tag` namespaces the
        prefix index (the server passes the param version — see module
        docstring). On success, `commit()` registers the request's own
        full prompt blocks under the same tag."""
        prompt = tuple(int(t) for t in prompt)
        bs = self.block_size
        n_total = self.blocks_needed(total_rows)
        shared, shared_rows, partial = self.match_prefix(prompt, tag)
        use_partial = partial is not None
        n_fresh = n_total - len(shared) - (1 if use_partial else 0)
        if n_fresh < 0:
            # prompt-dominated tiny request: the match covers more
            # blocks than the table needs — trim the tail of the match
            drop = -n_fresh
            if use_partial:
                use_partial = False
                shared_rows = len(shared) * bs
                drop -= 1
            if drop:
                shared = shared[:-drop]
                shared_rows = len(shared) * bs
            n_fresh = n_total - len(shared) - (1 if use_partial else 0)
        need_cow = use_partial and will_append
        if need_cow and n_total + 1 > self.capacity:
            # a capacity-sized table PLUS its CoW spare can never be
            # satisfied, not even by an empty pool — forgo the partial
            # ride (prefill recomputes those rows) instead of parking
            # the request in the memory queue forever
            use_partial = False
            need_cow = False
            shared_rows = len(shared) * bs
            n_fresh = n_total - len(shared)
        need_new = n_fresh + (1 if need_cow else 0)
        revive = [b for b in shared + ([partial] if use_partial else [])
                  if b in self._cached]
        if need_new > len(self._free) + len(self._cached) - len(revive):
            return None
        for b in shared:
            self._take(b)
        if use_partial:
            self._take(partial)
        fresh = [self._alloc_raw() for _ in range(need_new)]
        for b in fresh:
            self._ref[b] = 1
        spare = fresh.pop() if need_cow else None
        ids = shared + ([partial] if use_partial else []) + fresh
        pending = []
        if self.prefix_cache:
            # this request's own full PROMPT blocks (positions the match
            # did not cover) become shareable — but only AFTER the
            # prefill actually writes them: commit() registers these,
            # called by the scheduler on prefill success. Generated-token
            # blocks are private and never indexed.
            pending = [(i, (tag, prompt[:(i + 1) * bs]))
                       for i in range(len(shared),
                                      min(len(prompt) // bs, n_total))]
        cow = (len(shared), spare) if spare is not None else None
        return PagedAllocation(ids, shared_rows,
                               len(shared) + (1 if use_partial else 0),
                               cow, pending)

    def commit(self, alloc):
        """Register `alloc`'s freshly-PREFILLED full prompt blocks in
        the prefix index. Call ONLY after the prefill dispatch
        succeeded — an admitted-but-never-filled block must never become
        matchable (a sharer would read garbage rows)."""
        for i, key in alloc.pending_index:
            if key not in self._index:
                self._register(alloc.ids[i], key)
        alloc.pending_index = []

    def cow(self, alloc):
        """Materialize a lazy copy-on-write: the spare reserved at
        admit() replaces the shared partial block in `alloc`'s table.
        Returns (src, dst) physical ids — the CALLER performs the device
        row copy (`make_block_copy_fn`) before its next append dispatch,
        whatever its width: the 1-wide decode step writes one frontier
        row into the shared block, and a K-wide VERIFY dispatch writes
        its whole [pos, pos+K) burst starting there — both must see the
        private copy first (the scheduler materializes any pending CoW
        before the first decode-phase dispatch, which covers both)."""
        idx, spare = alloc.cow
        src = alloc.ids[idx]
        alloc.ids = list(alloc.ids)
        alloc.ids[idx] = spare
        alloc.cow = None
        alloc.n_shared -= 1
        self._drop(src)
        return src, spare

    def cached_entries(self, tag=None):
        """(block id, prefix tokens) for every CACHED (refcount-0,
        still-indexed) block under `tag`, in LRU order — the saveable
        set the persistent prefix cache serializes
        (serving/kvstate.py). An accessor, so persistence reads the
        cached tier through the pool's API the same way restore writes
        it through `adopt()` — a representation change here cannot
        silently break the save path."""
        return [(bid, key[1]) for bid, key in self._cached.items()
                if key[0] == tag]

    def indexed_chain(self, key, tag=None):
        """Parent-first (block id, prefix tokens) chain of INDEXED
        blocks covering `key`'s leading full blocks under `tag` — the
        shippable set the fleet prefix tier exports (PREFIX_PULL).
        Unlike `cached_entries`, the chain is NOT restricted to the
        refcount-0 cached tier: a hot prefix is, by definition, held by
        live requests, and an indexed block's rows are immutable once
        committed (commit-after-prefill + the CoW discipline), so the
        exporter may extract them while they are still referenced.
        Pure lookup, like `match_prefix`: takes no references."""
        if not self.prefix_cache:
            return []
        key = tuple(int(t) for t in key)
        bs = self.block_size
        out, rows = [], 0
        while rows + bs <= len(key):
            prefix = key[:rows + bs]
            bid = self._index.get((tag, prefix))
            if bid is None:
                break
            out.append((bid, prefix))
            rows += bs
        return out

    def adopt(self, key):
        """Allocate a block for an EXTERNALLY-RESTORED prefix entry
        (serving/kvstate.py `PrefixCacheArtifact`): take a physical
        block, register `key` ((tag, prefix tokens)) in the index, and
        park it straight in the CACHED tier (refcount 0, LRU-evictable
        — exactly where `release` retires an indexed block). The CALLER
        installs the artifact's rows into the returned block id before
        any request can match it; the server does both under one
        restore call before serving starts, so a half-restored entry is
        never matchable. Returns None when the key is already indexed
        (nothing to adopt) or the FREE list is dry — adoption never
        evicts cached state (on a full pool that would recycle the
        blocks adoption itself just parked, churning the restore into
        a last-writer-wins shuffle): a too-small pool restores a
        prefix of the artifact, never fails the server."""
        if not self.prefix_cache or key in self._index:
            return None
        if not self._free:
            return None
        bid = self._free.pop()
        self._register(bid, key)
        self._cached[bid] = key
        self.restored.add(bid)
        return bid

    def release(self, alloc):
        """Return one request's blocks: refcount--, last reference
        retires an indexed block to the prefix cache (LRU-evictable) and
        frees a private one outright. An unmaterialized CoW spare is
        freed too."""
        for bid in alloc.ids:
            self._drop(bid)
        if alloc.cow is not None:
            self._drop(alloc.cow[1])
            alloc.cow = None
        alloc.ids = []
        alloc.pending_index = []    # uncommitted blocks stay unindexed

    # -- internals -----------------------------------------------------
    def _take(self, bid):
        if bid in self._cached:
            del self._cached[bid]
            self._ref[bid] = 1
        else:
            self._ref[bid] += 1

    def _drop(self, bid):
        self._ref[bid] -= 1
        if self._ref[bid] > 0:
            return
        del self._ref[bid]
        key = self._key_of.get(bid)
        if key is not None and self.prefix_cache:
            self._cached[bid] = key     # newest at the LRU tail
        else:
            self._free.append(bid)

    def _alloc_raw(self):
        if self._free:
            return self._free.pop()
        bid, key = self._cached.popitem(last=False)     # LRU evict
        self._unindex(bid, key)
        return bid

    @staticmethod
    def _parent_ext(key, bs):
        """key = (tag, prefix tokens): parent strips this block's bs
        tokens; ext is the stripped tail (the block's own contents)."""
        tag, prefix = key
        return (tag, prefix[:-bs]), prefix[-bs:]

    def _register(self, bid, key):
        self._index[key] = bid
        self._key_of[bid] = key
        parent, ext = self._parent_ext(key, self.block_size)
        self._children.setdefault(parent, {})[bid] = ext

    def _unindex(self, bid, key):
        del self._index[key]
        del self._key_of[bid]
        self.restored.discard(bid)
        parent, _ = self._parent_ext(key, self.block_size)
        kids = self._children.get(parent)
        if kids is not None:
            kids.pop(bid, None)
            if not kids:
                del self._children[parent]

    def check(self):
        """Internal-consistency invariants; raises AssertionError on a
        leak or a dangling reference (tests call this after churn)."""
        seen = (set(self._free) | set(self._cached) | set(self._ref))
        assert len(self._free) + len(self._cached) + len(self._ref) \
            == self.capacity, "block leaked or double-booked"
        assert seen == set(range(self.capacity)), "block ids corrupted"
        assert all(r >= 1 for r in self._ref.values()), \
            "zero refcount left in the in-use map"
        assert all(self._index.get(k) == b
                   for b, k in self._key_of.items()), \
            "index / key_of disagree"
        assert all(self._key_of.get(b) == k
                   for b, k in self._cached.items()), \
            "cached block lost its index key"
        assert self.restored <= set(self._key_of), \
            "restored-block marker outlived its index entry"
        return True
