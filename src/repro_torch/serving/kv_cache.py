"""Paged KV-cache block management with elastic expansion/contraction and
vLLM-style copy-on-write prefix sharing.

Implements the paper's §6.3 (expansion) and §6.4 (contraction with logical
remapping) faithfully:

  * ``BlockManager`` — logical bookkeeping: free list, refcounts, per-sequence
    block tables, K_boundary, migration-plan construction (§6.4 steps 1-2, 4-5).
  * the physical (L, num_blocks + 1, block_size, KH, hd) pages live in
    ``paged_runtime.PagedKVRuntime``; ``paged_runtime.apply_copies``
    executes the §6.4 step-3 data movement through the block-migration
    kernel.

Prefix sharing (``prefix_caching=True``) adds a content-hash index over
*full* prefix blocks, hash-chained over token ids:

  * ``match_prefix`` finds the longest cached prefix of a prompt;
  * ``share`` maps those blocks into a new sequence's table at refcount+1;
  * ``register_prefix`` publishes a sequence's freshly materialised full
    prompt blocks for reuse;
  * ``fork_for_write`` privatises any refcount>1 block a write range covers
    (copy-on-write) and records the (src, dst) copy for the physical tier
    to execute (``drain_pending_copies``);
  * a block whose refcount drops to 0 while registered is *cached-reusable*:
    it parks in an LRU tier instead of the free list and is only recycled
    when the free list runs dry (eviction unregisters it).

A block is therefore in exactly one of three states: **free** (allocatable,
content dead), **cached-reusable** (refcount 0, content live in the hash
index, reclaimable on demand) or **pinned** (refcount >= 1).

With a ``HostKVStore`` attached (``host_store=``), eviction from the
cached-reusable tier gains a fourth, host-side destination: instead of
discarding the block's content, the manager records it under the block's
chain hash and queues a device→host copy (``pending_spills``); a later
``match_prefix`` walk that misses the device index but hits the host store
restores the content into a *free* device block (``pending_restores``,
host→device) and re-registers the hash, so the admission path counts the
restored prefix as cached.  The physical tier drains both queues before its
step writes — spills before restores, so a block spilled and re-matched in
the same scheduling round restores the just-captured payload.  This is the
KV-side generalisation of the paper's draft-offload move (§6.2): cold
prefix state parks in host memory instead of being recomputed.

Invariants (property-tested):
  I1  a block id is in the free list, the cached-LRU tier, or referenced
      by >=1 sequence — exactly one of the three
  I2  refcounts equal the number of tables referencing the block
  I3  after contraction no table references id >= K_boundary
  I4  migration preserves every sequence's logical KV contents bit-exactly
  I5  every cached hash maps to a live (non-free) block whose stored token
      chain reproduces the hash
  I6  (host tier) every pending restore targets a registered device block
      backed by a pinned host record; host and device indices are disjoint
      except for restores in flight, and every host record either
      reproduces its key AND passes its payload checksum, or fails the
      checksum (no *silently* corrupt record — a failed checksum is
      detectable and the restore path drops the record); pinned records
      (restore in flight) always verify
  I7  (crash) a FAILED replica owns nothing: no block tables, no
      refcounts, no cached/registered blocks, every block back on the
      free list, no pending copies/spills/restores, and no pinned host
      records (``check_invariants(failed=True)``)
  I8  (lifecycle completeness) every block id in the pool is reachable:
      free, cached-reusable, table-referenced, or reserved for an
      in-flight contraction migration — a cancelled or deadline-expired
      request can never strand a block in NO structure (the leak I1's
      disjointness checks alone cannot see)
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class OutOfBlocks(Exception):
    pass


class SharedBlockWrite(Exception):
    """A write would land in a block with refcount > 1.  Shared (prefix)
    blocks are immutable; the write must be routed through
    ``BlockManager.fork_for_write`` first (copy-on-write)."""


# ---------------------------------------------------------------------------
# Stable content hashing.  Any identity derived from token content that can
# cross a process boundary (the prefix-cache index here, and the routing-tier
# template keys in serving/controlplane.py) must come from this seeded
# blake2b chain — never from Python's hash(), whose salting rules are an
# implementation detail we refuse to depend on.  The chain is:
#   h_0 = CHAIN_ROOT;  h_i = chain_hash(h_{i-1}, block_i_token_ids)
# so a block's hash commits to the entire prefix before it.
# ---------------------------------------------------------------------------

# chain-hash seed for the first block of a prompt (a fixed, documented seed
# so independently constructed processes agree on every chain value)
CHAIN_ROOT = 0x517CC1B727220A95
_CHAIN_ROOT = CHAIN_ROOT   # backward-compatible alias
_MASK64 = (1 << 64) - 1


def chain_hash(parent: int, tokens: Sequence[int]) -> int:
    """Seeded content hash of one token block chained onto ``parent``.

    blake2b over the parent hash plus the token ids serialised as
    little-endian int64 — one C-level call per block, deterministic across
    processes, platforms, interpreter versions and ``PYTHONHASHSEED``
    values (regression-tested against golden values in
    tests/test_controlplane.py).  This sits on the per-admission hot path
    (every full block of every prompt is hashed), hence no Python-level
    per-token loop."""
    buf = (parent & _MASK64).to_bytes(8, "little") \
        + np.asarray(tokens, dtype="<i8").tobytes()
    return int.from_bytes(hashlib.blake2b(buf, digest_size=8).digest(),
                          "little")


@dataclass
class MigrationPlan:
    """One-to-one mapping b_old -> b_new (old >= K_boundary, new < K_boundary)."""

    src: List[int]
    dst: List[int]

    def __len__(self):
        return len(self.src)


@dataclass
class HostBlockRecord:
    """One spilled prefix block in host memory.

    ``parent``/``tokens`` are the chain-hash material (enough to re-verify
    the key and to re-register the block on restore); ``data`` holds the
    per-pool page payloads once the physical tier executes the spill —
    keyed ``"<pool_tag>:<page_key>"`` (e.g. ``"t:k_pages"``) with
    host-side numpy arrays.  The simulated tier never fills ``data``.
    ``checksum`` is the blake2b integrity stamp over (parent, tokens,
    data), written at spill time (and re-sealed after the physical tier
    fills ``data``) and verified before any restore — host memory is
    outside the device's ECC domain, so a record is never trusted on
    faith."""

    parent: int
    tokens: Tuple[int, ...]
    data: Dict[str, np.ndarray] = field(default_factory=dict)
    checksum: Optional[int] = None


def record_checksum(parent: int, tokens: Sequence[int],
                    data: Dict[str, np.ndarray]) -> int:
    """Integrity checksum of one host record: blake2b over the chain-hash
    material plus every payload page (key + raw bytes, key-sorted so the
    stamp is independent of dict insertion order)."""
    hsh = hashlib.blake2b(digest_size=8)
    hsh.update((parent & _MASK64).to_bytes(8, "little"))
    hsh.update(np.asarray(tokens, dtype="<i8").tobytes())
    for key in sorted(data):
        hsh.update(key.encode())
        hsh.update(np.ascontiguousarray(data[key]).tobytes())
    return int.from_bytes(hsh.digest(), "little")


class HostKVStore:
    """Host-memory spill tier for evicted cached-reusable prefix blocks.

    An LRU dict keyed by the block's blake2b chain hash — the same
    process-stable identity the device-side ``hash_index`` uses, so a
    restored block re-registers under exactly the key ``match_prefix``
    walks.  Capacity is counted in blocks; inserting past capacity evicts
    host-LRU records, except records *pinned* by an in-flight restore
    (the device side already re-registered their hash; dropping the record
    before the physical copy would serve garbage content)."""

    def __init__(self, capacity_blocks: int = 4096):
        self.capacity = max(int(capacity_blocks), 1)
        self.records: "OrderedDict[int, HostBlockRecord]" = OrderedDict()
        self.pinned: set = set()               # hashes with restores in flight
        self.stats: Dict[str, float] = dict(
            spills=0, spilled_blocks=0, restores=0, host_evictions=0,
            spill_s=0.0, restore_s=0.0, corrupt_dropped=0)

    def __len__(self) -> int:
        return len(self.records)

    def __contains__(self, h: int) -> bool:
        return h in self.records

    def put(self, h: int, parent: int, tokens: Tuple[int, ...]) -> None:
        """Index (or refresh) a spilled block.  A re-spill of a hash the
        store already holds keeps the existing record (content is fully
        determined by the hash) and just refreshes its LRU position."""
        rec = self.records.get(h)
        if rec is None:
            rec = HostBlockRecord(parent, tuple(tokens))
            rec.checksum = record_checksum(rec.parent, rec.tokens, rec.data)
            self.records[h] = rec
            self.stats["spills"] += 1
        self.records.move_to_end(h)
        while len(self.records) > self.capacity:
            victim = next((k for k in self.records if k not in self.pinned),
                          None)
            if victim is None:
                break                      # everything pinned: tolerate spill
            del self.records[victim]
            self.stats["host_evictions"] += 1

    def get(self, h: int) -> Optional[HostBlockRecord]:
        rec = self.records.get(h)
        if rec is not None:
            self.records.move_to_end(h)
        return rec

    def pin(self, h: int) -> None:
        self.pinned.add(h)

    def unpin(self, h: int) -> None:
        self.pinned.discard(h)

    def take(self, h: int) -> Optional[HostBlockRecord]:
        """Consume a record at restore time: move semantics — once the
        content is back in a device block the host copy is dropped (a later
        eviction re-spills it)."""
        rec = self.records.pop(h, None)
        self.pinned.discard(h)
        if rec is not None:
            self.stats["restores"] += 1
        return rec

    # -- integrity ---------------------------------------------------------

    def seal(self, h: int) -> None:
        """Re-stamp a record's checksum after its payload pages are filled
        (the physical tier writes ``data`` after ``put`` indexed the
        record, so the stamp must follow the bytes)."""
        rec = self.records.get(h)
        if rec is not None:
            rec.checksum = record_checksum(rec.parent, rec.tokens, rec.data)

    def verify(self, h: int) -> bool:
        """True iff the record exists and its bytes match its stamp."""
        rec = self.records.get(h)
        return rec is not None and rec.checksum == record_checksum(
            rec.parent, rec.tokens, rec.data)

    def drop_corrupt(self, h: int) -> None:
        """Discard a record that failed verification.  The prefix it held
        will cold-re-prefill — strictly better than serving bad KV."""
        self.records.pop(h, None)
        self.pinned.discard(h)
        self.stats["corrupt_dropped"] += 1

    def corrupt(self, h: int) -> bool:
        """Fault injection: flip payload bits of one record WITHOUT
        updating its stamp (models bit rot / a bad DMA).  Pinned records
        are refused — an in-flight restore already owns that content.
        Returns True if the record was corrupted."""
        rec = self.records.get(h)
        if rec is None or h in self.pinned:
            return False
        if rec.data:
            key = sorted(rec.data)[0]
            arr = np.ascontiguousarray(rec.data[key])
            flat = arr.view(np.uint8).reshape(-1).copy()
            if not flat.size:
                return False
            flat[0] ^= 0xFF
            rec.data[key] = flat.view(arr.dtype).reshape(arr.shape)
        else:
            # simulated tier holds no pages: corrupt the chain material
            rec.tokens = (rec.tokens[0] ^ 1,) + rec.tokens[1:]
        return True


class BlockManager:
    """vLLM-style block allocator + Nightjar's elastic boundary."""

    def __init__(self, num_blocks: int, block_size: int, *,
                 prefix_caching: bool = False,
                 host_store: Optional[HostKVStore] = None):
        self.block_size = block_size
        self.base_blocks = num_blocks      # N_orig
        self.total_blocks = num_blocks     # N_orig or N_scale
        self.boundary = num_blocks         # K_boundary
        self.free: List[int] = list(range(num_blocks))
        self.refcount: Dict[int, int] = {}
        self.tables: Dict[int, List[int]] = {}   # seq_id -> block ids
        self.lengths: Dict[int, int] = {}        # seq_id -> token count
        self.reserved: set = set()                # blocks mid-migration
        # --- prefix-sharing state (all empty with caching off) ---
        self.prefix_caching = prefix_caching
        self.hash_index: Dict[int, int] = {}      # chain hash -> block id
        self.block_hash: Dict[int, int] = {}      # block id -> chain hash
        # block id -> (parent chain hash, token tuple): collision guard +
        # the material for the I5 invariant check
        self.block_chain: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self.cached: "OrderedDict[int, None]" = OrderedDict()  # LRU order
        self.pending_copies: List[Tuple[int, int]] = []  # CoW (src, dst)
        # --- host offload tier (inactive when host_store is None) ---
        # spill: (block id, hash) device→host copies the physical tier owes;
        # restore: (hash, block id) host→device copies, queued by
        # match_prefix when a chain walk hits the host store.  Both drain
        # before the step's writes, spills first.
        self.host_store = host_store if prefix_caching else None
        self.pending_spills: List[Tuple[int, int]] = []
        self.pending_restores: List[Tuple[int, int]] = []
        self.stats: Dict[str, int] = dict(
            queries=0, hits=0, saved_tokens=0, shared_blocks=0, forks=0,
            evictions=0, allocated_blocks=0, restored_blocks=0)
        # observability seam: engine.attach_trace wires these (trace_ctx
        # yields the live (clock, replica_id) for spill/restore instants)
        self.trace = None
        self.trace_ctx = None

    def _trace_instant(self, name: str, **args) -> None:
        tr = self.trace
        if tr is not None and tr.enabled and self.trace_ctx is not None:
            t, rep = self.trace_ctx()
            tr.instant("kv", name, t, replica=rep, args=args)

    # ------------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self.free)

    @property
    def num_allocatable(self) -> int:
        """Blocks an allocation may consume: truly free plus cached-reusable
        (refcount-0 prefix blocks, evicted LRU-first on demand)."""
        return len(self.free) + len(self.cached)

    def blocks_needed(self, tokens: int) -> int:
        return max((tokens + self.block_size - 1) // self.block_size, 1)

    def can_allocate(self, tokens: int) -> bool:
        return self.num_allocatable >= self.blocks_needed(tokens)

    # ------------------------------------------------------------------
    def _pop_block(self, what: str) -> int:
        """One allocatable block id: the free list first, then LRU eviction
        of a cached-reusable prefix block (which unregisters it, spilling
        its content to the host tier when one is attached)."""
        if self.free:
            return self.free.pop()
        if self.cached:
            b = next(iter(self.cached))              # least recently used
            self._evict_cached_block(b)
            return b
        raise OutOfBlocks(f"{what}: pool exhausted")

    def _grow_table(self, table: List[int], need: int, what: str) -> List[int]:
        """Acquire ``need`` free blocks onto ``table`` (the single home of
        the free-list pop / refcount / append bookkeeping)."""
        if self.num_allocatable < need:
            raise OutOfBlocks(
                f"{what} needs {need}, allocatable {self.num_allocatable}")
        added = []
        for _ in range(need):
            b = self._pop_block(what)
            self.refcount[b] = self.refcount.get(b, 0) + 1
            table.append(b)
            added.append(b)
        self.stats["allocated_blocks"] += need
        return added

    def allocate(self, seq_id: int, tokens: int) -> List[int]:
        table: List[int] = []
        self._grow_table(table, self.blocks_needed(tokens), "allocate")
        self.tables[seq_id] = table
        self.lengths[seq_id] = tokens
        return table

    def _assert_writable(self, table: List[int], start: int, end: int,
                         what: str) -> None:
        """Hard error if the content-write range [start, end) covers any
        block shared with another sequence — the silent-aliasing hazard a
        missing ``fork_for_write`` would otherwise introduce."""
        bs = self.block_size
        for idx in range(start // bs, min(-(-end // bs), len(table))):
            b = table[idx]
            if self.refcount.get(b, 0) > 1:
                raise SharedBlockWrite(
                    f"{what}: positions [{start},{end}) cover block {b} "
                    f"(refcount {self.refcount[b]}); route the write through "
                    "fork_for_write first")

    def append_tokens(self, seq_id: int, n: int = 1) -> List[int]:
        """Extend a sequence by n tokens, allocating new blocks on demand.
        The appended token content lands in [old_len, old_len+n): that range
        must be private (see :meth:`fork_for_write`)."""
        table = self.tables[seq_id]
        old = self.lengths[seq_id]
        new = old + n
        self._assert_writable(table, old, new, "append")
        need = self.blocks_needed(new) - len(table)
        added = self._grow_table(table, need, "append") if need > 0 else []
        self.lengths[seq_id] = new
        return added

    def ensure_capacity(self, seq_id: int, tokens: int) -> List[int]:
        """Grow a sequence's block table to COVER ``tokens`` positions
        without changing its logical length — the real backend reserves
        room for this step's KV writes (decode token / speculative chunk /
        prefill chunk) BEFORE executing, so a paged write can never land in
        another sequence's blocks.  A later ``append_tokens`` for positions
        already covered allocates nothing."""
        table = self.tables[seq_id]
        need = self.blocks_needed(tokens) - len(table)
        if need <= 0:
            return []
        return self._grow_table(table, need, "reserve")

    def grow_to(self, seq_id: int, tokens: int) -> List[int]:
        """Ensure a sequence's table covers ``tokens`` positions, allocating
        only the shortfall (chunked prefill reserves per chunk, not per
        prompt).  No-op when the table already covers the target."""
        have = self.lengths[seq_id]
        if tokens <= have:
            return []
        return self.append_tokens(seq_id, tokens - have)

    def release(self, seq_id: int) -> None:
        dropped: List[int] = []
        for b in self.tables.pop(seq_id, []):
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                del self.refcount[b]
                if b >= self.total_blocks or b in self.reserved:
                    self._unregister(b)
                    continue
                if b in self.block_hash:
                    # registered prefix content stays reusable: park in the
                    # LRU tier (most-recently-used end) instead of freeing
                    self.cached[b] = None
                    self.cached.move_to_end(b)
                else:
                    self.free.append(b)
                    dropped.append(b)
        if dropped and self.pending_copies:
            # a pending CoW copy targeting a block that just went back to
            # the free list is moot (its forking sequence is gone) — and
            # executing it after reallocation would clobber the new owner
            ds = set(dropped)
            self.pending_copies = [p for p in self.pending_copies
                                   if p[1] not in ds]
        self.lengths.pop(seq_id, None)

    # ------------------------------------------------------------------
    # prefix sharing: content-hash index + copy-on-write forking
    # ------------------------------------------------------------------
    def _unregister(self, b: int) -> None:
        h = self.block_hash.pop(b, None)
        if h is not None and self.hash_index.get(h) == b:
            del self.hash_index[h]
        self.block_chain.pop(b, None)
        self.cached.pop(b, None)
        if h is not None and self.pending_restores:
            # the block was a restore TARGET whose host→device copy never
            # executed: cancel the restore — the host record (still pinned
            # until now) remains the sole owner of the content
            kept = [(ph, pb) for ph, pb in self.pending_restores if pb != b]
            if len(kept) != len(self.pending_restores):
                self.pending_restores = kept
                if self.host_store is not None:
                    self.host_store.unpin(h)

    def _evict_cached_block(self, b: int) -> None:
        """Evict one cached-reusable block: spill its content to the host
        tier (when attached, and unless the block is itself an
        unmaterialised restore target — then the host record already owns
        the content), then unregister.  The caller decides where the freed
        id goes (returned to the caller by ``_pop_block``, appended to the
        free list by ``plan_contraction``)."""
        hs = self.host_store
        h = self.block_hash.get(b)
        self.cached.pop(b, None)
        if hs is not None and h is not None and \
                not any(pb == b for _, pb in self.pending_restores):
            parent, toks = self.block_chain[b]
            hs.put(h, parent, toks)
            self.pending_spills.append((b, h))
            self._trace_instant("spill", block=b)
        self._unregister(b)
        self.stats["evictions"] += 1

    def match_prefix(self, tokens: Optional[Sequence[int]]
                     ) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: walk the hash chain over
        full blocks, verifying stored token content (collision guard).
        When the device index misses but the host tier holds the hash, the
        walk continues by *restoring*: a free device block is registered
        under the hash, parked in the cached-LRU tier, and the host→device
        copy queued for the physical tier — so admission accounting sees
        restorable blocks as cached.  Returns (block ids, matched token
        count) — both empty/0 when caching is off or nothing matches."""
        if not self.prefix_caching or not tokens:
            return [], 0
        self.stats["queries"] += 1
        bs = self.block_size
        blocks: List[int] = []
        h = _CHAIN_ROOT
        for i in range(len(tokens) // bs):
            blk = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            h = chain_hash(h, blk)
            b = self.hash_index.get(h)
            if b is not None:
                if self.block_chain[b][1] != blk:
                    break
                blocks.append(b)
                continue
            b = self._restore_block(h, blk)
            if b is None:
                break
            blocks.append(b)
        return blocks, len(blocks) * bs

    def _restore_block(self, h: int, blk: Tuple[int, ...]) -> Optional[int]:
        """Pull one host-tier block back onto the device: allocate strictly
        from the free list (never evict device-cached content to make room
        — that would thrash the warmer tier), register the hash at the new
        home, park it cached-reusable, and queue the host→device copy.  The
        host record stays (pinned) until the physical drain consumes it."""
        hs = self.host_store
        if hs is None or not self.free:
            return None
        rec = hs.get(h)
        if rec is None:
            return None
        if not hs.verify(h):
            # integrity stamp mismatch (bit rot, bad DMA, injected fault):
            # drop the record and let the prefix cold-re-prefill — bad KV
            # is never restored into the device tier
            hs.drop_corrupt(h)
            return None
        if rec.tokens != blk:
            return None
        b = self.free.pop()
        self.hash_index[h] = b
        self.block_hash[b] = h
        self.block_chain[b] = (rec.parent, rec.tokens)
        self.cached[b] = None
        self.cached.move_to_end(b)
        self.pending_restores.append((h, b))
        hs.pin(h)
        self.stats["restored_blocks"] += 1
        self._trace_instant("restore", block=b)
        return b

    def drain_pending_spills(self) -> List[Tuple[int, int]]:
        """Hand the queued device→host (block, hash) spills to the physical
        tier, which gathers each block's pages into the matching
        ``HostKVStore`` record (skipping hashes the host LRU already
        dropped).  Must run before this step's writes AND before
        ``drain_pending_restores`` — a block spilled and re-matched in the
        same round restores the payload this drain captures."""
        out, self.pending_spills = self.pending_spills, []
        return out

    def drain_pending_restores(self) -> List[Tuple[int, int]]:
        """Hand the queued host→device (hash, block) restores to the
        physical tier, which scatters each record's payload into the
        target block and then ``take``s the record (move semantics)."""
        out, self.pending_restores = self.pending_restores, []
        return out

    def share(self, seq_id: int, blocks: List[int], tokens: int) -> List[int]:
        """Admission side of prefix sharing: map cached prefix ``blocks``
        into a new sequence's table at refcount+1, crediting ``tokens``
        materialised positions (the cached prefix needs no prefill compute
        and no new blocks).  Cached-reusable blocks become pinned again."""
        assert seq_id not in self.tables, seq_id
        table: List[int] = []
        for b in blocks:
            self.cached.pop(b, None)          # pinned while refcount >= 1
            self.refcount[b] = self.refcount.get(b, 0) + 1
            table.append(b)
        self.tables[seq_id] = table
        self.lengths[seq_id] = tokens
        self.stats["hits"] += 1
        self.stats["saved_tokens"] += tokens
        self.stats["shared_blocks"] += len(blocks)
        return table

    def register_prefix(self, seq_id: int, tokens: Optional[Sequence[int]],
                        upto: int) -> int:
        """Publish a sequence's materialised *full* prompt blocks (the first
        ``upto`` tokens of ``tokens``) in the hash index so future
        admissions can share them.  Idempotent; already-cached hashes keep
        their first publisher.  Returns the number of newly indexed blocks."""
        if not self.prefix_caching or tokens is None:
            return 0
        table = self.tables.get(seq_id)
        if table is None:
            return 0
        bs = self.block_size
        n = min(upto, len(tokens)) // bs
        h = _CHAIN_ROOT
        added = 0
        for i in range(min(n, len(table))):
            blk = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            parent = h
            h = chain_hash(parent, blk)
            b = table[i]
            if self.block_hash.get(b) == h:
                continue                      # already registered
            if h in self.hash_index or b in self.block_hash:
                continue                      # hash or block taken elsewhere
            self.hash_index[h] = b
            self.block_hash[b] = h
            self.block_chain[b] = (parent, blk)
            if self.host_store is not None:
                # the sequence re-materialised this content on device (e.g.
                # a restore was skipped for lack of free blocks): the fresh
                # device copy supersedes the host record — drop it so the
                # tiers stay disjoint.  It cannot be pinned: a pinned hash
                # has a pending restore, hence is already in hash_index and
                # was skipped above.
                self.host_store.records.pop(h, None)
            added += 1
        return added

    def shared_blocks_in_range(self, blocks: List[int], start: int,
                               end: int) -> int:
        """How many of ``blocks`` (a table prefix) a write to positions
        [start, end) would touch — the worst-case fork count an admission
        must budget for."""
        bs = self.block_size
        lo = start // bs
        hi = min(-(-end // bs), len(blocks))
        return max(hi - lo, 0)

    def fork_for_write(self, seq_id: int, start: int, end: int
                       ) -> List[Tuple[int, int]]:
        """Copy-on-write: privatise every refcount>1 block the write range
        [start, end) covers.  Allocates a private replacement (may evict
        cached-reusable blocks), swaps it into the table, and records the
        (src, dst) pair in ``pending_copies`` for the physical tier to
        execute before the step's writes.  Returns the new pairs."""
        table = self.tables.get(seq_id)
        if table is None:
            return []
        bs = self.block_size
        copies: List[Tuple[int, int]] = []
        for idx in range(start // bs, min(-(-end // bs), len(table))):
            b = table[idx]
            if self.refcount.get(b, 0) > 1:
                nb = self._pop_block("fork")   # may raise OutOfBlocks
                self.refcount[b] -= 1
                self.refcount[nb] = 1
                table[idx] = nb
                # queue IMMEDIATELY: if a later block's fork raises, the
                # already-swapped private copies must still receive their
                # shared content (the caller preempts a victim and retries,
                # and the retry skips blocks that are now private)
                self.pending_copies.append((b, nb))
                copies.append((b, nb))
                self.stats["forks"] += 1
                self.stats["allocated_blocks"] += 1
        return copies

    def drain_pending_copies(self) -> List[Tuple[int, int]]:
        """Hand the accumulated CoW (src, dst) copies to the caller (the
        physical runtime batches them into one block-migration launch)."""
        out, self.pending_copies = self.pending_copies, []
        return out

    # ------------------------------------------------------------------
    # §6.3 expansion: attach [boundary, boundary + extra) to the pool
    def expand(self, extra_blocks: int) -> Tuple[int, int]:
        start = self.total_blocks
        self.total_blocks += extra_blocks
        # (1) allocatable ids extended; (2) refcounts implicitly zero;
        # (3) appended to the free queue
        self.free.extend(range(start, self.total_blocks))
        return start, self.total_blocks

    # §6.4 steps 1-2: identify evictees + build the migration plan
    def plan_contraction(self) -> Optional[MigrationPlan]:
        if self.total_blocks == self.base_blocks:
            return None
        # Cached-reusable (refcount-0) prefix blocks AT OR ABOVE the
        # boundary cannot survive the trim: evict them (spilling to the
        # host tier when attached).  Below-boundary cached blocks KEEP
        # their registrations — the shrunk pool can hold them, and
        # evicting them too would cold-restart the prefix cache on every
        # contraction cycle.
        for b in [x for x in self.cached if x >= self.boundary]:
            self._evict_cached_block(b)
            if b < self.total_blocks and b not in self.reserved:
                self.free.append(b)
        # deduplicate: a shared prefix block (refcount > 1) appears in
        # several tables but must migrate exactly once — a per-reference
        # list would reserve one dst per REFERENCE and strand the extras
        # in no tier (caught by I8)
        evict = sorted(
            {b for t in self.tables.values() for b in t if b >= self.boundary})
        # preserved-region free slots; when they cannot host every migrated
        # block, evict the minimum number of below-boundary cached blocks
        # (LRU-first, spilled like any other eviction) to make room —
        # pinned content always outranks reusable content
        low_free = [b for b in self.free if b < self.boundary]
        while len(low_free) < len(evict):
            b = next((x for x in self.cached if x < self.boundary), None)
            if b is None:
                break
            self._evict_cached_block(b)
            self.free.append(b)
            low_free.append(b)
        if len(low_free) < len(evict):
            return None  # not enough room — §6.4 step 2 verification failed
        dst = sorted(low_free)[: len(evict)]
        # remove migration targets from the free list & mark reserved
        dst_set = set(dst)
        self.free = [b for b in self.free if b not in dst_set and b < self.boundary]
        self.reserved |= dst_set
        return MigrationPlan(src=evict, dst=dst)

    # §6.4 step 4: atomic metadata update & remapping
    def commit_contraction(self, plan: MigrationPlan) -> None:
        mapping = dict(zip(plan.src, plan.dst))
        for seq_id, table in self.tables.items():
            self.tables[seq_id] = [mapping.get(b, b) for b in table]
        # queued CoW copies follow the same remapping: the §6.4 step-3 data
        # movement already relocated a migrated block's content, so a pending
        # (src, dst) pair must point at the blocks' post-migration homes
        # (stale high ids would index past the shrunk physical pools)
        self.pending_copies = [(mapping.get(s, s), mapping.get(d, d))
                               for s, d in self.pending_copies]
        for old, new in mapping.items():
            self.refcount[new] = self.refcount.pop(old)
            self.reserved.discard(new)
            # registered (pinned) prefix blocks carry their hash to the new
            # home; high cached refcount-0 blocks were already evicted at
            # plan time (below-boundary ones survive in place, untouched by
            # the mapping), so only table-referenced registrations appear
            h = self.block_hash.pop(old, None)
            if h is not None:
                self.block_hash[new] = h
                self.block_chain[new] = self.block_chain.pop(old)
                if self.hash_index.get(h) == old:
                    self.hash_index[h] = new
        # §6.4 step 5: trim the allocator index set
        self.free = [b for b in self.free if b < self.boundary]
        self.total_blocks = self.base_blocks
        self.reserved.clear()

    # ------------------------------------------------------------------
    def check_invariants(self, *, failed: bool = False) -> None:
        if failed:
            # I7: a FAILED replica owns nothing.  Its in-flight work is
            # lost, its blocks are gone — every block must be back on the
            # free list with no residual registrations, queued transfers
            # or host-store pins (a leak here is permanent: the replica
            # never steps again to drain anything).
            assert not self.tables, f"FAILED replica owns tables {self.tables}"
            assert not self.refcount, "FAILED replica holds refcounts"
            assert not self.cached, "FAILED replica holds cached blocks"
            assert not self.hash_index and not self.block_hash, \
                "FAILED replica holds registrations"
            assert not self.pending_copies, "FAILED replica owes CoW copies"
            assert not self.pending_spills, "FAILED replica owes spills"
            assert not self.pending_restores, "FAILED replica owes restores"
            assert len(self.free) == self.total_blocks, \
                (len(self.free), self.total_blocks)
            if self.host_store is not None:
                assert not self.host_store.pinned, \
                    f"FAILED replica pins host records {self.host_store.pinned}"
        refs: Dict[int, int] = {}
        for t in self.tables.values():
            for b in t:
                refs[b] = refs.get(b, 0) + 1
        assert refs == self.refcount, (refs, self.refcount)
        free_set = set(self.free)
        assert len(free_set) == len(self.free), "duplicate free blocks"
        for b in refs:
            assert b not in free_set, f"block {b} both free and referenced"
            assert 0 <= b < self.total_blocks
        for b in free_set:
            assert 0 <= b < self.total_blocks
        # I8: completeness — every pool block is in SOME structure.  The
        # checks above prove disjointness; this proves a release path
        # (cancellation, deadline reaping, force_fail) leaked nothing.
        covered = (free_set | set(refs) | set(self.cached)
                   | set(self.reserved))
        leaked = set(range(self.total_blocks)) - covered
        assert not leaked, f"blocks {sorted(leaked)} leaked (in no tier)"
        # I5: the prefix-cache index is consistent — every cached hash maps
        # to a live block whose stored token chain reproduces the hash, and
        # the cached-LRU tier is disjoint from both the free list and tables
        for b in self.cached:
            assert b in self.block_hash, f"cached block {b} unregistered"
            assert b not in refs, f"cached block {b} still referenced"
            assert b not in free_set, f"cached block {b} also free"
        for h, b in self.hash_index.items():
            assert self.block_hash.get(b) == h, (h, b)
            parent, toks = self.block_chain[b]
            assert chain_hash(parent, toks) == h, f"stale chain for block {b}"
            assert len(toks) == self.block_size, "partial block registered"
            assert b not in free_set, f"registered block {b} in free list"
            assert b in refs or b in self.cached, f"registered block {b} dead"
            assert 0 <= b < self.total_blocks
        for b, h in self.block_hash.items():
            assert self.hash_index.get(h) == b, (b, h)
        for src, dst in self.pending_copies:
            assert refs.get(dst) == 1, f"CoW target {dst} not private"
        # I6: the host tier's index is consistent with the device's — every
        # pending restore targets a registered (cached or pinned) device
        # block backed by a pinned host record, tiers are disjoint except
        # for restores in flight, and every host record reproduces its key
        hs = self.host_store
        if hs is not None:
            restoring = {h for h, _ in self.pending_restores}
            for h, b in self.pending_restores:
                assert h in hs.records, f"restore {h:#x} lost its record"
                assert h in hs.pinned, f"restore {h:#x} not pinned"
                assert self.hash_index.get(h) == b, (h, b)
                assert b in self.cached or b in refs, \
                    f"restore target {b} neither cached nor referenced"
            for h, rec in hs.records.items():
                if hs.verify(h):
                    assert chain_hash(rec.parent, rec.tokens) == h, \
                        f"host record {h:#x} chain mismatch"
                    assert len(rec.tokens) == self.block_size, \
                        "partial block spilled"
                else:
                    # a record may carry injected corruption, but never
                    # SILENTLY: the stamp must catch it, and a pinned
                    # record (restore in flight — its content is about to
                    # land on the device) must always verify
                    assert h not in hs.pinned, \
                        f"pinned host record {h:#x} fails its checksum"
                if h not in restoring:
                    assert h not in self.hash_index, \
                        f"hash {h:#x} live on both tiers without a restore"

