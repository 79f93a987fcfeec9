"""Paged KV-cache bookkeeping — the jax-free block allocator.

The port's copy of ``sparkdl_tpu/serving/paging.py``, the same code.

The unpaged serving tier reserves one full ``max_len`` cache row per
slot: HBM was bounded by ``num_slots × max_len`` whatever requests
actually used, and "8 slots" was a hard concurrency ceiling. Paging
(vLLM's PagedAttention layout) replaces the per-slot row with a **block
table over one shared K/V pool**: the pool is ``pool_blocks`` physical
blocks of ``block_size`` cache positions each, every slot carries a
``[max_blocks]`` int32 vector of physical block indices, and a logical
cache position ``p`` of a slot lives at pool position
``(table[p // block_size], p % block_size)``. A request then holds
exactly the blocks its prompt + generated tokens touch — concurrency is
bounded by what HBM holds, not by the worst-case reservation — and a
shared prompt head is a *pointer* (two tables naming the same physical
block), which is what makes radix prefix sharing
(:class:`serving.prefix.RadixPrefixCache`) a zero-copy graft.

This module is the allocator half, deliberately jax-free (the engine
and the ``StubBackend`` mirror ride it without a device):

- **free list** — ``allocate(n)`` pops physical blocks, ``deref``
  returns them at refcount 0; block 0 is the reserved **trash block**
  (never allocated): idle/stalled slots' tables point every entry at
  it, so the decode step's masked garbage writes land somewhere no
  request owns.
- **refcounts** — a block referenced by k slot tables + the radix trie
  has refcount k(+1); ``deref`` below zero raises (the double-free
  guard the acceptance pins); ``shared_count`` / ``shared_frac`` are
  the telemetry observables.
- **copy-on-write decision** — ``is_shared(b)`` tells a backend that a
  write would land in a block someone else can read; the backend copies
  the block first (``cow_blocks`` counts them). With chunk sizes a
  multiple of the block size and radix reuse rounded to chunk multiples
  the engine never writes into a shared block, so CoW is a safety net,
  but it is a *checked* one.
- **reclaim hook** — ``allocate(n, reclaim=...)`` lets the radix cache
  evict its LRU unreferenced blocks when the free list runs short, so
  cached-but-idle prefix blocks are capacity, not a leak.
- **latency ledger** — each allocate() records its wall time;
  ``drain_alloc_samples`` feeds the ``serving_block_alloc_s`` telemetry
  histogram without the allocator importing the telemetry plane.
"""

from __future__ import annotations

import collections
import threading
import time

__all__ = ["BlockAllocator", "BlockError", "BlockExhausted",
           "PagedBlockManager", "blocks_for_tokens"]


class BlockError(RuntimeError):
    """Allocator invariant violation (double free / bad block id) —
    always a bug in the caller, never a capacity condition."""


class BlockExhausted(RuntimeError):
    """The pool has fewer free(able) blocks than the caller needs.
    Capacity, not corruption: the engine backpressures admission (the
    request waits) instead of crashing."""


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Physical blocks covering ``n_tokens`` cache positions."""
    return -(-max(0, int(n_tokens)) // max(1, int(block_size)))


class BlockAllocator:
    """Free-list allocator with refcounts over ``num_blocks`` physical
    blocks (see module doc). Thread-safe: the scheduler thread
    allocates/frees while ``submit``/``snapshot`` callers read stats.
    """

    def __init__(self, num_blocks: int, *, trash_block: bool = True):
        if num_blocks < (2 if trash_block else 1):
            raise ValueError(f"pool needs >= {2 if trash_block else 1} "
                             f"blocks, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.trash = 0 if trash_block else None
        self._rc = [0] * self.num_blocks
        first = 1 if trash_block else 0
        if trash_block:
            self._rc[0] = 1  # pinned forever — never allocated or freed
        self._free: collections.deque[int] = collections.deque(
            range(first, self.num_blocks))
        self._lock = threading.Lock()
        self._alloc_samples: list[float] = []
        self.allocs = 0
        self.frees = 0
        self.failed_allocs = 0
        self.cow_blocks = 0
        self.peak_used = 0

    # -- capacity ---------------------------------------------------------
    @property
    def usable_blocks(self) -> int:
        """Blocks a request can ever hold (pool minus the trash block)."""
        return self.num_blocks - (0 if self.trash is None else 1)

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def used_count(self) -> int:
        with self._lock:
            return self.usable_blocks - len(self._free)

    def shared_count(self) -> int:
        """Blocks referenced more than once (the trash block excluded)."""
        with self._lock:
            return sum(1 for b, rc in enumerate(self._rc)
                       if rc >= 2 and b != self.trash)

    def can_allocate(self, n: int) -> bool:
        with self._lock:
            return len(self._free) >= n

    # -- alloc / ref / free ----------------------------------------------
    def allocate(self, n: int, reclaim=None) -> list[int] | None:
        """Pop ``n`` fresh blocks (each at refcount 1). When the free
        list is short and ``reclaim(k)`` is given, it is asked to free
        ``k`` more (the radix cache's LRU eviction) BEFORE giving up.
        Returns ``None`` on exhaustion — the caller backpressures."""
        if n <= 0:
            return []
        t0 = time.perf_counter()
        with self._lock:
            short = n - len(self._free)
        if short > 0 and reclaim is not None:
            reclaim(short)  # trie eviction derefs through this allocator
        with self._lock:
            if len(self._free) < n:
                self.failed_allocs += 1
                return None
            out = [self._free.popleft() for _ in range(n)]
            for b in out:
                self._rc[b] = 1
            self.allocs += n
            used = self.usable_blocks - len(self._free)
            if used > self.peak_used:
                self.peak_used = used
            self._alloc_samples.append(time.perf_counter() - t0)
            if len(self._alloc_samples) > 4096:  # bounded ledger
                del self._alloc_samples[:2048]
        return out

    def ref(self, b: int) -> int:
        with self._lock:
            if not 0 <= b < self.num_blocks or self._rc[b] <= 0:
                raise BlockError(f"ref of unallocated block {b}")
            self._rc[b] += 1
            return self._rc[b]

    def deref(self, b: int) -> int:
        """Drop one reference; the block returns to the free list at 0.
        Dropping below zero (or freeing the trash block) raises
        :class:`BlockError` — the double-free guard."""
        with self._lock:
            if not 0 <= b < self.num_blocks:
                raise BlockError(f"deref of invalid block id {b}")
            if b == self.trash:
                raise BlockError("deref of the reserved trash block")
            if self._rc[b] <= 0:
                raise BlockError(f"double free of block {b}")
            self._rc[b] -= 1
            if self._rc[b] == 0:
                self._free.append(b)
                self.frees += 1
            return self._rc[b]

    def refcount(self, b: int) -> int:
        with self._lock:
            return self._rc[b]

    def snapshot_refcounts(self) -> list[int]:
        """One-lock copy of every refcount — the radix cache's bulk
        read (per-node ``refcount()`` calls would pay one lock
        round-trip per cached block on every eviction scan)."""
        with self._lock:
            return list(self._rc)

    def is_shared(self, b: int) -> bool:
        """True when a write to ``b`` could be read by another holder —
        the copy-on-write trigger."""
        with self._lock:
            return self._rc[b] >= 2

    def note_cow(self):
        with self._lock:
            self.cow_blocks += 1

    # -- telemetry --------------------------------------------------------
    def drain_alloc_samples(self) -> list[float]:
        with self._lock:
            out, self._alloc_samples = self._alloc_samples, []
        return out

    def stats(self) -> dict:
        with self._lock:
            free = len(self._free)
            used = self.usable_blocks - free
            shared = sum(1 for b, rc in enumerate(self._rc)
                         if rc >= 2 and b != self.trash)
            return {
                "blocks_total": self.usable_blocks,
                "blocks_free": free,
                "blocks_used": used,
                "blocks_shared": shared,
                "utilization": round(used / self.usable_blocks, 4)
                if self.usable_blocks else 0.0,
                "peak_utilization": round(
                    self.peak_used / self.usable_blocks, 4)
                if self.usable_blocks else 0.0,
                "shared_frac": round(shared / used, 4) if used else 0.0,
                "allocs": self.allocs,
                "frees": self.frees,
                "failed_allocs": self.failed_allocs,
                "cow_blocks": self.cow_blocks,
            }


class PagedBlockManager:
    """The per-backend paged bookkeeping BOTH backends share (the jax
    ``PagedLlamaSlotBackend`` and the jax-free ``StubBackend`` mirror —
    one copy, so the scheduler-visible allocation policy cannot drift
    between them): per-slot block lists, radix graft / private
    allocation / release / copy-on-write decisions. The two
    device-specific actions ride callbacks: ``on_table(slot, idx,
    block)`` mirrors a table entry into the device-side block table
    (no-op for the stub), ``copy_block(src, dst)`` performs the CoW
    K/V copy (no-op for the stub — it has no K/V bytes).
    """

    def __init__(self, num_slots: int, max_len: int, block_size: int,
                 pool_blocks: int | None = None, *, radix: bool = True,
                 on_table=None, copy_block=None):
        from .prefix import RadixPrefixCache
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.max_blocks = -(-int(max_len) // self.block_size)
        self.max_len = self.max_blocks * self.block_size
        if pool_blocks is None:
            # default = the un-paged footprint (+ trash): paging is a
            # strict generalization; over-subscription comes from more
            # slots against a FIXED pool
            pool_blocks = self.num_slots * self.max_blocks + 1
        self.pool_blocks = int(pool_blocks)
        self.allocator = BlockAllocator(self.pool_blocks)
        self.radix = RadixPrefixCache(self.allocator, self.block_size) \
            if radix else None
        self.slot_blocks: list[list[int]] = [[] for _ in
                                             range(self.num_slots)]
        self._on_table = on_table or (lambda slot, idx, block: None)
        self._copy_block = copy_block or (lambda src, dst: None)
        # Static pool facts the owning backend publishes through
        # pool_stats() (observability: kv dtype, per-block
        # byte cost incl. scale overhead, effective block count). The
        # manager itself is jax-free and dtype-agnostic — it only
        # carries the dict.
        self.info: dict = {}

    # -- capacity ---------------------------------------------------------
    def _reclaim(self, n: int) -> int:
        return self.radix.evict(n) if self.radix is not None else 0

    def can_reserve(self, n: int) -> bool:
        """Free blocks plus what radix eviction could free. Slightly
        optimistic (an imminent graft pins blocks still counted
        evictable), so reservation can still raise
        :class:`BlockExhausted` — the engine requeues and waits."""
        free = self.allocator.free_count()
        if free >= n:
            return True
        return self.radix is not None and \
            free + self.radix.evictable_blocks() >= n

    def _extend(self, slot: int, blocks) -> None:
        start = len(self.slot_blocks[slot])
        for i, b in enumerate(blocks):
            self._on_table(slot, start + i, b)
        self.slot_blocks[slot].extend(blocks)

    # -- reservation ------------------------------------------------------
    def reserve_prompt(self, slot: int, prompt, chunk: int) -> int:
        """Arm a chunked zero-aligned prefill: graft the longest cached
        full-block head (pointer + refcount, zero copy), allocate
        private blocks covering the chunk-aligned remainder plus one
        decode block. Returns the reuse offset (a chunk multiple);
        raises :class:`BlockExhausted` with the graft rolled back when
        the pool cannot cover the prompt."""
        from .prefix import usable_reuse
        reuse = 0
        chunk = max(1, int(chunk))
        # Radix grafts are whole blocks, so chunk-aligned reuse must
        # also be block-aligned; the engine aligns chunk to the block
        # size — a misaligned direct caller just prefills cold.
        if self.radix is not None and chunk % self.block_size == 0:
            match = self.radix.lookup(prompt)
            reuse = usable_reuse(len(match) * self.block_size,
                                 len(prompt), chunk)
            nblk = reuse // self.block_size
            if nblk > 0:
                grafted = match[:nblk]
                for b in grafted:
                    self.allocator.ref(b)
                self._extend(slot, grafted)
                self.radix.use(prompt, nblk, reuse)
            else:
                reuse = 0
                self.radix.note_miss()
        # Reserve the REAL rows + one decode block. The chunk plan's
        # pad tail needs no blocks: the paged chunk primitive routes
        # pad writes to the trash block, so alignment never inflates a
        # request's footprint (in particular a preemption resume, whose
        # chunk-aligned served length can exceed what admission gated —
        # aligned reservation would deadlock the queue head forever).
        self._reserve_rows(slot, len(prompt), rollback=True)
        return reuse

    def reserve_bucket(self, slot: int, bucket: int) -> None:
        """Blocking-path reservation: ``bucket`` rows + 1 decode block
        (left-padded layout — no radix sharing)."""
        self._reserve_rows(slot, int(bucket), rollback=True)

    def _reserve_rows(self, slot: int, rows: int, rollback: bool):
        # Rows are REAL cache positions (prompt or blocking bucket) —
        # callers never pass pad-tail alignment (pad writes go to the
        # trash block). The slot's logical row is max_blocks blocks,
        # hard: clamp the +1 decode block to it.
        rows = min(int(rows), self.max_len)
        need = min(blocks_for_tokens(rows, self.block_size) + 1,
                   self.max_blocks) - len(self.slot_blocks[slot])
        if need <= 0:
            return
        got = self.allocator.allocate(need, reclaim=self._reclaim)
        if got is None:
            if rollback:
                self.release(slot)  # drops graft refs too
            raise BlockExhausted(
                f"slot {slot} needs {need} more blocks; "
                f"{self.allocator.free_count()} free of "
                f"{self.allocator.usable_blocks}")
        self._extend(slot, got)

    def ensure_block_for(self, slot: int, pos: int) -> bool:
        """Make logical position ``pos`` writable: allocate decode-
        growth blocks on demand, copy-on-write when the target block is
        shared (safety net — chunk-aligned grafts keep writes out of
        shared blocks, but a drifted caller must corrupt nothing).
        False on exhaustion: the caller stalls the slot, never
        crashes."""
        bi = int(pos) // self.block_size
        if bi >= self.max_blocks:
            return False  # beyond the slot's logical row — caller bug
        blocks = self.slot_blocks[slot]
        while len(blocks) <= bi:
            got = self.allocator.allocate(1, reclaim=self._reclaim)
            if not got:
                return False
            self._extend(slot, got)
        if self.allocator.is_shared(blocks[bi]):
            return self._cow(slot, bi)
        return True

    def _cow(self, slot: int, bi: int) -> bool:
        new = self.allocator.allocate(1, reclaim=self._reclaim)
        if not new:
            return False
        old = self.slot_blocks[slot][bi]
        self._copy_block(old, new[0])
        self.slot_blocks[slot][bi] = new[0]
        self._on_table(slot, bi, new[0])
        self.allocator.deref(old)
        self.allocator.note_cow()
        return True

    # -- commit / release -------------------------------------------------
    def commit(self, slot: int, prompt) -> int:
        """Radix-commit the prompt's FULL blocks (zero-copy: the trie
        refs the slot's own pool blocks). Returns blocks newly
        cached."""
        if self.radix is None:
            return 0
        nfull = len(prompt) // self.block_size
        if nfull <= 0:
            return 0
        return self.radix.insert(prompt, self.slot_blocks[slot][:nfull])

    def release(self, slot: int):
        """Drop every table reference: blocks return to the free list
        at refcount 0 (radix-cached ones stay resident on the trie's
        ref); the table parks on the trash block."""
        for b in self.slot_blocks[slot]:
            self.allocator.deref(b)
        self.slot_blocks[slot] = []
        for i in range(self.max_blocks):
            self._on_table(slot, i, 0)

    # -- telemetry --------------------------------------------------------
    def drain_alloc_samples(self) -> list[float]:
        return self.allocator.drain_alloc_samples()

    def pool_stats(self) -> dict:
        st = self.allocator.stats()
        if self.radix is not None:
            st["radix_blocks"] = len(self.radix)
        st.update(self.info)
        return st

    def prefix_stats(self) -> dict | None:
        return None if self.radix is None else self.radix.stats()
