"""Shared-prefix KV reuse — the jax-free bookkeeping.

The port's copy of ``sparkdl_tpu/serving/prefix.py``, the same code.

A serving fleet sees the same prompt *heads* over and over (system
prompts, few-shot preambles, retry storms of one request). Prefilling
those tokens again is pure waste: the K/V a transformer writes for
token ``i`` depends only on tokens ``[0, i]``, so two prompts sharing a
token prefix share — bit for bit — the prefix's cache rows. This module
is the bookkeeping half of that reuse: an LRU of
``token-tuple → opaque payload`` under a byte budget, with hit / miss /
eviction counters. The payloads are opaque on purpose: the llama
backend stores device-resident K/V row pytrees (copied slot→entry and
entry→slot device-side, never through the host), while the jax-free
``StubBackend`` stores token tuples with synthetic byte sizes — the
scheduler logic around the cache is tier-1-testable without a device.

Hash scope: the key is the **exact token id tuple** of a completed
prefill's prompt (model- and layout-independent ids, not text — two
tokenizations that differ in ids never collide; the dict hashes the
tuple, token-by-token comparison makes collisions impossible).
``lookup`` returns the entry sharing the longest COMMON token prefix
with the new prompt — a stored prompt and a new one that diverge after
a shared head still reuse the head (the backend overwrites everything
past the reuse point before attention can read it).
Invalidation is purely budget-driven (LRU under
``SPARKDL_SERVE_PREFIX_CACHE_MB``): entries are immutable snapshots of
prompt-derived K/V, so they can never go stale — only cold. A backend
that swaps weights must ``clear()`` (new params ⇒ new K/V).

**Radix sharing.** :class:`PrefixCache`
copies K/V rows slot↔entry on every commit and hit. With a paged
backend the prompt's K/V already lives in shared-pool *blocks*, so
:class:`RadixPrefixCache` stores no payloads at all: it is a trie keyed
on **block-sized token runs** whose nodes name *physical block ids*. A
commit inserts the prompt's full blocks (the trie takes one refcount on
each through the :class:`serving.paging.BlockAllocator`); a hit is a
**block-table pointer graft** — the new slot's table entries point at
the cached blocks (one more refcount each), zero bytes copied, so the
system-prompt head of every concurrent request is ONE physical set of
blocks. Eviction is LRU over leaf blocks nobody references (refcount
1 = trie-only), driven by the allocator's ``reclaim`` hook when the
free list runs short — cached prefixes are reclaimable capacity, never
a leak. The same weight-swap rule applies: ``clear()`` on new params.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import zlib

__all__ = ["PrefixCache", "RadixPrefixCache", "PREFIX_CACHE_MB_ENV",
           "DEFAULT_PREFIX_CACHE_MB", "prefix_cache_budget_bytes",
           "usable_reuse", "prompt_digest_chain", "DIGEST_GRANULE"]

PREFIX_CACHE_MB_ENV = "SPARKDL_SERVE_PREFIX_CACHE_MB"
DEFAULT_PREFIX_CACHE_MB = 64.0

# Granule for the unpaged cache's residency digest (the radix cache
# digests at its block_size — the natural sharing unit it already has).
DIGEST_GRANULE = 16


def _run_hash(run, seed: int) -> int:
    """Chain-hash one granule run of token ids onto ``seed``. crc32 over
    a separator-joined id encoding: deterministic across processes (no
    PYTHONHASHSEED salt), collision-tolerant by design — the digest is a
    routing HINT; a false positive costs one suboptimal placement, never
    correctness (the engine's own caches compare token-by-token)."""
    return zlib.crc32(b"\x00".join(str(t).encode() for t in run),
                      seed) & 0xFFFFFFFF


def prompt_digest_chain(prompt, granule: int) -> list[tuple[int, int]]:
    """``(head_tokens, chained_hash)`` for every granule-aligned head of
    ``prompt`` — THE chaining both caches' :meth:`residency_digest` use,
    so a router can hash an incoming prompt once and intersect with each
    replica's digest set to find its deepest resident head."""
    granule = max(1, int(granule))
    prompt = tuple(prompt)
    out: list[tuple[int, int]] = []
    h = 0
    for i in range(0, (len(prompt) // granule) * granule, granule):
        h = _run_hash(prompt[i:i + granule], h)
        out.append((i + granule, h))
    return out


def prefix_cache_budget_bytes() -> int:
    """The env-configured budget in bytes (``0`` disables the cache —
    backends then skip the commit copies entirely)."""
    try:
        mb = float(os.environ.get(PREFIX_CACHE_MB_ENV,
                                  DEFAULT_PREFIX_CACHE_MB))
    except ValueError:
        mb = DEFAULT_PREFIX_CACHE_MB
    return max(0, int(mb * 2 ** 20))


def usable_reuse(n_shared: int, prompt_len: int, chunk: int) -> int:
    """THE reuse-rounding policy, shared by every backend (a drifted
    copy would desync the stub from the real backend and could hand the
    engine an empty chunk plan): usable reuse is capped at
    ``prompt_len - 1`` (the last token must run through the model to
    produce the first logits) and rounded DOWN to a ``chunk`` multiple
    (tail chunks then end exactly at the admission-checked
    ``ceil(L/chunk)*chunk`` row, so the final chunk's scatter can never
    clamp against ``max_len`` and slide back over committed rows — and
    committed payload row counts stay chunk multiples, bounding the
    copy-program count)."""
    chunk = max(1, int(chunk))
    return (min(int(n_shared), int(prompt_len) - 1) // chunk) * chunk


class PrefixCache:
    """LRU of ``(token tuple → payload)`` under a byte budget.

    Thread-safe (the engine thread commits while ``submit`` callers may
    snapshot stats). An entry counts ``nbytes`` against the budget as
    reported by the committer; inserting past the budget evicts
    least-recently-used entries first. An entry larger than the whole
    budget is refused (counted as an ``oversize`` non-insert, never a
    crash).
    """

    def __init__(self, budget_bytes: int):
        self.budget_bytes = max(0, int(budget_bytes))
        self._entries: collections.OrderedDict = collections.OrderedDict()
        # key -> (payload, nbytes, n_tokens)
        self._lock = threading.Lock()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.oversize = 0
        self.reused_tokens = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup(self, prompt) -> tuple[object, int, object]:
        """Entry with the longest COMMON token prefix with ``prompt``
        (the stored prompt need not be a prefix of the new one — two
        requests sharing a system-prompt head hit each other even
        though their tails diverge; the backend's scatter + the tail
        chunks' write-frontier overwrite make any rows past the shared
        head harmless). Returns ``(key, n_shared, payload)``;
        ``(None, 0, None)`` when nothing shares even one token. Pure —
        counters and LRU order move only when the caller commits to
        using (or skipping) the match via :meth:`use` /
        :meth:`note_miss`, because a match whose usable chunk-aligned
        reuse (:func:`usable_reuse`) rounds to zero is not a hit.

        Cost: O(entries x shared-head) token comparisons under the
        lock. Entry count is budget-bounded and device payloads are
        MB-scale (a single request's K/V rows), so a real cache holds
        tens of entries, not thousands — revisit with a radix/trie
        index if entries ever become cheap."""
        prompt = tuple(prompt)
        best_key, best_shared = None, 0
        with self._lock:
            for key in self._entries:
                shared = 0
                for a, b in zip(key, prompt):
                    if a != b:
                        break
                    shared += 1
                if shared > best_shared:
                    best_key, best_shared = key, shared
            if best_key is None:
                return None, 0, None
            payload, _, _ = self._entries[best_key]
            return best_key, best_shared, payload

    def use(self, key, reused_tokens: int):
        """Record one actual reuse of ``key`` (LRU touch + hit +
        reused-token counters)."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
            self.hits += 1
            self.reused_tokens += int(reused_tokens)

    def note_miss(self):
        with self._lock:
            self.misses += 1

    def put(self, prompt, payload, nbytes: int) -> bool:
        """Insert (or LRU-refresh) one completed prefill's rows. Returns
        True when the entry is resident after the call."""
        key = tuple(prompt)
        nbytes = int(nbytes)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)  # refresh; keep the
                return True                     # existing payload
            if nbytes > self.budget_bytes:
                self.oversize += 1
                return False
            while self.bytes + nbytes > self.budget_bytes and self._entries:
                _, (_, old_bytes, _) = self._entries.popitem(last=False)
                self.bytes -= old_bytes
                self.evictions += 1
            self._entries[key] = (payload, nbytes, len(key))
            self.bytes += nbytes
            return True

    def clear(self):
        with self._lock:
            self._entries.clear()
            self.bytes = 0

    def residency_digest(self, granule: int = DIGEST_GRANULE) -> dict:
        """Compact picture of what prefix heads are resident:
        ``{"granule": g, "heads": {chained_hash: head_tokens}}`` over
        every cached entry's granule-aligned heads (see
        :func:`prompt_digest_chain`). Keys are snapshotted under the
        lock; hashing runs outside it (tuples are immutable)."""
        with self._lock:
            keys = list(self._entries)
        heads: dict[int, int] = {}
        for key in keys:
            for n, h in prompt_digest_chain(key, granule):
                if heads.get(h, 0) < n:
                    heads[h] = n
        return {"granule": max(1, int(granule)), "heads": heads}

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "budget_bytes": self.budget_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "oversize": self.oversize,
                "reused_tokens": self.reused_tokens,
                "hit_rate": round(self.hits / (self.hits + self.misses), 4)
                if (self.hits + self.misses) else None,
            }


class _RadixNode:
    """One cached physical block: the trie edge into it is the block's
    token run, ``block`` its pool id."""

    __slots__ = ("children", "block", "last_used", "parent", "run")

    def __init__(self, parent=None, run=None, block=None):
        self.children: dict[tuple, _RadixNode] = {}
        self.block = block
        self.last_used = 0
        self.parent = parent
        self.run = run


class RadixPrefixCache:
    """Trie of block-sized token runs → physical pool block ids (see
    module doc). Holds ONE allocator reference per cached block; a graft
    is the caller's extra reference, eviction drops the trie's.

    Thread-safe for the same reason :class:`PrefixCache` is: the
    scheduler thread mutates while ``snapshot()`` callers read stats.
    Only FULL blocks are cached (a partial tail block is private to its
    request — its later positions get overwritten by that request's own
    decode, so sharing it would alias live writes).
    """

    def __init__(self, allocator, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.allocator = allocator
        self.block_size = int(block_size)
        self._root = _RadixNode()
        self._lock = threading.Lock()
        self._clock = itertools.count(1)
        self._n_blocks = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.reused_tokens = 0
        self.inserted_blocks = 0

    def __len__(self) -> int:
        with self._lock:
            return self._n_blocks

    def _runs(self, prompt):
        bs = self.block_size
        prompt = tuple(prompt)
        return [prompt[i:i + bs] for i in
                range(0, (len(prompt) // bs) * bs, bs)]

    def lookup(self, prompt) -> list[int]:
        """Physical block ids of the longest cached chain of FULL
        block runs heading ``prompt`` (possibly empty). Pure — counters
        and LRU order move only on :meth:`use` / :meth:`note_miss`,
        exactly the :class:`PrefixCache` contract."""
        out: list[int] = []
        with self._lock:
            node = self._root
            for run in self._runs(prompt):
                node = node.children.get(run)
                if node is None:
                    break
                out.append(node.block)
        return out

    def use(self, prompt, n_blocks: int, reused_tokens: int):
        """Record one actual graft of ``n_blocks`` cached blocks (LRU
        touch along the used chain + hit/reused-token counters). The
        CALLER refs the grafted blocks through the allocator — the trie
        only re-times them."""
        with self._lock:
            node, now = self._root, next(self._clock)
            for run in self._runs(prompt)[:n_blocks]:
                node = node.children.get(run)
                if node is None:
                    break
                node.last_used = now
            self.hits += 1
            self.reused_tokens += int(reused_tokens)

    def note_miss(self):
        with self._lock:
            self.misses += 1

    def insert(self, prompt, block_ids) -> int:
        """Cache ``prompt``'s full-block runs as ``block_ids`` (the
        committing slot's physical blocks, in logical order). New nodes
        take one allocator ref; runs already cached keep their EXISTING
        block (the committer's duplicate stays slot-private — two
        physical copies of one run never both enter the trie). Returns
        the number of newly cached blocks."""
        runs = self._runs(prompt)
        added = 0
        with self._lock:
            node, now = self._root, next(self._clock)
            for run, block in zip(runs, block_ids):
                child = node.children.get(run)
                if child is None:
                    self.allocator.ref(block)
                    child = _RadixNode(parent=node, run=run, block=block)
                    node.children[run] = child
                    self._n_blocks += 1
                    self.inserted_blocks += 1
                    added += 1
                child.last_used = now
                node = child
        return added

    def evictable_blocks(self) -> int:
        """Blocks the trie could free right now (refcount 1 = nobody
        but the trie holds them). Conservative capacity signal for the
        admission gate: free list + this is what ``allocate(reclaim=)``
        can ultimately deliver. One refcount snapshot per call — not
        one lock round-trip per node."""
        rc = self.allocator.snapshot_refcounts()
        with self._lock:
            return sum(1 for n in self._iter_nodes() if rc[n.block] == 1)

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def evict(self, n: int) -> int:
        """Free up to ``n`` blocks, LRU LEAF first (an inner node's
        children would dangle — and a grafted chain refs its whole
        head, so ancestors are never less referenced than descendants).
        Only trie-exclusive blocks (refcount 1) are candidates; blocks
        a live slot still reads are untouchable. Returns blocks freed —
        this is the allocator's ``reclaim`` hook. Each pass collects
        and drains ALL current leaf candidates in LRU order (one trie
        scan per pass, not per block); further passes only run when an
        eviction exposed a parent as a new leaf."""
        freed = 0
        with self._lock:
            while freed < n:
                rc = self.allocator.snapshot_refcounts()
                victims = sorted(
                    (node for node in self._iter_nodes()
                     if not node.children and rc[node.block] == 1),
                    key=lambda x: x.last_used)
                if not victims:
                    break
                for v in victims:
                    if freed >= n:
                        break
                    del v.parent.children[v.run]
                    self.allocator.deref(v.block)
                    self._n_blocks -= 1
                    self.evictions += 1
                    freed += 1
        return freed

    def clear(self):
        """Drop every trie-held reference (weight swap). Blocks live
        slots still reference stay allocated until those slots
        release."""
        with self._lock:
            for node in list(self._iter_nodes()):
                self.allocator.deref(node.block)
            self._root = _RadixNode()
            self._n_blocks = 0

    def residency_digest(self) -> dict:
        """Same shape as :meth:`PrefixCache.residency_digest`, granule
        fixed at ``block_size`` (the trie's edge unit): one chained hash
        per trie node, accumulated root→leaf, so every cached prefix
        head maps to exactly one digest entry."""
        heads: dict[int, int] = {}
        with self._lock:
            stack: list[tuple[_RadixNode, int, int]] = [(self._root, 0, 0)]
            while stack:
                node, h, depth = stack.pop()
                for run, child in node.children.items():
                    ch = _run_hash(run, h)
                    n = (depth + 1) * self.block_size
                    if heads.get(ch, 0) < n:
                        heads[ch] = n
                    stack.append((child, ch, depth + 1))
        return {"granule": self.block_size, "heads": heads}

    def stats(self) -> dict:
        with self._lock:
            return {
                "blocks": self._n_blocks,
                "block_size": self.block_size,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "reused_tokens": self.reused_tokens,
                "inserted_blocks": self.inserted_blocks,
                "hit_rate": round(self.hits / (self.hits + self.misses), 4)
                if (self.hits + self.misses) else None,
            }
