"""LlamaSlotBackend — the torch half of the continuous-batching engine.

The counterpart of ``sparkdl_tpu/serving/backend.py`` (its single-device
backends). Owns the device-resident slot cache and the per-slot fill
state (``cur``/``pad_lens`` vectors, host-side), and drives the slot
primitives of ``models.llama``:

- ``prefill_into_slot``: the *blocking* whole-prompt refill
  (``SPARKDL_SERVE_STALL_FREE=0``), one call per prompt-length bucket;
  its prefill runs the flash-attention kernel when the model's
  attention resolves to it;
- ``prefill_chunk_into_slot``: the stall-free chunk primitive the engine
  interleaves with decode steps (``begin_prefill`` / ``prefill_chunk`` /
  ``finish_prefill``);
- ``slot_decode_step``: every slot one token at its own fill index — the
  steady-state hot path, through the flash-decode kernel with a per-row
  ``cur``; ``slot_verify_step``: the speculative verify window.

Every call's operand shapes are noted in ``core.runtime
.GLOBAL_COMPILE_CACHE``: "the decode step keeps ONE signature for the
engine's lifetime" stays an observable, as in the JAX package.

**The compiled decode step.** Where the JAX backends call a jitted step,
:meth:`LlamaSlotBackend.step` runs the model half of the S = 1 step
(``models.llama.slot_decode_logits`` / ``paged_slot_decode_logits``)
through the backend's own ``core.runtime.CompileCache`` (``graphs``): on
the card it is captured into a CUDA graph at the first step and replayed
at every later one, its operands copied into the graph's static buffers
first (on the CPU the same buffers feed an eager call). Sampling runs
after it, eagerly. A new cache (``_make_cache``: construction and
:meth:`rebuild`) drops the graphs, which point into the old one.

**Fill-state invariant (chunked mode).** ``_cur[slot]`` is always the
slot's *write frontier* — the next cache position a real write will
land on. A decode step unconditionally writes every row's (masked,
discarded) token at its own ``_cur``, so a decode step running between
two prefill chunks garbage-writes exactly AT the frontier, which the
next chunk (or the request's own first decode step) overwrites before
any attention can read it. Parking a mid-prefill slot anywhere *below*
its frontier would clobber committed prompt K/V.

**Paged variant.** :class:`PagedLlamaSlotBackend` replaces the per-slot
``max_len`` rows with block tables over ONE shared K/V pool: per-request
memory is the blocks actually touched, shared prompt heads are pointer
grafts (:class:`serving.prefix.RadixPrefixCache`), and allocation policy
lives in the device-free :class:`serving.paging.PagedBlockManager`, the
same object the ``StubBackend`` mirror rides. Decode steps and verify
windows attend through the tables in the paged flash-decode kernel
(``ops.paged_flash_decode``); idle and block-stalled slots' tables point
at the trash block 0, and writes past a table route there too, never
clamped back over a committed block. A ``kv_dtype`` pool stores int8 or
fp8 codes with a per-(block, kv head) scale plane.

**In place, not donated.** The JAX backends donated the cache to every
jitted call and detected a lost cache by a deleted buffer. The port
writes the cache in place, so a host-side error before any launch
leaves it usable and keeps the engine's per-request retry; a CUDA
runtime error (a refused or faulted kernel, ``ops._build.CudaError``,
or torch's own CUDA error) means the device state cannot be trusted and
becomes :class:`SlotCacheLost`, so the engine fails over through
:meth:`rebuild`.

Sampling: greedy (``temperature<=0``) is deterministic and
token-identical to the static ``generate()`` path for the same prompt.
With temperature sampling the draws come from one ``torch.Generator``
seeded from ``seed`` on the model's device: reproducible for a fixed
engine schedule, but not the draws ``generate()`` makes.

``weight_dtype="int8"`` quantizes the model's projection weights in
place at construction (``models.llama.quantize_params``, the
reference's ``_weight_quantize``): every later call, the captured decode
step included, runs the int8 products.

**Tensor-parallel variants** (:class:`TensorParallelLlamaSlotBackend`,
:class:`TensorParallelPagedLlamaSlotBackend`): one process a device, the
engine's tp group a ``{"tp": n}`` mesh of consecutive ranks
(:func:`tp_mesh`). Each rank serves ``models.llama.shard_model``'s shard
of the global model (1/n of the heads and MLP columns), with dense
prefill and the decode kernels on its local heads through
``parallel.sharding.head_sharded_kernel``, and holds 1/n of every cache
row or pool block (its ``kv_heads``). Block ids stay logical: the block
manager, radix trie, copy-on-write and preemption are the base classes'.
Every rank of the group makes the same calls with the same arguments
(the SPMD contract of every collective); logits are gathered, so every
rank samples the same tokens from a generator seeded alike. A started
engine keeps that contract through its front (``serving.group``), whose
control channel the backend holds as ``control``.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..core.runtime import GLOBAL_COMPILE_CACHE, CompileCache
from ..models import llama as L
from ..ops import flash_decode as fd
from ..ops import paged_flash_decode as pfd
from ..ops._build import CudaError
from ..runner import chaos as chaos_lib
from .paging import PagedBlockManager
from .prefix import (PrefixCache, prefix_cache_budget_bytes,
                     usable_reuse)

log = logging.getLogger("sparkdl_tpu_torch.serving")


class SlotCacheLost(RuntimeError):
    """A slot call failed on the device: the in-flight KV state cannot be
    trusted, so retrying the call cannot help. ``serving_fatal`` tells the
    (device-free) engine to fail over cleanly instead of burning its
    retry budget and evicting innocent requests one by one."""

    serving_fatal = True


def _sig(*tensors) -> tuple:
    """(shape, dtype) of every tensor — the call's shape signature."""
    return tuple((tuple(t.shape), str(t.dtype)) for t in tensors)


def _is_device_error(e: BaseException) -> bool:
    """True for a CUDA runtime error: a kernel the launcher saw refused
    or faulted, or torch's own CUDA error."""
    if isinstance(e, CudaError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and "CUDA error" in str(e)


def _weight_quantize(self, weight_dtype) -> None:
    """The int8-weight hook both backends run at construction, before the
    cache is made: validate the mode and quantize ``self.model``'s
    projections in place (each float weight is released as its codes
    land). A model already quantized is left as it is."""
    self.weight_dtype = weight_dtype
    if weight_dtype is None:
        return
    L.quantize_params(self.model, weight_dtype)
    log.info("serving with %s-quantized projection weights (absmax "
             "per-channel scales, applied after each product)",
             weight_dtype)


def _gather_slot_rows(cache: L.KVCache, slot: int, rows: int) -> L.KVCache:
    """Copy ``[0, rows)`` of one slot's K/V rows out of the slot cache —
    the prefix-cache COMMIT copy."""
    return L.KVCache([k[slot:slot + 1, :, :rows].clone() for k in cache.k],
                     [v[slot:slot + 1, :, :rows].clone() for v in cache.v])


def _scatter_prefix_rows(cache: L.KVCache, payload: L.KVCache,
                         slot: int) -> None:
    """Write a cached prefix payload's rows into row ``slot`` at position
    0 — the prefix-cache HIT copy, on the device. Rows past the payload's
    real token count are stale entry state: the engine's tail chunks
    overwrite everything from the reuse point on before attention can
    reach it (the write-frontier invariant in the module doc)."""
    for big, sm in zip(cache.k + cache.v, payload.k + payload.v):
        big[slot:slot + 1, :, :sm.shape[2]] = sm


def _check_kernels(model, paged_dtype=None) -> None:
    """Raise at construction when the model's attention would reach a
    kernel that cannot take its decode shapes on this device (head dim,
    dtype): a CUDA tensor reaches the kernel or an exception, and the
    engine should refuse before it admits a request."""
    if model.device.type != "cuda":
        return
    c, mesh = model.cfg, model.kernel_mesh
    attn_fn = L.resolve_attn_fn(model.attn_fn)
    q = torch.empty((1, model.heads, 1, c.head_dim), dtype=model.dtype,
                    device=model.device)
    if paged_dtype is None:
        if fd.decode_fn_for(attn_fn, mesh) is not None:
            kc = torch.empty((1, model.kv_heads, 1, c.head_dim),
                             dtype=model.dtype, device=model.device)
            reason = fd.support_reason(q, kc)
            if reason is not None:
                raise ValueError(f"flash_decode kernel: {reason}")
        return
    if pfd.paged_decode_fn_for(attn_fn, mesh) is not None:
        pool = torch.empty((1, model.kv_heads, 1, c.head_dim),
                           dtype=paged_dtype, device=model.device)
        scales = None if paged_dtype == model.dtype else \
            torch.empty((1, model.kv_heads, 2), device=model.device)
        reason = pfd.support_reason(q, pool, scales)
        if reason is not None:
            raise ValueError(f"paged_flash_decode kernel: {reason}")


class LlamaSlotBackend:
    """Slot backend over ``models.llama`` (see module doc).

    ``num_slots`` cache rows, each independently one in-flight request;
    ``max_len`` cache slots per row (a request needs
    ``bucket(prompt) + max_new_tokens <= max_len`` — the engine's
    admission check). The cache is written in place, so the device
    footprint stays one cache however many refills happen. ``model`` is
    the port's ``LlamaModel``; the cache lives on its device.
    """

    #: tensor-parallel degree: 1 here, the mesh's extent on the
    #: tensor-parallel variants
    tp_degree = 1

    def __init__(self, model, num_slots: int, max_len: int, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0,
                 prefix_cache_bytes: int | None = None,
                 weight_dtype: str | None = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.model = model
        self.device = model.device
        _weight_quantize(self, weight_dtype)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.vocab_size = int(model.cfg.vocab_size)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        _check_kernels(model)
        self.graphs = CompileCache()
        self._cache_gen = 0  # which cache the graphs' keys name
        self.cache = self._make_cache()
        self._tokens = np.zeros(self.num_slots, np.int32)
        # Idle slots park at fill index 0 — their write frontier: the
        # step's (masked, discarded) write lands exactly where the next
        # refill's first real write will overwrite it.
        self._cur = np.zeros(self.num_slots, np.int32)
        self._pads = np.zeros(self.num_slots, np.int32)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        budget = prefix_cache_budget_bytes() if prefix_cache_bytes is None \
            else max(0, int(prefix_cache_bytes))
        self.prefix_cache = PrefixCache(budget) if budget > 0 else None
        self._warned_commit = False

    def _make_cache(self):
        self.graphs.drop()  # they point into the cache being replaced
        self._cache_gen += 1
        return L.init_cache(self.model, self.num_slots, self.max_len)

    def _dev(self, arr, dtype=torch.int32) -> torch.Tensor:
        """A host array as a tensor on the backend's device."""
        return torch.as_tensor(np.asarray(arr)).to(self.device, dtype)

    def _sampling(self) -> dict:
        return dict(temperature=self.temperature, top_k=self.top_k,
                    top_p=self.top_p)

    def kv_pool_device_bytes(self) -> int:
        """Device bytes of the slot cache / paged pool: K/V plus a
        quantized pool's scale planes — this rank's own (1/tp of the
        whole under tensor parallelism). The engine exports it as the
        ``serving_kv_pool_device_bytes`` gauge."""
        return sum(t.numel() * t.element_size() for t in self.cache.tensors())

    # -- engine protocol --------------------------------------------------
    def prefill(self, slot: int, prompt, bucket: int) -> int:
        """Prefill ``prompt`` (left-padded to ``bucket``) into ``slot``;
        returns the first sampled token."""
        if bucket > self.max_len:
            raise ValueError(f"bucket {bucket} > max_len {self.max_len}")
        ids, pad = L.left_pad_prompts([list(prompt)], pad_to=bucket)
        ids, pad = ids.to(self.device), pad.to(self.device)
        GLOBAL_COMPILE_CACHE.note(
            "serve_prefill",
            (_sig(ids, pad), _sig(*self.cache.tensors()), self.temperature,
             self.top_k, self.top_p))
        tok = self._guarded(L.prefill_into_slot, self.model, ids, pad,
                            self.cache, int(slot), self._gen,
                            **self._sampling())
        tok = int(tok[0])
        self._tokens[slot] = tok
        self._cur[slot] = bucket
        self._pads[slot] = int(pad[0])
        return tok

    # -- chunked (stall-free) prefill protocol ----------------------------
    def begin_prefill(self, slot: int, prompt, chunk: int) -> int:
        """Arm ``slot`` for a chunked (zero-aligned) prefill. Looks the
        prompt up in the prefix cache; on a hit the cached rows are
        copied into the slot on the device and the returned offset tells
        the engine where its tail chunks start (0 on miss; the cap/
        rounding policy is :func:`serving.prefix.usable_reuse`)."""
        self._pads[slot] = 0
        self._tokens[slot] = 0
        self._cur[slot] = 0  # frontier: nothing written yet
        if self.prefix_cache is None:
            return 0
        key, n_cached, payload = self.prefix_cache.lookup(prompt)
        reuse = usable_reuse(n_cached, len(prompt), chunk)
        if reuse <= 0 or payload is None:
            self.prefix_cache.note_miss()
            return 0
        GLOBAL_COMPILE_CACHE.note(
            "serve_prefix_put", (_sig(*payload.tensors()),
                                 _sig(*self.cache.tensors())))
        self._guarded(_scatter_prefix_rows, self.cache, payload, int(slot))
        self.prefix_cache.use(key, reuse)
        self._cur[slot] = reuse  # frontier: tail chunks start here
        return reuse

    def prefill_chunk(self, slot: int, chunk, offset: int,
                      n_valid: int, window: int | None = None) -> int:
        """Consume one fixed-size chunk of a prompt into ``slot`` at
        ``[offset, offset + C)``; ``n_valid`` = real (non-pad) tokens in
        the chunk; ``window`` = the request's chunk-aligned total prompt
        length (the chunk attends only that many rows). Returns the token
        sampled at the chunk's last real position — the engine uses it
        only from the FINAL chunk."""
        ids = self._dev(np.asarray(chunk, np.int64)[None, :], torch.int64)
        window = self.max_len if window is None \
            else min(int(window), self.max_len)
        GLOBAL_COMPILE_CACHE.note(
            "serve_prefill_chunk",
            (_sig(ids), _sig(*self.cache.tensors()), window,
             self.temperature, self.top_k, self.top_p))
        tok = self._guarded(L.prefill_chunk_into_slot, self.model, ids,
                            self.cache, int(slot), int(offset), int(n_valid),
                            self._gen, window=window, **self._sampling())
        # frontier: the next write (chunk or first decode token) lands
        # past this chunk's rows
        self._cur[slot] = offset + len(chunk)
        return int(tok[0])

    def finish_prefill(self, slot: int, prompt, last_tok: int,
                       aligned_len: int, commit: bool = True) -> int:
        """Complete a chunked prefill: pin the slot's decode state at the
        REAL prompt length and (when ``commit``) copy the prompt's rows
        into the prefix cache (``aligned_len`` = chunk-aligned written
        length). Returns the request's first token."""
        n = len(prompt)
        self._tokens[slot] = int(last_tok)
        self._cur[slot] = n
        self._pads[slot] = 0
        if commit and self.prefix_cache is not None:
            try:
                chaos_lib.fire("serve_commit", batch=slot)
                self._commit_prefix(slot, prompt, aligned_len)
            except Exception as e:  # noqa: BLE001 — caching is an
                # optimization, never fatal — UNLESS the error says the
                # slot state itself is gone (injected cache_lost /
                # SlotCacheLost): then the engine must fail over.
                if getattr(e, "serving_fatal", False):
                    raise
                if not self._warned_commit:
                    self._warned_commit = True
                    log.warning("prefix-cache commit failed (%s: %s); "
                                "suppressing further warnings",
                                type(e).__name__, e)
        return int(last_tok)

    def _commit_prefix(self, slot: int, prompt, aligned_len: int):
        key = tuple(int(t) for t in prompt)
        cache_obj = self.prefix_cache
        if cache_obj is None or aligned_len < 1:
            return
        rows = min(int(aligned_len), self.max_len)
        GLOBAL_COMPILE_CACHE.note(
            "serve_prefix_gather", (rows, _sig(*self.cache.tensors())))
        payload = self._guarded(_gather_slot_rows, self.cache, int(slot),
                                rows)
        nbytes = sum(t.numel() * t.element_size() for t in payload.tensors())
        cache_obj.put(key, payload, nbytes)

    def prefix_stats(self) -> dict | None:
        return None if self.prefix_cache is None else \
            self.prefix_cache.stats()

    def _step_operands(self) -> tuple:
        return (self._dev(self._tokens, torch.int64), self._dev(self._cur),
                self._dev(self._pads))

    def _advance(self, active_slots, nxt) -> list[int]:
        nxt = nxt.cpu().numpy().astype(np.int32)
        # Only busy slots advance their fill index (each just wrote at
        # cur, the next token lands at cur+1 — admission guarantees
        # bucket + max_new <= max_len so this never overruns); idle
        # slots stay parked and their write is masked garbage.
        active = np.asarray(sorted(active_slots), np.int32)
        self._cur[active] += 1
        self._tokens[active] = nxt[active]
        return nxt.tolist()

    def _decode_logits(self, tok, cur, pads):
        return L.slot_decode_logits(self.model, self.cache, tok, cur, pads)

    def _replay(self, sig: tuple, fn, operands) -> list[int]:
        """The S = 1 step ``fn(*operands)`` through :attr:`graphs`, keyed
        by its signature and this cache; then the eager sample."""
        logits = self._guarded(self.graphs.get, "serve_decode_step",
                               (sig, self._cache_gen), fn, operands,
                               L.LAUNCH_COUNTED)
        return L._sample(logits, self._gen, **self._sampling())

    def step(self, active_slots) -> list[int]:
        """Advance every slot one token at its own fill index; returns
        the per-slot token list (idle slots' entries are garbage — the
        engine only reads ``active_slots``)."""
        tok, cur, pads = self._step_operands()
        sig = (_sig(tok, cur, pads), _sig(*self.cache.tensors()))
        # after warmup this must stay ONE signature for the engine's
        # lifetime — the observable for "refills never change the step"
        GLOBAL_COMPILE_CACHE.note(
            "serve_decode_step",
            (*sig, self.temperature, self.top_k, self.top_p))
        nxt = self._replay(sig, self._decode_logits, (tok, cur, pads))
        return self._advance(active_slots, nxt)

    # -- speculative verify protocol --------------------------------------
    def _verify_tokens(self, drafts, k: int):
        """The verify window's token matrix: column 0 is each slot's
        current token (what the decode step would consume), columns
        1..k its drafts (zero-padded — a padded column's write lands
        past the frontier / gets dropped, and its proposal is never
        committed)."""
        toks = np.zeros((self.num_slots, int(k) + 1), np.int64)
        toks[:, 0] = self._tokens
        for s, d in drafts.items():
            if d:
                toks[s, 1:1 + len(d)] = np.asarray(d, np.int64)
        return self._dev(toks, torch.int64)

    def _check_greedy(self):
        if self.temperature > 0.0:
            raise ValueError("speculative verify is greedy-only "
                             f"(temperature {self.temperature:g} > 0)")

    def verify(self, active_slots, drafts, k: int) -> list[list[int]]:
        """One batched speculative verify window
        (``models.llama.slot_verify_step``): k+1 greedy proposals per
        slot in one forward. Does NOT advance any fill state — the engine
        commits the accepted prefix via :meth:`commit_spec` (reject = no
        call at all). Greedy-only: the engine gates speculation on
        ``temperature <= 0``."""
        self._check_greedy()
        tok = self._verify_tokens(drafts, k)
        _, cur, pads = self._step_operands()
        GLOBAL_COMPILE_CACHE.note(
            "serve_verify_step",
            (_sig(tok, cur, pads), _sig(*self.cache.tensors())))
        props = self._guarded(L.slot_verify_step, self.model, self.cache,
                              tok, cur, pads)
        return props.cpu().numpy().astype(np.int32).tolist()

    def commit_spec(self, slot: int, n_tokens: int, last_tok: int):
        """Advance ``slot``'s write frontier past the ``n_tokens``
        positions the verify window committed and pin its current
        token. Rejected rows sit at/past the new frontier — garbage the
        next write overwrites before attention reads it, so rollback is
        exactly this non-advance (no device work)."""
        self._cur[slot] += int(n_tokens)
        self._tokens[slot] = int(last_tok)

    def _guarded(self, fn, *args, **kw):
        """Run one slot call; a CUDA runtime error becomes
        :class:`SlotCacheLost` so the engine fails over instead of
        retrying against device state it cannot trust. Host-side
        failures (validation, chaos before a launch) leave the in-place
        cache usable and keep the per-request retry/quarantine path."""
        try:
            return fn(*args, **kw)
        except SlotCacheLost:
            raise
        except Exception as e:
            if _is_device_error(e):
                raise SlotCacheLost(
                    f"slot cache lost in failed "
                    f"{getattr(fn, '__name__', fn)}: "
                    f"{type(e).__name__}: {e}") from e
            raise

    def release(self, slot: int):
        """Retire hook: park the slot at fill index 0 (its stale cache
        rows are dead — a future refill overwrites [0, bucket) and masks
        everything past its own fill index)."""
        self._cur[slot] = 0
        self._pads[slot] = 0
        self._tokens[slot] = 0

    def rebuild(self):
        """Failover hook: allocate a fresh slot cache, reset every slot's
        host-side frontier, and drop the prefix cache (its payloads were
        copied from the lost cache). The engine re-admits live requests
        via the preemption-resume path, so nothing here needs their
        state."""
        self.cache = None  # release the old cache before the new one
        self.cache = self._make_cache()
        self._tokens[:] = 0
        self._cur[:] = 0
        self._pads[:] = 0
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        self._warned_commit = False


def pool_bytes_per_block(model, block_size: int,
                         kv_dtype: str | None = None) -> int:
    """Bytes one physical block costs across every layer — the
    ``SPARKDL_SERVE_KV_POOL_MB`` → block-count conversion, derived from
    :func:`models.llama.paged_pool_spec` (the allocation's own source of
    truth; nothing is allocated). With ``kv_dtype`` the count covers the
    quantized K/V codes PLUS each block's slice of the ``kv_scale``
    planes, so an int8 pool's block gain is honest."""
    return sum(math.prod(shape) * dt.itemsize
               for shape, dt in L.paged_pool_spec(model, 1, int(block_size),
                                                  kv_dtype))


class PagedLlamaSlotBackend(LlamaSlotBackend):
    """Block-table slot backend: one shared K/V pool of ``pool_blocks``
    physical blocks, a ``[num_slots, max_blocks]`` int32 block table, a
    device-free :class:`serving.paging.BlockAllocator` (free list +
    refcounts + copy-on-write), and block-granular radix prefix sharing
    (:class:`serving.prefix.RadixPrefixCache`) whose hits are table
    pointer grafts — zero K/V bytes copied.

    ``self.cache`` *is* the pool. Slot tables and the allocator live
    host-side; a slot's logical row ``[0, max_len)`` maps through its
    table, unallocated entries point at the reserved trash block 0 so
    masked garbage writes (idle / block-stalled slots) land where no
    request reads.

    Sizing: ``pool_blocks`` directly, or ``kv_pool_mb`` converted via
    :func:`pool_bytes_per_block`; the default matches the un-paged
    footprint (``num_slots × ceil(max_len / block_size)`` + trash).
    ``kv_dtype`` ('int8' / 'fp8') stores codes plus scale planes.
    """

    paged = True

    def __init__(self, model, num_slots: int, max_len: int, *,
                 block_size: int = 16, pool_blocks: int | None = None,
                 kv_pool_mb: float | None = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0,
                 prefix_cache_bytes: int | None = None,
                 kv_dtype: str | None = None,
                 weight_dtype: str | None = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        qdt = model.dtype if kv_dtype is None else \
            L.kv_quant_spec(kv_dtype)[0]  # raises on an unknown mode
        self.kv_dtype = kv_dtype
        self.model = model
        self.device = model.device
        _weight_quantize(self, weight_dtype)
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.max_blocks = -(-int(max_len) // self.block_size)
        self.max_len = self.max_blocks * self.block_size
        self.vocab_size = int(model.cfg.vocab_size)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        _check_kernels(model, qdt)
        # the model's own block bytes are what one block costs this
        # device (1/tp of the whole under tensor parallelism), so
        # kv_pool_mb is a per-device budget; pool_stats reports whole
        # blocks
        per_dev = pool_bytes_per_block(model, self.block_size, kv_dtype)
        if pool_blocks is None and kv_pool_mb is not None:
            pool_blocks = max(2, int(kv_pool_mb * 2 ** 20) // per_dev)
        budget = prefix_cache_budget_bytes() if prefix_cache_bytes is None \
            else max(0, int(prefix_cache_bytes))
        self.tables = np.zeros((self.num_slots, self.max_blocks),
                               np.int32)  # 0 = trash block
        # Radix entries are pool blocks, not byte payloads: the MB knob
        # only gates sharing on/off here (the pool itself is the budget,
        # reclaimed LRU-first when allocation runs short).
        self.mgr = PagedBlockManager(
            self.num_slots, self.max_len, self.block_size, pool_blocks,
            radix=budget > 0,
            on_table=self._set_table, copy_block=self._copy_block)
        self.pool_blocks = self.mgr.pool_blocks
        scale_per_blk = sum(
            math.prod(shape) * dt.itemsize
            for shape, dt in L.paged_pool_spec(model, 1, self.block_size,
                                               kv_dtype)
            if len(shape) == 3)
        tp = self.tp_degree
        self.mgr.info = {
            "kv_dtype": kv_dtype or "float",
            "kv_block_bytes": per_dev * tp,
            "kv_block_bytes_f32": pool_bytes_per_block(
                model, self.block_size) * tp,
            "kv_scale_bytes_per_block": scale_per_blk * tp,
            "effective_blocks": self.pool_blocks,
        }
        self.graphs = CompileCache()
        self._cache_gen = 0  # which cache the graphs' keys name
        self.cache = self._make_cache()
        self.allocator = self.mgr.allocator
        self.radix = self.mgr.radix
        self._tokens = np.zeros(self.num_slots, np.int32)
        self._cur = np.zeros(self.num_slots, np.int32)
        self._pads = np.zeros(self.num_slots, np.int32)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.prefix_cache = None  # the byte-payload LRU does not apply
        self._warned_commit = False

    def _make_cache(self):
        self.graphs.drop()  # they point into the pool being replaced
        self._cache_gen += 1
        return L.init_paged_pool(self.model, self.pool_blocks,
                                 self.block_size, kv_quant=self.kv_dtype)

    # -- allocation plumbing (policy lives in PagedBlockManager) ----------
    def _set_table(self, slot: int, idx: int, block: int) -> None:
        self.tables[slot, idx] = block

    def _tables(self, slot: int | None = None) -> torch.Tensor:
        """The block tables (or one slot's row) on the device, checked on
        the host first: the kernel reads the pool rows they name without
        a bounds check of its own."""
        t = self.tables if slot is None else self.tables[slot]
        if t.min() < 0 or t.max() >= self.pool_blocks:
            raise ValueError(f"block table names a block outside the pool "
                             f"[0, {self.pool_blocks}): {t.min()}..{t.max()}")
        return self._dev(t)

    def _copy_block(self, src: int, dst: int) -> None:
        GLOBAL_COMPILE_CACHE.note("serve_pool_cow",
                                  _sig(*self.cache.tensors()))
        self._guarded(L.copy_pool_block, self.cache, int(src), int(dst))

    def can_reserve(self, n: int) -> bool:
        return self.mgr.can_reserve(n)

    def ensure_block_for(self, slot: int, pos: int) -> bool:
        return self.mgr.ensure_block_for(slot, pos)

    def drain_alloc_samples(self) -> list[float]:
        return self.mgr.drain_alloc_samples()

    def pool_stats(self) -> dict:
        return self.mgr.pool_stats()

    def prefix_stats(self) -> dict | None:
        return self.mgr.prefix_stats()

    # -- engine protocol --------------------------------------------------
    def prefill(self, slot: int, prompt, bucket: int) -> int:
        """Blocking whole-prompt refill through the table. The left-padded
        layout is not zero-aligned, so the blocking path never radix-
        shares — it still pages (bucket + 1 decode block allocated, the
        rest grows on demand)."""
        if bucket > self.max_len:
            raise ValueError(f"bucket {bucket} > max_len {self.max_len}")
        self.mgr.reserve_bucket(slot, bucket)
        ids, pad = L.left_pad_prompts([list(prompt)], pad_to=bucket)
        ids, pad = ids.to(self.device), pad.to(self.device)
        row = self._tables(slot)
        GLOBAL_COMPILE_CACHE.note(
            "serve_prefill",
            (_sig(ids, pad, row), _sig(*self.cache.tensors()),
             self.temperature, self.top_k, self.top_p))
        tok = self._guarded(L.paged_prefill_into_slot, self.model, ids, pad,
                            self.cache, row, self._gen, **self._sampling())
        tok = int(tok[0])
        self._tokens[slot] = tok
        self._cur[slot] = bucket
        self._pads[slot] = int(pad[0])
        return tok

    def begin_prefill(self, slot: int, prompt, chunk: int) -> int:
        """Arm a chunked (zero-aligned) prefill: radix-graft the longest
        cached full-block head (table pointers + refcounts, no copy),
        then allocate private blocks covering the chunk-aligned
        remainder + one decode block. Raises
        :class:`serving.paging.BlockExhausted` when the pool cannot
        cover it (graft refs rolled back) — the engine requeues the
        request and waits."""
        self._pads[slot] = 0
        self._tokens[slot] = 0
        self._cur[slot] = 0
        reuse = self.mgr.reserve_prompt(slot, prompt, chunk)
        self._cur[slot] = reuse  # frontier: tail chunks start here
        return reuse

    def prefill_chunk(self, slot: int, chunk, offset: int,
                      n_valid: int, window: int | None = None) -> int:
        ids = self._dev(np.asarray(chunk, np.int64)[None, :], torch.int64)
        # window is NOT clamped to max_len: a resume's chunk-aligned plan
        # can overhang the slot row, and the paged primitive pads the
        # attention view with scratch rows past the table instead of
        # sliding the chunk's write back over committed rows. Cap only
        # against a runaway caller.
        window = self.max_len if window is None \
            else min(int(window), self.max_len + len(chunk))
        row = self._tables(slot)
        wb = -(-window // self.block_size)
        GLOBAL_COMPILE_CACHE.note(
            "serve_prefill_chunk",
            (_sig(ids, row), _sig(*self.cache.tensors()), wb,
             self.temperature, self.top_k, self.top_p))
        tok = self._guarded(L.paged_prefill_chunk_into_slot, self.model, ids,
                            self.cache, row, int(offset), int(n_valid),
                            self._gen, window=wb * self.block_size,
                            **self._sampling())
        self._cur[slot] = offset + len(chunk)
        return int(tok[0])

    def finish_prefill(self, slot: int, prompt, last_tok: int,
                       aligned_len: int, commit: bool = True) -> int:
        """Complete a chunked prefill. The radix commit is ZERO-COPY —
        the prompt's full blocks are already in the pool, the trie just
        takes a reference on each — so commit whenever sharing is on."""
        self._tokens[slot] = int(last_tok)
        self._cur[slot] = len(prompt)
        self._pads[slot] = 0
        if commit:
            try:
                chaos_lib.fire("serve_commit", batch=slot)
                self.mgr.commit(slot, prompt)
            except Exception as e:  # noqa: BLE001 — caching is an
                # optimization, never fatal — UNLESS serving-fatal
                # (injected cache_lost / SlotCacheLost): fail over.
                if getattr(e, "serving_fatal", False):
                    raise
                if not self._warned_commit:
                    self._warned_commit = True
                    log.warning("radix commit failed (%s: %s); "
                                "suppressing further warnings",
                                type(e).__name__, e)
        return int(last_tok)

    def _decode_logits(self, tok, cur, pads, tables):
        return L.paged_slot_decode_logits(self.model, self.cache, tables,
                                          tok, cur, pads)

    def step(self, active_slots) -> list[int]:
        tok, cur, pads = self._step_operands()
        tables = self._tables()
        sig = (_sig(tok, cur, pads, tables), _sig(*self.cache.tensors()))
        GLOBAL_COMPILE_CACHE.note(
            "serve_decode_step",
            (*sig, self.temperature, self.top_k, self.top_p))
        nxt = self._replay(sig, self._decode_logits,
                           (tok, cur, pads, tables))
        return self._advance(active_slots, nxt)

    def verify(self, active_slots, drafts, k: int) -> list[list[int]]:
        """Paged speculative verify window
        (``models.llama.paged_slot_verify_step``): the k+1 writes go
        through each slot's block table — the engine allocated the draft
        window's growth blocks up front (``ensure_block_for`` per draft
        position), and positions past a slot's table route to the trash
        block. Frontier state advances only via :meth:`commit_spec`."""
        self._check_greedy()
        tok = self._verify_tokens(drafts, k)
        _, cur, pads = self._step_operands()
        tables = self._tables()
        GLOBAL_COMPILE_CACHE.note(
            "serve_verify_step",
            (_sig(tok, cur, pads, tables), _sig(*self.cache.tensors())))
        props = self._guarded(L.paged_slot_verify_step, self.model,
                              self.cache, tables, tok, cur, pads)
        return props.cpu().numpy().astype(np.int32).tolist()

    def release(self, slot: int):
        """Retire/evict/quarantine hook: drop every table reference
        (blocks return to the free list at refcount 0 — radix-cached ones
        stay resident on the trie's reference) and park the table on the
        trash block."""
        self.mgr.release(slot)
        self._cur[slot] = 0
        self._pads[slot] = 0
        self._tokens[slot] = 0

    def rebuild(self):
        """Failover hook: fresh pool, fresh block manager — allocator
        free list, radix trie and every table reference start from zero;
        the static pool facts (``mgr.info``) carry over."""
        info = self.mgr.info
        radix_on = self.mgr.radix is not None
        self.tables[:] = 0  # every row parks on the trash block
        self.mgr = PagedBlockManager(
            self.num_slots, self.max_len, self.block_size,
            self.pool_blocks, radix=radix_on,
            on_table=self._set_table, copy_block=self._copy_block)
        self.mgr.info = info
        self.allocator = self.mgr.allocator
        self.radix = self.mgr.radix
        self.cache = None  # release the old pool before the new one
        self.cache = self._make_cache()
        self._tokens[:] = 0
        self._cur[:] = 0
        self._pads[:] = 0
        self._warned_commit = False


# ---------------------------------------------------------------------------
# Tensor-parallel slot backends: one engine over a {"tp": n} group
# ---------------------------------------------------------------------------

def tp_mesh(tp: int):
    """The ``{"tp": tp}`` mesh of this rank's engine group: ``tp``
    consecutive ranks of the ``torch.distributed`` gang, rank r in group
    ``r // tp`` (one process a device, rank r on ``cuda:r``, so the rank
    fixes its group and no placement knob is needed). Every rank of the
    gang must call it, in the same order as any other collective: the
    gang is cut into ``world // tp`` groups (``core.runtime.make_mesh(
    {"replica": world // tp, "tp": tp})``), and each rank takes its
    own."""
    import torch.distributed as dist

    from ..core.runtime import make_mesh

    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh({"tp": tp})  # raises: no gang
    world = dist.get_world_size()
    if world % tp:
        raise ValueError(f"tp={tp} does not divide the gang's {world} "
                         f"ranks into engine groups (SPARKDL_SERVE_TP)")
    return make_mesh({"replica": world // tp, "tp": tp})["tp"]


def _tp_setup(self, model, tp: int, mesh, weight_dtype):
    """The tensor-parallel delta over the base backends, run before their
    ``__init__``: check the heads split (``parallel.sharding
    .serving_tp_layout``), take or make the mesh (its extent must be
    ``tp``), quantize the GLOBAL model when asked (a row-parallel shard
    holds part of each scale's row, so scales come from the whole), and
    return this rank's shard (``models.llama.shard_model``: dense
    prefill, the head-sharded decode dispatch). The base ``__init__`` then
    runs on the shard unchanged: its cache or pool holds the rank's
    ``kv_heads``, its generator is seeded alike on every rank. Beside the
    mesh it takes the group's control channel (``serving.group
    .control_group``, a gloo group over the mesh's ranks), over which a
    started engine's front sends its messages."""
    from ..parallel.sharding import serving_tp_layout
    from .group import control_group
    self.layout = serving_tp_layout(tp, model.cfg)
    self.mesh = mesh if mesh is not None else tp_mesh(tp)
    if self.mesh.size() != tp:
        raise ValueError(f"tp={tp} disagrees with the mesh's "
                         f"{self.mesh.size()} rank(s)")
    self.control = control_group(self.mesh)
    self.tp_degree = int(tp)
    if weight_dtype is not None:
        L.quantize_params(model, weight_dtype)
    return L.shard_model(model, self.mesh)


def _group_clock(self, t: float) -> float:
    """The group's clock for one engine iteration driven inline: rank 0's
    reading ``t``, broadcast to every rank of the tp group, so the
    scheduler's deadline decisions agree on every rank
    (``GenerationEngine.step`` calls it once a step; a started engine's
    front carries the reading in its message instead)."""
    import torch.distributed as dist
    g = self.mesh.get_group("tp")
    x = torch.tensor([t], dtype=torch.float64,
                     device=self.mesh.device_type)
    dist.broadcast(x, src=dist.get_global_rank(g, 0), group=g)
    return float(x.item())


class TensorParallelLlamaSlotBackend(LlamaSlotBackend):
    """Head-sharded :class:`LlamaSlotBackend` over a ``{"tp": n}`` mesh
    (module doc): slot cache rows ``[slots, Hkv/n, max_len, hd]``, per-rank
    cache bytes ``1/n`` of the whole (:meth:`kv_pool_device_bytes`). The
    S = 1 step, its NCCL all-reduces and gathers included, is captured
    into the backend's CUDA graph and replayed like the base backend's
    (captured on the H100 with NCCL 2.27 at one rank: ``chip_smoke.py``
    phase u); prefill chunks and verify windows issue them eagerly."""

    def __init__(self, model, num_slots: int, max_len: int, *, tp: int,
                 mesh=None, weight_dtype: str | None = None, **kw):
        local = _tp_setup(self, model, tp, mesh, weight_dtype)
        super().__init__(local, num_slots, max_len,
                         weight_dtype=weight_dtype, **kw)

    group_clock = _group_clock


class TensorParallelPagedLlamaSlotBackend(PagedLlamaSlotBackend):
    """Head-sharded :class:`PagedLlamaSlotBackend`: every pool block
    ``[Hkv/n, block_size, hd]`` (and a quantized pool's scale plane
    ``[Hkv/n, 2]``) holds this rank's heads, block ids stay logical, and
    ``kv_pool_mb`` is a per-device budget — the same figure buys n times
    the blocks of the one-device backend. The S = 1 step is captured into
    the backend's CUDA graph with its collectives, as in
    :class:`TensorParallelLlamaSlotBackend`."""

    def __init__(self, model, num_slots: int, max_len: int, *, tp: int,
                 mesh=None, weight_dtype: str | None = None, **kw):
        local = _tp_setup(self, model, tp, mesh, weight_dtype)
        super().__init__(local, num_slots, max_len,
                         weight_dtype=weight_dtype, **kw)

    group_clock = _group_clock
