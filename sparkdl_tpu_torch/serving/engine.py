"""Continuous-batching generation engine — in-flight batching over the
slotted KV cache.

The port's copy of ``sparkdl_tpu/serving/engine.py``: the same
scheduler; :meth:`GenerationEngine.from_model` builds the port's torch
backends on a ``device``, the tensor-parallel ones over a ``{"tp": n}``
group of a ``torch.distributed`` gang (one process a device). Driven
inline, every rank of such a group makes the same engine calls with the
same arguments, and the scheduler decides alike on each: the one clock
it reads for deadlines is the group's rank 0's, broadcast once an
iteration (:meth:`GenerationEngine.step`) and at each
:meth:`GenerationEngine.submit` that sets a deadline, whose limit runs
from that reading. Started (:meth:`GenerationEngine.start`), the group's
rank 0 is its front (``serving.group``): it takes requests from any
thread and sends every rank each iteration's admissions, cancels, stop
and clock in one message over the group's control channel.

The static ``models.llama.generate`` path is batch-job shaped: every row
of a batch prefills together, decodes in lockstep, and a new request
waits for the whole batch to drain. This module is the request-level
tier on top of the same two compiled programs' *slot* variants
(``models.llama.prefill_into_slot`` / ``slot_decode_step``): a request
queue with admission control feeds a fixed table of ``num_slots`` cache
slots, each independently holding one in-flight request. Every engine
iteration:

1. finished slots (EOS / max-tokens) are **retired** and their requests
   completed;
2. free slots are **admitted** from the queue and their prompts
   consumed — stall-free by default (``SPARKDL_SERVE_STALL_FREE=1``):
   at most ONE fixed-size chunk (``SPARKDL_SERVE_PREFILL_CHUNK``
   tokens) of at most one PREFILLING slot runs per iteration,
   interleaved with everyone else's decode, so a long prompt never
   preempts the decode batch for a whole O(L²) prefill (the blocking
   whole-prompt refill is the ``=0`` fallback); prompts that share a
   cached prefix copy those K/V rows device-side and chunk-prefill only
   the tail (``serving.prefix.PrefixCache``,
   ``SPARKDL_SERVE_PREFIX_CACHE_MB``);
3. one **decode step** advances every RUNNING slot one token at its own
   fill index — compiled once per (num_slots, max_len), never re-traced
   by refills or mid-prefill neighbors, so the batch never drains and
   aggregate tokens/s is bounded by compute, not by the longest request
   in a batch. ``serve_decode_stall`` accounting (engine stats,
   telemetry counter + histogram, and a flight-recorder span) records
   exactly how much wall time RUNNING
   slots spent not decoding while prefill work ran.

**Paged KV.** A backend with ``paged = True`` (the block-
table backends over one shared K/V pool) changes three scheduler
rules: admission additionally requires the pool to cover the prompt's
blocks + one decode block (a queue head it cannot cover WAITS, FIFO —
``admission_block_waits``); decode growth allocates blocks lazily at
each slot's write frontier, and a slot the pool cannot serve sits the
iteration out (``block_stall_events``) — only when EVERY running slot
stalls is the newest request preempted (released + requeued to resume
as ``prompt + tokens-so-far``; greedy output unchanged, nothing
re-emitted); and the per-iteration prefill pacing generalizes from one
chunk to a TOKEN budget (``SPARKDL_SERVE_PREFILL_BUDGET``) spent
round-robin oldest-first across every PREFILLING slot, so one
iteration can complete several refills — the admission-rate unlock
high-churn mixes need. Exhaustion is always backpressure:
``RequestRejected`` fires only for requests that can NEVER fit.

**Speculative decoding.** ``SPARKDL_SERVE_SPEC_K`` > 0
replaces each decode iteration with draft → verify → commit: a
jax-free ``serving.draft`` provider proposes up to k candidate tokens
per RUNNING slot (n-gram prompt-lookup by default; REST-style
retrieval over completed requests; or a registry-paired draft model),
ONE batched verify dispatch (``backend.verify`` — the fourth
slot primitive) checks them all, and the engine commits the longest
draft prefix the target's greedy argmax agrees with plus the target's
own next token — always >= 1 token per slot per iteration, so
speculation can never emit below the k=0 baseline. Reject is a pure
frontier non-advance (misspeculated rows are garbage past the write
frontier — the chunked-prefill invariant), acceptance compares
argmaxes so the stream stays bit-identical to static ``generate()``
(greedy-only; sampling backends degrade to k=0 with a warning), and
k=0 is the EXACT pre-speculation engine.

Design split: this module is **jax-free** — the scheduler, queue, slot
table, request state machine, streaming callbacks, and failure policy
are all plain Python against a duck-typed backend (``prefill(slot,
prompt, bucket) -> first_token``, ``step(active_slots) -> tokens [num_
slots]``), so the whole scheduling layer unit-tests without a device
(``serving.paging`` — allocator, block manager, radix trie — is
jax-free too, and ``StubBackend`` mirrors the full paged protocol).
The torch half is ``serving.backend.LlamaSlotBackend`` (lazily imported
by :meth:`GenerationEngine.from_model`); :class:`StubBackend` here is
the deterministic device-free stand-in the scheduler tests ride.

Failure semantics (request-granular): a prompt that
fails admission is **rejected** synchronously (``RequestRejected`` /
``QueueFullError`` — backpressure, the caller owns retry); a request
whose prefill raises is retried ``SPARKDL_SERVE_RETRIES`` times and
then **quarantined** (request failed, engine keeps serving — the
poisoned request is evicted, not the gang); a decode-step failure is
retried, then the newest-admitted request (the state-change suspect) is
evicted and quarantined and the step retried again — down to an empty
slot table if need be, the engine staying alive for the queue (a
genuinely broken backend degrades per-request, each refill burning its
own retry budget, never gang-fatally). ``SPARKDL_SERVE_STALL_S`` arms a
wall-clock watchdog on every backend call — a wedged device surfaces as
a classified ``ServingStallError`` instead of an eternal hang.

**Failover.** A serving-fatal error (``SlotCacheLost`` — a
slot call failed on the device — or a stall-watchdog fire) no longer kills the engine: every live request is
snapshotted host-side (prompt + tokens-so-far, all already jax-free
``Request`` state), the backend is torn down and rebuilt
(``backend.rebuild()`` — fresh slot cache / paged pool / prefix trie),
and the snapshots re-admit through the preemption-resume path with
exactly-once delivery: streamed tokens are never re-emitted (the
per-request ``delivered`` cursor survives the failover) and greedy
output is bit-identical to an uninterrupted run. Zero-progress
failovers in a row are bounded by ``SPARKDL_SERVE_FAILOVER_BUDGET``
(exponential backoff via ``SPARKDL_SERVE_FAILOVER_BACKOFF_S``); past
the engine budget the engine fails closed with the original cause, and
a single request that personally survives ``budget`` failovers without
gaining a token is quarantined individually instead of blocking the
fleet. Requests also carry **deadlines** (``deadline_s`` on
``submit()``, default ``SPARKDL_SERVE_DEADLINE_S``) and support
**cancellation** (``Request.cancel()``): both are honored at the next
iteration boundary — during prefill, decode, or mid-verify-window —
freeing the slot and its KV blocks (no radix entry is ever committed
for an aborted prefill). ``engine.drain()`` is the graceful-handoff
primitive: stop admission, preempt live requests into resumable
snapshots, and return them (``engine.resume(req)`` re-admits one); a
drain wedged past ``SPARKDL_SERVE_STALL_S`` degrades to
snapshot-and-stop instead of hanging the caller.

Observability: per-request ``serve_queue`` / ``serve_prefill`` /
``serve_decode`` spans through the flight recorder, and (when the
telemetry plane is armed) ``serving_queue_depth`` / ``serving_slots_
busy`` gauges, token/request counters, and request-latency + TTFT
histograms, whose percentiles :func:`runner.telemetry.histogram_quantile`
derives.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import threading
import time

from ..runner import chaos as chaos_lib
from ..runner import events, telemetry
from ..runner import sentinel as sentinel_lib
from .introspect import register_engine
from .paging import BlockExhausted

__all__ = [
    "GenerationEngine", "Request", "StubBackend", "bucket_length",
    "ServingError", "RequestRejected", "QueueFullError",
    "RequestQuarantined", "ServingStallError", "EngineStopped",
    "RequestCancelled", "DeadlineExceeded",
    "PREFILLING", "BlockExhausted", "REQUEST_SCOPED_EVENTS",
    "ENGINE_SCOPED_EVENTS",
]

log = logging.getLogger("sparkdl_tpu_torch.serving")

SLOTS_ENV = "SPARKDL_SERVE_SLOTS"
MAX_LEN_ENV = "SPARKDL_SERVE_MAX_LEN"
QUEUE_CAP_ENV = "SPARKDL_SERVE_QUEUE_CAP"
RETRIES_ENV = "SPARKDL_SERVE_RETRIES"
STALL_ENV = "SPARKDL_SERVE_STALL_S"
MIN_BUCKET_ENV = "SPARKDL_SERVE_MIN_BUCKET"
CHUNK_ENV = "SPARKDL_SERVE_PREFILL_CHUNK"
STALL_FREE_ENV = "SPARKDL_SERVE_STALL_FREE"
# Paged KV + multi-chunk prefill budgets. PREFILL_CHUNK
# stays the per-CHUNK size (one backend call's token count);
# PREFILL_BUDGET owns admission pacing: tokens of prefill work per
# engine iteration, spread round-robin (oldest admitted first) across
# every PREFILLING slot. Default = one chunk.
PREFILL_BUDGET_ENV = "SPARKDL_SERVE_PREFILL_BUDGET"
BLOCK_SIZE_ENV = "SPARKDL_SERVE_BLOCK_SIZE"
KV_POOL_MB_ENV = "SPARKDL_SERVE_KV_POOL_MB"
# Speculative decoding. SPEC_K is the draft window: 0 (the
# default) disables speculation entirely — the plain decode
# path; k > 0 replaces each decode iteration with draft -> one batched
# verify -> greedy commit (always >= 1 token per slot per iteration).
# SPEC_DRAFT names the draft provider (serving.draft.make_provider).
SPEC_K_ENV = "SPARKDL_SERVE_SPEC_K"
# Tensor-parallel serving. TP is the number of ranks (one device each)
# one engine spans: 1 (the default) constructs the EXACT single-device
# backends (no mesh, no wrapper, zero overhead); > 1 selects the
# head-sharded TensorParallel* backends over a {"tp": n} group of
# consecutive gang ranks (rank r serves in group r // tp), while this
# scheduler stays unchanged.
TP_ENV = "SPARKDL_SERVE_TP"
# Quantized serving. KV_DTYPE selects the paged pool's K/V
# storage ("int8" / "fp8"): codes + a per-block [P, Hkv, 2] scale
# plane, dequantized inside the paged flash-decode kernel — no
# dequantized cache copy ever lands in HBM. Only meaningful with the
# paged backend (SPARKDL_SERVE_BLOCK_SIZE > 0); setting it without
# paging raises — a quantization request silently served at f32 is a
# 4x memory surprise. WEIGHT_DTYPE ("int8") quantizes the Megatron-
# sharded projection matmuls (absmax per-output-channel scales,
# dequant folded after the int8 dot); works on paged and un-paged,
# tp or single-device backends alike.
KV_DTYPE_ENV = "SPARKDL_SERVE_KV_DTYPE"
WEIGHT_DTYPE_ENV = "SPARKDL_SERVE_WEIGHT_DTYPE"
# Serving survivability. FAILOVER_BUDGET bounds CONSECUTIVE
# zero-progress failovers (any token emitted engine-wide resets the
# streak — supervise()'s restart-budget rule); past it the engine fails
# closed with the original cause. FAILOVER_BACKOFF_S is the base of the
# exponential sleep before each rebuild (0 = none, the test/CI
# default). DEADLINE_S is the default per-request deadline applied at
# submit() when the caller passes none (0/unset = no deadline).
FAILOVER_BUDGET_ENV = "SPARKDL_SERVE_FAILOVER_BUDGET"
FAILOVER_BACKOFF_ENV = "SPARKDL_SERVE_FAILOVER_BACKOFF_S"
DEADLINE_ENV = "SPARKDL_SERVE_DEADLINE_S"
# The JAX package's per-rank device-offset knob (its launcher's
# placement; torch's form needs none, rank r serves in group r // tp):
# scrubbed with the serving knobs.
TP_OFFSET_ENV = "SPARKDL_TP_DEVICE_OFFSET"

_DEFAULT_SLOTS = 8
_DEFAULT_MAX_LEN = 2048
_DEFAULT_QUEUE_CAP = 128
_DEFAULT_RETRIES = 1
_DEFAULT_MIN_BUCKET = 16
_DEFAULT_CHUNK = 32
_DEFAULT_FAILOVER_BUDGET = 3
# Block-allocation-latency-shaped bounds (seconds): a free-list pop is
# microseconds; radix-eviction reclaims and CoW copies push into the
# ms range — the histogram's job is to show when allocation stops
# being free.
_ALLOC_BUCKETS = (1e-5, 5e-5, 2e-4, 1e-3, 5e-3, 0.02, 0.1, 0.5)

# Request-latency-shaped histogram bounds (seconds). The telemetry
# default buckets top out at 10s (span-duration-shaped) — a long-tail
# generation easily waits + decodes past that, and the quantile helper
# clamps +Inf-bucket ranks to the last finite bound, which would
# silently saturate the bench's p95/p99 at 10.0.
_LATENCY_BUCKETS = (0.005, 0.02, 0.05, 0.1, 0.15, 0.25, 0.35, 0.5,
                    0.75, 1.0, 1.5, 2.5, 5.0, 10.0, 30.0, 60.0, 180.0,
                    600.0)
# Decode-stall-shaped bounds: one stall event is one prefill (chunk or
# whole prompt) that ran while RUNNING slots waited — sub-ms on a stub,
# tens of ms per chunk on a real model, whole-prompt seconds on the
# blocking path. The histogram's job is exactly to show that shape
# difference between SPARKDL_SERVE_STALL_FREE=1 and =0.
_STALL_BUCKETS = (0.0005, 0.002, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5,
                  1.0, 2.5, 10.0)


def _env_num(name: str, default, cast=int):
    try:
        return cast(os.environ[name])
    except (KeyError, ValueError):
        return default


def scrub_serving_env(env: dict | None = None) -> dict:
    """Remove every serving knob (``SPARKDL_SERVE_*`` plus
    ``SPARKDL_TP_DEVICE_OFFSET``) from ``env`` — default the process
    environment — returning the removed entries so a caller can
    restore them. The ONE implementation of evidence hygiene for the
    tp bench leg, the MULTICHIP record script and the dryrun leg: an
    ambient ``SPARKDL_SERVE_KV_POOL_MB`` (a per-DEVICE budget) would
    size every tp degree's pool to ~equal device bytes and silently
    invert their 1/tp observable, and STALL_FREE/SPEC/PREFIX overrides
    would change which composition actually ran."""
    target = os.environ if env is None else env
    removed = {}
    for k in list(target):
        if k.startswith("SPARKDL_SERVE_") or k == TP_OFFSET_ENV:
            removed[k] = target.pop(k)
    return removed


class ServingError(RuntimeError):
    """Base class for serving-tier failures."""


class RequestRejected(ServingError):
    """Admission control refused the request (invalid prompt, or the
    bucketed prompt + max_new_tokens cannot fit the slot cache)."""


class QueueFullError(ServingError):
    """Backpressure: the request queue is at capacity and the caller
    asked not to (or timed out waiting to) block."""


class RequestQuarantined(ServingError):
    """The request failed ``retries + 1`` attempts and was evicted; the
    engine keeps serving the other requests."""


class ServingStallError(ServingError):
    """A backend call exceeded ``SPARKDL_SERVE_STALL_S`` wall seconds."""


class EngineStopped(ServingError):
    """The engine stopped (or died) before this request completed."""


class RequestCancelled(ServingError):
    """The client cancelled the request (``Request.cancel()``); its
    slot and KV blocks were freed at the next iteration boundary."""


class DeadlineExceeded(ServingError):
    """The request's deadline (``deadline_s`` at submit, or the
    ``SPARKDL_SERVE_DEADLINE_S`` default) passed before completion."""


class SnapshotIncompatibleError(ServingError):
    """A resume snapshot failed validation (unknown version, missing
    fields, or an inconsistent delivery cursor) — rejected BEFORE it
    can corrupt a slot. Fatal by taxonomy: replaying it elsewhere
    reproduces the same rejection."""


# Version tag on resume snapshots: bump when the snapshot
# shape changes so a stale/foreign snapshot raises
# :class:`SnapshotIncompatibleError` instead of corrupting a slot.
SNAPSHOT_VERSION = 1

# Request ids are unique in the process, not per engine: the telemetry
# plane's trace collector and the flight recorder key a request by its
# id alone, and a fleet runs several engines in one process (the JAX
# package numbers each engine's requests from 0, and its collector folds
# two replicas' request 0 into one trace).
_REQUEST_IDS = itertools.count()


def bucket_length(prompt_len: int, min_bucket: int = _DEFAULT_MIN_BUCKET
                  ) -> int:
    """Prefill bucket for a prompt: the next power of two >=
    max(prompt_len, min_bucket). Every distinct bucket is one compiled
    prefill program, so the program count is bounded by
    log2(max_len / min_bucket) + 1 — a mixed-length request stream
    compiles a handful of prefills and then never re-traces."""
    if prompt_len < 1:
        raise ValueError("prompt must hold at least one token")
    b = max(1, min_bucket)
    while b < prompt_len:
        b <<= 1
    return b


# Every serve_* span/event the engine emits is classified here (ISSUE
# 13): REQUEST-scoped emissions carry ``request=<id>`` — the trace
# collector folds them into per-request records and SILENTLY degrades
# for any that drop the attribution, so a drift-guard test pins that
# (a) any serve_* name the engine emits appears in exactly one of
# these sets and (b) every REQUEST-scoped record carries ``request=``.
# ENGINE-scoped emissions describe the engine as a whole (a rejection
# happens before a Request exists; a step retry is not attributable to
# one request until eviction names a suspect; stall/draft spans cover
# all slots of an iteration).
REQUEST_SCOPED_EVENTS = frozenset({
    "serve_queue", "serve_prefill", "serve_decode",
    "serve_prefill_retry", "serve_prefill_chunk_retry",
    "serve_reserve_retry", "serve_prefix_seed_failed",
    "serve_request_quarantined", "serve_request_preempted",
    "serve_admission_block_wait", "serve_request",
    "serve_request_failover", "serve_request_cancelled",
    "serve_request_detached",
})
ENGINE_SCOPED_EVENTS = frozenset({
    "serve_reject", "serve_step_retry", "serve_decode_stall",
    "serve_draft", "serve_engine_fatal", "serve_engine_failover",
    "serve_engine_drain",
})


def _req_trace(req: "Request") -> dict:
    """Causal-trace kwargs for a request-scoped emission:
    parent it under the request's admission (``serve_request``) span so
    the whole lifecycle — queue wait, prefill chunks, preemptions, the
    final decode span — chains to one node under the run root. {} when
    tracing is off, keeping untraced streams byte-identical."""
    sid = getattr(req, "span_id", None)
    return {"parent_id": sid} if sid else {}

# Request lifecycle states (plain strings — they serialize into events
# and stats as-is). PREFILLING is the stall-free scheduler's state: the
# request owns a slot and its prompt is being consumed chunk by chunk,
# interleaved with the other slots' decode steps.
QUEUED = "queued"
PREFILLING = "prefilling"
RUNNING = "running"
DONE = "done"
FAILED = "failed"


class Request:
    """One in-flight generation request: the handle ``submit`` returns.

    ``tokens`` grows as the engine emits (``stream_cb(request, token)``
    fires per token, in emission order, from the engine thread);
    ``result()`` blocks until retirement and returns the generated
    tokens (prompt excluded; the EOS token, when hit, is included —
    exactly ``generate()``'s contract).
    """

    def __init__(self, rid: int, prompt, max_new_tokens: int, bucket: int,
                 stream_cb=None):
        self.id = rid
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.bucket = bucket
        self.stream_cb = stream_cb
        self.tokens: list[int] = []
        self.state = QUEUED
        self.finish_reason: str | None = None   # eos | length | error
        self.error: BaseException | None = None
        self.failures = 0
        self.slot: int | None = None
        self.t_submit = time.time()
        self.t_admit: float | None = None
        self.t_first_token: float | None = None
        self.t_done: float | None = None
        # chunked (stall-free) prefill plan — filled at admission
        self.chunk_plan: list | None = None  # [(tokens[C], n_valid), ...]
        self.chunk_base = 0       # cache offset of chunk 0 (prefix reuse)
        self.next_chunk = 0       # committed chunks resume from here
        self.prefill_reused = 0   # prefix-cache tokens skipped
        self.prefill_spent_s = 0.0
        # paged mode: the slot's write frontier (next decode write
        # position — drives lazy block growth), preemption count, and
        # the length actually prefilled (prompt + already-generated
        # tokens after a preemption resume)
        self.write_pos = 0
        self.preemptions = 0
        self.served_len = len(self.prompt)
        self._block_stalled = False
        # Survivability: the exactly-once delivery cursor
        # (== len(tokens); host-side, so it survives a backend rebuild
        # — the failover audit's ground truth), consecutive failovers
        # this request survived WITHOUT gaining a token (progress
        # resets it; past the engine budget the request is quarantined
        # individually), and the deadline/cancel flags the engine
        # honors at the next iteration boundary.
        self.delivered = 0
        self.failovers = 0
        self._len_at_failover: int | None = None
        self.t_deadline: float | None = None
        self._cancel = False
        # request-scoped phase ledger: the trace collector
        # reads these off the serve_decode span at retirement —
        # t_enqueue starts the CURRENT queued stint (reset on requeue,
        # so a preempted request's serve_queue spans each measure their
        # own wait instead of everything since submit)
        self.t_enqueue = self.t_submit
        self.draft_s = 0.0
        self.block_stall_s = 0.0
        self.spec_windows = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self._block_stall_t0: float | None = None
        # Trace context: the admission span this request's
        # serve_* emissions parent under. Minted at submit time on the
        # CALLER's thread, so the captured parent is the submitter's
        # enclosing span (or the env-shipped gang-attempt span) — the
        # engine loop's ambient context would be wrong for every request
        # but the one it is currently stepping.
        self.span_id: str | None = None
        self.parent_span: str | None = None
        if events.trace_armed():
            self.span_id = events.new_span_id()
            self.parent_span = events.current_span_id()
        self._done = threading.Event()

    # -- caller-side API --------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self):
        """Ask the engine to abort this request (the client-disconnect
        primitive). Honored at the next iteration boundary — queued,
        PREFILLING, RUNNING, or mid-verify-window — freeing the slot
        and its KV blocks; ``result()`` then raises
        :class:`RequestCancelled`. Idempotent; a no-op once done."""
        self._cancel = True

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def snapshot(self) -> dict:
        """Self-contained, version-tagged resume state:
        everything a DIFFERENT engine needs to continue this request —
        prompt, emitted tokens, the exactly-once delivery cursor, and
        the generation params. Plain ints/lists, so it survives a
        process hop (a router's shadow state for an uncleanly dead
        replica is exactly this dict rebuilt host-side)."""
        return {
            "version": SNAPSHOT_VERSION,
            "id": self.id,
            "prompt": list(self.prompt),
            "tokens": list(self.tokens),
            "delivered": self.delivered,
            "max_new_tokens": self.max_new_tokens,
            "failovers": self.failovers,
        }

    def result(self, timeout: float | None = None) -> list[int]:
        """Generated token ids (prompt excluded). Raises the request's
        failure (``RequestQuarantined`` / ``EngineStopped`` / the
        backend error) when it did not complete."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not done after "
                               f"{timeout}s")
        if self.state != DONE:
            raise self.error if self.error is not None else \
                ServingError(f"request {self.id} ended in state "
                             f"{self.state}")
        return list(self.tokens)

    def __repr__(self):
        return (f"Request(id={self.id}, state={self.state}, "
                f"n_prompt={len(self.prompt)}, n_out={len(self.tokens)})")


class StubBackend:
    """Deterministic jax-free backend: scheduler tests and the
    backend-outage bench leg measure queue/slot mechanics (and raw
    scheduler throughput) without a device.

    Token stream per request: a fold over the SERVED sequence —
    ``v = sum(served) + len(served)`` after prefill, each emission
    ``tok = (seed + v·31) % vocab_size`` then ``v += tok + 1`` — so the
    stream is deterministic in the prompt alone AND resume-consistent:
    prefilling ``prompt + tokens-so-far`` (the preemption/failover
    resume) lands the chain on exactly the state an uninterrupted run
    would hold, so two runs of the same workload emit identical streams
    regardless of slot placement, chunking, prefix reuse, preemption or
    failover (the CPU llama tests carry the real equivalence proof).
    The mod-``vocab_size`` dynamics stay eventually periodic, so a
    small vocab still yields the repetitive, n-gram-predictable text
    the speculative legs ride. ``step_s``/``prefill_s``/``prefill_tok_s`` add
    synthetic per-call latency (bench shaping): a blocking prefill
    costs ``prefill_s + prefill_tok_s·bucket``, one chunk costs
    ``prefill_s + prefill_tok_s·C`` — per-token cost models the real
    O(tokens) device work, so prefix-cache reuse (fewer tail tokens)
    and bucket padding (blocking pads to the power-of-two bucket)
    show up in stub wall time exactly as they do on hardware.

    Mirrors the full chunked protocol (``begin_prefill`` /
    ``prefill_chunk`` / ``finish_prefill``) and the shared-prefix LRU
    (:class:`serving.prefix.PrefixCache` with synthetic
    ``prefix_bytes_per_token`` entry sizes) jax-free, so the scheduler
    logic — including hit/evict accounting — is tier-1-testable."""

    def __init__(self, num_slots: int, max_len: int, *,
                 vocab_size: int = 32000, step_s: float = 0.0,
                 prefill_s: float = 0.0, prefill_tok_s: float = 0.0,
                 seed: int = 0, prefix_cache_bytes: int | None = None,
                 prefix_bytes_per_token: int = 1024,
                 block_size: int | None = None,
                 pool_blocks: int | None = None,
                 spec_tok_s: float = 0.0):
        from .prefix import PrefixCache, prefix_cache_budget_bytes
        self.num_slots = num_slots
        self.max_len = max_len
        self.vocab_size = vocab_size
        self.step_s = step_s
        self.prefill_s = prefill_s
        self.prefill_tok_s = prefill_tok_s
        self.spec_tok_s = spec_tok_s
        self.seed = seed
        self.prefix_bytes_per_token = int(prefix_bytes_per_token)
        # (prompt_key, n_emitted, chain) — key is the served prompt's
        # sum+len (kept for test hooks), chain drives the token fold
        self._state = [(0, 0, 0)] * num_slots
        budget = prefix_cache_budget_bytes() if prefix_cache_bytes is None \
            else max(0, int(prefix_cache_bytes))
        # Paged mirror: block_size arms the SAME
        # PagedBlockManager the llama backend rides — slot block lists,
        # radix grafts, CoW and release bookkeeping are the one shared
        # implementation, only the K/V bytes are absent. The byte-
        # payload PrefixCache is replaced by the manager's radix trie.
        self.paged = bool(block_size)
        if self.paged:
            from .paging import PagedBlockManager
            self.mgr = PagedBlockManager(num_slots, max_len, block_size,
                                         pool_blocks, radix=budget > 0)
            self.block_size = self.mgr.block_size
            self.max_blocks = self.mgr.max_blocks
            self.max_len = self.mgr.max_len
            self.pool_blocks = self.mgr.pool_blocks
            self.allocator = self.mgr.allocator
            self.prefix_cache = None
        else:
            self.prefix_cache = PrefixCache(budget) if budget > 0 else None

    def _tok(self, key: int, n: int) -> int:
        """Emission hook: ``key`` is the fold-chain value at this
        position (== sum+len of everything served so far), ``n`` the
        emission index since the last prefill — the default ignores
        ``n`` so resumes (which reset it) stay stream-identical."""
        return (self.seed + key * 31) % self.vocab_size

    def _emit(self, slot: int):
        """Advance the slot's fold chain one token."""
        key, n, v = self._state[slot]
        tok = self._tok(v, n)
        self._state[slot] = (key, n + 1, v + tok + 1)
        return tok

    def prefill(self, slot: int, prompt, bucket: int) -> int:
        if self.paged:
            self.mgr.reserve_bucket(slot, bucket)  # BlockExhausted OK
        if self.prefill_s or self.prefill_tok_s:
            time.sleep(self.prefill_s + self.prefill_tok_s * bucket)
        key = sum(prompt) + len(prompt)
        self._state[slot] = (key, 0, key)
        return self._emit(slot)

    # -- chunked (stall-free) protocol, mirroring LlamaSlotBackend --------
    def begin_prefill(self, slot: int, prompt, chunk: int) -> int:
        from .prefix import usable_reuse
        self._state[slot] = (0, 0, 0)
        if self.paged:
            return self.mgr.reserve_prompt(slot, prompt, chunk)
        if self.prefix_cache is None:
            return 0
        key, n_cached, _payload = self.prefix_cache.lookup(prompt)
        reuse = usable_reuse(n_cached, len(prompt), chunk)
        if reuse <= 0:
            self.prefix_cache.note_miss()
            return 0
        self.prefix_cache.use(key, reuse)
        return reuse

    def prefill_chunk(self, slot: int, chunk_tokens, offset: int,
                      n_valid: int, window: int | None = None) -> int:
        if self.prefill_s or self.prefill_tok_s:
            time.sleep(self.prefill_s
                       + self.prefill_tok_s * len(chunk_tokens))
        return 0  # the engine reads the first token from finish_prefill

    def finish_prefill(self, slot: int, prompt, last_tok: int,
                       aligned_len: int, commit: bool = True) -> int:
        key = sum(prompt) + len(prompt)
        self._state[slot] = (key, 0, key)
        if commit:
            # Commit failures degrade (the entry just isn't cached) —
            # unless serving-fatal (injected cache_lost): that means
            # the slot state itself is gone and the engine must fail
            # over, exactly the llama backends' posture.
            try:
                chaos_lib.fire("serve_commit", batch=slot)
                if self.paged:
                    self.mgr.commit(slot, prompt)
                elif self.prefix_cache is not None:
                    self.prefix_cache.put(
                        tuple(prompt), tuple(prompt),
                        len(prompt) * self.prefix_bytes_per_token)
            except Exception as e:  # noqa: BLE001 — degrade, not fail
                if getattr(e, "serving_fatal", False):
                    raise
                log.warning("stub prefix commit failed (slot %s): %s",
                            slot, e)
        return self._emit(slot)

    def prefix_stats(self) -> dict | None:
        if self.paged:
            return self.mgr.prefix_stats()
        return None if self.prefix_cache is None else \
            self.prefix_cache.stats()

    # -- paged protocol (bookkeeping only — no K/V bytes) -----------------
    def can_reserve(self, n: int) -> bool:
        return self.mgr.can_reserve(n)

    def ensure_block_for(self, slot: int, pos: int) -> bool:
        return self.mgr.ensure_block_for(slot, pos)

    def pool_stats(self) -> dict:
        return self.mgr.pool_stats()

    def drain_alloc_samples(self) -> list[float]:
        return self.mgr.drain_alloc_samples()

    def release(self, slot: int):
        if self.paged:
            self.mgr.release(slot)
        self._state[slot] = (0, 0, 0)

    def rebuild(self):
        """Failover hook: discard every slot's chain state
        and rebuild the paged pool / prefix trie from scratch — the
        jax-free mirror of the llama backends' cache teardown."""
        self._state = [(0, 0, 0)] * self.num_slots
        if self.paged:
            from .paging import PagedBlockManager
            radix = self.mgr.radix is not None
            self.mgr = PagedBlockManager(self.num_slots, self.max_len,
                                         self.block_size,
                                         self.pool_blocks, radix=radix)
            self.allocator = self.mgr.allocator
        elif self.prefix_cache is not None:
            self.prefix_cache.clear()

    def step(self, active_slots) -> list[int]:
        if self.step_s:
            time.sleep(self.step_s)
        out = [0] * self.num_slots
        for s in active_slots:
            out[s] = self._emit(s)
        return out

    # -- speculative verify protocol, mirrored jax-free --------
    def verify(self, active_slots, drafts, k: int) -> list[list[int]]:
        """One verify window: proposal ``i`` of slot ``s`` is the token
        the stub's deterministic stream emits after ``i`` accepted
        drafts — position-determined, independent of the drafts
        themselves, exactly the greedy-target contract (a draft is
        accepted iff it equals the stream). Costs ONE step_s sleep
        (+ ``spec_tok_s`` per draft column — the marginal verify-width
        device time), so the k=0-vs-k speedup the bench measures is
        dispatch economics, the thing speculation actually buys."""
        if self.step_s or (self.spec_tok_s and k):
            time.sleep(self.step_s + self.spec_tok_s * k)
        out = [[0] * (k + 1) for _ in range(self.num_slots)]
        for s in active_slots:
            key, n, v = self._state[s]
            row = []
            for i in range(k + 1):
                tok = self._tok(v, n + i)
                row.append(tok)
                v += tok + 1
            out[s] = row
        return out

    def commit_spec(self, slot: int, n_tokens: int, last_tok: int):
        """Advance the slot's stream past ``n_tokens`` committed
        positions (reject = simply not advancing)."""
        for _ in range(int(n_tokens)):
            self._emit(slot)


class GenerationEngine:
    """Iteration-level scheduler over a slot backend (see module doc).

    Drive it inline (``step()`` / ``run_until_idle()`` — tests, batch
    drains) or as a background thread (``start()`` / ``stop()``, or the
    context manager). ``submit()`` is thread-safe and applies admission
    control synchronously.
    """

    def __init__(self, backend, *, eos_id: int | None = None,
                 queue_capacity: int | None = None,
                 retries: int | None = None,
                 stall_s: float | None = None,
                 min_bucket: int | None = None,
                 stall_free: bool | None = None,
                 prefill_chunk: int | None = None,
                 prefill_budget: int | None = None,
                 spec_k: int | None = None,
                 draft_provider=None,
                 failover_budget: int | None = None,
                 failover_backoff_s: float | None = None,
                 deadline_s: float | None = None):
        self.backend = backend
        self.eos_id = eos_id
        # Paged backend: admission additionally gates on KV-
        # pool blocks, decode growth allocates lazily, exhaustion
        # backpressures (the request waits) instead of crashing.
        self.paged = bool(getattr(backend, "paged", False))
        # Tensor-parallel degree + per-device KV-pool bytes:
        # both are engine-lifetime constants (the cache's shapes and
        # placement never change), so read them once here and export
        # them as gauges each iteration when the plane is armed.
        self.tp_degree = int(getattr(backend, "tp_degree", 1) or 1)
        kb = getattr(backend, "kv_pool_device_bytes", None)
        try:
            self.kv_pool_device_bytes = int(kb()) if callable(kb) else None
        except Exception:  # noqa: BLE001 — accounting, never fatal
            self.kv_pool_device_bytes = None
        # Stall-free scheduling (SPARKDL_SERVE_STALL_FREE, default on):
        # prompts are consumed in fixed-size chunks interleaved with the
        # decode step instead of blocking it for a whole O(L^2) prefill.
        # Requires the backend to speak the chunked protocol; otherwise
        # fall back to the blocking path with a warning.
        want_sf = (os.environ.get(STALL_FREE_ENV, "1").lower()
                   not in ("0", "false")) if stall_free is None \
            else bool(stall_free)
        self.stall_free = want_sf and hasattr(backend, "prefill_chunk")
        if want_sf and not self.stall_free:
            log.warning("backend %s lacks the chunked prefill protocol; "
                        "falling back to blocking refills",
                        type(backend).__name__)
        self.prefill_chunk = max(1, prefill_chunk
                                 if prefill_chunk is not None
                                 else _env_num(CHUNK_ENV, _DEFAULT_CHUNK))
        self.prefill_chunk = min(self.prefill_chunk, backend.max_len)
        if self.paged:
            # Radix grafts are whole blocks and chunk plans start at
            # chunk multiples: align the chunk to the block size so a
            # block-aligned reuse offset is always plan-legal.
            bs = int(backend.block_size)
            self.prefill_chunk = max(bs, (self.prefill_chunk // bs) * bs)
        # The per-iteration prefill TOKEN budget: how many
        # prompt tokens may be consumed per engine iteration, spread one
        # chunk at a time round-robin (oldest admitted first) over every
        # PREFILLING slot. Default = one chunk;
        # raising it lets one iteration refill several slots, removing
        # the ~1 admission/iteration cap high-churn mixes starve under.
        self.prefill_budget = max(
            self.prefill_chunk,
            prefill_budget if prefill_budget is not None
            else _env_num(PREFILL_BUDGET_ENV, self.prefill_chunk))
        # Floor 1: capacity 0 would make every blocking submit() spin
        # forever on `len(queue) >= 0` with no exit condition.
        self.queue_capacity = max(1, queue_capacity
                                  if queue_capacity is not None
                                  else _env_num(QUEUE_CAP_ENV,
                                                _DEFAULT_QUEUE_CAP))
        self.retries = max(0, retries if retries is not None
                           else _env_num(RETRIES_ENV, _DEFAULT_RETRIES))
        self.stall_s = stall_s if stall_s is not None \
            else _env_num(STALL_ENV, 0.0, float)
        self.min_bucket = min_bucket if min_bucket is not None \
            else _env_num(MIN_BUCKET_ENV, _DEFAULT_MIN_BUCKET)
        # Survivability knobs: see the env-constant comments.
        self.failover_budget = max(0, failover_budget
                                   if failover_budget is not None
                                   else _env_num(FAILOVER_BUDGET_ENV,
                                                 _DEFAULT_FAILOVER_BUDGET))
        self.failover_backoff_s = max(0.0, failover_backoff_s
                                      if failover_backoff_s is not None
                                      else _env_num(FAILOVER_BACKOFF_ENV,
                                                    0.0, float))
        self.default_deadline_s = max(0.0, deadline_s
                                      if deadline_s is not None
                                      else _env_num(DEADLINE_ENV, 0.0,
                                                    float))
        # Speculative decode: k = 0 (default) is the EXACT
        # plain decode path — no draft provider, no verify program, nothing
        # speculation-shaped runs. k > 0 requires the backend's verify
        # protocol AND greedy sampling (acceptance compares argmaxes;
        # a sampling engine silently degrading to different draws
        # would break the determinism contract, so it degrades to
        # k = 0 with a warning instead).
        self.spec_k = max(0, spec_k if spec_k is not None
                          else _env_num(SPEC_K_ENV, 0))
        self._draft = None
        if self.spec_k > 0:
            greedy = float(getattr(backend, "temperature", 0.0)
                           or 0.0) <= 0.0
            if not hasattr(backend, "verify"):
                log.warning("backend %s lacks the speculative verify "
                            "protocol; running without speculation",
                            type(backend).__name__)
                self.spec_k = 0
            elif not greedy:
                log.warning("speculative decode is greedy-only "
                            "(acceptance = argmax agreement); backend "
                            "samples at temperature > 0 — running "
                            "without speculation")
                self.spec_k = 0
            else:
                from .draft import make_provider
                self._draft = draft_provider if draft_provider \
                    is not None else make_provider()
        # k+1 accept-length buckets (1..k+1 emitted per verify window)
        self._spec_buckets = tuple(
            float(i) for i in range(1, self.spec_k + 2)) or None
        self._queue: collections.deque[Request] = collections.deque()
        self._slots: list[Request | None] = [None] * backend.num_slots
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._stop_mode: str | None = None  # None | "drain" | "now"
        self._fatal: BaseException | None = None
        self._watch_pool = None  # lazy ThreadPoolExecutor(1) when stall_s
        # Failover supervisor state: re-entrancy latch,
        # consecutive zero-progress streak, chaos/watchdog call counter,
        # the note the fail-closed EngineStopped carries, and the
        # operator-facing ledger introspect/snapshot expose.
        self._failing_over = False
        # Router-side liveness: stamped at every iteration
        # (and every idle wait) — a fleet router reads this to tell a
        # busy-but-advancing replica from a wedged one.
        self.t_heartbeat = time.time()
        self._failover_streak = 0
        self._tokens_at_failover = -1
        self._backend_calls = 0
        self._fatal_note: str | None = None
        self._awaiting_recovery = False
        self._t_fault: float | None = None
        self._failover_info: dict = {
            "state": "healthy", "count": 0, "streak": 0,
            "last_cause": None, "last_t": None, "resumed_total": 0,
            "quarantined_total": 0, "last_backoff_s": 0.0,
            "last_recovery_s": None,
        }
        self.stats = {
            "submitted": 0, "rejected": 0, "completed": 0,
            "quarantined": 0, "failed": 0, "tokens_out": 0, "steps": 0,
            "prefills": 0, "prefill_retries": 0, "step_retries": 0,
            "peak_queue_depth": 0, "peak_slots_busy": 0,
            "callback_errors": 0, "prefill_chunks": 0,
            "decode_stall_s": 0.0, "decode_stall_events": 0,
            # paged-mode ledger: iterations where the queue head waited
            # for pool blocks (admission backpressure), decode steps a
            # RUNNING slot sat out waiting for a growth block, and
            # preemptions (the deadlock-breaking requeue of the newest
            # request when EVERY running slot is block-stalled)
            "admission_block_waits": 0, "block_stall_events": 0,
            "preemptions": 0,
            # survivability ledger: engine failovers
            # survived, requests re-admitted / individually quarantined
            # across them, and deadline/cancel aborts (never counted
            # quarantined)
            "failovers": 0, "failover_resumed": 0,
            "failover_quarantined": 0, "cancelled": 0,
            # speculative-decode ledger: verify iterations,
            # draft tokens the target agreed with (each one a decode
            # dispatch saved) vs rejected (wasted draft+verify columns)
            "spec_verifies": 0, "spec_tokens_accepted": 0,
            "spec_tokens_rejected": 0,
        }
        # A tensor-parallel group's clock (backend.group_clock): rank
        # 0's reading, broadcast at each step() and at each submit() that
        # sets a deadline, is the one clock the deadline decisions read,
        # so every rank ends a request at the same step; None on one
        # device, where the wall clock is read.
        self._group_clock = getattr(backend, "group_clock", None)
        self._group_now = None
        # The group's front (serving.group.GroupFront), made when the
        # backend carries the group's control channel: it serves start(),
        # submit() from any thread of rank 0 and stop() across the group.
        self._front = None
        control = getattr(backend, "control", None)
        if control is not None:
            from .group import GroupFront
            self._front = GroupFront(self, control)
        # Live inspector: one weak-set add per engine BUILD
        # (never per token); introspect.serving_snapshot() reads
        # every registered engine via debug_state().
        register_engine(self)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_model(cls, model, variables=None, *,
                   num_slots: int | None = None,
                   max_len: int | None = None, temperature: float = 0.0,
                   top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                   eos_id: int | None = None,
                   prefix_cache_mb: float | None = None,
                   block_size: int | None = None,
                   pool_blocks: int | None = None,
                   kv_pool_mb: float | None = None,
                   tp: int | None = None, mesh=None,
                   kv_dtype: str | None = None,
                   weight_dtype: str | None = None,
                   device=None, **kw) -> "GenerationEngine":
        """Build an engine over the port's
        :class:`serving.backend.LlamaSlotBackend` (torch is imported
        here, not at module import). ``model`` is the port's
        ``models.llama.LlamaModel``, which holds its weights;
        ``variables``, when given, is a JAX-package parameter tree loaded
        into it (``load_flax_params``). ``device``: where the engine
        runs — None means ``cuda`` and raises without a CUDA device;
        pass ``device="cpu"`` to run on the CPU on purpose. The model
        must already lie there. ``prefix_cache_mb`` overrides
        ``SPARKDL_SERVE_PREFIX_CACHE_MB`` (0 disables shared-prefix KV
        reuse).

        ``block_size`` > 0 (or ``SPARKDL_SERVE_BLOCK_SIZE``) selects the
        PAGED backend: one shared K/V pool of ``pool_blocks`` blocks (or
        ``kv_pool_mb`` / ``SPARKDL_SERVE_KV_POOL_MB`` converted; default
        = the un-paged footprint) addressed through per-slot block
        tables, with block-granular radix prefix sharing instead of the
        copy-based LRU. ``kv_dtype`` ("int8"/"fp8", or
        ``SPARKDL_SERVE_KV_DTYPE``) block-quantizes that pool (paged
        only — raises otherwise). ``weight_dtype`` ("int8", or
        ``SPARKDL_SERVE_WEIGHT_DTYPE``) quantizes the model's projection
        weights IN PLACE to int8 codes with per-channel scales
        (``models.llama.quantize_params``); any other name raises
        ``ValueError``.

        ``tp`` > 1 (or ``SPARKDL_SERVE_TP``) spans the engine over a
        tensor-parallel group: every rank of the gang calls
        ``from_model`` with the same global model and arguments, and
        serves its shard of the heads, MLP columns and KV cache / pool
        (``serving.backend.TensorParallel*``); ``mesh`` supplies the
        ``{"tp": n}`` mesh, else ``serving.backend.tp_mesh`` cuts the
        gang into groups of ``tp`` consecutive ranks (outside a gang it
        raises ``make_mesh``'s ``ValueError``). A mesh with a defaulted
        ``tp`` serves at its extent; an explicit ``tp`` that disagrees
        with it raises. Without a mesh, tp <= 1 builds exactly the
        single-device classes; a passed mesh builds the tensor-parallel
        ones at its extent, one rank included (a group of one, started
        behind its front: a fleet's replica in a process of its own,
        ``serving.remote``). Paged + tp makes ``kv_pool_mb`` a
        per-device budget."""
        from ..models.llama import load_flax_params
        from ..utils.platform import resolve_device
        num_slots = num_slots if num_slots is not None \
            else _env_num(SLOTS_ENV, _DEFAULT_SLOTS)
        max_len = max_len if max_len is not None \
            else _env_num(MAX_LEN_ENV, _DEFAULT_MAX_LEN)
        block_size = block_size if block_size is not None \
            else _env_num(BLOCK_SIZE_ENV, 0)
        tp_explicit = tp is not None
        if tp is None:
            raw = os.environ.get(TP_ENV)
            if raw in (None, ""):
                tp = 1
            else:
                tp_explicit = True  # the operator pinned a degree
                try:
                    tp = int(raw)
                except ValueError:
                    raise ValueError(
                        f"{TP_ENV}={raw!r} is not an integer") from None
        if int(tp) < 0:
            # checked before the mesh: a negative tp beside a mesh must
            # not be overwritten by the mesh's extent
            raise ValueError(f"tp={tp} is negative (0/1 = single-device)")
        if mesh is not None:
            extent = int(mesh.size())
            if not tp_explicit:
                # a passed mesh IS the tensor-parallel request: serve at
                # its extent rather than drop it for one device
                tp = extent
            elif int(tp) != extent:
                raise ValueError(f"tp={tp} disagrees with the passed "
                                 f"mesh's {extent} rank(s)")
        if weight_dtype is None:
            weight_dtype = os.environ.get(WEIGHT_DTYPE_ENV) or None
        pbytes = None if prefix_cache_mb is None \
            else int(prefix_cache_mb * 2 ** 20)
        if kv_dtype is None:
            kv_dtype = os.environ.get(KV_DTYPE_ENV) or None
        if kv_dtype and not (block_size and block_size > 0):
            # A quantized-KV request silently served from the un-paged
            # float cache is a 4x memory surprise AND a wrong bench — the
            # malformed-knob posture raises instead.
            raise ValueError(
                f"{KV_DTYPE_ENV}={kv_dtype!r} requires the paged "
                f"backend ({BLOCK_SIZE_ENV} > 0); the un-paged cache "
                "has no quantized mode")
        device = resolve_device(device)
        if model.device != device and not (
                device.type == model.device.type and device.index is None):
            raise ValueError(
                f"the model lies on {model.device}, the engine was asked "
                f"for {device}; build the model with device={device!s}")
        if variables is not None:
            load_flax_params(model, variables)
        # tp_kw's truthiness SELECTS the TensorParallel class: keep it
        # tp-only (weight_dtype rides the common arguments)
        tp_kw = {"tp": int(tp), "mesh": mesh} \
            if int(tp) > 1 or mesh is not None else {}
        common = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed, prefix_cache_bytes=pbytes,
                      weight_dtype=weight_dtype)
        if block_size and block_size > 0:
            from .backend import (PagedLlamaSlotBackend,
                                  TensorParallelPagedLlamaSlotBackend)
            kv_pool_mb = kv_pool_mb if kv_pool_mb is not None \
                else _env_num(KV_POOL_MB_ENV, None, float)
            klass = TensorParallelPagedLlamaSlotBackend if tp_kw \
                else PagedLlamaSlotBackend
            backend = klass(
                model, num_slots, max_len,
                block_size=int(block_size), pool_blocks=pool_blocks,
                kv_pool_mb=kv_pool_mb, kv_dtype=kv_dtype, **common,
                **tp_kw)
        else:
            from .backend import (LlamaSlotBackend,
                                  TensorParallelLlamaSlotBackend)
            klass = TensorParallelLlamaSlotBackend if tp_kw \
                else LlamaSlotBackend
            backend = klass(model, num_slots, max_len, **common, **tp_kw)
        return cls(backend, eos_id=eos_id, **kw)

    # -- telemetry helpers ------------------------------------------------
    def _metric(self, kind: str, name: str, *args, buckets=None):
        if not telemetry.enabled():
            return
        reg = telemetry.registry()
        if kind == "counter":
            reg.counter(name).inc(*args)
        elif kind == "gauge":
            reg.gauge(name).set(*args)
        else:
            reg.histogram(name, buckets or _LATENCY_BUCKETS).observe(*args)

    def _note_stall(self, dt: float, n_running: int):
        """Account one prefill-induced decode stall: a prefill (whole
        prompt on the blocking path, one chunk on the stall-free path)
        ran for ``dt`` wall seconds while ``n_running`` RUNNING slots
        sat idle instead of decoding. The ``serve_decode_stall`` span
        lands in the flight recorder like every other stage, so the
        scheduler's before/after is provable from the trace, not just
        the bench."""
        if n_running <= 0 or dt <= 0:
            return
        self.stats["decode_stall_s"] += dt
        self.stats["decode_stall_events"] += 1
        events.completed_span("serve_decode_stall", dt,
                              slots_waiting=n_running)
        self._metric("counter", "serving_decode_stall_s_total", dt)
        self._metric("histogram", "serve_decode_stall_s", dt,
                     buckets=_STALL_BUCKETS)

    # -- admission --------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 16, *,
               stream_cb=None, block: bool = True,
               timeout: float | None = None,
               deadline_s: float | None = None) -> Request:
        """Queue one request; returns its :class:`Request` handle.

        Admission control is synchronous: an invalid prompt (empty, or
        out-of-vocab ids when the backend knows its vocab) or one whose
        ``bucket + max_new_tokens`` cannot fit the slot cache raises
        :class:`RequestRejected`; a full queue blocks (``block=True``,
        up to ``timeout``) or raises :class:`QueueFullError` — that is
        the backpressure contract, the caller owns retry/shedding.

        ``deadline_s`` caps the request's total wall time from submit
        (default ``SPARKDL_SERVE_DEADLINE_S``; 0/None = no deadline):
        past it the engine aborts the request at the next iteration
        boundary, freeing its slot and KV blocks, and ``result()``
        raises :class:`DeadlineExceeded`.

        On a started tensor-parallel engine only rank 0 takes requests
        (its front; the limit then runs from rank 0's clock at submit,
        and no collective is issued here); another rank raises
        ``ValueError``.
        """
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            self._reject("empty prompt (needs >= 1 token id)")
        if max_new_tokens < 1:
            self._reject("max_new_tokens < 1")
        vocab = getattr(self.backend, "vocab_size", None)
        if vocab is not None and any(t < 0 or t >= vocab for t in prompt):
            # the poisoned-request fast path: a corrupt id would index
            # the embedding out of range (silently clamped on-device) —
            # reject at the door, with the offending id named
            bad = next(t for t in prompt if t < 0 or t >= vocab)
            self._reject(f"token id {bad} outside vocab [0, {vocab})")
        if self.stall_free:
            # Chunked placement is zero-aligned: the prompt writes rows
            # [0, ceil(L/C)*C) (pad tail included) and decode continues
            # from L — both ends must fit the slot row.
            c = self.prefill_chunk
            bucket = -(-len(prompt) // c) * c
            if max(bucket, len(prompt) + max_new_tokens) > \
                    self.backend.max_len:
                self._reject(
                    f"chunk-aligned prompt ({bucket}) + max_new_tokens "
                    f"({max_new_tokens}) exceeds max_len "
                    f"{self.backend.max_len}")
        else:
            bucket = bucket_length(len(prompt), self.min_bucket)
            if bucket + max_new_tokens > self.backend.max_len:
                self._reject(
                    f"bucketed prompt ({bucket}) + max_new_tokens "
                    f"({max_new_tokens}) exceeds max_len "
                    f"{self.backend.max_len}")
        if self.paged:
            # Reject only what can NEVER fit — a request whose lifetime
            # block footprint exceeds the whole pool would wait forever;
            # anything smaller waits for blocks (backpressure, below).
            # Chunked mode: only real rows need blocks (pad writes go
            # to the trash block); blocking mode writes the whole
            # left-padded bucket.
            bs = self.backend.block_size
            rows = len(prompt) + max_new_tokens if self.stall_free \
                else max(bucket, len(prompt) + max_new_tokens)
            # the +1 decode block caps at the slot row (a request
            # spanning the whole row grows no further)
            need = min(-(-rows // bs) + 1,
                       -(-self.backend.max_len // bs))
            total = self.backend.allocator.usable_blocks
            if need > total:
                self._reject(
                    f"request needs {need} KV blocks (block_size {bs}); "
                    f"the whole pool holds {total} — can never fit")
        if self._front is not None and self._front.fronting():
            return self._front.submit(prompt, int(max_new_tokens), bucket,
                                      stream_cb, block, timeout, deadline_s)
        deadline = None if timeout is None else time.time() + timeout
        with self._work:
            if self._stop_mode is not None or self._fatal is not None:
                raise EngineStopped("engine is stopped")
            while len(self._queue) >= self.queue_capacity:
                if not block:
                    self._reject_locked("queue_full", QueueFullError)
                remain = None if deadline is None \
                    else deadline - time.time()
                if remain is not None and remain <= 0:
                    self._reject_locked("queue_full_timeout",
                                        QueueFullError)
                if not self._work.wait(timeout=remain if remain is not None
                                       else 0.5):
                    if deadline is not None:
                        self._reject_locked("queue_full_timeout",
                                            QueueFullError)
                if self._stop_mode is not None or self._fatal is not None:
                    raise EngineStopped("engine is stopped")
            req = Request(next(_REQUEST_IDS), prompt, int(max_new_tokens),
                          bucket, stream_cb)
            limit = deadline_s if deadline_s is not None \
                else self.default_deadline_s
            if limit and limit > 0:
                start = req.t_submit if self._group_clock is None \
                    else self._group_clock(req.t_submit)
                req.t_deadline = start + float(limit)
            self._queue.append(req)
            self.stats["submitted"] += 1
            depth = len(self._queue)
            if depth > self.stats["peak_queue_depth"]:
                self.stats["peak_queue_depth"] = depth
            self._work.notify_all()
        self._metric("gauge", "serving_queue_depth", depth)
        sentinel_lib.observe("queue_depth", float(depth))
        return req

    def _reject(self, reason: str, exc_type=RequestRejected):
        with self._lock:
            self._reject_locked(reason, exc_type)

    def _reject_locked(self, reason: str, exc_type=RequestRejected):
        """Caller holds the lock; raises after recording the rejection."""
        self.stats["rejected"] += 1
        events.event("serve_reject", reason=reason[:200])
        self._metric("counter", "serving_requests_rejected_total")
        raise exc_type(reason)

    # -- scheduling loop --------------------------------------------------
    def step(self) -> bool:
        """One scheduler iteration. Stall-free (default): admit queued
        requests into free slots, advance AT MOST ONE chunk of at most
        one PREFILLING slot, then advance every RUNNING slot one decode
        step — a long prompt is consumed interleaved with everyone
        else's decode instead of monopolizing the device. Blocking
        fallback (``SPARKDL_SERVE_STALL_FREE=0``): retire/refill free
        slots with whole-prompt prefills, then decode. Returns True when
        any work happened; False when idle — the inline-drive loop
        condition.

        Failover seam: a serving-fatal error or stall
        surfacing from ANY backend call inside the iteration is caught
        HERE — the single supervisor point — and routed through
        :meth:`_handle_fatal`; when the failover succeeds (backend
        rebuilt, live requests re-admitted) the iteration reports
        worked=True and serving continues."""
        if self._fatal is not None:
            raise EngineStopped("engine died") from self._fatal
        self.t_heartbeat = time.time()
        if self._group_clock is not None:
            self._group_now = self._group_clock(self.t_heartbeat)
        try:
            return self._step_inner()
        except Exception as e:  # noqa: BLE001 — failover routing
            if not (getattr(e, "serving_fatal", False)
                    or isinstance(e, ServingStallError)):
                raise  # scheduler bug etc: the old fail-everything path
            self._handle_fatal(e)
            if self._fatal is None:
                return True  # failed over: rebuilt + re-admitted
            raise

    def _step_inner(self) -> bool:
        worked = self._reap_cancelled()
        if self.stall_free:
            worked = self._admit() > 0 or worked
            worked = self._prefill_tick() or worked
        else:
            worked = self._refill() > 0 or worked
        with self._lock:
            busy = sum(r is not None for r in self._slots)
            active = [(s, r) for s, r in enumerate(self._slots)
                      if r is not None and r.state == RUNNING]
        if busy > self.stats["peak_slots_busy"]:
            self.stats["peak_slots_busy"] = busy
        self._metric("gauge", "serving_slots_busy", busy)
        self._metric("gauge", "serving_tp_degree", self.tp_degree)
        if self.kv_pool_device_bytes is not None:
            self._metric("gauge", "serving_kv_pool_device_bytes",
                         self.kv_pool_device_bytes)
        if self.paged:
            self._export_pool_metrics()
        if not active:
            return worked
        if self.paged:
            # Lazy decode growth: every RUNNING slot needs a writable
            # block at its frontier before it may step; a slot the pool
            # cannot serve sits this iteration out (backpressure, not a
            # crash), and if NOBODY can step the newest request is
            # preempted to break the deadlock.
            active = self._filter_block_stalled(active)
            if not active:
                return True
        if self.spec_k > 0 and self._spec_step(active):
            return True
        # k = 0, or a speculative iteration where NO slot drafted
        # anything: the plain decode step (flash-decode economics, no
        # wasted k+1-wide verify window)
        t0 = time.perf_counter() if sentinel_lib.armed() else None
        toks = self._step_with_isolation()
        if t0 is not None and toks is not None:
            sentinel_lib.observe("decode_step", time.perf_counter() - t0)
        if toks is not None:
            self.stats["steps"] += 1
            for slot, req in active:
                if req.state == RUNNING:  # not evicted mid-isolation
                    self._deliver(req, int(toks[slot]))
                    req.write_pos += 1
        return True

    # -- deadlines / cancellation ------------------------------
    def _now(self) -> float:
        """The clock deadline decisions read: the wall clock, or a
        tensor-parallel group's reading of this iteration."""
        return time.time() if self._group_clock is None \
            else self._group_now

    @staticmethod
    def _should_cancel(req: Request, now: float) -> bool:
        if req.state in (DONE, FAILED):
            return False
        return req._cancel or (req.t_deadline is not None
                               and now >= req.t_deadline)

    def _reap_cancelled(self) -> bool:
        """Honor ``Request.cancel()`` and expired deadlines at the
        iteration boundary: pull the victims out of the queue and the
        slot table, release their slots (a paged release derefs every
        KV block; a mid-prefill abort never committed a radix/prefix
        entry, so there is nothing to roll back), and finish them
        FAILED with :class:`RequestCancelled` / :class:`DeadlineExceeded`
        — counted in ``cancelled``, never ``quarantined``."""
        now = self._now()
        victims = []
        with self._work:
            for r in list(self._queue):
                if self._should_cancel(r, now):
                    self._queue.remove(r)
                    victims.append(r)
            for s, r in enumerate(self._slots):
                if r is not None and self._should_cancel(r, now):
                    self._slots[s] = None
                    victims.append(r)
            if victims:
                self._work.notify_all()
        for r in victims:
            slot, r.slot = r.slot, None
            self._release_slot(slot)
            self._finish_cancelled(r, now)
        return bool(victims)

    def _finish_cancelled(self, req: Request, now: float):
        reason = "cancelled" if req._cancel else "deadline"
        req.state = FAILED
        req.finish_reason = reason
        if req._cancel:
            req.error = RequestCancelled(
                f"request {req.id} cancelled by the client "
                f"({len(req.tokens)} token(s) already streamed)")
        else:
            req.error = DeadlineExceeded(
                f"request {req.id} exceeded its deadline "
                f"({now - req.t_submit:.3f}s since submit)")
        req.t_done = now
        req.chunk_plan = None
        self._end_block_stall(req, time.perf_counter())
        self.stats["cancelled"] += 1
        events.event("serve_request_cancelled", request=req.id,
                     reason=reason, generated=len(req.tokens),
                     **_req_trace(req))
        self._metric("counter", "serving_requests_cancelled_total")
        self._close_request_span(req, reason)
        req._done.set()

    def run_until_idle(self):
        """Drive inline until the queue is empty and every slot idle."""
        while self.step():
            pass

    def start(self, on_request=None) -> "GenerationEngine":
        """Run the scheduling loop in a daemon thread.

        On a tensor-parallel engine every rank of the group calls it:
        rank 0 runs the group's front, whose loop sends each iteration's
        admissions, cancels, stop and clock to the others, and every
        other rank follows (``serving.group``). Only rank 0 then takes
        ``submit()`` and ``resume()``; a follower's ``stop()`` /
        ``drain()`` wait for rank 0's stop and return the same
        snapshots. ``on_request(req)`` is called on every rank with each
        request its group admits or resumes (a follower's handle, named
        by rank 0's id, streams what rank 0 was asked); one device has no
        such hook."""
        if self._front is not None:
            return self._front.start(on_request)
        if on_request is not None:
            raise ValueError("on_request= serves a tensor-parallel group's "
                             "ranks; this engine has no group")
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_mode = None
            self._thread = threading.Thread(
                target=self._loop, name="sparkdl-serve-engine", daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float | None = None
             ) -> list[Request]:
        """Stop the background loop. ``drain=True`` finishes queued and
        in-flight requests first; ``drain=False`` fails them with
        :class:`EngineStopped`. A drain wedged past
        ``SPARKDL_SERVE_STALL_S`` (or ``timeout``) degrades to
        snapshot-and-stop: the still-live requests are preempted into
        resumable snapshots and returned (empty list on a clean
        drain/stop)."""
        return self._shutdown("drain" if drain else "now", timeout)

    def drain(self, timeout: float | None = None) -> list[Request]:
        """Graceful handoff: stop admission, preempt every
        live request into a resumable snapshot (``prompt`` +
        ``tokens``-so-far on the returned :class:`Request` handles —
        the preemption-resume form), and return them. Feed each to
        :meth:`resume` on a fresh engine to continue exactly where it
        left off; already-streamed tokens are never re-emitted."""
        return self._shutdown("snapshot", timeout)

    def _shutdown(self, mode: str, timeout: float | None
                  ) -> list[Request]:
        """The ONE stop/drain implementation. ``mode``: "drain"
        (finish everything, degrade to snapshot past the stall budget),
        "snapshot" (immediate preempt-and-return), "now" (fail
        pending)."""
        if self._front is not None:
            snaps = self._front.shutdown(mode, timeout)
            if snaps is not None:
                return snaps
        with self._work:
            self._stop_mode = "drain" if mode == "drain" else "now"
            self._work.notify_all()
            t = self._thread
        snaps: list[Request] = []
        if mode == "drain" and t is not None:
            budget = timeout
            if self.stall_s and self.stall_s > 0:
                budget = self.stall_s if budget is None \
                    else min(budget, self.stall_s)
            t.join(budget)
            if t.is_alive():
                # Wedged drain: never hang the caller — degrade to
                # snapshot-and-stop, returning the resumable snapshots.
                log.warning("drain still running after %ss; degrading "
                            "to snapshot-and-stop", budget)
                with self._work:
                    self._stop_mode = "now"
                    self._work.notify_all()
                mode = "snapshot"
        if mode == "now" and t is not None:
            t.join(timeout)
        if mode == "snapshot":
            if t is not None:
                # Give the loop one beat to notice stop_mode="now" and
                # park between iterations; the in-flight guards make a
                # late backend return harmless either way.
                t.join(timeout if timeout is not None
                       else (self.stall_s or 1.0))
            snaps = self._detach_all()
            events.event("serve_engine_drain", requests=len(snaps))
        if t is not None:
            if t.is_alive():
                # The loop is wedged past the join timeout: leave
                # _thread set so a later start() cannot spawn a SECOND
                # loop over the same slot table.
                log.warning("serve engine loop still running after "
                            "stop(timeout=%s); not restartable until it "
                            "exits", timeout)
            else:
                with self._lock:
                    if self._thread is t:  # a concurrent start() may
                        self._thread = None  # already own the handle
        if mode == "now":
            self._fail_pending(EngineStopped("engine stopped"))
        pool, self._watch_pool = self._watch_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        return snaps

    def resume(self, req: "Request | dict", *, stream_cb=None) -> Request:
        """Re-admit a drained/preempted snapshot — on this engine or a
        DIFFERENT one. Accepts either the :class:`Request`
        handle :meth:`drain` returned, or a self-contained snapshot
        dict from :meth:`Request.snapshot` (the router's shadow-state
        path for an uncleanly dead replica; ``stream_cb`` attaches the
        continuation stream). The request keeps its id; its prefill
        consumes ``prompt + tokens-so-far`` and the stream continues
        exactly where it left off (greedy determinism), nothing
        re-emitted.

        Cross-engine safety: the request is RE-BUCKETED for THIS
        engine's config (chunk alignment / ``min_bucket`` may differ
        from the engine that drained it); a snapshot that cannot fit
        this engine's ``max_len`` raises :class:`RequestRejected`, and
        a stale/foreign snapshot (unknown version, missing fields, or
        a delivery cursor past the emitted tokens) raises
        :class:`SnapshotIncompatibleError` — both BEFORE the snapshot
        can touch a slot. Undelivered tail tokens (emitted but never
        streamed before the hop) are dropped back to the delivery
        cursor: greedy determinism regenerates them identically, so
        the client stream stays zero-dup / zero-loss."""
        if isinstance(req, dict):
            req = self._request_from_snapshot(req, stream_cb)
        elif stream_cb is not None:
            req.stream_cb = stream_cb
        if req.state in (DONE, FAILED):
            return req
        req.bucket = self._resume_bucket(req)
        if self._front is not None and self._front.fronting():
            return self._front.resume(req)
        with self._work:
            if self._stop_mode is not None or self._fatal is not None:
                raise EngineStopped("engine is stopped")
            req.state = QUEUED
            req.slot = None
            req.chunk_plan = None
            req._block_stalled = False
            req.t_enqueue = time.time()
            self._queue.append(req)
            self.stats["submitted"] += 1
            self._work.notify_all()
        return req

    def _request_from_snapshot(self, snap: dict, stream_cb) -> Request:
        """Rehydrate a :meth:`Request.snapshot` dict into a fresh
        handle (validation first — a foreign/corrupt snapshot must die
        here, not in a slot)."""
        version = snap.get("version")
        if version != SNAPSHOT_VERSION:
            raise SnapshotIncompatibleError(
                f"resume snapshot version {version!r} is not the "
                f"supported version {SNAPSHOT_VERSION}")
        try:
            rid = int(snap["id"])
            prompt = [int(t) for t in snap["prompt"]]
            tokens = [int(t) for t in snap["tokens"]]
            delivered = int(snap["delivered"])
            max_new = int(snap["max_new_tokens"])
        except (KeyError, TypeError, ValueError) as e:
            raise SnapshotIncompatibleError(
                f"resume snapshot is missing or malforms a required "
                f"field: {e!r}") from e
        if not prompt:
            raise SnapshotIncompatibleError(
                "resume snapshot has an empty prompt")
        if delivered < 0 or delivered > len(tokens):
            raise SnapshotIncompatibleError(
                f"resume snapshot delivery cursor {delivered} is "
                f"outside its emitted tokens [0, {len(tokens)}] — "
                f"re-admitting it could duplicate or lose streamed "
                f"tokens")
        req = Request(rid, prompt, max_new, 0, stream_cb)
        # Roll emitted-but-undelivered tokens back to the cursor: the
        # client never saw them, and the greedy continuation regrows
        # them bit-identically.
        req.tokens = tokens[:delivered]
        req.delivered = delivered
        req.failovers = int(snap.get("failovers", 0) or 0)
        return req

    def _resume_bucket(self, req: Request) -> int:
        """Re-bucket a resumed request for THIS engine (its stored
        bucket belongs to the engine that drained it). Same fit rules
        as :meth:`submit`, over the SERVED sequence (prompt + tokens
        already generated)."""
        served = len(req.prompt) + len(req.tokens)
        remaining = max(1, req.max_new_tokens - len(req.tokens))
        if self.stall_free:
            c = self.prefill_chunk
            bucket = -(-served // c) * c
            if max(bucket, served + remaining) > self.backend.max_len:
                self._reject(
                    f"resumed request {req.id}: chunk-aligned served "
                    f"length ({bucket}) + remaining tokens "
                    f"({remaining}) exceeds max_len "
                    f"{self.backend.max_len}")
        else:
            bucket = bucket_length(served, self.min_bucket)
            if bucket + remaining > self.backend.max_len:
                self._reject(
                    f"resumed request {req.id}: bucketed served length "
                    f"({bucket}) + remaining tokens ({remaining}) "
                    f"exceeds max_len {self.backend.max_len}")
        if self.paged:
            # Never-fit only — a coverable-but-currently-full pool
            # waits FIFO (the admission gate's backpressure), exactly
            # the submit() posture.
            bs = self.backend.block_size
            rows = served + remaining if self.stall_free \
                else max(bucket, served + remaining)
            need = min(-(-rows // bs) + 1,
                       -(-self.backend.max_len // bs))
            total = self.backend.allocator.usable_blocks
            if need > total:
                self._reject(
                    f"resumed request {req.id} needs {need} KV blocks "
                    f"(block_size {bs}); the whole pool holds {total} "
                    f"— can never fit")
        return bucket

    def residency_digest(self) -> dict | None:
        """Compact digest of the backend's resident prefix heads
        — what a fleet router's radix-aware placement
        shadows. Duck-typed over both cache families: the paged
        backends' :class:`~sparkdl_tpu.serving.prefix.RadixPrefixCache`
        (via ``backend.radix`` / ``backend.mgr.radix``) or the unpaged
        byte-payload LRU (``backend.prefix_cache``). ``None`` when no
        prefix cache is enabled."""
        be = self.backend
        radix = getattr(be, "radix", None)
        if radix is None:
            radix = getattr(getattr(be, "mgr", None), "radix", None)
        if radix is not None:
            return radix.residency_digest()
        pc = getattr(be, "prefix_cache", None)
        if pc is not None:
            return pc.residency_digest()
        return None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)
        return False

    def _loop(self):
        # Online anomaly sentinel: env-armed at loop start,
        # same posture as fit() — TTFT / decode-step / queue-depth
        # baselines drift-checked while the engine serves.
        sentinel_lib.maybe_arm_from_env()
        try:
            while True:
                with self._work:
                    if self._fatal is not None or self._stop_mode == "now":
                        break
                    idle = not self._queue and all(
                        r is None for r in self._slots)
                    if idle:
                        if self._stop_mode == "drain":
                            break
                        self.t_heartbeat = time.time()
                        self._work.wait(0.05)
                        continue
                try:
                    self.step()
                except Exception as e:  # noqa: BLE001 — record, not die
                    # step() already routed failover-eligible errors; a
                    # raise here means failover was impossible/failed
                    # (or a scheduler bug) — record and die, unless a
                    # concurrent path somehow recovered.
                    self._handle_fatal(e)
                    if self._fatal is not None:
                        break
        finally:
            # A stop() whose join timed out leaves _thread set (so a
            # concurrent start() can't double-drive the slot table);
            # once the loop really exits, release the handle so start()
            # can re-arm the engine.
            with self._lock:
                if self._thread is threading.current_thread():
                    self._thread = None

    # -- refill -----------------------------------------------------------
    def _served_prompt(self, req: Request) -> list:
        """The token sequence this admission actually prefills: the
        prompt, plus any tokens already generated before a preemption
        (the recompute-resume — greedy K/V is deterministic, so the
        continuation picks up exactly where the preempted decode
        left off)."""
        return req.prompt + req.tokens if req.tokens else req.prompt

    def _blocks_needed(self, req: Request) -> int:
        """Worst-case NEW blocks an admission must be able to cover:
        the REAL prompt rows (chunk-pad writes route to the trash
        block, so alignment never inflates the footprint — in
        particular after a preemption resume) — or the blocking
        bucket, whose left-pad rows ARE written — plus one decode
        block. Radix grafts only reduce the real allocation, never the
        gate (conservative)."""
        served = len(self._served_prompt(req))
        rows = served if self.stall_free else \
            self._blocking_bucket(served, req)
        rows = min(rows, self.backend.max_len)
        bs = self.backend.block_size
        return min(-(-rows // bs) + 1,
                   -(-self.backend.max_len // bs))

    def _blocking_bucket(self, served: int, req: Request) -> int:
        """Blocking-path bucket for (possibly resumed) ``served``
        tokens: the power-of-two bucket, clamped so bucket + the
        remaining output still fits the slot row — a resume whose
        re-bucket overshoots ``max_len`` must degrade to a snug
        non-power-of-two bucket (one extra compiled prefill per resume
        length; preemption is rare), never quarantine. Always >=
        ``served``: admission guaranteed served + remaining <=
        max_len."""
        remaining = max(1, req.max_new_tokens - len(req.tokens))
        return min(bucket_length(served, self.min_bucket),
                   self.backend.max_len - remaining)

    def _pop_to_slot(self):
        """Move the queue head into the lowest free slot (admission
        bookkeeping shared by both scheduler modes); returns
        ``(req, slot)`` or ``(None, None)`` when there is nothing to
        do. Paged mode additionally gates on KV-pool capacity: a head
        the pool cannot cover WAITS (FIFO — later smaller requests do
        not jump it), counted in ``admission_block_waits``."""
        with self._work:
            free = [s for s, r in enumerate(self._slots) if r is None]
            if not free or not self._queue:
                return None, None
            if self.paged and not self.backend.can_reserve(
                    self._blocks_needed(self._queue[0])):
                self.stats["admission_block_waits"] += 1
                return None, None
            req = self._queue.popleft()
            slot = min(free)  # deterministic: lowest free slot, FIFO
            self._slots[slot] = req
            depth = len(self._queue)
            self._work.notify_all()  # queue space freed
        req.t_admit = time.time()
        req.slot = slot
        self._metric("gauge", "serving_queue_depth", depth)
        # Per-STINT wait: t_enqueue is reset on every requeue, so a
        # preempted request's second serve_queue span measures only its
        # re-queued wait — the trace collector sums stints, and phases
        # still total the end-to-end latency.
        wait_s = req.t_admit - req.t_enqueue
        events.completed_span("serve_queue", wait_s, request=req.id,
                              **_req_trace(req))
        self._metric("histogram", "serving_queue_wait_s", wait_s)
        return req, slot

    def _refill(self) -> int:
        """Blocking-mode refill: every free slot prefills its whole
        prompt inside this scheduler iteration (the pre-ISSUE-10
        head-of-line stall the stall-free path removes)."""
        admitted = 0
        while True:
            req, slot = self._pop_to_slot()
            if req is None:
                break
            try:
                ok = self._prefill_with_retries(req, slot)
            except BlockExhausted:
                # The admission gate was optimistic (an imminent graft
                # can pin blocks it counted evictable): requeue at the
                # FRONT and wait — exhaustion is backpressure, never a
                # quarantine.
                self._requeue_for_blocks(req, slot)
                break
            admitted += 1
            if not ok:
                with self._work:
                    self._slots[slot] = None
                    self._work.notify_all()
                # Same release as retirement/eviction/chunked
                # quarantine: a release()-ful backend must never leak a
                # slot's fill state on the blocking path either.
                self._release_slot(slot)
        return admitted

    def _requeue_for_blocks(self, req: Request, slot: int):
        with self._work:
            if self._slots[slot] is req:
                self._slots[slot] = None
            self._queue.appendleft(req)
            self._work.notify_all()
        self._release_slot(slot)
        req.slot = None
        req.t_enqueue = time.time()  # new queued stint begins
        self.stats["admission_block_waits"] += 1
        events.event("serve_admission_block_wait", request=req.id,
                     **_req_trace(req))

    # -- stall-free admission + chunked prefill ---------------------------
    def _admit(self) -> int:
        """Move queued requests into free slots as PREFILLING (prefix
        seed + chunk plan; no prompt compute happens here — chunks run
        one per iteration in :meth:`_prefill_tick`)."""
        admitted = 0
        while True:
            req, slot = self._pop_to_slot()
            if req is None:
                break
            if not self._arm_chunked_prefill(req, slot):
                break  # requeued on block exhaustion: wait, FIFO order
            admitted += 1
        return admitted

    def _arm_chunked_prefill(self, req: Request, slot: int) -> bool:
        c = self.prefill_chunk
        served = self._served_prompt(req)
        # Per-stint active-prefill ledger: a preemption-resume re-arms
        # here, and its serve_prefill span must report THIS stint's
        # compute, not re-bill the previous stint's (already landed on
        # the earlier span).
        req.prefill_spent_s = 0.0
        with self._lock:
            n_running = sum(1 for r in self._slots
                            if r is not None and r.state == RUNNING)
        start = 0
        t0 = time.perf_counter()
        try:
            # Under the same watchdog + stall ledger as every other
            # device call: a prefix-cache hit scatters K/V rows
            # device-side, which both stalls running decodes and can
            # wedge exactly like a chunk. (A paged backend's graft is a
            # pointer swap — cheap, but the ledger stays honest.)
            start = int(self._timed(
                lambda: self.backend.begin_prefill(slot, served, c),
                "prefix_seed"))
        except ServingStallError:
            raise  # a wedged device is never a per-request fault
        except BlockExhausted:
            # Optimistic-gate miss (see _refill): requeue and wait.
            self._requeue_for_blocks(req, slot)
            return False
        except Exception as e:  # noqa: BLE001 — reuse is an optimization
            if getattr(e, "serving_fatal", False):
                raise  # step()'s failover seam owns it
            if self.paged:
                # Paged begin_prefill is RESERVATION, not just reuse: a
                # cold fallback would chunk-write through an unreserved
                # (trash-parked) table — silently wrong tokens. Retry
                # the whole admission; quarantine past the budget.
                req.failures += 1
                if req.failures > self.retries:
                    with self._work:
                        if self._slots[slot] is req:
                            self._slots[slot] = None
                        self._work.notify_all()
                    self._release_slot(slot)
                    self._quarantine(req, e)
                    return True  # slot freed — keep admitting others
                events.event("serve_reserve_retry", request=req.id,
                             attempt=req.failures,
                             error=f"{type(e).__name__}: {e}"[:200],
                             **_req_trace(req))
                self._requeue_for_blocks(req, slot)
                return False
            events.event("serve_prefix_seed_failed", request=req.id,
                         error=f"{type(e).__name__}: {e}"[:200],
                         **_req_trace(req))
            start = 0
        dt = time.perf_counter() - t0
        self._note_stall(dt, n_running)
        req.prefill_spent_s += dt
        # Guard the contract (usable_reuse): a drifted backend must
        # degrade to a cold prefill, never hand the chunker an empty or
        # misaligned plan (a non-chunk-multiple start could make the
        # final chunk's scatter clamp at max_len and slide back over
        # committed rows).
        if not 0 <= start < len(served) or start % c:
            if start != 0:
                log.warning("backend.begin_prefill returned offset %s "
                            "for a %s-token prompt (chunk %s); ignoring "
                            "prefix reuse", start, len(served), c)
            start = 0
        tail = served[start:]
        plan = []
        for i in range(0, len(tail), c):
            part = list(tail[i:i + c])
            nv = len(part)
            if nv < c:  # final chunk right-pads; n_valid marks the reals
                part = part + [0] * (c - nv)
            plan.append((part, nv))
        req.chunk_plan = plan
        req.chunk_base = start
        req.next_chunk = 0
        req.prefill_reused = start
        req.served_len = len(served)
        req.state = PREFILLING
        return True

    def _prefill_tick(self) -> bool:
        """Spend this iteration's prefill TOKEN budget
        (``SPARKDL_SERVE_PREFILL_BUDGET``, default one chunk) one
        chunk at a time, round-robin oldest-
        admitted-first across every PREFILLING slot: with the default
        budget exactly one chunk of the oldest request runs per
        iteration; with a larger budget one iteration can advance —
        and complete — several refills, removing the ~1
        admission/iteration cap that starved high-churn mixes. Every
        RUNNING slot's decode still runs in the same iteration, so a
        long prompt costs running requests at most ``budget`` tokens of
        added latency per step, never a whole O(L²) prefill.
        Chunk-aware retry: a failed chunk stays current (the cache
        holds every committed chunk) and is re-attempted next tick;
        past the retry budget the REQUEST is quarantined and its slot
        freed — the gang keeps serving."""
        budget = self.prefill_budget
        worked = False
        while budget > 0:
            with self._lock:
                prefilling = sorted(
                    (r for r in self._slots
                     if r is not None and r.state == PREFILLING),
                    key=lambda r: (r.t_admit or 0.0, r.id))
            if not prefilling:
                break
            progressed = False
            for req in prefilling:
                if budget <= 0:
                    break
                if req.state != PREFILLING:
                    continue
                self._prefill_chunk_once(req)
                progressed = worked = True
                budget -= self.prefill_chunk
            if not progressed:
                break
        return worked

    def _prefill_chunk_once(self, req: Request) -> None:
        """Run exactly one chunk (or the final chunk + finish) of one
        PREFILLING request — the unit the budget loop spends."""
        with self._lock:
            n_running = sum(1 for r in self._slots
                            if r is not None and r.state == RUNNING)
        c = self.prefill_chunk
        chunk, n_valid = req.chunk_plan[req.next_chunk]
        offset = req.chunk_base + req.next_chunk * c
        final = req.next_chunk == len(req.chunk_plan) - 1
        window = req.chunk_base + len(req.chunk_plan) * c
        t0 = time.perf_counter()
        try:
            tok = self._timed(
                lambda: self.backend.prefill_chunk(req.slot, chunk,
                                                   offset, n_valid,
                                                   window),
                "prefill_chunk")
            if final:
                aligned = req.chunk_base + len(req.chunk_plan) * c
                # Commit policy: caching a one-chunk prompt can never
                # save a chunk on reuse, and a prompt the cache already
                # mostly served (a warm hit's distinct tail) adds no
                # reusable head — skip the commit copy for both. A
                # paged backend's radix commit is a zero-copy pointer
                # insert, so there is no copy economy to police:
                # commit whenever the prompt holds a full block.
                commit = True if self.paged else (
                    aligned > c and req.prefill_reused * 2 < aligned)
                tok = self._timed(
                    lambda: self.backend.finish_prefill(
                        req.slot, self._served_prompt(req), tok, aligned,
                        commit=commit),
                    "finish_prefill")
        except ServingStallError:
            raise  # a wedged device is never a per-request fault
        except Exception as e:  # noqa: BLE001 — per-request isolation
            if getattr(e, "serving_fatal", False):
                raise  # step()'s failover seam owns it
            dt_fail = time.perf_counter() - t0
            self._note_stall(dt_fail, n_running)
            req.prefill_spent_s += dt_fail  # failed-attempt compute is
            # still prefill-phase time — it must not leak into wait_s
            req.failures += 1
            if req.failures > self.retries:
                with self._work:
                    if req.slot is not None and \
                            self._slots[req.slot] is req:
                        self._slots[req.slot] = None
                    self._work.notify_all()
                self._release_slot(req.slot)
                self._quarantine(req, e)
            else:
                self.stats["prefill_retries"] += 1
                events.event("serve_prefill_chunk_retry", request=req.id,
                             chunk=req.next_chunk, offset=offset,
                             attempt=req.failures,
                             error=f"{type(e).__name__}: {e}"[:200],
                             **_req_trace(req))
            return
        dt = time.perf_counter() - t0
        self._note_stall(dt, n_running)
        req.prefill_spent_s += dt
        req.next_chunk += 1
        self.stats["prefill_chunks"] += 1
        if final:
            self.stats["prefills"] += 1
            if req.state != PREFILLING:
                # The engine failed, failed over, or drained while the
                # chunk was in flight: the request was already reported
                # failed — or detached into a resumable snapshot (state
                # QUEUED) awaiting re-admission. Never resurrect it to
                # RUNNING or stream a token from the dead stint.
                return
            req.state = RUNNING
            req.write_pos = req.served_len  # decode writes from L
            req.t_decode_start = time.time()
            # wait_s = the PREFILLING phase's wall minus its active
            # compute: time this request's chunks sat waiting for their
            # round-robin turn while other slots prefilled/decoded. The
            # trace collector needs it so queue + prefill + wait +
            # decode provably sums to the measured latency.
            phase_wall = req.t_decode_start - (req.t_admit
                                               or req.t_decode_start)
            wait_s = max(0.0, phase_wall - req.prefill_spent_s)
            events.completed_span(
                "serve_prefill", req.prefill_spent_s, request=req.id,
                slot=req.slot, bucket=req.bucket, rows=1,
                chunks=len(req.chunk_plan), reused=req.prefill_reused,
                wait_s=round(wait_s, 6), **_req_trace(req))
            self._deliver(req, int(tok))

    def _prefill_with_retries(self, req: Request, slot: int) -> bool:
        last: BaseException | None = None
        served = self._served_prompt(req)
        if req.tokens:  # preemption resume: re-bucket the longer prompt
            req.bucket = self._blocking_bucket(len(served), req)
        for attempt in range(self.retries + 1):
            with self._lock:
                n_running = sum(1 for r in self._slots
                                if r is not None and r.state == RUNNING)
            t0 = time.perf_counter()
            try:
                with events.span("serve_prefill", request=req.id, slot=slot,
                                 bucket=req.bucket, rows=1,
                                 **_req_trace(req)):
                    first = self._timed(
                        lambda: self.backend.prefill(slot, served,
                                                     req.bucket),
                        "prefill")
                # The head-of-line stall this whole prefill inflicted on
                # every already-RUNNING slot (the blocking-path number
                # the stall-free scheduler is measured against).
                self._note_stall(time.perf_counter() - t0, n_running)
                self.stats["prefills"] += 1
                if req.state == FAILED or self._slots[slot] is not req:
                    # The engine failed, failed over, or drained while
                    # this prefill was in flight: the request was
                    # already reported failed — or detached from the
                    # slot into a resumable snapshot. Never resurrect
                    # it to RUNNING or stream a token from the dead
                    # stint.
                    return False
                req.state = RUNNING
                req.served_len = len(served)
                req.write_pos = req.bucket  # blocking layout: cur=bucket
                req.t_decode_start = time.time()
                self._deliver(req, int(first))
                return True
            except ServingStallError:
                raise  # a wedged device is never a per-request fault
            except BlockExhausted:
                raise  # capacity, not a fault: _refill requeues + waits
            except Exception as e:  # noqa: BLE001 — per-request isolation
                if getattr(e, "serving_fatal", False):
                    # e.g. backend.SlotCacheLost: the donated cache was
                    # consumed by the failing call — retrying reads a
                    # deleted buffer, so let step()'s failover seam
                    # rebuild instead of evicting innocents one by one.
                    raise
                self._note_stall(time.perf_counter() - t0, n_running)
                last = e
                req.failures += 1
                if attempt < self.retries:
                    self.stats["prefill_retries"] += 1
                    events.event("serve_prefill_retry", request=req.id,
                                 attempt=attempt + 1,
                                 error=f"{type(e).__name__}: {e}"[:200],
                                 **_req_trace(req))
        self._quarantine(req, last)
        return False

    def _quarantine(self, req: Request, cause: BaseException | None):
        req.state = FAILED
        req.finish_reason = "error"
        req.error = RequestQuarantined(
            f"request {req.id} quarantined after {req.failures} "
            f"failure(s): {type(cause).__name__ if cause else '?'}: "
            f"{cause}")
        req.error.__cause__ = cause
        req.t_done = time.time()
        self.stats["quarantined"] += 1
        events.event("serve_request_quarantined", request=req.id,
                     failures=req.failures,
                     error=f"{type(cause).__name__}: {cause}"[:200]
                     if cause else "?", **_req_trace(req))
        self._metric("counter", "serving_requests_quarantined_total")
        self._close_request_span(req, "quarantined")
        req._done.set()

    # -- decode step ------------------------------------------------------
    def _step_with_isolation(self, call=None, stage: str = "decode_step"):
        """Run one backend decode/verify call with the retry
        posture: transient failures retry; past the budget the
        newest-admitted request (the slot-table state that changed most
        recently — the suspect) is evicted + quarantined and the call
        retried, so a poisoned request takes itself out, not the gang.
        ``call(slots)`` defaults to the plain decode step; the
        speculative path passes the batched verify. Returns the
        backend's result, or None when every request was evicted."""
        if call is None:
            call = self.backend.step
        attempts = 0
        while True:
            with self._lock:
                slots = sorted(s for s, r in enumerate(self._slots)
                               if r is not None and r.state == RUNNING
                               and not r._block_stalled)
            if not slots:
                # Every running request was evicted (each already
                # quarantined with its cause): the engine stays alive
                # and keeps serving the queue — a sole poisoned
                # occupant must not take the gang down any more than a
                # co-resident one does. A genuinely broken backend
                # degrades per-request (each new refill burns its own
                # retry budget and quarantines), never engine-fatally.
                return None
            try:
                return self._timed(lambda: call(slots), stage)
            except ServingStallError:
                raise
            except Exception as e:  # noqa: BLE001 — retry taxonomy below
                if getattr(e, "serving_fatal", False):
                    raise  # step()'s failover seam owns it
                attempts += 1
                if attempts <= self.retries:
                    self.stats["step_retries"] += 1
                    events.event("serve_step_retry", attempt=attempts,
                                 error=f"{type(e).__name__}: {e}"[:200])
                    continue
                with self._lock:
                    running = [r for r in self._slots
                               if r is not None and r.state == RUNNING
                               and not r._block_stalled]
                    victim = max(running, key=lambda r: r.t_admit or 0.0) \
                        if running else None
                    if victim is not None:
                        self._slots[victim.slot] = None
                if victim is not None:
                    # Same release step as a normal retirement: the
                    # backend parks the evicted slot (a release()-ful
                    # backend must never leak one slot per eviction).
                    self._release_slot(victim.slot)
                    self._quarantine(victim, e)
                attempts = 0

    # -- speculative decode ------------------------------------
    def _spec_step(self, active) -> bool:
        """One draft → verify → commit iteration: draft up to ``spec_k``
        candidates per RUNNING slot (jax-free provider, host-side),
        check them ALL in one batched target verify, and greedily
        commit the longest draft prefix the target's argmax agrees
        with plus the target's own next token — so every slot emits
        >= 1 token per iteration (a fully-rejected draft degrades to
        exactly the k=0 decode step's output, never below it). Reject
        is a pure frontier non-advance: the misspeculated rows sit
        past the slot's new write frontier and are garbage the next
        write overwrites before any attention reads them (the
        write-frontier invariant — no rollback program exists). Paged mode allocates
        each slot's draft-window growth blocks UP FRONT
        (``ensure_block_for`` per draft position; a position the pool
        cannot serve just shortens that slot's window — backpressure,
        never a stall). Returns False — withOUT dispatching anything —
        when NO slot drafted a single token: the caller then runs the
        plain decode step, so draftless iterations keep the k=0
        economics (flash-decode HBM clamp included) instead of paying
        a wasted k+1-wide dense verify window."""
        k = self.spec_k
        drafts: dict[int, list[int]] = {}
        t0 = time.perf_counter()
        total_drafted = 0
        for slot, req in active:
            # Window caps: never draft past the request's remaining
            # output (the emission a+1 must not overshoot
            # max_new_tokens) nor the slot row's last writable position.
            cap = min(k, req.max_new_tokens - len(req.tokens) - 1,
                      self.backend.max_len - req.write_pos - 1)
            d: list[int] = []
            if cap > 0:
                t_d = time.perf_counter()
                try:
                    d = [int(t) for t in self._draft.propose(
                        req.prompt + req.tokens, cap)][:cap]
                except Exception:  # noqa: BLE001 — drafting is an
                    # optimization; a broken provider costs acceptance,
                    # never correctness or the loop
                    log.exception("draft provider failed (request %s)",
                                  req.id)
                    d = []
                req.draft_s += time.perf_counter() - t_d
            if self.paged and d:
                ok = 0
                for i in range(len(d)):
                    if self._ensure_block(slot, req.write_pos + 1 + i):
                        ok += 1
                    else:
                        break
                d = d[:ok]
            drafts[slot] = d
            total_drafted += len(d)
        if not total_drafted:
            return False  # nothing to verify — plain decode step
        # the drafting span lands in the flight recorder like every
        # other serving stage
        events.completed_span("serve_draft",
                              time.perf_counter() - t0,
                              rows=total_drafted)
        props = self._step_with_isolation(
            lambda slots: self.backend.verify(
                slots, {s: drafts.get(s, []) for s in slots}, k),
            stage="spec_verify")
        if props is None:
            return True  # every occupant evicted — nothing to fall to
        self.stats["steps"] += 1
        self.stats["spec_verifies"] += 1
        for slot, req in active:
            if req.state != RUNNING or req._block_stalled:
                continue  # evicted mid-isolation / sat this one out
            prop = [int(t) for t in props[slot]]
            d = drafts.get(slot, [])
            a = 0
            while a < len(d) and prop[a] == d[a]:
                a += 1
            self.stats["spec_tokens_accepted"] += a
            self.stats["spec_tokens_rejected"] += len(d) - a
            if d:
                req.spec_windows += 1
                req.spec_drafted += len(d)
                req.spec_accepted += a
                self._metric("counter", "serving_spec_tokens_accepted",
                             a)
                self._metric("counter", "serving_spec_tokens_rejected",
                             len(d) - a)
            emit = prop[:a + 1]
            self._metric("histogram", "serve_spec_accept_len",
                         float(len(emit)), buckets=self._spec_buckets)
            delivered, last = 0, None
            for t in emit:
                if req.state != RUNNING or \
                        self._should_cancel(req, self._now()):
                    # retired (EOS / length), cancelled, or past its
                    # deadline mid-verify-window: stop emitting — the
                    # reaper at the next iteration boundary finishes a
                    # cancel/deadline victim without streaming more
                    break
                self._deliver(req, t)
                req.write_pos += 1
                delivered += 1
                last = t
            if delivered and req.state == RUNNING:
                # Frontier advance past the committed rows; a retired
                # request's slot was already released (reset) by
                # _retire, so committing it would corrupt the next
                # occupant's fill state.
                self.backend.commit_spec(slot, delivered, last)
        return True

    # -- paged-mode block growth / backpressure ---------------------------
    def _ensure_block(self, slot: int, pos: int) -> bool:
        """``backend.ensure_block_for`` under the ``serve_alloc`` chaos
        site: an injected serving-fatal fault (``cache_lost``)
        propagates to step()'s failover seam; any other injected or
        organic allocator error degrades to False — the block-stall
        backpressure path, never a crash."""
        try:
            chaos_lib.fire("serve_alloc", batch=slot)
            return bool(self.backend.ensure_block_for(slot, pos))
        except Exception as e:  # noqa: BLE001 — alloc faults backpressure
            if getattr(e, "serving_fatal", False):
                raise
            log.warning("ensure_block_for(%s, %s) failed: %s: %s",
                        slot, pos, type(e).__name__, e)
            return False

    def _filter_block_stalled(self, active):
        """Secure a writable frontier block for every RUNNING slot
        (oldest admitted first — FIFO priority when blocks are scarce).
        Slots the pool cannot serve are flagged ``_block_stalled`` and
        sit the decode step out; if EVERY running slot stalls, the
        newest-admitted one is preempted (released + requeued for a
        recompute resume) so the others can make progress — exhaustion
        never evicts work, the worst case is a deferred request."""
        ordered = sorted(active,
                         key=lambda sr: (sr[1].t_admit or 0.0, sr[1].id))
        ok, stalled = [], []
        now = time.perf_counter()
        for slot, req in ordered:
            req._block_stalled = False
            if self._ensure_block(slot, req.write_pos):
                self._end_block_stall(req, now)
                ok.append((slot, req))
            else:
                req._block_stalled = True
                if req._block_stall_t0 is None:
                    req._block_stall_t0 = now  # stall interval opens
                stalled.append((slot, req))
                self.stats["block_stall_events"] += 1
        if stalled and not ok:
            victim = self._preempt_newest(stalled)
            # the victim's blocks are free now: give the survivors one
            # immediate retry instead of a wasted iteration
            for slot, req in stalled:
                if req is victim:
                    continue
                if self._ensure_block(slot, req.write_pos):
                    req._block_stalled = False
                    self._end_block_stall(req, time.perf_counter())
                    ok.append((slot, req))
        return sorted(ok)

    @staticmethod
    def _end_block_stall(req: Request, now: float):
        """Close an open block-stall interval into the request's phase
        ledger (the trace collector reads the total off the retirement
        span)."""
        if req._block_stall_t0 is not None:
            req.block_stall_s += max(0.0, now - req._block_stall_t0)
            req._block_stall_t0 = None

    def _preempt_newest(self, stalled) -> Request:
        """Deadlock breaker: requeue (front, FIFO-fair) the NEWEST
        stalled request. Its blocks free immediately; on re-admission
        it prefills ``prompt + tokens-so-far`` and continues — greedy
        output is unchanged (the recompute writes the identical K/V),
        already-streamed tokens are never re-emitted."""
        victim = max((r for _, r in stalled),
                     key=lambda r: (r.t_admit or 0.0, r.id))
        slot = victim.slot
        with self._work:
            if slot is not None and self._slots[slot] is victim:
                self._slots[slot] = None
            self._queue.appendleft(victim)
            self._work.notify_all()
        self._release_slot(slot)
        now = time.time()
        self._end_block_stall(victim, time.perf_counter())
        # the aborted stint's decode-phase wall: without it the trace
        # collector would book this time as unattributed (the final
        # serve_decode span only covers the LAST stint)
        stint_decode_s = max(0.0, now - getattr(victim, "t_decode_start",
                                                now))
        victim.slot = None
        victim.state = QUEUED
        victim.chunk_plan = None
        victim._block_stalled = False
        victim.preemptions += 1
        victim.t_enqueue = now  # new queued stint begins
        self.stats["preemptions"] += 1
        events.event("serve_request_preempted", request=victim.id,
                     generated=len(victim.tokens),
                     decode_s=round(stint_decode_s, 6),
                     **_req_trace(victim))
        self._metric("counter", "serving_requests_preempted_total")
        return victim

    def _export_pool_metrics(self):
        if not telemetry.enabled():
            return
        ps = self.backend.pool_stats()
        self._metric("gauge", "serving_kv_blocks_free",
                     ps.get("blocks_free", 0))
        self._metric("gauge", "serving_kv_blocks_shared",
                     ps.get("blocks_shared", 0))
        # How many pool blocks the configured kv dtype
        # bought at this budget (pool_blocks incl. the trash block;
        # named so a dashboard can overlay int8 vs f32 runs at equal
        # SPARKDL_SERVE_KV_POOL_MB).
        self._metric("gauge", "kv_pool_effective_blocks",
                     ps.get("effective_blocks", ps.get("blocks_total", 0)))
        drain = getattr(self.backend, "drain_alloc_samples", None)
        if drain is not None:
            for dt in drain():
                self._metric("histogram", "serving_block_alloc_s", dt,
                             buckets=_ALLOC_BUCKETS)

    def _deliver(self, req: Request, tok: int):
        req.tokens.append(tok)
        self.stats["tokens_out"] += 1
        self._metric("counter", "serving_tokens_total")
        now = time.time()
        if self._awaiting_recovery and req.failovers:
            # recovery_s = fault-to-first-resumed-token (the
            # survivability headline a bench reads off the snapshot)
            self._failover_info["last_recovery_s"] = max(
                0.0, now - (self._t_fault or now))
            self._awaiting_recovery = False
        if req.t_first_token is None:
            req.t_first_token = now
            self._metric("histogram", "serving_ttft_s",
                         now - req.t_submit)
            sentinel_lib.observe("ttft", now - req.t_submit)
        if req.stream_cb is not None:
            try:
                req.stream_cb(req, tok)
            except Exception:  # noqa: BLE001 — a client callback must
                self.stats["callback_errors"] += 1  # never kill the loop
                log.exception("serve stream callback failed (request %s)",
                              req.id)
        # Exactly-once delivery cursor: every token is appended +
        # streamed in this one place, so cursor == len(tokens) always —
        # a failover that re-emitted (or a resume that skipped) a token
        # would break the invariant, which is exactly what the chaos
        # smoke's cursor audit checks.
        req.delivered = len(req.tokens)
        if self.eos_id is not None and tok == self.eos_id:
            self._retire(req, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._retire(req, "length")

    def _close_request_span(self, req: Request, finish: str):
        """Land the request's causal-envelope span: one
        ``serve_request`` span covering submit→done, carrying the
        admission span id every other emission for this request parents
        under, itself parented at the submitter's context (or the
        env-shipped gang-attempt span). Only when tracing is armed — and
        deliberately WITHOUT an ``error`` attr even for quarantines:
        merge_timeline reads error-bearing records as failure evidence,
        and a per-request quarantine already narrates itself via
        ``serve_request_quarantined``."""
        if not req.span_id or req.t_done is None:
            return
        kw: dict = {"request": req.id, "finish": finish,
                    "span_id": req.span_id}
        if req.parent_span:
            kw["parent_id"] = req.parent_span
        events.completed_span("serve_request",
                              max(0.0, req.t_done - req.t_submit), **kw)

    def _release_slot(self, slot: int | None):
        if slot is None:
            return
        release = getattr(self.backend, "release", None)
        if release is not None:
            try:
                release(slot)
            except Exception:  # noqa: BLE001 — cleanup must not mask
                log.exception("backend.release(%s) failed", slot)

    def _retire(self, req: Request, reason: str):
        with self._work:
            if req.slot is not None and self._slots[req.slot] is req:
                self._slots[req.slot] = None
            self._work.notify_all()
        self._release_slot(req.slot)
        req.state = DONE
        req.finish_reason = reason
        req.t_done = time.time()
        self.stats["completed"] += 1
        decode_s = req.t_done - getattr(req, "t_decode_start", req.t_admit)
        # Retirement span = the request's decode-phase wall, carrying
        # the per-request sub-phase ledger: draft/block-stall
        # seconds are carved out of the decode wall by the trace
        # collector, the speculation counters yield its mean accept
        # length. Only nonzero fields ride, keeping the stream lean.
        attrs: dict = {"request": req.id, "rows": len(req.tokens),
                       "reason": reason}
        if req.prefill_reused:
            attrs["reused"] = req.prefill_reused
        if req.draft_s > 0:
            attrs["draft_s"] = round(req.draft_s, 6)
        if req.block_stall_s > 0:
            attrs["block_stall_s"] = round(req.block_stall_s, 6)
        if req.spec_windows:
            attrs["spec_windows"] = req.spec_windows
            attrs["spec_drafted"] = req.spec_drafted
            attrs["spec_accepted"] = req.spec_accepted
        if req.preemptions:
            attrs["preemptions"] = req.preemptions
        attrs.update(_req_trace(req))
        events.completed_span("serve_decode", decode_s, **attrs)
        self._close_request_span(req, reason)
        self._metric("counter", "serving_requests_completed_total")
        self._metric("histogram", "serving_request_latency_s",
                     req.t_done - req.t_submit)
        if self._draft is not None:
            # retrieval providers (HistoryDraft) learn from completed
            # traffic; a broken observer costs future acceptance only
            obs = getattr(self._draft, "observe", None)
            if obs is not None:
                try:
                    obs(req.prompt, req.tokens)
                except Exception:  # noqa: BLE001
                    log.exception("draft observe failed (request %s)",
                                  req.id)
        req._done.set()

    # -- failure plumbing -------------------------------------------------
    # Chaos sites: every backend-call stage the watchdog
    # already names maps onto one of the serving fault-injection sites,
    # so the whole failover posture is provable on CPU. The rebuild
    # stage is deliberately absent — injecting into the recovery path
    # itself would recurse (the _failing_over latch guards regardless).
    _CHAOS_SITES = {
        "prefill": "serve_prefill", "prefill_chunk": "serve_prefill",
        "finish_prefill": "serve_prefill", "prefix_seed": "serve_alloc",
        "decode_step": "serve_decode", "spec_verify": "serve_decode",
    }

    def _timed(self, fn, stage: str):
        """Run one backend call under the optional stall watchdog (and
        the serving chaos sites — fired on the engine thread so an
        injected fault takes the organic error's exact control path)."""
        site = self._CHAOS_SITES.get(stage)
        if site is not None:
            self._backend_calls += 1
            chaos_lib.fire(site, step=self._backend_calls)
        if not self.stall_s or self.stall_s <= 0:
            return fn()
        if self._watch_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._watch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="sparkdl-serve-backend")
        fut = self._watch_pool.submit(fn)
        from concurrent.futures import TimeoutError as FutTimeout
        try:
            return fut.result(timeout=self.stall_s)
        except FutTimeout:
            # step()'s failover seam owns the stall (rebuild or fail
            # closed); raising is all the watchdog does now.
            raise ServingStallError(
                f"serving {stage} exceeded SPARKDL_SERVE_STALL_S="
                f"{self.stall_s:g}s") from None

    def _handle_fatal(self, exc: BaseException):
        """The serving supervisor: try to fail over —
        snapshot live requests, rebuild the backend, re-admit — and
        only when that is impossible (no ``backend.rebuild``, an
        ineligible error class, budget exhausted, or the rebuild itself
        died) fall back to the fail-closed posture: record ONE
        ``serve_engine_fatal`` event and fail everything pending.
        Idempotent and latch-guarded — a failure surfacing through
        several paths runs one recovery."""
        with self._lock:
            if self._fatal is not None or self._failing_over:
                return
            self._failing_over = True
        ok = False
        try:
            ok = self._can_failover(exc) and self._failover(exc)
        finally:
            with self._lock:
                if not ok and self._fatal is None:
                    self._fatal = exc
                self._failing_over = False
        if ok:
            return
        note = f": {self._fatal_note}" if self._fatal_note else ""
        events.event("serve_engine_fatal",
                     error=f"{type(exc).__name__}: {exc}"[:300] + note)
        self._fail_pending(EngineStopped(
            f"engine died{note}: {type(exc).__name__}: {exc}"))

    def _can_failover(self, exc: BaseException) -> bool:
        """Failover eligibility: only errors that mean the BACKEND
        STATE is gone/wedged (``serving_fatal``-flagged, or a stall-
        watchdog fire) — an arbitrary scheduler exception keeps the
        conservative fail-everything posture — and only when the
        backend can actually be rebuilt."""
        if not (getattr(exc, "serving_fatal", False)
                or isinstance(exc, ServingStallError)):
            return False
        return callable(getattr(self.backend, "rebuild", None))

    def _failover(self, cause: BaseException) -> bool:
        """One failover: budget/backoff accounting, snapshot + detach
        every live request, rebuild the backend (fresh slot cache /
        paged pool / prefix trie), re-admit the snapshots through the
        preemption-resume path (FIFO seniority preserved), quarantining
        individually any request that has personally survived
        ``failover_budget`` failovers without gaining a token. Returns
        False to fail closed."""
        budget = self.failover_budget
        if self.stats["tokens_out"] > self._tokens_at_failover >= 0:
            self._failover_streak = 0  # progress resets the streak
        self._failover_streak += 1
        self._tokens_at_failover = self.stats["tokens_out"]
        if self._failover_streak > budget:
            self._fatal_note = (
                f"failover budget exhausted "
                f"({FAILOVER_BUDGET_ENV}={budget})")
            self._failover_info.update(
                state="exhausted", streak=self._failover_streak,
                last_cause=f"{type(cause).__name__}: {cause}"[:200])
            return False
        t_fault = time.time()
        backoff = self.failover_backoff_s * (
            2 ** (self._failover_streak - 1))
        if backoff > 0:
            time.sleep(backoff)
        live = self._detach_all()
        # A stall-triggered failover leaves the wedged call sleeping in
        # the 1-worker watchdog pool — the rebuild must not queue behind
        # it. Abandon the pool (daemon worker; the in-flight guards make
        # a late return harmless) and let _timed lazily build a fresh
        # one around the rebuild.
        pool, self._watch_pool = self._watch_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        try:
            self._timed(self.backend.rebuild, "failover_rebuild")
        except Exception as e:  # noqa: BLE001 — rebuild died: fail closed
            self._fatal_note = (f"backend rebuild failed: "
                                f"{type(e).__name__}: {e}")
            self._failover_info.update(
                state="rebuild_failed", streak=self._failover_streak,
                last_cause=f"{type(cause).__name__}: {cause}"[:200])
            with self._work:
                # Put the detached snapshots back so the fail-closed
                # path (_fail_pending) reports them — never strand a
                # request in QUEUED with no engine working it.
                self._queue.extendleft(reversed(live))
                self._work.notify_all()
            return False
        resumed, keep = 0, []
        for r in live:
            prev = r._len_at_failover
            if prev is not None and len(r.tokens) <= prev:
                r.failovers += 1  # zero progress since the last one
            else:
                r.failovers = 1
            r._len_at_failover = len(r.tokens)
            if r.failovers > budget:
                r.failures = max(r.failures, r.failovers)
                self.stats["failover_quarantined"] += 1
                self._quarantine(r, cause)
                continue
            events.event("serve_request_failover", request=r.id,
                         generated=len(r.tokens), failovers=r.failovers,
                         **_req_trace(r))
            keep.append(r)
            resumed += 1
        with self._work:
            self._queue.extendleft(reversed(keep))
            self._work.notify_all()
        self.stats["failovers"] += 1
        self.stats["failover_resumed"] += resumed
        self._failover_info.update(
            state="recovered", count=self.stats["failovers"],
            streak=self._failover_streak,
            last_cause=f"{type(cause).__name__}: {cause}"[:200],
            last_t=t_fault,
            resumed_total=self.stats["failover_resumed"],
            quarantined_total=self.stats["failover_quarantined"],
            last_backoff_s=backoff, last_recovery_s=None)
        self._awaiting_recovery = True
        self._t_fault = t_fault
        events.event("serve_engine_failover",
                     error=f"{type(cause).__name__}: {cause}"[:300],
                     resumed=resumed,
                     quarantined=self.stats["failover_quarantined"],
                     streak=self._failover_streak)
        self._metric("counter", "serving_failovers_total")
        if resumed:
            self._metric("counter", "serving_requests_resumed_total",
                         resumed)
        log.warning("serving failover %s (streak %s/%s): %s — %s "
                    "request(s) re-admitted", self.stats["failovers"],
                    self._failover_streak, budget, cause, resumed)
        return True

    def _detach_all(self) -> list[Request]:
        """Pull every live request out of the queue and the slot table
        into resumable snapshot form (state QUEUED, slot released,
        chunk plan dropped — exactly the preemption-resume shape),
        preserving FIFO seniority: slot occupants (admitted earliest)
        first, then the queue in order. Shared by failover and
        drain."""
        with self._work:
            queued = list(self._queue)
            self._queue.clear()
            occupants = []
            for s, r in enumerate(self._slots):
                if r is not None:
                    occupants.append(r)
                    self._slots[s] = None
            self._work.notify_all()
        live: list[Request] = []
        now = time.time()
        for r in sorted(occupants, key=lambda r: (r.t_admit or 0.0, r.id)):
            slot, r.slot = r.slot, None
            self._release_slot(slot)
            if r.state in (DONE, FAILED):
                continue
            self._close_stint(r, now)
            r.state = QUEUED
            r.chunk_plan = None
            r._block_stalled = False
            self._end_block_stall(r, time.perf_counter())
            r.t_enqueue = now
            live.append(r)
        for r in queued:
            if r.state not in (DONE, FAILED):
                live.append(r)
        return live

    @staticmethod
    def _close_stint(req: Request, now: float):
        """Book the stint a detach cuts: a RUNNING request's decode wall
        since its prefill, a PREFILLING one's chunk compute and the rest
        of its wall since admission as the prefill's wait. Without it a
        request resumed elsewhere (a fleet's re-admission keeps the
        request and its id) leaves that time unattributed in its trace:
        its next serve_prefill and serve_decode cover only the new
        stint."""
        attrs: dict = {}
        if req.state == RUNNING:
            attrs["decode_s"] = round(max(0.0, now - getattr(
                req, "t_decode_start", now)), 6)
        elif req.state == PREFILLING:
            wall = max(0.0, now - (req.t_admit or now))
            attrs["prefill_s"] = round(req.prefill_spent_s, 6)
            attrs["wait_s"] = round(max(0.0, wall - req.prefill_spent_s), 6)
        if attrs:
            events.event("serve_request_detached", request=req.id,
                         generated=len(req.tokens), **attrs,
                         **_req_trace(req))

    def _fail_pending(self, err: EngineStopped):
        with self._work:
            pending = list(self._queue)
            self._queue.clear()
            for s, r in enumerate(self._slots):
                if r is not None:
                    pending.append(r)
                    self._slots[s] = None
            self._work.notify_all()
        for req in pending:
            if req.state in (DONE, FAILED):
                continue
            req.state = FAILED
            req.finish_reason = "error"
            req.error = err
            req.t_done = time.time()
            self.stats["failed"] += 1
            req._done.set()

    # -- introspection ----------------------------------------------------
    def debug_state(self) -> dict:
        """Live operator view: the slot table (state /
        request / write frontier / age / per-slot KV block footprint),
        queue depth + head age, KV pool and radix residency, and
        speculation acceptance — what ``introspect.serving_snapshot()``
        returns per engine. See
        :func:`serving.introspect.engine_debug_state`."""
        from .introspect import engine_debug_state
        return engine_debug_state(self)

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "queue_depth": len(self._queue),
                "slots_busy": sum(r is not None for r in self._slots),
                "num_slots": len(self._slots),
                "stall_free": self.stall_free,
                "prefill_chunk": self.prefill_chunk,
                "prefill_budget": self.prefill_budget,
                "paged": self.paged,
                "spec_k": self.spec_k,
                "tp_degree": self.tp_degree,
                "kv_pool_device_bytes": self.kv_pool_device_bytes,
                **dict(self.stats),
            }
            snap["failover"] = dict(self._failover_info)
            if self._front is not None:
                snap["front"] = dict(self._front.stats)
        ps = getattr(self.backend, "prefix_stats", None)
        if callable(ps):
            st = ps()
            if st:
                snap["prefix_cache"] = st
        if self.paged:
            pool = getattr(self.backend, "pool_stats", None)
            if callable(pool):
                snap["kv_pool"] = pool()
        return snap
