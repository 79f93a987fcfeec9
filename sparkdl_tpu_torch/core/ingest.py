"""Host-ingest layer: the host side of the scoring feed.

The port's copy of ``sparkdl_tpu/core/ingest.py``. Decode, pack, pad and
stage are host stages below the device boundary; this module owns them
so they can be exercised without touching a device. Its own imports are
numpy only (pyarrow inside the functions that read Arrow data), and
reaching it through the package imports no device state:

- **Decode backends**: the order-preserving decode pool
  (``runtime.parallel_map_iter``) runs on threads by default, which caps
  GIL-bound decode (the pure-python Arrow→NHWC fallback, PIL row resize)
  at one core however many workers are configured.
  ``SPARKDL_DECODE_BACKEND=process`` switches it to a shared
  ``ProcessPoolExecutor``; tasks must then be picklable, so the scorer
  ships self-contained chunk tasks (:func:`run_decode_task`) built from
  module-level factories + compacted Arrow chunk payloads.
- **Shared chunk-decode semantics**: :func:`decode_chunk` is the ONE copy
  of the chunk-then-row-fallback quarantine protocol so the thread and
  process backends cannot drift: a failing chunk decode is retried row by
  row, rows that still fail (or decode to a deviant shape) become dead
  letters, and the chaos ``decode`` site fires per chunk/row-attempt on
  whichever backend runs the decode.

The reference's reused staging buffers (``StagingPool``/``stage_batch``)
are not copied: the port's ``BatchRunner`` pads each batch in one write
into pinned memory from PyTorch's caching host allocator
(``runtime._pinned_pad``) on the card, and through ``runtime.pad_batch``
on the CPU.

Process-pool note: the default multiprocessing context is ``fork``
(children inherit the parent image — no per-child re-import; the child
work is numpy/pyarrow only). ``SPARKDL_DECODE_MP_CONTEXT=spawn`` trades
per-worker package import for a fork-free start, e.g. under runtimes
where forking a threaded process is unreliable (a process that has
initialised CUDA is one).
"""

from __future__ import annotations

import atexit
import collections
import itertools
import os
import threading
import time
from typing import Callable, Iterable

import numpy as np

DECODE_BACKEND_ENV = "SPARKDL_DECODE_BACKEND"
MP_CONTEXT_ENV = "SPARKDL_DECODE_MP_CONTEXT"
FUSED_PREPROCESS_ENV = "SPARKDL_FUSED_PREPROCESS"
MAX_WIRE_SHAPES_ENV = "SPARKDL_MAX_WIRE_SHAPES"


def _chaos():
    from sparkdl_tpu_torch.runner import chaos
    return chaos


def decode_backend_default() -> str:
    """Decode pool backend (``SPARKDL_DECODE_BACKEND``): ``thread``
    (default — right whenever decode releases the GIL: the native C++
    packer, PIL file decode) or ``process`` (GIL-bound decode: the
    pure-python pack fallback, python ``decode_fn``s — scales past the
    ~1-core thread ceiling at the cost of pickling chunks in and out)."""
    v = os.environ.get(DECODE_BACKEND_ENV, "thread").strip().lower()
    return v if v in ("thread", "process") else "thread"


def decode_mp_context_default() -> str:
    """Multiprocessing start method for the process decode pool
    (``SPARKDL_DECODE_MP_CONTEXT``; default ``fork``)."""
    v = os.environ.get(MP_CONTEXT_ENV, "fork").strip().lower()
    return v if v in ("fork", "spawn", "forkserver") else "fork"


def fused_preprocess_default() -> bool:
    """``SPARKDL_FUSED_PREPROCESS`` (default on): image feeds ship
    storage-dtype NHWC at the smaller of stored/target size and the
    device step does flip/cast/resize (see
    ``XlaImageTransformer``); ``0`` restores the host-side
    resize+flip+cast feed."""
    return os.environ.get(FUSED_PREPROCESS_ENV, "1").strip().lower() \
        not in ("0", "false", "no")


def decode_stall_default() -> float:
    """``SPARKDL_DECODE_TIMEOUT_S`` (default 600): stall watchdog on
    process-pool decode futures. Forking a threaded parent can
    deadlock a pool child (CPython's own fork warning); without a bound
    the stream would hang forever under DEFAULT settings, so unlike the
    dispatch/fetch watchdog this one is armed by default — generous
    enough that only a genuinely wedged child trips it. ``0`` disables;
    ``SPARKDL_DISPATCH_TIMEOUT_S``, when set, takes precedence so one
    knob can tighten the whole pipeline."""
    try:
        return float(os.environ.get("SPARKDL_DECODE_TIMEOUT_S", "600"))
    except ValueError:
        return 600.0


def decode_stall_resolved() -> float:
    """The EFFECTIVE stall bound for process-decode futures:
    ``SPARKDL_DISPATCH_TIMEOUT_S`` whenever it is SET — including an
    explicit ``0``, that knob's documented off value, which must win
    here rather than falling through a falsy-``or`` to the 600s decode
    default — else :func:`decode_stall_default`."""
    raw = os.environ.get("SPARKDL_DISPATCH_TIMEOUT_S")
    if raw not in (None, ""):
        try:
            return float(raw)
        except ValueError:
            pass
    return decode_stall_default()


def max_wire_shapes_default() -> int:
    """``SPARKDL_MAX_WIRE_SHAPES`` (default 8): how many distinct NATIVE
    wire sizes one image stage may ship in fused mode. Every distinct
    wire shape is one new signature of the device step (and on the card
    a new set of cuDNN algorithm searches) — a dataset ordered by source
    (per-directory dumps of many sizes) would otherwise re-plan
    unboundedly where the host-pack feed compiled
    once. Sizes past the cap pack at the target shape instead."""
    try:
        return max(0, int(os.environ.get(MAX_WIRE_SHAPES_ENV, "8")))
    except ValueError:
        return 8


# ---------------------------------------------------------------------------
# The submit-ahead window (shared: runtime's feed paths AND the bench)
# ---------------------------------------------------------------------------

def windowed_apply(fn: Callable, items: Iterable, depth: int, workers: int,
                   thread_prefix: str = "", executor=None,
                   stall_s: float = 0.0, stall_stage: str = "decode"):
    """THE submit-ahead window (one copy: the device put feed, the decode
    pool, run_stream's put stage, and ``scripts/ingest_bench.py`` all
    ride it): apply ``fn`` to each item keeping up to ``depth`` results
    in flight ahead of the consumer, yielding strictly in input order.

    ``workers <= 0`` applies inline — with ``depth > 0`` results are still
    produced ahead into the window (right for async-returning fns like
    ``device_put``: the transfer proceeds while earlier results are
    consumed), with ``depth <= 0`` it is a plain lazy map. ``workers > 0``
    submits to a thread pool with in-flight depth ``max(depth, workers)``
    (idle threads would defeat the knob); exceptions re-raise at the
    consumption point, and closing the generator cancels un-started work.
    ``executor``: submit to this SHARED executor (the process decode
    pool) instead of owning a fresh thread pool — same window, same
    ordering, but only pending futures are cancelled on close, the
    executor itself stays up for the next stream.

    ``stall_s > 0`` arms a stall watchdog on each future wait (the
    ``SPARKDL_DISPATCH_TIMEOUT_S`` posture): a worker that never
    completes — e.g. a pool child deadlocked by forking a threaded
    parent — surfaces as a classified ``ScoringStallError`` naming
    ``stall_stage`` instead of hanging the stream forever.
    """
    it = iter(items)
    window: collections.deque = collections.deque()
    sentinel = object()
    if executor is None and workers <= 0:
        if depth <= 0:
            for item in it:
                yield fn(item)
            return
        for item in itertools.islice(it, depth):
            window.append(fn(item))
        while window:
            out = window.popleft()
            nxt = next(it, sentinel)
            if nxt is not sentinel:
                window.append(fn(nxt))
            yield out
        return
    depth = max(depth, workers, 1)
    if executor is not None:
        pool, own_pool = executor, False
    else:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=workers,
                                  thread_name_prefix=thread_prefix)
        own_pool = True

    def _await(fut):
        if stall_s and stall_s > 0:
            import concurrent.futures as cf
            try:
                return fut.result(timeout=stall_s)
            except cf.TimeoutError:
                from sparkdl_tpu_torch.runner import failures
                raise failures.ScoringStallError(stall_stage, stall_s) \
                    from None
        return fut.result()

    try:
        for item in itertools.islice(it, depth):
            window.append(pool.submit(fn, item))
        while window:
            fut = window.popleft()
            nxt = next(it, sentinel)
            if nxt is not sentinel:
                window.append(pool.submit(fn, nxt))
            yield _await(fut)
    finally:
        for f in window:
            f.cancel()
        if own_pool:
            pool.shutdown(wait=False, cancel_futures=True)


# ---------------------------------------------------------------------------
# Shared chunk-decode semantics (thread AND process backends)
# ---------------------------------------------------------------------------

def decode_chunk(decoder: Callable, start: int, length: int,
                 quarantine: bool):
    """Decode one chunk through ``decoder(start, length)``.

    Returns ``(array_or_None, info)``: ``info`` is ``None`` in raise mode
    (exceptions propagate); in quarantine mode it is ``{"length": n,
    "dead": [(row, error_class, message), ...]}`` with row indices in
    ``decoder``'s index space. The chaos ``decode`` site fires per chunk
    attempt and per row-fallback attempt, exactly as the pre-process-pool
    scorer did — the ONE copy of the protocol, so the two backends
    cannot drift."""
    if not quarantine:
        _chaos().fire("decode")
        return decoder(start, length), None
    try:
        _chaos().fire("decode")
        return decoder(start, length), {"length": length, "dead": []}
    except Exception:  # noqa: BLE001 — row fallback re-derives
        return _decode_rows(decoder, start, length)


def _decode_rows(decoder: Callable, start: int, length: int):
    """Row-level quarantine fallback: re-decode the failed chunk one row
    at a time; rows that still raise — or decode clean but with a deviant
    trailing shape that would crash the batch concat or recompile the
    program — are dead-lettered instead of killing the stream."""
    arrs, rows, dead = [], [], []
    for j in range(start, start + length):
        try:
            _chaos().fire("decode")
            arrs.append(decoder(j, 1))
            rows.append(j)
        except Exception as e:  # noqa: BLE001 — becomes the dead letter
            dead.append((j, type(e).__name__, str(e)))
    if arrs:
        modal = collections.Counter(
            a.shape[1:] for a in arrs).most_common(1)[0][0]
        kept = [(a, r) for a, r in zip(arrs, rows)
                if a.shape[1:] == modal]
        dead.extend((r, "ShapeMismatch",
                     f"row decodes to shape {a.shape[1:]}, chunk "
                     f"decodes to {modal}")
                    for a, r in zip(arrs, rows) if a.shape[1:] != modal)
        arrs = [a for a, _ in kept]
    dead.sort()
    arr = np.concatenate(arrs, axis=0) if arrs else None
    return arr, {"length": length, "dead": dead}


# ---------------------------------------------------------------------------
# Process decode pool
# ---------------------------------------------------------------------------

_POOL = None
_POOL_KEY: tuple | None = None
_POOL_USERS = 0
_POOL_LOCK = threading.Lock()


def _ensure_pool_locked(key: tuple):
    """Caller holds ``_POOL_LOCK``. Ensure the shared pool matches
    ``key`` — rebuilt only when the key changed AND no stream currently
    holds the pool: tearing down a live pool would cancel a concurrent
    stream's in-flight decode futures outside the quarantine protocol.
    A mismatched request while the pool is in use rides the existing
    pool (worker count is a throughput knob, never a semantic one).
    A BROKEN pool (a child died — BrokenProcessPool poisons the executor
    permanently) is always replaced, held or not: its holders' futures
    have already failed, and caching it would fail every process-backend
    stream until the interpreter restarts. Returns the replaced pool
    (caller shuts it down OUTSIDE the lock)."""
    global _POOL, _POOL_KEY
    broken = _POOL is not None and bool(getattr(_POOL, "_broken", False))
    if _POOL is not None and not broken \
            and (_POOL_KEY == key or _POOL_USERS > 0):
        return None
    old = _POOL
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    ctx = multiprocessing.get_context(key[1])
    _POOL = ProcessPoolExecutor(max_workers=key[0], mp_context=ctx)
    _POOL_KEY = key
    return old


def get_decode_executor(workers: int):
    """The process-wide shared decode ``ProcessPoolExecutor`` (children
    are expensive — one pool serves every stream); see
    :func:`_ensure_pool_locked` for the rebuild policy."""
    key = (max(1, int(workers)), decode_mp_context_default())
    with _POOL_LOCK:
        old = _ensure_pool_locked(key)
        pool = _POOL
    if old is not None:
        old.shutdown(wait=False, cancel_futures=True)
    return pool


def acquire_decode_executor(workers: int):
    """``get_decode_executor`` + a hold: the pool will not be rebuilt out
    from under the caller until :func:`release_decode_executor`. Streams
    (``runtime.parallel_map_iter``) bracket their whole consumption with
    acquire/release. Lookup and hold are ONE critical section — a
    two-step get-then-increment would let a concurrent mismatched
    request tear the pool down in the gap."""
    global _POOL_USERS
    key = (max(1, int(workers)), decode_mp_context_default())
    with _POOL_LOCK:
        old = _ensure_pool_locked(key)
        _POOL_USERS += 1
        pool = _POOL
    if old is not None:
        old.shutdown(wait=False, cancel_futures=True)
    return pool


def release_decode_executor():
    global _POOL_USERS
    with _POOL_LOCK:
        _POOL_USERS = max(0, _POOL_USERS - 1)


def invalidate_decode_executor(pool) -> None:
    """Evict ``pool`` from the shared slot, held or not — the next
    request builds a fresh executor. Called on a decode STALL: a
    wedged-but-alive child never sets ``_broken``, so without eviction
    its worker slot is lost until interpreter restart and every retry
    re-stalls the full watchdog budget on the same pool. Any concurrent
    stream's in-flight futures on this pool were already doomed by the
    same wedge. No-op when the slot holds a different (newer) pool."""
    global _POOL, _POOL_KEY, _POOL_USERS
    with _POOL_LOCK:
        if _POOL is not pool:
            return
        _POOL, _POOL_KEY = None, None
        _POOL_USERS = 0
    pool.shutdown(wait=False, cancel_futures=True)


def shutdown_decode_executor():
    global _POOL, _POOL_KEY, _POOL_USERS
    with _POOL_LOCK:
        pool, _POOL, _POOL_KEY = _POOL, None, None
        _POOL_USERS = 0
    if pool is not None:
        pool.shutdown(wait=False, cancel_futures=True)


atexit.register(shutdown_decode_executor)


_CHAOS_INSTALLED: str | None = "\0never"  # sentinel != any real value


def _install_chaos(text: str | None):
    """Child-side chaos arming: the parent ships its active plan's JSON
    with every task (a pool forked before the plan was installed would
    otherwise never see it). Cached by text — re-installing per task
    would reset in-memory once-state; cross-PROCESS once-semantics need
    the plan's ``state_dir`` markers, exactly as supervised gang
    restarts do."""
    global _CHAOS_INSTALLED
    if text == _CHAOS_INSTALLED:
        return
    chaos = _chaos()
    cur = chaos.active_plan()
    if (cur.to_json() if cur is not None else None) == text:
        # Already armed with this exact plan — the inline (workers=0)
        # path and fork-after-install children land here; re-installing
        # would discard the live plan's in-memory once-state.
        _CHAOS_INSTALLED = text
        return
    if text:
        chaos.install(chaos.FaultPlan.from_json(text))
    else:
        chaos.uninstall()
    _CHAOS_INSTALLED = text


def run_decode_task(task: tuple):
    """Module-level (picklable) decode-task entry for the process pool.

    ``task = (factory, payload, length, quarantine, chaos_json)``:
    ``factory(payload, row_start, row_len)`` decodes rows of ONE chunk
    (chunk-local indices — the parent re-bases dead-letter rows onto the
    partition). Returns ``(arr, info, dur_s)``; ``dur_s`` lets the parent
    land a ``decode`` span in ITS flight recorder (the child's ring dies
    with the child)."""
    factory, payload, length, quarantine, chaos_json = task
    _install_chaos(chaos_json)
    t0 = time.perf_counter()
    arr, info = decode_chunk(
        lambda s, n: factory(payload, s, n), 0, length, quarantine)
    return arr, info, time.perf_counter() - t0


# -- picklable chunk factories (module-level by necessity) -------------------

def decode_image_chunk(payload: tuple, start: int, length: int) -> np.ndarray:
    """Image-column chunk factory: ``payload = (struct_chunk, h, w, order,
    dtype_name, fused, native_ok)`` where ``struct_chunk`` is the
    COMPACTED Arrow slice for this chunk (so pickling ships only the
    chunk's bytes) and ``native_ok`` is the parent's wire-shape-budget
    verdict (children are stateless — the budget lives in the parent)."""
    col, h, w, order, dtype_name, fused, native_ok = payload
    from sparkdl_tpu_torch.image import imageIO
    sl = col if (start, length) == (0, len(col)) \
        else col.slice(start, length)
    return imageIO.imageColumnFeed(sl, h, w, dtype=np.dtype(dtype_name),
                                   channelOrder=order, fused=fused,
                                   native_ok=native_ok)


def decode_array_chunk(payload: tuple, start: int, length: int) -> np.ndarray:
    """Array-column chunk factory: ``payload = (list_chunk, shape)``."""
    col, shape = payload
    sl = col if (start, length) == (0, len(col)) \
        else col.slice(start, length)
    return columnToNdarray(sl, shape)


def columnToNdarray(column, shape: tuple | None,
                    dtype=np.float32, atleast_2d: bool = False) -> np.ndarray:
    """list<float> / primitive column → (N, *shape) contiguous array.

    ``atleast_2d``: promote a plain numeric column to (N, 1) — callers
    that treat rows as vectors (feature stages) set this so scalar
    columns work wherever vector columns do. (Lives here — below the
    transformers layer, no torch in this module's imports — so the
    process decode pool's children run it without dragging in device
    state.)"""
    import pyarrow as pa
    if isinstance(column, pa.ChunkedArray):
        column = column.combine_chunks()
    if (pa.types.is_list(column.type)
            or pa.types.is_large_list(column.type)
            or pa.types.is_fixed_size_list(column.type)):
        flat = column.flatten().to_numpy(zero_copy_only=False).astype(dtype)
        n = len(column)
        if shape:
            return np.ascontiguousarray(flat.reshape((n,) + tuple(shape)))
        if n and flat.size % n:
            raise ValueError(f"Ragged array column: {flat.size} values over "
                             f"{n} rows")
        return np.ascontiguousarray(flat.reshape(n, -1) if n else
                                    flat.reshape(0, 0))
    arr = column.to_numpy(zero_copy_only=False).astype(dtype)
    if shape:
        return arr.reshape((len(arr),) + tuple(shape))
    return arr[:, None] if atleast_2d else arr
