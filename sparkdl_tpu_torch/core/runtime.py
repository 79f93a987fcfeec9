"""Device runtime of the port: the scoring feed, the batch runner, call
signatures and the compiled decode step.

The counterpart of ``sparkdl_tpu/core/runtime.py`` (that module imports
jax), in the parts the port's callers reach:

- host-side feed helpers: :func:`pad_batch`, :func:`background_iter`,
  :func:`parallel_map_iter` (the order-preserving decode pool) and the
  dispatch retry / timeout defaults;
- :class:`BatchRunner`, the execution engine behind every image
  transformer: it pads host batches to one static batch size, copies them
  to the device (pinned host memory, ``non_blocking`` on a side stream
  ordered by events), runs one step ``fn(preprocess(cast(batch)))`` and
  brings the outputs back through pinned buffers whose copy starts at
  dispatch, keeping a window of batches in flight;
- :func:`resize_nhwc`, the counterpart of ``jit_resize_nhwc``
  (``jax.image.resize(method="bilinear")``, antialiased when it
  downscales);
- ``CompileCache`` / ``GLOBAL_COMPILE_CACHE`` (``note``, ``snapshot``,
  ``signatures``) and ``get``, the counterpart of the reference's jit
  wrapper: where the reference compiles a step into one XLA program per
  signature, ``get`` captures it into one CUDA graph per signature and
  replays it (:class:`StepGraph`).

- :func:`make_mesh`, a named ``DeviceMesh`` over the process's
  ``torch.distributed`` gang (one process a device).

The sharded feed (``BatchRunner(mesh=)``): every rank of a ``{"data":
n}`` mesh runs its contiguous share of each padded batch, and the
outputs are all-gathered, so every rank yields the whole batch (the
reference's global array). The persistent compile cache has no
counterpart (nothing is compiled ahead of a call).
"""

from __future__ import annotations

import collections
import gc
import itertools
import os
import queue as queue_mod
import threading
import time
from typing import Callable, Iterable, Iterator

import numpy as np

from . import ingest


def make_mesh(axes: dict[str, int] | None = None):
    """A named ``torch.distributed.device_mesh.DeviceMesh`` over the
    process's gang — the group ``XlaRunner`` joined from
    ``launcher.launch``'s env (NCCL on the card, gloo on the CPU).

    ``axes`` maps axis name → size, e.g. ``{"sp": 8}`` or ``{"data": 2,
    "model": 2, "sp": 2}``, outermost first; one size may be ``-1``,
    "whatever is left". Default: one ``data`` axis over the gang. The
    sizes must multiply to the gang's size (``ValueError`` otherwise, and
    with no process group at all: one process drives one device here).
    The mesh's device is ``cuda`` under NCCL and ``cpu`` under gloo.
    Every rank must call it, in the same order as any other collective:
    each axis's subgroup is made here."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "make_mesh needs a torch.distributed gang, one process a "
            "device: start the processes with sparkdl_tpu_torch.runner."
            "launcher.launch(script, np=N) and join it with XlaRunner() in "
            "each (or pass XlaRunner coordinator=, num_processes=, "
            "process_id=). One process driving several devices (the "
            "reference's single controller) is not torch's form "
            "(ROADMAP.md, Queue C 2)")
    world = dist.get_world_size()
    if axes is None:
        axes = {"data": world}
    names, sizes = list(axes.keys()), [int(s) for s in axes.values()]
    if sizes.count(-1) > 1:
        raise ValueError("At most one mesh axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if world % known:
            raise ValueError(f"{world} devices not divisible by {known}")
        sizes[sizes.index(-1)] = world // known
    total = math.prod(sizes)
    if total != world:
        raise ValueError(
            f"Mesh axes {dict(zip(names, sizes))} need {total} devices, "
            f"have {world}: the gang has {world} processes, one a device "
            f"(start {total} with sparkdl_tpu_torch.runner.launcher."
            f"launch(script, np={total}))")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(names))


def _events():
    from ..runner import events
    return events


def _chaos():
    from ..runner import chaos
    return chaos


def _failures():
    from ..runner import failures
    return failures


def _run_stats():
    from ..runner import metrics
    return metrics.run_stats


def _telemetry():
    from ..runner import telemetry
    return telemetry


_CAPTURE_LOCK = threading.Lock()


class StepGraph:
    """One S = 1 step, ``fn(*inputs) -> tensor``, run from static input
    buffers to a static output.

    On a CUDA device the first call runs ``fn`` once eagerly on the
    current stream (a real step, whose output it returns: it allocates
    what the kernels keep across calls outside the graph's memory pool,
    and loads cuBLAS), then captures ``fn`` into a CUDA graph; every later
    call copies its inputs into the static buffers and replays the graph.
    The output is then the graph's own tensor, valid until the next call.

    Several engines may step on several threads at once (a fleet's
    replicas on one card). So captures are serialised by one process-wide
    lock (they share PyTorch's capture stream), a capture errors only on
    what its own thread does (``capture_error_mode="thread_local"``: the
    other threads go on launching and allocating), and the eager step
    runs on the current stream, where the other threads' steps run too:
    the decode kernels' merge counters are shared by calls of one shape,
    which must not run at once.

    On the CPU (the CPU mode, taken only for CPU tensors) every call
    copies its inputs into the same static buffers and calls ``fn`` on
    them eagerly: the arithmetic the graph replays, with the same buffer
    plumbing, so the CPU tests hold both.

    ``counters``: the kernel wrappers whose ``launches`` count their CUDA
    launches. Capture launches nothing, so the counts it adds are taken
    into a tally of the capturing thread alone (``ops._build.
    capture_tally``), and each replay adds what the capture counted: a
    replayed step counts the launches an eager step would. A capture or
    replay that fails raises; nothing falls back to the eager step."""

    def __init__(self, fn, inputs, counters=()):
        self.fn = fn
        self.counters = tuple(counters)
        self.static = tuple(None if t is None else t.clone() for t in inputs)
        self.device = next(t.device for t in inputs if t is not None)
        self.graph = None
        self.out = None
        self.launches = (0,) * len(self.counters)
        self.capture_ms = None

    def _load(self, inputs) -> None:
        if len(inputs) != len(self.static):
            raise ValueError(f"step takes {len(self.static)} inputs, got "
                             f"{len(inputs)}")
        for buf, t in zip(self.static, inputs):
            if (buf is None) != (t is None) or (
                    buf is not None and buf.shape != t.shape):
                raise ValueError("step inputs differ from the captured "
                                 "signature")
            if buf is not None:
                buf.copy_(t)

    def __call__(self, inputs):
        self._load(inputs)
        if self.device.type != "cuda":
            return self.fn(*self.static)
        if self.graph is None:
            return self._capture()
        self.graph.replay()
        from ..ops import _build
        for c, n in zip(self.counters, self.launches):
            _build.count_launch(c, n)
        return self.out

    def _capture(self):
        import torch

        from ..ops import _build

        with torch.cuda.device(self.device):
            first = self.fn(*self.static)
            # No collection while capturing: a collection there may free
            # an unreachable step's graph (a dropped engine's), whose
            # reset the capturing thread may not call, and the capture is
            # lost. Garbage waits for the next collection outside.
            collecting = gc.isenabled()
            gc.disable()
            try:
                with _CAPTURE_LOCK, _build.capture_tally() as tally:
                    t0 = time.perf_counter()
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph,
                                          capture_error_mode="thread_local"):
                        out = self.fn(*self.static)
                    self.capture_ms = (time.perf_counter() - t0) * 1e3
            finally:
                if collecting:
                    gc.enable()
            self.launches = tuple(tally.get(c, 0) for c in self.counters)
        self.graph, self.out = graph, out
        return first


class CompileCache:
    """Call signatures noted by name, with hit/miss counters, and the
    captured steps of :meth:`get`.

    The serving backends note each slot call's operand shapes, and "the
    decode step keeps one signature for an engine's lifetime" stays an
    observable, as in the JAX package. A cache that :meth:`get` fills
    holds graphs that point into the tensors their steps were captured
    on, so its owner keeps it as long as those tensors and drops it
    (:meth:`drop`) when they are replaced."""

    def __init__(self):
        self._keys: dict[str, set] = {}
        self._steps: dict = {}
        self._lock = threading.Lock()
        self.misses = 0
        self.hits = 0
        self.captures = 0
        self.replays = 0

    def note(self, name: str, key) -> bool:
        """Record one call signature; True when it is NEW for ``name``.

        Every new (fn, signature) pair becomes a flight-recorder
        ``recompile`` event (the JAX package's name for it), so a
        signature storm shows in traces."""
        with self._lock:
            seen = self._keys.setdefault(name, set())
            if key in seen:
                self.hits += 1
                return False
            seen.add(key)
            self.misses += 1
            misses = self.misses
        _events().event("recompile", fn=name, misses=misses,
                        shapes=str(key)[:200])
        return True

    def get(self, name: str, key, fn, inputs, counters=()):
        """Run one step ``fn(*inputs)`` through the :class:`StepGraph`
        kept under ``(name, key)``, made on the first call. ``key`` is
        the step's signature and names the tensors ``fn`` reads besides
        its inputs (the cache), so a step never replays against other
        tensors than those it was captured on. Each capture becomes a
        flight-recorder ``graph_capture`` event with its time."""
        self.note(name, key)
        with self._lock:
            step = self._steps.get((name, key))
            new = step is None
            if new:
                step = self._steps[(name, key)] = StepGraph(fn, inputs,
                                                            counters)
        try:
            out = step(inputs)
        except BaseException:
            if new:  # a failed capture leaves no half-made step behind
                with self._lock:
                    self._steps.pop((name, key), None)
            raise
        with self._lock:
            if new and step.capture_ms is not None:
                self.captures += 1
            elif not new and step.graph is not None:
                self.replays += 1
        if new and step.capture_ms is not None:
            _events().event("graph_capture", fn=name,
                            ms=round(step.capture_ms, 3),
                            shapes=str(key)[:200])
        return out

    def drop(self) -> None:
        """Forget every captured step, releasing its graph and memory
        pool: the tensors they were captured on are being replaced."""
        with self._lock:
            self._steps.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "captures": self.captures, "replays": self.replays}

    def signatures(self, name: str) -> int:
        """How many distinct call signatures ``name`` has seen — the
        re-trace observable (the serving bench pins "no decode-step
        re-trace after warmup" as ``signatures('serve_decode_step')``
        staying constant across the measured run)."""
        with self._lock:
            return len(self._keys.get(name, ()))


GLOBAL_COMPILE_CACHE = CompileCache()


# ---------------------------------------------------------------------------
# Batch padding (one static batch size per runner)
# ---------------------------------------------------------------------------

def pad_batch(arrays: dict[str, np.ndarray] | np.ndarray, batch_size: int):
    """Pad leading dim up to ``batch_size``; returns (padded, n_valid).

    Padding replicates row 0 (not zeros) so that models with
    normalization/pooling never see degenerate inputs; validity is tracked by
    count and the pad rows are sliced off after the computation.
    """
    single = not isinstance(arrays, dict)
    d = {"x": arrays} if single else arrays
    n = next(iter(d.values())).shape[0]
    if n > batch_size:
        raise ValueError(f"Batch of {n} rows exceeds batch size {batch_size}")
    if n < batch_size:
        out = {}
        for k, v in d.items():
            pad = np.broadcast_to(v[:1], (batch_size - n,) + v.shape[1:])
            out[k] = np.concatenate([v, pad], axis=0)
        d = out
    return (d["x"] if single else d), n


# ---------------------------------------------------------------------------
# Host feed helpers
# ---------------------------------------------------------------------------

# THE submit-ahead window — one copy, in the host-only ingest module;
# every feed path here rides it.
_windowed_apply = ingest.windowed_apply


def background_iter(iterator: Iterable, maxsize: int = 2) -> Iterator:
    """Drive ``iterator`` in a daemon thread through a bounded queue.

    Wraps host-side producers (image decode/pack) so their work overlaps
    device compute instead of serializing with it: the worker thread stays
    ``maxsize`` items ahead of the consumer. Exceptions re-raise at the
    consumption point. Closing/abandoning the generator (including an error
    raised by the consumer mid-stream) cancels the producer thread — it
    stops at the next queue hand-off rather than parking forever on a full
    queue with its buffered batches pinned.
    """
    # Queue(0) would mean *unbounded* — clamp to preserve backpressure.
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, maxsize))
    sentinel = object()
    cancelled = threading.Event()
    failure: list[BaseException] = []

    def put_bounded(item) -> bool:
        """Put with cancellation polling — a cancelled consumer can't
        strand the producer on a full queue. True iff delivered."""
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def work():
        try:
            for item in iterator:
                if not put_bounded(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            failure.append(e)
        finally:
            # The sentinel must actually arrive while the consumer lives —
            # dropping it on a transiently-full queue would strand the
            # consumer in q.get().
            put_bounded(sentinel)

    threading.Thread(target=work, daemon=True,
                     name="sparkdl-feed").start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        if failure:
            raise failure[0]
    finally:
        cancelled.set()


def dispatch_retries_default() -> int:
    """Bounded retry budget for transient dispatch/fetch errors in
    ``BatchRunner.run_stream`` (``SPARKDL_DISPATCH_RETRIES``, default 2;
    0 disables retries AND releases the per-slot host batch copy the
    re-dispatch path needs — the leanest-memory mode)."""
    try:
        return max(0, int(os.environ.get("SPARKDL_DISPATCH_RETRIES", "2")))
    except ValueError:
        return 2


def dispatch_backoff_default() -> float:
    """Base backoff (seconds) between dispatch/fetch retries; doubles per
    attempt (``SPARKDL_DISPATCH_BACKOFF_S``, default 0.2)."""
    try:
        return max(0.0, float(
            os.environ.get("SPARKDL_DISPATCH_BACKOFF_S", "0.2")))
    except ValueError:
        return 0.2


def dispatch_timeout_default() -> float:
    """Stall watchdog on the in-flight window: a blocking fetch that makes
    no progress for this many seconds raises a classified
    ``ScoringStallError`` naming the stage instead of hanging the job
    forever (``SPARKDL_DISPATCH_TIMEOUT_S``; default 0 = disabled — the
    watchdog costs one helper thread per fetch while armed)."""
    try:
        return float(os.environ.get("SPARKDL_DISPATCH_TIMEOUT_S", "0"))
    except ValueError:
        return 0.0


def _call_with_timeout(fn: Callable, timeout_s: float, stage: str):
    """Run ``fn`` on a helper thread, bounded by ``timeout_s``. On timeout
    the (possibly wedged) call is abandoned on its daemon thread and a
    classified :class:`ScoringStallError` names the stage — turning a
    silent device hang into a supervisable failure."""
    result: dict = {}
    done = threading.Event()

    def work():
        try:
            result["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            result["error"] = e
        finally:
            done.set()

    threading.Thread(target=work, daemon=True,
                     name="sparkdl-fetch-watchdog").start()
    if not done.wait(timeout_s):
        raise _failures().ScoringStallError(stage, timeout_s)
    if "error" in result:
        raise result["error"]
    return result["value"]


def decode_workers_default() -> int:
    """Host decode parallelism for the inference feed
    (``SPARKDL_DECODE_WORKERS``; default 2). The Arrow→NHWC pack and PIL
    resize release the GIL, so N workers keep N cores decoding. 0 = decode
    inline on the consumer thread (no overlap; debugging)."""
    try:
        return int(os.environ.get("SPARKDL_DECODE_WORKERS", "2"))
    except ValueError:
        return 2


def parallel_map_iter(fn: Callable, items: Iterable, workers: int | None = None,
                      maxsize: int | None = None,
                      backend: str | None = None) -> Iterator:
    """Order-preserving parallel map over an iterator — the host decode pool.

    Up to ``max(workers, maxsize)`` applications of ``fn`` stay in flight on
    a worker pool; results yield strictly in submission order, so a
    slow-to-decode chunk never reorders the stream. Submission is
    pull-driven: each yield tops the window back up, so the pool runs ahead
    of the consumer by the window depth and no producer thread needs
    cancelling. Exceptions from ``fn`` re-raise at the consumption point;
    closing the generator cancels whatever has not started.

    ``workers=None`` → :func:`decode_workers_default`; ``workers<=0`` maps
    inline (serial). ``backend`` (default: ``SPARKDL_DECODE_BACKEND``):
    ``thread``, or ``process`` to run ``fn`` on the shared
    ``ProcessPoolExecutor`` (``ingest.acquire_decode_executor``) — GIL-bound
    decode then scales past ~2 workers, but ``fn`` and every item must be
    picklable (the streaming scorer ships module-level factories +
    compacted Arrow chunks; see ``ingest.run_decode_task``). Callers
    whose ``fn`` closes over un-picklable state pass ``backend="thread"``
    explicitly rather than inheriting the env.
    """
    workers = decode_workers_default() if workers is None else int(workers)
    if backend is None:
        backend = ingest.decode_backend_default()
    if backend == "process" and workers > 0:
        pool = ingest.acquire_decode_executor(workers)
        try:
            # stall_s: a pool child deadlocked at fork must surface as a
            # classified decode stall, not an eternal hang — armed BY
            # DEFAULT (ingest.decode_stall_resolved); a SET
            # SPARKDL_DISPATCH_TIMEOUT_S (incl. an explicit 0 = off)
            # takes precedence.
            yield from _windowed_apply(
                fn, items, max(workers, maxsize or 0), workers, "",
                executor=pool,
                stall_s=ingest.decode_stall_resolved(),
                stall_stage="decode")
        except _failures().ScoringStallError:
            # The stalled future's child is wedged but ALIVE — it never
            # sets _broken, so the cached pool would re-stall every
            # later stream on a permanently lost worker slot. Evict it;
            # the next request builds fresh workers.
            ingest.invalidate_decode_executor(pool)
            raise
        finally:
            ingest.release_decode_executor()
        return
    # depth 0 when inline: decode is synchronous CPU work — running it
    # ahead on the consumer thread would serialize identically.
    yield from _windowed_apply(
        fn, items, 0 if workers <= 0 else max(workers, maxsize or 0),
        workers, "sparkdl-decode")


# ---------------------------------------------------------------------------
# The batch runner
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    """``fn`` over the leaves of a dict / list / tuple tree."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def _tree_structure(tree):
    if isinstance(tree, dict):
        return ("dict", tuple((k, _tree_structure(v))
                              for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,
                tuple(_tree_structure(v) for v in tree))
    return "*"


def _host_tensor(a: np.ndarray):
    """A CPU tensor over a host batch: zero-copy when numpy allows a
    writable view, else a copy (a read-only Arrow view)."""
    import torch
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _pinned_pad(a: np.ndarray, batch_size: int):
    """``a`` padded to ``batch_size`` rows in one write into a pinned host
    tensor, the pad rows replicating row 0 (the :func:`pad_batch`
    contract) — the source of an asynchronous host→device copy.
    PyTorch's caching host allocator keeps the block from reuse until
    the copies that read it have completed, so no pool of our own is
    needed."""
    import torch
    a = np.asarray(a)
    n = a.shape[0]
    if n > batch_size:
        raise ValueError(f"Batch of {n} rows exceeds batch size {batch_size}")
    t = torch.empty((batch_size,) + a.shape[1:],
                    dtype=torch.from_numpy(a[:0]).dtype, pin_memory=True)
    buf = t.numpy()
    buf[:n] = a
    buf[n:] = a[:1]
    return t


def _to_numpy(t):
    import torch
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


_runner_ids = itertools.count()


class BatchRunner:
    """Drives one device step over a stream of host batches.

    The execution engine behind every inference transformer: pads to a
    static batch, copies it to the device, runs ``fn`` and slices off pad
    rows. ``fn`` is a torch callable over the device batch (a tensor, or a
    dict of them) returning a tensor or a tree of tensors; it runs eagerly
    under ``torch.inference_mode``.

    Execution is *pipelined*: up to ``prefetch`` executions stay in flight
    with their device→host copies started asynchronously, so the fetch of
    batch k overlaps compute on batch k+1. On the card, the pad writes
    the host batch once into pinned memory and the put copies it with
    ``non_blocking=True`` on a side stream; an event orders the step on
    the compute stream after it. Each output is copied into a pinned host buffer at dispatch (the
    counterpart of ``copy_to_host_async``) and waited on when it is
    popped. On the CPU the same window runs synchronously.

    :meth:`run_stream` is the streaming-engine entry point: it drives the
    SAME window over one continuous batch stream with arbitrary host-side
    metadata riding alongside each batch — callers feed the whole dataset
    (all partitions) through one call, so the in-flight window never
    drains at a partition boundary. :meth:`run` is the meta-less wrapper.
    Every stage emits flight-recorder spans (``pad``/``put``/``dispatch``/
    ``fetch``) so postmortems and bench can see where scoring time goes.
    Each new input signature of a runner is one ``CompileCache.note`` and
    one ``recompile`` event, as in the reference (on the card a new shape
    is a new set of cuDNN plans).
    """

    def __init__(self, fn: Callable, batch_size: int,
                 donate: bool = False,
                 prefetch: int = 2, mesh=None, input_cast=None,
                 preprocess: Callable | None = None, device=None,
                 data_axis: str = "data"):
        """``device``: where the step runs; ``None`` → the card
        (``utils.platform.resolve_device``, which raises without one);
        ``"cpu"`` must be asked for.

        ``input_cast``: a torch dtype (e.g. ``torch.float32``): every input
        leaf is cast to it on the device, inside the step. Feed uint8 host
        batches: 4x fewer bytes over the host→device link than pre-cast
        float32 feeds.

        ``preprocess``: a torch callable applied inside the step between
        the input cast and ``fn`` — the fused preprocess prologue: channel
        flips / :func:`resize_nhwc` / normalization run on the device, so
        the host ships raw storage-dtype batches and does zero per-pixel
        math. A prologue may branch on ``x.shape`` (e.g. resize only when
        the wire size differs from the model size); each distinct wire
        shape is a new signature, visible as a ``recompile`` event.

        ``mesh``: a ``DeviceMesh`` over the gang (``make_mesh``) with a
        ``data_axis`` axis of n ranks: ``batch_size`` is rounded up to a
        multiple of n, every rank (each passes the same batches) runs the
        step on its contiguous ``batch_size / n`` rows of each padded
        batch, and the outputs are all-gathered over the axis in rank
        order, so every rank yields the whole batch. The device is the
        mesh's (``cuda`` under NCCL, ``cpu`` under gloo) unless
        ``device`` names one.

        ``donate``: the runner keeps no reference to the device batch once
        the step is dispatched — the step receives the only one, so the
        input's memory returns to the caching allocator as soon as the
        step's cast or prologue lets go of it. PyTorch has no aliasing of
        an input buffer into an output (ROADMAP.md, Queue C 2)."""
        import torch
        from ..utils.platform import resolve_device
        self.mesh, self.donate = mesh, bool(donate)
        self._group, self._n, self._coord = None, 1, 0
        if mesh is not None:
            names = list(mesh.mesh_dim_names)
            if data_axis not in names:
                raise ValueError(f"axis {data_axis!r} is not an axis of the "
                                 f"mesh {tuple(names)}")
            self._n = mesh.size(names.index(data_axis))
            self._group = mesh.get_group(data_axis)
            self._coord = mesh.get_local_rank(data_axis)
            if device is None:
                device = "cuda" if mesh.device_type == "cuda" else "cpu"
        self.device = resolve_device(device)
        # Per-runner identity for recompile accounting: each runner owns
        # its own plans, so the same shapes through a NEW runner are a new
        # signature, not a hit.
        self._sig_name = (f"BatchRunner:{getattr(fn, '__name__', 'fn')}"
                          f":{next(_runner_ids)}")
        self.batch_size = -(-int(batch_size) // self._n) * self._n
        self.prefetch = prefetch
        self._fn = fn
        self._input_cast = input_cast
        self._preprocess = preprocess
        self._h2d_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    def _step(self, box: list):
        """Run the step on the batch in ``box`` (popped when donating,
        so the step holds the only reference)."""
        import torch
        batch = box.pop() if self.donate else box[0]
        with torch.inference_mode():
            if self._input_cast is not None:
                batch = _tree_map(lambda t: t.to(self._input_cast), batch)
            if self._preprocess is not None:
                batch = self._preprocess(batch)
            out = self._fn(batch)
            if self._group is not None:
                out = _tree_map(self._gather_rows, out)
            return out

    def _gather_rows(self, t):
        """The mesh's ranks' rows of an output joined in rank order."""
        from ..parallel.fsdp import all_gather
        return all_gather(t, 0, self._group, self._n)

    def _share(self, t):
        """This rank's contiguous rows of a padded batch leaf."""
        if self._group is None:
            return t
        w = self.batch_size // self._n
        return t[self._coord * w:(self._coord + 1) * w]

    def _stage(self, host):
        """Pad a host batch to ``batch_size`` rows, the pad rows
        replicating row 0; returns ``(staged, n_valid, bytes_copied)``.
        On the card every batch is written once into pinned memory
        (:func:`_pinned_pad`); on the CPU a full batch passes through
        untouched and a short one is padded by :func:`pad_batch`."""
        n = _tree_leaves(host)[0].shape[0]
        if self.device.type == "cuda":
            staged = _tree_map(lambda a: _pinned_pad(a, self.batch_size),
                               host)
        else:
            staged, n = pad_batch(host, self.batch_size)
            if n == self.batch_size:
                return staged, n, 0
        return staged, n, sum(leaf.nbytes for leaf in _tree_leaves(staged))

    def _put(self, staged):
        """Staged batch → ``(device_batch, ready_event_or_None)``; under a
        mesh, the rank's share of it."""
        import torch
        if self.device.type != "cuda":
            return _tree_map(lambda a: self._share(_host_tensor(a)),
                             staged), None
        with torch.cuda.stream(self._h2d_stream):
            dev = _tree_map(
                lambda t: self._share(t).to(self.device, non_blocking=True),
                staged)
            ready = torch.cuda.Event()
            ready.record(self._h2d_stream)
        return dev, ready

    def _launch(self, box: list, ready):
        """Run the step on the device batch in ``box`` (a one-item list
        the step may empty: ``donate``); on the card, start the outputs'
        copy to pinned host buffers. Returns ``(outputs,
        done_event_or_None)``."""
        import torch
        if ready is None:
            return self._step(box), None
        with torch.cuda.device(self.device):
            compute = torch.cuda.current_stream()
            compute.wait_event(ready)
            # allocated on the side stream, read on this one
            _tree_map(lambda t: t.record_stream(compute), box[0])
            out = self._step(box)
            host = _tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True).copy_(
                    t, non_blocking=True), out)
            done = torch.cuda.Event()
            done.record(compute)
        return host, done

    def run(self, batches: Iterable[np.ndarray | dict]) -> Iterator[np.ndarray]:
        """batches: iterator of host arrays/dicts with leading batch dim ≤
        batch_size. Yields numpy outputs with pad rows removed."""
        for out, _ in self.run_stream((b, None) for b in batches):
            yield out

    def run_stream(self, batches: Iterable[tuple]) -> Iterator[tuple]:
        """Persistent pipeline over one continuous batch stream.

        ``batches``: iterator of ``(host_batch, meta)`` — ``meta`` is any
        host-side value (the streaming transformers carry partition
        identity/row counts here) and rides the pipeline untouched. Yields
        ``(numpy_output_with_pad_rows_removed, meta)`` in input order.

        The in-flight window (``prefetch`` dispatched executions with
        async device→host copies, plus the same depth of pending puts)
        spans the WHOLE stream: feeding every partition of a dataset
        through one call keeps the device busy across partition boundaries
        instead of draining per partition.

        Fault tolerance: transient *retryable* dispatch/fetch errors
        (``failures.classify_exception`` — UNAVAILABLE, preemption,
        connection flakes; a CUDA out-of-memory or illegal memory access
        is fatal) are retried up to ``SPARKDL_DISPATCH_RETRIES`` times with
        exponential backoff (``SPARKDL_DISPATCH_BACKOFF_S``), each retry
        staging and putting the caller's host batch again and emitting a
        ``retry`` flight-recorder event; exhaustion (or a fatal error) emits
        ``give_up`` and raises :class:`ScoringStageError` naming the stage.
        ``SPARKDL_DISPATCH_RETRIES=0`` disables retries and keeps no host
        copy. ``SPARKDL_DISPATCH_TIMEOUT_S`` > 0 arms a stall watchdog on
        the blocking fetch: no progress for that long raises a classified
        ``ScoringStallError`` instead of hanging.
        """
        ev = _events()
        chaos = _chaos()
        tel = _telemetry()
        # env-armed (SPARKDL_METRICS_DIR / SPARKDL_METRICS_PORT); two dict
        # lookups and the plane stays off when neither is set
        tel.maybe_start_from_env()
        depth_gauge = occupancy_gauge = None
        if tel.enabled():
            depth_gauge = tel.registry().gauge("run_stream_window_depth")
            occupancy_gauge = tel.registry().gauge(
                "run_stream_slot_occupancy")
        retries = dispatch_retries_default()
        backoff_s = dispatch_backoff_default()
        stall_s = dispatch_timeout_default()

        def put_slot(slot):
            # n/meta ride each window slot through the shared submit-ahead
            # window. The caller's host batch is kept only while retries
            # are enabled: the re-dispatch path stages and puts it again.
            # The staged (pinned) copy is a local here, dropped as soon
            # as its put is issued, so the caching host allocator can
            # reuse its block once the DMA completes.
            idx, (b, meta) = slot
            with ev.span("pad") as sp:
                padded, n, copied = self._stage(b)
                # bytes = host bytes COPIED to stage this batch
                # (0 = pass-through)
                sp.set(rows=n, bytes=copied)
            nbytes = sum(leaf.nbytes for leaf in _tree_leaves(padded))
            with ev.span("put", rows=n, bytes=nbytes):
                dev, ready = self._put(padded)
            # the device batch rides in a box the step may empty
            # (donate): nothing of the window holds it then
            return [dev], ready, (b if retries else None), n, meta, idx

        def put_stream():
            # inline (no put threads): puts are issued in stream order
            return _windowed_apply(put_slot, enumerate(batches),
                                   self.prefetch, 0, "sparkdl-put")

        def dispatch_once(box, ready, n, idx):
            # Signature accounting BEFORE the dispatch: a pad bug or
            # mixed-shape stream shows up as `recompile` events.
            GLOBAL_COMPILE_CACHE.note(self._sig_name, (
                _tree_structure(box[0]),
                tuple((tuple(leaf.shape), str(leaf.dtype))
                      for leaf in _tree_leaves(box[0]))))
            with ev.span("dispatch", rows=n):
                chaos.fire("dispatch", step=idx)
                if stall_s > 0:
                    # On the CPU the step itself runs here; a hang there
                    # never reaches the fetch — the armed watchdog covers
                    # both ends of the window.
                    return _call_with_timeout(
                        lambda: self._launch(box, ready), stall_s,
                        "dispatch")
                return self._launch(box, ready)

        def retry_or_raise(stage, exc, host, n, idx, state):
            """One retry decision + (on retry) the serial re-put +
            re-dispatch. Returns a fresh ``(out, done)``; raises the
            classified stage error when the budget is spent or the error
            is fatal."""
            failures = _failures()
            while True:
                kind = failures.classify_exception(exc)
                if host is None or kind != "retryable" \
                        or state["attempts"] > retries:
                    ev.event("give_up", stage=stage,
                             attempts=state["attempts"], kind=kind,
                             error=f"{type(exc).__name__}: {exc}"[:300],
                             batch=idx)
                    if kind == "retryable" and host is not None:
                        _run_stats().record_retry(giveup=True)
                    raise failures.ScoringStageError(
                        stage, state["attempts"], exc) from exc
                delay = backoff_s * (2 ** (state["attempts"] - 1))
                ev.event("retry", stage=stage, attempt=state["attempts"],
                         delay_s=round(delay, 3),
                         error=f"{type(exc).__name__}: {exc}"[:300],
                         batch=idx)
                _run_stats().record_retry()
                state["attempts"] += 1
                if delay:
                    time.sleep(delay)
                try:
                    # Rare path, so serial: fresh device buffers from the
                    # host copy, then re-dispatch.
                    with ev.span("put"):
                        dev, ready = self._put(self._stage(host)[0])
                    return dispatch_once([dev], ready, n, idx)
                except failures.ScoringStallError:
                    # The retry itself wedged: surface it NOW instead of
                    # burning the remaining budget stall_s at a time.
                    ev.event("give_up", stage=stage, stalled=True,
                             timeout_s=stall_s, batch=idx)
                    raise
                except Exception as e:  # noqa: BLE001 — reclassified above
                    exc = e

        def wait_host(out, done):
            if done is not None:
                done.synchronize()
            return _tree_map(_to_numpy, out)

        def fetch(slot):
            (out, done), host, n, meta, idx, state = slot
            failures = _failures()
            while True:
                try:
                    with ev.span("fetch", rows=n):
                        if stall_s > 0:
                            out_np = _call_with_timeout(
                                lambda: wait_host(out, done), stall_s,
                                "fetch")
                        else:
                            out_np = wait_host(out, done)
                    return _tree_map(lambda x: x[:n], out_np), meta
                except failures.ScoringStallError:
                    # A wedged fetch is not fixed by re-dispatching onto
                    # the same wedged device — surface it for the
                    # process-level supervisor (classified retryable).
                    ev.event("give_up", stage="fetch", stalled=True,
                             timeout_s=stall_s, batch=idx)
                    raise
                except Exception as e:  # noqa: BLE001 — reclassified
                    # Async device errors materialize here; a retry must
                    # redo put+dispatch for this batch, then re-fetch.
                    out, done = retry_or_raise("fetch", e, host, n, idx,
                                               state)

        window: collections.deque = collections.deque()
        for box, ready, host, n, meta, idx in put_stream():
            state = {"attempts": 1}
            try:
                launched = dispatch_once(box, ready, n, idx)
            except _failures().ScoringStallError:
                # A wedged dispatch is not fixed by re-dispatching onto
                # the same wedged device (same rule as the fetch stall).
                ev.event("give_up", stage="dispatch", stalled=True,
                         timeout_s=stall_s, batch=idx)
                raise
            except Exception as e:  # noqa: BLE001 — reclassified
                launched = retry_or_raise("dispatch", e, host, n, idx,
                                          state)
            del box
            window.append((launched, host, n, meta, idx, state))
            oldest = window.popleft() if len(window) > self.prefetch \
                else None
            if depth_gauge is not None:
                # Live in-flight view, read AFTER the pop: a keeping-up
                # feed reads 1.0.
                depth_gauge.set(len(window))
                occupancy_gauge.set(len(window) / max(self.prefetch, 1))
            if oldest is not None:
                yield fetch(oldest)
        while window:
            if depth_gauge is not None:
                depth_gauge.set(len(window))
            yield fetch(window.popleft())


# ---------------------------------------------------------------------------
# NHWC resize (the fused-preprocess building block)
# ---------------------------------------------------------------------------

def resize_nhwc(x, height: int, width: int):
    """Bilinear resize of an NHWC batch to ``(height, width)``, float32
    out, on the device ``x`` lies on (a numpy batch: the CPU) — the
    counterpart of ``jit_resize_nhwc`` / ``jax.image.resize(x, ...,
    method="bilinear")``: half-pixel centres, a triangle filter widened by
    the scale factor when it downscales (``antialias=True``), and the
    weights that fall outside the image dropped and renormalised. A batch
    already at the target size comes back as it is (cast to f32)."""
    import torch
    import torch.nn.functional as F
    if isinstance(x, np.ndarray):
        x = _host_tensor(x)
    x = x.float()
    if x.shape[1] == int(height) and x.shape[2] == int(width):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(int(height), int(width)),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)
