"""Call signatures and the compiled decode step of the port.

The port's copy of the jax-free ``CompileCache`` / ``GLOBAL_COMPILE_CACHE``
of ``sparkdl_tpu/core/runtime.py`` (that module imports jax): ``note``,
``snapshot`` and ``signatures``, and ``get``, the counterpart of the
reference's jit wrapper. Where the reference compiles a step into one XLA
program per signature, ``get`` captures it into one CUDA graph per
signature and replays it (:class:`StepGraph`).
"""

from __future__ import annotations

import threading
import time


def _events():
    from ..runner import events
    return events


class StepGraph:
    """One S = 1 step, ``fn(*inputs) -> tensor``, run from static input
    buffers to a static output.

    On a CUDA device the first call runs ``fn`` once eagerly on a side
    stream (a real step, whose output it returns: it allocates what the
    kernels keep across calls outside the graph's memory pool, and loads
    cuBLAS), then captures ``fn`` into a CUDA graph; every later call
    copies its inputs into the static buffers and replays the graph. The
    output is then the graph's own tensor, valid until the next call.

    On the CPU (the CPU mode, taken only for CPU tensors) every call
    copies its inputs into the same static buffers and calls ``fn`` on
    them eagerly: the arithmetic the graph replays, with the same buffer
    plumbing, so the CPU tests hold both.

    ``counters``: the kernel wrappers whose ``launches`` count their CUDA
    launches. Capture launches nothing, so the counts it adds are taken
    back, and each replay adds what the capture counted: a replayed step
    counts the launches an eager step would. A capture or replay that
    fails raises; nothing falls back to the eager step."""

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
        for c, n in zip(self.counters, self.launches):
            c.launches += n
        return self.out

    def _capture(self):
        import torch

        with torch.cuda.device(self.device):
            here = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(here)
            with torch.cuda.stream(side):
                first = self.fn(*self.static)
            here.wait_stream(side)
            before = [c.launches for c in self.counters]
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self.fn(*self.static)
            self.capture_ms = (time.perf_counter() - t0) * 1e3
            self.launches = tuple(c.launches - b
                                  for c, b in zip(self.counters, before))
            for c, b in zip(self.counters, before):
                c.launches = b
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
