"""Signature bookkeeping of the port's serving calls.

The port's copy of the jax-free ``CompileCache`` / ``GLOBAL_COMPILE_CACHE``
of ``sparkdl_tpu/core/runtime.py`` (that module imports jax): ``note``,
``snapshot`` and ``signatures``, without the jit wrapper ``get``.
"""

from __future__ import annotations

import threading


def _events():
    from ..runner import events
    return events


class CompileCache:
    """Call signatures noted by name, with hit/miss counters.

    The port runs eagerly and compiles nothing per signature, so a note
    records a new SHAPE signature, not a compile: the serving backends
    note each slot call's operand shapes, and "the decode step keeps one
    signature for an engine's lifetime" stays an observable, as in the
    JAX package."""

    def __init__(self):
        self._keys: dict[str, set] = {}
        self._lock = threading.Lock()
        self.misses = 0
        self.hits = 0

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

    def snapshot(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses}

    def signatures(self, name: str) -> int:
        """How many distinct call signatures ``name`` has seen — the
        re-trace observable (the serving bench pins "no decode-step
        re-trace after warmup" as ``signatures('serve_decode_step')``
        staying constant across the measured run)."""
        with self._lock:
            return len(self._keys.get(name, ()))


GLOBAL_COMPILE_CACHE = CompileCache()
