"""Live engine inspector — jax-free.

The port's copy of ``sparkdl_tpu/serving/introspect.py``, without the
fleet half (the router it reads is not ported yet, ROADMAP.md).

``GenerationEngine.snapshot()`` is the engine's own aggregate counters;
this module is the *state* view an operator debugging a live engine
needs: the slot table (who holds each slot, how long, at what write
frontier), the queue (depth + head age — admission starvation is
visible as an aging head), the KV pool (free/shared/CoW block counts,
per-slot block footprints, radix residency), and speculation
acceptance. :func:`serving_snapshot` returns it for every live engine
as plain JSON-able data.

Engines register themselves here at construction through a
``weakref.WeakSet`` — one set-add per engine *build* (never per token),
and a garbage-collected engine drops out on its own. The inspector only
ever *reads* engine state under the engine's lock; a failing read
degrades to an error entry, never takes the caller (or the engine) down.
"""

from __future__ import annotations

import threading
import time
import weakref

__all__ = ["register_engine", "live_engines", "engine_debug_state",
           "serving_snapshot"]

_ENGINES: "weakref.WeakSet" = weakref.WeakSet()
_lock = threading.Lock()


def register_engine(engine) -> None:
    """Track a live engine for the inspector (weakly — no lifetime is
    extended)."""
    with _lock:
        _ENGINES.add(engine)


def live_engines() -> list:
    with _lock:
        return list(_ENGINES)


def engine_debug_state(eng) -> dict:
    """One engine's live state as plain JSON-able data (see module
    doc). Reads the slot table and queue under the engine's lock;
    backend stats (pool/prefix/spec) are read lock-free — they carry
    their own locks."""
    now = time.time()
    with eng._lock:
        queue = list(eng._queue)
        slots = list(eng._slots)
        running = eng._thread is not None
        fatal = eng._fatal
        stats = dict(eng.stats)
        failover = dict(getattr(eng, "_failover_info", {}) or {})
    mgr = getattr(eng.backend, "mgr", None)
    slot_rows = []
    for i, r in enumerate(slots):
        row: dict = {"slot": i,
                     "state": "idle" if r is None else r.state}
        if r is not None:
            row.update({
                "request": r.id,
                "prompt_tokens": len(r.prompt),
                "tokens_out": len(r.tokens),
                "max_new_tokens": r.max_new_tokens,
                "write_pos": r.write_pos,
                "age_s": round(now - (r.t_admit or now), 3),
                "preemptions": r.preemptions,
                "block_stalled": bool(r._block_stalled),
                # Exactly-once audit fields: the delivery
                # cursor (tokens streamed to the client — must equal
                # tokens_out at every boundary) and how many failovers
                # this request has personally ridden through.
                "delivered": r.delivered,
                "failovers": r.failovers,
            })
            if r.chunk_plan is not None:
                row["chunks_done"] = r.next_chunk
                row["chunks_total"] = len(r.chunk_plan)
            if r.prefill_reused:
                row["prefix_reused_tokens"] = r.prefill_reused
        if mgr is not None:
            row["kv_blocks"] = len(mgr.slot_blocks[i])
        slot_rows.append(row)
    head = queue[0] if queue else None
    out: dict = {
        "t": round(now, 6),
        "backend": type(eng.backend).__name__,
        "paged": eng.paged,
        "stall_free": eng.stall_free,
        "spec_k": eng.spec_k,
        # How many devices this engine spans and what the KV
        # cache/pool costs EACH of them — the operator's first question
        # about a multi-chip engine ("is the pool really 1/tp here?")
        "tp_degree": getattr(eng, "tp_degree", 1),
        "kv_pool_device_bytes": getattr(eng, "kv_pool_device_bytes",
                                        None),
        "num_slots": len(slots),
        "slots_busy": sum(r is not None for r in slots),
        "loop_running": running,
        "fatal": f"{type(fatal).__name__}: {fatal}"[:200]
        if fatal is not None else None,
        "queue": {
            "depth": len(queue),
            "head": None if head is None else {
                "request": head.id,
                "prompt_tokens": len(head.prompt),
                "age_s": round(now - head.t_enqueue, 3),
                "preemptions": head.preemptions,
            },
        },
        "slots": slot_rows,
        "stats": stats,
        # Survivability view: failover state machine (healthy /
        # recovered / rebuild_failed / exhausted), counts, last cause,
        # resumed/quarantined ledgers, backoff and fault-to-first-
        # resumed-token recovery latency.
        "failover": failover,
    }
    if eng.paged:
        pool = getattr(eng.backend, "pool_stats", None)
        if callable(pool):
            # blocks free/used/shared, CoW count, peak utilization and
            # (radix backends) trie residency — the HBM-pressure view
            out["kv_pool"] = pool()
    pstats = getattr(eng.backend, "prefix_stats", None)
    if callable(pstats):
        st = pstats()
        if st:
            out["prefix_cache"] = st
    if eng.spec_k:
        acc = stats.get("spec_tokens_accepted", 0)
        rej = stats.get("spec_tokens_rejected", 0)
        out["spec"] = {
            "k": eng.spec_k,
            "verifies": stats.get("spec_verifies", 0),
            "tokens_accepted": acc,
            "tokens_rejected": rej,
            "accept_rate": round(acc / (acc + rej), 4)
            if acc + rej else None,
        }
    return out


def serving_snapshot() -> dict:
    """Every live engine's debug state. A single engine failing to
    snapshot yields an error entry for that engine only."""
    engines = []
    for eng in live_engines():
        try:
            engines.append(engine_debug_state(eng))
        except Exception as e:  # noqa: BLE001 — inspector must degrade
            engines.append({"error": f"{type(e).__name__}: {e}"[:300]})
    engines.sort(key=lambda d: d.get("t", 0))
    return {"t": round(time.time(), 6), "n_engines": len(engines),
            "engines": engines}
