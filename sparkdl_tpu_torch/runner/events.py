"""Flight recorder — structured event tracing for the serving engine.

The port's copy of ``sparkdl_tpu/runner/events.py``, cut to what the
serving engine reaches: point events, spans, back-dated completed spans,
the causal trace ids and the tee seam the telemetry and sentinel layers
observe. Crash postmortems and the gang-timeline merge serve the
training supervisor and return with the slice that ports it
(ROADMAP.md).

- :func:`event(name, **attrs)` — a point event
- :func:`span(name, **attrs)` — a context manager emitting begin/end events
  with the measured duration (and the exception, when the region fails)
- :func:`completed_span(name, dur_s, **attrs)` — a span whose region
  already ran

Events land in a bounded in-memory **ring buffer** (``SPARKDL_EVENT_RING``
entries, default 512). With ``SPARKDL_EVENT_DIR`` unset the hot-path cost is
a dict build + deque append — no I/O, no device sync. With it set, each
event is also streamed as one JSON line to
``$SPARKDL_EVENT_DIR/events_rank{i}.jsonl`` (line-buffered, so a killed
process's trace survives up to its last completed event), capped at
``SPARKDL_EVENT_MAX_MB``.

Stdlib only.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time

__all__ = ["FlightRecorder", "RECORDER_DIR_ENV", "RING_ENV",
           "TRACE_ID_ENV", "TRACE_PARENT_ENV",
           "event", "span", "completed_span", "get_recorder",
           "add_tee", "remove_tee",
           "trace_armed", "new_span_id", "current_span_id"]

RECORDER_DIR_ENV = "SPARKDL_EVENT_DIR"
RING_ENV = "SPARKDL_EVENT_RING"
STREAM_CAP_ENV = "SPARKDL_EVENT_MAX_MB"
# Causal trace context: a run-level trace id and the parent span id
# ride the environment, so a process inherits its causal position with
# zero protocol.
TRACE_ID_ENV = "SPARKDL_TRACE_ID"
TRACE_PARENT_ENV = "SPARKDL_TRACE_PARENT"
_DEFAULT_RING = 512
_DEFAULT_STREAM_CAP_MB = 256  # per-rank JSONL cap; ring keeps recording


def _rank() -> int:
    try:
        return int(os.environ.get("SPARKDL_PROCESS_ID", "0"))
    except ValueError:
        return 0


# Event tees: consumers that see every emitted record in-process.
# Module-level (not per-recorder) so replacing the recorder cannot
# silently detach a live consumer. Empty by default: the hot-path cost
# of an unused tee list is one falsy check per emit.
_TEES: list = []


def add_tee(cb) -> None:
    """Register ``cb(record_dict)`` to observe every emitted event.
    Idempotent per callable."""
    if cb not in _TEES:
        _TEES.append(cb)


def remove_tee(cb) -> None:
    try:
        _TEES.remove(cb)
    except ValueError:
        pass


# -- trace context -------------------------------------------------
# Spans gain span_id/parent_id from a thread-local span stack, so nested
# regions chain causally WITHIN a thread. The machinery is armed only when
# SPARKDL_TRACE_ID is set: untraced runs keep emitting byte-identical
# records (one env lookup per span).

_TRACE_TLS = threading.local()
_SPAN_SEQ = itertools.count(1)


def trace_armed() -> bool:
    """True when a run-level trace id is in the environment."""
    return bool(os.environ.get(TRACE_ID_ENV))


def new_span_id() -> str:
    """Cheap process-unique span id: rank + pid + per-process counter.
    No randomness on the hot path — uniqueness comes from the (pid, seq)
    pair, and the rank prefix makes raw streams greppable by origin."""
    return f"{_rank()}-{os.getpid():x}-{next(_SPAN_SEQ):x}"


def current_span_id() -> str | None:
    """Innermost open span on THIS thread, else the env-shipped parent,
    else None."""
    st = getattr(_TRACE_TLS, "stack", None)
    if st:
        return st[-1]
    return os.environ.get(TRACE_PARENT_ENV) or None


def _push_span(span_id: str) -> None:
    st = getattr(_TRACE_TLS, "stack", None)
    if st is None:
        st = _TRACE_TLS.stack = []
    st.append(span_id)


def _pop_span(span_id: str) -> None:
    st = getattr(_TRACE_TLS, "stack", None)
    if not st:
        return
    if st[-1] == span_id:
        st.pop()
    else:
        # A span exited out of order (generator-held context manager, or
        # exit on a different thread than enter): drop just that id —
        # corrupting the WHOLE stack would mis-parent every later span.
        try:
            st.remove(span_id)
        except ValueError:
            pass


class _Span:
    """Begin/end event pair around a region; duration and (on failure) the
    exception ride the end event."""

    __slots__ = ("seconds", "_t0", "_rec", "_name", "_attrs", "_span_id")

    def __init__(self, rec: "FlightRecorder", name: str, **attrs):
        self.seconds = 0.0
        self._rec = rec
        self._name = name
        self._attrs = attrs
        self._span_id = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        if trace_armed():
            # span_id/parent_id land in _attrs so BOTH the B and the E
            # record carry them; an explicit span_id/parent_id kwarg
            # (the serving engine parenting under a request's admission
            # span) wins over the ambient stack.
            self._span_id = self._attrs.get("span_id") or new_span_id()
            parent = self._attrs.get("parent_id") or current_span_id()
            if parent is not None:
                self._attrs.setdefault("parent_id", parent)
            self._attrs["span_id"] = self._span_id
            _push_span(self._span_id)
        self._rec.emit(self._name, "B", self._attrs)
        return self

    def set(self, **attrs) -> "_Span":
        """Attach attrs discovered INSIDE the region — they land on the
        end event; the begin event has already been emitted without
        them."""
        self._attrs.update(attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._span_id is not None:
            # Pop before the end event: anything emitted from here on
            # belongs to the enclosing scope, not the closed region.
            _pop_span(self._span_id)
        self.seconds = time.perf_counter() - self._t0
        end = dict(self._attrs)
        end["dur_s"] = round(self.seconds, 6)
        if exc_type is not None:
            end["error"] = f"{exc_type.__name__}: {exc}"[:300]
        self._rec.emit(self._name, "E", end)
        return False


class FlightRecorder:
    """Bounded event ring + optional per-rank JSONL stream.

    Record shape (flat, jq-friendly): ``{"t": <unix wall time>, "name": ...,
    "ph": "P"|"B"|"E", "rank": <int>, ...attrs}``. ``t``/``name``/``ph``/
    ``rank`` are reserved keys. Wall time (not perf_counter) so traces from
    different processes on one host merge into one timeline.
    """

    def __init__(self, ring_size: int | None = None):
        if ring_size is None:
            try:
                ring_size = int(os.environ.get(RING_ENV, _DEFAULT_RING))
            except ValueError:
                ring_size = _DEFAULT_RING
        self.ring: collections.deque = collections.deque(
            maxlen=max(ring_size, 8))
        self._lock = threading.Lock()
        self._file = None
        self._dir = None
        self._stream_bytes = 0
        self._stream_cap = 0
        self._stream_capped = False

    # -- emission ---------------------------------------------------------
    def emit(self, name: str, ph: str = "P", attrs: dict | None = None,
             t: float | None = None):
        rec = {"t": round(time.time() if t is None else t, 6),
               "name": name, "ph": ph, "rank": _rank()}
        if attrs:
            rec.update(attrs)
        tid = os.environ.get(TRACE_ID_ENV)
        if tid:
            rec.setdefault("trace_id", tid)
            if "span_id" not in rec and "parent_id" not in rec:
                # Bare point events (chaos fires, anomalies) parent under
                # the innermost open span.
                parent = current_span_id()
                if parent is not None:
                    rec["parent_id"] = parent
        self.ring.append(rec)
        if _TEES:
            for cb in _TEES:
                try:
                    cb(rec)
                except Exception:  # noqa: BLE001 — telemetry must never
                    pass  # kill the hot path, nor one broken tee starve
                    # the others of the event (per-callback isolation)
        d = os.environ.get(RECORDER_DIR_ENV)
        if d:
            self._write(d, rec)

    def event(self, name: str, **attrs):
        self.emit(name, "P", attrs)

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, **attrs)

    def completed_span(self, name: str, dur_s: float, **attrs):
        """Land a span that ALREADY ran: B back-dated by ``dur_s``, E
        now."""
        t1 = time.time()
        if trace_armed():
            attrs.setdefault("span_id", new_span_id())
            parent = current_span_id()
            if parent is not None:
                attrs.setdefault("parent_id", parent)
        self.emit(name, "B", attrs, t=t1 - max(0.0, dur_s))
        end = dict(attrs)
        end["dur_s"] = round(max(0.0, dur_s), 6)
        self.emit(name, "E", end, t=t1)

    def _write(self, d: str, rec: dict):
        try:
            with self._lock:
                if self._file is None or self._dir != d:
                    if self._file is not None:
                        self._file.close()
                    os.makedirs(d, exist_ok=True)
                    self._dir = d
                    # append + line-buffered: every completed event is on
                    # disk before a kill can land
                    self._file = open(
                        os.path.join(d, f"events_rank{_rank()}.jsonl"),
                        "a", buffering=1)
                    # Cap resolved once per open (not per event — this is
                    # the hot path), budget seeded from what's already on
                    # disk (append mode sits at EOF).
                    self._stream_cap = self._stream_cap_bytes()
                    self._stream_bytes = self._file.tell()
                    self._stream_capped = \
                        self._stream_bytes > self._stream_cap
                if self._stream_capped:
                    return
                line = json.dumps(rec, default=str) + "\n"
                # len() == encoded bytes: json.dumps defaults to
                # ensure_ascii, so the line is pure ASCII by construction.
                self._stream_bytes += len(line)
                if self._stream_bytes > self._stream_cap:
                    # The ring keeps recording past the cap; the marker
                    # line makes the truncation visible to readers.
                    self._stream_capped = True
                    self._file.write(json.dumps(
                        {"t": round(time.time(), 6),
                         "name": "event_stream_truncated", "ph": "P",
                         "rank": _rank(),
                         "cap_mb": self._stream_cap // 2 ** 20}
                    ) + "\n")
                    return
                self._file.write(line)
        except (OSError, ValueError):
            pass  # a torn-down tmpdir must not kill the serving loop

    @staticmethod
    def _stream_cap_bytes() -> int:
        try:
            mb = float(os.environ.get(STREAM_CAP_ENV,
                                      _DEFAULT_STREAM_CAP_MB))
        except ValueError:
            mb = _DEFAULT_STREAM_CAP_MB
        return int(mb * 2 ** 20)

    # -- inspection -------------------------------------------------------
    def tail(self, n: int | None = None) -> list[dict]:
        # Other threads may still be appending; iterating a deque under
        # concurrent append can raise — retry.
        for _ in range(5):
            try:
                evs = list(self.ring)
                break
            except RuntimeError:
                continue
        else:
            evs = []
        return evs if n is None else evs[-n:]


# -- process-global recorder --------------------------------------------------

_RECORDER: FlightRecorder | None = None


def get_recorder() -> FlightRecorder:
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = FlightRecorder()
    return _RECORDER


def event(name: str, **attrs):
    get_recorder().event(name, **attrs)


def span(name: str, **attrs) -> _Span:
    return get_recorder().span(name, **attrs)


def completed_span(name: str, dur_s: float, **attrs) -> None:
    get_recorder().completed_span(name, dur_s, **attrs)
