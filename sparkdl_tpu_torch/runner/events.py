"""Flight recorder — structured per-rank event tracing.

The port's copy of ``sparkdl_tpu/runner/events.py``. Every interesting
moment in the runner and the serving engine (step phases, checkpoint
saves, injected faults, profiler traces, restarts, request phases)
becomes a structured event:

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

On any failure path (``fit()``, ``run_with_restarts``) the ring is flushed
as a **crash postmortem** — the last events and the exception — to
``postmortem_rank{i}.json`` (:func:`postmortem`). :func:`merge_timeline`
merges every rank's event files, postmortems and heartbeats into one
time-ordered timeline naming which rank failed or stalled first, at what
step and batch, and at which site; :func:`collect_degradations` lists
the faults a run survived (rollbacks, resumes, retries).

Stdlib only at import time; :class:`Timer` imports torch only when asked
to wait for tensors on the card. ``utils.timing.Timer`` is an alias of
it — one timing primitive in the package.
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import re
import threading
import time
import uuid

__all__ = ["FlightRecorder", "Timer", "RECORDER_DIR_ENV", "RING_ENV",
           "TRACE_ID_ENV", "TRACE_PARENT_ENV",
           "event", "span", "completed_span", "postmortem", "get_recorder",
           "reset", "enable_flight_recorder", "merge_timeline",
           "format_timeline", "write_gang_postmortem", "clear_rank_files",
           "collect_degradations", "parse_heartbeat_body", "add_tee",
           "remove_tee", "atomic_write_json", "trace_armed", "new_trace_id",
           "new_span_id", "current_span_id"]

log = logging.getLogger("sparkdl_tpu_torch.runner")

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
_POSTMORTEM_TAIL = 128  # events carried in a crash postmortem


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


def new_trace_id() -> str:
    """Mint a run-level trace id (in the launching process, once a launch)."""
    return uuid.uuid4().hex[:16]


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


def _block_until_ready(tree) -> None:
    """Wait until the device work that produces ``tree`` (a tensor, or a
    dict, list or tuple of them) has finished: each CUDA device a tensor
    lies on is synchronised once. CPU tensors and other leaves need no
    wait."""
    seen = set()

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            dev = getattr(x, "device", None)
            if getattr(dev, "type", None) == "cuda":
                seen.add(dev)

    walk(tree)
    if seen:
        import torch  # lazy: the recorder itself stays stdlib-only
        for dev in seen:
            torch.cuda.synchronize(dev)


class Timer:
    """``with Timer() as t: ...`` then ``t.seconds`` — waits for
    ``block_on`` (tensors, as :func:`_block_until_ready` takes them)
    before stopping, so device work is actually counted.

    The base of the span API: a span is a Timer that also records events.
    """

    __slots__ = ("seconds", "_block_on", "_t0")

    def __init__(self, block_on=None):
        self._block_on = block_on
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._block_on is not None:
            _block_until_ready(self._block_on)
        self.seconds = time.perf_counter() - self._t0
        return False


class _Span(Timer):
    """Begin/end event pair around a region; duration and (on failure) the
    exception ride the end event."""

    __slots__ = ("_rec", "_name", "_attrs", "_span_id")

    def __init__(self, rec: "FlightRecorder", name: str, block_on=None,
                 **attrs):
        super().__init__(block_on)
        self._rec = rec
        self._name = name
        self._attrs = attrs
        self._span_id = None

    def __enter__(self):
        super().__enter__()
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
        block_err = None
        try:
            super().__exit__(exc_type, exc, tb)
        except BaseException as be:
            # the wait for the device is where an asynchronous device
            # error shows: the span that saw it still lands its end
            # event (with the error) before the exception propagates
            self.seconds = time.perf_counter() - self._t0
            block_err = be
        end = dict(self._attrs)
        end["dur_s"] = round(self.seconds, 6)
        if exc is not None:
            # A draw-time failure is tagged by the dataset with the batch
            # being drawn (data._tag_batch). The span that observed it is
            # usually the timeline's earliest error evidence, so it
            # carries the attribution too.
            bi = getattr(exc, "_sparkdl_batch_index", None)
            if bi is not None:
                end["batch_index"] = bi
                ep = getattr(exc, "_sparkdl_batch_epoch", None)
                if ep is not None:
                    end["epoch"] = ep
        if exc_type is not None:
            if exc_type in (StopIteration, GeneratorExit):
                # Normal stream exhaustion (fit's data_fetch span around
                # next()): marked, but NOT as an error — a rank that
                # finished its data must never be named the first failure.
                end["end_of_data"] = True
            else:
                end["error"] = f"{exc_type.__name__}: {exc}"[:300]
            if block_err is not None:  # both failed: record, don't mask
                end["block_error"] = \
                    f"{type(block_err).__name__}: {block_err}"[:300]
        elif block_err is not None:
            end["error"] = f"{type(block_err).__name__}: {block_err}"[:300]
        self._rec.emit(self._name, "E", end)
        if block_err is not None and exc_type is None:
            # Surface the device error from a clean region; when the
            # region already raised, its exception is the story.
            raise block_err
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

    def span(self, name: str, block_on=None, **attrs) -> _Span:
        return _Span(self, name, block_on=block_on, **attrs)

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

    def postmortem(self, exc: BaseException | None = None,
                   **attrs) -> dict:
        """Flush the ring tail + exception as a crash postmortem.

        Always returns the postmortem dict (and logs a compact line); when
        ``SPARKDL_EVENT_DIR`` is set it is also written atomically to
        ``postmortem_rank{i}.json``, where :func:`merge_timeline` reads
        it.
        """
        info: dict = {"t": round(time.time(), 6), "rank": _rank()}
        if attrs:
            info.update(attrs)
        if exc is not None:
            try:  # lazy sibling import: no package-init work on the hot path
                from .failures import exception_summary
                info["error"] = exception_summary(exc)
            except Exception:
                info["error"] = {"type": type(exc).__name__,
                                 "message": str(exc)[:2000]}
        info["events"] = self.tail(_POSTMORTEM_TAIL)
        d = os.environ.get(RECORDER_DIR_ENV)
        if d:
            try:
                os.makedirs(d, exist_ok=True)
                atomic_write_json(
                    os.path.join(d, f"postmortem_rank{_rank()}.json"), info)
            except OSError:
                pass
        err = info.get("error", {})
        log.warning("flight recorder postmortem: rank %d, %d events, "
                    "error=%s", info["rank"], len(info["events"]),
                    err.get("type") if isinstance(err, dict) else None)
        return info

    def close(self):
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
                self._dir = None


# -- process-global recorder --------------------------------------------------

_RECORDER: FlightRecorder | None = None


def get_recorder() -> FlightRecorder:
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = FlightRecorder()
    return _RECORDER


def reset(ring_size: int | None = None) -> FlightRecorder:
    """Fresh recorder (tests; ring-size changes). Closes any open stream.
    The tees are module-level and survive it."""
    global _RECORDER
    if _RECORDER is not None:
        _RECORDER.close()
    _RECORDER = FlightRecorder(ring_size=ring_size)
    return _RECORDER


def event(name: str, **attrs):
    get_recorder().event(name, **attrs)


def span(name: str, block_on=None, **attrs) -> _Span:
    return get_recorder().span(name, block_on=block_on, **attrs)


def completed_span(name: str, dur_s: float, **attrs) -> None:
    get_recorder().completed_span(name, dur_s, **attrs)


def postmortem(exc: BaseException | None = None, **attrs) -> dict:
    return get_recorder().postmortem(exc, **attrs)


def enable_flight_recorder(event_dir: str | None = None,
                           ring_size: int | None = None) -> FlightRecorder:
    """Public switch (``runner.api.enable_flight_recorder``): stream events
    to ``event_dir`` (also exported to child processes via the env var) and
    optionally resize the ring. ``event_dir=None`` keeps ring-only mode."""
    if event_dir is not None:
        os.environ[RECORDER_DIR_ENV] = event_dir
    if ring_size is not None:
        os.environ[RING_ENV] = str(ring_size)
    return reset(ring_size=ring_size)


# -- merged timeline ---------------------------------------------------------

_EVENT_FILE_RE = re.compile(r"events_rank(\d+)\.jsonl$")
_POSTMORTEM_FILE_RE = re.compile(r"postmortem_rank(\d+)\.json$")
GANG_TIMELINE_FILE = "gang_timeline.json"
# The supervisor-side span tree (trace id, run-root span, one entry per
# gang attempt) lives next to the per-rank streams and is NOT cleared per
# attempt (clear_rank_files deletes by the rank-file patterns only).
TRACE_MANIFEST_FILE = "trace_manifest.json"
_MERGE_TAIL_BYTES = 1 << 20  # per-rank read cap when merging timelines
# Survived-fault narrative: machinery that engaged and recovered (a
# dispatch retry, quarantined rows, a checkpoint rollback, a resume, a
# skipped or quarantined batch, an unverified cursor, an SLO breach and
# its recovery, a resize, a reshard). `give_up` is NOT here — an exhausted
# retry budget is failure evidence.
_DEGRADATION_EVENTS = ("retry", "quarantine", "checkpoint_rollback",
                       "checkpoint_quarantine", "train_resume",
                       "train_batch_quarantined", "train_batch_skipped",
                       "unverified_data_cursor", "slo_breach",
                       "slo_recovered", "gang_resized",
                       "checkpoint_resharded")


def atomic_write_json(path: str, obj) -> str:
    """The one tmp-file + ``os.replace`` JSON writer (postmortems,
    timelines, heartbeats and the telemetry plane's snapshots ride it): a
    reader can never observe a torn or empty body, and a kill between
    write and replace leaves only a pid-tagged .tmp file behind."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, default=str)
    os.replace(tmp, path)
    return path


def _read_jsonl_tail(path: str, cap: int = _MERGE_TAIL_BYTES):
    """Parse the last ``cap`` bytes of a JSONL stream. Returns
    (records, truncated). Bounded on purpose: failure evidence lives in
    the tail, and a reader must not load a whole capped stream."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        start = max(0, size - cap)
        f.seek(start)
        data = f.read()
    lines = data.decode("utf-8", "replace").splitlines()
    if start > 0 and lines:
        lines = lines[1:]  # the seek likely landed mid-line
    recs = []
    for line in lines:
        try:
            recs.append(json.loads(line))
        except ValueError:
            continue  # torn tail line from a killed rank
    return recs, start > 0


def clear_rank_files(event_dir: str):
    """Remove one attempt's event/postmortem files before a relaunch — the
    timeline of attempt N must not splice attempt N-1's trace. Deletes by
    the SAME patterns :func:`merge_timeline` reads (every rank, so a reused
    dir from an earlier, larger gang cannot leak a stale high-rank trace),
    and the merged ``gang_timeline.json`` too."""
    try:
        names = os.listdir(event_dir)
    except OSError:
        return
    for fn in names:
        if _EVENT_FILE_RE.match(fn) or _POSTMORTEM_FILE_RE.match(fn) \
                or fn == GANG_TIMELINE_FILE:
            try:
                os.unlink(os.path.join(event_dir, fn))
            except OSError:
                pass


def parse_heartbeat_body(body: str) -> dict:
    """The one decoder of the heartbeat format: JSON ``{"step": N,
    "time": T}`` from ``metrics.touch_heartbeat``'s atomic writer, with
    bare step-number bodies (hand-rolled workers) still accepted."""
    try:
        d = json.loads(body)
        if isinstance(d, dict):
            return {k: d[k] for k in ("step", "time") if k in d}
    except ValueError:
        pass
    return {"step": body.strip() or None}


def _read_heartbeat(path: str) -> dict | None:
    try:
        st = os.stat(path)
        with open(path) as f:
            body = f.read()
    except OSError:
        return None
    hb = {"mtime": round(st.st_mtime, 3)}
    hb.update(parse_heartbeat_body(body))
    return hb


def merge_timeline(event_dir: str, heartbeat_dir: str | None = None,
                   max_events: int = 200) -> dict:
    """Merge all ranks' event streams, postmortems, and heartbeats into one
    time-ordered timeline.

    Returns ``{"ranks": {rank: {...}}, "first_failing_rank",
    "first_failure", "first_stalled_rank", "degradations", "events"}``.
    The first-failing rank is the one with the earliest error evidence
    (chaos event, failed span, or postmortem) after its last in-process
    restart; when nothing errored (a hang), the first-*stalled* rank —
    the one whose last event or heartbeat is oldest — is the lead
    suspect.
    """
    ranks: dict[int, dict] = {}
    merged: list[dict] = []
    errors: list[dict] = []  # (t, rank, site, step, error) candidates
    recovered: list[dict] = []  # in-process restarts: second-tier evidence
    last_restart: dict[int, float] = {}  # rank -> latest restart event t
    degradations: list[dict] = []  # survived faults
    try:
        names = sorted(os.listdir(event_dir))
    except OSError:
        names = []
    for fn in names:
        m = _EVENT_FILE_RE.match(fn)
        if not m:
            continue
        rank = int(m.group(1))
        try:
            recs, truncated = _read_jsonl_tail(os.path.join(event_dir, fn))
        except OSError:
            continue
        merged.extend(recs)
        # last_step from COMPUTE evidence (step_compute spans, chaos
        # fires), not feed events: with feed_lookahead the feed's
        # data_fetch spans run steps ahead of the training loop. Any step
        # attr is the fallback for traces that never emit step_compute.
        compute_steps = [r["step"] for r in recs
                         if r.get("name") in ("step_compute", "chaos")
                         and isinstance(r.get("step"), (int, float))]
        any_steps = compute_steps or [
            r["step"] for r in recs
            if isinstance(r.get("step"), (int, float))]
        last = recs[-1] if recs else None
        ranks[rank] = {
            "n_events": len(recs),  # tail-bounded when truncated
            "last_step": int(max(any_steps)) if any_steps else None,
            "last_event": ({"t": last.get("t"), "name": last.get("name")}
                           if last else None),
        }
        if truncated:
            ranks[rank]["tail_truncated"] = True
        for r in recs:
            if r.get("name") == "chaos":
                e = {"t": r.get("t", 0), "rank": rank,
                     "site": r.get("site"), "step": r.get("step"),
                     "error": f"injected {r.get('kind')}"}
                # At the data_fetch site the hook's step IS the dataset's
                # batch index: surface it so consecutive failures can be
                # correlated to one batch.
                if r.get("site") == "data_fetch" \
                        and r.get("step") is not None:
                    e["batch_index"] = r.get("step")
                errors.append(e)
            elif r.get("name") == "restart":
                # An in-process restart (run_with_restarts) RECOVERED from
                # its error — second-tier evidence only, or it would
                # outrank the later fault that actually ended the run.
                t = r.get("t", 0)
                last_restart[rank] = max(last_restart.get(rank, 0), t)
                recovered.append({"t": t, "rank": rank,
                                  "site": r.get("name"),
                                  "step": r.get("step"),
                                  "error": r.get("error"),
                                  "recovered": True})
            elif r.get("name") in _DEGRADATION_EVENTS:
                # Engaged and recovered: narrative, never failure
                # evidence, though these events carry error text.
                degradations.append({"t": r.get("t", 0), "rank": rank,
                                     "kind": r.get("name"),
                                     "detail": {k: v for k, v in r.items()
                                                if k not in ("t", "ph",
                                                             "rank")}})
            elif "error" in r:
                e = {"t": r.get("t", 0), "rank": rank,
                     "site": r.get("name"), "step": r.get("step"),
                     "error": r["error"]}
                if r.get("batch_index") is not None:
                    e["batch_index"] = r.get("batch_index")
                errors.append(e)
    for fn in names:
        m = _POSTMORTEM_FILE_RE.match(fn)
        if not m:
            continue
        rank = int(m.group(1))
        try:
            with open(os.path.join(event_dir, fn)) as f:
                pm = json.load(f)
        except (OSError, ValueError):
            continue
        entry = ranks.setdefault(rank, {"n_events": 0, "last_step": None,
                                        "last_event": None})
        err = pm.get("error")
        entry["postmortem"] = {"t": pm.get("t"), "error": err,
                               "site": pm.get("site"),
                               "step": pm.get("step"),
                               "batch_index": pm.get("batch_index")}
        if entry["last_step"] is None and pm.get("step") is not None:
            entry["last_step"] = pm.get("step")
        if err:
            msg = err.get("message", "") if isinstance(err, dict) else \
                str(err)
            typ = err.get("type", "") if isinstance(err, dict) else ""
            e = {"t": pm.get("t", 0), "rank": rank,
                 "site": pm.get("site"), "step": pm.get("step"),
                 "error": f"{typ}: {msg}"[:300].strip(": ")}
            if pm.get("batch_index") is not None:
                e["batch_index"] = pm.get("batch_index")
            errors.append(e)
    if heartbeat_dir:
        try:
            hb_names = os.listdir(heartbeat_dir)
        except OSError:
            hb_names = []
        for fn in hb_names:
            m = re.match(r"rank(\d+)\.hb$", fn)
            if not m:
                continue
            rank = int(m.group(1))
            hb = _read_heartbeat(os.path.join(heartbeat_dir, fn))
            if hb is not None:
                ranks.setdefault(rank, {"n_events": 0, "last_step": None,
                                        "last_event": None})
                ranks[rank]["heartbeat"] = hb
    merged.sort(key=lambda r: r.get("t", 0))
    # Tiering: a rank's restart event marks everything before it on that
    # rank as survived — only evidence AFTER the last restart is terminal.
    # A recovered error is narrative, never attribution: a stall on
    # another rank outranks it.
    terminal = [e for e in errors
                if e["t"] > last_restart.get(e["rank"], -1)]
    survived = recovered + [dict(e, recovered=True) for e in errors
                            if e["t"] <= last_restart.get(e["rank"], -1)]
    candidates = terminal or survived
    first_failure = min(candidates, key=lambda e: e["t"]) \
        if candidates else None

    def _last_activity(d) -> float | None:
        """Freshest evidence a rank was alive: last event OR heartbeat (a
        rank whose stream hit its cap keeps beating)."""
        le = d.get("last_event") or {}
        hb = d.get("heartbeat") or {}
        cands = [x for x in (le.get("t"), hb.get("time"), hb.get("mtime"))
                 if isinstance(x, (int, float))]
        return max(cands) if cands else None

    stalled = None
    activity = {r: _last_activity(d) for r, d in ranks.items()}
    activity = {r: t for r, t in activity.items() if t is not None}
    if activity:
        stalled = min(activity, key=activity.get)
    # Rank attribution: terminal evidence wins; with only recovered
    # evidence the stall heuristic wins; a recovered rank is named only
    # when it is the only signal.
    if terminal:
        first_failing = first_failure["rank"]
    elif stalled is not None:
        first_failing = stalled
    else:
        first_failing = first_failure["rank"] if first_failure else None
    degradations.sort(key=lambda d: d.get("t", 0))
    return {
        "ranks": {str(r): ranks[r] for r in sorted(ranks)},
        "first_failing_rank": first_failing,
        "first_failure": first_failure,
        "first_stalled_rank": stalled,
        "degradations": degradations[-50:],
        "events": merged[-max_events:],
    }


def collect_degradations(event_dir: str) -> list[dict]:
    """Degradation events (retries, quarantines, rollbacks, resumes,
    skipped batches) from every rank's stream tail, time-ordered: what a
    run that succeeded survived."""
    out: list[dict] = []
    try:
        names = sorted(os.listdir(event_dir))
    except OSError:
        return out
    for fn in names:
        if not _EVENT_FILE_RE.match(fn):
            continue
        try:
            recs, _ = _read_jsonl_tail(os.path.join(event_dir, fn))
        except OSError:
            continue
        out.extend(r for r in recs
                   if r.get("name") in _DEGRADATION_EVENTS)
    out.sort(key=lambda r: r.get("t", 0))
    return out


def format_timeline(tl: dict) -> str:
    """Compact human rendering of :func:`merge_timeline`'s result."""
    lines = []
    ff = tl.get("first_failure")
    stalled = tl.get("first_stalled_rank")
    if ff is not None and not ff.get("recovered"):
        lines.append(
            f"gang timeline: first failure on rank {ff['rank']} at "
            f"site {ff.get('site') or '?'}"
            + (f" step {ff['step']}" if ff.get("step") is not None else "")
            + (f" batch {ff['batch_index']}"
               if ff.get("batch_index") is not None else "")
            + (f" ({ff['error']})" if ff.get("error") else ""))
    elif stalled is not None:
        line = (f"gang timeline: no terminal error recorded; rank "
                f"{stalled} stalled first")
        if ff is not None:  # recovered narrative rides as context only
            line += (f" (earlier error on rank {ff['rank']} was "
                     f"recovered in-process: {ff.get('error')})")
        lines.append(line)
    elif ff is not None:
        lines.append(
            f"gang timeline: only recovered errors on record — rank "
            f"{ff['rank']} at site {ff.get('site') or '?'}"
            + (f" ({ff['error']})" if ff.get("error") else ""))
    degr = tl.get("degradations") or []
    if degr:
        kinds = collections.Counter(d.get("kind") for d in degr)
        lines.append(
            "  survived degradations: "
            + ", ".join(f"{k} x{n}" for k, n in sorted(kinds.items())))
    for r, d in tl.get("ranks", {}).items():
        le = d.get("last_event") or {}
        hb = d.get("heartbeat") or {}
        lines.append(
            f"  rank {r}: last_step={d.get('last_step')} "
            f"last_event={le.get('name')} events={d.get('n_events')}"
            + (f" heartbeat_step={hb.get('step')}" if hb else ""))
    return "\n".join(lines)


def write_gang_postmortem(event_dir: str, tl: dict) -> str:
    """Atomically write the merged timeline next to the per-rank files."""
    return atomic_write_json(os.path.join(event_dir, GANG_TIMELINE_FILE), tl)
