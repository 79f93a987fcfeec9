"""StreamScorer — the cross-partition streaming inference engine.

The port's copy of ``sparkdl_tpu/transformers/streaming.py``, over the
port's runtime helpers. One :class:`StreamScorer` instance becomes a
``DataFrame.mapStream`` op that

- chunks every partition into device batches and decodes them on the
  parallel, order-preserving host pool (``runtime.parallel_map_iter``,
  ``SPARKDL_DECODE_WORKERS`` workers) — each decode wrapped in a ``decode``
  flight-recorder span;
- feeds the WHOLE dataset's chunk stream through one
  ``BatchRunner.run_stream`` call, partition identity and row counts riding
  host-side as the stream metadata — the pad/put/dispatch/fetch window
  never drains between partitions;
- encodes device outputs to their final Arrow form on an overlap worker
  (``encode`` spans), so the consumer loop goes straight back to fetching
  the next device result;
- reassembles one output RecordBatch per input partition, in order, with
  the int32→large_list offset promotion handled once in
  :func:`concatChunkArrays`.

Fault isolation: with ``on_error='quarantine'`` a host-side
decode/payload failure does not kill the whole job — the failing chunk is
re-decoded row by row, bad rows route to a **dead-letter side output**
(:class:`QuarantineSink`: the original row + ``error_class``/``error``
columns) and the surviving rows continue through the device stream. A
circuit breaker (``SPARKDL_MAX_QUARANTINE_FRAC``, default 0.5) fails the
job with a fatal :class:`QuarantineOverflowError` when the bad-row
fraction says the *input* is broken, not the odd record. Device-side
dispatch/fetch faults are retried with backoff inside
``BatchRunner.run_stream`` (see ``core/runtime.py``).

Peak host memory stays O(window · batchSize) decoded rows + the pending
partitions whose chunks are in flight. pyarrow is imported inside the
functions that build Arrow data, so importing this module needs none.
"""

from __future__ import annotations

import collections
import logging
import os
from typing import Callable, Iterator

import numpy as np

from ..core import ingest
from ..core.runtime import (BatchRunner, _chaos, _events, _failures,
                            _run_stats, _telemetry, parallel_map_iter)

log = logging.getLogger("sparkdl_tpu_torch.streaming")

ERROR_CLASS_COL = "error_class"
ERROR_COL = "error"


def max_quarantine_frac_default() -> float:
    """Dead-letter circuit-breaker threshold: the job fails (fatal) once
    quarantined_rows / seen_rows exceeds this fraction
    (``SPARKDL_MAX_QUARANTINE_FRAC``, default 0.5 — half the input bad
    means the pipeline, not the data, is broken)."""
    try:
        return float(os.environ.get("SPARKDL_MAX_QUARANTINE_FRAC", "0.5"))
    except ValueError:
        return 0.5


def quarantine_min_rows_default() -> int:
    """Minimum rows seen before the circuit breaker may trip MID-stream
    (``SPARKDL_QUARANTINE_MIN_ROWS``, default 100): one corrupt leading
    chunk must not read as "half the input is bad" and fatally kill a
    job whose overall bad fraction is tiny. At end of stream the breaker
    evaluates the TRUE whole-input fraction with no floor."""
    try:
        return max(1, int(
            os.environ.get("SPARKDL_QUARANTINE_MIN_ROWS", "100")))
    except ValueError:
        return 100


def concatChunkArrays(pieces: list[pa.Array]) -> pa.Array:
    """Concatenate per-chunk output arrays into one partition column.

    int32 list offsets overflow past 2**31 total values — every piece is
    promoted to large_list before concat when the total crosses that line
    (the single-piece path gets this inside ``arrayColumnToArrow``)."""
    import pyarrow as pa
    if len(pieces) == 1:
        return pieces[0]
    total = sum(len(p.values) if isinstance(
        p, (pa.ListArray, pa.LargeListArray)) else 0 for p in pieces)
    if total > np.iinfo(np.int32).max:
        pieces = [p.cast(pa.large_list(p.type.value_type))
                  if isinstance(p, pa.ListArray) else p for p in pieces]
    return pa.concat_arrays(pieces)


class QuarantineSink:
    """Collects dead-letter rows: each quarantined input row rides with an
    ``error_class`` (exception type name) and ``error`` (message) column.

    Schema is pinned from the FIRST input partition (``ensure_schema``),
    so :meth:`to_table` returns a stably-typed table even when nothing was
    quarantined — the empty-quarantine and all-rows-quarantined edges
    round-trip through Arrow identically. Consumer-thread only (the
    scorer's reassembly loop); not thread-safe by design."""

    def __init__(self):
        import pyarrow as pa
        self.batches: list[pa.RecordBatch] = []
        self.rows = 0
        self._schema: pa.Schema | None = None

    def ensure_schema(self, input_schema: pa.Schema):
        import pyarrow as pa
        if self._schema is None:
            self._schema = pa.schema(
                list(input_schema)
                + [pa.field(ERROR_CLASS_COL, pa.string()),
                   pa.field(ERROR_COL, pa.string())])

    @property
    def schema(self) -> pa.Schema | None:
        return self._schema

    def add(self, batch: pa.RecordBatch, dead: list[tuple]):
        """``dead``: ``[(row_index, error_class, message), ...]`` into
        ``batch`` — appended as one dead-letter RecordBatch."""
        import pyarrow as pa
        if not dead:
            return
        self.ensure_schema(batch.schema)
        src = batch.take(pa.array([r for r, _, _ in dead], type=pa.int64()))
        arrays = list(src.columns) + [
            pa.array([c for _, c, _ in dead], type=pa.string()),
            pa.array([m[:500] for _, _, m in dead], type=pa.string())]
        self.batches.append(pa.RecordBatch.from_arrays(
            arrays, schema=self._schema))
        self.rows += len(dead)

    def publish_to(self, dest: "QuarantineSink"):
        """Hand this run's collection to the transformer-visible sink.
        The schema pin always transfers; the dead-letter rows replace
        ``dest``'s only when this run actually quarantined something —
        so a 1-row schema probe (``DataFrame.schema`` re-invokes the
        stream op) or an early-closed ``take()`` pass cannot silently
        wipe the ledger of the last real materialization."""
        if dest._schema is None:
            dest._schema = self._schema
        if self.rows:
            dest.batches = self.batches
            dest.rows = self.rows
            dest._schema = self._schema

    def to_table(self) -> pa.Table:
        import pyarrow as pa
        if self.batches:
            return pa.Table.from_batches(self.batches)
        if self._schema is not None:
            return self._schema.empty_table()
        return pa.table({})


class StreamScorer:
    """``DataFrame.mapStream`` op scoring a column through a BatchRunner.

    Per-transformer behavior plugs in via three callables:

    - ``make_decoder(batch) -> decode(start, length) -> host_array``:
      per-partition setup (pin the target shape, resolve the feed dtype)
      returning a slice decoder — the scorer chunks the partition into
      ``chunk_rows``-row device batches itself and calls ``decode`` per
      chunk on the decode pool (and per ROW on the quarantine fallback
      path);
    - ``encode(np.ndarray) -> pa.Array``: device output chunk → its final
      Arrow representation (runs on the overlap worker);
    - ``empty_array() -> pa.Array``: output column for a zero-row
      partition.

    ``on_error='quarantine'`` arms row-level fault isolation: a chunk
    whose decode raises is retried row by row; rows that still fail (or
    decode to a deviant shape) are dead-lettered into ``sink`` and the
    scored output batch simply omits them (length-changing — pair with
    ``mapStream(..., changes_length=True)``). ``max_quarantine_frac``
    bounds the damage (default: :func:`max_quarantine_frac_default`).

    ``decoder_spec`` (optional) makes the scorer eligible for the
    PROCESS decode backend (``SPARKDL_DECODE_BACKEND=process`` — GIL-
    bound decode scales past the ~1-core thread ceiling):
    ``decoder_spec(batch) -> spec`` where ``spec(start, length)`` returns
    a PICKLABLE ``(factory, payload)`` pair — ``factory`` a module-level
    callable decoding rows of that chunk from ``payload`` with
    chunk-local indices (see ``ingest.decode_image_chunk``). Without a
    spec, a process-backend request degrades to threads with one warning
    (entries/decoders close over Arrow batches and device state — not
    picklable). Chunk decode semantics — row-fallback quarantine, the
    chaos ``decode`` site — are the ONE shared implementation
    (``ingest.decode_chunk``) on either backend.
    """

    def __init__(self, runner: BatchRunner, out_col: str,
                 make_decoder: Callable, encode: Callable,
                 empty_array: Callable, chunk_rows: int | None = None,
                 decode_workers: int | None = None,
                 on_error: str = "raise",
                 max_quarantine_frac: float | None = None,
                 sink: QuarantineSink | None = None,
                 decoder_spec: Callable | None = None):
        if on_error not in ("raise", "quarantine"):
            raise ValueError(f"on_error must be 'raise' or 'quarantine', "
                             f"got {on_error!r}")
        self.runner = runner
        self.out_col = out_col
        self.make_decoder = make_decoder
        self.encode = encode
        self.empty_array = empty_array
        self.chunk_rows = int(chunk_rows or runner.batch_size)
        self.decode_workers = decode_workers
        self.on_error = on_error
        self.decoder_spec = decoder_spec
        self.max_quarantine_frac = (
            max_quarantine_frac if max_quarantine_frac is not None
            else max_quarantine_frac_default())
        self.sink = sink if sink is not None else (
            QuarantineSink() if on_error == "quarantine" else None)

    # -- stages ------------------------------------------------------------
    def _decode(self, item):
        """Decode one chunk (thread-pool path). Returns ``(array_or_None,
        info)`` — ``info`` is None in raise mode; in quarantine mode it
        carries the chunk length and the dead rows so ALL sink / counter
        mutation happens later on the consumer thread. The chunk/row-
        fallback protocol itself is the shared ``ingest.decode_chunk``."""
        decoder, start, length = item
        with _events().span("decode", rows=length):
            return ingest.decode_chunk(decoder, start, length,
                                       self.on_error == "quarantine")

    def _encode(self, result: np.ndarray) -> pa.Array:
        with _events().span("encode", rows=len(result)):
            return self.encode(result)

    def _finish(self, entry: dict, sink: QuarantineSink | None
                ) -> pa.RecordBatch:
        import pyarrow as pa
        batch = entry["batch"]
        dead = entry["dead"]
        scored = batch
        if dead:
            if sink is not None:
                sink.add(batch, dead)
            dead_rows = {r for r, _, _ in dead}
            keep = [i for i in range(batch.num_rows) if i not in dead_rows]
            scored = (batch.take(pa.array(keep, type=pa.int64())) if keep
                      else batch.slice(0, 0))
        from ..core.frame import _set_column
        pieces = [f.result() for f in entry["futs"]]
        if not pieces:
            return _set_column(scored, self.out_col, self.empty_array())
        return _set_column(scored, self.out_col, concatChunkArrays(pieces))

    # -- the stream op -----------------------------------------------------
    def __call__(self, parts: Iterator[pa.RecordBatch]
                 ) -> Iterator[pa.RecordBatch]:
        from concurrent.futures import ThreadPoolExecutor
        ev = _events()
        tel = _telemetry()
        # env-armed (SPARKDL_METRICS_DIR / SPARKDL_METRICS_PORT); two dict
        # lookups and the plane stays off when neither is set
        tel.maybe_start_from_env()
        pending_gauge = backlog_gauge = None
        if tel.enabled():
            # Live queue-depth gauges: `pending` = partitions
            # whose chunks are still in flight (reassembly latency),
            # `backlog` = fetched-but-unencoded raw outputs parked on the
            # overlap worker (encode falling behind the device).
            pending_gauge = tel.registry().gauge("scorer_pending_partitions")
            backlog_gauge = tel.registry().gauge("scorer_encode_backlog")
        # Entries appear here in partition order as the chunk producer
        # (pulled on this thread through the decode pool / put window)
        # walks the input; each holds its RecordBatch and expected chunk
        # count host-side — the row-count bookkeeping the continuous
        # device stream does not carry.
        pending: collections.deque[dict] = collections.deque()
        totals = {"seen": 0, "quarantined": 0}
        # Each invocation (one materialization of the lazy result)
        # collects into its OWN sink, published to the transformer-
        # visible one only at completion — see QuarantineSink.publish_to.
        run_sink = QuarantineSink() if self.sink is not None else None
        min_rows = quarantine_min_rows_default()

        def breaker_check(floor: int):
            if totals["seen"] >= floor and totals["quarantined"] > \
                    self.max_quarantine_frac * totals["seen"]:
                raise _failures().QuarantineOverflowError(
                    totals["quarantined"], totals["seen"],
                    self.max_quarantine_frac)

        # Decode backend resolution: the process pool needs
        # picklable tasks, which only scorers WITH a decoder_spec can
        # build; everything else rides threads exactly as before. The
        # chunk FIFO pairs each in-order decode result back with its
        # partition entry (entries hold RecordBatches and futures — they
        # never cross the process boundary).
        process_mode = ingest.decode_backend_default() == "process" \
            and (self.decode_workers is None or self.decode_workers > 0)
        if process_mode and self.decoder_spec is None:
            log.warning(
                "SPARKDL_DECODE_BACKEND=process but this scorer has no "
                "decoder_spec (its decoder closes over un-picklable "
                "state); decoding on threads instead")
            process_mode = False
        quarantine = self.on_error == "quarantine"
        chaos_json = None
        if process_mode:
            plan = _chaos().active_plan()
            chaos_json = plan.to_json() if plan is not None else None
        fifo: collections.deque[tuple] = collections.deque()

        def chunk_stream():
            for rb in parts:
                if run_sink is not None and rb.num_rows == 0 \
                        and run_sink.schema is None:
                    run_sink.ensure_schema(rb.schema)
                decoder = spec = None
                if rb.num_rows:
                    if process_mode:
                        spec = self.decoder_spec(rb)
                    else:
                        decoder = self.make_decoder(rb)
                starts = range(0, rb.num_rows, self.chunk_rows)
                entry = {"batch": rb, "n_chunks": len(starts), "futs": [],
                         "n_skipped": 0, "dead": []}
                pending.append(entry)
                for s in starts:
                    length = min(self.chunk_rows, rb.num_rows - s)
                    fifo.append((entry, s, length))
                    if process_mode:
                        factory, payload = spec(s, length)
                        yield (factory, payload, length, quarantine,
                               chaos_json)
                    else:
                        yield (decoder, s, length)

        def complete(entry: dict) -> bool:
            return len(entry["futs"]) + entry["n_skipped"] \
                == entry["n_chunks"]

        decoded = parallel_map_iter(
            ingest.run_decode_task if process_mode else self._decode,
            chunk_stream(), workers=self.decode_workers,
            maxsize=max(self.runner.prefetch, 1),
            backend="process" if process_mode else "thread")

        def device_stream():
            """Consumer-thread filter between the decode pool and the
            device window: records quarantine bookkeeping (sink schema,
            entry dead rows, counters, the circuit breaker) and drops
            chunks with no surviving rows."""
            for res in decoded:
                entry, start, length = fifo.popleft()
                if process_mode:
                    arr, info, dur_s = res
                    # The decode ran in a pool child whose recorder dies
                    # with it — land the span HERE so stage accounting /
                    # bottleneck reports still see decode time.
                    ev.completed_span("decode", dur_s, rows=length)
                    if info is not None and info["dead"]:
                        # child indices are chunk-local; re-base onto the
                        # partition batch
                        info = {"length": info["length"],
                                "dead": [(start + j, c, m)
                                         for j, c, m in info["dead"]]}
                else:
                    arr, info = res
                if info is not None:
                    totals["seen"] += info["length"]
                    if run_sink is not None and run_sink.schema is None:
                        run_sink.ensure_schema(entry["batch"].schema)
                    dead = info["dead"]
                    if dead:
                        entry["dead"].extend(dead)
                        totals["quarantined"] += len(dead)
                        _run_stats().record_quarantine(len(dead))
                        ev.event("quarantine", rows=len(dead),
                                 error_class=dead[0][1],
                                 total=totals["quarantined"])
                        # Mid-stream the breaker needs a sample-size
                        # floor — one corrupt leading chunk is not "half
                        # the input is bad".
                        breaker_check(min_rows)
                if arr is None or not len(arr):
                    entry["n_skipped"] += 1
                    continue
                yield arr, entry

        encode_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="sparkdl-encode")
        # Backpressure for the overlap worker: un-encoded RAW outputs are
        # full float32 chunks, so an encode slower than the device fetch
        # (image-mode nhwcToStructs on a huge partition) must throttle the
        # consumer loop before a partition's worth of raw output piles up
        # on the host — the O(window · batchSize) contract. Encoded
        # results are the compact final column form and may accumulate
        # per pending partition, exactly as the per-partition design did.
        backlog: collections.deque = collections.deque()
        max_backlog = max(2, int(getattr(self.runner, "prefetch", 2)))
        try:
            for out, entry in self.runner.run_stream(device_stream()):
                # Hand the Arrow encode to the overlap worker and go
                # straight back to the device stream — the feed waits on
                # encoding only past the bounded backlog.
                while backlog and backlog[0].done():
                    backlog.popleft()
                if len(backlog) >= max_backlog:
                    backlog.popleft().result()
                fut = encode_pool.submit(self._encode, np.asarray(out))
                backlog.append(fut)
                entry["futs"].append(fut)
                while pending and complete(pending[0]):
                    yield self._finish(pending.popleft(), run_sink)
                if pending_gauge is not None:
                    pending_gauge.set(len(pending))
                    backlog_gauge.set(len(backlog))
            # End of stream: the breaker now knows the TRUE whole-input
            # bad fraction — evaluate it with no sample-size floor.
            breaker_check(1)
            while pending:
                yield self._finish(pending.popleft(), run_sink)
            if run_sink is not None:
                run_sink.publish_to(self.sink)
        finally:
            encode_pool.shutdown(wait=False, cancel_futures=True)
