"""The port's request traces, live inspector and SLO monitor held
against the JAX package's.

Twins of ``tests/test_request_trace.py``'s ``TestTraceCollector``,
``TestAttributionDriftGuard`` (reading the port's engine source),
``TestOffPlaneOverhead``, ``TestIntrospect``, ``TestSloMonitor`` and
``TestEngineInspectorIntegrity``, on the port's ``StubBackend`` engines,
with the reference's assertions. The offline assembly reads the streamed
``events_rank0.jsonl`` line by line (the reports over a whole event dir,
``analysis.load_event_dir`` and its CLIs, are held in
``test_torch_analysis.py``).
Beside them, one side-by-side test runs the same Stub workload through
both packages' engines with the plane armed: the trace blocks agree in
request count, stage names and the order of stages (durations are not
compared).

Every HTTP endpoint binds port 0; every wait has its own timeout.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
import os
import re
import time
import urllib.request

import pytest

from sparkdl_tpu.runner import events as jevents
from sparkdl_tpu.runner import slo as jslo
from sparkdl_tpu.runner import telemetry as jtelemetry
from sparkdl_tpu.serving import GenerationEngine as JEngine
from sparkdl_tpu.serving import StubBackend as JStub
from sparkdl_tpu_torch.runner import events, slo, telemetry
from sparkdl_tpu_torch.serving import (ENGINE_SCOPED_EVENTS, PREFILLING,
                                       REQUEST_SCOPED_EVENTS,
                                       GenerationEngine, StubBackend,
                                       introspect)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_plane(monkeypatch):
    """Fresh planes, recorders and SLO monitors in both packages per
    test; SLO env never leaks."""
    for v in ("SPARKDL_SLO_TTFT_S", "SPARKDL_SLO_LATENCY_S",
              "SPARKDL_SLO_ERROR_RATE", "SPARKDL_SLO_TARGET",
              "SPARKDL_SLO_WINDOWS_S", "SPARKDL_SLO_BURN_THRESHOLD",
              "SPARKDL_TRACE_RING", "SPARKDL_TRACE_SLOWEST",
              "SPARKDL_EVENT_DIR", "SPARKDL_METRICS_DIR",
              "SPARKDL_METRICS_PORT"):
        monkeypatch.delenv(v, raising=False)
    for mod in (telemetry, jtelemetry, slo, jslo, events, jevents):
        mod.reset()
    yield
    for mod in (telemetry, jtelemetry, slo, jslo, events, jevents):
        mod.reset()


def _drain(eng, handles, timeout=30):
    eng.run_until_idle()
    for h in handles:
        assert h.wait(timeout)


def _load_event_dir(d):
    """Every record of the JSONL streams in ``d``."""
    recs = []
    for fn in sorted(os.listdir(d)):
        if fn.startswith("events_rank") and fn.endswith(".jsonl"):
            with open(os.path.join(d, fn)) as f:
                recs += [json.loads(ln) for ln in f if ln.strip()]
    return recs


# ---------------------------------------------------------------------------
# Trace assembly
# ---------------------------------------------------------------------------

class TestTraceCollector:
    def test_engine_run_assembles_traces_summing_to_latency(self):
        """The invariant: every completed request has a trace
        whose phases sum to its measured latency within 5%
        (unattributed_s bounded)."""
        telemetry.start()
        eng = GenerationEngine(StubBackend(4, 128, step_s=0.001),
                               prefill_chunk=8)
        hs = [eng.submit([1 + i, 2, 3], max_new_tokens=12)
              for i in range(10)]
        _drain(eng, hs)
        traces = telemetry.request_traces().traces()
        assert len(traces) == 10
        for t in traces:
            assert t["finish"] == "length"
            assert t["tokens_out"] == 12
            assert t["latency_s"] > 0
            assert abs(t["unattributed_s"]) <= 0.05 * t["latency_s"]
            total = (t["queue_s"] + t["prefill_s"] + t["prefill_wait_s"]
                     + t["decode_s"] + t["unattributed_s"])
            assert total == pytest.approx(t["latency_s"], abs=1e-4)
            assert t["ttft_s"] is not None
            assert t["dominant_phase"] in t["phases"]

    def test_slowest_and_ring_bounds(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_TRACE_RING", "8")
        monkeypatch.setenv("SPARKDL_TRACE_SLOWEST", "3")
        telemetry.start()
        eng = GenerationEngine(StubBackend(2, 64, step_s=0.0002),
                               prefill_chunk=8)
        hs = [eng.submit([1 + i, 2], max_new_tokens=4)
              for i in range(20)]
        _drain(eng, hs)
        col = telemetry.request_traces()
        assert len(col.traces()) == 8          # ring bound
        slowest = col.slowest()
        assert len(slowest) == 3               # slowest-N bound
        lats = [t["latency_s"] for t in slowest]
        assert lats == sorted(lats, reverse=True)
        summ = col.summary()
        assert summ["completed"] == 20
        assert summ["in_ring"] == 8
        assert len(summ["slowest"]) == 3

    def test_quarantined_request_finalizes_as_error(self):
        class FailingPrefill(StubBackend):
            def prefill_chunk(self, *a, **kw):
                raise RuntimeError("poisoned prompt")

        telemetry.start()
        eng = GenerationEngine(FailingPrefill(2, 64), retries=1,
                               prefill_chunk=8)
        h = eng.submit([1, 2, 3], max_new_tokens=4)
        eng.run_until_idle()
        assert h.state == "failed"
        traces = telemetry.request_traces().traces()
        assert len(traces) == 1
        assert traces[0]["finish"] == "error"
        assert traces[0]["retries"] >= 1

    def test_spec_and_preemption_fields(self):
        """Paged + speculative run: traces carry the spec ledger (mean
        accept length) and preemption/block-stall evidence when the
        pool is tight."""
        telemetry.start()
        eng = GenerationEngine(
            StubBackend(4, 128, vocab_size=8, block_size=8,
                        pool_blocks=12), prefill_chunk=8, spec_k=2)
        hs = [eng.submit([1, 2, 3], max_new_tokens=20)
              for _ in range(6)]
        _drain(eng, hs)
        traces = telemetry.request_traces().traces()
        assert len(traces) == 6
        spec = [t for t in traces if t["spec_windows"] > 0]
        assert spec, "speculation ran but no trace carries its ledger"
        for t in spec:
            assert 1.0 <= t["spec_mean_accept_len"] <= 3.0
        assert eng.stats["preemptions"] == sum(
            t["preemptions"] for t in traces)

    def test_offline_assembly_matches_live(self, tmp_path, monkeypatch):
        """request_report's offline fold and the live tee are the same
        implementation: traces assembled from the streamed JSONL equal
        the live collector's."""
        monkeypatch.setenv("SPARKDL_EVENT_DIR", str(tmp_path))
        events.reset()
        telemetry.start()
        eng = GenerationEngine(StubBackend(2, 64, step_s=0.0005),
                               prefill_chunk=8)
        hs = [eng.submit([1 + i, 2], max_new_tokens=6)
              for i in range(5)]
        _drain(eng, hs)
        live = {t["request"]: t
                for t in telemetry.request_traces().traces()}
        telemetry.stop()
        events.reset()  # close the stream
        recs = _load_event_dir(str(tmp_path))
        offline = {t["request"]: t for t in
                   telemetry.assemble_request_traces(recs).traces()}
        assert live.keys() == offline.keys()
        for rid, t in live.items():
            assert offline[rid] == t


# ---------------------------------------------------------------------------
# Drift guard: serve_* attribution
# ---------------------------------------------------------------------------

class TestAttributionDriftGuard:
    def test_every_emitted_serve_event_is_classified_and_attributed(
            self):
        """Drive every scheduler path (chunked, blocking, paged +
        preemption, speculation, retry + quarantine, reject) with a tee
        capturing records: every serve_* name must be classified in
        exactly one scope set, and every REQUEST-scoped record must
        carry request= — the trace collector silently degrades without
        it."""
        seen: list = []
        events.add_tee(
            lambda rec: seen.append(dict(rec))
            if str(rec.get("name", "")).startswith("serve_") else None)
        try:
            # chunked + spec
            eng = GenerationEngine(StubBackend(2, 64, vocab_size=8),
                                   prefill_chunk=8, spec_k=2)
            hs = [eng.submit([1, 2, 3], max_new_tokens=8)
                  for _ in range(3)]
            _drain(eng, hs)
            # blocking
            engb = GenerationEngine(StubBackend(2, 64),
                                    stall_free=False)
            hb = engb.submit([1, 2, 3], max_new_tokens=4)
            _drain(engb, [hb])
            # paged, pool tight enough to preempt and admission-wait
            engp = GenerationEngine(
                StubBackend(4, 128, block_size=8, pool_blocks=10),
                prefill_chunk=8)
            hp = [engp.submit([1, 2, 3], max_new_tokens=24)
                  for _ in range(6)]
            _drain(engp, hp)
            assert engp.stats["preemptions"] > 0 \
                or engp.stats["block_stall_events"] > 0

            # prefill failure: retry then quarantine
            class Flaky(StubBackend):
                def prefill_chunk(self, *a, **kw):
                    raise RuntimeError("boom")

            engf = GenerationEngine(Flaky(1, 64), retries=1,
                                    prefill_chunk=8)
            hf = engf.submit([1, 2], max_new_tokens=2)
            engf.run_until_idle()
            assert hf.state == "failed"

            # blocking-path prefill failure (serve_prefill_retry)
            class FlakyBlocking(StubBackend):
                def prefill(self, *a, **kw):
                    raise RuntimeError("boom")

            engfb = GenerationEngine(FlakyBlocking(1, 64), retries=1,
                                     stall_free=False)
            hfb = engfb.submit([1, 2], max_new_tokens=2)
            engfb.run_until_idle()
            assert hfb.state == "failed"

            # decode-step failure: step retry + suspect eviction
            class FlakyStep(StubBackend):
                def step(self, active):
                    raise RuntimeError("step boom")

            engs = GenerationEngine(FlakyStep(1, 64), retries=1,
                                    prefill_chunk=8)
            hs2 = engs.submit([1, 2], max_new_tokens=4)
            engs.run_until_idle()
            assert hs2.state == "failed"
            # rejection (pre-admission — engine-scoped by design)
            with pytest.raises(Exception):
                eng.submit([], max_new_tokens=2)
        finally:
            events._TEES.clear()
        names = {r["name"] for r in seen}
        unclassified = names - REQUEST_SCOPED_EVENTS \
            - ENGINE_SCOPED_EVENTS
        assert not unclassified, (
            f"new serve_* emissions must be classified request- or "
            f"engine-scoped: {sorted(unclassified)}")
        for r in seen:
            if r["name"] in REQUEST_SCOPED_EVENTS:
                assert "request" in r, \
                    f"{r['name']} dropped request= attribution: {r}"
        # the paths above must actually exercise the interesting names
        assert {"serve_queue", "serve_prefill", "serve_decode",
                "serve_request_quarantined",
                "serve_prefill_chunk_retry", "serve_prefill_retry",
                "serve_step_retry", "serve_reject"} <= names

    def test_engine_source_emissions_all_classified(self):
        """Static completeness: every serve_* literal passed to
        events.event/span/completed_span in engine.py appears in one of
        the scope sets — adding an emission without classifying it
        fails here even if no runtime path above reaches it."""
        src = open(os.path.join(
            _REPO, "sparkdl_tpu_torch", "serving", "engine.py")).read()
        emitted = set(re.findall(
            r"events\.(?:event|span|completed_span)\(\s*\n?\s*"
            r"['\"](serve_[a-z_]+)['\"]", src))
        assert emitted, "expected serve_* emissions in engine.py"
        unclassified = emitted - REQUEST_SCOPED_EVENTS \
            - ENGINE_SCOPED_EVENTS
        assert not unclassified, sorted(unclassified)


# ---------------------------------------------------------------------------
# Off-plane overhead pins
# ---------------------------------------------------------------------------

class TestOffPlaneOverhead:
    def test_zero_registration_and_no_tee_when_plane_off(self):
        """Plane off: no tee (collector included), zero metric
        registration from a full engine run (slo gauges included), no
        traces collected."""
        assert events._TEES == []
        eng = GenerationEngine(StubBackend(2, 64, vocab_size=8),
                               prefill_chunk=8, spec_k=2)
        hs = [eng.submit([1, 2, 3], max_new_tokens=8)
              for _ in range(3)]
        _drain(eng, hs)
        assert events._TEES == []
        assert telemetry.registry().snapshot() == {
            "counters": {}, "gauges": {}, "histograms": {}}
        assert telemetry.request_traces().traces() == []
        assert telemetry.request_traces().summary() is None
        # and the snapshot carries neither a traces nor an slo block
        snap = telemetry.snapshot()
        assert "request_traces" not in snap
        assert "slo" not in snap

    def test_no_per_token_event_cost(self):
        """The per-request emission count is independent of output
        length: tracing attribution rides the three lifecycle spans,
        never per-token events."""
        def count_serve_records(max_new):
            rec = events.reset()
            eng = GenerationEngine(StubBackend(1, 256),
                                   prefill_chunk=8)
            h = eng.submit([1, 2, 3], max_new_tokens=max_new)
            _drain(eng, [h])
            return sum(1 for r in rec.tail()
                       if str(r.get("name", "")).startswith("serve_"))

        assert count_serve_records(4) == count_serve_records(64)

    def test_slo_monitor_off_without_env(self):
        assert slo.monitor() is None
        assert slo.evaluate({"t": time.time()}) is None


# ---------------------------------------------------------------------------
# Live engine inspector (/serving)
# ---------------------------------------------------------------------------

class TestIntrospect:
    def test_debug_state_paged_engine(self):
        eng = GenerationEngine(
            StubBackend(3, 64, block_size=8, pool_blocks=30),
            prefill_chunk=8)
        h = eng.submit([1, 2, 3, 4, 5], max_new_tokens=4)
        st = eng.debug_state()
        assert st["num_slots"] == 3
        assert st["queue"]["depth"] == 1
        assert st["queue"]["head"]["request"] == h.id
        assert st["queue"]["head"]["age_s"] >= 0
        assert [s["slot"] for s in st["slots"]] == [0, 1, 2]
        assert all(s["state"] == "idle" for s in st["slots"])
        assert all("kv_blocks" in s for s in st["slots"])
        assert "blocks_free" in st["kv_pool"]
        eng.run_until_idle()
        st = eng.debug_state()
        assert st["slots_busy"] == 0
        assert st["stats"]["completed"] == 1
        assert st["fatal"] is None

    def test_debug_state_mid_run_slot_map(self):
        eng = GenerationEngine(StubBackend(2, 64), prefill_chunk=8)
        eng.submit([1, 2, 3], max_new_tokens=4)
        eng.submit([4, 5, 6], max_new_tokens=4)
        eng._admit()
        st = eng.debug_state()
        busy = [s for s in st["slots"] if s["state"] != "idle"]
        assert len(busy) == 2
        for s in busy:
            assert s["state"] == "prefilling"
            assert s["chunks_total"] == 1
            assert s["tokens_out"] == 0
        eng.run_until_idle()

    def test_serving_endpoint_live(self):
        """/serving on the telemetry HTTP server returns every live
        engine's state as JSON."""
        telemetry.start(port=0)
        port = telemetry.server_port()
        assert port is not None
        eng = GenerationEngine(StubBackend(2, 64), prefill_chunk=8)
        eng.submit([1, 2, 3], max_new_tokens=4)
        eng._admit()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/serving", timeout=10) as resp:
            body = json.loads(resp.read().decode())
        ours = [e for e in body["engines"]
                if e.get("backend") == "StubBackend"
                and e.get("slots_busy", 0) > 0]
        assert ours, body
        assert ours[0]["slots"][0]["state"] == "prefilling"
        eng.run_until_idle()


# ---------------------------------------------------------------------------
# SLO monitor
# ---------------------------------------------------------------------------

def _hist(bounds, buckets, count=None, s=0.0):
    return {"bounds": list(bounds), "buckets": list(buckets),
            "count": count if count is not None else buckets[-1],
            "sum": s}


class TestSloMonitor:
    def test_fraction_below(self):
        h = _hist((0.1, 1.0, 10.0), [50, 90, 100])
        assert telemetry.histogram_fraction_below(h, 0.1) == 0.5
        # interpolated inside (0.1, 1.0]: 50 + 40*(0.55-0.1)/0.9 = 70
        assert telemetry.histogram_fraction_below(h, 0.55) == \
            pytest.approx(0.7, abs=1e-6)
        assert telemetry.histogram_fraction_below(h, 10.0) == 1.0
        assert telemetry.histogram_fraction_below(h, 100.0) == 1.0
        assert telemetry.histogram_fraction_below({}, 1.0) is None
        # +Inf-bucket observations count as above any finite threshold
        h2 = _hist((0.1,), [5], count=10)
        assert telemetry.histogram_fraction_below(h2, 0.5) == 0.5

    def test_burn_rate_windows_and_breach_flip(self, monkeypatch):
        """Synthetic history: compliant traffic, then a burst of
        violations — burn must exceed the threshold in every window and
        the breach event fire exactly once per transition."""
        monkeypatch.setenv("SPARKDL_SLO_TTFT_S", "1.0")
        mon = slo.SloMonitor(slo.objectives_from_env(),
                             windows_s=(10.0, 60.0))
        rec = events.reset()

        def snap_at(t, good, bad):
            return {"t": t, "histograms": {"serving_ttft_s": _hist(
                (1.0, 5.0), [good, good + bad])}}

        b0 = mon.evaluate(snap_at(1000.0, 100, 0))
        ob = b0["objectives"]["ttft"]
        assert ob["compliance"] == 1.0 and not ob["breaching"]
        # 30s later: 100 new requests, 10 violations — burn 10x in both
        # the 10s and 60s windows (window diffs vs history)
        b1 = mon.evaluate(snap_at(1030.0, 190, 10))
        ob = b1["objectives"]["ttft"]
        assert ob["breaching"] is True
        assert ob["burn_rate"] == pytest.approx(10.0, rel=0.01)
        names = [e["name"] for e in rec.tail()]
        assert names.count("slo_breach") == 1
        # recovery: clean traffic, short window clean -> not breaching
        b2 = mon.evaluate(snap_at(1045.0, 290, 10))
        assert b2["objectives"]["ttft"]["breaching"] is False
        names = [e["name"] for e in rec.tail()]
        assert names.count("slo_recovered") == 1

    def test_error_rate_objective(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_SLO_ERROR_RATE", "0.1")
        mon = slo.SloMonitor(slo.objectives_from_env(),
                             windows_s=(10.0,))
        c0 = {"t": 0.0, "counters": {
            "serving_requests_completed_total": 90.0,
            "serving_requests_quarantined_total": 0.0}}
        mon.evaluate(c0)
        c1 = {"t": 20.0, "counters": {
            "serving_requests_completed_total": 140.0,
            "serving_requests_quarantined_total": 50.0}}
        ob = mon.evaluate(c1)["objectives"]["errors"]
        # window: 50 completed + 50 errors -> error rate 0.5, burn 5x
        assert ob["breaching"] is True
        assert ob["burn_rate"] == pytest.approx(5.0, rel=0.01)

    def test_plane_snapshot_carries_slo_block_and_gauges(
            self, monkeypatch):
        monkeypatch.setenv("SPARKDL_SLO_TTFT_S", "0.001")
        monkeypatch.setenv("SPARKDL_SLO_WINDOWS_S", "5,30")
        slo.reset()
        telemetry.start()
        eng = GenerationEngine(StubBackend(2, 64, step_s=0.002),
                               prefill_chunk=8)
        hs = [eng.submit([1 + i, 2], max_new_tokens=4)
              for i in range(4)]
        _drain(eng, hs)
        snap = telemetry.snapshot()  # every TTFT > 1ms: burning
        ob = snap["slo"]["objectives"]["ttft"]
        assert ob["breaching"] is True
        telemetry.snapshot()  # gauges land for the NEXT read
        gauges = telemetry.registry().snapshot()["gauges"]
        assert gauges["slo_ttft_burn_rate"]["value"] > 1.0
        assert gauges["slo_ttft_compliance"]["value"] < 0.99

    def test_armed_objective_without_traffic_registers_no_gauges(
            self, monkeypatch):
        """An armed objective that has seen NO traffic must export
        nothing — a default-0.0 compliance gauge would read as a total
        SLO failure when the truth is 'no data'."""
        monkeypatch.setenv("SPARKDL_SLO_TTFT_S", "1.0")
        slo.reset()
        telemetry.start()
        telemetry.snapshot()
        telemetry.snapshot()
        assert telemetry.registry().snapshot()["gauges"] == {}

    def test_compliance_from_traces(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_SLO_TTFT_S", "0.5")
        monkeypatch.setenv("SPARKDL_SLO_LATENCY_S", "2.0")
        monkeypatch.setenv("SPARKDL_SLO_ERROR_RATE", "0.3")
        traces = [
            {"ttft_s": 0.1, "latency_s": 1.0, "finish": "length"},
            {"ttft_s": 0.9, "latency_s": 3.0, "finish": "length"},
            {"ttft_s": None, "latency_s": 0.2, "finish": "error"},
        ]
        out = slo.compliance_from_traces(traces)
        assert out["ttft"]["compliance"] == 0.5
        # latency population mirrors the live histogram: COMPLETED
        # requests only (the engine observes serving_request_latency_s
        # at _retire) — the 0.2s error trace is excluded, so 1 of the
        # 2 completed traces is under the 2.0s threshold
        assert out["latency"]["compliance"] == 0.5
        assert out["errors"]["compliance"] == pytest.approx(2 / 3)
        assert out["errors"]["met"] is False
        # a partial trace (fabricated attributed-sum latency) is
        # excluded from the latency population too
        traces.append({"ttft_s": None, "latency_s": 0.01,
                       "partial": True, "finish": "length"})
        out2 = slo.compliance_from_traces(traces)
        assert out2["latency"]["compliance"] == 0.5
        assert out2["latency"]["total"] == 2


class TestEngineInspectorIntegrity:
    def test_introspect_registry_is_weak(self):
        import gc
        import weakref
        eng = GenerationEngine(StubBackend(1, 32))
        assert eng in introspect.live_engines()
        wr = weakref.ref(eng)
        del eng
        gc.collect()
        # the registry holds no strong ref: the engine is collectable
        # and therefore gone from the live list
        assert wr() is None
        assert all(wr() is not e for e in introspect.live_engines())

    def test_serving_snapshot_degrades_per_engine(self):
        eng = GenerationEngine(StubBackend(1, 32))
        eng.backend.pool_stats = None  # not callable -> fine
        snap = introspect.serving_snapshot()
        assert snap["n_engines"] >= 1
        assert all("slots" in e or "error" in e
                   for e in snap["engines"])

    def test_debug_state_exposes_failover_and_delivery_cursors(self):
        """The /serving view carries the failover state
        machine block, and each occupied slot row shows the exactly-once
        audit fields (delivery cursor + per-request failover count)."""
        eng = GenerationEngine(StubBackend(1, 32, vocab_size=997))
        eng.submit([5], max_new_tokens=8)
        for _ in range(3):
            eng.step()
        state = introspect.engine_debug_state(eng)
        fo = state["failover"]
        assert fo["state"] == "healthy"
        assert fo["count"] == 0 and fo["quarantined_total"] == 0
        row = state["slots"][0]
        assert row["state"] == "running"
        # the delivery cursor must sit exactly at the emitted frontier
        # at every iteration boundary — that equality IS exactly-once
        assert row["delivered"] == row["tokens_out"] > 0
        assert row["failovers"] == 0
        # snapshot() (the aggregate-counters view) carries it too
        assert eng.snapshot()["failover"]["state"] == "healthy"


# ---------------------------------------------------------------------------
# Side by side: the same workload's trace blocks in both packages
# ---------------------------------------------------------------------------

def _trace_shape(eng_cls, stub_cls, tel, ev):
    tel.start()
    seen = []

    def tee(rec):
        if rec.get("request") is not None and \
                str(rec.get("name", "")).startswith("serve_") and \
                rec.get("ph") in ("E", "P"):
            seen.append((rec["request"], rec["name"], rec["ph"]))

    ev.add_tee(tee)
    try:
        eng = eng_cls(stub_cls(2, 64, vocab_size=8, block_size=8,
                               pool_blocks=10), prefill_chunk=8, spec_k=2)
        hs = [eng.submit([1 + i, 2, 3], max_new_tokens=16)
              for i in range(5)]
        _drain(eng, hs)
        traces = tel.request_traces().traces()
        summ = tel.request_traces().summary()
        snap = tel.snapshot()
    finally:
        ev.remove_tee(tee)
        tel.stop()
    order = {}
    for rid, name, ph in seen:  # ids differ: the port's are process-wide
        order.setdefault(rid, []).append((name, ph))
    return {
        "completed": summ["completed"],
        "in_ring": summ["in_ring"],
        "snapshot_completed": snap["request_traces"]["completed"],
        "requests": len({t["request"] for t in traces}),
        "keys": sorted({k for t in traces for k in t}),
        "phases": [sorted(t["phases"]) for t in traces],
        "finish": [t["finish"] for t in traces],
        "tokens_out": [t["tokens_out"] for t in traces],
        "counts": [(t["retries"], t["preemptions"], t["spec_windows"])
                   for t in traces],
        "stage_order": [order[r] for r in sorted(order)],
    }


def test_trace_blocks_match_reference():
    """Paged, tight pool (preemptions), speculation: request count, stage
    names and each request's order of stages equal the JAX package's."""
    ours = _trace_shape(GenerationEngine, StubBackend, telemetry, events)
    ref = _trace_shape(JEngine, JStub, jtelemetry, jevents)
    assert ours["completed"] == 5
    assert ours == ref


def test_two_engines_in_one_process_keep_their_traces_apart():
    """The port numbers requests process-wide, so two engines stepped in
    turn (a fleet's replicas) give one whole trace a request, each
    summing to its latency. The JAX package numbers each engine's
    requests from 0, and its collector folds the two engines' request i
    together: half its traces come out partial (the recorded
    difference)."""
    def traces(eng_cls, stub_cls, tel):
        tel.start()
        engines = [eng_cls(stub_cls(2, 64, step_s=0.001), prefill_chunk=8)
                   for _ in range(2)]
        hs = [e.submit([1 + i, 2, 3], max_new_tokens=4)
              for e in engines for i in range(3)]
        while any([e.step() for e in engines]):  # in turn, as a fleet
            pass                                 # steps its replicas
        assert all(h.wait(30) for h in hs)
        out = tel.request_traces().traces()
        tel.stop()
        return out

    ours = traces(GenerationEngine, StubBackend, telemetry)
    assert len(ours) == len({t["request"] for t in ours}) == 6
    for t in ours:
        assert not t.get("partial")
        assert abs(t["unattributed_s"]) <= 0.05 * t["latency_s"]
    ref = traces(JEngine, JStub, jtelemetry)
    assert sum(bool(t.get("partial")) for t in ref) == 3


@pytest.mark.parametrize("stint", ["decode", "prefill"])
def test_a_drained_request_resumed_elsewhere_keeps_its_time(stint):
    """A request drained from one engine mid-stint and resumed on another
    (a fleet's re-admission, which keeps the request and its id): its
    one trace still sums to its latency within 5 %. The stint the drain
    cut (decode steps, or chunks of a prefill and their waits) is booked
    at the drain; without that it was unattributed."""
    telemetry.start()
    try:
        a, b = (GenerationEngine(StubBackend(2, 256, step_s=0.01,
                                             prefill_tok_s=0.002),
                                 prefill_chunk=8) for _ in range(2))
        h = a.submit(list(range(1, 41)), max_new_tokens=12)
        while (len(h.tokens) < 6 if stint == "decode"
               else h.next_chunk < 3):
            a.step()
        assert h.state == ("running" if stint == "decode" else PREFILLING)
        snaps = a.drain()
        assert snaps == [h]
        b.resume(h)
        b.run_until_idle()
        assert h.wait(30) and len(h.tokens) == 12
        tr = [t for t in telemetry.request_traces().traces()
              if t["request"] == h.id]
    finally:
        telemetry.stop()
    assert len(tr) == 1 and not tr[0].get("partial"), tr
    assert abs(tr[0]["unattributed_s"]) <= 0.05 * tr[0]["latency_s"], tr
