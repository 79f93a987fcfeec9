"""The port's telemetry plane (``sparkdl_tpu_torch.runner.telemetry``)
held against the JAX package's.

Twins of ``tests/test_telemetry.py``'s ``TestRegistry``,
``TestStageAccountant``, ``TestExporterLifecycle`` (the snapshot files, the
Prometheus and JSON endpoints, ``/healthz``), ``TestOverheadBounded`` and
``TestMeterIntegration``, with the reference's assertions; the gang
aggregation is not ported (ROADMAP.md, Queue A 7). Beside them, one
synthetic span stream folds through both packages' accountants and renders
to the same books and the same Prometheus text.

Every HTTP endpoint binds port 0; every wait has its own timeout.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

from sparkdl_tpu.runner import events as jevents
from sparkdl_tpu.runner import slo as jslo
from sparkdl_tpu.runner import telemetry as jtelemetry
from sparkdl_tpu_torch.runner import events, slo, telemetry
from sparkdl_tpu_torch.runner.telemetry import (MetricsRegistry,
                                                StageAccountant,
                                                render_prometheus)


@pytest.fixture(autouse=True)
def _fresh_plane():
    """Every test gets stopped, fresh planes, recorders and SLO monitors
    in both packages; env arming from one test must not leak into the
    next."""
    for mod in (telemetry, jtelemetry, slo, jslo):
        mod.reset()
    yield
    for mod in (telemetry, jtelemetry, slo, jslo, events, jevents):
        mod.reset()


def _span_records(stage, pairs, rank=0, **attrs):
    """Synthetic B/E record pairs: pairs = [(t0, t1), ...]."""
    recs = []
    for t0, t1 in pairs:
        recs.append({"t": t0, "name": stage, "ph": "B", "rank": rank})
        recs.append({"t": t1, "name": stage, "ph": "E", "rank": rank,
                     "dur_s": round(t1 - t0, 6), **attrs})
    return recs


def _wait_for(path, timeout=5.0):
    deadline = time.time() + timeout
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.02)
    return os.path.exists(path)


class TestRegistry:
    def test_counter_gauge_histogram(self):
        reg = MetricsRegistry()
        reg.counter("c").inc()
        reg.counter("c").inc(2.5)
        reg.gauge("g").set(3)
        reg.gauge("g").set(1)  # value drops, max holds
        reg.histogram("h", buckets=(0.1, 1.0)).observe(0.05)
        reg.histogram("h").observe(0.5)
        reg.histogram("h").observe(5.0)
        snap = reg.snapshot()
        assert snap["counters"]["c"] == 3.5
        assert snap["gauges"]["g"] == {"value": 1, "max": 3}
        h = snap["histograms"]["h"]
        assert h["count"] == 3 and abs(h["sum"] - 5.55) < 1e-9
        assert h["buckets"] == [1, 2]

    def test_counter_inc_is_thread_safe(self):
        reg = MetricsRegistry()
        c = reg.counter("n")

        def work():
            for _ in range(1000):
                c.inc()

        ts = [threading.Thread(target=work) for _ in range(4)]
        [t.start() for t in ts]
        [t.join(30) for t in ts]
        assert not any(t.is_alive() for t in ts)
        assert c.value == 4000

    def test_prometheus_rendering(self):
        reg = MetricsRegistry()
        reg.counter("rows").inc(7)
        reg.gauge("depth").set(2)
        reg.histogram("lat", buckets=(0.5,)).observe(0.3)
        snap = {"rank": 3, "elapsed_s": 1.5,
                "stages": {"decode": {"busy_s": 0.5, "wall_busy_s": 0.4,
                                      "busy_frac": 0.27, "count": 9,
                                      "rows": 36, "bytes": 1024,
                                      "errors": 0, "active": 1,
                                      "max_concurrency": 2}}}
        snap.update(reg.snapshot())
        txt = render_prometheus(snap)
        assert '# TYPE sparkdl_stage_busy_seconds counter' in txt
        assert 'sparkdl_stage_busy_seconds{rank="3",stage="decode"} 0.5' \
            in txt
        assert 'sparkdl_stage_busy_frac{rank="3",stage="decode"} 0.27' \
            in txt
        assert 'sparkdl_rows_total{rank="3"} 7' in txt
        assert 'sparkdl_depth{rank="3"} 2' in txt
        assert 'sparkdl_lat_bucket{le="0.5",rank="3"} 1' in txt
        assert 'sparkdl_lat_bucket{le="+Inf",rank="3"} 1' in txt
        assert 'sparkdl_lat_count{rank="3"} 1' in txt
        assert re.search(r'rank=(?!")', txt) is None  # no unquoted rank
        assert txt == jtelemetry.render_prometheus(snap)


class TestStageAccountant:
    def test_busy_books_on_synthetic_spans(self):
        acc = StageAccountant()
        for r in [{"t": 0.0, "name": "decode", "ph": "B"},
                  {"t": 1.0, "name": "decode", "ph": "B"},
                  {"t": 2.0, "name": "decode", "ph": "E", "dur_s": 2.0,
                   "rows": 8, "bytes": 100},
                  {"t": 3.0, "name": "decode", "ph": "E", "dur_s": 2.0,
                   "rows": 8, "bytes": 100},
                  {"t": 3.0, "name": "dispatch", "ph": "B"},
                  {"t": 4.0, "name": "dispatch", "ph": "E", "dur_s": 1.0,
                   "error": "boom"}]:
            acc.on_event(r)
        snap = acc.snapshot(now=4.0)
        assert snap["elapsed_s"] == 4.0
        d = snap["stages"]["decode"]
        assert d["busy_s"] == 4.0
        assert d["wall_busy_s"] == 3.0
        assert d["busy_frac"] == 0.75
        assert d["rows"] == 16 and d["bytes"] == 200
        assert d["max_concurrency"] == 2 and d["active"] == 0
        dis = snap["stages"]["dispatch"]
        assert dis["errors"] == 1 and dis["busy_frac"] == 0.25
        assert all(0.0 <= s["busy_frac"] <= 1.0
                   for s in snap["stages"].values())

    def test_open_span_counts_as_busy_in_live_snapshot(self):
        acc = StageAccountant()
        acc.on_event({"t": 10.0, "name": "dispatch", "ph": "B"})
        snap = acc.snapshot(now=40.0)
        st = snap["stages"]["dispatch"]
        assert st["active"] == 1
        assert st["wall_busy_s"] == 30.0
        assert snap["elapsed_s"] == 30.0
        assert st["busy_frac"] == 1.0

    def test_point_events_tallied(self):
        acc = StageAccountant()
        acc.on_event({"t": 1.0, "name": "quarantine", "ph": "P", "rows": 3})
        acc.on_event({"t": 2.0, "name": "quarantine", "ph": "P", "rows": 2})
        acc.on_event({"t": 2.5, "name": "retry", "ph": "P"})
        snap = acc.snapshot(now=3.0)
        assert snap["events"] == {"quarantine": 2, "retry": 1}
        assert snap["event_rows"] == {"quarantine": 5}

    def test_tee_feeds_accountant_through_recorder(self):
        telemetry.start()  # no dir/port: tee only
        rec = events.reset()  # fresh ring; module-level tee survives reset
        with events.span("pad", rows=4):
            pass
        with events.span("pad", rows=4):
            pass
        snap = telemetry.accountant().snapshot()
        assert snap["stages"]["pad"]["count"] == 2
        assert snap["stages"]["pad"]["rows"] == 8
        assert rec.tail()  # the ring saw them too

    def test_same_stream_same_books_as_reference(self):
        """One synthetic stream (overlapping spans, an open span, point
        events, an error) through both packages' accountants: the same
        books, and the same Prometheus text."""
        recs = (_span_records("decode", [(0.0, 2.0), (1.0, 3.5)], rows=4,
                              bytes=64)
                + _span_records("dispatch", [(3.5, 4.0)], error="x")
                + [{"t": 4.5, "name": "fetch", "ph": "B"},
                   {"t": 2.2, "name": "retry", "ph": "P", "rows": 2}])
        ours, ref = StageAccountant(), jtelemetry.StageAccountant()
        for r in recs:
            ours.on_event(dict(r))
            ref.on_event(dict(r))
        snap, jsnap = ours.snapshot(now=6.0), ref.snapshot(now=6.0)
        assert snap == jsnap
        snap["rank"] = jsnap["rank"] = 0
        assert render_prometheus(snap) == jtelemetry.render_prometheus(jsnap)


class TestExporterLifecycle:
    def test_snapshot_files_appear_and_survive_stop(self, tmp_path,
                                                    monkeypatch):
        monkeypatch.setenv("SPARKDL_METRICS_INTERVAL_S", "0.05")
        d = str(tmp_path / "m")
        telemetry.start(metrics_dir=d)
        with events.span("decode", rows=2):
            pass
        path = os.path.join(d, "metrics_rank0.json")
        assert _wait_for(path), "exporter never wrote a snapshot"
        snap = json.load(open(path))
        assert snap["stages"]["decode"]["count"] == 1
        telemetry.stop()
        final = json.load(open(path))
        assert final["stages"]["decode"]["count"] == 1
        hist = open(os.path.join(d, "metrics_rank0.jsonl")).readlines()
        assert all(json.loads(ln) for ln in hist)

    def test_start_and_stop_are_idempotent(self, tmp_path):
        d = str(tmp_path / "m")
        p1 = telemetry.start(metrics_dir=d)
        p2 = telemetry.start(metrics_dir=str(tmp_path / "other"))
        assert p1 is p2
        assert p2.metrics_dir == d  # second start did not rewire
        assert telemetry.enabled()
        telemetry.stop()
        telemetry.stop()  # no-op
        assert not telemetry.enabled()
        before = telemetry.accountant().snapshot()["stages"].get(
            "pad", {}).get("count", 0)
        with events.span("pad"):
            pass
        after = telemetry.accountant().snapshot()["stages"].get(
            "pad", {}).get("count", 0)
        assert after == before

    def test_http_endpoint_serves_prometheus_and_json(self):
        telemetry.start(port=0)  # ephemeral
        port = telemetry.server_port()
        assert port
        with events.span("fetch", rows=4):
            pass
        txt = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert 'sparkdl_stage_count{rank="0",stage="fetch"} 1' in txt
        js = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics.json", timeout=10).read())
        assert js["stages"]["fetch"]["rows"] == 4
        telemetry.stop()

    def test_healthz_endpoint(self):
        telemetry.start(port=0)
        port = telemetry.server_port()
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10)
        assert resp.status == 200
        body = json.loads(resp.read())
        assert body["status"] == "ok"
        assert body["pid"] == os.getpid()
        assert body["rank"] == 0
        assert isinstance(body["uptime_s"], (int, float))
        assert body["uptime_s"] >= 0
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/nope", timeout=10)
        telemetry.stop()

    def test_healthz_bind_failure_degrades(self, tmp_path):
        import socket
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        sock.listen(1)
        taken = sock.getsockname()[1]
        try:
            telemetry.start(metrics_dir=str(tmp_path / "m"), port=taken)
            assert telemetry.server_port() is None  # degraded, not dead
            assert telemetry.enabled()
            with events.span("pad"):
                pass
            telemetry.flush_snapshot()
            snap = json.load(
                open(os.path.join(str(tmp_path / "m"),
                                  "metrics_rank0.json")))
            assert snap["stages"]["pad"]["count"] == 1
        finally:
            sock.close()
            telemetry.stop()

    def test_maybe_start_from_env(self, tmp_path, monkeypatch):
        monkeypatch.delenv("SPARKDL_METRICS_DIR", raising=False)
        monkeypatch.delenv("SPARKDL_METRICS_PORT", raising=False)
        assert telemetry.maybe_start_from_env() is False  # nothing set
        assert not telemetry.enabled()
        monkeypatch.setenv("SPARKDL_METRICS_DIR", str(tmp_path / "m"))
        assert telemetry.maybe_start_from_env() is True
        assert telemetry.enabled()

    def test_unparseable_port_alone_does_not_arm(self, monkeypatch):
        monkeypatch.delenv("SPARKDL_METRICS_DIR", raising=False)
        monkeypatch.setenv("SPARKDL_METRICS_PORT", "abc")
        assert telemetry.maybe_start_from_env() is False
        assert not telemetry.enabled()
        assert events._TEES == []

    def test_history_capped_latest_keeps_updating(self, tmp_path,
                                                  monkeypatch):
        monkeypatch.setenv("SPARKDL_METRICS_MAX_MB", "0.0002")  # ~200 B
        monkeypatch.setenv("SPARKDL_METRICS_INTERVAL_S", "60")
        d = str(tmp_path / "m")
        telemetry.start(metrics_dir=d)
        for _ in range(20):
            telemetry.flush_snapshot()
        hpath = os.path.join(d, "metrics_rank0.jsonl")
        lines = open(hpath).read().splitlines()
        marker = json.loads(lines[-1])
        assert marker["name"] == "metrics_history_truncated"
        assert sum(1 for ln in lines
                   if '"metrics_history_truncated"' in ln) == 1
        n = len(lines)
        telemetry.flush_snapshot()
        telemetry.flush_snapshot()
        assert len(open(hpath).read().splitlines()) == n  # capped
        with events.span("decode"):
            pass
        telemetry.flush_snapshot()
        latest = json.load(open(os.path.join(d, "metrics_rank0.json")))
        assert latest["stages"]["decode"]["count"] == 1
        telemetry.stop()

    def test_concurrent_flush_and_tick_never_tear_snapshot(self, tmp_path,
                                                           monkeypatch):
        monkeypatch.setenv("SPARKDL_METRICS_INTERVAL_S", "0.05")
        d = str(tmp_path / "m")
        telemetry.start(metrics_dir=d)
        with events.span("pad"):
            pass

        def flusher():
            for _ in range(25):
                telemetry.flush_snapshot()

        threads = [threading.Thread(target=flusher) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        telemetry.stop()
        snap = json.load(open(os.path.join(d, "metrics_rank0.json")))
        assert snap["stages"]["pad"]["count"] == 1
        for ln in open(os.path.join(d, "metrics_rank0.jsonl")):
            json.loads(ln)  # no torn/interleaved line


class TestOverheadBounded:
    def test_disabled_plane_is_free(self, tmp_path, monkeypatch):
        monkeypatch.delenv("SPARKDL_METRICS_DIR", raising=False)
        monkeypatch.delenv("SPARKDL_METRICS_PORT", raising=False)
        assert telemetry.maybe_start_from_env() is False
        assert events._TEES == []  # emit()'s per-event check is one falsy
        n_threads = threading.active_count()
        rec = events.reset()
        for _ in range(200):
            with events.span("pad", rows=1):
                pass
        assert threading.active_count() == n_threads
        assert list(tmp_path.iterdir()) == []
        assert telemetry.accountant().snapshot()["stages"] == {}
        assert rec.tail()  # recording itself still worked

    def test_broken_tee_never_breaks_the_hot_path(self):
        def bad(rec):
            raise RuntimeError("telemetry bug")

        events.add_tee(bad)
        try:
            with events.span("pad"):
                pass  # must not raise
            events.event("x")
        finally:
            events.remove_tee(bad)


class TestMeterIntegration:
    def test_summary_carries_stage_utilization_when_armed(self):
        from sparkdl_tpu_torch.runner.metrics import ThroughputMeter
        telemetry.start()
        events.reset()
        with events.span("decode", rows=4):
            time.sleep(0.002)
        with events.span("dispatch", rows=4):
            pass
        s = ThroughputMeter().summary()
        su = s["stage_utilization"]
        assert su is not None
        assert su["dominant_stage"] == "decode"
        assert set(su["stages"]) == {"decode", "dispatch"}
        telemetry.stop()

    def test_summary_block_is_none_when_off(self):
        from sparkdl_tpu_torch.runner.metrics import ThroughputMeter
        assert ThroughputMeter().summary()["stage_utilization"] is None

    def test_log_summary_flattens_doubly_nested_blocks(self, caplog):
        from sparkdl_tpu_torch.runner.metrics import MetricsLogger
        logger = MetricsLogger()
        with caplog.at_level("INFO", logger="sparkdl_tpu_torch.runner"):
            logger.log_summary(10, {
                "examples_per_sec": 5.0,
                "compile_cache": {"hits": 2,
                                  "persistent": {"hits": 1, "misses": 0}},
                "stage_utilization": {
                    "dominant_stage": "decode",
                    "stages": {"decode": {"busy_frac": 0.9}}},
            })
        assert "compile_cache_persistent_hits" in caplog.text
        assert "stage_utilization_stages_decode_busy_frac" in caplog.text
        assert "{'hits'" not in caplog.text  # nothing stringified
