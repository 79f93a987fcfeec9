"""The port's causal trace plane and Chrome-trace exporter
(``sparkdl_tpu_torch.runner.events``' trace context,
``runner/traceview.py``, ``scripts/torch_trace_export.py``) against the
JAX package's, on the CPU.

Twins of ``tests/test_traceplane.py``'s ``TestTraceContext``,
``TestTraceview``, ``TestTraceExportScript`` and ``TestEngineParentage``:
each runs through both packages (``PKGS``; the engine tests on each
package's ``StubBackend``) with the reference's assertions. Side by side,
one seeded gang dir (a supervisor manifest, two ranks' streams with
chaos instants, serve_* request spans, heartbeats and metrics histories)
goes through both packages' ``chrome_trace`` and ``validate_chrome_trace``:
the traces are equal as JSON, floats within 1e-9.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import importlib.util
import json
import os
import threading

import pytest

from sparkdl_tpu.runner import events as ref_events
from sparkdl_tpu.runner import telemetry as ref_telemetry
from sparkdl_tpu.runner import traceview as ref_traceview
from sparkdl_tpu_torch.runner import events, telemetry, traceview
from test_torch_analysis import assert_json_equal

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = [("ref", ref_events, ref_traceview), ("port", events, traceview)]
EXPORT_SCRIPTS = {"ref": "trace_export", "port": "torch_trace_export"}


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Fresh recorders, no stream dir, no trace env — arming is
    per-test."""
    for v in ("SPARKDL_EVENT_DIR", events.TRACE_ID_ENV,
              events.TRACE_PARENT_ENV):
        monkeypatch.delenv(v, raising=False)
    for mod in (events, ref_events, telemetry, ref_telemetry):
        mod.reset()
    yield
    for mod in (events, ref_events, telemetry, ref_telemetry):
        mod.reset()


def _arm(monkeypatch, ev, trace_id="t" * 16, parent=None):
    monkeypatch.setenv(ev.TRACE_ID_ENV, trace_id)
    if parent:
        monkeypatch.setenv(ev.TRACE_PARENT_ENV, parent)
    return trace_id


# ---------------------------------------------------------------------------
# TestTraceContext
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg_name,ev,_tv", PKGS)
class TestTraceContext:
    def test_untraced_records_are_byte_identical(self, pkg_name, ev, _tv):
        rec = ev.reset()
        with ev.span("step_compute", step=1):
            ev.event("chaos", site="step_start")
        for r in rec.tail():
            assert "span_id" not in r
            assert "parent_id" not in r
            assert "trace_id" not in r

    def test_armed_spans_chain_and_carry_trace_id(self, monkeypatch,
                                                  pkg_name, ev, _tv):
        tid = _arm(monkeypatch, ev)
        rec = ev.reset()
        with ev.span("outer"):
            with ev.span("inner"):
                ev.event("chaos", site="x")
        by = {}
        for r in rec.tail():
            by.setdefault((r["name"], r["ph"]), r)
        outer, inner = by[("outer", "B")], by[("inner", "B")]
        point = by[("chaos", "P")]
        assert all(r["trace_id"] == tid for r in (outer, inner, point))
        assert outer["span_id"] and "parent_id" not in outer
        assert inner["parent_id"] == outer["span_id"]
        assert point["parent_id"] == inner["span_id"]
        assert by[("inner", "E")]["span_id"] == inner["span_id"]

    def test_sibling_after_exit_parents_to_enclosing(self, monkeypatch,
                                                     pkg_name, ev, _tv):
        _arm(monkeypatch, ev)
        rec = ev.reset()
        with ev.span("outer"):
            with ev.span("first"):
                pass
            with ev.span("second"):
                pass
        by = {(r["name"], r["ph"]): r for r in rec.tail()}
        outer_id = by[("outer", "B")]["span_id"]
        assert by[("first", "B")]["parent_id"] == outer_id
        assert by[("second", "B")]["parent_id"] == outer_id

    def test_env_parent_is_the_outermost_fallback(self, monkeypatch,
                                                  pkg_name, ev, _tv):
        _arm(monkeypatch, ev, parent="driver-span-7")
        rec = ev.reset()
        ev.event("restart", attempt=1)
        with ev.span("step_compute", step=0):
            pass
        by = {(r["name"], r["ph"]): r for r in rec.tail()}
        assert by[("restart", "P")]["parent_id"] == "driver-span-7"
        assert by[("step_compute", "B")]["parent_id"] == "driver-span-7"

    def test_completed_span_mints_ids(self, monkeypatch, pkg_name, ev, _tv):
        _arm(monkeypatch, ev, parent="root-1")
        rec = ev.reset()
        ev.completed_span("serve_decode", 0.5, request=3)
        (r,) = [x for x in rec.tail()
                if x["name"] == "serve_decode" and x["ph"] == "E"]
        assert r["span_id"] and r["parent_id"] == "root-1"
        ev.completed_span("serve_decode", 0.1, request=4,
                          span_id="S", parent_id="P")
        (r2,) = [x for x in rec.tail()
                 if x.get("request") == 4 and x["ph"] == "E"]
        assert r2["span_id"] == "S" and r2["parent_id"] == "P"

    def test_span_stack_is_thread_local(self, monkeypatch, pkg_name, ev,
                                        _tv):
        _arm(monkeypatch, ev)
        rec = ev.reset()

        def feeder():
            with ev.span("data_fetch"):
                pass

        with ev.span("step_compute"):
            t = threading.Thread(target=feeder)
            t.start()
            t.join(10)
            assert not t.is_alive()
        by = {(r["name"], r["ph"]): r for r in rec.tail()}
        assert "parent_id" not in by[("data_fetch", "B")]

    def test_exception_exit_still_pops(self, monkeypatch, pkg_name, ev,
                                       _tv):
        _arm(monkeypatch, ev)
        rec = ev.reset()
        with pytest.raises(RuntimeError):
            with ev.span("outer"):
                with ev.span("boom"):
                    raise RuntimeError("x")
        with ev.span("after"):
            pass
        by = {(r["name"], r["ph"]): r for r in rec.tail()}
        assert "parent_id" not in by[("after", "B")]


# ---------------------------------------------------------------------------
# TestTraceview
# ---------------------------------------------------------------------------

def _seed(tmp_path, with_manifest=True):
    ev = tmp_path / "ev"
    ev.mkdir()
    if with_manifest:
        (ev / "trace_manifest.json").write_text(json.dumps({
            "trace_id": "abc123", "root_span_id": "root",
            "spans": [{"span_id": "root", "parent_id": None,
                       "name": "supervise", "t": 100.0},
                      {"span_id": "a1", "parent_id": "root",
                       "name": "gang_attempt", "t": 100.2,
                       "attempt": 1}]}))
    recs0 = [
        {"t": 101.0, "name": "step_compute", "ph": "E", "rank": 0,
         "dur_s": 0.5, "trace_id": "abc123", "span_id": "s0",
         "parent_id": "a1", "step": 1},
        {"t": 101.2, "name": "chaos", "ph": "P", "rank": 0,
         "site": "step_start", "trace_id": "abc123", "parent_id": "s0"},
    ]
    recs1 = [
        {"t": 101.1, "name": "step_compute", "ph": "E", "rank": 1,
         "dur_s": 0.4, "trace_id": "abc123", "span_id": "s1",
         "parent_id": "a1", "step": 1},
    ]
    for rank, recs in ((0, recs0), (1, recs1)):
        with open(ev / f"events_rank{rank}.jsonl", "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
    return str(ev)


@pytest.mark.parametrize("pkg_name,_ev,tv", PKGS)
class TestTraceview:
    def test_chrome_trace_shape(self, tmp_path, pkg_name, _ev, tv):
        tr = tv.chrome_trace(_seed(tmp_path))
        assert tr["displayTimeUnit"] == "ms"
        evs = tr["traceEvents"]
        x = [e for e in evs if e["ph"] == "X"]
        i = [e for e in evs if e["ph"] == "i"]
        m = [e for e in evs if e["ph"] == "M"]
        s0 = next(e for e in x if e["args"].get("span_id") == "s0")
        assert s0["pid"] == 0
        assert s0["ts"] == pytest.approx((101.0 - 0.5) * 1e6)
        assert s0["dur"] == pytest.approx(0.5 * 1e6)
        assert all(e["s"] == "t" for e in i)
        driver = [e for e in x if e["pid"] == tv.DRIVER_PID]
        assert {e["name"] for e in driver} == {"supervise", "gang_attempt"}
        assert any(e["name"] == "process_name"
                   and e["args"]["name"] == "driver" for e in m)
        assert any(e["name"] == "process_name"
                   and e["args"]["name"] == "rank 1" for e in m)
        skew = tr["otherData"]["clock_skew"]
        assert skew["measured"] is False and "unmeasured" in skew["note"]

    def test_counter_tracks_from_metrics_history(self, tmp_path, pkg_name,
                                                 _ev, tv):
        ev = _seed(tmp_path)
        mdir = tmp_path / "m"
        mdir.mkdir()
        with open(mdir / "metrics_rank0.jsonl", "w") as f:
            for t, depth in ((101.0, 2), (101.5, 5)):
                f.write(json.dumps(
                    {"t": t, "rank": 0,
                     "gauges": {"serving_queue_depth":
                                {"value": depth, "max": 5}},
                     "counters": {"steps_total": t - 100.0}}) + "\n")
        tr = tv.chrome_trace(ev, metrics_dir=str(mdir))
        c = [e for e in tr["traceEvents"] if e["ph"] == "C"]
        assert [e["args"]["value"] for e in c
                if e["name"] == "serving_queue_depth"] == [2, 5]
        assert any(e["name"] == "steps_total" for e in c)

    def test_validate_accepts_good_and_flags_broken_chains(
            self, tmp_path, pkg_name, _ev, tv):
        tr = tv.chrome_trace(_seed(tmp_path))
        good = tv.validate_chrome_trace(tr, require_ranks=2)
        assert good["ok"], good["problems"]
        assert good["ranks"] == [0, 1]
        tr["traceEvents"].append(
            {"ph": "X", "name": "orphan", "pid": 0, "tid": 9,
             "ts": 0, "dur": 1,
             "args": {"span_id": "zz", "parent_id": "missing"}})
        bad = tv.validate_chrome_trace(tr)
        assert not bad["ok"]
        assert any("resolves to no known span" in p
                   for p in bad["problems"])

    def test_validate_flags_foreign_trace_id(self, tmp_path, pkg_name, _ev,
                                             tv):
        tr = tv.chrome_trace(_seed(tmp_path))
        tr["traceEvents"].append(
            {"ph": "X", "name": "alien", "pid": 1, "tid": 9,
             "ts": 0, "dur": 1,
             "args": {"span_id": "zz", "trace_id": "OTHER"}})
        bad = tv.validate_chrome_trace(tr)
        assert any("FOREIGN trace_id" in p for p in bad["problems"])

    def test_manifest_found_in_newest_gang_subdir(self, tmp_path, pkg_name,
                                                  _ev, tv):
        ev = tmp_path / "ev"
        old, new = ev / "gang-1111-aaaa", ev / "gang-2222-bbbb"
        for d, tid in ((old, "oldtrace"), (new, "newtrace")):
            d.mkdir(parents=True)
            (d / "trace_manifest.json").write_text(json.dumps(
                {"trace_id": tid, "root_span_id": "r",
                 "spans": [{"span_id": "r", "parent_id": None,
                            "name": "supervise", "t": 1.0}]}))
            (d / "events_rank0.jsonl").write_text(json.dumps(
                {"t": 2.0, "name": "s", "ph": "E", "rank": 0,
                 "dur_s": 0.1}) + "\n")
        os.utime(old, (1, 1))
        assert tv.find_trace_manifest(str(ev))["trace_id"] == "newtrace"

    def test_clock_skew_measured_from_heartbeats(self, tmp_path, pkg_name,
                                                 _ev, tv):
        ev = _seed(tmp_path)
        hb = tmp_path / "hb"
        hb.mkdir()
        p = hb / "rank0.hb"
        p.write_text(json.dumps({"step": 3, "time": 500.0}))
        os.utime(p, (500.0, 500.25))  # mtime (host) 0.25s after body
        skew = tv.measure_clock_skew(str(hb))
        assert skew["measured"] is True
        assert skew["per_rank_s"]["0"] == pytest.approx(-0.25)
        assert skew["flagged"] == []  # at the 0.25 s threshold, not past
        tr = tv.chrome_trace(ev, heartbeat_dir=str(hb))
        assert tr["otherData"]["clock_skew"]["measured"] is True

    def test_request_summary_track(self, tmp_path, pkg_name, _ev, tv):
        ev = tmp_path / "ev"
        ev.mkdir()
        recs = [
            {"t": 10.2, "name": "serve_queue", "ph": "E", "rank": 0,
             "request": 1, "dur_s": 0.2},
            {"t": 10.5, "name": "serve_prefill", "ph": "E", "rank": 0,
             "request": 1, "dur_s": 0.3, "tokens": 3},
            {"t": 11.0, "name": "serve_decode", "ph": "E", "rank": 0,
             "request": 1, "dur_s": 0.5, "reason": "stop",
             "new_tokens": 4},
        ]
        with open(ev / "events_rank0.jsonl", "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        tr = tv.chrome_trace(str(ev))
        assert tr["otherData"]["requests"] == 1
        req = next(e for e in tr["traceEvents"]
                   if e["ph"] == "X" and e["name"] == "request 1")
        assert req["pid"] == 0
        assert req["args"]["finish"] == "stop"


# ---------------------------------------------------------------------------
# TestTraceExportScript
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["ref", "port"])
def test_cli_roundtrip_and_validation_gate(tmp_path, which):
    mod = _load_script(EXPORT_SCRIPTS[which])
    ev = tmp_path / "ev"
    ev.mkdir()
    (ev / "trace_manifest.json").write_text(json.dumps(
        {"trace_id": "abc", "root_span_id": "r",
         "spans": [{"span_id": "r", "parent_id": None,
                    "name": "supervise", "t": 1.0}]}))
    (ev / "events_rank0.jsonl").write_text(json.dumps(
        {"t": 2.0, "name": "s", "ph": "E", "rank": 0, "dur_s": 0.1,
         "trace_id": "abc", "span_id": "x", "parent_id": "r"}) + "\n")
    out = tmp_path / "t.json"
    assert mod.main([str(ev), "--out", str(out), "--validate"]) == 0
    trace = json.load(open(out))
    assert trace["otherData"]["trace_id"] == "abc"
    assert mod.main([str(ev), "--out", str(out), "--validate",
                     "--require-ranks", "2"]) == 1
    empty = tmp_path / "empty"
    empty.mkdir()
    assert mod.main([str(empty)]) == 2


# ---------------------------------------------------------------------------
# TestEngineParentage
# ---------------------------------------------------------------------------

def _engine(which):
    if which == "ref":
        from sparkdl_tpu.serving import GenerationEngine, StubBackend
    else:
        from sparkdl_tpu_torch.serving import GenerationEngine, StubBackend
    return GenerationEngine(StubBackend(2, 64, step_s=0.0), prefill_chunk=8)


@pytest.mark.parametrize("which,ev", [("ref", ref_events),
                                      ("port", events)])
def test_serve_spans_parent_under_request_envelope(monkeypatch, which, ev):
    _arm(monkeypatch, ev, parent="attempt-9")
    rec = ev.reset()
    eng = _engine(which)
    h = eng.submit([1, 2, 3], max_new_tokens=4)
    eng.run_until_idle()
    assert h.wait(30) and h.finish_reason == "length"
    recs = [r for r in rec.tail() if r["name"].startswith("serve_")]
    env_rec = next(r for r in recs if r["name"] == "serve_request")
    assert env_rec["span_id"]
    assert env_rec["parent_id"] == "attempt-9"
    assert env_rec["finish"] == "length"
    scoped = [r for r in recs if r["name"] != "serve_request"
              and r.get("request") is not None and r["ph"] != "B"]
    assert scoped
    for r in scoped:
        assert r["parent_id"] == env_rec["span_id"], r["name"]
        assert r["trace_id"] == env_rec["trace_id"]


@pytest.mark.parametrize("which,ev", [("ref", ref_events),
                                      ("port", events)])
def test_untraced_engine_emits_no_ids(which, ev):
    rec = ev.reset()
    eng = _engine(which)
    eng.submit([1, 2, 3], max_new_tokens=4)
    eng.run_until_idle()
    recs = [r for r in rec.tail() if r["name"].startswith("serve_")]
    assert recs
    assert not any(r["name"] == "serve_request" for r in recs)
    for r in recs:
        assert "span_id" not in r and "parent_id" not in r


# ---------------------------------------------------------------------------
# side by side
# ---------------------------------------------------------------------------

def _seed_gang(root, monkeypatch):
    """A supervised run's dirs: the manifest with two attempts, two
    ranks' streams (the port's engine serving traced requests on rank 0,
    steps and a chaos instant on both), heartbeats and metrics
    histories."""
    ev, hb, md = root / "ev", root / "hb", root / "m"
    gang = ev / "gang-1-x"
    for d in (gang, hb, md):
        d.mkdir(parents=True)
    (gang / "trace_manifest.json").write_text(json.dumps({
        "trace_id": "f00d", "root_span_id": "root",
        "spans": [{"span_id": "root", "parent_id": None, "name": "supervise",
                   "t": 50.0},
                  {"span_id": "a1", "parent_id": "root",
                   "name": "gang_attempt", "t": 50.1, "attempt": 1},
                  {"span_id": "a2", "parent_id": "root",
                   "name": "gang_attempt", "t": 60.0, "attempt": 2}]}))
    _arm(monkeypatch, events, trace_id="f00d", parent="a2")
    monkeypatch.setenv("SPARKDL_EVENT_DIR", str(gang))
    events.reset()
    eng = _engine("port")
    hs = [eng.submit([i + 1, 2, 3], max_new_tokens=5) for i in range(4)]
    eng.run_until_idle()
    for h in hs:
        assert h.wait(30)
    events.reset()
    monkeypatch.delenv("SPARKDL_EVENT_DIR")
    with open(gang / "events_rank1.jsonl", "w") as f:
        for step in range(6):
            t = 61.0 + 0.3 * step
            f.write(json.dumps({"t": t, "name": "step_compute", "ph": "E",
                                "rank": 1, "dur_s": 0.25, "step": step,
                                "trace_id": "f00d",
                                "span_id": f"s{step}",
                                "parent_id": "a2"}) + "\n")
        f.write(json.dumps({"t": 62.5, "name": "chaos", "ph": "P",
                            "rank": 1, "site": "step_start",
                            "trace_id": "f00d", "parent_id": "s5"}) + "\n")
    for rank, skew in ((0, 0.01), (1, -0.4)):
        p = hb / f"rank{rank}.hb"
        p.write_text(json.dumps({"step": 5, "time": 70.0 + skew}))
        os.utime(p, (70.0, 70.0))
        with open(md / f"metrics_rank{rank}.jsonl", "w") as f:
            for k in range(3):
                f.write(json.dumps({"t": 61.0 + k, "rank": rank,
                                    "gauges": {"serving_queue_depth":
                                               {"value": k, "max": 2}},
                                    "counters": {"steps_total": k}})
                        + "\n")
    return ev, hb, md


def test_gang_dir_chrome_trace_equals_reference(tmp_path, monkeypatch):
    ev, hb, md = _seed_gang(tmp_path, monkeypatch)
    traces, verdicts = [], []
    for _, _ev, tv in PKGS:
        tr = tv.chrome_trace(str(ev), metrics_dir=str(md),
                             heartbeat_dir=str(hb))
        traces.append(json.loads(json.dumps(tr, default=str)))
        verdicts.append(tv.validate_chrome_trace(
            tr, require_ranks=2, require_requests=4, require_counters=True))
    assert_json_equal(traces[0], traces[1])
    assert verdicts[0] == verdicts[1] and verdicts[1]["ok"], verdicts[1]
    other = traces[1]["otherData"]
    assert other["trace_id"] == "f00d" and other["requests"] == 4
    assert other["clock_skew"]["flagged"] == [1]
    attempts = [e for e in traces[1]["traceEvents"]
                if e.get("name") == "gang_attempt" and e["ph"] == "X"]
    assert len(attempts) == 2
    out = tmp_path / "trace.json"
    traceview.write_chrome_trace(str(out), traces[1])
    assert json.load(open(out)) == traces[1]
