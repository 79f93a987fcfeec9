"""The port's offline analysis (``sparkdl_tpu_torch.runner.analysis``) and
its report CLIs (``scripts/torch_request_report.py``,
``scripts/torch_bottleneck_report.py``) against the JAX package's, on the
CPU.

Twins of ``tests/test_telemetry.py::TestAnalysis`` and of
``tests/test_request_trace.py::TestReportClis``'s report and gang tests:
each runs the same records through both packages (``PKGS``) and asserts
the reference's claims on both; the CLIs of both packages read the same
event dir, written by the port's serving engine. A port twin of the
metric-docs lint runs ``scripts/check_metric_docs.py`` over the port's
package. Side by side, one Stub serving workload's event dir and one
seeded gang dir go through both packages' ``analyze``,
``utilization_from_events``, ``request_summary`` and the text renderings:
the outputs are equal as JSON, floats within 1e-9.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import importlib.util
import json
import os
import sys

import pytest

from sparkdl_tpu.runner import analysis as ref_analysis
from sparkdl_tpu.runner import events as ref_events
from sparkdl_tpu.runner import slo as ref_slo
from sparkdl_tpu.runner import telemetry as ref_telemetry
from sparkdl_tpu_torch.runner import analysis, events, slo, telemetry
from sparkdl_tpu_torch.serving import GenerationEngine, StubBackend

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = [("ref", ref_analysis, ref_telemetry),
        ("port", analysis, telemetry)]
SCRIPTS = {"request": ("request_report", "torch_request_report"),
           "bottleneck": ("bottleneck_report", "torch_bottleneck_report")}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for v in ("SPARKDL_SLO_TTFT_S", "SPARKDL_SLO_LATENCY_S",
              "SPARKDL_SLO_ERROR_RATE", "SPARKDL_SLO_TARGET",
              "SPARKDL_TRACE_SLOWEST", "SPARKDL_EVENT_DIR",
              "SPARKDL_METRICS_DIR", "SPARKDL_METRICS_PORT"):
        monkeypatch.delenv(v, raising=False)
    for mod in (telemetry, ref_telemetry, slo, ref_slo, events, ref_events):
        mod.reset()
    yield
    for mod in (telemetry, ref_telemetry, slo, ref_slo, events, ref_events):
        mod.reset()


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span_records(stage, pairs, rank=0, **attrs):
    """Synthetic B/E record pairs: pairs = [(t0, t1), ...]."""
    recs = []
    for t0, t1 in pairs:
        recs.append({"t": t0, "name": stage, "ph": "B", "rank": rank})
        recs.append({"t": t1, "name": stage, "ph": "E", "rank": rank,
                     "dur_s": round(t1 - t0, 6), **attrs})
    return recs


def _write_stream(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _run_serving_workload(event_dir, monkeypatch, n=8):
    """The port's engine over its StubBackend, streaming into
    ``event_dir`` (the reference's ``_run_serving_workload``)."""
    monkeypatch.setenv("SPARKDL_EVENT_DIR", str(event_dir))
    events.reset()
    eng = GenerationEngine(StubBackend(2, 64, step_s=0.001,
                                       prefill_s=0.004),
                           prefill_chunk=8)
    hs = [eng.submit([1 + i, 2, 3], max_new_tokens=8) for i in range(n)]
    eng.run_until_idle()
    for h in hs:
        assert h.wait(30)
    events.reset()  # close the stream
    monkeypatch.delenv("SPARKDL_EVENT_DIR")


def assert_json_equal(a, b, tol=1e-9, path="$"):
    """Equal as JSON: same keys and list lengths, strings and ints equal,
    floats within ``tol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_json_equal(a[k], b[k], tol, f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_json_equal(x, y, tol, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= tol, (path, a, b)
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------------
# twins of tests/test_telemetry.py::TestAnalysis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg_name,an,_tel", PKGS)
class TestAnalysis:
    def test_union_seconds(self, pkg_name, an, _tel):
        assert an.union_seconds([]) == 0.0
        assert an.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4.0

    def test_attribution_on_synthetic_spans(self, pkg_name, an, _tel):
        recs = []
        recs += _span_records("decode",
                              [(0.0, 5.0), (0.5, 5.5), (5.0, 10.0)],
                              rows=4)
        recs += _span_records("dispatch", [(2.0, 5.0)], rows=4)
        rep = an.analyze(events=recs)
        assert rep["dominant_stage"] == "decode"
        d = rep["stages"]["decode"]
        assert d["busy_frac"] == 1.0
        assert d["busy_s"] == 15.0
        assert d["avg_concurrency"] == 1.5
        assert abs(d["exclusive_s"] - 7.0) < 1e-6
        assert rep["stages"]["dispatch"]["busy_frac"] == 0.3
        assert rep["stages"]["dispatch"]["exclusive_s"] == 0.0
        assert rep["max_speedup_fixing_others"] == 1.0
        assert rep["idle_s"] == 0.0
        assert all(0.0 <= s["busy_frac"] <= 1.0
                   for s in rep["stages"].values())

    def test_idle_gap_reported(self, pkg_name, an, _tel):
        rep = an.analyze(events=_span_records("fetch",
                                              [(0.0, 1.0), (3.0, 4.0)]))
        assert rep["wall_s"] == 4.0
        assert rep["idle_s"] == 2.0
        assert rep["idle_frac"] == 0.5

    def test_no_spans_is_none(self, pkg_name, an, _tel):
        assert an.analyze(events=[{"name": "x", "ph": "P",
                                   "t": 1.0}]) is None
        assert an.analyze(events=[]) is None

    def test_format_report_names_dominant(self, pkg_name, an, _tel):
        recs = _span_records("decode", [(0.0, 9.4)], rows=100) \
            + _span_records("fetch", [(9.4, 10.0)])
        txt = an.format_report(an.analyze(events=recs))
        assert "dominant stage: decode (94.0% busy)" in txt
        assert "<= 1.06x" in txt

    def test_event_dir_loader_includes_gang_subdirs(self, tmp_path,
                                                    pkg_name, an, _tel):
        (tmp_path / "gang-x").mkdir()
        _write_stream(tmp_path / "events_rank0.jsonl",
                      _span_records("pad", [(0.0, 1.0)]))
        _write_stream(tmp_path / "gang-x" / "events_rank1.jsonl",
                      _span_records("pad", [(1.0, 2.0)], rank=1))
        rep = an.analyze(event_dir=str(tmp_path))
        assert rep["stages"]["pad"]["count"] == 2

    def test_event_dir_loader_merges_only_newest_gang_subdir(
            self, tmp_path, pkg_name, an, _tel):
        old, new = tmp_path / "gang-old", tmp_path / "gang-new"
        empty = tmp_path / "gang-zzz-empty"
        for d in (old, new, empty):
            d.mkdir()
        _write_stream(old / "events_rank0.jsonl",
                      _span_records("pad", [(0.0, 1.0)]))
        _write_stream(new / "events_rank0.jsonl",
                      _span_records("pad", [(1000.0, 1001.0)]))
        os.utime(old, (1, 1))
        os.utime(new, (100, 100))
        os.utime(empty, (200, 200))
        rep = an.analyze(event_dir=str(tmp_path))
        assert rep["stages"]["pad"]["count"] == 1
        assert rep["wall_s"] == 1.0
        assert rep["idle_s"] == 0.0

    def test_torn_tail_line_is_skipped(self, tmp_path, pkg_name, an, _tel):
        """A killed rank leaves half a line: the reader keeps the rest."""
        p = tmp_path / "events_rank0.jsonl"
        _write_stream(p, _span_records("pad", [(0.0, 1.0)]))
        with open(p, "a") as f:
            f.write('{"t": 2.0, "name": "pa')
        assert len(an.read_span_stream(str(p))) == 2
        assert an.load_event_dir(str(tmp_path / "nowhere")) == []


@pytest.mark.parametrize("which", ["ref", "port"])
def test_bottleneck_report_cli(tmp_path, capsys, which):
    """Twin of ``TestAnalysis.test_bottleneck_report_cli``."""
    mod = _load_script(SCRIPTS["bottleneck"][which == "port"])
    d = tmp_path / "ev"
    d.mkdir()
    _write_stream(d / "events_rank0.jsonl",
                  _span_records("decode", [(0.0, 2.0)], rows=8)
                  + _span_records("dispatch", [(2.0, 2.5)]))
    assert mod.main([str(d), "--json"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["report"]["dominant_stage"] == "decode"
    empty = tmp_path / "empty"
    empty.mkdir()
    assert mod.main([str(empty)]) == 2


# ---------------------------------------------------------------------------
# twins of tests/test_request_trace.py::TestReportClis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["ref", "port"])
def test_request_report_cli(tmp_path, monkeypatch, capsys, which):
    _run_serving_workload(tmp_path, monkeypatch)
    monkeypatch.setenv("SPARKDL_SLO_TTFT_S", "5.0")
    mod = _load_script(SCRIPTS["request"][which == "port"])
    assert mod.main([str(tmp_path), "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert "8 completed" in out
    assert "dominant cause" in out
    assert "SLO compliance" in out and "ttft" in out
    assert mod.main([str(tmp_path), "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["completed"] == 8
    assert rec["tail_dominant_phase"] in rec["tail_phase_frac"]
    assert rec["max_unattributed_frac"] <= 0.05
    assert rec["slo"]["ttft"]["met"] is True
    empty = tmp_path / "empty"
    empty.mkdir()
    assert mod.main([str(empty)]) == 2


@pytest.mark.parametrize("which", ["ref", "port"])
def test_bottleneck_report_appends_request_block(tmp_path, monkeypatch,
                                                 capsys, which):
    _run_serving_workload(tmp_path, monkeypatch)
    monkeypatch.setenv("SPARKDL_SLO_LATENCY_S", "10.0")
    mod = _load_script(SCRIPTS["bottleneck"][which == "port"])
    assert mod.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "dominant stage" in out
    assert "request traces:" in out
    assert "SLO compliance" in out
    assert "latency" in out
    if which == "port":
        assert "scripts/torch_request_report.py" in out
    assert mod.main([str(tmp_path), "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["requests"]["completed"] == 8
    assert rec["report"] is not None


def test_bottleneck_report_gang_metrics_block(tmp_path, capsys):
    """``--metrics-dir``: the gang aggregate prints beside the stage
    table, its histogram quantiles from ``telemetry.histogram_quantile``,
    as the reference's script prints them."""
    ev = tmp_path / "ev"
    ev.mkdir()
    _write_stream(ev / "events_rank0.jsonl",
                  _span_records("decode", [(0.0, 2.0)], rows=8))
    md = tmp_path / "m"
    md.mkdir()
    for rank in (0, 1):
        (md / f"metrics_rank{rank}.json").write_text(json.dumps({
            "t": 1.0, "rank": rank, "elapsed_s": 2.0,
            "stages": {"decode": {"count": 1, "busy_s": 1.0,
                                  "wall_busy_s": 1.0, "busy_frac": 0.5,
                                  "rows": 4, "bytes": 0, "errors": 0,
                                  "active": 0, "max_concurrency": 1}},
            "gauges": {"serving_queue_depth": {"value": 3, "max": 5}},
            "histograms": {"serving_ttft_s": {
                "bounds": [0.1, 1.0], "buckets": [1, 3], "count": 3,
                "sum": 1.2}}}))
    outs = []
    for which in ("ref", "port"):
        mod = _load_script(SCRIPTS["bottleneck"][which == "port"])
        assert mod.main([str(ev), "--metrics-dir", str(md)]) == 0
        outs.append(capsys.readouterr().out)
    assert "gang telemetry (2 rank(s)" in outs[1]
    assert "gauge serving_queue_depth: 3 (high-water 5)" in outs[1]
    assert "serving_ttft_s: p50" in outs[1]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("pkg_name,_an,tel", PKGS)
def test_gang_aggregation_merges_trace_blocks(tmp_path, pkg_name, _an, tel):
    for rank, lat in ((0, 1.0), (1, 9.0)):
        snap = {"t": 1.0, "rank": rank, "elapsed_s": 1.0,
                "stages": {}, "request_traces": {
                    "completed": 2, "open": 0,
                    "slowest": [{"request": rank * 10,
                                 "latency_s": lat}]}}
        (tmp_path / f"metrics_rank{rank}.json").write_text(json.dumps(snap))
    tb = tel.aggregate_snapshots(str(tmp_path))["request_traces"]
    assert tb["completed"] == 4
    assert tb["slowest"][0]["request"] == 10


@pytest.mark.parametrize("pkg_name,_an,tel", PKGS)
def test_gang_aggregation_honors_slowest_knob(tmp_path, monkeypatch,
                                              pkg_name, _an, tel):
    monkeypatch.setenv("SPARKDL_TRACE_SLOWEST", "2")
    for rank in (0, 1):
        snap = {"t": 1.0, "rank": rank, "elapsed_s": 1.0,
                "stages": {}, "request_traces": {
                    "completed": 2, "open": 0,
                    "slowest": [{"request": rank * 10 + i,
                                 "latency_s": float(i)}
                                for i in range(2)]}}
        (tmp_path / f"metrics_rank{rank}.json").write_text(json.dumps(snap))
    agg = tel.aggregate_snapshots(str(tmp_path))
    assert len(agg["request_traces"]["slowest"]) == 2


def test_check_metric_docs_lint(tmp_path):
    """The port twin of the metric-docs lint: every metric the port's
    package registers with a literal name is documented in README.md.
    The lint reads ``<root>/sparkdl_tpu``, so the root here holds the
    port's package under that name; synthetic drift is still caught."""
    mod = _load_script("check_metric_docs")
    root = tmp_path / "port"
    root.mkdir()
    os.symlink(os.path.join(_REPO, "sparkdl_tpu_torch"),
               root / "sparkdl_tpu")
    readme = os.path.join(_REPO, "README.md")
    names = mod.code_metric_names(str(root))
    assert "serving_ttft_s" in names and len(names) > 20
    assert mod.missing_metrics(root=str(root), readme=readme) == []
    pkg = tmp_path / "drift" / "sparkdl_tpu"
    pkg.mkdir(parents=True)
    (pkg / "x.py").write_text(
        'reg.counter("totally_new_metric_total").inc()\n'
        '_metric("gauge", "another_new_gauge", 1)\n')
    missing = mod.missing_metrics(root=str(tmp_path / "drift"),
                                  readme=readme)
    assert missing == ["another_new_gauge", "totally_new_metric_total"]


# ---------------------------------------------------------------------------
# side by side
# ---------------------------------------------------------------------------

def test_serving_dir_reports_equal_reference(tmp_path, monkeypatch):
    """One Stub serving workload's event dir through both packages:
    ``analyze``, ``utilization_from_events``, ``request_summary`` (with an
    SLO objective armed) and both text renderings agree."""
    _run_serving_workload(tmp_path, monkeypatch, n=12)
    monkeypatch.setenv("SPARKDL_SLO_TTFT_S", "5.0")
    outs = []
    for _, an, _tel in PKGS:
        recs = an.load_event_dir(str(tmp_path))
        rep = an.analyze(events=recs)
        req = an.request_summary(recs, top_n=5)
        outs.append(dict(recs=recs, rep=rep,
                         util=an.utilization_from_events(recs), req=req,
                         txt=an.format_report(rep),
                         req_txt=an.format_request_summary(req)))
    ref, port = outs
    assert ref["recs"] == port["recs"] and port["req"]["completed"] == 12
    for k in ("rep", "util", "req"):
        assert_json_equal(json.loads(json.dumps(ref[k], default=str)),
                          json.loads(json.dumps(port[k], default=str)))
    assert ref["txt"] == port["txt"] and ref["req_txt"] == port["req_txt"]


def test_gang_dir_reports_equal_reference(tmp_path):
    """A seeded two-rank gang dir (stages on both ranks, a gang-* subdir
    beside an older one) through both packages' ``analyze``."""
    import random
    rng = random.Random(7)
    old, new = tmp_path / "gang-1", tmp_path / "gang-2"
    for d in (old, new):
        d.mkdir()
    for rank in (0, 1):
        recs, t = [], 100.0
        for step in range(40):
            for stage in ("data_fetch", "shard_put", "step_compute"):
                dur = rng.uniform(0.001, 0.05)
                recs += _span_records(stage, [(t, t + dur)], rank=rank,
                                      rows=32, bytes=4096, step=step)
                t += dur + rng.uniform(0.0, 0.01)
        _write_stream(new / f"events_rank{rank}.jsonl", recs)
    _write_stream(old / "events_rank0.jsonl",
                  _span_records("step_compute", [(0.0, 1.0)]))
    os.utime(old, (1, 1))
    reps = [an.analyze(event_dir=str(tmp_path)) for _, an, _tel in PKGS]
    assert reps[1]["stages"]["step_compute"]["count"] == 80
    assert_json_equal(reps[0], reps[1])
    assert ref_analysis.format_report(reps[0]) == \
        analysis.format_report(reps[1])


def test_analysis_imports_no_torch_by_itself():
    """The readers are standard library only: ``analysis`` and
    ``traceview`` import nothing of torch themselves (the runner
    package's ``__init__`` does)."""
    import ast
    for name in ("analysis", "traceview"):
        path = os.path.join(_REPO, "sparkdl_tpu_torch", "runner",
                            f"{name}.py")
        tree = ast.parse(open(path).read())
        mods = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module
                 and n.level == 0}
        assert mods <= {"__future__", "json", "os", "re", "typing"} | set(
            sys.stdlib_module_names), (name, mods)
