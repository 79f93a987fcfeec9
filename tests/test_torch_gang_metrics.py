"""The gang's telemetry and trace context in the port's supervisor
(``runner/telemetry.py``'s ``aggregate_snapshots`` / ``clear_rank_files``,
``runner/launcher.py``'s metrics-dir isolation and trace manifest), on
the CPU, against the JAX package's.

Twins of ``tests/test_telemetry.py::TestGangAggregation`` (on the same
synthetic snapshots) and of ``tests/test_traceplane.py``'s
``TestLauncherPropagation`` and ``TestMergeTimelineResize``, the tests
that read only the launcher and ``events`` (the manifest is read as the
file it is; the trace exporter's twins are in
``test_torch_traceview.py``). The workers are standard-library scripts;
each runs through the reference and the port, each in its own directory,
and their results are held equal.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
import os

import pytest

from sparkdl_tpu.runner import events as ref_events
from sparkdl_tpu.runner import launcher as ref_launcher
from sparkdl_tpu.runner import telemetry as ref_telemetry
from sparkdl_tpu_torch.runner import events, launcher, telemetry

PKGS = [("ref", ref_launcher, ref_telemetry, ref_events),
        ("port", launcher, telemetry, events)]

_STAGE = {"count": 5, "busy_s": 4.0, "wall_busy_s": 4.0, "busy_frac": 0.4,
          "rows": 50, "bytes": 1000, "errors": 0, "active": 0,
          "max_concurrency": 2}

# a worker that exports one telemetry snapshot (tests/test_telemetry.py)
_SNAP_WORKER = """
import json, os, sys
d = os.environ["SPARKDL_METRICS_DIR"]
os.makedirs(d, exist_ok=True)
rank = os.environ.get("SPARKDL_PROCESS_ID", "0")
snap = {"t": 1.0, "rank": int(rank), "pid": os.getpid(), "elapsed_s": 2.0,
        "stages": {"step_compute": {"count": 4, "busy_s": 1.5,
                                    "wall_busy_s": 1.5, "busy_frac": 0.75,
                                    "rows": 32, "bytes": 0, "errors": 0,
                                    "active": 0, "max_concurrency": 1}}}
tmp = os.path.join(d, f"metrics_rank{rank}.json.tmp")
open(tmp, "w").write(json.dumps(snap))
os.replace(tmp, os.path.join(d, f"metrics_rank{rank}.json"))
"""


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("SPARKDL_EVENT_DIR", "SPARKDL_METRICS_DIR", "SPARKDL_TRACE_ID",
              "SPARKDL_TRACE_PARENT", "SPARKDL_CHAOS"):
        monkeypatch.delenv(k, raising=False)


def _write_snap(d, rank, stages, elapsed=10.0, events_=None, t=None):
    os.makedirs(d, exist_ok=True)
    snap = {"t": 100.0 + rank if t is None else t, "rank": rank, "pid": 1,
            "elapsed_s": elapsed, "stages": stages}
    if events_:
        snap["events"] = events_
    with open(os.path.join(d, f"metrics_rank{rank}.json"), "w") as f:
        json.dump(snap, f)


class TestGangAggregation:
    def test_aggregate_sums_stages_across_ranks(self, tmp_path):
        d = str(tmp_path)
        _write_snap(d, 0, {"decode": dict(_STAGE)},
                    events_={"quarantine": 1})
        _write_snap(d, 1, {"decode": dict(_STAGE, busy_s=6.0,
                                          wall_busy_s=6.0, rows=70)},
                    events_={"quarantine": 2})
        agg = telemetry.aggregate_snapshots(d)
        assert agg == ref_telemetry.aggregate_snapshots(d)
        dec = agg["stages"]["decode"]
        assert agg["n_ranks"] == 2
        assert dec["busy_s"] == 10.0 and dec["rows"] == 120
        assert dec["count"] == 10 and dec["max_concurrency"] == 2
        assert dec["busy_frac"] == 0.5
        assert agg["events"] == {"quarantine": 3}

    def test_aggregate_registry_and_traces(self, tmp_path):
        """Counters summed, gauges max'd, histograms merged bucket by
        bucket (a mismatched layout skipped), the request-trace tails
        merged and re-ranked — as the reference does."""
        d = str(tmp_path)
        for r, (c, g, lat) in enumerate(((3.0, 0.5, 0.2), (4.0, 0.9, 0.7))):
            snap = {"t": 1.0, "rank": r, "elapsed_s": 5.0, "stages": {},
                    "counters": {"gang_resizes": c},
                    "gauges": {"queue": {"value": g, "max": g * 2}},
                    "histograms": {
                        "lat": {"bounds": [0.1, 1.0], "buckets": [r, 2],
                                "count": 2 + r, "sum": 1.5},
                        "odd": {"bounds": [0.1 * (r + 1)], "buckets": [1],
                                "count": 1, "sum": 0.1}},
                    "request_traces": {"completed": 2, "open": r,
                                       "slowest": [{"latency_s": lat}]}}
            with open(os.path.join(d, f"metrics_rank{r}.json"), "w") as f:
                json.dump(snap, f)
        agg = telemetry.aggregate_snapshots(d)
        assert agg == ref_telemetry.aggregate_snapshots(d)
        assert agg["counters"] == {"gang_resizes": 7.0}
        assert agg["gauges"]["queue"] == {"value": 0.9, "max": 1.8}
        assert agg["histograms"]["lat"]["buckets"] == [1, 4]
        assert agg["request_traces"]["slowest"][0]["latency_s"] == 0.7

    def test_aggregate_empty_dir_is_none(self, tmp_path):
        for tel in (ref_telemetry, telemetry):
            assert tel.aggregate_snapshots(str(tmp_path)) is None
            assert tel.aggregate_snapshots(str(tmp_path / "missing")) \
                is None

    def test_aggregate_falls_back_to_newest_gang_subdir(self, tmp_path):
        """Pointed at ``$SPARKDL_METRICS_DIR`` itself, the view is the
        newest ``gang-*`` subdir's (never a merge of several gangs)."""
        old, new = tmp_path / "gang-old", tmp_path / "gang-new"
        _write_snap(str(old), 0, {"stale": dict(_STAGE)})
        _write_snap(str(new), 0, {"fresh": dict(_STAGE)})
        os.utime(old, (1, 1))
        agg = telemetry.aggregate_snapshots(str(tmp_path))
        assert agg == ref_telemetry.aggregate_snapshots(str(tmp_path))
        assert set(agg["stages"]) == {"fresh"}

    def test_clear_rank_files(self, tmp_path):
        for name, _mod, tel, _ev in PKGS:
            d = tmp_path / name
            _write_snap(str(d), 0, {})
            (d / "metrics_rank0.jsonl").write_text("{}\n")
            (d / "keep.txt").write_text("x")
            tel.clear_rank_files(str(d))
            assert sorted(os.listdir(d)) == ["keep.txt"], name

    def test_supervise_attaches_gang_metrics(self, tmp_path):
        """A worker that exports a snapshot: ``SuperviseResult.metrics``
        carries the aggregated gang view, the same in both."""
        views = []
        for name, mod, _tel, _ev in PKGS:
            script = tmp_path / f"{name}.py"
            script.write_text(_SNAP_WORKER)
            res = mod.supervise(
                str(script), np=2, timeout_s=30.0, max_restarts=0,
                poll_s=0.2,
                env={"SPARKDL_METRICS_DIR": str(tmp_path / name)})
            assert res.metrics is not None, name
            views.append({k: v for k, v in res.metrics.items()
                          if k != "per_rank"})
        assert views[0] == views[1]
        assert views[1]["n_ranks"] == 2
        assert views[1]["stages"]["step_compute"]["rows"] == 64

    def test_launch_failure_metrics_ignore_stale_rank_files(self, tmp_path):
        """A reused ``SPARKDL_METRICS_DIR`` holding a dead 4-rank gang's
        snapshots is not this gang's failure evidence: ``launch`` gives the
        gang a fresh ``gang-*`` subdir."""
        st = dict(_STAGE, count=9, busy_s=9.0, wall_busy_s=9.0, rows=999)
        for name, mod, _tel, _ev in PKGS:
            mdir = tmp_path / name / "metrics"
            for r in (2, 3):
                _write_snap(str(mdir), r, {"stale_stage": dict(st)})
            edir = tmp_path / name / "events"
            script = tmp_path / name / "w.py"
            script.write_text(_SNAP_WORKER + """
import time
with open(os.path.join(os.environ["SPARKDL_EVENT_DIR"],
                       f"events_rank{rank}.jsonl"), "w") as f:
    f.write(json.dumps({"t": time.time(), "name": "step_compute",
                        "ph": "E", "dur_s": 0.1, "rank": int(rank)}) + "\\n")
if rank == "0":
    time.sleep(0.5)  # let rank 1 land its files before the gang dies
    sys.exit(1)
""")
            with pytest.raises(mod.GangFailure) as ei:
                mod.launch(str(script), np=2, timeout_s=30.0, poll_s=0.2,
                           capture=True, event_dir=str(edir),
                           env={"SPARKDL_METRICS_DIR": str(mdir)})
            tl = ei.value.timeline
            assert tl is not None and tl.get("metrics") is not None, name
            assert tl["metrics"]["n_ranks"] == 2
            assert "stale_stage" not in tl["metrics"]["stages"]
            assert tl["metrics"]["stages"]["step_compute"]["rows"] == 64
            assert any(fn.startswith("gang-") for fn in os.listdir(mdir))
            assert (mdir / "metrics_rank3.json").exists()


# --- TestLauncherPropagation ------------------------------------------------

_TRACE_WORKER = """
import json, os, sys
rank = int(os.environ["SPARKDL_PROCESS_ID"])
d = os.environ["SPARKDL_EVENT_DIR"]
rec = {"t": 100.0 + rank, "name": "worker_span", "ph": "E", "rank": rank,
       "dur_s": 0.5, "trace_id": os.environ.get("SPARKDL_TRACE_ID"),
       "span_id": f"w{rank}",
       "parent_id": os.environ.get("SPARKDL_TRACE_PARENT")}
with open(os.path.join(d, f"events_rank{rank}.jsonl"), "w") as f:
    f.write(json.dumps(rec) + "\\n")
"""


def _manifest(event_dir) -> dict:
    with open(os.path.join(event_dir, events.TRACE_MANIFEST_FILE)) as f:
        return json.load(f)


class TestLauncherPropagation:
    def test_supervise_ships_trace_context_and_writes_manifest(
            self, tmp_path):
        """Both ranks inherit one trace id and a parent span id that is the
        attempt span of the supervisor's manifest, under the run root."""
        shapes = []
        for name, mod, _tel, _ev in PKGS:
            script = tmp_path / f"{name}.py"
            script.write_text(_TRACE_WORKER)
            event_dir = str(tmp_path / name)
            mod.supervise(str(script), np=2, timeout_s=60.0,
                          max_restarts=0, backoff_s=0.1, poll_s=0.1,
                          event_dir=event_dir)
            manifest = _manifest(event_dir)
            assert manifest["trace_id"]
            spans = {s["span_id"]: s for s in manifest["spans"]}
            root = manifest["root_span_id"]
            assert spans[root]["parent_id"] is None
            attempt = [s for s in manifest["spans"]
                       if s["name"] == "gang_attempt"]
            assert attempt and attempt[0]["parent_id"] == root
            for rank in (0, 1):
                with open(os.path.join(event_dir,
                                       f"events_rank{rank}.jsonl")) as f:
                    (rec,) = [json.loads(ln) for ln in f]
                assert rec["trace_id"] == manifest["trace_id"]
                assert rec["parent_id"] == attempt[-1]["span_id"]
            shapes.append([(s["name"], sorted(s)) for s in
                           manifest["spans"]])
        assert shapes[0] == shapes[1], shapes

    def test_trace_env_of_caller_is_respected(self, tmp_path):
        for name, mod, _tel, _ev in PKGS:
            script = tmp_path / f"{name}.py"
            script.write_text(_TRACE_WORKER)
            event_dir = str(tmp_path / name)
            mod.supervise(str(script), np=1, timeout_s=60.0,
                          max_restarts=0, backoff_s=0.1, poll_s=0.1,
                          event_dir=event_dir,
                          env={events.TRACE_ID_ENV: "feedcafe01234567"})
            assert _manifest(event_dir)["trace_id"] == "feedcafe01234567"

    def test_launch_writes_a_root_manifest(self, tmp_path):
        """``launch``'s single-attempt manifest: one ``launch`` root span,
        the ranks' parent."""
        for name, mod, _tel, _ev in PKGS:
            script = tmp_path / f"{name}.py"
            script.write_text(_TRACE_WORKER)
            event_dir = str(tmp_path / name)
            mod.launch(str(script), np=2, timeout_s=60.0, poll_s=0.1,
                       event_dir=event_dir)
            manifest = _manifest(event_dir)
            (span,) = manifest["spans"]
            assert span["name"] == "launch" and span["np"] == 2
            with open(os.path.join(event_dir, "events_rank1.jsonl")) as f:
                assert json.loads(f.read())["parent_id"] == \
                    manifest["root_span_id"]


# --- TestMergeTimelineResize ------------------------------------------------

def _write_stream(d, rank, recs):
    with open(os.path.join(d, f"events_rank{rank}.jsonl"), "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


class TestMergeTimelineResize:
    def test_gang_resized_is_narrative_never_failure_evidence(
            self, tmp_path):
        d = str(tmp_path)
        _write_stream(d, 0, [
            {"t": 100.0, "name": "gang_resized", "ph": "P", "rank": 0,
             "from_np": 4, "to_np": 3, "reason": "rank_died",
             "error": "rank 2 exited 137 (permanent)"},
            {"t": 101.0, "name": "step_compute", "ph": "E", "rank": 0,
             "step": 10, "dur_s": 0.01},
        ])
        tl = events.merge_timeline(d)
        assert tl == ref_events.merge_timeline(d)
        assert tl["first_failure"] is None
        assert "gang_resized" in [dg["kind"] for dg in tl["degradations"]]
        assert "gang_resized" in events.format_timeline(tl)
        assert events.format_timeline(tl) == ref_events.format_timeline(tl)

    def test_resize_then_real_fault_attributes_to_the_fault(self, tmp_path):
        d = str(tmp_path)
        _write_stream(d, 0, [
            {"t": 100.0, "name": "gang_resized", "ph": "P", "rank": 0,
             "from_np": 2, "to_np": 1, "reason": "rank_died",
             "error": "rank 1 exited 137"},
            {"t": 105.0, "name": "chaos", "ph": "P", "rank": 0,
             "site": "step_start", "kind": "fatal", "step": 7},
        ])
        tl = events.merge_timeline(d)
        assert tl == ref_events.merge_timeline(d)
        assert tl["first_failure"]["site"] == "step_start"
        assert tl["first_failure"]["step"] == 7
        assert any(dg["kind"] == "gang_resized"
                   for dg in tl["degradations"])
