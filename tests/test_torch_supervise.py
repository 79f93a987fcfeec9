"""The port's gang supervisor (``sparkdl_tpu_torch.runner.launcher``:
``supervise``, the heartbeat watchdog, poison-batch quarantine, elastic
resizing, the CLI) against the JAX package's, on the CPU.

Twins of ``tests/test_multiprocess.py``'s ``TestGangSupervision``
(watchdog, restart, fatal, budget), ``TestPoisonBatchQuarantine`` and
``TestElasticSupervision``, and of ``tests/test_events.py``'s
``TestGangTimeline`` and ``TestGangEventDirIsolation``. Each twin runs the
same worker script — standard library only, so a gang attempt costs
~50 ms — through ``sparkdl_tpu.runner.launcher`` and through the port,
each in its own directory (the scripts keep their state in marker files),
and holds the port's restart ledger (``failure_kinds``, ``restarts``,
``attempts``, ``quarantined_batches``, ``resizes``, ``final_np``, the
degradations' names) or its ``GangFailure`` (kind, hung, the message's
verdict) equal to the reference's. The CLI and the elastic restore of a
replicated checkpoint close the file.
"""

import json
import os
import sys
import time

import pytest
import torch

from sparkdl_tpu.runner import events as ref_events
from sparkdl_tpu.runner import launcher as ref_launcher
from sparkdl_tpu.runner import metrics as ref_metrics
from sparkdl_tpu.runner.chaos import Fault as RefFault
from sparkdl_tpu.runner.chaos import FaultPlan as RefFaultPlan
from sparkdl_tpu.runner.failures import PoisonDataError as RefPoisonDataError
from sparkdl_tpu_torch.runner import events, launcher, metrics
from sparkdl_tpu_torch.runner.chaos import Fault, FaultPlan
from sparkdl_tpu_torch.runner.failures import PoisonDataError

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (package name, launcher, Fault, FaultPlan, PoisonDataError, metrics,
# events): the reference first, then the port
PKGS = [("ref", ref_launcher, RefFault, RefFaultPlan, RefPoisonDataError,
         ref_metrics, ref_events),
        ("port", launcher, Fault, FaultPlan, PoisonDataError, metrics,
         events)]

# the reference's own timings (tests/test_multiprocess.py)
FAST = dict(timeout_s=30.0, backoff_s=0.05, poll_s=0.2)


def _ledger(res) -> dict:
    """A ``SuperviseResult``'s restart ledger, what both packages must
    agree on."""
    return dict(failure_kinds=res.failure_kinds, restarts=res.restarts,
                attempts=res.attempts,
                quarantined_batches=res.quarantined_batches,
                resizes=res.resizes, final_np=res.final_np,
                degradations=sorted({d.get("name")
                                     for d in res.degradations}),
                all_ok=all(r.returncode == 0 for r in res.results))


def _both(tmp_path, write, **kw) -> list:
    """``supervise`` of the script ``write(dir)`` returns (path, args)
    through the reference and the port, each in its own directory: the
    two ledgers, which must be equal."""
    out = []
    for name, mod, *_ in PKGS:
        d = tmp_path / name
        d.mkdir()
        script, args = write(d)
        out.append(_ledger(mod.supervise(str(script), args=args, **kw)))
    assert out[0] == out[1], out
    return out


def _both_fail(tmp_path, write, exc=None, **kw) -> list:
    """As :func:`_both` for a run that raises: the two exceptions, of the
    same class name, kind and hung flag."""
    errs = []
    for name, mod, *_ in PKGS:
        d = tmp_path / name
        d.mkdir()
        script, args = write(d)
        with pytest.raises(exc or mod.GangFailure) as ei:
            mod.supervise(str(script), args=args, **kw)
        errs.append(ei.value)
    kinds = [(type(e).__name__, getattr(e, "kind", None),
              getattr(e, "hung", None)) for e in errs]
    assert kinds[0] == kinds[1], kinds
    return errs


def _script(body: str):
    def write(d):
        p = d / "w.py"
        p.write_text(body)
        return p, []
    return write


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("SPARKDL_EVENT_DIR", "SPARKDL_METRICS_DIR", "SPARKDL_ELASTIC",
              "SPARKDL_ELASTIC_MIN_NP", "SPARKDL_SKIP_BATCHES",
              "SPARKDL_MAX_SKIPPED_BATCHES", "SPARKDL_TRACE_ID",
              "SPARKDL_HEARTBEAT_DIR", "SPARKDL_CHAOS"):
        monkeypatch.delenv(k, raising=False)
    for *_, m, ev in PKGS:
        m.run_stats.reset()
        ev.reset()
    yield
    for *_, m, ev in PKGS:
        m.run_stats.reset()


# --- TestGangSupervision ----------------------------------------------------

class TestGangSupervision:
    def test_watchdog_detects_stale_heartbeat(self, tmp_path):
        """A rank that beats once then stalls is caught by the heartbeat
        watchdog long before ``timeout_s``, in both packages; the port's
        message names the step the beat carried."""
        msgs = []
        for name, mod, *_ in PKGS:
            hb = tmp_path / name / "hb"
            hb.mkdir(parents=True)
            script = tmp_path / name / "w.py"
            script.write_text(
                "import os, time\n"
                "d = os.environ['SPARKDL_HEARTBEAT_DIR']\n"
                "r = os.environ['SPARKDL_PROCESS_ID']\n"
                "open(os.path.join(d, 'rank%s.hb' % r), 'w').write('7')\n"
                "time.sleep(120)\n")
            t0 = time.monotonic()
            with pytest.raises(mod.GangFailure) as ei:
                mod.launch(str(script), np=2, timeout_s=120.0, capture=True,
                           poll_s=0.25, heartbeat_dir=str(hb),
                           watchdog_s=1.5)
            wall = time.monotonic() - t0
            assert wall < 30, f"{name}: watchdog took {wall:.1f}s"
            assert ei.value.hung and ei.value.kind == "retryable"
            msgs.append(str(ei.value))
        for m in msgs:
            assert "heartbeat watchdog" in m and "step 7" in m, m

    def test_clear_heartbeats_removes_every_rank(self, tmp_path):
        """Before an attempt every ``rank*.hb`` goes, the ranks of a larger
        earlier gang too (a shrunken gang must not see a dead rank's
        beat); other files stay."""
        for name, mod, *_ in PKGS:
            d = tmp_path / name
            d.mkdir()
            for fn in ("rank0.hb", "rank3.hb", "keep.txt"):
                (d / fn).write_text("1")
            mod._clear_heartbeats(str(d), 2)
            assert sorted(os.listdir(d)) == ["keep.txt"], name

    def test_supervise_restarts_retryable_and_succeeds(self, tmp_path):
        def write(d):
            p = d / "w.py"
            p.write_text(
                "import os, sys\n"
                "m = sys.argv[1]\n"
                "if os.environ['SPARKDL_PROCESS_ID'] == '0' "
                "and not os.path.exists(m):\n"
                "    open(m, 'w').write('x')\n"
                "    print('UNAVAILABLE: injected backend flake',"
                " file=sys.stderr)\n"
                "    sys.exit(1)\n")
            return p, [str(d / "m")]

        got, _ = _both(tmp_path, write, np=2, timeout_s=60.0,
                       max_restarts=2, backoff_s=0.05, poll_s=0.25)
        assert got["restarts"] == 1 and got["attempts"] == 2
        assert got["failure_kinds"] == ["retryable"] and got["all_ok"]

    def test_supervise_fatal_does_not_retry(self, tmp_path):
        def write(d):
            p = d / "w.py"
            p.write_text(
                "import sys\n"
                "with open(sys.argv[1], 'a') as f: f.write('attempt\\n')\n"
                "raise ValueError('user bug')\n")
            return p, [str(d / "count")]

        errs = _both_fail(tmp_path, write, np=2, timeout_s=60.0,
                          max_restarts=3, backoff_s=0.05, poll_s=0.25)
        assert errs[1].kind == "fatal"
        for name, *_ in PKGS:
            n = (tmp_path / name / "count").read_text().count("attempt")
            assert 1 <= n <= 2, (name, n)

    def test_supervise_budget_exhaustion(self, tmp_path):
        errs = _both_fail(tmp_path, _script(
            "import sys\nprint('UNAVAILABLE: forever', file=sys.stderr)\n"
            "sys.exit(1)\n"), np=2, timeout_s=60.0, max_restarts=1,
            backoff_s=0.05, poll_s=0.25)
        for e in errs:
            assert "giving up after 1" in str(e), str(e)


# --- TestPoisonBatchQuarantine ----------------------------------------------

# the reference's poison worker (tests/test_multiprocess.py), verbatim
_POISON_WORKER = """
import json, os, sys, time
skip = json.loads(os.environ.get("SPARKDL_SKIP_BATCHES", "[]"))
mode = {mode!r}
bi = {pick}
if bi is None:
    sys.exit(0)
d = os.environ["SPARKDL_EVENT_DIR"]
err = ({{"type": "TrainingDivergedError",
        "message": "training diverged: non-finite loss (nan) at step %d" % bi}}
       if mode == "fatal" else
       {{"type": "InjectedPreemption", "message": "UNAVAILABLE: poison"}})
pm = {{"t": time.time(), "rank": 0, "site": "fit", "step": bi,
      "batch_index": bi, "error": err}}
tmp = os.path.join(d, "postmortem_rank0.json.tmp")
open(tmp, "w").write(json.dumps(pm))
os.replace(tmp, os.path.join(d, "postmortem_rank0.json"))
print(err["type"] + ": " + err["message"], file=sys.stderr)
sys.exit(1)
"""


def _poison(mode="retryable", pick="8 if 8 not in skip else None"):
    return _script(_POISON_WORKER.format(mode=mode, pick=pick))


class TestPoisonBatchQuarantine:
    def test_retryable_poison_quarantined_after_two_failures(self,
                                                             tmp_path):
        """The ledger, the counter and the supervisor-side degradation
        record (the same shape in both, but for its time)."""
        ledgers, recs = [], []
        for name, mod, *_, m, _ev in PKGS:
            d = tmp_path / name
            d.mkdir()
            script, _ = _poison()(d)
            res = mod.supervise(str(script), np=1, max_restarts=1, **FAST)
            ledgers.append(_ledger(res))
            q = next(x for x in res.degradations
                     if x.get("name") == "train_batch_quarantined")
            recs.append({k: v for k, v in q.items() if k != "t"})
            assert m.run_stats.train_batches_quarantined == 1, name
        assert ledgers[0] == ledgers[1] and recs[0] == recs[1]
        got = ledgers[1]
        assert got["quarantined_batches"] == [8]
        assert got["failure_kinds"] == ["retryable", "quarantined"]
        assert got["restarts"] == 2
        assert "train_batch_quarantined" in got["degradations"]
        assert recs[1]["batch_index"] == 8 and recs[1]["skip_list"] == [8]

    def test_fatal_poison_gets_probe_restart_then_quarantine(self,
                                                             tmp_path):
        got, _ = _both(tmp_path, _poison(mode="fatal"), np=1,
                       max_restarts=1, **FAST)
        assert got["quarantined_batches"] == [8]
        assert got["failure_kinds"] == ["fatal", "quarantined"]

    def test_fatal_probe_not_blocked_by_earlier_unrelated_signature(
            self, tmp_path):
        body = """
import json, os, sys, time
marker, skip = sys.argv[1], json.loads(
    os.environ.get("SPARKDL_SKIP_BATCHES", "[]"))
if not os.path.exists(marker):
    open(marker, "w").write("x")
    bi, err = 3, {"type": "InjectedPreemption",
                  "message": "UNAVAILABLE: transient flake"}
elif 8 not in skip:
    bi, err = 8, {"type": "TrainingDivergedError",
                  "message": "training diverged: non-finite loss (nan)"}
else:
    sys.exit(0)
d = os.environ["SPARKDL_EVENT_DIR"]
pm = {"t": time.time(), "rank": 0, "site": "fit", "step": bi,
      "batch_index": bi, "error": err}
tmp = os.path.join(d, "postmortem_rank0.json.tmp")
open(tmp, "w").write(json.dumps(pm))
os.replace(tmp, os.path.join(d, "postmortem_rank0.json"))
print(err["type"] + ": " + err["message"], file=sys.stderr)
sys.exit(1)
"""

        def write(d):
            p = d / "w.py"
            p.write_text(body)
            return p, [str(d / "m")]

        got, _ = _both(tmp_path, write, np=1, max_restarts=3, **FAST)
        assert got["quarantined_batches"] == [8]
        assert got["failure_kinds"] == ["retryable", "fatal", "quarantined"]

    def test_counterfactual_death_loop_without_quarantine(self, tmp_path):
        errs = _both_fail(tmp_path, _poison(pick="8"), np=1, max_restarts=2,
                          quarantine_batches=False, **FAST)
        for e in errs:
            assert "giving up after 2" in str(e)

    def test_batchless_fatal_still_fails_fast(self, tmp_path):
        errs = _both_fail(tmp_path, _script(
            "import sys\nraise ValueError('user bug, no batch')\n"),
            np=1, max_restarts=3, **FAST)
        for e in errs:
            assert e.kind == "fatal"
            assert "giving up after 0 restart(s)" in str(e)

    def test_unskippable_poison_fails_fast_not_requarantine_loop(
            self, tmp_path):
        errs = _both_fail(tmp_path, _poison(pick="8"), np=1, max_restarts=2,
                          **FAST)
        for e in errs:
            assert "giving up after 2 restart(s)" in str(e)

    def test_max_skipped_batches_circuit_breaker(self, tmp_path):
        errs = []
        for name, mod, _f, _p, poison_err, *_ in PKGS:
            d = tmp_path / name
            d.mkdir()
            script, _ = _poison(pick="len(skip)")(d)
            with pytest.raises(poison_err, match="circuit breaker") as ei:
                mod.supervise(str(script), np=1, max_restarts=8,
                              max_skipped_batches=2, **FAST)
            errs.append(ei.value)
        assert errs[0].quarantined == errs[1].quarantined == [0, 1]


# --- TestElasticSupervision -------------------------------------------------

_DEAD_SLOT_WORKER = """
import os, sys
w, r = os.environ["SPARKDL_NUM_PROCESSES"], os.environ["SPARKDL_PROCESS_ID"]
recovered = sys.argv[1] if len(sys.argv) > 1 else ""
if w == "3" and r == "2" and not (recovered and os.path.exists(recovered)):
    print("UNAVAILABLE: slot lost", file=sys.stderr)
    sys.exit(1)
"""

_FLAKE_AT_2 = """
if w == "2" and r == "0" and not os.path.exists({flake!r}):
    open({flake!r}, "w").write("x")
{recover}    print("UNAVAILABLE: transient flake", file=sys.stderr)
    sys.exit(1)
"""


class TestElasticSupervision:
    def test_permanent_rank_death_shrinks_without_burning_budget(
            self, tmp_path):
        got, _ = _both(tmp_path, _script(_DEAD_SLOT_WORKER), np=3,
                       max_restarts=1, env={"SPARKDL_ELASTIC": "1"}, **FAST)
        assert got["failure_kinds"] == ["retryable", "resized"]
        assert got["resizes"] == 1 and got["final_np"] == 2
        assert got["restarts"] == 2
        for *_, m, _ev in PKGS:
            assert m.run_stats.resizes == 1
            assert "np 3 -> 2" in m.run_stats.last_resize

    def test_transient_failure_does_not_resize(self, tmp_path):
        def write(d):
            p = d / "w.py"
            p.write_text(
                "import os, sys\n"
                "m = sys.argv[1]\n"
                "if os.environ['SPARKDL_PROCESS_ID'] == '1' "
                "and not os.path.exists(m):\n"
                "    open(m, 'w').write('x')\n"
                "    print('UNAVAILABLE: flake', file=sys.stderr)\n"
                "    sys.exit(1)\n")
            return p, [str(d / "m")]

        got, _ = _both(tmp_path, write, np=3, max_restarts=2, elastic=True,
                       **FAST)
        assert got["failure_kinds"] == ["retryable"]
        assert got["resizes"] == 0 and got["final_np"] == 3

    def test_min_np_floor_gives_up_with_clear_error(self, tmp_path):
        errs = _both_fail(tmp_path, _script(_DEAD_SLOT_WORKER), np=3,
                          max_restarts=1, elastic=True, min_np=3, **FAST)
        for e in errs:
            msg = str(e)
            assert "elastic floor" in msg and "SPARKDL_ELASTIC_MIN_NP" in msg
            assert "rank 2 of 3 is permanently dead" in msg

    def test_recovered_capacity_grows_back_via_probe(self, tmp_path):
        def write(d):
            recovered, flake = str(d / "recovered"), str(d / "flake")
            p = d / "w.py"
            p.write_text(_DEAD_SLOT_WORKER + _FLAKE_AT_2.format(
                flake=flake,
                recover=f"    open({recovered!r}, 'w').write('x')\n"))
            return p, [recovered]

        reasons = []
        for name, mod, *_ in PKGS:
            d = tmp_path / name
            d.mkdir()
            script, args = write(d)
            res = mod.supervise(str(script), np=3, args=args,
                                max_restarts=3, elastic=True, **FAST)
            assert res.failure_kinds == ["retryable", "resized",
                                         "retryable"], (name, res)
            assert res.resizes == 2 and res.final_np == 3
            reasons.append([x.get("reason") for x in res.degradations
                            if x.get("name") == "gang_resized"])
        assert reasons[0] == reasons[1] == ["rank_dead", "grow_probe"]

    def test_failed_probe_reverts_free_and_finishes_shrunk(self, tmp_path):
        def write(d):
            p = d / "w.py"
            p.write_text(_DEAD_SLOT_WORKER + _FLAKE_AT_2.format(
                flake=str(d / "flake"), recover=""))
            return p, []

        got, _ = _both(tmp_path, write, np=3, max_restarts=2, elastic=True,
                       **FAST)
        assert got["failure_kinds"] == ["retryable", "resized", "retryable",
                                        "probe_failed"]
        assert got["final_np"] == 2
        assert got["resizes"] == 3 and got["restarts"] == 4

    def test_elastic_off_death_loops(self, tmp_path):
        errs = _both_fail(tmp_path, _script(_DEAD_SLOT_WORKER), np=3,
                          max_restarts=1, **FAST)
        for e in errs:
            assert "giving up after 1" in str(e)


# --- TestGangTimeline / TestGangEventDirIsolation ---------------------------

# the reference's timeline worker (tests/test_events.py), on each package
_TIMELINE_WORKER = """
import os, sys, time
sys.path.insert(0, {repo!r})
from {pkg}.runner import chaos, events
rank = int(os.environ["SPARKDL_PROCESS_ID"])
for step in range(4):
    with events.span("step_compute", step=step):
        try:
            chaos.fire("step_start", step=step)
        except Exception as e:
            events.postmortem(e, site="step_start", step=step)
            raise
        time.sleep(0.05)
time.sleep(60)  # survivor: wait for the gang kill
"""


class TestGangTimeline:
    def test_supervise_failure_carries_merged_timeline(self, tmp_path):
        """A chaos-injected gang failure under ``supervise`` carries the
        merged, time-ordered timeline naming the first-failing rank, its
        last step and the fault site, written beside the stderr and named
        in the message — the same in both packages."""
        tls = []
        for (name, mod, fault, plan, *_), pkg in zip(
                PKGS, ("sparkdl_tpu", "sparkdl_tpu_torch")):
            script = tmp_path / f"{name}.py"
            script.write_text(_TIMELINE_WORKER.format(repo=_REPO, pkg=pkg))
            event_dir = tmp_path / f"{name}_events"
            with pytest.raises(mod.GangFailure) as ei:
                mod.supervise(str(script), np=2, timeout_s=120.0,
                              max_restarts=0, backoff_s=0.05, poll_s=0.25,
                              plan=plan([fault("step_start", "preempt",
                                               at_step=2, rank=1)]),
                              event_dir=str(event_dir))
            err = ei.value
            tl = err.timeline
            assert tl is not None, name
            ts = [e["t"] for e in tl["events"]]
            assert ts == sorted(ts)
            merged = event_dir / events.GANG_TIMELINE_FILE
            assert json.loads(merged.read_text())["first_failing_rank"] == 1
            assert "gang timeline" in str(err)
            assert "first failure on rank 1" in str(err)
            tls.append((tl["first_failing_rank"],
                        tl["first_failure"]["site"],
                        tl["first_failure"]["step"],
                        tl["ranks"]["1"]["last_step"]))
        assert tls[0] == tls[1] == (1, "step_start", 2, 2), tls


class TestGangEventDirIsolation:
    def test_supervise_does_not_clobber_callers_event_stream(
            self, tmp_path, monkeypatch):
        """A caller whose own recorder streams to ``SPARKDL_EVENT_DIR``
        keeps its ``events_rank0.jsonl`` across ``supervise``: the gang
        gets an adopted ``gang-*`` subdir, pruned when the workers wrote
        nothing."""
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "0")
        for name, mod, *_, ev in PKGS:
            d = tmp_path / name
            d.mkdir()
            monkeypatch.setenv("SPARKDL_EVENT_DIR", str(d))
            rec = ev.reset()
            rec.event("parent_alive")
            script = d / "w.py"
            script.write_text("import sys; sys.exit(1)\n")
            with pytest.raises(mod.GangFailure):
                mod.supervise(str(script), np=1, timeout_s=30.0,
                              max_restarts=0, backoff_s=0.05, poll_s=0.25)
            rec.event("parent_still_alive")
            rec.close()
            lines = (d / "events_rank0.jsonl").read_text().splitlines()
            assert [json.loads(ln)["name"] for ln in lines] == \
                ["parent_alive", "parent_still_alive"], name
            assert not any(p.name.startswith("gang-")
                           for p in d.iterdir() if p.is_dir()), name


# --- the CLI ----------------------------------------------------------------

class TestCli:
    _FLAKY = ("import os, sys\n"
              "m = sys.argv[1]\n"
              "print('rank', os.environ['SPARKDL_PROCESS_ID'], 'ran')\n"
              "if os.environ['SPARKDL_PROCESS_ID'] == '0' "
              "and not os.path.exists(m):\n"
              "    open(m, 'w').write('x')\n"
              "    print('UNAVAILABLE: flake', file=sys.stderr)\n"
              "    sys.exit(1)\n")

    def test_cli_supervises_a_flaky_gang(self, tmp_path, capsys):
        """``main(["--np", "2", "--restarts", "1", script, arg])`` relaunches
        the flaky gang once, replays each rank's output and says how many
        restarts it took — in both packages."""
        outs = []
        for name, mod, *_ in PKGS:
            d = tmp_path / name
            d.mkdir()
            script = d / "w.py"
            script.write_text(self._FLAKY)
            assert mod.main(["--np", "2", "--restarts", "1",
                             "--timeout", "60", str(script),
                             str(d / "m")]) == 0
            cap = capsys.readouterr()
            outs.append((sorted(ln for ln in cap.out.splitlines()),
                         [ln for ln in cap.err.splitlines()
                          if ln.startswith("launcher:")]))
        assert outs[0] == outs[1], outs
        assert outs[1][1] == ["launcher: completed after 1 restart(s)"]
        assert "rank 1 ran" in outs[1][0]

    def test_cli_without_restarts_launches_once(self, tmp_path):
        """No ``--restarts`` and no ``--watchdog``: a plain ``launch``, whose
        failure raises ``GangFailure``."""
        script = tmp_path / "w.py"
        script.write_text(self._FLAKY)
        with pytest.raises(launcher.GangFailure, match="rank"):
            launcher.main(["--np", "2", str(script), str(tmp_path / "m")])
        assert launcher.main(["--np", "2", str(script),
                              str(tmp_path / "m")]) == 0

    def test_module_runs_as_a_script(self, tmp_path):
        """``python -m sparkdl_tpu_torch.runner.launcher --np 2 --restarts
        1 --watchdog 30 script.py arg`` exits 0 once the gang finishes."""
        import subprocess

        script = tmp_path / "w.py"
        script.write_text(self._FLAKY)
        env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        r = subprocess.run(
            [sys.executable, "-m", "sparkdl_tpu_torch.runner.launcher",
             "--np", "2", "--restarts", "1", "--watchdog", "30",
             str(script), str(tmp_path / "m")],
            env=env, capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "completed after 1 restart(s)" in r.stderr
        assert "rank 1 ran" in r.stdout


# --- the elastic restore of a replicated checkpoint -------------------------

class TestElasticRestore:
    """``CheckpointManager.restore`` under ``SPARKDL_ELASTIC=1``: a step
    saved at another world size, and differing in nothing else, loads as
    it is (the gang's state is replicated) and records
    ``checkpoint_resharded``; without the knob it raises
    ``CheckpointTopologyError``; a tensor that does not fit raises under
    both."""

    def _saved(self, tmp_path, world: int):
        from sparkdl_tpu_torch.runner import TrainState, sgd
        from sparkdl_tpu_torch.runner.checkpoint import CheckpointManager

        torch.manual_seed(0)
        model = torch.nn.Linear(4, 3)
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.world_size = world  # as a gang of ``world`` ranks saves it
        state = TrainState.create(model, sgd(0.1))
        state.step = 2
        mgr.save(2, state, wait=True)
        mgr.close()
        return {k: v.clone() for k, v in model.state_dict().items()}

    def _restore(self, tmp_path, model):
        from sparkdl_tpu_torch.runner import TrainState, sgd
        from sparkdl_tpu_torch.runner.checkpoint import CheckpointManager

        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        try:
            return mgr.restore(TrainState.create(model, sgd(0.1)))
        finally:
            mgr.close()

    def test_world_size_alone_restores_under_elastic(self, tmp_path,
                                                     monkeypatch):
        saved = self._saved(tmp_path, world=4)
        monkeypatch.setenv("SPARKDL_ELASTIC", "1")
        rec = events.reset()
        state = self._restore(tmp_path, torch.nn.Linear(4, 3))
        assert state.step == 2
        assert all(torch.equal(v, saved[k])
                   for k, v in state.model.state_dict().items())
        ev = [e for e in rec.tail() if e["name"] == "checkpoint_resharded"]
        assert len(ev) == 1 and ev[0]["step"] == 2
        assert ev[0]["mismatch"] == "saved at world size 4, restoring at 1"

    def test_world_size_raises_without_elastic(self, tmp_path):
        from sparkdl_tpu_torch.runner.checkpoint import \
            CheckpointTopologyError

        self._saved(tmp_path, world=4)
        with pytest.raises(CheckpointTopologyError,
                           match="saved at world size 4") as ei:
            self._restore(tmp_path, torch.nn.Linear(4, 3))
        assert "SPARKDL_ELASTIC=1" in str(ei.value)
        assert "Queue A 8" in str(ei.value)

    @pytest.mark.parametrize("elastic", ["0", "1"])
    def test_shape_mismatch_raises_under_both(self, tmp_path, monkeypatch,
                                              elastic):
        from sparkdl_tpu_torch.runner.checkpoint import \
            CheckpointTopologyError

        self._saved(tmp_path, world=4)
        monkeypatch.setenv("SPARKDL_ELASTIC", elastic)
        with pytest.raises(CheckpointTopologyError) as ei:
            self._restore(tmp_path, torch.nn.Linear(4, 5))
        assert "weight: saved (3, 4)" in str(ei.value)
