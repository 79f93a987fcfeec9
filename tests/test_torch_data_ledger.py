"""The port's batch ledger and exact batch attribution through ``fit``
(``runner/data.py``'s ``append_ledger`` / ``read_ledger`` and the
``data_fetch`` chaos site, ``RunnerContext.fit``'s postmortem), on the
CPU.

Twins of the 7 tests of ``tests/test_data.py::TestFitCursorThreading``:
each runs the same datasets, plans and checkpoint cadence through the JAX
package and the port, and holds the port's ledger (step, epoch, batch
index, skip-list, world size) and its postmortem's ``batch_index`` /
``epoch`` equal to the reference's. The fits train a 4×3 linear softmax
model on seeded numpy batches.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json

import numpy as np
import optax
import pytest
import torch

from sparkdl_tpu.runner import ListDataset as JaxListDataset
from sparkdl_tpu.runner import XlaRunner as JaxRunner
from sparkdl_tpu.runner import chaos as ref_chaos
from sparkdl_tpu.runner import data as ref_data
from sparkdl_tpu.runner import events as ref_events
from sparkdl_tpu.runner import softmax_cross_entropy_loss as jax_sce
from sparkdl_tpu.runner.failures import \
    TrainingDivergedError as JaxDivergedError
from sparkdl_tpu_torch.runner import (ListDataset, TrainingDivergedError,
                                      XlaRunner, chaos, events, sgd,
                                      softmax_cross_entropy_loss)
from sparkdl_tpu_torch.runner import data as data_lib

_AUDIT = ("step", "epoch", "batch_index", "skip_list", "world")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("SPARKDL_EVENT_DIR", "SPARKDL_BATCH_LEDGER",
              "SPARKDL_SKIP_BATCHES", "SPARKDL_PROCESS_ID",
              "SPARKDL_NUM_PROCESSES", chaos.CHAOS_ENV):
        monkeypatch.delenv(k, raising=False)
    for mod in (chaos, ref_chaos):
        mod.uninstall()
    for mod in (events, ref_events):
        mod.reset()
    yield
    for mod in (chaos, ref_chaos):
        mod.uninstall()
    for mod in (events, ref_events):
        mod.reset()


class Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(np.array(w)))

    def forward(self, x):
        return x @ self.w


def _batches(n, rows=8):
    return [{"image": np.random.RandomState(i).randn(rows, 4)
             .astype(np.float32),
             "label": np.random.RandomState(i).randint(0, 3, (rows,))}
            for i in range(n)]


def _w():
    return np.random.RandomState(0).randn(4, 3).astype(np.float32)


def _port_fit(ckpt_dir, data, num_steps, **kw):
    kw.setdefault("log_every", 100)
    return XlaRunner(device="cpu", checkpoint_dir=str(ckpt_dir)).run(
        lambda ctx: ctx.fit(
            loss_fn=softmax_cross_entropy_loss(), model=Linear(_w()),
            tx=sgd(0.1), data=data, num_steps=num_steps,
            checkpoint_every=2, **kw))


def _ref_fit(ckpt_dir, data, num_steps, **kw):
    kw.setdefault("log_every", 100)
    return JaxRunner(np=1, checkpoint_dir=str(ckpt_dir)).run(
        lambda ctx: ctx.fit(
            loss_fn=jax_sce(), params={"w": _w()}, tx=optax.sgd(0.1),
            apply_fn=lambda p, x: x @ p["w"], data=data,
            num_steps=num_steps, checkpoint_every=2, **kw))


# (fit, ListDataset, chaos module, events module, data module, diverged)
_PORT = (_port_fit, ListDataset, chaos, events, data_lib,
         TrainingDivergedError)
_REF = (_ref_fit, JaxListDataset, ref_chaos, ref_events, ref_data,
        JaxDivergedError)


def _audit(led):
    return [{k: e[k] for k in _AUDIT} for e in led]


def _postmortem(tmp_path, monkeypatch, pkg, tag, plan, exc, fit_args,
                **fit_kw):
    """Run one failing fit under ``plan`` with the recorder streaming
    into ``tmp_path/<tag>``; return the postmortem."""
    fit, ds, ch, ev, _, diverged = pkg
    d = tmp_path / tag
    monkeypatch.setenv("SPARKDL_EVENT_DIR", str(d / "ev"))
    ev.reset()
    ch.install(ch.FaultPlan([ch.Fault(**f) for f in plan]))
    try:
        with pytest.raises(diverged if exc == "diverged"
                           else getattr(ch, exc)):
            fit(d / "ck", ds(_batches(8)), 8, **fit_kw)
    finally:
        ch.uninstall()
        ev.get_recorder().close()
        monkeypatch.delenv("SPARKDL_EVENT_DIR")
        ev.reset()
    with open(d / "ev" / "postmortem_rank0.json") as f:
        pm = json.load(f)
    with open(d / "ev" / "events_rank0.jsonl") as f:
        evs = [json.loads(ln) for ln in f]
    return pm, evs


class TestFitCursorThreading:
    def test_resume_continues_at_exact_batch(self, tmp_path, monkeypatch):
        """Two fits over one checkpoint dir: the second resumes the DATA
        at batch 4, not 0..3 (pinned through the ledger)."""
        ledgers = []
        for tag, (fit, ds, _, _, dmod, _) in (("p", _PORT), ("r", _REF)):
            monkeypatch.setenv(dmod.LEDGER_ENV, str(tmp_path / tag / "led"))
            batches = _batches(8)
            fit(tmp_path / tag / "ck", ds(batches), 4)
            fit(tmp_path / tag / "ck", ds(batches), 8)
            led = dmod.read_ledger(str(tmp_path / tag / "led"))
            assert [(e["step"], e["batch_index"]) for e in led] == \
                [(i, i) for i in range(8)]
            ledgers.append(_audit(led))
        assert ledgers[0] == ledgers[1]
        assert data_lib.LEDGER_ENV == ref_data.LEDGER_ENV

    def test_lookahead_batches_replayed_not_dropped(self, tmp_path,
                                                    monkeypatch):
        """A failure mid-loop with ``feed_lookahead`` > 0: the batches the
        feed drew ahead replay from the cursor on the resume."""
        ledgers = []
        for tag, (fit, ds, ch, _, dmod, _) in (("p", _PORT), ("r", _REF)):
            monkeypatch.setenv(dmod.LEDGER_ENV, str(tmp_path / tag / "led"))
            batches = _batches(8)
            ch.install(ch.FaultPlan(
                [ch.Fault("step_start", "preempt", at_step=3)]))
            try:
                with pytest.raises(ch.InjectedPreemption):
                    fit(tmp_path / tag / "ck", ds(batches), 8,
                        feed_lookahead=2)
            finally:
                ch.uninstall()
            fit(tmp_path / tag / "ck", ds(batches), 8, feed_lookahead=2)
            led = dmod.read_ledger(str(tmp_path / tag / "led"))
            by_step = {}
            for e in led:
                assert by_step.setdefault(e["step"], e["batch_index"]) \
                    == e["batch_index"], "replay diverged"
            assert sorted(by_step.items()) == [(i, i) for i in range(8)]
            ledgers.append(_audit(led))
        assert ledgers[0] == ledgers[1]

    def test_fit_honors_env_skip_list(self, tmp_path, monkeypatch):
        ledgers = []
        for tag, (fit, ds, _, _, dmod, _) in (("p", _PORT), ("r", _REF)):
            monkeypatch.setenv(dmod.LEDGER_ENV, str(tmp_path / tag / "led"))
            monkeypatch.setenv(dmod.SKIP_ENV, "[1]")
            fit(tmp_path / tag / "ck", ds(_batches(5)), 4)
            led = dmod.read_ledger(str(tmp_path / tag / "led"))
            assert [e["batch_index"] for e in led] == [0, 2, 3, 4]
            assert all(e["skip_list"] == [1] for e in led)
            ledgers.append(_audit(led))
        assert ledgers[0] == ledgers[1]

    def test_draw_failure_attributed_to_failing_batch(self, tmp_path,
                                                      monkeypatch):
        """A failure raised while DRAWING batch 3 (the ``data_fetch``
        site) postmortems as batch 3, and the failed data_fetch span
        carries the tag too, with a lookahead feed."""
        got = []
        for tag, pkg in (("p", _PORT), ("r", _REF)):
            pm, evs = _postmortem(
                tmp_path, monkeypatch, pkg, tag,
                [dict(site="data_fetch", kind="fatal", at_step=3,
                      once=False)], "InjectedFatal", None, feed_lookahead=2)
            assert pm["batch_index"] == 3 and pm["epoch"] == 0
            span_err = [e for e in evs if e["name"] == "data_fetch"
                        and e.get("error")]
            assert span_err and span_err[0]["batch_index"] == 3
            got.append((pm["site"], pm["step"], pm["batch_index"],
                        pm["epoch"]))
        assert got[0] == got[1]

    def test_step_start_failure_not_attributed_to_previous_batch(
            self, tmp_path, monkeypatch):
        got = []
        for tag, pkg in (("p", _PORT), ("r", _REF)):
            pm, _ = _postmortem(
                tmp_path, monkeypatch, pkg, tag,
                [dict(site="step_start", kind="fatal", at_step=2,
                      once=False)], "InjectedFatal", None)
            assert pm["batch_index"] is None
            got.append((pm["site"], pm["step"], pm["batch_index"]))
        assert got[0] == got[1] == ("fit", 2, None)

    def test_diverged_attribution_suppressed_unless_log_every_1(
            self, tmp_path, monkeypatch):
        """With ``log_every`` > 1 the NaN-making batch lies anywhere in the
        window: no batch is named. With ``log_every=1`` it is exact."""
        got = []
        for tag, pkg in (("p", _PORT), ("r", _REF)):
            plan = [dict(site="data_fetch", kind="poison", at_step=2,
                         once=False)]
            pm3, _ = _postmortem(tmp_path, monkeypatch, pkg, tag + "3",
                                 plan, "diverged", None, log_every=3)
            assert pm3["batch_index"] is None
            pm1, _ = _postmortem(tmp_path, monkeypatch, pkg, tag + "1",
                                 plan, "diverged", None, log_every=1)
            assert pm1["batch_index"] == 2 and pm1["step"] == 2
            got.append([(p["step"], p["batch_index"], p["epoch"])
                        for p in (pm3, pm1)])
        assert got[0] == got[1]

    def test_bare_iterator_keeps_legacy_path(self, tmp_path, monkeypatch):
        """A generator (not replayable): no cursor in the manifest, no
        ledger lines."""
        for tag, (fit, _, _, _, dmod, _) in (("p", _PORT), ("r", _REF)):
            monkeypatch.setenv(dmod.LEDGER_ENV, str(tmp_path / tag / "led"))
            res = fit(tmp_path / tag / "ck", iter(_batches(4)), 4)
            assert int(res["state"].step) == 4
            assert dmod.read_ledger(str(tmp_path / tag / "led")) == []
            with open(tmp_path / tag / "ck" / "manifest_step_4.json") as f:
                assert "data_cursor" not in json.load(f)


def test_ledger_lines_read_by_either_package(tmp_path, monkeypatch):
    """The port's ledger file is the reference's format: each package's
    reader parses the other's lines to the same records, and a torn tail
    line is skipped."""
    monkeypatch.setenv("SPARKDL_PROCESS_ID", "1")
    monkeypatch.setenv("SPARKDL_NUM_PROCESSES", "2")
    for mod, d in ((data_lib, tmp_path / "p"), (ref_data, tmp_path / "r")):
        monkeypatch.setenv(mod.LEDGER_ENV, str(d))
        mod.append_ledger(0, {"epoch": 0, "batch_index": 1,
                              "skip_list": [5]})
        mod.append_ledger(1, None)  # no cursor: nothing
        mod.append_ledger(1, {"epoch": 1, "batch_index": 3})
    with open(tmp_path / "p" / "ledger_rank1.jsonl", "a") as f:
        f.write('{"step": 2, "ep')
    port = data_lib.read_ledger(str(tmp_path / "p"), rank=1)
    assert port == ref_data.read_ledger(str(tmp_path / "p"), rank=1)
    assert _audit(port) == _audit(
        data_lib.read_ledger(str(tmp_path / "r"), rank=1))
    assert _audit(port) == [
        {"step": 0, "epoch": 0, "batch_index": 0, "skip_list": [5],
         "world": 2},
        {"step": 1, "epoch": 1, "batch_index": 2, "skip_list": [],
         "world": 2}]
    assert data_lib.read_ledger(str(tmp_path / "none")) == []
